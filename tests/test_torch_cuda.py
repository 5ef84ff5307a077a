"""CUDA kernels of the PyTorch port vs their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present. This file imports
no JAX, so on a GPU machine without the JAX package it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Shapes here are the ragged ones chip_smoke.py does not reach: row counts
that are not a multiple of the GEMM tile, s_k != s_q, explicit cross masks.
Layer tolerance: bf16 outputs of O(1) magnitude, max abs 6e-2 (two bf16
ulps at |y| ~ 8), mean abs 2e-3; VQ: indices, the straight-through z_q and
counts exact, at row counts around its blocks (1, 63-65, 3,072, 24,577),
at 9 x 768, 16 x 1,024, 9 x 64, 9 x 66 (the element path) and the largest
codebook it takes at D = 768, with two equal codes; sum_z, loss and
perplexity within 1e-5 of their largest magnitude (f32 sums in another
order), and sum_z and the loss the same bits in two launches. On random
rows a code may differ from the plain version's only at an f32 near tie
(the two nearest codes closer in f64 than 4 f32 ulps of the distances,
where two summation orders may pick either); there the kernel picks one of
the tied codes, and its z_q, counts and sums are held to its own codes.
Backward and attention backward: every output within 2e-2 of its leaf's
largest magnitude (kernel and plain share the bf16 rounding points; an f32
sum in another order flips an occasional bf16 rounding of an intermediate,
one ulp is 0.4%). CE: ids exact, NLL within 1e-4 absolute (values ~10,
f32 sums in another order), dlogits within 1e-2 of the largest magnitude
(one bf16 ulp); the forward kernels also at rows starting at every 16-byte
phase, vocabularies 30,522, 30,521, 9, 8, 7 and 1, ties within and across
8-wide chunks and lanes, and targets in a row's head, body and tail and
outside the vocabulary; the backward at logits views of every element
offset of a 16-byte chunk, in bf16 and f32, at vocabularies 1, 7, 8, 9,
30,522, 50,257 and 50,264, with targets on a chunk's first and last
element and a row of scale 0, its output at the logits' 16-byte phase.
AMSGrad (#14): bit for bit, over leaves of ragged lengths, a leaf without a
gradient, a misaligned leaf and a chunk boundary.
Fused head + CE (#9, #10), both modes, ragged rows and odd vocabularies,
and at the tile edges (rows 1, 128, 129; V 256, 129, 2053; H 64, 768):
the kernel's logits within two bf16 ulps at the top of their range of the
plain version's (cuBLAS sums in another order; one ulp at each of the two
roundings); its NLL, lse and ids held to the plain CE over its own logits
(1e-4 absolute, ids exact); against the plain version, NLL within twice the
largest logit difference dl, and ids equal wherever the plain top-2 logits
are more than 2 dl apart (99% of rows in all); flash bit for bit equal
to store; g within one bf16 ulp (1e-2 of the largest), dbias within 1e-3 of
its largest, dx within 1e-2 of its largest, against the plain backward on
the same logits; the table gradient within 1e-4 of its largest; the
store-mode logits and g padded to rows of a multiple of 8, pad columns 0;
through ``fused_head_ce_loss``, the saved logits keep that stride and the
gradients sit within 1e-2 of the plain path's largest (bf16 g and dx).
SDPA (#11 / #12) and MHA (#13): outputs and gradients within 2e-2 of their
largest magnitude (the attention backward's bar: the same device code), the
attention keep masks exact. The attention kernels (csrc/attention.cuh and
its f32 instance csrc/attention_f32.cuh) at their tile edges: every entry
(the layer's attention forward and backward, #11 / #12, #13) at s_q, s_k in
{1, 7, 12, 16, 17, 32}, head_dim 64, 128, 40 (padded to 48 in bf16), 36 and
33 (element loads), a fully masked sentence and a part-filled last CTA,
held to the same 2e-2 in bf16 and to F32_FWD / F32_GRAD in f32; keep masks
exact through split views of a packed qkv / kv at 17 and 32 rows, in both
dtypes. The f32 attention forward and backward at the step's (2048, 12,
768), self and cross, dropout 0.1, against their function in f64 (one f32
accumulator a 3xTF32 product, up to 128 deep), at the same f32 bars.
The layer GEMM (wgmma + TMA), every layout and epilogue at ragged rows: an
f32 output within 1e-4 of the largest magnitude of the plain version's (f32
sums of up to 3,072 products in another order, and tanhf ulps in the GELU
epilogues); a bf16 output within half a bf16 ulp of the plain version's f32
value before its rounding, plus the same 1e-4; the weight gradients' split-K
sums equal bit for bit from run to run (bf16 and f32). The f32 GEMM (3xTF32
on wgmma) also at N = 200 / 8 and K = 200 / 40 (off its 128-wide tile and
32-deep slice), with b1 from its GELU-gradient epilogue, and its largest
error against torch.matmul in full f32 at K = 3,072 and over the weight and
table gradients' 24,576 rows within the f32 bars (the promotion interval);
cvt.rna.tf32, which splits its operands, with its 13 low bits zero and ties
away from zero on 2^24 values.
LayerNorm and column sums (csrc/layernorm.cu) at rows 1, 31, 33, 97 (a
warp's, a backward block's 64 and a GEMM tile's 128 rows crossed) and at the
step's 24,576, widths 64, 768 and the widest, 1,024: the residual +
LayerNorm's output and the LayerNorm backward's da, bf16, at the GEMM's bar
around the plain f32 value (a mean and variance summed in another order
move the f32 value by ~1e-7 and flip an occasional rounding); the rsqrt and
the backward's dr within 1e-5 of their largest magnitude (the same
division, the row means summed in another order); every column sum
(dgamma, dbeta, dbias, the bias sums of bf16 matrices up to 3,072 wide, and
b1 from the GELU-gradient GEMM's epilogue) within 1e-4 of its largest
magnitude (f32 sums over up to 24,576 rows in another order; for b1 also
the GEMM's own 1e-4), and the same bits from run to run.
CE at GPT-2's vocabulary (#7, #8): 50,257 (rows at all eight 16-byte
phases) and 50,264 (every row at the first row's phase), at the CE bars
above, targets outside the vocabulary included. The GPT-2 decoder (plain
PyTorch) in bf16 on the card, forward and backward, against the CPU's f32
pass: no further from it than 1.25 times the CPU's bf16 pass, plus one bf16
ulp of the largest magnitude.
f32 (JAX's parity dtype; the kernels' f32 instances) against the f32 plain
versions, every kernel of the default route: forwards (the layer GEMM's NN
products, the layer, the residual + LayerNorm, the attention context)
within 2e-5 of the output's largest magnitude (f32 sums in another order;
the GEMM's 3xTF32 products within a few 1e-7 of f32 ones); gradients (the
GEMM's NT and TN products, the layer backward, the LayerNorm backward, the
column sums, the attention backward) within 1e-4; CE NLL within 1e-5
relative, ids exact, dlogits within 1e-4; keep masks bit for bit. An f32
training step of the kernel route against the f32 plain route: the loss
within 1e-5 relative, the gradients within 1e-4 global relative L2. The f32
instances of the fused head + CE (#9, #10 in both modes, the table
gradient) at 129 rows x vocabularies 127, 129, 130, at 300 rows x 2,053 x
a hidden width of 200, and at the step's 24,576 x 30,522: the logits within 2e-5 of their largest magnitude, NLL and lse
within 1e-5 relative, ids exact wherever the plain top two logits lie more
than 2 dl apart (dl the logits' largest difference), g, dx, dbias and the
table gradient within 1e-4, flash equal to store bit for bit (nll, lse,
ids, g, dbias, dx), the pad columns 0; those of #11 / #12 (self causal,
self padded, cross; dropout 0.1) within 2e-5 / 1e-4, their keep masks bit
for bit; #13's with masked and fully masked rows within 2e-5.
The other variants (Shelgon, also with both masks None, Shelgon2 with
``mask_pct_train``, Shelgon3-Gumbel) at a small bf16 size, one training
loss and backward with dropout on: the kernel route's loss within 1e-3 of
the plain route's from the same weights and generator seed, and its
gradients no further (global and per-leaf relative L2) from an f32 plain
step's than 1.25 times the plain bf16 route's, leaves whose f32 gradient is
rounding noise aside (``chip_smoke.py``'s bars).
The serving ops and artifacts: ``kvq::layer_fwd``, ``kvq::vq_fwd`` and
``kvq::sdpa_fwd`` equal to their wrappers' direct launches bit for bit, in
bf16 and f32; an artifact exported on the card (``serve/export.py``, H 128,
2 + 2 layers, bucket 16: Shelgon3-VQ in bf16 and f32, Shelgon with its
Gumbel noise, a ``fused_layer="off"`` run) equal to the live kernel forward
bit for bit, with its launches, and refusing the CPU.
"""

import dataclasses
import os

import pytest
import torch

from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.models import build_model, init_weights
from kindergarten_vq_vae_torch.ops.adam import AdamScalars, adam_update_reference, amsgrad_update
from kindergarten_vq_vae_torch.ops.attention import fused_mha, mha_forward, mha_reference
from kindergarten_vq_vae_torch.ops.ce import (
    ce_bwd,
    ce_bwd_reference,
    ce_fwd,
    ce_fwd_ids,
    ce_fwd_ids_reference,
    ce_fwd_reference,
    target_logits,
)
from kindergarten_vq_vae_torch.ops.dropout import (
    OP_CROSS_OUT,
    OP_MLP_OUT,
    attention_keep,
    cross_op,
    hidden_keep,
)
from kindergarten_vq_vae_torch.ops.gemm import (
    gelu,
    gelu_grad,
    gemm,
    gemm_f32_plan,
    gemm_plan,
    gemm_reference,
)
from kindergarten_vq_vae_torch.ops.head_ce import (
    head_ce_bwd,
    head_ce_bwd_reference,
    head_ce_fwd,
    fused_head_ce_loss,
    head_ce_fwd_reference,
    table_grad,
    table_grad_reference,
)
from kindergarten_vq_vae_torch.ops.layer import (
    DEC_WEIGHTS,
    ENC_WEIGHTS,
    LayerGeom,
    attention_backward,
    attention_backward_reference,
    attention_forward,
    attention_forward_reference,
    bert_layer_reference,
    column_sums,
    column_sums_reference,
    fused_bert_layer,
    layer_backward,
    layer_backward_reference,
    layer_forward,
    layer_forward_reference,
    layernorm_backward,
    layernorm_backward_reference,
    residual_layernorm,
    residual_layernorm_reference,
    residual_names,
)
from kindergarten_vq_vae_torch.ops.sdpa import (
    fused_sdpa,
    sdpa_backward,
    sdpa_backward_reference,
    sdpa_forward,
    sdpa_forward_reference,
)
from kindergarten_vq_vae_torch.ops.vq import vector_quantize
from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel, vq_plan
from kindergarten_vq_vae_torch.train.variants import make_loss_fn

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _case(gen, decoder, B, S, SK, H, NH, F, with_cmask, gelu_exact=True, dtype=torch.bfloat16):
    dev = torch.device("cuda")
    geom = LayerGeom(num_heads=NH, head_dim=H // NH, intermediate=F, causal=decoder,
                     has_cross=decoder, eps=1e-12, gelu_exact=gelu_exact)
    x = torch.randn(B, S, H, device=dev, generator=gen).to(dtype)
    enc = torch.randn(B, SK, H, device=dev, generator=gen).to(dtype) if decoder else None
    lens = torch.randint(1, S + 1, (B,), device=dev, generator=gen)
    smask = (torch.arange(S, device=dev)[None] < lens[:, None]).to(torch.int32)
    cmask = None
    if with_cmask:
        cmask = torch.randint(0, 2, (B, SK), device=dev, generator=gen, dtype=torch.int32)
        cmask[:, 0] = 1
    shapes, ws = geom.weight_shapes(), []
    for n in DEC_WEIGHTS if decoder else ENC_WEIGHTS:
        r = torch.randn(shapes[n], device=dev, generator=gen)
        ws.append((0.05 * r).to(dtype) if n.startswith("w") else 1.0 + 0.1 * r if n.startswith("g")
                  else 0.05 * r)
    return geom, x, enc, smask, cmask, ws


# the f32 instances' bars against the f32 plain versions: a forward output
# within F32_FWD of its largest magnitude, a gradient within F32_GRAD
F32_FWD, F32_GRAD = 2e-5, 1e-4
BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("decoder,B,S,SK,H,NH,F,with_cmask,gelu_exact,dtype", [
    (False, 5, 12, 12, 128, 2, 256, False, True, BF),
    (True, 5, 12, 9, 128, 2, 256, True, True, BF),
    (True, 11, 7, 16, 192, 3, 384, False, True, BF),
    (False, 3, 32, 32, 256, 2, 512, False, True, BF),
    (True, 4, 12, 12, 128, 2, 256, False, False, BF),
    (False, 5, 12, 12, 128, 2, 256, False, True, F32),
    (True, 11, 7, 16, 192, 3, 384, True, True, F32),
    (True, 4, 12, 12, 128, 2, 256, False, False, F32),
])
def test_layer_kernel_matches_plain(gen, decoder, B, S, SK, H, NH, F, with_cmask, gelu_exact,
                                    dtype):
    geom, x, enc, smask, cmask, ws = _case(gen, decoder, B, S, SK, H, NH, F, with_cmask,
                                           gelu_exact, dtype)
    before = fused_bert_layer.launches, fused_bert_layer.f32_launches
    with torch.inference_mode():
        out = fused_bert_layer(geom, x, enc, smask, cmask, ws)
        torch.cuda.synchronize()
        ref = bert_layer_reference(geom, x, enc, smask, cmask, ws)
    assert (fused_bert_layer.launches, fused_bert_layer.f32_launches) == (
        before[0] + 1, before[1] + int(dtype == F32))
    assert out.dtype == dtype and out.shape == x.shape
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out).all()
    if dtype == F32:
        assert _rel_max(out, ref) <= F32_FWD
    else:
        assert err.max().item() <= 6e-2 and err.mean().item() <= 2e-3


def test_layer_kernel_rejects_what_it_does_not_take(gen):
    geom, x, enc, smask, cmask, ws = _case(gen, False, 2, 12, 12, 128, 2, 256, False)
    with torch.inference_mode():
        with pytest.raises(TypeError, match="bfloat16"):
            fused_bert_layer(geom, x.float(), None, smask, None, ws)
        with pytest.raises(ValueError, match="contiguous"):
            fused_bert_layer(geom, x.transpose(0, 1).contiguous().transpose(0, 1), None, smask,
                             None, ws)
        with pytest.raises(TypeError, match="int32"):
            fused_bert_layer(geom, x, None, smask.long(), None, ws)
        shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        with pytest.raises(ValueError, match="16-byte"):
            fused_bert_layer(geom, shifted, None, smask, None, ws)


@pytest.mark.parametrize("b,s,d,n_e", [(3, 5, 128, 9), (7, 12, 768, 9), (1, 33, 1024, 16)])
def test_vq_kernel_matches_plain(gen, b, s, d, n_e):
    z = torch.randn(b, s, d, device="cuda", generator=gen)
    e = (torch.rand(n_e, d, device="cuda", generator=gen) * 2 - 1) / n_e
    before = vector_quantize_kernel.launches
    with torch.inference_mode():
        k = vector_quantize_kernel(z, e, 0.25)
        torch.cuda.synchronize()
        p = vector_quantize(z, e, 0.25)
    assert vector_quantize_kernel.launches == before + 1
    assert torch.equal(k.indices, p.indices)
    assert torch.equal(k.z_q, p.z_q)
    assert torch.equal(k.counts, p.counts)
    torch.testing.assert_close(k.sum_z, p.sum_z, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k.loss, p.loss, rtol=1e-5, atol=0)
    torch.testing.assert_close(k.perplexity, p.perplexity, rtol=1e-5, atol=0)


def _rel_max(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _vq_max_codes(d: int) -> int:
    """The largest codebook the VQ kernel takes at width d."""
    n_e = 1
    while vq_plan(1, d, n_e + 1) is not None:
        n_e += 1
    return n_e


_VQ_ROWS = (1, 63, 64, 65, 3072, 24577)


def _vq_near_ties(z, e, idx):
    """Rows whose two nearest codes are closer, in f64, than 4 f32 ulps of
    the row's distances (where two f32 sums in different orders may pick
    either), and whether ``idx`` picks one of the codes that close to the
    f64 minimum."""
    z64, e64 = z.reshape(-1, z.shape[-1]).double(), e.double()
    c = e64.mean(0)
    zc, ec = z64 - c, e64 - c
    dist = (zc * zc).sum(1, keepdim=True) + (ec * ec).sum(1) - 2.0 * (zc @ ec.T)
    bound = 4 * 2.0**-23 * ((zc * zc).sum(1) + (ec * ec).sum(1).max())
    best = dist.min(1).values
    gap = dist.topk(2, 1, largest=False).values[:, 1] - best if e.shape[0] > 1 else bound + 1
    picked = dist.gather(1, idx.reshape(-1, 1))[:, 0] - best <= bound
    return gap <= bound, picked


@pytest.mark.parametrize("n_e,d", [(9, 768), (16, 1024), (9, 64), (9, 66), (None, 768), (3, 256),
                                   (8, 128)])
@pytest.mark.parametrize("rows", _VQ_ROWS)
def test_vq_kernel_at_block_edges(gen, rows, n_e, d):
    """Row counts around the kernel's blocks and a pair a warp, the widest
    row, a width off the 16-byte path (66), the largest codebook it takes
    at D = 768 (None), and small codebooks (3 and 8 codes, which the dot
    products take as 12 with the rest masked). The straight-through z_q is exactly z + (e[k] - z) of
    the kernel's own codes, the counts exactly their histogram, sum_z and
    the loss within 1e-5 of the plain sums over the same codes, and sum_z
    and the loss the same bits in two launches. The codes are the plain
    version's (and so are z_q, counts, sum_z, loss and perplexity, as
    above) on every row but an f32 near tie (see _vq_near_ties), where the
    kernel picks one of the tied codes."""
    if n_e is None:
        n_e = _vq_max_codes(d)
        assert n_e >= 37  # the codebooks the kernel before the 16-byte redesign took
    z = torch.randn(1, rows, d, device="cuda", generator=gen)
    e = (torch.rand(n_e, d, device="cuda", generator=gen) * 2 - 1) / n_e
    with torch.inference_mode():
        k = vector_quantize_kernel(z, e, 0.25)
        k2 = vector_quantize_kernel(z, e, 0.25)
        torch.cuda.synchronize()
        p = vector_quantize(z, e, 0.25)
    assert torch.equal(k.sum_z, k2.sum_z) and torch.equal(k.loss, k2.loss)
    idx, z2 = k.indices.view(-1), z.view(-1, d)
    assert torch.equal(k.z_q.view(-1, d), z2 + (e[idx] - z2))
    assert torch.equal(k.counts, torch.bincount(idx, minlength=n_e).float())
    one_hot = torch.nn.functional.one_hot(idx, n_e).float()
    assert _rel_max(k.sum_z, one_hot.T @ z2) <= 1e-5
    assert _rel_max(k.loss, ((e[idx] - z2) ** 2).sum() * 1.25 / z2.numel()) <= 1e-5
    near, picked = _vq_near_ties(z, e, idx)
    differ = idx != p.indices.view(-1)
    assert bool(picked.all()) and not bool((differ & ~near).any()), (
        f"{int(differ.sum())} codes differ, {int(near.sum())} near ties")
    if not bool(differ.any()):
        assert torch.equal(k.indices, p.indices) and torch.equal(k.z_q, p.z_q)
        assert torch.equal(k.counts, p.counts)
        for f in ("sum_z", "loss", "perplexity"):
            assert _rel_max(getattr(k, f), getattr(p, f)) <= 1e-5, f


def test_vq_kernel_first_minimum_on_equal_codes(gen):
    """Code 5 is a copy of code 2 and rows sit near it: the kernel picks 2,
    as the plain version's first minimum does, in every 16-code group."""
    n_e, d = 37, 768  # three groups of up to 16 codes
    e = (torch.rand(n_e, d, device="cuda", generator=gen) * 2 - 1) / 9
    e[5], e[21], e[36] = e[2], e[18], e[18]
    pick = torch.tensor([2, 18], device="cuda")[torch.randint(0, 2, (4096,), device="cuda",
                                                              generator=gen)]
    z = (e[pick] + 1e-3 * torch.randn(4096, d, device="cuda", generator=gen)).view(64, 64, d)
    with torch.inference_mode():
        k = vector_quantize_kernel(z, e, 0.25)
        torch.cuda.synchronize()
        p = vector_quantize(z, e, 0.25)
    assert torch.equal(k.indices.view(-1), pick) and torch.equal(k.indices, p.indices)
    assert torch.equal(k.z_q, p.z_q) and torch.equal(k.counts, p.counts)


def test_vq_kernel_rejects_what_it_does_not_take(gen):
    n_e = _vq_max_codes(768)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="shared memory"):
            vector_quantize_kernel(torch.randn(1, 4, 768, device="cuda"),
                                   torch.randn(n_e + 1, 768, device="cuda"), 0.25)
        with pytest.raises(ValueError, match="D <= 1024"):
            vector_quantize_kernel(torch.randn(1, 4, 1025, device="cuda"),
                                   torch.randn(9, 1025, device="cuda"), 0.25)
        with pytest.raises(TypeError, match="float32"):
            vector_quantize_kernel(torch.randn(1, 4, 768, device="cuda").double(),
                                   torch.randn(9, 768, device="cuda"), 0.25)


@pytest.mark.parametrize("decoder,B,S,SK,H,NH,F,dtype", [
    (False, 5, 12, 12, 128, 2, 256, BF),
    (True, 5, 12, 9, 128, 2, 256, BF),
    (True, 11, 7, 16, 192, 3, 384, BF),
    (False, 171, 12, 12, 128, 2, 256, BF),   # 2052 rows: split-K weight gradients, uneven chunks
    (True, 205, 10, 12, 192, 3, 384, BF),    # 2050 rows
    (False, 5, 12, 12, 128, 2, 256, F32),
    (True, 11, 7, 16, 192, 3, 384, F32),
    (False, 171, 12, 12, 128, 2, 256, F32),
    (True, 205, 10, 12, 192, 3, 384, F32),
])
def test_training_layer_kernels_match_plain(gen, decoder, B, S, SK, H, NH, F, dtype):
    """Training forward (dropout 0.1 / 0.1, residuals kept) and the backward
    kernels, each against its plain version on the same inputs. Past 2048
    rows the weight gradients take the split-K path."""
    geom, x, enc, smask, cmask, ws = _case(gen, decoder, B, S, SK, H, NH, F, decoder, True,
                                           dtype)
    fwd_bar, grad_bar = (F32_FWD, F32_GRAD) if dtype == F32 else (2e-2, 2e-2)
    geom = LayerGeom(**{**geom.__dict__, "attn_rate": 0.1, "hid_rate": 0.1})
    seed = -1234567
    before = fused_bert_layer.launches
    out, res = layer_forward(geom, x, enc, smask, cmask, ws, seed)
    torch.cuda.synchronize()
    assert fused_bert_layer.launches == before + 1
    out_p, res_p = layer_forward_reference(geom, x, enc, smask, cmask, ws, seed)
    err = (out.float() - out_p.float()).abs()
    assert torch.isfinite(out).all()
    if dtype == F32:
        assert out.dtype == F32 and _rel_max(out, out_p) <= F32_FWD
    else:
        assert err.max() <= 6e-2 and err.mean() <= 2e-3
    for name, a, b in zip(residual_names(geom), res, res_p):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_max(a, b) <= fwd_bar, name

    gy = (0.1 * torch.randn(x.shape, device="cuda", generator=gen)).to(dtype)
    before = layer_backward.launches
    got = layer_backward(geom, x, enc, smask, cmask, ws, seed, res_p, out_p, gy, torch.float32)
    torch.cuda.synchronize()
    assert layer_backward.launches == before + 1
    want = layer_backward_reference(geom, x, enc, smask, cmask, ws, seed, res_p, out_p, gy,
                                    torch.float32)
    assert got[0].dtype == dtype and _rel_max(got[0], want[0]) <= grad_bar
    if decoder:
        assert got[1].dtype == torch.float32 and _rel_max(got[1], want[1]) <= grad_bar
    names = DEC_WEIGHTS if decoder else ENC_WEIGHTS
    for n, w, a, b in zip(names, ws, got[2], want[2]):
        assert a.dtype == w.dtype and a.shape == w.shape, n
        assert torch.isfinite(a).all() and _rel_max(a, b) <= grad_bar, n


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("cross", [False, True])
def test_attention_backward_kernel_matches_plain(gen, cross, dtype):
    B, S, SK, H, NH = 9, 12, 9 if cross else 12, 256, 4
    q = torch.randn(B, S, H if cross else 3 * H, device="cuda", generator=gen).to(dtype)
    kv = torch.randn(B, SK, 2 * H, device="cuda", generator=gen).to(dtype) if cross else None
    lens = torch.randint(1, SK + 1, (B,), device="cuda", generator=gen)
    mask = (torch.arange(SK, device="cuda")[None] < lens[:, None]).to(torch.int32)
    g = torch.randn(B, S, H, device="cuda", generator=gen).to(dtype)
    op = cross_op(NH) if cross else 0
    before = attention_backward.launches, attention_backward.f32_launches
    before_cross = attention_backward.cross_launches
    got = attention_backward(q, kv, mask, g, NH, not cross, 77, op, 0.1)
    torch.cuda.synchronize()
    assert (attention_backward.launches, attention_backward.f32_launches) == (
        before[0] + 1, before[1] + int(dtype == F32))
    assert attention_backward.cross_launches == before_cross + int(cross)
    want = attention_backward_reference(q, kv, mask, g, NH, not cross, 77, op, 0.1)
    for a, b in zip(got if cross else (got,), want if cross else (want,)):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel_max(a, b) <= (F32_GRAD if dtype == F32 else 2e-2)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_attention_keep_mask_is_visible_and_exact(gen, dtype):
    """With q = k = 0 every valid key gets the same probability, and with v
    the one-hot of the key position the context shows p * keep per (query,
    key, head): its nonzero pattern is the keep mask, exactly."""
    B, S, H, NH, F = 7, 12, 128, 2, 256
    hd = H // NH
    geom = LayerGeom(num_heads=NH, head_dim=hd, intermediate=F, causal=False, has_cross=False,
                     eps=1e-12, gelu_exact=True, attn_rate=0.3, hid_rate=0.3)
    x = torch.zeros(B, S, H, device="cuda")
    for h in range(NH):
        x[:, torch.arange(S), h * hd + torch.arange(S)] = 1.0
    x = x.to(dtype)
    smask = torch.ones(B, S, dtype=torch.int32, device="cuda")
    shapes, ws = geom.weight_shapes(), []
    for n in ENC_WEIGHTS:
        w = torch.zeros(shapes[n], device="cuda")
        if n == "wqkv":
            w[:, 2 * H:] = torch.eye(H, device="cuda")
        if n.startswith("g"):
            w += 1.0
        ws.append(w.to(dtype) if n.startswith("w") else w)
    _, res = layer_forward(geom, x, None, smask, None, ws, 99)
    ctx = res[residual_names(geom).index("ctx")].view(B, S, NH, hd)[..., :S]
    for h in range(NH):
        keep = attention_keep(99, h, B, S, S, 0.3, "cuda") > 0
        assert torch.equal(ctx[:, :, h] > 0, keep)


def _nll_held(nll, nll_p, dtype):
    """NLL within 1e-4 absolute (bf16 logits) or 1e-5 relative (f32)."""
    if dtype == F32:
        assert ((nll - nll_p).abs() / nll_p.abs().clamp_min(1e-30)).max() <= 1e-5
    else:
        assert (nll - nll_p).abs().max() <= 1e-4


@pytest.mark.parametrize("dtype", [BF, F32])
def test_ce_kernels_match_plain(gen, dtype):
    rows, vocab = 1000, 30522
    x = (3.0 * torch.randn(rows, vocab, device="cuda", generator=gen)).to(dtype)
    x[0, [5, 9000, 30000]] = 40.0   # ties far apart
    x[1, [7, 8]] = 40.0             # ties side by side
    x[2] = 0.5                      # an all-equal row
    t = torch.randint(0, vocab, (rows,), device="cuda", generator=gen, dtype=torch.int32)
    before = ce_fwd_ids.launches, ce_bwd.launches, ce_fwd_ids.f32_launches, ce_bwd.f32_launches
    nll, ids = ce_fwd_ids(x, t)
    torch.cuda.synchronize()
    nll_p, ids_p = ce_fwd_ids_reference(x, t)
    assert torch.equal(ids, ids_p) and ids[0] == 5 and ids[1] == 7 and ids[2] == 0
    _nll_held(nll, nll_p, dtype)
    _held_ce_bwd(gen, x, t, nll_p + x.float().gather(1, t.long()[:, None])[:, 0])
    f32 = int(dtype == F32)
    assert (ce_fwd_ids.launches, ce_bwd.launches, ce_fwd_ids.f32_launches,
            ce_bwd.f32_launches) == (before[0] + 1, before[1] + 1, before[2] + f32, before[3] + f32)
    odd = x[:, :30521].contiguous()  # an odd vocabulary: rows at every 16-byte phase
    assert torch.equal(ce_fwd_ids(odd, t.clamp(max=30520))[1],
                       ce_fwd_ids_reference(odd, t.clamp(max=30520))[1])


@pytest.mark.parametrize("vocab", [30522, 30521])
def test_ce_fwd_kernel_matches_plain(gen, vocab):
    """#6: the NLL alone, the same value as #7's."""
    rows = 777
    x = (3.0 * torch.randn(rows, vocab, device="cuda", generator=gen)).bfloat16()
    t = torch.randint(0, vocab, (rows,), device="cuda", generator=gen, dtype=torch.int32)
    before = ce_fwd.launches
    nll = ce_fwd(x, t)
    torch.cuda.synchronize()
    assert ce_fwd.launches == before + 1 and nll.dtype == torch.float32
    assert (nll - ce_fwd_reference(x, t)).abs().max() <= 1e-4
    assert torch.equal(nll, ce_fwd_ids(x, t)[0])


def _ce_edge_case(gen, rows, vocab, offset, dtype=BF):
    """(rows, vocab) bf16 or f32 logits starting ``offset`` elements into
    their buffer, so the rows' first 16-byte boundaries fall at every phase,
    with ties within a 16-byte chunk (8 bf16 or 4 f32), across chunks and
    lanes, between the head and the body and between the body and the tail
    (columns counted from each row's head), an all-equal row, and targets in
    the head, the body, the tail and outside the vocabulary."""
    buf = (3.0 * torch.randn(rows * vocab + offset, device="cuda", generator=gen)).to(dtype)
    x = buf[offset:].view(rows, vocab)
    t = torch.randint(0, vocab, (rows,), device="cuda", generator=gen, dtype=torch.int32)
    es = x.element_size()
    E = 16 // es
    for r in range(rows):
        h = min((16 - (x[r].data_ptr() % 16)) % 16 // es, vocab)
        body = (vocab - h) // E
        tail = h + E * body
        ties = [(h + 1, h + 2), (h + E - 1, h + E), (h + 3, h + E * 33 + 3), (0, h + 5),
                (tail - 1, vocab - 1), (5, 9000, 30000)][r % 6]
        cols = [c for c in ties if c < vocab]
        if cols:
            x[r, cols] = 40.0
        t[r] = [0, h + E, vocab - 1, vocab, -1, t[r]][r % 6] if r >= 6 else t[r]
    x[rows - 1] = 0.5  # an all-equal row
    return x, t


def _held_ce_bwd(gen, x, t, lse):
    """#8 on ``x`` against its plain version, with a random scale and a row
    of scale 0: within 1e-2 (bf16) or F32_GRAD (f32) of the largest
    magnitude, the zero row all 0, in the logits' dtype, and out at the
    logits' 16-byte phase (so 16-byte aligned where the logits are)."""
    rows = x.shape[0]
    scale = torch.rand(rows, device="cuda", generator=gen) / rows
    scale[rows // 2] = 0.0
    got = ce_bwd(x, t, lse, scale)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape and got.is_contiguous()
    assert got.data_ptr() % 16 == x.data_ptr() % 16
    assert _rel_max(got, ce_bwd_reference(x, t, lse, scale)) <= (
        F32_GRAD if x.dtype == F32 else 1e-2)
    assert (got[rows // 2] == 0).all()


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("vocab", [30522, 30521, 9, 8, 7, 1])
def test_ce_fwd_kernels_at_row_phases(gen, vocab, offset):
    """#7 and #6 over rows at every 16-byte phase (30,522 bf16 rows start at
    four; an offset of one element adds the odd ones), an odd vocabulary and
    vocabularies under one chunk: ids exact, NLL within 1e-4, #6's NLL the
    bits of #7's."""
    x, t = _ce_edge_case(gen, 64, vocab, offset)
    nll, ids = ce_fwd_ids(x, t)
    nll6 = ce_fwd(x, t)
    torch.cuda.synchronize()
    nll_p, ids_p = ce_fwd_ids_reference(x, t)
    assert torch.equal(ids, ids_p)
    assert ids[-1] == 0
    assert (nll - nll_p).abs().max() <= 1e-4
    assert torch.equal(nll6, nll)


@pytest.mark.parametrize("vocab", [1, 7, 8, 9, 30522, 50257, 50264])
@pytest.mark.parametrize("dtype, offset", [(BF, o) for o in range(8)]
                         + [(F32, o) for o in range(4)])
def test_ce_bwd_kernel_at_row_phases(gen, vocab, dtype, offset):
    """#8 over logits views at every element offset of a 16-byte chunk (8
    bf16 or 4 f32), so the first row starts at every 16-byte phase (and
    odd vocabularies put the rows at every phase besides), at vocabularies
    under, at and over one chunk and the model's 30,522 / 50,257 / 50,264,
    with targets at every place a row is cut (the head's first and last
    column, a body chunk's first and last, the body's last, the tail's
    first, the row's last, -1 and V) and a row of scale 0."""
    x, t = _ce_edge_case(gen, 64, vocab, offset, dtype)
    es = x.element_size()
    for r in range(64):
        h = min((16 - (x[r].data_ptr() % 16)) % 16 // es, vocab)
        tail = h + 16 // es * ((vocab - h) // (16 // es))
        t[r] = [0, h - 1, h, h + 16 // es - 1, h + 16 // es, tail - 1, tail, vocab - 1, vocab,
                -1][r % 10]
    lse = ce_fwd_ids_reference(x, t)[0] + target_logits(x, t)
    before = ce_bwd.launches
    _held_ce_bwd(gen, x, t, lse)
    assert ce_bwd.launches == before + 1


def _head_case(gen, rows, V, H):
    x = torch.randn(rows, H, device="cuda", generator=gen).bfloat16()
    table = (0.05 * torch.randn(V, H, device="cuda", generator=gen)).bfloat16()
    bias = 0.1 * torch.randn(V, device="cuda", generator=gen)
    t = torch.randint(0, V, (rows,), device="cuda", generator=gen, dtype=torch.int32)
    return x, table, bias, t


def _ulp_top(l):
    """One bf16 ulp at the largest magnitude of l."""
    return 2.0 ** (torch.floor(torch.log2(l.float().abs().max())).item() - 7)


def _held_head_ce(gen, rows, V, H):
    """#9 and #10 in both modes and the table gradient against their plain
    versions, at the bars of the module docstring."""
    x, table, bias, t = _head_case(gen, rows, V, H)
    before = head_ce_fwd.launches, head_ce_bwd.launches, table_grad.launches
    out = {m: head_ce_fwd(x, table, bias, t, m) for m in ("store", "flash")}
    torch.cuda.synchronize()
    nll, lse, ids, logits = out["store"]
    assert out["flash"][3] is None
    for a, b in zip(out["store"][:3], out["flash"][:3]):
        assert torch.equal(a, b)  # flash = store, bit for bit
    ld = logits.stride(0)
    assert logits.shape == (rows, V) and ld % 8 == 0 and V <= ld < V + 8
    assert (logits.as_strided((rows, ld), (ld, 1))[:, V:] == 0).all()
    nll_p, lse_p, ids_p, logits_p = head_ce_fwd_reference(x, table, bias, t, "store")
    dl = (logits.float() - logits_p.float()).abs().max().item()
    assert dl <= 2 * _ulp_top(logits_p)  # at most one ulp at each of the two roundings
    nll_own, ids_own = ce_fwd_ids_reference(logits, t)
    assert torch.equal(ids, ids_own) and (nll - nll_own).abs().max() <= 1e-4
    assert (lse - (nll_own + logits.float().gather(1, t.long()[:, None])[:, 0])).abs().max() <= 1e-4
    # lse and the target logit each move by at most dl; an argmax can move
    # only where the plain top-2 logits are within 2 dl of each other
    assert (nll - nll_p).abs().max() <= 2 * dl + 1e-4
    top2 = logits_p.float().topk(2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > 2 * dl
    assert torch.equal(ids[clear], ids_p[clear]) and (ids == ids_p).float().mean() >= 0.99

    scale = torch.rand(rows, device="cuda", generator=gen) / rows
    g_s, dx_s, db_s = head_ce_bwd(logits, table, bias, t, lse, scale, "store")
    g_f, dx_f, db_f = head_ce_bwd(x, table, bias, t, lse, scale, "flash")
    torch.cuda.synchronize()
    assert g_s.shape == (rows, V) and g_s.stride(0) % 8 == 0 and g_s.dtype == torch.bfloat16
    assert torch.equal(g_s, g_f) and torch.equal(dx_s, dx_f) and torch.equal(db_s, db_f)
    assert (g_s.as_strided((rows, g_s.stride(0)), (g_s.stride(0), 1))[:, V:] == 0).all()
    g_p, dx_p, db_p = head_ce_bwd_reference(logits, table, bias, t, lse, scale, "store")
    assert _rel_max(g_s, g_p) <= 1e-2 and _rel_max(dx_s, dx_p) <= 1e-2
    assert db_s.dtype == torch.float32 and _rel_max(db_s, db_p) <= 1e-3
    dt = table_grad(g_s, x)
    torch.cuda.synchronize()
    assert dt.dtype == torch.float32 and dt.shape == (V, H)
    assert _rel_max(dt, table_grad_reference(g_s, x)) <= 1e-4
    assert (head_ce_fwd.launches, head_ce_bwd.launches, table_grad.launches) == (
        before[0] + 2, before[1] + 2, before[2] + 1)


@pytest.mark.parametrize("rows,V,H", [(300, 133, 64), (1000, 30522, 768), (129, 2053, 128)])
def test_head_ce_kernels_match_plain(gen, rows, V, H):
    _held_head_ce(gen, rows, V, H)


@pytest.mark.parametrize("H", [64, 768])
@pytest.mark.parametrize("V", [256, 129, 2053])
@pytest.mark.parametrize("rows", [1, 128, 129])
def test_head_ce_kernels_at_tile_edges(gen, rows, V, H):
    """At the edges of the GEMM's 128-row tile and the CE epilogues' 128-wide
    vocab tile: V a multiple of it, one past it, and V % 8 != 0; H one K tile
    (64) and the model's 768."""
    _held_head_ce(gen, rows, V, H)


@pytest.mark.parametrize("mode", ["store", "flash"])
def test_fused_head_ce_keeps_the_padded_logits_through_backward(gen, mode):
    """fused_head_ce_loss saves the store-mode logits as #9 wrote them (a view
    of rows padded to a multiple of 8) and #10 reads them so; its gradients
    match the plain path's."""
    B, S, V, H = 6, 5, 133, 64
    x, table, bias, t = _head_case(gen, B * S, V, H)
    valid = torch.ones(B, device="cuda")
    grads = {}
    for reference in (False, True):
        h = x.view(B, S, H).clone().requires_grad_()
        tab = table.float().requires_grad_()
        b = bias.clone().requires_grad_()
        loss, _ = fused_head_ce_loss(h, tab, b, t.view(B, S), valid, mode=mode,
                                     reference=reference)
        if not reference:
            saved = loss.grad_fn.saved_tensors[0]
            if mode == "store":
                assert saved.shape == (B * S, V) and saved.stride() == (136, 1)
            else:
                assert saved.shape == (B * S, H)
        loss.backward()
        grads[reference] = (h.grad, tab.grad, b.grad)
    for got, want in zip(grads[False], grads[True]):
        assert _rel_max(got, want) <= 1e-2


def test_head_ce_kernels_reject_what_they_do_not_take(gen):
    x, table, bias, t = _head_case(gen, 64, 133, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        head_ce_fwd(x.float(), table, bias, t, "store")
    with pytest.raises(TypeError, match="int32"):
        head_ce_fwd(x, table, bias, t.long(), "flash")
    with pytest.raises(ValueError, match="mode"):
        head_ce_fwd(x, table, bias, t, "auto")
    with pytest.raises(ValueError, match="multiple of 8"):
        head_ce_fwd(x[:, :60].contiguous(), table[:, :60].contiguous(), bias, t, "store")


def _held_head_ce_f32(gen, rows, V, H):
    """#9 / #10 (both modes) and the table gradient in f32 against their f32
    plain versions, at the bars of the module docstring."""
    x = torch.randn(rows, H, device="cuda", generator=gen)
    table = 0.05 * torch.randn(V, H, device="cuda", generator=gen)
    bias = 0.1 * torch.randn(V, device="cuda", generator=gen)
    t = torch.randint(0, V, (rows,), device="cuda", generator=gen, dtype=torch.int32)
    counters = (head_ce_fwd, head_ce_bwd, table_grad)
    before = [(f.launches, f.f32_launches) for f in counters]
    out = {m: head_ce_fwd(x, table, bias, t, m) for m in ("store", "flash")}
    torch.cuda.synchronize()
    nll, lse, ids, logits = out["store"]
    assert out["flash"][3] is None and logits.dtype == F32
    for a, b in zip(out["store"][:3], out["flash"][:3]):
        assert torch.equal(a, b)  # flash = store, bit for bit
    ld = logits.stride(0)
    assert logits.shape == (rows, V) and ld % 8 == 0 and V <= ld < V + 8
    assert (logits.as_strided((rows, ld), (ld, 1))[:, V:] == 0).all()
    nll_p, lse_p, ids_p, logits_p = head_ce_fwd_reference(x, table, bias, t, "store")
    assert _rel_max(logits, logits_p) <= F32_FWD
    dl = (logits - logits_p).abs().max().item()
    assert _rel_max(nll, nll_p) <= 1e-5 and _rel_max(lse, lse_p) <= 1e-5
    top2 = logits_p.topk(2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > 2 * dl
    assert torch.equal(ids[clear], ids_p[clear])
    del logits_p, top2

    scale = torch.rand(rows, device="cuda", generator=gen) / rows
    g_s, dx_s, db_s = head_ce_bwd(logits, table, bias, t, lse, scale, "store")
    g_f, dx_f, db_f = head_ce_bwd(x, table, bias, t, lse, scale, "flash")
    torch.cuda.synchronize()
    assert g_s.shape == (rows, V) and g_s.stride(0) % 8 == 0 and g_s.dtype == F32
    assert torch.equal(g_s, g_f) and torch.equal(dx_s, dx_f) and torch.equal(db_s, db_f)
    assert (g_s.as_strided((rows, g_s.stride(0)), (g_s.stride(0), 1))[:, V:] == 0).all()
    g_p, dx_p, db_p = head_ce_bwd_reference(logits, table, bias, t, lse, scale, "store")
    assert dx_s.dtype == F32 and db_s.dtype == F32
    assert max(_rel_max(g_s, g_p), _rel_max(dx_s, dx_p), _rel_max(db_s, db_p)) <= F32_GRAD
    del g_p, dx_p
    dt = table_grad(g_s, x)
    torch.cuda.synchronize()
    assert dt.dtype == F32 and dt.shape == (V, H)
    assert _rel_max(dt, table_grad_reference(g_s, x)) <= F32_GRAD
    after = [(f.launches, f.f32_launches) for f in counters]
    assert after == [(b[0] + n, b[1] + n) for b, n in zip(before, (2, 2, 1))]


@pytest.mark.parametrize("rows,V,H", [(129, 127, 64), (129, 129, 64), (129, 130, 64),
                                      (300, 2053, 200)])
def test_head_ce_f32_kernels_at_tile_edges(gen, rows, V, H):
    """129 and 300 rows (past the 128-row tile); V odd (the CE epilogues'
    column at a time) and 2 mod 4 (g's rows padded to a multiple of 4, K of
    dx); a hidden width of 200, not a multiple of the 32-deep slice."""
    _held_head_ce_f32(gen, rows, V, H)


def test_head_ce_f32_kernels_at_the_step_shape(gen):
    _held_head_ce_f32(gen, 2048 * 12, 30522, 768)


def test_amsgrad_kernel_matches_plain_bit_for_bit(gen):
    sizes = [(65536 + 3,), (30522,), (7, 5), (1,), (128, 768)]
    leaves = [torch.randn(sz, device="cuda", generator=gen) for sz in sizes]
    base = torch.randn(4097, device="cuda", generator=gen)
    leaves.append(base[1:])  # 4-byte aligned only: the scalar path
    grads = [1e-3 * torch.randn(p.shape, device="cuda", generator=gen) for p in leaves]
    grads[1] = None
    s = AdamScalars(*(float(torch.tensor(v, dtype=torch.float32)) for v in (
        1e-3, 0.01, 0.9, 0.999, 1e-8, 0.1, 0.001, 0.1, 0.001)))
    k = [[t.clone() for t in leaves]] + [[torch.rand_like(t) for t in leaves] for _ in range(3)]
    p = [[t.clone() for t in group] for group in k]
    before = amsgrad_update.launches
    for _ in range(2):
        amsgrad_update(*k[:1], grads, *k[1:], s)
        for leaf in zip(p[0], grads, p[1], p[2], p[3]):
            adam_update_reference(*leaf, s)
    torch.cuda.synchronize()
    assert amsgrad_update.launches == before + 2
    for a, b in zip(sum(k, []), sum(p, [])):
        assert torch.equal(a, b)


def _views(gen, cross, B, S, SK, H, dtype=BF):
    """q, k, v as the per-module trunk hands them over: split views of a
    packed qkv (self) or of q and a packed kv (cross)."""
    if cross:
        q = torch.randn(B, S, H, device="cuda", generator=gen).to(dtype)
        k, v = torch.randn(B, SK, 2 * H, device="cuda", generator=gen).to(dtype).split(H, -1)
        return q, k, v
    return torch.randn(B, S, 3 * H, device="cuda", generator=gen).to(dtype).split(H, -1)


@pytest.mark.parametrize("cross,causal,rate", [
    (False, True, 0.1), (False, False, 0.0), (True, False, 0.1), (True, False, 0.0),
])
def test_sdpa_kernels_match_plain(gen, cross, causal, rate):
    B, S, SK, H, NH = 37, 12, 9 if cross else 12, 256, 4
    q, k, v = _views(gen, cross, B, S, SK, H)
    lens = torch.randint(1, SK + 1, (B,), device="cuda", generator=gen)
    mask = (torch.arange(SK, device="cuda")[None] < lens[:, None]).to(torch.int32)
    g = torch.randn(B, S, H, device="cuda", generator=gen).bfloat16()
    before = (sdpa_forward.launches, sdpa_forward.cross_launches, sdpa_backward.launches,
              sdpa_backward.cross_launches)
    out = sdpa_forward(q, k, v, mask, -77, NH, causal, rate, cross)
    grads = sdpa_backward(q, k, v, mask, -77, g, NH, causal, rate, cross)
    torch.cuda.synchronize()
    assert (sdpa_forward.launches, sdpa_forward.cross_launches, sdpa_backward.launches,
            sdpa_backward.cross_launches) == (before[0] + 1, before[1] + int(cross),
                                              before[2] + 1, before[3] + int(cross))
    want = sdpa_forward_reference(q, k, v, mask, -77, NH, causal, rate)
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, H)
    assert torch.isfinite(out).all() and _rel_max(out, want) <= 2e-2
    for a, b in zip(grads, sdpa_backward_reference(q, k, v, mask, -77, g, NH, causal, rate)):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape and _rel_max(a, b) <= 2e-2


def test_sdpa_autograd_runs_the_kernels(gen):
    q, k, v = (t.detach().requires_grad_() for t in _views(gen, False, 5, 12, 12, 128))
    before = sdpa_forward.launches, sdpa_backward.launches
    fused_sdpa(q, k, v, None, 3, 2, True, 0.1).float().sum().backward()
    torch.cuda.synchronize()
    assert (sdpa_forward.launches, sdpa_backward.launches) == (before[0] + 1, before[1] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


def test_sdpa_keep_masks_are_exact(gen):
    """q = k = 0 and v the one-hot of the key position: the context's nonzero
    pattern is p * keep per (query, key, head), and equals the plain mask."""
    B, S, H, NH = 9, 12, 128, 2
    hd = H // NH
    q = torch.zeros(B, S, H, device="cuda", dtype=torch.bfloat16)
    v = torch.zeros(B, S, H, device="cuda")
    for h in range(NH):
        v[:, torch.arange(S), h * hd + torch.arange(S)] = 1.0
    out = sdpa_forward(q, q, v.bfloat16(), None, 123, NH, True, 0.3)
    ctx = out.view(B, S, NH, hd)[..., :S]
    tril = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    for h in range(NH):
        keep = attention_keep(123, h, B, S, S, 0.3, "cuda") > 0
        assert torch.equal(ctx[:, :, h] > 0, keep & tril)


@pytest.mark.parametrize("causal,masked", [(False, True), (True, False), (True, True)])
def test_mha_kernel_matches_plain(gen, causal, masked):
    B, S, H, NH = 21, 12, 256, 4
    q, k, v = (t.detach().requires_grad_() for t in _views(gen, False, B, S, S, H))
    mask = None
    if masked:
        mask = torch.randint(0, 2, (B, S), device="cuda", generator=gen, dtype=torch.int32)
        mask[:, 0] = 1
        mask[3] = 0  # a fully masked sentence: uniform over every key
    before = mha_forward.launches
    out = fused_mha(q, k, v, mask, NH, causal)
    g = torch.randn(B, S, H, device="cuda", generator=gen).bfloat16()
    out.backward(g)
    torch.cuda.synchronize()
    assert mha_forward.launches == before + 1
    with torch.no_grad():
        want = mha_reference(q, k, v, mask, NH, causal)
    assert out.dtype == torch.bfloat16 and _rel_max(out, want) <= 2e-2
    if masked:
        assert _rel_max(out[3], v[3].float().mean(0).expand(S, H)) <= 2e-2
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    mha_reference(qq, kk, vv, mask, NH, causal).backward(g)
    for a, b in ((q, qq), (k, kk), (v, vv)):
        assert torch.equal(a.grad, b.grad)  # the backward is autograd through the plain version


@pytest.mark.parametrize("cross,causal,masked", [
    (False, True, False), (False, False, True), (True, False, True),
])
def test_sdpa_f32_kernels_match_plain(gen, cross, causal, masked):
    """#11 / #12's f32 instances (dropout 0.1) against their f32 plain
    versions; a sentence fully masked where masked."""
    B, S, SK, H, NH = 37, 12, 9 if cross else 12, 256, 4
    q, k, v = _views(gen, cross, B, S, SK, H, F32)
    mask = None
    if masked:
        lens = torch.randint(1, SK + 1, (B,), device="cuda", generator=gen)
        mask = (torch.arange(SK, device="cuda")[None] < lens[:, None]).to(torch.int32)
        mask[3] = 0
    g = torch.randn(B, S, H, device="cuda", generator=gen)
    counters = (sdpa_forward, sdpa_backward)
    before = [(f.launches, f.f32_launches, f.cross_launches) for f in counters]
    out = sdpa_forward(q, k, v, mask, -77, NH, causal, 0.1, cross)
    grads = sdpa_backward(q, k, v, mask, -77, g, NH, causal, 0.1, cross)
    torch.cuda.synchronize()
    after = [(f.launches, f.f32_launches, f.cross_launches) for f in counters]
    assert after == [(b[0] + 1, b[1] + 1, b[2] + int(cross)) for b in before]
    want = sdpa_forward_reference(q, k, v, mask, -77, NH, causal, 0.1)
    assert out.dtype == F32 and torch.isfinite(out).all() and _rel_max(out, want) <= F32_FWD
    for a, b in zip(grads, sdpa_backward_reference(q, k, v, mask, -77, g, NH, causal, 0.1)):
        assert a.dtype == F32 and a.shape == b.shape and _rel_max(a, b) <= F32_GRAD


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_f32_keep_masks_are_exact(gen, causal):
    """As test_sdpa_keep_masks_are_exact, in f32, forward (the context) and
    backward (dv)."""
    B, S, H, NH = 9, 12, 128, 2
    hd = H // NH
    q = torch.zeros(B, S, H, device="cuda")
    v = torch.zeros(B, S, H, device="cuda")
    for h in range(NH):
        v[:, torch.arange(S), h * hd + torch.arange(S)] = 1.0
    ctx = sdpa_forward(q, q, v, None, 123, NH, causal, 0.3).view(B, S, NH, hd)[..., :S]
    dv = sdpa_backward(q, q, v, None, 123, v, NH, causal, 0.3)[2].view(B, S, NH, hd)[..., :S]
    tril = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    for h in range(NH):
        keep = attention_keep(123, h, B, S, S, 0.3, "cuda") > 0
        if causal:
            keep &= tril
        assert torch.equal(ctx[:, :, h] > 0, keep)
        assert torch.equal(dv[:, :, h].transpose(1, 2) > 0, keep)


@pytest.mark.parametrize("causal,masked", [(False, True), (True, False), (True, True)])
def test_mha_f32_kernel_matches_plain(gen, causal, masked):
    """#13's f32 instance: masked rows and a fully masked sentence (uniform
    over every key), through its wrapper and its autograd."""
    B, S, H, NH = 21, 12, 256, 4
    q, k, v = (t.detach().requires_grad_() for t in _views(gen, False, B, S, S, H, F32))
    mask = None
    if masked:
        mask = torch.randint(0, 2, (B, S), device="cuda", generator=gen, dtype=torch.int32)
        mask[:, 0] = 1
        mask[3] = 0
    before = mha_forward.launches, mha_forward.f32_launches
    out = fused_mha(q, k, v, mask, NH, causal)
    out.backward(torch.randn(B, S, H, device="cuda", generator=gen))
    torch.cuda.synchronize()
    assert (mha_forward.launches, mha_forward.f32_launches) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        want = mha_reference(q, k, v, mask, NH, causal)
        assert out.dtype == F32 and _rel_max(out, want) <= F32_FWD
        assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
        if masked:
            assert _rel_max(out[3], v[3].mean(0).expand(S, H)) <= F32_FWD


def test_sdpa_and_mha_reject_what_they_do_not_take(gen):
    q = torch.randn(2, 12, 128, device="cuda", generator=gen).half()
    with pytest.raises(TypeError, match="bfloat16"):
        sdpa_forward(q, q, q, None, 0, 2)
    with pytest.raises(TypeError, match="dtype"):  # bf16 q with f32 k and v
        sdpa_forward(q.bfloat16(), q.float(), q.float(), None, 0, 2)
    long = torch.zeros(2, 33, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="sequences"):
        sdpa_forward(long, long, long, None, 0, 2)
    with pytest.raises(ValueError, match="one sequence length"):
        mha_forward(q.bfloat16(), long[:, :9], long[:, :9], None, 2)
    qb, kb, vb = _views(gen, False, 2, 12, 12, 128)
    with pytest.raises(ValueError, match="strided"):  # k and v at two row strides
        sdpa_forward(qb, kb, vb.contiguous(), None, 0, 2)


# (s_q, s_k) across the attention kernel's 16- and 32-row tile edges
_EDGE_SHAPES = [(s, s) for s in (1, 7, 12, 16, 17, 32)] + [
    (1, 32), (7, 17), (12, 32), (16, 1), (17, 7), (32, 12)]


@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [64, 128, 40, 36, 33])
@pytest.mark.parametrize("SQ,SK", _EDGE_SHAPES)
def test_attention_kernels_at_tile_edges(gen, SQ, SK, hd, dtype):
    """Every attention entry at one shape: 37 sentences x 3 heads (111 warp
    units: the last CTA part-filled), sentence 3 fully masked; head_dim 40
    pads to 48 in bf16 (40 in f32), 36 and 33 take the element loads in bf16
    (rows not 16-byte aligned), 33 in f32. bf16 within 2e-2 of the largest
    magnitude; f32 forwards within F32_FWD, gradients within F32_GRAD, all
    outputs f32."""
    B, NH = 37, 3
    H, cross = NH * hd, SQ != SK
    if cross:
        packed = torch.randn(B, SQ, H, device="cuda", generator=gen).to(dtype)
        kv = torch.randn(B, SK, 2 * H, device="cuda", generator=gen).to(dtype)
        q, (k, v) = packed, kv.split(H, -1)
    else:
        packed, kv = torch.randn(B, SQ, 3 * H, device="cuda", generator=gen).to(dtype), None
        q, k, v = packed.split(H, -1)
    lens = torch.randint(1, SK + 1, (B,), device="cuda", generator=gen)
    mask = (torch.arange(SK, device="cuda")[None] < lens[:, None]).to(torch.int32)
    mask[3] = 0
    g = torch.randn(B, SQ, H, device="cuda", generator=gen).to(dtype)
    op, causal = (cross_op(NH), False) if cross else (0, True)
    fwd_bar, grad_bar = (F32_FWD, F32_GRAD) if dtype == F32 else (2e-2, 2e-2)

    def held(got, want, bar=grad_bar):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for a, b in zip(got, want):
            assert a.dtype == dtype and a.shape == b.shape
            assert torch.isfinite(a).all() and _rel_max(a, b) <= bar

    layer_args = (packed, kv, mask, NH, causal, 41, op, 0.1)
    held(attention_forward(*layer_args), attention_forward_reference(*layer_args), fwd_bar)
    bwd_args = (packed, kv, mask, g, NH, causal, 41, op, 0.1)
    held(attention_backward(*bwd_args), attention_backward_reference(*bwd_args))
    sdpa_args = (q, k, v, mask, -5)
    held(sdpa_forward(*sdpa_args, NH, False, 0.1),
         sdpa_forward_reference(*sdpa_args, NH, False, 0.1), fwd_bar)
    held(sdpa_backward(*sdpa_args, g, NH, False, 0.1),
         sdpa_backward_reference(*sdpa_args, g, NH, False, 0.1))
    if not cross:
        out = mha_forward(q, k, v, mask, NH, True)
        held(out, mha_reference(q, k, v, mask, NH, True), fwd_bar)
        torch.cuda.synchronize()
        # WHERE_MASK: the fully masked sentence is uniform over every key
        assert _rel_max(out[3], v[3].float().mean(0).expand(SQ, H)) <= fwd_bar


@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("S", [17, 32])
@pytest.mark.parametrize("cross", [False, True])
def test_attention_keep_masks_exact_at_tile_edges(gen, cross, S, dtype):
    """q = k = 0, v and g one-hot in the key / query position, read through
    split views of the packed qkv / kv: the context shows p * keep and dv
    its transpose, per (query, key, head), equal to the plain masks."""
    B, NH, hd = 9, 2, 64
    H = NH * hd
    onehot = torch.zeros(B, S, H, device="cuda")
    for h in range(NH):
        onehot[:, torch.arange(S), h * hd + torch.arange(S)] = 1.0
    onehot = onehot.to(dtype)
    zero = torch.zeros_like(onehot)
    if cross:
        packed, kv, op = zero, torch.cat([zero, onehot], -1), cross_op(NH)
    else:
        packed, kv, op = torch.cat([zero, zero, onehot], -1), None, 0
    ctx = attention_forward(packed, kv, None, NH, False, 1234, op, 0.3)
    grads = attention_backward(packed, kv, None, onehot, NH, False, 1234, op, 0.3)
    dv = (grads[1][..., H:] if cross else grads[..., 2 * H:]).view(B, S, NH, hd)[..., :S]
    ctx = ctx.view(B, S, NH, hd)[..., :S]
    for h in range(NH):
        keep = attention_keep(1234, op + h, B, S, S, 0.3, "cuda") > 0
        assert torch.equal(ctx[:, :, h] > 0, keep)
        assert torch.equal(dv[:, :, h].transpose(1, 2) > 0, keep)


def _attention_f64(q, k, v, mask, g, nh, causal, seed, op_base, rate):
    """The plain versions' function (ops/layer.py ``_attention`` and
    ``attention_grads``: additive NEG_INF masks, p = softmax, the keep mask on
    p) in f64, the gradients through autograd: (ctx, (dq, dk, dv))."""
    b, sq, H = q.shape
    sk, hd = k.shape[1], H // nh
    leaves = [t.detach().double().requires_grad_() for t in (q, k, v)]
    qh, kh, vh = (t.reshape(b, t.shape[1], nh, hd).transpose(1, 2) for t in leaves)
    ok = torch.ones(b, 1, sq, sk, dtype=torch.bool, device="cuda")
    if mask is not None:
        ok = ok & (mask[:, None, None, :] > 0)
    if causal:
        ok = ok & torch.ones(sq, sk, dtype=torch.bool, device="cuda").tril()
    s = qh @ kh.transpose(-1, -2) / hd ** 0.5 + torch.where(ok, 0.0, -1e9)
    keep = torch.stack([attention_keep(seed, op_base + h, b, sq, sk, rate, "cuda")
                        for h in range(nh)], 1).double()
    ctx = ((torch.softmax(s, -1) * keep) @ vh).transpose(1, 2).reshape(b, sq, H)
    return ctx.detach(), torch.autograd.grad(ctx, leaves, g.double())


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_attention_f32_accuracy_at_the_step_shape(gen, cross):
    """The f32 attention forward and backward (3xTF32 products, one f32
    accumulator each) at the batch-2048 step's shape, (2048, 12, 768), 12
    heads, dropout 0.1 (self: a padded mask; cross: q and a packed kv),
    against the plain versions' function in f64: each output within F32_FWD
    (the context) or F32_GRAD (dq, dk, dv) of its largest magnitude. Prints
    each output's largest relative error."""
    B, S, H, NH, rate, seed = 2048, 12, 768, 12, 0.1, 2024
    if cross:
        packed = torch.randn(B, S, H, device="cuda", generator=gen)
        kv = torch.randn(B, S, 2 * H, device="cuda", generator=gen)
        (q, k, v), mask, op = (packed, *kv.split(H, -1)), None, cross_op(NH)
    else:
        packed, kv = torch.randn(B, S, 3 * H, device="cuda", generator=gen), None
        q, k, v = packed.split(H, -1)
        lens = torch.randint(1, S + 1, (B,), device="cuda", generator=gen)
        mask = (torch.arange(S, device="cuda")[None] < lens[:, None]).to(torch.int32)
        op = 0
    g = torch.randn(B, S, H, device="cuda", generator=gen)
    ctx = attention_forward(packed, kv, mask, NH, False, seed, op, rate)
    grads = attention_backward(packed, kv, mask, g, NH, False, seed, op, rate)
    torch.cuda.synchronize()
    want_ctx, want = _attention_f64(q, k, v, mask, g, NH, False, seed, op, rate)
    got = (grads[0], *grads[1].split(H, -1)) if cross else grads.split(H, -1)
    errs = {"ctx": _rel_max(ctx, want_ctx)}
    errs.update({n: _rel_max(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)})
    print(f"f32 attention at (2048, 12, 768), {'cross' if cross else 'self'}, largest relative "
          f"error against f64: " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    assert ctx.dtype == torch.float32 and all(a.dtype == torch.float32 for a in got)
    assert errs["ctx"] <= F32_FWD
    assert max(errs[n] for n in ("dq", "dk", "dv")) <= F32_GRAD


def test_layer_forward_counts_its_attention(gen):
    """Each fused layer forward adds its attention launches (one self, and a
    cross in a decoder layer) to ``attention_forward``'s counts."""
    for decoder in (False, True):
        geom, x, enc, smask, cmask, ws = _case(gen, decoder, 3, 12, 9, 128, 2, 256, decoder)
        before = attention_forward.launches, attention_forward.cross_launches
        with torch.no_grad():
            fused_bert_layer(geom, x, enc, smask, cmask, ws)
        assert (attention_forward.launches, attention_forward.cross_launches) == (
            before[0] + 1 + int(decoder), before[1] + int(decoder))


_GEMM_CASES = [("nn", e, BF) for e in ("f32", "bf16", "gelu_erf", "gelu_tanh")] + \
              [("nt", e, BF) for e in ("f32", "bf16", "add_f32", "add_bf16", "dgelu_erf",
                                       "dgelu_tanh")] + \
              [("tn", e, BF) for e in ("f32", "bf16")] + \
              [("nn", e, F32) for e in ("f32", "gelu_erf", "gelu_tanh")] + \
              [("nt", e, F32) for e in ("f32", "add_f32", "dgelu_erf", "dgelu_tanh")] + \
              [("tn", "f32", F32)]


def _gemm_case(gen, layout, epi, M, N, K, dtype=BF):
    a = torch.randn((K, M) if layout == "tn" else (M, K), device="cuda", generator=gen).to(dtype)
    b = (torch.randn((N, K) if layout == "nt" else (K, N), device="cuda", generator=gen)
         / K ** 0.5).to(dtype)
    kw = dict(a_t=layout == "tn", b_t=layout == "nt", epi=epi)
    if layout == "nn":
        kw["bias"] = 0.1 * torch.randn(N, device="cuda", generator=gen)
    if epi.startswith("add"):
        kw["aux"] = torch.randn(M, N, device="cuda", generator=gen)
    if epi.startswith("dgelu"):
        kw["aux"] = (2.0 * torch.randn(M, N, device="cuda", generator=gen)).to(dtype)
    return a, b, kw


def _gemm_f32(a, b, kw):
    """The plain version's value of each output before its last rounding."""
    acc = gemm_reference(a, b, a_t=kw["a_t"], b_t=kw["b_t"], epi="f32", bias=kw.get("bias"))
    epi = kw["epi"]
    if epi.startswith("gelu"):
        return gelu(acc, epi == "gelu_erf"), acc
    if epi.startswith("add"):
        return (acc + kw["aux"],)
    if epi.startswith("dgelu"):
        du = acc * gelu_grad(kw["aux"].float(), epi == "dgelu_erf")
        return du, du
    return (acc,)


def _gemm_held(got, want, what, rel=1e-4):
    tol = rel * want.abs().max().item() + torch.zeros_like(want)
    if got.dtype == torch.bfloat16:
        tol += torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 8)
    excess = ((got.float() - want).abs() - tol).max().item()
    assert got.shape == want.shape and excess <= 0, f"{what}: max excess {excess:.3e}"


# (N, K) of every case; the f32 GEMM's also at N and K off its 128-wide tile
# and 32-deep slice
_GEMM_NK = {BF: [(576, 192), (1536, 3072)], F32: [(576, 192), (1536, 3072), (200, 200), (8, 40)]}


@pytest.mark.parametrize("layout,epi,dtype,M,N,K", [
    (*case, M, N, K) for case in _GEMM_CASES for M in (1, 96, 2052, 127, 129)
    for N, K in _GEMM_NK[case[2]]])
def test_gemm_kernel_matches_plain(gen, layout, epi, dtype, M, N, K):
    """Every layout and epilogue at ragged rows (M 127 / 129 about the
    128-row tile); in f32 (3xTF32) the forward's (NN) outputs within 2e-5 of
    their largest magnitude, the gradients' within 1e-4, also at K = 3,072
    and at N and K that are not multiples of the f32 tile (200, 8 / 40)."""
    a, b, kw = _gemm_case(gen, layout, epi, M, N, K, dtype)
    two = epi.startswith(("gelu", "dgelu"))
    before = gemm.launches, gemm.f32_launches
    if layout == "tn" and M % 8:  # A stored (K, M): rows of M elements, not a multiple of 8
        with pytest.raises(ValueError, match="multiple of 8"):
            gemm(a, b, **kw)
        return
    got = gemm(a, b, **kw, out2=two)
    torch.cuda.synchronize()
    assert (gemm.launches, gemm.f32_launches) == (before[0] + 1, before[1] + int(dtype == F32))
    got = got if two else (got,)
    rel = 1e-4 if dtype == BF else F32_FWD if layout == "nn" else F32_GRAD
    for i, (g, w) in enumerate(zip(got, _gemm_f32(a, b, kw))):
        assert torch.isfinite(g).all() and (dtype == BF or g.dtype == F32)
        _gemm_held(g, w, f"{layout} {epi} {dtype} output {i}", rel)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_gemm_weight_gradient_is_deterministic(gen, dtype):
    """A weight gradient over 24,576 rows: split-K partials summed in a fixed
    order give the same bits in every run."""
    x = torch.randn(24576, 768, device="cuda", generator=gen).to(dtype)
    dy = (0.1 * torch.randn(24576, 768, device="cuda", generator=gen)).to(dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = gemm_plan(768, 768, 24576, True, sms) if dtype == BF else \
        gemm_f32_plan(768, 768, 24576, sms)
    assert plan.splits > 1
    epi = "bf16" if dtype == BF else "f32"
    one, two = gemm(x, dy, a_t=True, epi=epi), gemm(x, dy, a_t=True, epi=epi)
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    _gemm_held(one, gemm_reference(x, dy, a_t=True), "wgrad",
               1e-4 if dtype == BF else F32_GRAD)


_TF32_CHECK = r"""
#include <cstdint>
#include <cstdio>
__global__ void check(unsigned* bad) {  // every f32 bit pattern that is not a NaN
  const uint64_t step = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < (1ull << 32); i += step) {
    const uint32_t x = (uint32_t)i;
    if ((x & 0x7fffffffu) > 0x7f800000u) continue;
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(__uint_as_float(x)));
    if (r & 0x1fffu) atomicAdd(bad, 1u);                             // low bits set
    if (r != ((x + 0x1000u) & 0xffffe000u)) atomicAdd(bad + 1, 1u);  // not ties-away
  }
}
int main() {
  unsigned* bad;
  cudaMalloc(&bad, 8);
  cudaMemset(bad, 0, 8);
  check<<<132 * 16, 256>>>(bad);
  unsigned r[2];
  cudaMemcpy(r, bad, 8, cudaMemcpyDeviceToHost);
  printf("%u %u\n", r[0], r[1]);
  return cudaGetLastError() != cudaSuccess;
}
"""


def test_tf32_conversion_zeroes_the_low_bits(gen, tmp_path):
    """The f32 GEMM splits x into big = cvt.rna.tf32(x) and the TF32
    rounding of x - big with no mask between, and the f32 attention rounds
    the same way on two integer operations (layer_common.cuh to_tf32_int):
    on the card, cvt.rna's result has its 13 low bits zero and equals (bits
    + 0x1000) & ~0x1fff, round to nearest with ties away from zero, for every
    f32 bit pattern that is not a NaN."""
    import subprocess

    from kindergarten_vq_vae_torch import _build

    src, exe = tmp_path / "check.cu", tmp_path / "check"
    src.write_text(_TF32_CHECK)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(exe),
                    str(src)], check=True, capture_output=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    assert out.split() == ["0", "0"], out


@pytest.mark.parametrize("layout,M,N,K", [("nn", 2048, 768, 3072), ("tn", 768, 3072, 24576),
                                          ("tn", 30528, 768, 24576)])
def test_gemm_f32_error_over_a_long_k(gen, layout, M, N, K):
    """The f32 GEMM adds each 32-deep slice's products, summed by the tensor
    cores, to its f32 sums with one rounded add: its largest error against
    torch.matmul in full f32 at K = 3,072 and over the weight gradients'
    and the table gradient's K chunks stays within the f32 bars."""
    a = torch.randn((K, M) if layout == "tn" else (M, K), device="cuda", generator=gen)
    b = torch.randn(K, N, device="cuda", generator=gen) / K ** 0.5
    got = gemm(a, b, a_t=layout == "tn")
    torch.cuda.synchronize()
    want = (a.t() if layout == "tn" else a) @ b
    rel = _rel_max(got, want)
    print(f"f32 GEMM {layout} ({M},{N},{K}): largest error {rel:.3e} of the largest magnitude")
    assert rel <= (F32_FWD if layout == "nn" else F32_GRAD)


def test_gemm_kernel_rejects_what_it_does_not_take(gen):
    a, b, kw = _gemm_case(gen, "nt", "add_f32", 96, 576, 192)
    with pytest.raises(ValueError, match="no epilogue"):
        gemm(a, b, a_t=True, b_t=True)
    with pytest.raises(ValueError, match="no epilogue"):
        gemm(a, b, b_t=True, epi="gelu_erf")
    with pytest.raises(ValueError, match="needs aux"):
        gemm(a, b, b_t=True, epi="add_f32")
    with pytest.raises(TypeError, match="bfloat16"):
        gemm(a.float(), b, b_t=True)
    with pytest.raises(ValueError, match="out2"):
        gemm(a, b, b_t=True, epi="bf16", out2=True)
    with pytest.raises(ValueError, match="colsum"):
        gemm(a, b, b_t=True, epi="add_f32", aux=kw["aux"], colsum=True)
    shifted = torch.empty(a.numel() + 8, dtype=a.dtype, device=a.device)[8:].view(a.shape)
    shifted.copy_(a)
    gemm(shifted, b, b_t=True)  # 16 bytes in: taken
    odd = torch.empty(a.numel() + 4, dtype=a.dtype, device=a.device)[4:].view(a.shape)
    with pytest.raises(ValueError, match="16-byte"):
        gemm(odd, b, b_t=True)


# ------------------------------------------------ LayerNorm and column sums
_LN_ROWS = (1, 31, 33, 97, 24576)


def _ln_params(gen, N):
    gamma = 1.0 + 0.1 * torch.randn(N, device="cuda", generator=gen)
    gamma[3] = 0.0
    return gamma, 0.1 * torch.randn(N, device="cuda", generator=gen)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N", [64, 768, 1024])
@pytest.mark.parametrize("rows", _LN_ROWS)
def test_residual_layernorm_kernel_matches_plain(gen, rows, N, rate, dtype):
    x = torch.randn(rows, N, device="cuda", generator=gen).to(dtype)
    a = 0.5 * torch.randn(rows, N, device="cuda", generator=gen) + 0.2
    gamma, beta = _ln_params(gen, N)
    before = residual_layernorm.launches, residual_layernorm.f32_launches
    out, inv = residual_layernorm(x, a, gamma, beta, 1e-12, -77, OP_CROSS_OUT, rate)
    torch.cuda.synchronize()
    assert (residual_layernorm.launches, residual_layernorm.f32_launches) == (
        before[0] + 1, before[1] + int(dtype == F32))
    keep = hidden_keep(-77, OP_CROSS_OUT, rows, N, rate, "cuda") if rate else None
    r = x.float() + (a if keep is None else a * keep)
    mu = r.mean(-1, keepdim=True)
    want_inv = torch.rsqrt(torch.clamp((r * r).mean(-1, keepdim=True) - mu * mu, min=0.0) + 1e-12)
    _gemm_held(out, (r - mu) * want_inv * gamma + beta, "out", 1e-4 if dtype == BF else F32_FWD)
    assert out.dtype == dtype and _rel_max(inv, want_inv[:, 0]) <= 1e-5
    ref_out, ref_inv = residual_layernorm_reference(x, a, gamma, beta, 1e-12, keep)
    assert ref_out.dtype == dtype and torch.equal(ref_inv, want_inv[:, 0])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("v_dtype,gy_dtype", [(BF, BF), (BF, F32), (F32, F32)])
@pytest.mark.parametrize("N", [64, 768, 1024])
@pytest.mark.parametrize("rows", _LN_ROWS)
def test_layernorm_backward_kernel_matches_plain(gen, rows, N, v_dtype, gy_dtype, rate):
    gamma, beta = _ln_params(gen, N)
    v = torch.randn(rows, N, device="cuda", generator=gen).to(v_dtype)
    inv = 0.5 + 1.5 * torch.rand(rows, device="cuda", generator=gen)
    gy = torch.randn(rows, N, device="cuda", generator=gen).to(gy_dtype)
    before = layernorm_backward.launches
    got = layernorm_backward(gy, v, inv, gamma, beta, 5, OP_MLP_OUT, rate)
    torch.cuda.synchronize()
    assert layernorm_backward.launches == before + 1
    keep = hidden_keep(5, OP_MLP_OUT, rows, N, rate, "cuda") if rate else None
    want = layernorm_backward_reference(gy, v, inv, gamma, beta, keep)
    assert got[0].dtype == torch.float32 and _rel_max(got[0], want[0]) <= 1e-5
    assert got[1].dtype == v_dtype
    _gemm_held(got[1], want[1], "da", 1e-4 if v_dtype == BF else F32_GRAD)
    for name, g, w in zip(("dgamma", "dbeta", "dbias"), got[2:], want[2:]):
        assert g.shape == (N,) and _rel_max(g, w) <= 1e-4, name
    assert got[2][3].item() == 0.0
    again = layernorm_backward(gy, v, inv, gamma, beta, 5, OP_MLP_OUT, rate)
    for one, two in zip(got, again):
        assert torch.equal(one, two)  # the same bits in every run


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("N", [768, 1536, 2304, 3072])
@pytest.mark.parametrize("rows", (1, 31, 33, 97, 255, 257, 24576))
def test_column_sums_kernel_matches_plain(gen, rows, N, dtype):
    src = torch.randn(rows, N, device="cuda", generator=gen).to(dtype)
    before = column_sums.launches
    got = column_sums(src)
    torch.cuda.synchronize()
    assert column_sums.launches == before + 1
    assert got.dtype == torch.float32 and _rel_max(got, column_sums_reference(src)) <= 1e-4
    assert torch.equal(got, column_sums(src))


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("N,K", [(768, 192), (3072, 768)])
@pytest.mark.parametrize("M", (1, 31, 33, 97, 129, 24576))
@pytest.mark.parametrize("epi", ["dgelu_erf", "dgelu_tanh"])
def test_gemm_gelu_gradient_column_sums(gen, epi, M, N, K, dtype):
    """b1 from the GELU-gradient GEMM's epilogue partials, against the plain
    f32 du's column sums and against the sums of the kernel's own f32 du."""
    dy, w2, kw = _gemm_case(gen, "nt", epi, M, N, K, dtype)
    du, du_f32, b1 = gemm(dy, w2, **kw, out2=True, colsum=True)
    torch.cuda.synchronize()
    want = _gemm_f32(dy, w2, kw)[0]
    _gemm_held(du, want, f"{epi} du")
    assert b1.dtype == torch.float32 and b1.shape == (N,)
    assert _rel_max(b1, want.sum(0)) <= 1e-4
    assert _rel_max(b1, du_f32.sum(0)) <= 1e-5
    du2, b1_again = gemm(dy, w2, **kw, colsum=True)
    assert torch.equal(du2, du) and torch.equal(b1_again, b1)  # the same bits in every run


def test_layernorm_kernels_reject_what_they_do_not_take(gen):
    x = torch.randn(33, 64, device="cuda", generator=gen).bfloat16()
    a = torch.randn(33, 64, device="cuda", generator=gen)
    g, b = _ln_params(gen, 64)
    inv = torch.ones(33, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):  # f16: neither bf16 nor f32
        residual_layernorm(x.half(), a, g, b, 1e-12)
    with pytest.raises(ValueError, match="shape"):
        residual_layernorm(x, a[:32], g, b, 1e-12)
    with pytest.raises(ValueError, match="multiple of 8"):
        residual_layernorm(x[:, :60].contiguous(), a[:, :60].contiguous(), g[:60], b[:60], 1e-12)
    with pytest.raises(ValueError, match="16-byte"):
        odd = torch.empty(a.numel() + 1, device="cuda")[1:].view(a.shape)
        residual_layernorm(x, odd, g, b, 1e-12)
    with pytest.raises(TypeError, match="bfloat16"):
        layernorm_backward(x, x.float(), inv, g, b)
    with pytest.raises(ValueError, match="shape"):
        layernorm_backward(x, x, inv[:32], g, b)
    with pytest.raises(ValueError, match="multiple of 8"):
        layernorm_backward(x[:, :60].contiguous(), x[:, :60].contiguous(), inv, g[:60], b[:60])
    with pytest.raises(ValueError, match="at most"):
        wide = torch.zeros(2, 1032, device="cuda").bfloat16()
        layernorm_backward(wide, wide, inv[:2], torch.ones(1032, device="cuda"),
                           torch.zeros(1032, device="cuda"))
    with pytest.raises(TypeError, match="bfloat16"):
        column_sums(a.half())
    with pytest.raises(ValueError, match="multiple of 8"):
        column_sums(x[:, :60].contiguous())


@pytest.mark.parametrize("decoder", [False, True])
def test_layer_training_step_counts_its_layernorm_kernels(gen, decoder):
    """A layer's forward and backward under autograd launch the residual +
    LayerNorm 2 / 3 times (encoder / decoder), the LayerNorm backward as
    often, and the column sums for bqkv (and bq, bkv); b1 comes from the GELU
    gradient's GEMM, one of its 8 / 14 backward products."""
    geom, x, enc, smask, cmask, ws = _case(gen, decoder, 5, 12, 9, 128, 2, 256, decoder)
    ws = [w.requires_grad_() for w in ws]
    counters = (residual_layernorm, layernorm_backward, column_sums, gemm)
    before = [f.launches for f in counters]
    out = fused_bert_layer(geom, x, enc, smask, cmask, ws)
    out.backward(torch.randn_like(out))
    torch.cuda.synchronize()
    n = 3 if decoder else 2
    assert [f.launches - b for f, b in zip(counters, before)] == [
        n, n, 3 if decoder else 1, 21 if decoder else 12]
    assert all(torch.isfinite(w.grad).all() for w in ws)


VARIANT_CASES = [("shelgon", {}),
                 ("shelgon", {"use_mask_encoder": False, "use_mask_decoder": False}),
                 ("shelgon2", {"mask_pct_train": 0.1}),
                 ("shelgon3", {"vq_mode": "GumbelQuantizer"})]


@pytest.mark.parametrize("model_name, over", VARIANT_CASES,
                         ids=["shelgon", "shelgon-masks-none", "shelgon2", "shelgon3-gumbel"])
def test_variant_kernel_route_matches_plain(gen, model_name, over):
    cfg = RunConfig(model_name=model_name, vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256, vq_e_dim=128, enc_out_size=128,
                    emb_size=128, word_embedding_size=128, tokenized_sentence_max_length=12,
                    compute_dtype="bfloat16", **over)
    model = init_weights(build_model(cfg, device="cuda"), gen)
    b = 48
    ids = torch.randint(1, 512, (b, 12), generator=gen, device="cuda")
    lens = torch.randint(3, 13, (b, 1), generator=gen, device="cuda")
    mask = (torch.arange(12, device="cuda")[None] < lens).to(torch.int32)
    labels = torch.randint(0, 3, (b, 5), generator=gen, device="cuda")
    labels8 = torch.randint(0, 3, (b, 8), generator=gen, device="cuda")
    batch = {"input_ids": ids * mask, "attention_mask": mask, "n_valid": b - 5,
             "labels": labels, "one_hot": torch.nn.functional.one_hot(labels, 3),
             "labels8": labels8, "one_hot8": torch.nn.functional.one_hot(labels8, 3)}

    def run(m, c, reference):
        for p in m.parameters():
            p.grad = None
        loss, _ = make_loss_fn(c, "train", reference=reference)(
            m, batch, torch.Generator(device="cuda").manual_seed(7), False)
        loss.backward()
        return loss.item(), {n: p.grad.float() for n, p in m.named_parameters()
                             if p.grad is not None}

    f32_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    f32 = build_model(f32_cfg, device="cuda")
    f32.load_state_dict(model.state_dict())
    _, ref = run(f32, f32_cfg, True)
    noise = 1e-6 * max(g.abs().max().item() for g in ref.values())
    dist = {}
    for path, reference in (("plain", True), ("kernel", False)):
        loss, got = run(model, cfg, reference)
        assert got.keys() == ref.keys() and all(torch.isfinite(g).all() for g in got.values())
        glob = (sum(((got[n] - ref[n]) ** 2).sum() for n in ref)
                / sum((ref[n] ** 2).sum() for n in ref)).sqrt().item()
        leaf = max(((got[n] - ref[n]).norm() / ref[n].norm()).item() for n in ref
                   if ref[n].abs().max() > noise)
        dist[path] = (loss, glob, leaf)
    (lp, gp, wp), (lk, gk, wk) = dist["plain"], dist["kernel"]
    assert abs(lk - lp) <= 1e-3 * abs(lp)
    assert gk <= 1.25 * gp and wk <= 1.25 * wp, dist


F32_ROUTE_CASES = [("shelgon3", {}), ("bagon", {"decoder_model_name": "gpt2",
                                                "decoder_vocab_size": 300})]


@pytest.mark.parametrize("model_name, over", F32_ROUTE_CASES, ids=["shelgon3-vq", "bagon-gpt2"])
def test_f32_kernel_route_matches_plain(gen, model_name, over):
    """One f32 training loss and backward (dropout 0.1 / 0.1) through the
    kernels' f32 instances against the f32 plain route from the same weights
    and generator seed: the loss within 1e-5 relative, the gradients within
    1e-4 global relative L2; every kernel launched is an f32 instance."""
    cfg = RunConfig(model_name=model_name, vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256, vq_e_dim=128, enc_out_size=128,
                    emb_size=128, word_embedding_size=128, tokenized_sentence_max_length=12,
                    compute_dtype="float32", **over)
    model = init_weights(build_model(cfg, device="cuda"), gen)
    b = 48
    ids = torch.randint(1, 300, (b, 12), generator=gen, device="cuda")
    lens = torch.randint(3, 13, (b, 1), generator=gen, device="cuda")
    mask = (torch.arange(12, device="cuda")[None] < lens).to(torch.int32)
    batch = {"input_ids": ids * mask, "attention_mask": mask, "n_valid": b - 5}
    if "gpt" in cfg.decoder_model_name:
        batch.update(dec_input_ids=ids * mask, dec_attention_mask=mask)
    counters = (fused_bert_layer, layer_backward, gemm, ce_fwd_ids, ce_bwd)

    def run(reference):
        for p in model.parameters():
            p.grad = None
        loss, _ = make_loss_fn(cfg, "train", reference=reference)(
            model, batch, torch.Generator(device="cuda").manual_seed(7), False)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    lp, ref = run(True)
    before = [(f.launches, f.f32_launches) for f in counters]
    lk, got = run(False)
    torch.cuda.synchronize()
    after = [(f.launches, f.f32_launches) for f in counters]
    for (n0, f0), (n1, f1) in zip(before, after):
        assert n1 > n0 and n1 - n0 == f1 - f0  # launched, and f32 instances only
    assert got.keys() == ref.keys() and all(torch.isfinite(g).all() for g in got.values())
    glob = (sum(((got[n] - ref[n]) ** 2).sum() for n in ref)
            / sum((ref[n] ** 2).sum() for n in ref)).sqrt().item()
    assert abs(lk - lp) <= 1e-5 * abs(lp) and glob <= 1e-4, (lk, lp, glob)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("vocab", [50257, 50264])
def test_ce_kernels_at_the_gpt2_vocabulary(gen, vocab, offset, dtype):
    """#7 and #8 at GPT-2's odd vocabulary (each row starts at another
    16-byte phase: eight over 64 rows in bf16, four in f32) and at the even
    50,264 (every row at the first row's phase), with ties, targets in a
    row's head, body and tail and outside the vocabulary: ids exact, NLL
    within 1e-4 (bf16) or 1e-5 relative (f32), dlogits within 1e-2 (bf16)
    or 1e-4 (f32) of the largest magnitude, at the logits' phase."""
    x, t = _ce_edge_case(gen, 64, vocab, offset, dtype)
    nll, ids = ce_fwd_ids(x, t)
    torch.cuda.synchronize()
    nll_p, ids_p = ce_fwd_ids_reference(x, t)
    assert torch.equal(ids, ids_p) and ids[-1] == 0
    _nll_held(nll, nll_p, dtype)
    phases = 16 // x.element_size() if vocab % 2 else 1
    assert len({x[r].data_ptr() % 16 for r in range(8)}) == phases
    _held_ce_bwd(gen, x, t, nll_p + target_logits(x, t))


def _gpt2_decoder_pass(model, ids, mask, enc, emask):
    """Logits, last hidden state and cross-attention maps in f32 (CPU), and
    every gradient of a fixed projection of the logits, with the encoder
    states' gradient among them."""
    enc = enc.detach().requires_grad_()
    for p in model.parameters():
        p.grad = None
    out = model(ids, mask, enc, emask, output_attentions=True)
    w = torch.linspace(-1.0, 1.0, out["logits"].shape[-1], device=ids.device)
    (out["logits"].float() * w).sum().backward()
    outs = {"logits": out["logits"], "last_hidden_state": out["last_hidden_state"],
            **{f"cross_{i}": a for i, a in enumerate(out["cross_attentions"])}}
    grads = {n: p.grad for n, p in model.named_parameters()} | {"encoder_states": enc.grad}
    return ({k: v.detach().float().cpu() for k, v in outs.items()},
            {k: v.float().cpu() for k, v in grads.items()})


def test_gpt2_decoder_on_the_card_matches_the_cpu(gen):
    """The GPT-2 decoder (2 blocks, H 128, 2 heads, vocabulary 50,257) in
    bf16 on the card, forward and backward, held to the CPU's f32 pass on the
    same weights: each output and the gradients (global relative L2) no
    further from it than 1.25 times the CPU's bf16 pass, plus one bf16 ulp
    (2^-8) of the output's largest magnitude."""
    from kindergarten_vq_vae_torch.nn.gpt2 import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config(vocab_size=50257, hidden_size=128, num_layers=2, num_heads=2)
    ref = init_weights(GPT2LMHeadModel(cfg), torch.Generator().manual_seed(0))
    cpu = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 50257, (6, 12), generator=cpu)
    mask = (torch.arange(12)[None] < torch.randint(3, 13, (6, 1), generator=cpu)).int()
    enc = torch.randn(6, 9, 128, generator=cpu)
    emask = (torch.arange(9)[None] < torch.tensor([[9], [5], [2], [9], [7], [1]])).int()
    passes = {}
    for what, device, dtype in (("f32", "cpu", torch.float32), ("cpu_bf16", "cpu", torch.bfloat16),
                                ("card_bf16", "cuda", torch.bfloat16)):
        model = GPT2LMHeadModel(dataclasses.replace(cfg, dtype=dtype), device=device)
        model.load_state_dict(ref.state_dict())
        passes[what] = _gpt2_decoder_pass(model, *(a.to(device) for a in (ids, mask, enc, emask)))
    (out32, g32), (outc, gc), (outk, gk) = passes["f32"], passes["cpu_bf16"], passes["card_bf16"]
    for k, want in out32.items():
        card, cpu_err = _rel_max(outk[k], want), _rel_max(outc[k], want)
        assert card <= 1.25 * cpu_err + 2.0 ** -8, (k, card, cpu_err)

    def dist(g):
        num = sum(((g[n] - g32[n]) ** 2).sum() for n in g32)
        return (num / sum((g32[n] ** 2).sum() for n in g32)).sqrt().item()

    assert all(torch.isfinite(g).all() for g in gk.values())
    assert dist(gk) <= 1.25 * dist(gc) + 2.0 ** -8, (dist(gk), dist(gc))


# ---------------------------------------------------------------- the serving ops and artifacts


@pytest.mark.parametrize("dtype", [BF, F32])
def test_custom_ops_equal_their_wrappers(gen, dtype):
    """``kvq::layer_fwd``, ``kvq::vq_fwd`` and ``kvq::sdpa_fwd`` on the card
    give their wrappers' direct launches bit for bit, one launch a call."""
    from kindergarten_vq_vae_torch.ops import layer as layer_ops
    from kindergarten_vq_vae_torch.ops import vq_kernel

    for decoder in (False, True):
        geom, x, enc, smask, cmask, ws = _case(gen, decoder, 5, 12, 9, 128, 2, 256, decoder,
                                               dtype=dtype)
        before = fused_bert_layer.launches
        with torch.inference_mode():
            got = torch.ops.kvq.layer_fwd(x, enc, smask, cmask, ws, *layer_ops._geom_args(geom),
                                          0)
            want = layer_ops._launch(geom, x, enc, smask, cmask, ws, 0, save=False)[0]
        assert fused_bert_layer.launches == before + 2
        assert got.dtype == dtype and torch.equal(got, want)

    z = torch.randn(7 * 12, 768, device="cuda", generator=gen)
    cb = torch.randn(9, 768, device="cuda", generator=gen)
    before = vector_quantize_kernel.launches
    got, want = torch.ops.kvq.vq_fwd(z, cb), vq_kernel._launch_packed(z, cb)
    assert vector_quantize_kernel.launches == before + 2
    assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))

    qkv = torch.randn(6, 12, 3 * 128, device="cuda", generator=gen).to(dtype)
    q, k, v = qkv.split(128, dim=-1)
    mask = (torch.arange(12, device="cuda")[None] < torch.tensor(
        [[12], [3], [7], [1], [12], [9]], device="cuda")).int()
    for causal, rate in ((True, 0.0), (False, 0.1)):
        before = sdpa_forward.launches
        got = torch.ops.kvq.sdpa_fwd(q, k, v, mask, 17, 2, causal, rate, False)
        want = sdpa_forward(q, k, v, mask, 17, 2, causal, rate)
        assert sdpa_forward.launches == before + 2
        assert got.dtype == dtype and torch.equal(got, want)


def _tiny_run(root: str, name: str, model_name: str, dtype: str, **over) -> str:
    """A run directory of seeded weights at a width the kernels take."""
    from kindergarten_vq_vae_torch.ckpt.bridge import params_to_jax
    from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name, write_checkpoint
    from kindergarten_vq_vae_torch.config import RunConfig
    from kindergarten_vq_vae_torch.data.tokenizer import WordTokenizer

    data_dir, run = os.path.join(root, "data"), os.path.join(root, name)
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(run)
    cfg = RunConfig(model_name=model_name, vocab_size=64, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256, compute_dtype=dtype, emb_size=128,
                    vq_n_e=9, vq_e_dim=128, data_dir=data_dir,
                    tokenized_sentence_max_length=12, **over)
    cfg.save(os.path.join(run, "run_conf.json"))
    WordTokenizer("i you he she eat buy the a apple car red big".split()).save(
        os.path.join(data_dir, cfg.tokenizer_file))
    model = init_weights(build_model(cfg, device="cuda"),
                         torch.Generator(device="cuda").manual_seed(0))
    write_checkpoint(os.path.join(run, best_ckpt_name(model_name, "loss_recon", "val")),
                     params_to_jax(model))
    return run


@pytest.mark.parametrize("name, model_name, dtype, over, launches", [
    ("vq_bf16", "shelgon3", "bfloat16", {}, (4, 0, 1)),
    ("vq_f32", "shelgon3", "float32", {}, (4, 0, 1)),
    ("shelgon_bf16", "shelgon", "bfloat16", {}, (4, 0, 0)),
    ("off_bf16", "shelgon3", "bfloat16", {"fused_layer": "off"}, (0, 6, 1)),
])
def test_artifact_exported_on_the_card_equals_the_live_forward(gen, tmp_path, name, model_name,
                                                               dtype, over, launches):
    """An artifact exported on the card gives the live kernel forward's ids
    and codes bit for bit, with the live forward's launches (layer, SDPA, VQ)
    and no launch in its export; it refuses the CPU."""
    from kindergarten_vq_vae_torch.serve.export import export_reconstructor, load_exported
    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor

    run = _tiny_run(str(tmp_path), name, model_name, dtype, **over)

    def counts():
        return (fused_bert_layer.launches, sdpa_forward.launches,
                vector_quantize_kernel.launches)

    before = counts()
    out, meta = export_reconstructor(run, bucket=16, out_path=str(tmp_path / "art"))
    assert counts() == before and meta["device"] == "cuda"
    live = Reconstructor(run, batch_buckets=(16,))
    served = Reconstructor(run, artifact=out)
    ids = torch.randint(1, 64, (16, 12), device="cuda", generator=gen, dtype=torch.int32)
    mask = (torch.arange(12, device="cuda")[None] < torch.randint(
        1, 13, (16, 1), device="cuda", generator=gen)).int()
    with torch.inference_mode():
        want = live.forward(ids, mask)
        before = counts()
        got = served.forward(ids, mask)
        torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == launches
    assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="exported for cuda"):
        load_exported(out, device="cpu")
