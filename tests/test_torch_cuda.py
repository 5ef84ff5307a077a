"""CUDA kernels of the PyTorch port vs their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present. This file imports
no JAX, so on a GPU machine without the JAX package it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Shapes here are the ragged ones chip_smoke.py does not reach: row counts
that are not a multiple of the GEMM tile, s_k != s_q, explicit cross masks.
Layer tolerance: bf16 outputs of O(1) magnitude, max abs 6e-2 (two bf16
ulps at |y| ~ 8), mean abs 2e-3; VQ: indices, z_q and counts exact.
Backward and attention backward: every output within 2e-2 of its leaf's
largest magnitude (kernel and plain share the bf16 rounding points; an f32
sum in another order flips an occasional bf16 rounding of an intermediate,
one ulp is 0.4%). CE: ids exact, NLL within 1e-4 absolute (values ~10,
f32 sums in another order), dlogits within 1e-2 of the largest magnitude
(one bf16 ulp).
"""

import pytest
import torch

from kindergarten_vq_vae_torch.ops.ce import (
    ce_bwd,
    ce_bwd_reference,
    ce_fwd_ids,
    ce_fwd_ids_reference,
)
from kindergarten_vq_vae_torch.ops.dropout import attention_keep, cross_op
from kindergarten_vq_vae_torch.ops.layer import (
    DEC_WEIGHTS,
    ENC_WEIGHTS,
    LayerGeom,
    attention_backward,
    attention_backward_reference,
    bert_layer_reference,
    fused_bert_layer,
    layer_backward,
    layer_backward_reference,
    layer_forward,
    layer_forward_reference,
    residual_names,
)
from kindergarten_vq_vae_torch.ops.vq import vector_quantize
from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _case(gen, decoder, B, S, SK, H, NH, F, with_cmask, gelu_exact=True):
    dev = torch.device("cuda")
    geom = LayerGeom(num_heads=NH, head_dim=H // NH, intermediate=F, causal=decoder,
                     has_cross=decoder, eps=1e-12, gelu_exact=gelu_exact)
    x = torch.randn(B, S, H, device=dev, generator=gen).bfloat16()
    enc = torch.randn(B, SK, H, device=dev, generator=gen).bfloat16() if decoder else None
    lens = torch.randint(1, S + 1, (B,), device=dev, generator=gen)
    smask = (torch.arange(S, device=dev)[None] < lens[:, None]).to(torch.int32)
    cmask = None
    if with_cmask:
        cmask = torch.randint(0, 2, (B, SK), device=dev, generator=gen, dtype=torch.int32)
        cmask[:, 0] = 1
    shapes, ws = geom.weight_shapes(), []
    for n in DEC_WEIGHTS if decoder else ENC_WEIGHTS:
        r = torch.randn(shapes[n], device=dev, generator=gen)
        ws.append((0.05 * r).bfloat16() if n.startswith("w") else 1.0 + 0.1 * r if n.startswith("g")
                  else 0.05 * r)
    return geom, x, enc, smask, cmask, ws


@pytest.mark.parametrize("decoder,B,S,SK,H,NH,F,with_cmask,gelu_exact", [
    (False, 5, 12, 12, 128, 2, 256, False, True),
    (True, 5, 12, 9, 128, 2, 256, True, True),
    (True, 11, 7, 16, 192, 3, 384, False, True),
    (False, 3, 32, 32, 256, 2, 512, False, True),
    (True, 4, 12, 12, 128, 2, 256, False, False),
])
def test_layer_kernel_matches_plain(gen, decoder, B, S, SK, H, NH, F, with_cmask, gelu_exact):
    geom, x, enc, smask, cmask, ws = _case(gen, decoder, B, S, SK, H, NH, F, with_cmask,
                                           gelu_exact)
    before = fused_bert_layer.launches
    with torch.inference_mode():
        out = fused_bert_layer(geom, x, enc, smask, cmask, ws)
        torch.cuda.synchronize()
        ref = bert_layer_reference(geom, x, enc, smask, cmask, ws)
    assert fused_bert_layer.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out).all()
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


@pytest.mark.parametrize("decoder,B,S,SK,H,NH,F", [
    (False, 5, 12, 12, 128, 2, 256),
    (True, 5, 12, 9, 128, 2, 256),
    (True, 11, 7, 16, 192, 3, 384),
    (False, 171, 12, 12, 128, 2, 256),   # 2052 rows: split-K weight gradients, uneven chunks
    (True, 205, 10, 12, 192, 3, 384),    # 2050 rows
])
def test_training_layer_kernels_match_plain(gen, decoder, B, S, SK, H, NH, F):
    """Training forward (dropout 0.1 / 0.1, residuals kept) and the backward
    kernels, each against its plain version on the same inputs. Past 2048
    rows the weight gradients take the split-K path."""
    geom, x, enc, smask, cmask, ws = _case(gen, decoder, B, S, SK, H, NH, F, decoder)
    geom = LayerGeom(**{**geom.__dict__, "attn_rate": 0.1, "hid_rate": 0.1})
    seed = -1234567
    before = fused_bert_layer.launches
    out, res = layer_forward(geom, x, enc, smask, cmask, ws, seed)
    torch.cuda.synchronize()
    assert fused_bert_layer.launches == before + 1
    out_p, res_p = layer_forward_reference(geom, x, enc, smask, cmask, ws, seed)
    err = (out.float() - out_p.float()).abs()
    assert torch.isfinite(out).all() and err.max() <= 6e-2 and err.mean() <= 2e-3
    for name, a, b in zip(residual_names(geom), res, res_p):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_max(a, b) <= 2e-2, name

    gy = (0.1 * torch.randn(x.shape, device="cuda", generator=gen)).bfloat16()
    before = layer_backward.launches
    got = layer_backward(geom, x, enc, smask, cmask, ws, seed, res_p, out_p, gy, torch.float32)
    torch.cuda.synchronize()
    assert layer_backward.launches == before + 1
    want = layer_backward_reference(geom, x, enc, smask, cmask, ws, seed, res_p, out_p, gy,
                                    torch.float32)
    assert got[0].dtype == torch.bfloat16 and _rel_max(got[0], want[0]) <= 2e-2
    if decoder:
        assert got[1].dtype == torch.float32 and _rel_max(got[1], want[1]) <= 2e-2
    names = DEC_WEIGHTS if decoder else ENC_WEIGHTS
    for n, w, a, b in zip(names, ws, got[2], want[2]):
        assert a.dtype == w.dtype and a.shape == w.shape, n
        assert torch.isfinite(a).all() and _rel_max(a, b) <= 2e-2, n


@pytest.mark.parametrize("cross", [False, True])
def test_attention_backward_kernel_matches_plain(gen, cross):
    B, S, SK, H, NH = 9, 12, 9 if cross else 12, 256, 4
    q = torch.randn(B, S, H if cross else 3 * H, device="cuda", generator=gen).bfloat16()
    kv = torch.randn(B, SK, 2 * H, device="cuda", generator=gen).bfloat16() if cross else None
    lens = torch.randint(1, SK + 1, (B,), device="cuda", generator=gen)
    mask = (torch.arange(SK, device="cuda")[None] < lens[:, None]).to(torch.int32)
    g = torch.randn(B, S, H, device="cuda", generator=gen).bfloat16()
    op = cross_op(NH) if cross else 0
    before = attention_backward.launches
    before_cross = attention_backward.cross_launches
    got = attention_backward(q, kv, mask, g, NH, not cross, 77, op, 0.1)
    torch.cuda.synchronize()
    assert attention_backward.launches == before + 1
    assert attention_backward.cross_launches == before_cross + int(cross)
    want = attention_backward_reference(q, kv, mask, g, NH, not cross, 77, op, 0.1)
    for a, b in zip(got if cross else (got,), want if cross else (want,)):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _rel_max(a, b) <= 2e-2


def test_attention_keep_mask_is_visible_and_exact(gen):
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
    x = x.bfloat16()
    smask = torch.ones(B, S, dtype=torch.int32, device="cuda")
    shapes, ws = geom.weight_shapes(), []
    for n in ENC_WEIGHTS:
        w = torch.zeros(shapes[n], device="cuda")
        if n == "wqkv":
            w[:, 2 * H:] = torch.eye(H, device="cuda")
        if n.startswith("g"):
            w += 1.0
        ws.append(w.bfloat16() if n.startswith("w") else w)
    _, res = layer_forward(geom, x, None, smask, None, ws, 99)
    ctx = res[residual_names(geom).index("ctx")].view(B, S, NH, hd)[..., :S]
    for h in range(NH):
        keep = attention_keep(99, h, B, S, S, 0.3, "cuda") > 0
        assert torch.equal(ctx[:, :, h] > 0, keep)


def test_ce_kernels_match_plain(gen):
    rows, vocab = 1000, 30522
    x = (3.0 * torch.randn(rows, vocab, device="cuda", generator=gen)).bfloat16()
    x[0, [5, 9000, 30000]] = 40.0   # ties far apart
    x[1, [7, 8]] = 40.0             # ties side by side
    x[2] = 0.5                      # an all-equal row
    t = torch.randint(0, vocab, (rows,), device="cuda", generator=gen, dtype=torch.int32)
    before = ce_fwd_ids.launches, ce_bwd.launches
    nll, ids = ce_fwd_ids(x, t)
    torch.cuda.synchronize()
    nll_p, ids_p = ce_fwd_ids_reference(x, t)
    assert torch.equal(ids, ids_p) and ids[0] == 5 and ids[1] == 7 and ids[2] == 0
    assert (nll - nll_p).abs().max() <= 1e-4
    lse = nll_p + x.float().gather(1, t.long()[:, None])[:, 0]
    scale = torch.rand(rows, device="cuda", generator=gen) / rows
    got = ce_bwd(x, t, lse, scale)
    torch.cuda.synchronize()
    assert (ce_fwd_ids.launches, ce_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16 and _rel_max(got, ce_bwd_reference(x, t, lse, scale)) <= 1e-2
    odd = x[:, :30521].contiguous()  # odd vocab: the scalar path
    assert torch.equal(ce_fwd_ids(odd, t.clamp(max=30520))[1],
                       ce_fwd_ids_reference(odd, t.clamp(max=30520))[1])
