"""CUDA kernels of the PyTorch port vs their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present. This file imports
no JAX, so on a GPU machine without the JAX package it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Shapes here are the ragged ones chip_smoke.py does not reach: row counts
that are not a multiple of the GEMM tile, s_k != s_q, explicit cross masks.
Layer tolerance: bf16 outputs of O(1) magnitude, max abs 6e-2 (two bf16
ulps at |y| ~ 8), mean abs 2e-3; VQ: indices, z_q and counts exact.
"""

import pytest
import torch

from kindergarten_vq_vae_torch.ops.layer import (
    DEC_WEIGHTS,
    ENC_WEIGHTS,
    LayerGeom,
    bert_layer_reference,
    fused_bert_layer,
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
