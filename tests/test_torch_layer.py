"""Plain fused-layer forward of the PyTorch port vs the JAX package's fused
layer kernel (ops/layer_pallas.py, interpret mode on the CPU), encoder and
decoder geometry, f32, with masks that hold zeros and a batch that is not a
multiple of the kernel's sentence tile. Tolerance atol = rtol = 2e-5: f32
on both sides; the two differ only in summation order and tanh/exp ulps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.layer_pallas import LayerGeom as JaxGeom
from kindergarten_vq_vae_tpu.ops.layer_pallas import fused_bert_layer as jax_fused_layer
from kindergarten_vq_vae_torch.ops.layer import (
    DEC_WEIGHTS,
    ENC_WEIGHTS,
    LayerGeom,
    bert_layer_reference,
    fused_bert_layer,
    gelu,
)

H, NH, F = 64, 4, 128


def _inputs(decoder: bool, B=5, S=12, SK=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H)).astype(np.float32)
    enc = rng.normal(size=(B, SK, H)).astype(np.float32) if decoder else None
    smask = rng.integers(0, 2, (B, S)).astype(np.int32)
    smask[:, 0] = 1  # every query keeps a visible key (causal rows see key 0)
    cmask = None
    if decoder:
        cmask = rng.integers(0, 2, (B, SK)).astype(np.int32)
        cmask[:, 0] = 1
    names = DEC_WEIGHTS if decoder else ENC_WEIGHTS
    geom = LayerGeom(num_heads=NH, head_dim=H // NH, intermediate=F, causal=decoder,
                     has_cross=decoder, eps=1e-12, gelu_exact=True)
    shapes = geom.weight_shapes()
    # LayerNorm scales around 1, every other weight and bias around 0
    ws = [(1.0 if n.startswith("g") else 0.0) + rng.normal(scale=0.1, size=shapes[n])
          for n in names]
    return geom, x, enc, smask, cmask, [w.astype(np.float32) for w in ws]


def _jax_out(geom, x, enc, smask, cmask, ws, sk):
    jgeom = JaxGeom(num_heads=geom.num_heads, head_dim=geom.head_dim, s_q=x.shape[1], s_k=sk,
                    intermediate=geom.intermediate, causal=geom.causal, has_cross=geom.has_cross,
                    attn_rate=0.0, hid_rate=0.0, eps=geom.eps, gelu_exact=geom.gelu_exact,
                    block_b_fwd=4, block_b_bwd=2)
    out = jax_fused_layer(jgeom, jnp.asarray(x), None if enc is None else jnp.asarray(enc),
                          jnp.asarray(smask), None if cmask is None else jnp.asarray(cmask),
                          jnp.asarray([0], jnp.int32), None, *map(jnp.asarray, ws))
    return np.asarray(out)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("decoder,sk,gelu_exact", [
    (False, 12, True), (True, 12, True), (True, 9, True), (False, 12, False),
])
def test_reference_matches_jax_fused_layer(decoder, sk, gelu_exact):
    geom, x, enc, smask, cmask, ws = _inputs(decoder, SK=sk)
    geom = LayerGeom(**{**geom.__dict__, "gelu_exact": gelu_exact})
    want = _jax_out(geom, x, enc, smask, cmask, ws, sk)
    got = bert_layer_reference(geom, _t(x), _t(enc), _t(smask), _t(cmask), [_t(w) for w in ws])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_wrapper_on_cpu_is_the_reference_and_launches_nothing():
    geom, x, enc, smask, cmask, ws = _inputs(True)
    before = fused_bert_layer.launches
    got = fused_bert_layer(geom, _t(x), _t(enc), _t(smask), _t(cmask), [_t(w) for w in ws])
    want = bert_layer_reference(geom, _t(x), _t(enc), _t(smask), _t(cmask), [_t(w) for w in ws])
    assert torch.equal(got, want)
    assert fused_bert_layer.launches == before


def test_wrapper_refuses_dropout_and_grad():
    """Dropout needs a seed and a rate in [0, 1); the backward takes one
    derivative, not a second."""
    geom, x, enc, smask, cmask, ws = _inputs(False)
    ws = [_t(w) for w in ws]
    with pytest.raises(ValueError, match="dropout"):
        fused_bert_layer(LayerGeom(**{**geom.__dict__, "hid_rate": 0.1}), _t(x), None, None, None, ws)
    with pytest.raises(ValueError, match="dropout"):
        fused_bert_layer(LayerGeom(**{**geom.__dict__, "attn_rate": 1.0}), _t(x), None, None, None,
                         ws, seed=1)
    xg = _t(x).requires_grad_()
    (gx,) = torch.autograd.grad(fused_bert_layer(geom, xg, None, None, None, ws).sum(), xg,
                                create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|does not require grad"):
        gx.sum().backward()


def test_gelu_polynomial_matches_jax():
    from kindergarten_vq_vae_tpu.ops.layer_pallas import _gelu_fwd

    u = np.linspace(-8.0, 8.0, 4097, dtype=np.float32)
    for exact in (True, False):
        want = np.asarray(_gelu_fwd(jnp.asarray(u), exact))
        np.testing.assert_allclose(gelu(torch.from_numpy(u), exact).numpy(), want,
                                   atol=2e-6, rtol=1e-6)


def test_bf16_reference_keeps_rounding_points():
    """In bf16 the plain layer keeps the JAX kernel's rounding points: an
    element may differ by at most one bf16 rounding flip (3.1e-2 at |y| < 8),
    and flips are rare (mean abs 5e-4)."""
    geom, x, enc, smask, cmask, ws = _inputs(True, B=3)
    names = DEC_WEIGHTS
    x16 = torch.from_numpy(x).bfloat16()
    enc16 = torch.from_numpy(enc).bfloat16()
    w_t = [torch.from_numpy(w).bfloat16() if n.startswith("w") else torch.from_numpy(w)
           for n, w in zip(names, ws)]
    got = bert_layer_reference(geom, x16, enc16, _t(smask), _t(cmask), w_t).float().numpy()
    jgeom = JaxGeom(num_heads=NH, head_dim=H // NH, s_q=12, s_k=12, intermediate=F, causal=True,
                    has_cross=True, attn_rate=0.0, hid_rate=0.0, eps=1e-12, gelu_exact=True,
                    block_b_fwd=4, block_b_bwd=2)
    jw = [jnp.asarray(w, jnp.bfloat16) if n.startswith("w") else jnp.asarray(w)
          for n, w in zip(names, ws)]
    want = np.asarray(jax_fused_layer(
        jgeom, jnp.asarray(x, jnp.bfloat16), jnp.asarray(enc, jnp.bfloat16), jnp.asarray(smask),
        jnp.asarray(cmask), jnp.asarray([0], jnp.int32), None, *jw).astype(jnp.float32))
    err = np.abs(got - want)
    assert err.max() <= 3.2e-2 and err.mean() <= 5e-4, (err.max(), err.mean())
