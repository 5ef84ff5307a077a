"""Training mode of the port's fused layer vs the JAX package, on the CPU.

Hash-dropout keep masks are held bit for bit against ``_keep_2d`` and
``_dropout_keep_scale``. The port's training forward and plain backward, with
dropout 0.1 / 0.1, are held against ``jax.vjp`` of the JAX ``fused_bert_layer``
(Pallas in interpret mode, same seed) in f32: output, dx, denc and every
weight gradient, each to max|port - jax| / max|jax| <= 1e-4 (f32 on both
sides; they differ in summation order, and the JAX backward recovers the
LayerNorm's normalised values from its stored outputs). The attention
forward alone is held against ``_attn_fwd_tile`` and the attention backward
against ``_attn_bwd_call`` to the same criterion, at 12 rows and at the card
kernel's tile edges (17 and 32 rows, self and cross).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.layer_pallas import LayerGeom as JaxGeom
from kindergarten_vq_vae_tpu.ops.layer_pallas import _attn_bwd_call, _keep_2d
from kindergarten_vq_vae_tpu.ops.layer_pallas import fused_bert_layer as jax_fused_layer
from kindergarten_vq_vae_tpu.ops.sdpa_pallas import _dropout_keep_scale, _tile_geometry
from kindergarten_vq_vae_torch.ops.dropout import attention_keep, cross_op, hidden_keep
from kindergarten_vq_vae_torch.ops.layer import (
    DEC_WEIGHTS,
    ENC_WEIGHTS,
    LayerGeom,
    attention_backward,
    fused_bert_layer,
    gelu_grad,
    layer_backward,
)

H, NH, F = 64, 4, 128
REL = 1e-4
SEEDS = (0, 91, -7, -2**31, 2**31 - 1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", SEEDS)
def test_keep_masks_bit_exact(seed, rate):
    for op in (1000, 1001, 1002):
        want = np.asarray(_keep_2d(jnp.int32(seed), jnp.int32(3), op, 20, 48, rate))
        got = hidden_keep(seed, op, 80, 48, rate)[60:].numpy()  # rows 60..79 = tile 3 of 20
        np.testing.assert_array_equal(got, want)
    tb, s_q, s_k = 3, 12, 9
    _, kpos = _tile_geometry(tb, s_q, s_k)
    for op in (0, NH - 1, cross_op(NH), cross_op(NH) + NH - 1):
        want = np.asarray(_dropout_keep_scale(jnp.int32(seed), jnp.int32(2), op, kpos, tb, s_q,
                                              s_k, rate))
        got = attention_keep(seed, op, 3 * tb, s_q, s_k, rate)[2 * tb:].numpy()
        blocks = np.stack([want[b * s_q:(b + 1) * s_q, b * s_k:(b + 1) * s_k] for b in range(tb)])
        np.testing.assert_array_equal(got, blocks)


def _case(decoder, B=5, S=12, SK=9, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H)).astype(np.float32)
    enc = rng.normal(size=(B, SK, H)).astype(np.float32) if decoder else None
    lens = rng.integers(1, S + 1, B)
    smask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)  # padded rows
    cmask = None
    if decoder:
        cmask = (np.arange(SK)[None] < rng.integers(1, SK + 1, B)[:, None]).astype(np.int32)
    names = DEC_WEIGHTS if decoder else ENC_WEIGHTS
    geom = LayerGeom(num_heads=NH, head_dim=H // NH, intermediate=F, causal=decoder,
                     has_cross=decoder, eps=1e-12, gelu_exact=True, attn_rate=0.1, hid_rate=0.1)
    shapes = geom.weight_shapes()
    ws = [((1.0 if n.startswith("g") else 0.0) + rng.normal(scale=0.1, size=shapes[n]))
          .astype(np.float32) for n in names]
    gy = rng.normal(size=(B, S, H)).astype(np.float32)
    return geom, x, enc, smask, cmask, ws, gy


def _jax_geom(geom, s_q, s_k):
    return JaxGeom(num_heads=geom.num_heads, head_dim=geom.head_dim, s_q=s_q, s_k=s_k,
                   intermediate=geom.intermediate, causal=geom.causal, has_cross=geom.has_cross,
                   attn_rate=geom.attn_rate, hid_rate=geom.hid_rate, eps=geom.eps,
                   gelu_exact=geom.gelu_exact, block_b_fwd=4, block_b_bwd=2)


def _t(a, grad=False):
    return None if a is None else torch.from_numpy(a).requires_grad_(grad)


@pytest.mark.parametrize("decoder", [False, True])
def test_training_layer_matches_jax_vjp(decoder):
    seed = -123457
    geom, x, enc, smask, cmask, ws, gy = _case(decoder)
    sk = enc.shape[1] if decoder else x.shape[1]
    jgeom = _jax_geom(geom, x.shape[1], sk)
    jenc = None if enc is None else jnp.asarray(enc)
    jcm = None if cmask is None else jnp.asarray(cmask)

    def f(x_, enc_, *w):
        return jax_fused_layer(jgeom, x_, enc_, jnp.asarray(smask), jcm,
                               jnp.asarray([seed], jnp.int32), None, *w)

    want, vjp = jax.vjp(f, jnp.asarray(x), jenc, *map(jnp.asarray, ws))
    wgrads = vjp(jnp.asarray(gy))

    xt, enct, wt = _t(x, True), _t(enc, True), [_t(w, True) for w in ws]
    before = fused_bert_layer.launches, layer_backward.launches
    out = fused_bert_layer(geom, xt, enct, _t(smask), _t(cmask), wt, seed=seed)
    out.backward(torch.from_numpy(gy))
    assert (fused_bert_layer.launches, layer_backward.launches) == before

    assert _rel(out.detach(), want) <= REL
    assert _rel(xt.grad, wgrads[0]) <= REL
    if decoder:
        assert enct.grad.dtype == torch.float32
        assert _rel(enct.grad, wgrads[1]) <= REL
    names = DEC_WEIGHTS if decoder else ENC_WEIGHTS
    for n, w, g in zip(names, wt, wgrads[2:]):
        assert _rel(w.grad, g) <= REL, n


def test_dropout_is_on_and_seeded():
    """Seed and rate change the output; the same seed gives the same output."""
    geom, x, enc, smask, cmask, ws, _ = _case(True)
    args = (_t(x), _t(enc), _t(smask), _t(cmask), [_t(w) for w in ws])
    a = fused_bert_layer(geom, *args, seed=5)
    assert torch.equal(a, fused_bert_layer(geom, *args, seed=5))
    assert not torch.equal(a, fused_bert_layer(geom, *args, seed=6))
    off = LayerGeom(**{**geom.__dict__, "attn_rate": 0.0, "hid_rate": 0.0})
    assert not torch.equal(a, fused_bert_layer(off, *args, seed=5))


B_ATT = 5
# (S, S_k) of each case, self and cross: the step's 12 and the card kernel's
# tile edges (17 rows: two m16 blocks; 32: the largest)
_ATT_SHAPES = {False: {12: 12, 17: 17, 32: 32}, True: {12: 9, 17: 32, 32: 17}}


def _attention_case(rng, cross, S, SK):
    q = rng.normal(size=(B_ATT, S, H if cross else 3 * H)).astype(np.float32)
    kv = rng.normal(size=(B_ATT, SK, 2 * H)).astype(np.float32) if cross else None
    mask = (np.arange(SK)[None] < rng.integers(1, SK + 1, B_ATT)[:, None]).astype(np.int32)
    return q, kv, mask


@pytest.mark.parametrize("S", [12, 17, 32])
@pytest.mark.parametrize("cross", [False, True])
def test_attention_forward_matches_jax(cross, S):
    """The layer forward's attention alone (the card's ``kvq_attention_fwd``;
    its plain version here) against the JAX layer kernel's ``_attn_fwd_tile``
    over the same packed rows, dropout 0.1 with the cross op ids."""
    from kindergarten_vq_vae_tpu.ops.layer_pallas import _attn_fwd_tile
    from kindergarten_vq_vae_torch.ops.layer import attention_forward

    SK, seed, rate, hd = _ATT_SHAPES[cross][S], -77, 0.1, H // NH
    q, kv, mask = _attention_case(np.random.default_rng(5), cross, S, SK)
    op = cross_op(NH) if cross else 0
    q2 = q.reshape(B_ATT * S, -1)
    k2 = (kv if cross else q).reshape(B_ATT * SK, -1)
    qh, kh, vh = (q2[:, :H], k2[:, :H], k2[:, H:2 * H]) if cross else \
        (q2[:, :H], q2[:, H:2 * H], q2[:, 2 * H:])
    want = _attn_fwd_tile(jnp.asarray(qh), jnp.asarray(kh), jnp.asarray(vh),
                          jnp.asarray(mask.reshape(1, -1)), not cross, jnp.int32(seed),
                          jnp.int32(0), op, NH, hd, B_ATT, S, SK, rate, jnp.float32, 0)
    got = attention_forward(_t(q), _t(kv), _t(mask), NH, not cross, seed, op, rate)
    assert got.shape == (B_ATT, S, H)
    assert _rel(got.reshape(B_ATT * S, H), want) <= REL


@pytest.mark.parametrize("S", [12, 17, 32])
@pytest.mark.parametrize("cross", [False, True])
def test_attention_backward_matches_jax(cross, S):
    rng = np.random.default_rng(4)
    B, SK, seed, rate = B_ATT, _ATT_SHAPES[cross][S], 77, 0.1
    geom = JaxGeom(num_heads=NH, head_dim=H // NH, s_q=S, s_k=SK, intermediate=F,
                   causal=not cross, has_cross=cross, attn_rate=rate, hid_rate=0.0, eps=1e-12,
                   gelu_exact=True, block_b_fwd=2, block_b_bwd=2)
    q, kv, mask = _attention_case(rng, cross, S, SK)
    g = rng.normal(size=(B, S, H)).astype(np.float32)
    want = _attn_bwd_call(geom, cross, jnp.asarray(q), None if kv is None else jnp.asarray(kv),
                          jnp.asarray(mask), jnp.asarray([seed], jnp.int32), jnp.asarray(g), True)
    got = attention_backward(_t(q), _t(kv), _t(mask), _t(g), NH, not cross, seed,
                             cross_op(NH) if cross else 0, rate)
    for gt, wt in zip(got if cross else (got,), want if cross else (want,)):
        assert gt.shape == wt.shape
        assert _rel(gt, wt) <= REL


def test_gelu_grad_matches_jax():
    """atol 1e-5: in the tails the gradient holds u * (1 - t^2) with t = tanh
    near 1, so one ulp of tanh (6e-8) between torch and XLA moves it by ~4e-6."""
    from kindergarten_vq_vae_tpu.ops.layer_pallas import _gelu_grad

    u = np.linspace(-8.0, 8.0, 4097, dtype=np.float32)
    for exact in (True, False):
        want = np.asarray(_gelu_grad(jnp.asarray(u), exact))
        np.testing.assert_allclose(gelu_grad(torch.from_numpy(u), exact).numpy(), want,
                                   atol=1e-5, rtol=1e-6)
