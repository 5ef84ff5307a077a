"""The port's SDPA (kernels #11 / #12, their plain versions on the CPU) vs the
JAX package's ``fused_sdpa`` (ops/sdpa_pallas.py, interpret mode on the CPU).

f32 on both sides, the same seeded numpy inputs: self-attention (causal and
not) and cross-attention (S_q != S_k), padded key masks and ``None``, a batch
that is not a multiple of the JAX sentence tile, dropout rate 0 and 0.1 with
a fixed seed, and sequence lengths at the card kernel's tile edges (1, 16,
17 and 32 rows). The forward is held at atol 1e-5 and dq / dk / dv (from
``jax.vjp`` against the port's autograd) at atol 2e-5, the bars of
``tests/test_sdpa_pallas.py``: the two sides differ only in f32 summation
order and exp ulps. At rate 0.1 the keep masks are compared exactly, through
inputs that make each one visible."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.sdpa_pallas import fused_sdpa as jax_sdpa
from kindergarten_vq_vae_torch.ops.dropout import attention_keep
from kindergarten_vq_vae_torch.ops.sdpa import (
    _rows_even,
    fused_sdpa,
    sdpa_backward,
    sdpa_backward_reference,
    sdpa_forward,
    sdpa_forward_reference,
)

H, NH, SEED = 64, 4, -123456789
JAX_TILE = 2  # sentences per JAX kernel tile: B = 5 leaves a padded tile


def _inputs(B, SQ, SK, masked, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, SQ, H)).astype(np.float32)
    k, v = (rng.normal(size=(B, SK, H)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(B, SQ, H)).astype(np.float32)
    mask = None
    if masked:
        lens = rng.integers(1, SK + 1, B)
        mask = (np.arange(SK)[None] < lens[:, None]).astype(np.int32)
    return q, k, v, mask, w


def _jax(q, k, v, mask, w, causal, rate):
    m = None if mask is None else jnp.asarray(mask)
    seed = jnp.asarray([SEED], jnp.int32)

    def f(q_, k_, v_):
        return jax_sdpa(q_, k_, v_, m, seed, NH, causal, rate, JAX_TILE)

    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(w))]


@pytest.mark.parametrize("SQ,SK,causal,masked,rate", [
    (12, 12, False, True, 0.0),
    (12, 12, True, True, 0.0),
    (12, 12, True, False, 0.0),
    (7, 12, False, True, 0.0),     # cross-attention, padded encoder keys
    (12, 9, False, False, 0.0),
    (12, 12, True, True, 0.1),
    (12, 12, False, False, 0.1),
    (7, 12, False, True, 0.1),
    # the card kernel's tile edges: one row, 16 and 32 rows, one row past 16
    (1, 1, False, True, 0.0),
    (16, 16, True, True, 0.0),
    (17, 17, False, True, 0.0),
    (32, 32, True, False, 0.1),
    (17, 32, False, True, 0.1),    # cross-attention over two key blocks
])
def test_fused_sdpa_matches_jax(SQ, SK, causal, masked, rate):
    q, k, v, mask, w = _inputs(5, SQ, SK, masked)
    want, want_grads = _jax(q, k, v, mask, w, causal, rate)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    got = fused_sdpa(tq, tk, tv, tmask, SEED, NH, causal, rate, cross=SQ != SK)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    for name, t, g in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), g, atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("SQ,SK,causal", [(12, 12, True), (12, 12, False), (9, 12, False)])
def test_keep_masks_equal_jax(SQ, SK, causal):
    """q = k = 0 gives every valid key the same probability and v the one-hot
    of the key position in each head, so a context entry is p * keep per
    (query, key, head): its nonzero pattern is the keep mask. Port, JAX and
    ``ops/dropout.attention_keep`` (op id = head) agree on every bit."""
    B, rate = 6, 0.1
    hd = H // NH
    q = np.zeros((B, SQ, H), np.float32)
    k = np.zeros((B, SK, H), np.float32)
    v = np.zeros((B, SK, H), np.float32)
    for h in range(NH):
        v[:, np.arange(SK), h * hd + np.arange(SK)] = 1.0
    got = fused_sdpa(*(torch.from_numpy(a) for a in (q, k, v)), None, SEED, NH, causal, rate)
    want = np.asarray(jax_sdpa(*map(jnp.asarray, (q, k, v)), None, jnp.asarray([SEED], jnp.int32),
                               NH, causal, rate, JAX_TILE))
    ctx = got.numpy().reshape(B, SQ, NH, hd)[..., :SK]
    np.testing.assert_array_equal(ctx > 0, want.reshape(B, SQ, NH, hd)[..., :SK] > 0)
    visible = np.tril(np.ones((SQ, SK), bool)) if causal else np.ones((SQ, SK), bool)
    for h in range(NH):
        keep = attention_keep(SEED, h, B, SQ, SK, rate).numpy() > 0
        np.testing.assert_array_equal(ctx[:, :, h] > 0, keep & visible)
    assert 0.8 < float((ctx > 0).sum()) / (visible.sum() * B * NH) < 0.97


def test_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing():
    q, k, v, mask, w = _inputs(3, 12, 12, True, seed=1)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    tmask = torch.from_numpy(mask)
    before = (sdpa_forward.launches, sdpa_backward.launches)
    out = sdpa_forward(*args, tmask, 7, NH, True, 0.1)
    assert torch.equal(out, sdpa_forward_reference(*args, tmask, 7, NH, True, 0.1))
    g = torch.from_numpy(w)
    for a, b in zip(sdpa_backward(*args, tmask, 7, g, NH, True, 0.1),
                    sdpa_backward_reference(*args, tmask, 7, g, NH, True, 0.1)):
        assert torch.equal(a, b)
    assert (sdpa_forward.launches, sdpa_backward.launches) == before


def test_split_views_of_a_packed_qkv_are_read_in_place():
    """The kernels take split views of a packed qkv at its row stride; a
    layout they cannot read (here a transposed view) is refused on the card."""
    qkv = torch.randn(4, 12, 3 * H)
    q, k, v = qkv.split(H, dim=-1)
    assert all(_rows_even(t) for t in (q, k, v))
    assert not _rows_even(qkv.transpose(0, 1)[:, :, :H])
    ref = fused_sdpa(q.contiguous(), k.contiguous(), v.contiguous(), None, 0, NH)
    assert torch.equal(fused_sdpa(q, k, v, None, 0, NH), ref)


def test_refuses_bad_dropout():
    q = torch.zeros(2, 12, H)
    with pytest.raises(ValueError, match="rate"):
        fused_sdpa(q, q, q, None, 1, NH, rate=1.0)
    with pytest.raises(ValueError, match="seed"):
        fused_sdpa(q, q, q, None, None, NH, rate=0.1)
