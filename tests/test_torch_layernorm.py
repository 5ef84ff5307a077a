"""The plain versions of the fused layer's LayerNorm and column-sum kernels vs the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
functions and through the port's wrappers, which take their plain versions
for CPU tensors (``csrc/layernorm.cu`` is held against these on the card, in
``tests/test_torch_cuda.py``):

- ``residual_layernorm`` against ``_ln_fwd`` (``layer_pallas.py:164``) of
  ``x + a * keep``;
- ``layernorm_backward`` against ``_ln_recover_yhat`` (l.542) and
  ``_ln_bwd`` (l.175), with dgamma / dbeta / dbias summed as
  ``_layer_backward_xla`` sums them (l.1047-1057);
- the hidden keep mask (``hidden_keep``) against ``_keep_2d`` (l.142), bit
  for bit;
- ``column_sums`` and the GELU-gradient GEMM's column sums
  (``gemm_reference(..., colsum=True)``) against JAX's ``du.sum(0)`` and
  ``jnp.sum(src.astype(f32), 0)``.

Rows 1 / 31 / 33 / 97 cross every row-block edge of the kernels (a warp's
rows, a block's 64 rows of the backward, a GEMM tile's 128); widths 64 and
768; the upstream gy in bf16 and f32; one gamma entry exactly 0; dropout
rates 0 and 0.1. Bar: f32 on both sides, every output within 1e-5 of its
largest magnitude (the two sum rows and columns in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.layer_pallas import (
    _gelu_grad,
    _keep_2d,
    _ln_bwd,
    _ln_fwd,
    _ln_recover_yhat,
    _mm_nt,
)
from kindergarten_vq_vae_torch.ops.dropout import OP_ATTN_OUT, OP_CROSS_OUT, OP_MLP_OUT, hidden_keep
from kindergarten_vq_vae_torch.ops.gemm import gemm_reference
from kindergarten_vq_vae_torch.ops.layer import (
    column_sums,
    column_sums_reference,
    layernorm_backward,
    residual_layernorm,
)

REL = 1e-5
ROWS = (1, 31, 33, 97)
SEED = -1234567


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _params(rng, N):
    gamma = (1.0 + 0.1 * rng.normal(size=N)).astype(np.float32)
    gamma[3] = 0.0  # a dead column: yhat 0 there, as `_ln_recover_yhat` maps it
    beta = (0.1 * rng.normal(size=N)).astype(np.float32)
    return gamma, beta


@jax.jit
def _jax_ln_fwd(x, a, gamma, beta):
    out, _, inv = _ln_fwd(x + a, gamma, beta, 1e-12, jnp.float32)
    return out, inv[:, 0]


@jax.jit
def _jax_ln_bwd(gy, v, inv, gamma, beta, keep):
    yhat = _ln_recover_yhat(v, gamma, beta)
    dr = _ln_bwd(gy, yhat, inv[:, None], gamma)
    da = dr * keep
    return dr, da, jnp.sum(gy * yhat, axis=0), jnp.sum(gy, axis=0), jnp.sum(da, axis=0)


@jax.jit
def _jax_du_sums(dy, w2, u):
    du_erf = _mm_nt(dy, w2) * _gelu_grad(u, True)
    du_tanh = _mm_nt(dy, w2) * _gelu_grad(u, False)
    return jnp.sum(du_erf, axis=0), jnp.sum(du_tanh, axis=0)


def _keep(op, rows, N, rate):
    """The JAX mask (None at rate 0), held bit for bit against the port's."""
    if rate == 0.0:
        return None
    want = np.asarray(_keep_2d(jnp.int32(SEED), jnp.int32(0), op, rows, N, rate))
    np.testing.assert_array_equal(hidden_keep(SEED, op, rows, N, rate).numpy(), want)
    return want


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N", [64, 768])
@pytest.mark.parametrize("rows", ROWS)
def test_residual_layernorm_matches_jax(rows, N, rate):
    rng = np.random.default_rng(rows * N)
    x = rng.normal(size=(rows, N)).astype(np.float32)
    a = (0.5 * rng.normal(size=(rows, N)) + 0.2).astype(np.float32)
    gamma, beta = _params(rng, N)
    k = _keep(OP_CROSS_OUT, rows, N, rate)
    want_out, want_inv = _jax_ln_fwd(x, a if k is None else a * k, gamma, beta)
    out, inv = residual_layernorm(torch.from_numpy(x), torch.from_numpy(a),
                                  torch.from_numpy(gamma), torch.from_numpy(beta), 1e-12, SEED,
                                  OP_CROSS_OUT, rate)
    assert out.dtype == torch.float32 and out.shape == (rows, N) and inv.shape == (rows,)
    assert _rel(out, want_out) <= REL
    assert _rel(inv, want_inv) <= REL


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("gy_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("N", [64, 768])
@pytest.mark.parametrize("rows", ROWS)
def test_layernorm_backward_matches_jax(rows, N, gy_dtype, rate):
    rng = np.random.default_rng(rows * N + 1)
    gamma, beta = _params(rng, N)
    v = rng.normal(size=(rows, N)).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, size=rows).astype(np.float32)
    gy_t = torch.from_numpy(rng.normal(size=(rows, N)).astype(np.float32)).to(
        getattr(torch, gy_dtype))
    gy = gy_t.float().numpy()  # the values both sides see
    k = _keep(OP_MLP_OUT, rows, N, rate)

    want = _jax_ln_bwd(gy, v, inv, gamma, beta, np.ones_like(gy) if k is None else k)

    got = layernorm_backward(gy_t, torch.from_numpy(v), torch.from_numpy(inv),
                             torch.from_numpy(gamma), torch.from_numpy(beta), SEED, OP_MLP_OUT,
                             rate)
    names = ("dr", "da", "dgamma", "dbeta", "dbias")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == np.shape(w), name
        assert _rel(g, w) <= REL, name
    assert got[2][3] == 0.0  # gamma 0: yhat 0, no dgamma


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("N", [64, 768])
@pytest.mark.parametrize("rows", ROWS)
def test_gelu_gradient_column_sums_match_jax(rows, N, exact):
    """b1 as the GELU-gradient GEMM's plain version sums it, and the plain
    column sum of its f32 du, against ``_layer_backward_xla``'s
    ``du.sum(0)`` (l.1059-1063)."""
    rng = np.random.default_rng(rows * N + 2)
    K = 32
    dy = rng.normal(size=(rows, K)).astype(np.float32)
    w2 = (rng.normal(size=(N, K)) / K ** 0.5).astype(np.float32)  # (in, out): dy @ w2^T
    u = (2.0 * rng.normal(size=(rows, N))).astype(np.float32)
    want = _jax_du_sums(dy, w2, u)[0 if exact else 1]
    epi = "dgelu_erf" if exact else "dgelu_tanh"
    _, du_f32, sums = gemm_reference(torch.from_numpy(dy), torch.from_numpy(w2), b_t=True, epi=epi,
                                     aux=torch.from_numpy(u), out2=True, colsum=True)
    assert sums.dtype == torch.float32 and sums.shape == (N,)
    assert _rel(sums, want) <= REL
    assert _rel(column_sums_reference(du_f32), want) <= REL
    assert torch.equal(column_sums(du_f32), column_sums_reference(du_f32))


@pytest.mark.parametrize("N", [64, 768, 2304])
@pytest.mark.parametrize("rows", ROWS)
def test_column_sums_match_jax(rows, N):
    """The bias gradients of bf16 matrices (dqkv, dqc, dkv), summed in f32 as
    ``_layer_backward_xla`` sums them (l.1087, 1090, 1116)."""
    rng = np.random.default_rng(rows * N + 3)
    src = torch.from_numpy(rng.normal(size=(rows, N)).astype(np.float32)).bfloat16()
    want = jnp.sum(jnp.asarray(src.float().numpy()), axis=0)
    got = column_sums(src)
    assert got.dtype == torch.float32 and got.shape == (N,)
    assert _rel(got, want) <= REL


def test_wrappers_refuse_a_dropout_rate_outside_0_1():
    x = torch.zeros(4, 64)
    g = torch.ones(64)
    with pytest.raises(ValueError, match="dropout rate"):
        residual_layernorm(x, x, g, g, 1e-12, 0, OP_ATTN_OUT, 1.0)
    with pytest.raises(ValueError, match="dropout rate"):
        layernorm_backward(x, x, torch.ones(4), g, g, 0, OP_ATTN_OUT, -0.1)
