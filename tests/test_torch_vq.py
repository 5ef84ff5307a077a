"""Plain VQ bottleneck of the PyTorch port vs the JAX package's oracle
(ops/vq.py) and fused kernel (ops/vq_pallas.py, interpret mode on the CPU).
Indices and counts must be equal; z_q, sum_z, loss and perplexity agree to
rtol 1e-5 (f32 on both sides, summation order differs). The gradient (the
custom VJP of ``_fused_vq_core``) is held against ``jax.grad`` through
``fused_vector_quantize``: dz and dcodebook to rtol 1e-5, atol 1e-7, and the
row of a code no row picks exactly 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.vq import vector_quantize as jax_vq
from kindergarten_vq_vae_tpu.ops.vq_pallas import fused_vector_quantize as jax_fused_vq
from kindergarten_vq_vae_torch.ops.vq import vector_quantize
from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel


def _random_case(b, s, d, n_e, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(b, s, d)).astype(np.float32)
    e = rng.uniform(-1.0 / n_e, 1.0 / n_e, size=(n_e, d)).astype(np.float32)
    return z, e


def _far_case():
    """tests/test_ops_vq.py:138: rows far from the origin (offset 361 per
    element), codes 1e-3 apart, where uncentered distances lose the argmin."""
    rng = np.random.default_rng(7)
    n_e, d, m = 9, 768, 256
    centers = 361.0 + rng.normal(size=(n_e, d)) * 1e-3
    assign = rng.integers(0, n_e, size=m)
    z = centers[assign] + rng.normal(size=(m, d)) * 2e-4
    return z.reshape(1, m, d).astype(np.float32), centers.astype(np.float32), assign


CASES = {
    "random": lambda: _random_case(3, 12, 64, 9, 0)[:2],
    "odd_rows": lambda: _random_case(3, 5, 128, 9, 1)[:2],
    "far_from_origin": lambda: _far_case()[:2],
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("jax_fn", ["oracle", "fused"])
def test_plain_vq_matches_jax(case, jax_fn):
    z, e = CASES[case]()
    beta = 0.69
    fn = jax_vq if jax_fn == "oracle" else jax_fused_vq
    want = fn(jnp.asarray(z), jnp.asarray(e), beta)
    got = vector_quantize(torch.from_numpy(z), torch.from_numpy(e), beta)

    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.one_hot.numpy(), np.asarray(want.one_hot))
    np.testing.assert_allclose(got.z_q.numpy(), np.asarray(want.z_q), rtol=1e-5)
    np.testing.assert_allclose(got.sum_z.numpy(), np.asarray(want.sum_z), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-5)
    np.testing.assert_allclose(float(got.perplexity), float(want.perplexity), rtol=1e-5)


def test_far_from_origin_recovers_true_assignments():
    z, e, assign = _far_case()
    got = vector_quantize(torch.from_numpy(z), torch.from_numpy(e), 0.25)
    np.testing.assert_array_equal(got.indices.reshape(-1).numpy(), assign)
    assert float(got.perplexity) > 5.0


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    z, e = CASES["random"]()
    before = vector_quantize_kernel.launches
    got = vector_quantize_kernel(torch.from_numpy(z), torch.from_numpy(e), 0.69)
    want = vector_quantize(torch.from_numpy(z), torch.from_numpy(e), 0.69)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert vector_quantize_kernel.launches == before
    zg, eg = torch.from_numpy(z).requires_grad_(), torch.from_numpy(e).requires_grad_()
    out = vector_quantize_kernel(zg, eg, 0.69)
    (out.loss + out.z_q.sum()).backward()
    assert zg.grad is not None and eg.grad is not None
    assert vector_quantize_kernel.launches == before


@pytest.mark.parametrize("use_kernel_wrapper", [False, True])
def test_vq_gradient_matches_jax(use_kernel_wrapper):
    """loss * a + sum(z_q * w): both gradient paths of the loss (the
    commitment term to z, the codebook term to E) and the straight-through
    z_q. Code 4 is moved far away so no row picks it."""
    z, e = _random_case(3, 12, 64, 9, 5)
    e[4] += 50.0
    w = np.random.default_rng(6).normal(size=z.shape).astype(np.float32)
    beta, a = 0.69, 3.0

    def f(z_, e_):
        out = jax_fused_vq(z_, e_, beta)
        return out.loss * a + jnp.sum(out.z_q * w)

    dz_want, de_want = jax.grad(f, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(e))
    zt, et = torch.from_numpy(z).requires_grad_(), torch.from_numpy(e).requires_grad_()
    quantize = vector_quantize_kernel if use_kernel_wrapper else vector_quantize
    out = quantize(zt, et, beta)
    assert 4 not in out.indices
    (out.loss * a + (out.z_q * torch.from_numpy(w)).sum()).backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(dz_want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(de_want), rtol=1e-5, atol=1e-7)
    assert (et.grad[4] == 0).all()
