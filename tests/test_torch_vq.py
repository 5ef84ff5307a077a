"""Plain VQ bottleneck of the PyTorch port vs the JAX package's oracle
(ops/vq.py) and fused kernel (ops/vq_pallas.py, interpret mode on the CPU).
Indices and counts must be equal; z_q, sum_z, loss and perplexity agree to
rtol 1e-5 (f32 on both sides, summation order differs). The gradient (the
custom VJP of ``_fused_vq_core``) is held against ``jax.grad`` through
``fused_vector_quantize``: dz and dcodebook to rtol 1e-5, atol 1e-7, and the
row of a code no row picks exactly 0.

Row counts around the card kernel's blocks (a pair of rows a warp, 14 or 16
rows a round) take the same bars. ``assemble`` given a raw forward that
returns the straight-through value itself, as the card kernel does, gives
the same bits as the ``vq_raw`` path, gradients included.

The codebook gradient alone (``codebook_grad``, on the CPU its plain
version ``index_add_``) against JAX's ``_fused_vq_core_bwd`` (``jax.grad``
of the loss through ``fused_vector_quantize``) at rows 1 / 31 / 33 / 97,
with uneven counts and a code no row picks (exactly 0), at rtol 1e-5, atol
1e-7.

The codebook's training extras given the same numpy inputs: the EMA update
(``ema_codebook_update`` from ``init_ema_state``, three batches of counts
and sums, one code never picked) to rtol 1e-6 (the same f32 expressions;
XLA may fuse a multiply-add); dead-code revival given JAX's own ``pick``
and ``noise`` draws (re-derived from its key) exactly, over steps that
expire one code and keep the others."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops import vq as jvq
from kindergarten_vq_vae_tpu.ops.vq import vector_quantize as jax_vq
from kindergarten_vq_vae_tpu.ops.vq_pallas import fused_vector_quantize as jax_fused_vq
from kindergarten_vq_vae_torch.ops.vq import (
    assemble,
    codebook_grad,
    dead_code_reset,
    dead_code_reset_with,
    ema_codebook_update,
    init_ema_state,
    vector_quantize,
    vq_raw,
)
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
    # around the card kernel's blocks: a pair of rows a warp, 8 warps (16
    # rows) at D = 64, 7 warps (14 rows) at the bert-base 9 x 768
    "rows_1": lambda: _random_case(1, 1, 64, 9, 2)[:2],
    "rows_15": lambda: _random_case(3, 5, 64, 9, 3)[:2],
    "rows_16": lambda: _random_case(2, 8, 64, 9, 4)[:2],
    "rows_17": lambda: _random_case(1, 17, 64, 9, 5)[:2],
    "rows_14_wide": lambda: _random_case(2, 7, 768, 9, 6)[:2],
    "rows_29_wide": lambda: _random_case(1, 29, 768, 9, 7)[:2],
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


def _ste_raw(z_flat, codebook):
    """A raw forward shaped like the card kernel's: z_q already the
    straight-through value (computed in numpy's f32, apart from torch), and
    counts, sum_z and diff views of one stats buffer."""
    zq, idx, counts, sum_z, diff = vq_raw(z_flat, codebook)
    z_np = z_flat.detach().numpy()
    ste = torch.from_numpy(z_np + (zq.numpy() - z_np))
    n_e, d = codebook.shape
    stats = torch.cat([sum_z.reshape(-1), counts, diff.reshape(1), torch.zeros(2)])
    ned = n_e * d
    return ste, idx, stats[ned:ned + n_e], stats[:ned].view(n_e, d), stats[ned + n_e]


_ste_raw.returns_ste = True


@pytest.mark.parametrize("grad", [False, True])
def test_assemble_keeps_a_raw_straight_through_value(grad):
    """``assemble`` passes on the z_q of a raw forward marked
    ``returns_ste`` and gives the bits of the ``vq_raw`` path, through the
    custom VJP too."""
    z, e = _random_case(3, 12, 64, 9, 8)
    e[4] += 50.0
    outs, grads = [], []
    for raw in (vq_raw, _ste_raw):
        zt, et = torch.from_numpy(z).requires_grad_(grad), torch.from_numpy(e).requires_grad_(grad)
        out = assemble(zt, et, 0.69, raw)
        outs.append(out)
        if grad:
            (out.loss * 3.0 + out.z_q.square().sum()).backward()
            grads.append((zt.grad, et.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    if grad:
        assert all(torch.equal(a, b) for a, b in zip(*grads))


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


@pytest.mark.parametrize("rows", [1, 31, 33, 97])
def test_codebook_grad_matches_jax(rows):
    """dE of ``loss * a`` alone: JAX's segment sum against ``codebook_grad``
    given JAX's own codes and ``g_d2 = a * beta / numel``. The rows sit
    near codes 0-3 with skewed shares (code 0 takes about half), code 4 is
    far from every row, so no row picks it."""
    n_e, d, beta, a = 9, 64, 0.69, 3.0
    rng = np.random.default_rng(rows)
    e = rng.uniform(-1.0 / n_e, 1.0 / n_e, size=(n_e, d)).astype(np.float32)
    e[4] += 50.0
    near = rng.choice(4, size=rows, p=[0.5, 0.25, 0.15, 0.1])
    z = (e[near] + 0.05 * rng.normal(size=(rows, d))).astype(np.float32).reshape(1, rows, d)

    de_want = jax.grad(lambda e_: jax_fused_vq(jnp.asarray(z), e_, beta).loss * a)(jnp.asarray(e))
    idx = np.array(jax_fused_vq(jnp.asarray(z), jnp.asarray(e), beta).indices).reshape(-1)
    assert 4 not in idx
    g_d2 = torch.tensor(a * beta / z.size, dtype=torch.float32)
    got = codebook_grad(torch.from_numpy(z.reshape(rows, d)), torch.from_numpy(idx).long(),
                        torch.from_numpy(e), g_d2)
    np.testing.assert_allclose(got.numpy(), np.asarray(de_want), rtol=1e-5, atol=1e-7)
    assert (got[4] == 0).all()
    counts = np.bincount(idx, minlength=n_e)
    assert rows == 1 or len(set(counts[:4])) > 1  # uneven


def test_ema_codebook_update_matches_jax():
    rng = np.random.default_rng(11)
    n_e, d = 6, 16
    cb = rng.uniform(-0.2, 0.2, (n_e, d)).astype(np.float32)
    jcb, jst = jnp.asarray(cb), jvq.init_ema_state(jnp.asarray(cb))
    tcb, tst = torch.from_numpy(cb), init_ema_state(torch.from_numpy(cb))
    for _ in range(3):
        counts = rng.integers(0, 40, n_e).astype(np.float32)
        counts[2] = 0.0
        sum_z = rng.normal(size=(n_e, d)).astype(np.float32) * counts[:, None]
        jcb, jst = jvq.ema_codebook_update(jcb, jst, jnp.asarray(counts), jnp.asarray(sum_z), 0.9)
        tcb, tst = ema_codebook_update(tcb, tst, torch.from_numpy(counts),
                                       torch.from_numpy(sum_z), 0.9)
        np.testing.assert_allclose(tcb.numpy(), np.asarray(jcb), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tst.counts.numpy(), np.asarray(jst.counts), rtol=1e-6)
        np.testing.assert_allclose(tst.means.numpy(), np.asarray(jst.means), rtol=1e-6, atol=1e-7)


def test_dead_code_reset_matches_jax_given_its_draws():
    rng = np.random.default_rng(12)
    n_e, d, m, threshold = 5, 8, 20, 2
    cb = rng.normal(size=(n_e, d)).astype(np.float32)
    z_rows = rng.normal(size=(m, d)).astype(np.float32)
    jcb, jdead = jnp.asarray(cb), jnp.zeros((n_e,), jnp.int32)
    tcb, tdead = torch.from_numpy(cb), torch.zeros(n_e, dtype=torch.int32)
    for step in range(4):
        counts = np.array([3, 0, 1, 0, 2], np.float32) if step < 3 else np.ones(n_e, np.float32)
        key = jax.random.key(step)
        jcb, jdead = jvq.dead_code_reset(jcb, jdead, jnp.asarray(counts), jnp.asarray(z_rows),
                                         key, threshold=threshold)
        k_pick, k_noise = jax.random.split(key)
        pick = np.array(jax.random.randint(k_pick, (n_e,), 0, m))
        noise = np.array(jax.random.normal(k_noise, (n_e, d), jnp.float32))
        tcb, tdead = dead_code_reset_with(tcb, tdead, torch.from_numpy(counts),
                                          torch.from_numpy(z_rows), torch.from_numpy(pick),
                                          torch.from_numpy(noise), threshold=threshold)
        np.testing.assert_array_equal(tcb.numpy(), np.asarray(jcb))
        np.testing.assert_array_equal(tdead.numpy(), np.asarray(jdead))
    assert not np.array_equal(tcb.numpy()[1], cb[1]) and np.array_equal(tcb.numpy()[0], cb[0])


def test_dead_code_reset_draws_from_its_generator():
    cb = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    args = (cb, torch.full((4,), 5, dtype=torch.int32), torch.tensor([1.0, 0, 0, 2]),
            torch.randn(16, 8, generator=torch.Generator().manual_seed(1)))
    a = dead_code_reset(*args, torch.Generator().manual_seed(3), threshold=3)
    b = dead_code_reset(*args, torch.Generator().manual_seed(3), threshold=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0][0], cb[0]) and not torch.equal(a[0][1], cb[1])
    assert a[1].tolist() == [0, 0, 0, 0]
