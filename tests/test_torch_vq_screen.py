"""The plain versions of the VQ general path's two new pieces against the JAX
package (``fused_vector_quantize`` in interpret mode on the CPU, and the
segment sum of ``_fused_vq_core_bwd`` through ``jax.grad``), from numpy
seeds at small widths.

The screen (``vq_screen_reference``): the TF32 split emulated by rounding
the mantissa (``tf32_split``, as ``cvt.rna``), the bound applied to the
emulated products. Its kept codes always hold JAX's index, and the recheck
over them picks JAX's index on random rows, duplicate codes, codes 1 ulp
apart (where their distances tie in every summation order: a subnormal
step; one ulp of every column is an f32 tie that the order breaks, and
there either code may be picked, both kept) and rows far from the origin
near close codes.

The grouped sums (``grouped_sum_reference``, a stable sort of the rows by
code, row block and slot, then the sums in the kernels' fixed order): JAX's
``sum_z`` and its codebook gradient within the bars the VQ tests use (rtol
1e-5; the gradient atol 1e-7), a code no row picks exactly 0, and the bits
of the one-pass kernel's slab order (a direct emulation) at every slot
count and across strips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.vq_pallas import fused_vector_quantize as jax_fused_vq
from kindergarten_vq_vae_torch.ops.vq import (
    grouped_order,
    grouped_sum_reference,
    screen_kappa,
    tf32_split,
    vq_screen_reference,
)


def _random():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(96, 64)).astype(np.float32)
    e = rng.uniform(-1 / 40, 1 / 40, size=(40, 64)).astype(np.float32)
    return z, e


def _duplicates():
    """Codes 5 and 21 copy code 2, code 33 copies 30; rows sit near 2 and 30."""
    rng = np.random.default_rng(1)
    e = rng.uniform(-1 / 9, 1 / 9, size=(40, 64)).astype(np.float32)
    e[5] = e[21] = e[2]
    e[33] = e[30]
    near = rng.choice([2, 30], size=96)
    z = (e[near] + 1e-3 * rng.normal(size=(96, 64))).astype(np.float32)
    return z, e


def _one_ulp():
    """Code 7 is code 3 one ulp up in a column where code 3 is 0 (the
    smallest subnormal), and code 11 one ulp above code 10 in every column;
    rows sit on codes 3 and 10."""
    rng = np.random.default_rng(2)
    e = rng.uniform(-1 / 9, 1 / 9, size=(24, 64)).astype(np.float32)
    e[3, 5] = 0.0
    e[7] = e[3]
    e[7, 5] = np.nextafter(np.float32(0), np.float32(1))
    e[11] = np.nextafter(e[10], np.float32(1))
    near = rng.choice([3, 10], size=64)
    z = (e[near] + 1e-4 * rng.normal(size=(64, 64))).astype(np.float32)
    return z, e


def _far_from_origin():
    """A codebook at row norm ~27.6, its codes ~0.06 apart (the trained
    encoder the JAX kernel's comment measured), rows near its codes."""
    rng = np.random.default_rng(3)
    d, n_e = 64, 48
    base = rng.normal(size=d)
    base *= 27.6 / np.linalg.norm(base)
    e = (base + 0.06 / np.sqrt(2 * d) * rng.normal(size=(n_e, d))).astype(np.float32)
    near = rng.integers(0, n_e, size=96)
    z = (e[near] + 0.01 / np.sqrt(d) * rng.normal(size=(96, d))).astype(np.float32)
    return z, e


CASES = {"random": _random, "duplicates": _duplicates, "one_ulp": _one_ulp,
         "far_from_origin": _far_from_origin}


@pytest.mark.parametrize("case", list(CASES))
def test_screen_keeps_and_picks_jax_index(case):
    z, e = CASES[case]()
    want = np.asarray(jax_fused_vq(jnp.asarray(z[None]), jnp.asarray(e), 0.25).indices).reshape(-1)
    kept, got = vq_screen_reference(torch.from_numpy(z), torch.from_numpy(e))
    rows = np.arange(len(want))
    assert kept.numpy()[rows, want].all(), "a code JAX picks was screened out"
    # codes 10 and 11 of the 1-ulp case tie in f32 up to the order of the
    # sums, which JAX's dot and the plain matmul take differently: both are
    # kept and either may be picked; every other row's pick is JAX's
    tie = np.isin(want, [10, 11]) if case == "one_ulp" else np.zeros(len(want), bool)
    np.testing.assert_array_equal(got.numpy()[~tie], want[~tie])
    assert np.isin(got.numpy()[tie], [10, 11]).all() and kept.numpy()[tie][:, [10, 11]].all()
    assert kept.sum(1).float().mean() <= 3.0  # the screen leaves few codes to recheck
    if case == "duplicates":
        assert set(want.tolist()) == {2, 30}
        assert kept.numpy()[want == 2][:, [2, 5, 21]].all()
    if case == "one_ulp":
        assert kept.numpy()[want == 3][:, [3, 7]].all() and (want != 7).all()


def test_screen_bound_covers_the_split():
    """The emulated 3xTF32 products stay within kappa ||x|| ||y|| of the f64
    product of the same centred f32 operands, at widths 8 to 1,280."""
    rng = np.random.default_rng(4)
    for d in (8, 64, 768, 1280):
        x = torch.from_numpy(rng.normal(size=(32, d)).astype(np.float32))
        y = torch.from_numpy(rng.uniform(-1, 1, size=(16, d)).astype(np.float32))
        (xb, xs), (yb, ys) = tf32_split(x), tf32_split(y)
        xb, xs, yb, ys = (t.double() for t in (xb, xs, yb, ys))
        cross = (xs @ yb.T + xb @ ys.T + xb @ yb.T).float().double()
        exact = x.double() @ y.double().T
        scale = x.double().norm(dim=1, keepdim=True) * y.double().norm(dim=1)
        assert ((cross - exact).abs() / scale).max() <= screen_kappa(d) / 2
    assert 1.2e-4 < screen_kappa(768) < 1.3e-4


def test_tf32_split_rounds_like_cvt_rna():
    """The high part keeps 10 mantissa bits, a tie rounds away from zero, and
    x - big - small stays within 2^-22 |x|."""
    one = np.float32(1.0)
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-12, 3.0], dtype=torch.float32)
    big, _ = tf32_split(tie)
    assert big.tolist() == [1 + 2.0**-10, -(1 + 2.0**-10), float(one), 3.0]
    x = torch.from_numpy(np.random.default_rng(5).normal(size=4096).astype(np.float32))
    big, small = tf32_split(x)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all() and ((small.view(torch.int32) & 0x1FFF) == 0).all()
    r = (x.double() - big.double() - small.double()).abs()
    assert (r <= 2.0**-22 * x.double().abs()).all()


def _jax_sums(z, e, beta=0.69, a=3.0):
    """JAX's indices, sum_z and codebook gradient of loss * a."""
    out = jax_fused_vq(jnp.asarray(z[None]), jnp.asarray(e), beta)
    de = jax.grad(lambda e_: jax_fused_vq(jnp.asarray(z[None]), e_, beta).loss * a)(jnp.asarray(e))
    return (np.asarray(out.indices).reshape(-1), np.asarray(out.sum_z), np.asarray(de),
            a * beta / z.size)


@pytest.mark.parametrize("rows_per_block,slots", [(16, 4), (16, 2), (48, 1), (32, 4), (4096, 4)])
def test_grouped_sum_matches_jax(rows_per_block, slots):
    """sum_z and the codebook gradient over 200 rows (13 row blocks of 16:
    every strip, some twice), skewed codes, code 4 never picked."""
    rng = np.random.default_rng(rows_per_block + slots)
    n_e, d, m = 12, 32, 200
    e = rng.uniform(-1 / n_e, 1 / n_e, size=(n_e, d)).astype(np.float32)
    e[4] += 50.0
    near = rng.choice([0, 1, 2, 3, 5, 8], size=m, p=[0.4, 0.2, 0.15, 0.1, 0.1, 0.05])
    z = (e[near] + 0.05 * rng.normal(size=(m, d))).astype(np.float32)
    idx, sum_z, de, g = _jax_sums(z, e)
    assert 4 not in idx
    zt, et, it = torch.from_numpy(z), torch.from_numpy(e), torch.from_numpy(idx.copy()).long()
    got = grouped_sum_reference(zt, it, n_e, rows_per_block, slots)
    np.testing.assert_allclose(got.numpy(), sum_z, rtol=1e-5, atol=1e-5)
    gt = torch.tensor(g, dtype=torch.float32)
    grad = grouped_sum_reference(gt * 2.0 * (et[it] - zt), it, n_e, rows_per_block, slots)
    np.testing.assert_allclose(grad.numpy(), de, rtol=1e-5, atol=1e-7)
    unpicked = np.setdiff1d(np.arange(n_e), idx)
    assert (got[unpicked] == 0).all() and (grad[unpicked] == 0).all()


def _one_pass_order(terms, idx, n_e, rows_per_block, slots):
    """The one-pass kernel's order written out: per row block, slot w's slab
    adds rows row0 + w + j slots in order; the slabs in slot order; the
    blocks' partials in colparts_reduce's 8 strips, then the strips."""
    m, d = terms.shape
    strips = [torch.zeros(n_e, d) for _ in range(8)]
    for b in range(-(-m // rows_per_block)):
        slabs = [torch.zeros(n_e, d) for _ in range(slots)]
        for r in range(b * rows_per_block, min(m, (b + 1) * rows_per_block)):
            slabs[(r - b * rows_per_block) % slots][idx[r]] += terms[r]
        part = slabs[0].clone()
        for w in range(1, slots):
            part += slabs[w]
        strips[b % 8] += part
    out = strips[0].clone()
    for w in range(1, 8):
        out += strips[w]
    return out


@pytest.mark.parametrize("rows_per_block,slots", [(16, 4), (32, 2), (48, 1), (304, 4)])
def test_grouped_sum_repeats_the_one_pass_order(rows_per_block, slots):
    rng = np.random.default_rng(rows_per_block * slots)
    z = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 6, size=300))
    want = _one_pass_order(z, idx, 7, rows_per_block, slots)
    assert torch.equal(grouped_sum_reference(z, idx, 7, rows_per_block, slots), want)


def test_grouped_order_follows_the_card_plans():
    """Row blocks of the 2^22-float rule and the one-pass kernel's slots:
    4 at 9 and 512 codes, 2 at 200 and 1 at 300 codes (D 768), 4 again off
    the 16-byte path, where a block's chunk is 32 columns."""
    assert grouped_order(24576, 768, 9) == (192, 4)
    assert grouped_order(24576, 768, 512) == (2464, 4)
    assert grouped_order(24576, 1280, 1024) == (8192, 4)
    assert grouped_order(5000, 768, 200)[1] == 2
    assert grouped_order(5000, 768, 300)[1] == 1
    assert grouped_order(5000, 768, 300, vec=False)[1] == 4


def test_raw_forward_grouping_reaches_the_backward_on_ctx():
    """A raw forward's sixth element (the card kernel's grouping of the rows
    by code) reaches the ``VQCore`` node, which hands it to the codebook
    gradient; a raw forward of five elements leaves None there, and the CPU
    op returns an empty grouping."""
    from kindergarten_vq_vae_torch.ops import vq as vq_ops
    from kindergarten_vq_vae_torch.ops import vq_kernel  # noqa: F401  (registers kvq::vq_fwd)

    rng = np.random.default_rng(5)
    z = torch.tensor(rng.standard_normal((2, 6, 8)), dtype=torch.float32, requires_grad=True)
    e = torch.tensor(rng.standard_normal((5, 8)), dtype=torch.float32, requires_grad=True)
    group = torch.arange(8, dtype=torch.int32)
    seen = []

    def grad(z_flat, idx, codebook, g_d2, handed=None):
        seen.append(handed)
        return vq_ops.codebook_grad_reference(z_flat, idx, codebook, g_d2)

    for raw, want in ((lambda zf, cb: (*vq_ops.vq_raw(zf, cb), group), group),
                      (vq_ops.vq_raw, None)):
        out = vq_ops.assemble(z, e, 0.25, raw)
        nodes, todo = [], [out.loss.grad_fn]
        while todo:
            node = todo.pop()
            if node is not None and node not in nodes:
                nodes.append(node)
                todo += [f for f, _ in node.next_functions]
        core = [n for n in nodes if "VQCore" in type(n).__name__]
        assert len(core) == 1 and core[0].group is want
        old, vq_ops.codebook_grad = vq_ops.codebook_grad, grad
        try:
            out.loss.backward()
        finally:
            vq_ops.codebook_grad = old
        assert seen.pop() is want
    got = torch.ops.kvq.vq_fwd(z.detach().reshape(-1, 8), e.detach())
    assert len(got) == 4 and got[3].dtype == torch.int32 and got[3].numel() == 0
