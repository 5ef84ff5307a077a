"""The layer GEMM of the PyTorch port (``ops/gemm.py``) on the CPU: its plain
version against the JAX package's products and GELU
(``kindergarten_vq_vae_tpu/ops/layer_pallas.py`` ``_mm`` / ``_mm_nt`` /
``_mm_tn``, ``_gelu_fwd`` / ``_gelu_grad``) for NN, NT and TN and every
epilogue, on numpy-seeded bf16 inputs at ragged shapes; the split-K plan;
the CPU route of the wrapper.

Tolerance: an f32 output within 1e-5 of the largest magnitude of JAX's
(both sides sum f32 products of the same bf16 values, and only the order of
the sum differs). A bf16 output is held to a rounding of JAX's f32 value:
within half a bf16 ulp of it, plus the same 1e-5 (a sum that lands beside a
rounding midpoint may round either way on either side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kindergarten_vq_vae_tpu.ops.layer_pallas import _gelu_fwd, _gelu_grad, _mm, _mm_nt, _mm_tn
from kindergarten_vq_vae_torch.ops.gemm import (
    F32_TILE,
    F32_TILE_K,
    MAX_SPLITS,
    TILE_K,
    gemm,
    gemm_f32_plan,
    gemm_plan,
    gemm_reference,
    tile_widths,
)

SHAPES = [(37, 64, 48), (130, 192, 576)]  # (M, K, N)
CASES = [("nn", e) for e in ("f32", "bf16", "gelu_erf", "gelu_tanh")] + \
        [("nt", e) for e in ("f32", "bf16", "add_f32", "add_bf16", "dgelu_erf", "dgelu_tanh")] + \
        [("tn", e) for e in ("f32", "bf16")]


def _bf16(rng, shape, scale=1.0) -> torch.Tensor:
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).bfloat16()


def _j(t: torch.Tensor):
    """The same values as a JAX array in the tensor's dtype."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                 else jnp.float32)


def _held(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, dtype=np.float32)
    diff = np.abs(got.float().numpy() - want)
    tol = np.full_like(want, 1e-5 * np.abs(want).max())
    if got.dtype == torch.bfloat16:
        tol += np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 8)
    assert got.shape == want.shape, what
    assert (diff <= tol).all(), f"{what}: max excess {(diff - tol).max():.3e}"


def _case(layout, epi, M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    a = _bf16(rng, (K, M) if layout == "tn" else (M, K))
    b = _bf16(rng, (N, K) if layout == "nt" else (K, N), 1.0 / np.sqrt(K))
    kw = dict(a_t=layout == "tn", b_t=layout == "nt", epi=epi)
    if layout == "nn":
        kw["bias"] = torch.from_numpy((0.1 * rng.normal(size=N)).astype(np.float32))
    if epi.startswith("add"):
        kw["aux"] = torch.from_numpy(rng.normal(size=(M, N)).astype(np.float32))
    if epi.startswith("dgelu"):
        kw["aux"] = _bf16(rng, (M, N), 2.0)
    return a, b, kw


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("layout,epi", CASES)
def test_gemm_reference_matches_jax(layout, epi, M, K, N):
    a, b, kw = _case(layout, epi, M, K, N)
    acc = {"nn": _mm, "nt": _mm_nt, "tn": _mm_tn}[layout](_j(a), _j(b))
    if "bias" in kw:
        acc = acc + _j(kw["bias"])
    two = epi.startswith(("gelu", "dgelu"))
    got = gemm_reference(a, b, **kw, out2=two)
    if epi in ("f32", "bf16"):
        _held(got, acc, epi)
    elif epi.startswith("gelu"):
        _held(got[0], _gelu_fwd(acc, epi == "gelu_erf"), f"{epi} output")
        _held(got[1], acc, f"{epi} pre-GELU u")
    elif epi.startswith("add"):
        _held(got, acc + _j(kw["aux"]), epi)
    else:
        du = acc * _gelu_grad(_j(kw["aux"]).astype(jnp.float32), epi == "dgelu_erf")
        _held(got[0], du, f"{epi} bf16 du")
        _held(got[1], du, f"{epi} f32 du")
    out = got[0] if two else got
    assert out.dtype == (torch.float32 if epi in ("f32", "add_f32") else torch.bfloat16)


@settings(max_examples=300, deadline=None)
@given(M=st.integers(1, 40000), N=st.integers(1, 40000), K=st.integers(1, 200000),
       split_k=st.booleans(), sms=st.integers(1, 264), epi=st.sampled_from([e for _, e in CASES]))
def test_gemm_plan_cuts_k_into_whole_tiles_once(M, N, K, split_k, sms, epi):
    plan = gemm_plan(M, N, K, split_k, sms, epi)
    assert plan.tile_n in tile_widths(split_k, epi)
    assert plan.kchunk % TILE_K == 0 and plan.kchunk > 0
    assert 1 <= plan.splits <= MAX_SPLITS
    assert (plan.splits - 1) * plan.kchunk < K <= plan.splits * plan.kchunk  # every chunk non-empty
    if not split_k:
        assert plan.splits == 1


def test_gemm_plan_fills_the_card_at_the_step_shapes():
    """The weight gradients of the batch-2048 step (24,576 rows) split their
    rows; the forward's products keep one chunk."""
    for M, N in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
        plan = gemm_plan(M, N, 24576, True, 132)
        tiles = -(-M // 128) * -(-N // plan.tile_n)
        assert plan.splits > 1 and tiles * plan.splits >= 100
    assert gemm_plan(24576, 768, 768, False, 132).splits == 1


@settings(max_examples=300, deadline=None)
@given(M=st.integers(1, 40000), N=st.integers(1, 40000), K=st.integers(1, 200000),
       sms=st.integers(1, 264))
def test_gemm_f32_plan_cuts_k_into_whole_slices_once(M, N, K, sms):
    plan = gemm_f32_plan(M, N, K, sms)
    assert plan.tile_n == F32_TILE
    assert plan.kchunk % F32_TILE_K == 0 and plan.kchunk > 0
    assert 1 <= plan.splits <= MAX_SPLITS
    assert (plan.splits - 1) * plan.kchunk < K <= plan.splits * plan.kchunk  # every chunk non-empty


def test_gemm_f32_plan_fills_the_card_at_the_step_shapes():
    """The f32 weight gradients of the batch-2048 step (24,576 rows) and the
    table gradient (30,522 x 768) give every one of the H100's 132 SMs a
    unit of work, and the units of the layer's fill their last wave to at
    least 90%."""
    for M, N in ((768, 2304), (768, 768), (768, 3072), (3072, 768), (30522, 768)):
        plan = gemm_f32_plan(M, N, 24576, 132)
        units = -(-M // F32_TILE) * -(-N // F32_TILE) * plan.splits
        assert units >= 132, (M, N, plan)
        if M <= 3072:
            assert plan.splits > 1 and units / (132 * -(-units // 132)) >= 0.9, (M, N, plan)


@pytest.mark.parametrize("layout,epi", [("nn", "gelu_erf"), ("nt", "dgelu_tanh"), ("tn", "bf16")])
def test_gemm_takes_the_plain_version_on_the_cpu(layout, epi):
    a, b, kw = _case(layout, epi, 37, 64, 48, seed=1)
    before = gemm.launches
    got = gemm(a, b, **kw)
    assert gemm.launches == before
    assert torch.equal(got, gemm_reference(a, b, **kw))
