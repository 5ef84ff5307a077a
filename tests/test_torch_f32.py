"""The f32 instances of the default route on the CPU: their plain versions
in f32 (JAX's parity dtype) against the JAX package, at the edges of the
card kernels that the f32 instances add, and the route check that lets an
f32 run onto the card.

- The layer GEMM's plain version (``ops/gemm.py`` ``gemm_reference``) on
  f32 operands with the f32 instance's epilogues (every output f32), against
  ``_mm`` / ``_mm_nt`` / ``_mm_tn`` and the GELU of
  ``kindergarten_vq_vae_tpu/ops/layer_pallas.py``, at M, N and K off the
  f32 kernel's 128 x 128 x 32 tile (1, 127 and 129 rows): within 1e-5 of
  the largest magnitude of JAX's output (f32 sums of the same f32 products
  in another order).
- #7 / #8's plain versions on f32 logits at the vocabularies 30,522 and
  50,257, on views starting 0-3 elements into their buffer (the card kernel
  reads 4-element chunks from each row's first 16-byte boundary), against
  ``ce_pallas.py`` ``fused_ce_loss_ids`` in interpret mode: the loss within
  1e-5 relative, the gradient within 1e-6 absolute (values of at most
  ~1/rows), the ids exact. One JAX call a vocabulary, shared by the offsets.
- ``config.refuse_unported_route``: which (device, dtype, ``fused_layer``,
  ``fused_head_ce``) pass and which raise. It needs no card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.ce_pallas import fused_ce_loss_ids as jax_ce
from kindergarten_vq_vae_tpu.ops.layer_pallas import _gelu_fwd, _gelu_grad, _mm, _mm_nt, _mm_tn
from kindergarten_vq_vae_torch.config import RunConfig, refuse_unported_route
from kindergarten_vq_vae_torch.ops.ce import fused_ce_loss_ids
from kindergarten_vq_vae_torch.ops.gemm import gemm_reference

# ------------------------------------------------------------- the layer GEMM

F32_CASES = [("nn", e) for e in ("f32", "gelu_erf", "gelu_tanh")] + \
            [("nt", e) for e in ("f32", "add_f32", "dgelu_erf", "dgelu_tanh")] + [("tn", "f32")]
# (M, K, N): rows about the 128-row tile, K about the 32-deep slice, N about
# the 128-wide tile (multiples of 8, as the kernel takes them)
F32_SHAPES = [(1, 40, 136), (127, 72, 120), (129, 264, 40)]


def _f32(rng, shape, scale=1.0) -> torch.Tensor:
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))


@pytest.mark.parametrize("M,K,N", F32_SHAPES)
@pytest.mark.parametrize("layout,epi", F32_CASES)
def test_f32_gemm_reference_matches_jax(layout, epi, M, K, N):
    rng = np.random.default_rng(M + K + N)
    a = _f32(rng, (K, M) if layout == "tn" else (M, K))
    b = _f32(rng, (N, K) if layout == "nt" else (K, N), 1.0 / np.sqrt(K))
    kw = dict(a_t=layout == "tn", b_t=layout == "nt", epi=epi)
    if layout == "nn":
        kw["bias"] = _f32(rng, (N,), 0.1)
    if epi.startswith(("add", "dgelu")):
        kw["aux"] = _f32(rng, (M, N), 2.0)
    acc = {"nn": _mm, "nt": _mm_nt, "tn": _mm_tn}[layout](jnp.asarray(a.numpy()),
                                                          jnp.asarray(b.numpy()))
    if "bias" in kw:
        acc = acc + jnp.asarray(kw["bias"].numpy())
    aux = jnp.asarray(kw["aux"].numpy()) if "aux" in kw else None
    if epi.startswith("gelu"):
        want = (_gelu_fwd(acc, epi == "gelu_erf"), acc)
    elif epi.startswith("add"):
        want = (acc + aux,)
    elif epi.startswith("dgelu"):
        du = acc * _gelu_grad(aux, epi == "dgelu_erf")
        want = (du, du)
    else:
        want = (acc,)
    two = epi.startswith(("gelu", "dgelu"))
    got = gemm_reference(a, b, **kw, out2=two)
    got = got if two else (got,)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, dtype=np.float32)
        assert g.dtype == torch.float32 and g.shape == w.shape, (epi, i)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), f"{layout} {epi} output {i}: {err:.3e}"


# ------------------------------------------------------------------ #7 / #8

CE_B, CE_S = 2, 4  # 8 rows: every 16-byte phase of the rows of both vocabularies
_JAX_CE = {}


def _ce_case(vocab):
    rng = np.random.default_rng(vocab)
    logits = rng.normal(scale=3.0, size=(CE_B, CE_S, vocab)).astype(np.float32)
    logits[0, 0, [5, 9000, vocab - 522]] = 40.0   # ties far apart
    logits[0, 1, [7, 8]] = 40.0                   # ties side by side
    logits[0, 2, [3, 4 + 4 * 33]] = 45.0          # ties across 4-wide chunks
    logits[1, 3] = 0.5                            # an all-equal row
    targets = rng.integers(0, vocab, (CE_B, CE_S)).astype(np.int32)
    targets[1, 0], targets[1, 1] = 0, vocab - 1
    valid = np.array([1, 1], np.float32)
    return logits, targets, valid, np.float32(1.3)


def _jax_ce(vocab):
    """JAX's loss, ids and gradient for the vocabulary, computed once."""
    if vocab not in _JAX_CE:
        logits, targets, valid, g = _ce_case(vocab)

        def f(lg):
            return jax_ce(lg, jnp.asarray(targets), jnp.asarray(valid), 8, 8192, True)

        (loss, ids), vjp = jax.vjp(f, jnp.asarray(logits))
        (dlogits,) = vjp((jnp.asarray(g), np.zeros(ids.shape, jax.dtypes.float0)))
        _JAX_CE[vocab] = (float(loss), np.asarray(ids), np.asarray(dlogits))
    return _JAX_CE[vocab]


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("vocab", [30522, 50257])
def test_f32_ce_matches_jax_at_row_offsets(vocab, offset):
    logits, targets, valid, g = _ce_case(vocab)
    loss_w, ids_w, dlogits_w = _jax_ce(vocab)
    buf = torch.zeros(logits.size + offset)
    x = buf[offset:].view(logits.shape)
    with torch.no_grad():
        x.copy_(torch.from_numpy(logits))
    x.requires_grad_()
    loss, ids = fused_ce_loss_ids(x, torch.from_numpy(targets), torch.from_numpy(valid))
    (loss * float(g)).backward()
    np.testing.assert_array_equal(ids.numpy(), ids_w)
    assert ids[0, 0] == 5 and ids[0, 1] == 7 and ids[0, 2] == 3 and ids[1, 3] == 0
    np.testing.assert_allclose(float(loss.detach()), loss_w, rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), dlogits_w, atol=1e-6, rtol=0)


# ------------------------------------------------------------- the route check

ROUTES = [(layer, head) for layer in ("auto", "on", "off")
          for head in ("auto", "off", "store", "flash")]


@pytest.mark.parametrize("fused_layer,fused_head_ce", ROUTES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_route_check_table(device, dtype, fused_layer, fused_head_ce):
    """f32 on CUDA takes the default route only; bf16 and the CPU take every
    route. The refusal names ROADMAP §2a."""
    cfg = RunConfig(compute_dtype=dtype, fused_layer=fused_layer, fused_head_ce=fused_head_ce)
    refused = (device == "cuda" and dtype == "float32"
               and (fused_layer == "off" or fused_head_ce in ("store", "flash")))
    if refused:
        with pytest.raises(NotImplementedError, match="ROADMAP §2a"):
            refuse_unported_route(cfg, device)
    else:
        assert refuse_unported_route(cfg, torch.device(device)) is None


def test_route_check_takes_f32_gpt2_runs_and_wants_full_f32_products():
    cfg = RunConfig(compute_dtype="float32", decoder_model_name="gpt2", model_name="bagon")
    assert refuse_unported_route(cfg, "cuda") is None
    assert refuse_unported_route(dataclasses.replace(cfg, fused_head_ce="store"), "cpu") is None
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")  # TF32 products
        with pytest.raises(ValueError, match="full f32"):
            refuse_unported_route(cfg, "cuda")
        assert refuse_unported_route(cfg, "cpu") is None
    finally:
        torch.set_float32_matmul_precision(old)
