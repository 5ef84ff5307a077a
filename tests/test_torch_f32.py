"""The kernels' f32 instances on the CPU: their plain versions in f32
(JAX's parity dtype) against the JAX package, at the edges of the card
kernels that the f32 instances add, an f32 step on the routes that the last
of them open, and the route check that lets an f32 run onto the card.

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
- The fused head + CE's plain versions (#9, #10, the table gradient) in
  f32 against ``head_ce_pallas.py`` ``fused_head_ce_loss`` in interpret
  mode, store and flash, at 129 rows (one past the f32 GEMM's 128-row tile)
  and vocabularies 129 (odd: the CE epilogues' column-at-a-time edge) and
  130 (2 mod 4, as 30,522: g's rows read on to the next multiple of 4), the
  logits and ``g`` handed on as (rows, V) views of rows ``padded_ld(V)``
  wide whose pad columns are zero, as the f32 kernels hand them on: the
  loss within 1e-5 relative, the ids exact, dx, d_table and dbias within
  2e-5 relative and 1e-6 absolute (f32 sums in another order; the JAX
  package's own bar for this op).
- One f32 training step of a tiny Shelgon3-VQ (2 + 2 layers, H 64, 4
  heads, vocabulary 130) on the per-module trunk (``fused_layer="off"``:
  #11 / #12's plain versions) with ``fused_head_ce`` "store" and "flash",
  weights carried across by ``ckpt/bridge.py``, dropout off, against JAX's
  f32 step (``fused_sdpa`` and ``fused_head_ce_loss`` in interpret mode):
  the loss within 1e-5 relative, every gradient within 1e-4 of its leaf's
  largest magnitude (the criterion of ``tests/test_torch_train.py``).
- ``config.refuse_unported_route``: every (device, dtype, ``fused_layer``,
  ``fused_head_ce``) passes while f32 products are full f32; TF32 on makes
  an f32 CUDA run raise. It needs no card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.ce_pallas import fused_ce_loss_ids as jax_ce
from kindergarten_vq_vae_tpu.ops.head_ce_pallas import fused_head_ce_loss as jax_head_ce
from kindergarten_vq_vae_tpu.ops.layer_pallas import _gelu_fwd, _gelu_grad, _mm, _mm_nt, _mm_tn
from kindergarten_vq_vae_tpu.train.config import DataConfig, ModelConfig
from kindergarten_vq_vae_tpu.train.config import RunConfig as JaxRunConfig
from kindergarten_vq_vae_tpu.train.variants import init_params
from kindergarten_vq_vae_tpu.train.variants import make_loss_fn as jax_make_loss_fn
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax
from kindergarten_vq_vae_torch.config import RunConfig, refuse_unported_route
from kindergarten_vq_vae_torch.models import build_model
from kindergarten_vq_vae_torch.ops.ce import fused_ce_loss_ids
from kindergarten_vq_vae_torch.ops.gemm import gemm_reference
from kindergarten_vq_vae_torch.ops.head_ce import (
    head_ce_bwd_reference,
    head_ce_fwd_reference,
    padded_ld,
    table_grad_reference,
)
from kindergarten_vq_vae_torch.train.variants import make_loss_fn

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


# --------------------------------------------------- #9 / #10 and the table gradient

HEAD_B, HEAD_S, HEAD_H = 3, 43, 64  # 129 rows


def _padded(t: torch.Tensor) -> torch.Tensor:
    """``t`` (rows, V) as the f32 kernels hand it on: a (rows, V) view of
    rows ``padded_ld(V)`` wide whose pad columns are zero."""
    buf = torch.zeros(t.shape[0], padded_ld(t.shape[1]), dtype=t.dtype)
    buf[:, :t.shape[1]] = t
    return buf[:, :t.shape[1]]


@pytest.mark.parametrize("mode", ["store", "flash"])
@pytest.mark.parametrize("vocab", [129, 130])
def test_f32_head_ce_reference_matches_jax(vocab, mode):
    rng = np.random.default_rng(vocab)
    hidden = (0.5 * rng.normal(size=(HEAD_B, HEAD_S, HEAD_H))).astype(np.float32)
    table = (0.3 * rng.normal(size=(vocab, HEAD_H))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(vocab,))).astype(np.float32)
    tgt = rng.integers(0, vocab, (HEAD_B, HEAD_S)).astype(np.int32)
    valid = np.array([1, 0, 1], np.float32)

    def f(h, t, b):
        return jax_head_ce(h, t, b, jnp.asarray(tgt), jnp.asarray(valid), None, mode, 64, 128,
                           True)

    (loss_w, ids_w), vjp = jax.vjp(f, jnp.asarray(hidden), jnp.asarray(table), jnp.asarray(bias))
    dh_w, dt_w, db_w = vjp((jnp.float32(1.0), np.zeros(ids_w.shape, jax.dtypes.float0)))

    rows = HEAD_B * HEAD_S
    x2, tab, b = (torch.from_numpy(a) for a in (hidden.reshape(rows, HEAD_H), table, bias))
    targets = torch.from_numpy(tgt.reshape(-1))
    nll, lse, ids, logits = head_ce_fwd_reference(x2, tab, b, targets, mode)
    w = torch.from_numpy(valid).repeat_interleave(HEAD_S)
    denom = max(float(valid.sum()), 1.0) * HEAD_S
    loss = (nll * w).sum() / denom
    saved = _padded(logits) if mode == "store" else x2
    g, dx, dbias = head_ce_bwd_reference(saved, tab, b, targets, lse, w / denom, mode)
    d_table = table_grad_reference(_padded(g), x2)

    assert all(t.dtype == torch.float32 for t in (nll, lse, g, dx, dbias, d_table))
    np.testing.assert_allclose(float(loss), float(loss_w), rtol=1e-5)
    np.testing.assert_array_equal(ids.reshape(HEAD_B, HEAD_S).numpy(), np.asarray(ids_w))
    for got, want in ((dx.reshape(hidden.shape), dh_w), (d_table, dt_w), (dbias, db_w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-6)


# ------------------------------------- an f32 step on the per-module trunk + fused head

STEP_B, STEP_S, STEP_V = 4, 12, 130


def _step_cfg(fused_head_ce):
    return JaxRunConfig(
        model=ModelConfig(model_name="shelgon3", vocab_size=STEP_V, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128, compute_dtype="float32",
                          vq_e_dim=64, enc_out_size=64, vq_n_e=9, fused_head_ce=fused_head_ce,
                          head_ce_block_r=64, head_ce_block_v=128, fused_layer="off",
                          fused_attn="on", sdpa_block_b=4),
        data=DataConfig(batch_size=STEP_B, tokenized_sentence_max_length=STEP_S))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, np.asarray(v)


@pytest.mark.parametrize("fused_head_ce", ["store", "flash"])
def test_f32_routes_step_matches_jax(fused_head_ce):
    cfg = _step_cfg(fused_head_ce)
    params = init_params(cfg, jax.random.key(0))
    tcfg = RunConfig.from_flat_dict(cfg.get_config())
    assert tcfg.fused_layer == "off" and tcfg.dtype == torch.float32
    model = build_model(tcfg, fused_head=True)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    rng = np.random.default_rng(0)
    lens = rng.integers(3, STEP_S + 1, STEP_B)
    mask = (np.arange(STEP_S)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.integers(1, STEP_V, (STEP_B, STEP_S)) * mask).astype(np.int32)

    rngs = {k: jax.random.key(1) for k in ("dropout", "gumbel", "perturb")}
    jbatch = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask),
              "n_valid": jnp.int32(STEP_B)}
    grad_fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(cfg, "train"), has_aux=True),
                      static_argnums=3)
    (loss_w, _), grads_w = grad_fn(params, jbatch, rngs, True)

    tbatch = {"input_ids": torch.from_numpy(ids).long(), "attention_mask": torch.from_numpy(mask),
              "n_valid": STEP_B}
    loss, _ = make_loss_fn(tcfg, "train")(model, tbatch, torch.Generator().manual_seed(0), True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_w), rtol=1e-5)
    tgrads = {n: p.grad for n, p in model.named_parameters()}
    for name, want in _flat(jax.device_get(grads_w)):
        got = np.zeros_like(want) if tgrads[name] is None else tgrads[name].numpy()
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, f"{name}: {err:.3e}"


# ------------------------------------------------------------- the route check

ROUTES = [(layer, head) for layer in ("auto", "on", "off")
          for head in ("auto", "off", "store", "flash")]


@pytest.mark.parametrize("fused_layer,fused_head_ce", ROUTES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_route_check_table(device, dtype, fused_layer, fused_head_ce):
    """Every route's kernels have f32 instances: with PyTorch's f32 products
    in full f32 (the default), every (device, dtype, route) passes."""
    cfg = RunConfig(compute_dtype=dtype, fused_layer=fused_layer, fused_head_ce=fused_head_ce)
    assert torch.get_float32_matmul_precision() == "highest"
    assert refuse_unported_route(cfg, torch.device(device)) is None
    assert refuse_unported_route(cfg, device) is None


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
