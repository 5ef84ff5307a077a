"""The port's streaming CE (+ argmax) vs the JAX package's ``fused_ce_loss``
and ``fused_ce_loss_ids`` (ops/ce_pallas.py, Pallas in interpret mode on the
CPU) and ``kl_recon_loss``.

Vocab 523 (not a multiple of the 2048-wide TPU block nor of 128), f32 logits,
a batch whose tail rows are invalid (``valid_row`` 0). Loss rtol 1e-5 and
dlogits atol 1e-6 (f32 on both sides: the streaming sum-exp differs only in
order), ids exactly, including rows with ties built across and within the
TPU kernel's vocab blocks. The card kernel reads a row as 8-element chunks
from its first 16-byte boundary: at the odd vocabularies 523, 1031, 9, 7
and 1 the rows start at every 8-element phase, 8 puts them all on one, and
each row of the first sentence has ties across an 8-wide chunk boundary,
shifted by one column a row. The backward's plain version is also held
directly to the TPU kernel #8 (``_ce_pallas_bwd``, interpret mode) given the
same ``lse`` and ``scale``: targets at -1, V, V - 1 and 0 and a row whose
scale is 0, atol 1e-6. The card kernel's output starts at the logits'
16-byte phase, which ``phase_matched_empty`` gives at every element offset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.ce_pallas import _ce_pallas_bwd
from kindergarten_vq_vae_tpu.ops.ce_pallas import fused_ce_loss as jax_ce_loss
from kindergarten_vq_vae_tpu.ops.ce_pallas import fused_ce_loss_ids as jax_ce
from kindergarten_vq_vae_tpu.train.losses import kl_recon_loss as jax_kl
from kindergarten_vq_vae_torch.ops.ce import (
    ce_bwd,
    ce_bwd_reference,
    ce_fwd,
    ce_fwd_ids,
    fused_ce_loss,
    fused_ce_loss_ids,
    phase_matched_empty,
)
from kindergarten_vq_vae_torch.train.losses import kl_recon_loss

B, S, V = 6, 12, 523
BLOCK_V = 128  # the JAX kernel's vocab block in this test: ties span blocks


def _case(seed=0, v=V):
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=2.0, size=(B, S, v)).astype(np.float32)
    if v == V:
        # ties: equal maxima within one block (cols 5, 9) and across blocks (3, 300, 511)
        logits[0, 0, [5, 9]] = 50.0
        logits[0, 1, [300, 3, 511]] = 40.0
        logits[1, 2, [200, 130]] = 30.0
    else:  # ties across an 8-wide chunk boundary, one column further a row
        for s in range(S):
            cols = [c for c in (7 + s, 8 + s, 16 + 2 * s) if c < v]
            logits[0, s, cols] = 60.0
    logits[2, 3, :] = 0.5  # an all-equal row
    targets = rng.integers(0, v, (B, S)).astype(np.int32)
    valid = np.array([1, 1, 1, 1, 0, 0], np.float32)
    g = np.float32(1.7)
    return logits, targets, valid, g


@pytest.mark.parametrize("vocab", [V, 1031, 9, 8, 7, 1])
def test_ce_matches_jax_loss_ids_and_grad(vocab):
    logits, targets, valid, g = _case(v=vocab)

    def f(lg):
        loss, ids = jax_ce(lg, jnp.asarray(targets), jnp.asarray(valid), 64, BLOCK_V, True)
        return loss, ids

    (loss_w, ids_w), vjp = jax.vjp(f, jnp.asarray(logits))
    (dlogits_w,) = vjp((jnp.asarray(g), np.zeros(ids_w.shape, jax.dtypes.float0)))

    x = torch.from_numpy(logits).requires_grad_()
    before = ce_fwd_ids.launches, ce_bwd.launches
    loss, ids = fused_ce_loss_ids(x, torch.from_numpy(targets), torch.from_numpy(valid))
    (loss * float(g)).backward()
    assert (ce_fwd_ids.launches, ce_bwd.launches) == before

    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_w))
    if vocab == V:
        assert ids[0, 0] == 5 and ids[0, 1] == 3 and ids[1, 2] == 130
    else:
        assert all(ids[0, s] == 7 + s for s in range(S) if 7 + s < vocab)
    assert ids[2, 3] == 0
    np.testing.assert_allclose(float(loss.detach()), float(loss_w), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dlogits_w), atol=1e-6, rtol=0)
    assert (x.grad[4:] == 0).all()  # invalid rows get no gradient


def test_ce_loss_without_ids_matches_jax():
    """#6: ``fused_ce_loss``, value and gradient, through the plain versions."""
    logits, targets, valid, g = _case(3)
    loss_w, vjp = jax.vjp(
        lambda lg: jax_ce_loss(lg, jnp.asarray(targets), jnp.asarray(valid), 64, BLOCK_V, True),
        jnp.asarray(logits))
    (dlogits_w,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(logits).requires_grad_()
    before = ce_fwd.launches, ce_bwd.launches
    loss = fused_ce_loss(x, torch.from_numpy(targets), torch.from_numpy(valid))
    (loss * float(g)).backward()
    assert (ce_fwd.launches, ce_bwd.launches) == before
    assert loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(loss_w), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dlogits_w), atol=1e-6, rtol=0)
    ids_loss, _ = fused_ce_loss_ids(x.detach(), torch.from_numpy(targets), torch.from_numpy(valid))
    assert torch.equal(loss.detach(), ids_loss)  # the same NLL as #7's


@pytest.mark.parametrize("vocab", [1, 7, 8, 9, V])
def test_ce_bwd_reference_matches_the_tpu_kernel(vocab):
    """#8's plain version against ``_ce_pallas_bwd`` on the same lse and
    scale: targets outside the vocabulary (-1, V) get no one-hot, the first
    and last columns do, and a row of scale 0 is all 0."""
    rng = np.random.default_rng(4)
    rows = 13
    logits = rng.normal(scale=3.0, size=(rows, vocab)).astype(np.float32)
    targets = rng.integers(0, vocab, rows).astype(np.int32)
    targets[:4] = [-1, vocab, vocab - 1, 0]
    lse = (np.log(np.exp(logits.astype(np.float64)).sum(1)) + rng.normal(0, 0.1, rows)
           ).astype(np.float32)
    scale = rng.uniform(0.1, 2.0, rows).astype(np.float32)
    scale[5] = 0.0
    want = _ce_pallas_bwd(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(lse),
                          jnp.asarray(scale), 8, BLOCK_V, True)
    got = ce_bwd_reference(*(torch.from_numpy(a) for a in (logits, targets, lse, scale)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert (got[5] == 0).all()


@pytest.mark.parametrize("dtype, offset", [(torch.bfloat16, o) for o in range(8)]
                         + [(torch.float32, o) for o in range(4)])
def test_phase_matched_empty_starts_at_the_logits_phase(dtype, offset):
    """The backward's output at every element offset of a view: the same
    16-byte phase and shape as the logits, contiguous, and at offset 0 a
    buffer of its own (aligned, as cuBLAS's dgrad reads it)."""
    buf = torch.zeros(offset + 3 * 37, dtype=dtype)
    x = buf[offset:].view(3, 37)
    out = phase_matched_empty(x)
    assert out.shape == x.shape and out.dtype == dtype and out.is_contiguous()
    assert out.data_ptr() % 16 == x.data_ptr() % 16
    assert (out.storage_offset() == 0) == (x.data_ptr() % 16 == 0)


@pytest.mark.parametrize("all_invalid", [False, True])
def test_kl_recon_loss_matches_jax(all_invalid):
    logits, targets, valid, g = _case(1)
    if all_invalid:
        valid[:] = 0.0  # denom clamps at 1 sentence
    want, vjp = jax.vjp(lambda lg: jax_kl(lg, jnp.asarray(targets), jnp.asarray(valid)),
                        jnp.asarray(logits))
    (dw,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(logits).requires_grad_()
    loss = kl_recon_loss(x, torch.from_numpy(targets), torch.from_numpy(valid))
    (loss * float(g)).backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dw), atol=1e-6, rtol=0)


def test_reference_flag_takes_the_plain_versions():
    logits, targets, valid, _ = _case(2)
    x = torch.from_numpy(logits)
    a = fused_ce_loss_ids(x, torch.from_numpy(targets), torch.from_numpy(valid))
    b = fused_ce_loss_ids(x, torch.from_numpy(targets), torch.from_numpy(valid), reference=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(fused_ce_loss(x, torch.from_numpy(targets), torch.from_numpy(valid)),
                       fused_ce_loss(x, torch.from_numpy(targets), torch.from_numpy(valid),
                                     reference=True))
