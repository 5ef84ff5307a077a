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
shifted by one column a row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.ce_pallas import fused_ce_loss as jax_ce_loss
from kindergarten_vq_vae_tpu.ops.ce_pallas import fused_ce_loss_ids as jax_ce
from kindergarten_vq_vae_tpu.train.losses import kl_recon_loss as jax_kl
from kindergarten_vq_vae_torch.ops.ce import (
    ce_bwd,
    ce_fwd,
    ce_fwd_ids,
    fused_ce_loss,
    fused_ce_loss_ids,
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
