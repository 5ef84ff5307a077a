"""The port's Gumbel softmax and Gumbel codebook quantizer vs the JAX package's.

On the CPU in f32. Torch cannot redraw ``jax.random.gumbel``, so each side
is given JAX's noise: the port's ``gumbel_softmax_with`` takes it as an
argument, and for ``gumbel_quantize`` the port's draw (``sample_gumbels``)
is replaced by one that returns the noise JAX draws from the same key.

- ``gumbel_softmax_with``, soft and hard, along the last and a middle axis,
  against ``gumbel_softmax``: values to rel 1e-6, the hard one-hot's
  positions exactly, and the gradient of a weighted sum (straight-through
  for hard) to rel 1e-6;
- ``gumbel_quantize`` in training (soft, straight-through) and in eval
  (forced hard): ``z_q``, ``soft_one_hot`` and ``diff`` to rel 1e-5 (an
  einsum over 16 features and a mean in another order), ``indices``
  exactly, and the gradients of ``sum(w * z_q) + diff`` with respect to
  ``z``, the projection and the codebook to 1e-5 of each leaf's largest;
- ``unique_count_perplexity`` exactly;
- the generator-driven forms: reproducible for a re-seeded generator, a
  sample of rows each summing to 1, the noise of the right shape and dtype.

:class:`NoiseFeed` feeds both packages' models the same noise for the
model, step and analysis tests (``test_torch_variants.py``,
``test_torch_analyses.py``): a monkeypatch replaces ``jax.random.gumbel``
(which the JAX modules reach through ``ops/gumbel.py``) and the port's
``sample_gumbels``, so that the k-th draw on either side is the same
standard Gumbel array of the asked shape; with ``per_shape`` every draw of
a shape is the same array (the JAX analyses cache jitted forwards, which
draw once per shape).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops import gumbel as jg
from kindergarten_vq_vae_torch.ops import gumbel as tg

REL = 1e-6


class NoiseFeed:
    """The k-th draw of either side: a standard Gumbel array of the asked
    shape from ``default_rng((seed, k))``; with ``per_shape`` k is always 0."""

    def __init__(self, monkeypatch, per_shape: bool = False, seed: int = 0):
        self.per_shape, self.seed = per_shape, seed
        self.reset()
        monkeypatch.setattr(jax.random, "gumbel", self._jax)
        monkeypatch.setattr(tg, "sample_gumbels", self._torch)

    def reset(self):
        self.calls = {"jax": 0, "torch": 0}

    def _next(self, side, shape) -> np.ndarray:
        k = 0 if self.per_shape else self.calls[side]
        self.calls[side] += 1
        return np.random.default_rng((self.seed, k)).gumbel(size=tuple(shape)).astype(np.float32)

    def _jax(self, key, shape=(), dtype=jnp.float32, **_):
        return jnp.asarray(self._next("jax", shape), dtype)

    def _torch(self, like, generator):
        return torch.from_numpy(self._next("torch", like.shape)).to(like.dtype)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("axis", [-1, 1])
def test_gumbel_softmax_with_matches_jax(hard, axis):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 5, 3)).astype(np.float32)
    w = rng.normal(size=logits.shape).astype(np.float32)
    key, tau = jax.random.key(7), 0.7

    def jloss(x):
        y = jg.gumbel_softmax(key, x, tau=tau, hard=hard, axis=axis)
        return jnp.sum(y * w), y

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    noise = np.array(jax.random.gumbel(key, logits.shape, dtype=jnp.float32))
    x = torch.from_numpy(logits).requires_grad_()
    got = tg.gumbel_softmax_with(x, torch.from_numpy(noise), tau, hard, axis)
    (got * torch.from_numpy(w)).sum().backward()
    assert _rel(got.detach().numpy(), want) <= REL
    if hard:
        np.testing.assert_array_equal(got.detach().numpy().round(), np.asarray(want).round())
    assert _rel(x.grad.numpy(), jgrad) <= REL


@pytest.mark.parametrize("straight_through, is_training",
                         [(False, True), (True, True), (False, False)],
                         ids=["train-soft", "train-straight-through", "eval-hard"])
def test_gumbel_quantize_matches_jax(monkeypatch, straight_through, is_training):
    rng = np.random.default_rng(1)
    b, s, e, n, d = 3, 5, 16, 9, 8
    arrays = dict(z=rng.normal(size=(b, s, e)), proj_kernel=rng.normal(0, 0.3, (e, n)),
                  proj_bias=rng.normal(0, 0.1, (n,)), codebook=rng.normal(size=(n, d)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    w = rng.normal(size=(b, s, d)).astype(np.float32)
    key, temp, kl = jax.random.key(11), 0.9, 5e-4

    def jloss(a):
        out = jg.gumbel_quantize(key, a["z"], a["proj_kernel"], a["proj_bias"], a["codebook"],
                                 temp, kl, straight_through, is_training)
        return jnp.sum(out.z_q * w) + out.diff, out

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (b, n, s), dtype=jnp.float32)))
    monkeypatch.setattr(tg, "sample_gumbels", lambda like, generator: noise)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in arrays.items()}
    got = tg.gumbel_quantize(leaves["z"], leaves["proj_kernel"], leaves["proj_bias"],
                             leaves["codebook"], temp, kl, straight_through, is_training)
    ((got.z_q * torch.from_numpy(w)).sum() + got.diff).backward()
    for k in ("z_q", "soft_one_hot", "diff"):
        assert _rel(getattr(got, k).detach().numpy(), getattr(want, k)) <= 1e-5, k
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    for k, t in leaves.items():
        assert _rel(t.grad.numpy(), jgrads[k]) <= 1e-5, k
    if not straight_through and is_training:
        assert not np.allclose(got.soft_one_hot.detach().numpy().max(1), 1.0)


@pytest.mark.parametrize("n_used", [1, 4, 9])
def test_unique_count_perplexity_matches_jax(n_used):
    idx = np.random.default_rng(n_used).integers(0, n_used, (6, 12))
    want = float(jg.unique_count_perplexity(jnp.asarray(idx), 9))
    got = tg.unique_count_perplexity(torch.from_numpy(idx), 9)
    assert got.dtype == torch.float32 and float(got) == want == len(np.unique(idx))


def test_generator_forms_draw_from_the_generator():
    logits = torch.randn(4, 9, 12, generator=torch.Generator().manual_seed(0))
    a = tg.gumbel_softmax(logits, 1.0, False, 1, torch.Generator().manual_seed(3))
    b = tg.gumbel_softmax(logits, 1.0, False, 1, torch.Generator().manual_seed(3))
    c = tg.gumbel_softmax(logits, 1.0, False, 1, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.testing.assert_close(a.sum(1), torch.ones(4, 12))
    g = tg.sample_gumbels(logits, torch.Generator().manual_seed(5))
    assert g.shape == logits.shape and g.dtype == logits.dtype and torch.isfinite(g).all()
    with pytest.raises(ValueError, match="Generator"):
        tg.gumbel_softmax(logits)
