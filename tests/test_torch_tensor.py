"""Input perturbation (``replace_pct_rand_values``) vs the JAX package's.

Given the draws JAX makes from its key (the permutation ranks and the noise
ids, re-derived here from the same key), the port's
:func:`replace_pct_rand_values_with` gives JAX's perturbed ids exactly. The
generator-driven form replaces exactly ``floor(pct * numel)`` positions,
repeats itself for a re-seeded generator and leaves the ids alone at
``pct == 0``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.utils.tensor import replace_pct_rand_values as jax_replace
from kindergarten_vq_vae_torch.utils.tensor import (
    replace_pct_rand_values,
    replace_pct_rand_values_with,
)


@pytest.mark.parametrize("pct", [0.1, 0.37, 1.0])
def test_matches_jax_given_its_draws(pct):
    ids = np.random.default_rng(0).integers(1, 50, (6, 12)).astype(np.int32)
    key = jax.random.key(3)
    want = np.asarray(jax_replace(key, jnp.asarray(ids), pct, 0, 50))
    k_perm, k_noise = jax.random.split(key)
    ranks = np.array(jax.random.permutation(k_perm, ids.size)).reshape(ids.shape)
    noise = np.array(jax.random.randint(k_noise, ids.shape, 0, 50, dtype=jnp.int32))
    got = replace_pct_rand_values_with(torch.from_numpy(ids), pct, torch.from_numpy(ranks),
                                       torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)


def test_generator_form_replaces_exactly_floor_pct():
    ids = torch.zeros(8, 12, dtype=torch.int64)  # noise drawn from [1, 9) never equals 0
    out = replace_pct_rand_values(ids, 0.3, 1, 9, torch.Generator().manual_seed(5))
    assert int((out != ids).sum()) == int(ids.numel() * 0.3)
    again = replace_pct_rand_values(ids, 0.3, 1, 9, torch.Generator().manual_seed(5))
    assert torch.equal(out, again) and out.dtype == ids.dtype
    assert replace_pct_rand_values(ids, 0.0, 1, 9, torch.Generator()) is ids
