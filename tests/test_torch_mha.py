"""The port's ``fused_mha`` (kernel #13, its plain version on the CPU) vs the
JAX package's ``fused_mha`` (ops/attention_pallas.py, interpret mode on the
CPU), f32, the same seeded numpy inputs: with and without a key mask, causal
and not, a batch that is not a multiple of the JAX tile, and a fully masked
row, where #13's where-masking (uniform over every key) and #11's additive
masking differ. Values at atol 1e-5, gradients (``jax.vjp`` against the
port's autograd, both through the plain reference) at atol 2e-5, the bars
of ``tests/test_attention_pallas.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.attention_pallas import fused_mha as jax_mha
from kindergarten_vq_vae_torch.ops.attention import fused_mha, mha_forward, mha_reference
from kindergarten_vq_vae_torch.ops.sdpa import fused_sdpa

B, S, H, NH = 5, 12, 64, 4


def _inputs(masked, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(size=(B, S, H)).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = rng.integers(0, 2, (B, S)).astype(np.int32)
        mask[:, 0] = 1
        mask[2] = 0  # a fully masked sentence: every row of it sees no key
    return q, k, v, mask, w


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_mha_matches_jax(masked, causal):
    q, k, v, mask, w = _inputs(masked)
    m = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(lambda q_, k_, v_: jax_mha(q_, k_, v_, m, NH, causal, 2),
                        *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(w))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = fused_mha(tq, tk, tv, None if mask is None else torch.from_numpy(mask), NH, causal)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for name, t, g in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-5, err_msg=f"d{name}")


def test_fully_masked_row_is_uniform_over_every_key():
    """Where-masking gives a row without a valid key the mean of all values;
    #11's additive mask keeps what of the scores survives the f32 sum with
    -1e9 (multiples of 64), which at scores of ~100 is not uniform."""
    q, k, v, mask, _ = _inputs(True, seed=1)
    q[2] *= 100.0
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = fused_mha(*t, torch.from_numpy(mask), NH)
    np.testing.assert_allclose(out[2].numpy(), np.broadcast_to(v[2].mean(0), (S, H)), atol=1e-5)
    sdpa = fused_sdpa(*t, torch.from_numpy(mask), 0, NH)
    assert not np.allclose(sdpa[2].numpy(), out[2].numpy(), atol=1e-3)
    np.testing.assert_allclose(sdpa[[0, 1, 3, 4]].numpy(), out[[0, 1, 3, 4]].numpy(), atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    q, k, v, mask, _ = _inputs(True, seed=2)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    before = mha_forward.launches
    assert torch.equal(mha_forward(*t, torch.from_numpy(mask), NH, True),
                       mha_reference(*t, torch.from_numpy(mask), NH, True))
    assert mha_forward.launches == before
