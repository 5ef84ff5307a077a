"""Input perturbation: replace a fixed share of the token ids with random ids.

Counterpart of ``kindergarten_vq_vae_tpu/utils/tensor.py``
``replace_pct_rand_values`` (l.24-48): exactly ``floor(pct * numel)``
positions, chosen by a random permutation of all positions, get uniform ids
in ``[low, high)``; ``pct == 0`` returns the ids unchanged. JAX draws from a
``jax.random`` key; the port draws the same kinds of numbers from a
:class:`torch.Generator`, so the two streams differ and the tests hold
:func:`replace_pct_rand_values_with`, the part after the draws, against
JAX given the same ``ranks`` and ``noise``. ``replace_pct_rand_columns``
waits for the Shelgon variant (ROADMAP item 7).
"""

from __future__ import annotations

import math

import torch


def replace_pct_rand_values_with(ids: torch.Tensor, pct: float, ranks: torch.Tensor,
                                 noise: torch.Tensor) -> torch.Tensor:
    """``ids`` with the positions whose ``ranks`` (a permutation of
    ``0..numel-1`` in ``ids``' shape) fall below ``floor(pct * numel)``
    replaced by ``noise``."""
    num_corrupt = int(ids.numel() * pct)
    return torch.where(ranks < num_corrupt, noise.to(ids.dtype), ids)


def replace_pct_rand_values(ids: torch.Tensor, pct: float, low: int, high: int,
                            generator: torch.Generator) -> torch.Tensor:
    """Replace exactly ``floor(pct * numel)`` elements of ``ids`` with uniform
    ints in ``[low, high)``, drawn from ``generator`` (on ``ids``' device)."""
    if math.isclose(pct, 0.0) or int(ids.numel() * pct) == 0:
        return ids
    ranks = torch.randperm(ids.numel(), generator=generator, device=ids.device).reshape(ids.shape)
    noise = torch.randint(low, high, ids.shape, generator=generator, device=ids.device,
                          dtype=ids.dtype)
    return replace_pct_rand_values_with(ids, pct, ranks, noise)
