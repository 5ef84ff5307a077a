"""Input perturbation: replace a fixed share of the token ids with random ids.

Counterpart of ``kindergarten_vq_vae_tpu/utils/tensor.py``:
``replace_pct_rand_values`` (l.24-48): exactly ``floor(pct * numel)``
positions, chosen by a random permutation of all positions, get uniform ids
in ``[low, high)``; ``replace_pct_rand_columns`` (l.51-75, the Shelgon
trainer's): ``floor(pct * dim)`` whole columns along ``axis``, the same
columns in every row. ``pct == 0`` returns the ids unchanged. JAX draws from
a ``jax.random`` key; the port draws the same kinds of numbers from a
:class:`torch.Generator`, so the two streams differ and the tests hold
:func:`replace_pct_rand_values_with` and :func:`replace_pct_rand_columns_with`,
the parts after the draws, against JAX given the same ``ranks`` and ``noise``.
Under a device mesh (:func:`~kindergarten_vq_vae_torch.parallel.mesh.use_mesh`)
``ids`` are the rank's rows: the draws are made at the global batch's shape
and the share counts the global batch's elements, so each rank takes its
rows of what one process would draw.
"""

from __future__ import annotations

import math

import torch

from kindergarten_vq_vae_torch.parallel.mesh import global_draw, global_numel


def replace_pct_rand_values_with(ids: torch.Tensor, pct: float, ranks: torch.Tensor,
                                 noise: torch.Tensor, numel: int | None = None) -> torch.Tensor:
    """``ids`` with the positions whose ``ranks`` (a permutation of
    ``0..numel-1`` in ``ids``' shape) fall below ``floor(pct * numel)``
    replaced by ``noise``; ``numel`` is ``ids``' unless given (the global
    batch's, for a rank's rows)."""
    num_corrupt = int((ids.numel() if numel is None else numel) * pct)
    return torch.where(ranks < num_corrupt, noise.to(ids.dtype), ids)


def replace_pct_rand_values(ids: torch.Tensor, pct: float, low: int, high: int,
                            generator: torch.Generator) -> torch.Tensor:
    """Replace exactly ``floor(pct * numel)`` elements of ``ids`` with uniform
    ints in ``[low, high)``, drawn from ``generator`` (on ``ids``' device)."""
    numel = global_numel(ids)
    if math.isclose(pct, 0.0) or int(numel * pct) == 0:
        return ids
    ranks = global_draw(ids.shape, lambda shape: torch.randperm(
        numel, generator=generator, device=ids.device).reshape(shape))
    noise = global_draw(ids.shape, lambda shape: torch.randint(
        low, high, shape, generator=generator, device=ids.device, dtype=ids.dtype))
    return replace_pct_rand_values_with(ids, pct, ranks, noise, numel)


def replace_pct_rand_columns_with(ids: torch.Tensor, pct: float, ranks: torch.Tensor,
                                  noise: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """``ids`` with the columns along ``axis`` whose ``ranks`` (a permutation
    of ``0..dim-1``) fall below ``floor(pct * dim)`` replaced by ``noise``
    (``ids``' shape)."""
    dim = ids.shape[axis]
    shape = [1] * ids.ndim
    shape[axis] = dim
    col_mask = (ranks < int(dim * pct)).reshape(shape)
    return torch.where(col_mask, noise.to(ids.dtype), ids)


def replace_pct_rand_columns(ids: torch.Tensor, pct: float, low: int, high: int,
                             generator: torch.Generator, axis: int = 1) -> torch.Tensor:
    """Replace ``floor(pct * dim)`` whole columns along ``axis`` (shared across
    the batch) with uniform ints in ``[low, high)``, drawn from ``generator``
    (on ``ids``' device)."""
    dim = ids.shape[axis]
    if math.isclose(pct, 0.0) or int(dim * pct) == 0:
        return ids
    ranks = torch.randperm(dim, generator=generator, device=ids.device)
    noise = global_draw(ids.shape, lambda shape: torch.randint(
        low, high, shape, generator=generator, device=ids.device, dtype=ids.dtype))
    return replace_pct_rand_columns_with(ids, pct, ranks, noise, axis)
