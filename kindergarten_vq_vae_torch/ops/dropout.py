"""Counter-based hash dropout: the keep masks of the fused layer, in plain PyTorch.

Counterpart of ``kindergarten_vq_vae_tpu/ops/layer_pallas.py`` ``_keep_2d``
(l.142, the hidden sites) and ``ops/sdpa_pallas.py`` ``_dropout_keep_scale``
(l.77, attention probabilities). A mask element is kept iff

    h = fmix32((row * 0x9E3779B1 + seed + op * 0xC2B2AE3D) ^ (col * 0x85EBCA77))
    h >= threshold

with all arithmetic mod 2**32. ``row`` is the absolute query row
(``sentence * s_q + pos``); ``col`` is the hidden column, or for attention
the key position *within* the sentence. ``op`` separates the sites:
self-attention heads ``0..nh-1``, cross-attention heads ``nh+1+h``, and the
hidden sites :data:`OP_ATTN_OUT`, :data:`OP_CROSS_OUT`, :data:`OP_MLP_OUT`.
No generator state: forward and backward rebuild the same mask from the seed.

``csrc/dropout_hash.cuh`` is the same function for the CUDA kernels; both
take :func:`keep_threshold` and :func:`keep_scale` from the host, computed
exactly as the JAX package computes them.
"""

from __future__ import annotations

import numpy as np
import torch

OP_ATTN_OUT, OP_CROSS_OUT, OP_MLP_OUT = 1000, 1001, 1002
_M32 = 0xFFFFFFFF


def cross_op(num_heads: int) -> int:
    """Op id of cross-attention head 0 (``layer_pallas.py:419``: ``nh + 1``)."""
    return num_heads + 1


def keep_threshold(rate: float) -> int:
    """uint32 threshold, as ``np.uint32(min(rate, 1.0) * float(2**32 - 1))``."""
    return int(np.uint32(min(rate, 1.0) * float(2**32 - 1)))


def keep_scale(rate: float) -> float:
    """``1 / (1 - rate)`` in f64, rounded to f32 (the value a kept element is scaled by)."""
    return float(np.float32(1.0 / (1.0 - rate)))


def seed_u32(seed: int) -> int:
    """A signed int32 seed as the uint32 the hash adds."""
    return int(seed) & _M32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32), without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_keep(rows: torch.Tensor, cols: torch.Tensor, op: int, seed: int,
              rate: float) -> torch.Tensor:
    """f32 keep/scale mask (``keep_scale(rate)`` where kept, 0 where dropped)
    for broadcastable int64 ``rows`` and ``cols``."""
    base = (seed_u32(seed) + _mul32(torch.tensor(op, dtype=torch.int64), 0xC2B2AE3D).item()) & _M32
    row_term = (_mul32(rows.to(torch.int64) & _M32, 0x9E3779B1) + base) & _M32
    x = _fmix(row_term ^ _mul32(cols.to(torch.int64) & _M32, 0x85EBCA77))
    keep = x >= keep_threshold(rate)
    return torch.where(keep, keep_scale(rate), 0.0).to(torch.float32)


def hidden_keep(seed: int, op: int, rows: int, cols: int, rate: float,
                device=None) -> torch.Tensor:
    """(rows, cols) mask of a hidden site over absolute rows ``0..rows-1``
    (``_keep_2d`` l.142-161)."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return hash_keep(r, c, op, seed, rate)


def attention_keep(seed: int, op: int, batch: int, s_q: int, s_k: int, rate: float,
                   device=None) -> torch.Tensor:
    """(batch, s_q, s_k) mask of one attention head: row ``b * s_q + i``,
    column the key position ``j`` within the sentence (``_dropout_keep_scale``
    l.77-100 on the block-diagonal entries, the only ones it keeps)."""
    r = (torch.arange(batch, dtype=torch.int64, device=device)[:, None, None] * s_q
         + torch.arange(s_q, dtype=torch.int64, device=device)[None, :, None])
    c = torch.arange(s_k, dtype=torch.int64, device=device)[None, None, :]
    return hash_keep(r, c, op, seed, rate)
