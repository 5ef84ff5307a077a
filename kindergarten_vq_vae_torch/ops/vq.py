"""Vector-quantization bottleneck, plain PyTorch version.

Counterpart of ``kindergarten_vq_vae_tpu/ops/vq.py`` ``vector_quantize``
(l.38): centered distances (l.55-62), first-minimum argmin, ``z_q`` as the
chosen code rows, ``mean((z_q - z)^2) + beta * mean((z_q - z)^2)``, the
straight-through value ``z + (z_q - z)``, codebook perplexity, and the
per-code ``counts`` / ``sum_z`` statistics. It is the plain version of the
CUDA kernel in :mod:`kindergarten_vq_vae_torch.ops.vq_kernel`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class VQOutput(NamedTuple):
    loss: torch.Tensor          # scalar commitment + codebook loss
    z_q: torch.Tensor           # (B, S, D) straight-through quantized latents
    perplexity: torch.Tensor    # scalar codebook usage perplexity
    one_hot: torch.Tensor       # (B*S, n_e) hard assignments
    indices: torch.Tensor       # (B, S, 1) int64 code indices
    counts: torch.Tensor        # (n_e,) per-code assignment counts
    sum_z: torch.Tensor         # (n_e, D) per-code sum of z


def perplexity_of(counts: torch.Tensor, total: int) -> torch.Tensor:
    e_mean = counts / total
    return torch.exp(-torch.sum(e_mean * torch.log(e_mean + 1e-10)))


def vector_quantize(z: torch.Tensor, codebook: torch.Tensor, beta: float) -> VQOutput:
    """Quantize ``z`` (B, S, D) against ``codebook`` (n_e, D), both f32.

    Distances use values centered on the codebook mean: the raw expansion
    ``|z|^2 + |e|^2 - 2 z.e`` loses its resolution when the codes sit close
    together far from the origin (see the JAX oracle's docstring)."""
    batch, seq_len, d = z.shape
    n_e = codebook.shape[0]
    z_flat = z.reshape(-1, d)

    center = codebook.mean(0)
    zc = z_flat - center
    ec = codebook - center
    dist = (zc * zc).sum(1, keepdim=True) + (ec * ec).sum(1) - 2.0 * (zc @ ec.T)
    indices = dist.argmin(1)  # first minimum on ties
    one_hot = F.one_hot(indices, n_e).to(z.dtype)
    z_q = codebook[indices].reshape(z.shape)  # exactly one_hot @ codebook

    diff = torch.mean((z_q - z) ** 2)
    loss = diff + beta * diff
    z_q_ste = z + (z_q - z).detach()

    counts = one_hot.sum(0)
    return VQOutput(
        loss=loss,
        z_q=z_q_ste,
        perplexity=perplexity_of(counts, z_flat.shape[0]),
        one_hot=one_hot,
        indices=indices.reshape(batch, seq_len, 1),
        counts=counts,
        sum_z=one_hot.T @ z_flat,
    )
