"""Vector-quantization bottleneck, plain PyTorch version, and its gradient.

Counterpart of ``kindergarten_vq_vae_tpu/ops/vq.py`` ``vector_quantize``
(l.38) and ``ops/vq_pallas.py`` ``fused_vector_quantize`` (l.187): centered
distances (vq.py l.55-62), first-minimum argmin, ``z_q`` as the chosen code
rows, the per-code ``counts`` / ``sum_z`` statistics, the sum ``diff`` of
``(z_q - z)^2``, and from them ``loss = (diff + beta * diff) / numel``, the
straight-through value ``z + (z_q - z)`` and the codebook perplexity.

The gradient is :class:`VQCore`, the JAX package's custom VJP
(``vq_pallas.py:149-184``): the loss's two terms are the same value with two
gradient paths, ``d1 ~ sum((sg[z_q] - z)^2)`` and ``d2 ~ sum((z_q - sg[z])^2)``,
so ``dz = g_zq + 2 g_d1 (z - z_q)`` and ``dE = index_add(2 g_d2 (z_q - z))``.
The raw forward is :func:`vq_raw` here and the CUDA kernel in
:mod:`kindergarten_vq_vae_torch.ops.vq_kernel`; everything else is shared.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from kindergarten_vq_vae_torch.utils.metrics import perplexity_from_counts


class VQOutput(NamedTuple):
    loss: torch.Tensor          # scalar commitment + codebook loss
    z_q: torch.Tensor           # (B, S, D) straight-through quantized latents
    perplexity: torch.Tensor    # scalar codebook usage perplexity
    one_hot: torch.Tensor       # (B*S, n_e) hard assignments
    indices: torch.Tensor       # (B, S, 1) int64 code indices
    counts: torch.Tensor        # (n_e,) per-code assignment counts
    sum_z: torch.Tensor         # (n_e, D) per-code sum of z


def vq_raw(z_flat: torch.Tensor, codebook: torch.Tensor):
    """Plain raw forward of (rows, D) f32 ``z_flat``: ``(z_q, indices (int64),
    counts, sum_z, diff)``.

    Distances use values centered on the codebook mean: the raw expansion
    ``|z|^2 + |e|^2 - 2 z.e`` loses its resolution when the codes sit close
    together far from the origin (see the JAX oracle's docstring)."""
    n_e = codebook.shape[0]
    center = codebook.mean(0)
    zc = z_flat - center
    ec = codebook - center
    dist = (zc * zc).sum(1, keepdim=True) + (ec * ec).sum(1) - 2.0 * (zc @ ec.T)
    indices = dist.argmin(1)  # first minimum on ties
    one_hot = F.one_hot(indices, n_e).to(z_flat.dtype)
    z_q = codebook[indices]  # exactly one_hot @ codebook
    return z_q, indices, one_hot.sum(0), one_hot.T @ z_flat, ((z_q - z_flat) ** 2).sum()


RawFn = Callable[[torch.Tensor, torch.Tensor], tuple]


def _core(z_flat, codebook, raw_fn: RawFn):
    """``(z_q_ste, diff, indices, counts, sum_z)`` from a raw forward."""
    zq, idx, counts, sumz, diff = raw_fn(z_flat, codebook)
    return z_flat + (zq - z_flat), diff, idx, counts, sumz


class VQCore(torch.autograd.Function):
    """``(z_q_ste, diff1, diff2, indices, counts, sum_z)`` of ``z_flat``
    against ``codebook`` with the custom VJP of ``_fused_vq_core``."""

    @staticmethod
    def forward(ctx, z_flat, codebook, raw_fn: RawFn):
        z_q, diff, idx, counts, sumz = _core(z_flat, codebook, raw_fn)
        ctx.save_for_backward(z_flat, codebook, idx)
        ctx.mark_non_differentiable(idx, counts, sumz)
        return z_q, diff, diff.clone(), idx, counts, sumz

    @staticmethod
    def backward(ctx, g_zq, g_d1, g_d2, _g_idx, _g_counts, _g_sumz):
        z_flat, codebook, idx = ctx.saved_tensors
        zq = codebook[idx]
        dz = dE = None
        if ctx.needs_input_grad[0]:
            dz = torch.zeros_like(z_flat) if g_zq is None else g_zq
            if g_d1 is not None:
                dz = dz + g_d1 * 2.0 * (z_flat - zq)
        if ctx.needs_input_grad[1]:
            dE = torch.zeros_like(codebook)
            if g_d2 is not None:
                dE.index_add_(0, idx, g_d2 * 2.0 * (zq - z_flat))
        return dz, dE, None


def assemble(z: torch.Tensor, codebook: torch.Tensor, beta: float, raw_fn: RawFn) -> VQOutput:
    """The bottleneck's outputs from a raw forward (``fused_vector_quantize`` l.203-228)."""
    batch, seq_len, d = z.shape
    n_e = codebook.shape[0]
    z_flat = z.reshape(-1, d)
    if torch.is_grad_enabled() and (z.requires_grad or codebook.requires_grad):
        z_q, d1, d2, idx, counts, sumz = VQCore.apply(z_flat, codebook, raw_fn)
    else:  # serving: no autograd bookkeeping
        z_q, d1, idx, counts, sumz = _core(z_flat, codebook, raw_fn)
        d2 = d1
    return VQOutput(
        loss=(d1 + beta * d2) / z_flat.numel(),
        z_q=z_q.reshape(z.shape),
        perplexity=perplexity_from_counts(counts, z_flat.shape[0]),
        one_hot=F.one_hot(idx, n_e).to(z.dtype),
        indices=idx.reshape(batch, seq_len, 1),
        counts=counts,
        sum_z=sumz,
    )


def vector_quantize(z: torch.Tensor, codebook: torch.Tensor, beta: float) -> VQOutput:
    """Quantize ``z`` (B, S, D) against ``codebook`` (n_e, D), both f32, in
    plain PyTorch on any device (the kernel's comparison baseline)."""
    return assemble(z, codebook, beta, vq_raw)
