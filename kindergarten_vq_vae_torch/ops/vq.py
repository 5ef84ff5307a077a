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

The codebook's training extras of ``ops/vq.py`` follow: the EMA codebook
update (l.99-128) and dead-code revival (l.171-198), whose random draws
come from a :class:`torch.Generator` and whose arithmetic given the draws
is :func:`dead_code_reset_with`.
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


class EMAState(NamedTuple):
    counts: torch.Tensor  # (n_e,) EMA of per-code assignment counts
    means: torch.Tensor   # (n_e, D) EMA of per-code sums of z


def init_ema_state(codebook: torch.Tensor) -> EMAState:
    """``ops/vq.py:104-106``: unit counts, means at the codebook."""
    return EMAState(torch.ones(codebook.shape[0], dtype=codebook.dtype, device=codebook.device),
                    codebook.detach().clone())


def ema_codebook_update(codebook: torch.Tensor, state: EMAState, counts: torch.Tensor,
                        sum_z: torch.Tensor, decay: float = 0.99, eps: float = 1e-5):
    """``(new_codebook, new_state)``: the EMA codebook update of
    ``ops/vq.py:109-128`` (VQ-VAE appendix A.1) from one batch's per-code
    ``counts`` and ``sum_z``, with Laplace smoothing of the counts."""
    new_counts = decay * state.counts + (1.0 - decay) * counts
    new_means = decay * state.means + (1.0 - decay) * sum_z
    n = new_counts.sum()
    n_e = codebook.shape[0]
    smoothed = (new_counts + eps) / (n + n_e * eps) * n
    return new_means / smoothed[:, None], EMAState(new_counts, new_means)


def dead_code_reset_with(codebook, dead_steps, counts, z_rows, pick, noise, threshold: int = 100,
                         noise_scale: float = 1e-3):
    """The arithmetic of ``ops/vq.py:171-198`` given its random draws:
    ``pick`` (n_e,) row indices into ``z_rows`` and ``noise`` (n_e, D)
    standard normals. ``dead_steps`` counts consecutive steps without an
    assignment; a code past ``threshold`` is re-seeded to ``z_rows[pick] +
    noise_scale * noise``. Returns ``(new_codebook, new_dead_steps)``."""
    dead_steps = torch.where(counts > 0, torch.zeros_like(dead_steps), dead_steps + 1)
    expired = dead_steps >= threshold
    replacements = z_rows.float()[pick] + noise_scale * noise
    new_codebook = torch.where(expired[:, None], replacements.to(codebook.dtype), codebook)
    return new_codebook, torch.where(expired, torch.zeros_like(dead_steps), dead_steps)


def dead_code_reset(codebook, dead_steps, counts, z_rows, generator: torch.Generator,
                    threshold: int = 100, noise_scale: float = 1e-3):
    """Dead-code revival with ``pick`` and ``noise`` drawn from ``generator``
    (on the codebook's device)."""
    n_e = codebook.shape[0]
    pick = torch.randint(0, z_rows.shape[0], (n_e,), generator=generator, device=codebook.device)
    noise = torch.randn(codebook.shape, generator=generator, device=codebook.device,
                        dtype=codebook.dtype)
    return dead_code_reset_with(codebook, dead_steps, counts, z_rows, pick, noise, threshold,
                                noise_scale)
