"""Streaming cross-entropy (+ argmax) over the logits: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``kindergarten_vq_vae_tpu/ops/ce_pallas.py`` ``fused_ce_loss``
(l.207-249) and ``fused_ce_loss_ids`` (l.252-286): the mean NLL of the
target ids over the valid rows, the latter also ``argmax(logits)`` from the
same read of the logits. The forward kernels (``csrc/ce.cu``: ``kvq_ce_fwd``,
TPU kernel #6 ``_ce_fwd_kernel`` l.34, and ``kvq_ce_fwd_ids``, #7
``_ce_fwd_ids_kernel`` l.63) return per-row f32 NLL and, for #7, int32 ids
(the lowest index among equal maxima); the backward kernel (``kvq_ce_bwd``,
#8 ``_ce_bwd_kernel`` l.104, which ``fused_ce_loss`` shares as l.245 does)
writes ``(softmax - one_hot) * scale`` in the logits' dtype. Around them, as
l.263-283: ``lse = nll + x[target]``, ``denom = max(sum(valid), 1) * S``
and ``scale = g / denom * valid``.
"""

from __future__ import annotations

import ctypes

import torch

from kindergarten_vq_vae_torch import _build

_VP, _I = ctypes.c_void_p, ctypes.c_int


def target_logits(logits2d: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(rows,) f32 ``logits2d[r, targets[r]]``; a target outside the
    vocabulary gathers 0, as the TPU kernels' hit mask does."""
    t = targets.long()
    v = logits2d.shape[1]
    inside = (t >= 0) & (t < v)
    got = logits2d.gather(1, t.clamp(0, v - 1)[:, None])[:, 0].float()
    return torch.where(inside, got, torch.zeros_like(got))


def ce_fwd_ids_reference(logits2d: torch.Tensor, targets: torch.Tensor):
    """Plain forward: (rows,) f32 NLL and (rows,) int32 argmax."""
    x = logits2d.float()
    m = x.amax(1, keepdim=True)
    lse = (m + torch.log(torch.exp(x - m).sum(1, keepdim=True)))[:, 0]
    return lse - target_logits(x, targets), torch.argmax(x, 1).to(torch.int32)  # first maximum


def ce_fwd_reference(logits2d: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Plain forward of #6: (rows,) f32 NLL."""
    return ce_fwd_ids_reference(logits2d, targets)[0]


def ce_grad_reference(logits2d, targets, lse, scale) -> torch.Tensor:
    """``(exp(x - lse) - one_hot) * scale`` in f32; a target outside the
    vocabulary has no one-hot, as in the kernels' ``iota == target``."""
    g = torch.exp(logits2d.float() - lse[:, None])
    t = targets.long()
    v = g.shape[1]
    inside = ((t >= 0) & (t < v)).float()
    g[torch.arange(g.shape[0], device=g.device), t.clamp(0, v - 1)] -= inside
    return g * scale[:, None]


def ce_bwd_reference(logits2d, targets, lse, scale) -> torch.Tensor:
    """Plain backward: :func:`ce_grad_reference` in the logits' dtype."""
    return ce_grad_reference(logits2d, targets, lse, scale).to(logits2d.dtype)


def _check(logits2d, targets, what):
    if logits2d.dtype != torch.bfloat16 or logits2d.dim() != 2 or not logits2d.is_contiguous():
        raise TypeError(f"{what} takes contiguous bf16 (rows, vocab) logits, got "
                        f"{logits2d.dtype} {tuple(logits2d.shape)}")
    if (targets.dtype != torch.int32 or targets.shape != logits2d.shape[:1]
            or targets.device != logits2d.device or not targets.is_contiguous()):
        raise TypeError(f"{what} takes contiguous int32 (rows,) targets on the logits' device")


def ce_fwd(logits2d: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-row NLL (#6). A CPU tensor takes :func:`ce_fwd_reference`; a CUDA
    tensor launches ``kvq_ce_fwd`` or raises, and each launch adds one to
    ``ce_fwd.launches``."""
    if logits2d.device.type == "cpu":
        return ce_fwd_reference(logits2d, targets)
    _check(logits2d, targets, "ce_fwd")
    rows, vocab = logits2d.shape
    nll = torch.empty((rows,), dtype=torch.float32, device=logits2d.device)
    _build.launch("kvq_ce_fwd", [_VP, _VP, _VP, _I, _I], logits2d.data_ptr(),
                  targets.data_ptr(), nll.data_ptr(), rows, vocab, device=logits2d.device)
    ce_fwd.launches += 1
    return nll


ce_fwd.launches = 0


def ce_fwd_ids(logits2d: torch.Tensor, targets: torch.Tensor):
    """Per-row NLL and argmax (#7). A CPU tensor takes
    :func:`ce_fwd_ids_reference`; a CUDA tensor launches ``kvq_ce_fwd_ids``
    or raises, and each launch adds one to ``ce_fwd_ids.launches``."""
    if logits2d.device.type == "cpu":
        return ce_fwd_ids_reference(logits2d, targets)
    _check(logits2d, targets, "ce_fwd_ids")
    rows, vocab = logits2d.shape
    dev = logits2d.device
    nll = torch.empty((rows,), dtype=torch.float32, device=dev)
    ids = torch.empty((rows,), dtype=torch.int32, device=dev)
    _build.launch("kvq_ce_fwd_ids", [_VP, _VP, _VP, _VP, _I, _I], logits2d.data_ptr(),
                  targets.data_ptr(), nll.data_ptr(), ids.data_ptr(), rows, vocab, device=dev)
    ce_fwd_ids.launches += 1
    return nll, ids


ce_fwd_ids.launches = 0


def ce_bwd(logits2d, targets, lse, scale) -> torch.Tensor:
    """The logits' gradient (#8). A CPU tensor takes :func:`ce_bwd_reference`;
    a CUDA tensor launches ``kvq_ce_bwd`` or raises, and each launch adds one
    to ``ce_bwd.launches``."""
    if logits2d.device.type == "cpu":
        return ce_bwd_reference(logits2d, targets, lse, scale)
    _check(logits2d, targets, "ce_bwd")
    rows, vocab = logits2d.shape
    for name, t in (("lse", lse), ("scale", scale)):
        if t.dtype != torch.float32 or t.shape != (rows,) or not t.is_contiguous():
            raise TypeError(f"ce_bwd takes contiguous f32 (rows,) {name}")
    out = torch.empty_like(logits2d)
    _build.launch("kvq_ce_bwd", [_VP, _VP, _VP, _VP, _VP, _I, _I], logits2d.data_ptr(),
                  targets.data_ptr(), lse.data_ptr(), scale.data_ptr(), out.data_ptr(), rows,
                  vocab, device=logits2d.device)
    ce_bwd.launches += 1
    return out


ce_bwd.launches = 0


class FusedCE(torch.autograd.Function):
    """``fused_ce_loss_ids`` (``ids=True``, ``ce_pallas.py:263-283``) and
    ``fused_ce_loss`` (``ids=False``, l.224-246) with their custom VJP."""

    @staticmethod
    def forward(ctx, logits, target_ids, valid_row, reference, ids):
        b, s, v = logits.shape
        logits2d = logits.reshape(b * s, v)
        targets = target_ids.reshape(-1).to(torch.int32).contiguous()
        if ids:
            nll, argmax = (ce_fwd_ids_reference if reference else ce_fwd_ids)(logits2d, targets)
        else:
            nll = (ce_fwd_reference if reference else ce_fwd)(logits2d, targets)
        w = valid_row.float().repeat_interleave(s)
        denom = torch.clamp(valid_row.float().sum(), min=1.0) * s
        loss = (nll * w).sum() / denom
        lse = nll + target_logits(logits2d, targets)
        ctx.save_for_backward(logits2d, targets, lse, w, denom)
        ctx.reference, ctx.shape = reference, (b, s, v)
        if not ids:
            return loss
        ctx.mark_non_differentiable(argmax)
        return loss, argmax.reshape(b, s)

    @staticmethod
    def backward(ctx, g, _g_ids=None):
        logits2d, targets, lse, w, denom = ctx.saved_tensors
        scale = ((g / denom) * w).contiguous()
        bwd = ce_bwd_reference if ctx.reference else ce_bwd
        return bwd(logits2d, targets, lse, scale).reshape(ctx.shape), None, None, None, None


def fused_ce_loss_ids(logits, target_ids, valid_row, reference: bool = False):
    """(B, S, V) logits, (B, S) targets, (B,) 1/0 valid rows -> (scalar mean
    NLL over the valid rows, (B, S) int32 argmax ids). ``reference=True``
    takes the plain versions on any device."""
    return FusedCE.apply(logits, target_ids, valid_row, reference, True)


def fused_ce_loss(logits, target_ids, valid_row, reference: bool = False):
    """:func:`fused_ce_loss_ids` without the ids: the scalar mean NLL (#6
    forward, #8 backward)."""
    return FusedCE.apply(logits, target_ids, valid_row, reference, False)
