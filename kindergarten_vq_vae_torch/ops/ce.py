"""Streaming cross-entropy + argmax over the logits: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``kindergarten_vq_vae_tpu/ops/ce_pallas.py``
``fused_ce_loss_ids`` (l.252-286): the mean NLL of the target ids over the
valid rows, and ``argmax(logits)`` from the same read of the logits. The
forward kernel (``csrc/ce.cu`` ``kvq_ce_fwd_ids``, TPU kernel #7
``_ce_fwd_ids_kernel`` l.63) returns per-row f32 NLL and int32 ids (the
lowest index among equal maxima); the backward kernel (``kvq_ce_bwd``,
#8 ``_ce_bwd_kernel`` l.104) writes ``(softmax - one_hot) * scale`` in the
logits' dtype. Around them, as l.263-283: ``lse = nll + x[target]``,
``denom = max(sum(valid), 1) * S`` and ``scale = g / denom * valid``.
"""

from __future__ import annotations

import ctypes

import torch

from kindergarten_vq_vae_torch import _build

_VP, _I = ctypes.c_void_p, ctypes.c_int


def ce_fwd_ids_reference(logits2d: torch.Tensor, targets: torch.Tensor):
    """Plain forward: (rows,) f32 NLL and (rows,) int32 argmax. A target
    outside the vocabulary gathers 0, as the TPU kernel's hit mask does."""
    x = logits2d.float()
    m = x.amax(1, keepdim=True)
    lse = (m + torch.log(torch.exp(x - m).sum(1, keepdim=True)))[:, 0]
    t = targets.long()
    inside = (t >= 0) & (t < x.shape[1])
    tl = torch.where(inside, x.gather(1, t.clamp(0, x.shape[1] - 1)[:, None])[:, 0], 0.0)
    return lse - tl, torch.argmax(x, 1).to(torch.int32)  # argmax: first maximum


def ce_bwd_reference(logits2d, targets, lse, scale) -> torch.Tensor:
    """Plain backward: ``(exp(x - lse) - one_hot) * scale`` in the logits' dtype."""
    x = logits2d.float()
    g = torch.exp(x - lse[:, None])
    g[torch.arange(x.shape[0], device=x.device), targets.long()] -= 1.0
    return (g * scale[:, None]).to(logits2d.dtype)


def _check(logits2d, targets, what):
    if logits2d.dtype != torch.bfloat16 or logits2d.dim() != 2 or not logits2d.is_contiguous():
        raise TypeError(f"{what} takes contiguous bf16 (rows, vocab) logits, got "
                        f"{logits2d.dtype} {tuple(logits2d.shape)}")
    if (targets.dtype != torch.int32 or targets.shape != logits2d.shape[:1]
            or targets.device != logits2d.device or not targets.is_contiguous()):
        raise TypeError(f"{what} takes contiguous int32 (rows,) targets on the logits' device")


def ce_fwd_ids(logits2d: torch.Tensor, targets: torch.Tensor):
    """Per-row NLL and argmax. A CPU tensor takes :func:`ce_fwd_ids_reference`;
    a CUDA tensor launches ``kvq_ce_fwd_ids`` or raises, and each launch adds
    one to ``ce_fwd_ids.launches``."""
    if logits2d.device.type == "cpu":
        return ce_fwd_ids_reference(logits2d, targets)
    _check(logits2d, targets, "ce_fwd_ids")
    rows, vocab = logits2d.shape
    dev = logits2d.device
    nll = torch.empty((rows,), dtype=torch.float32, device=dev)
    ids = torch.empty((rows,), dtype=torch.int32, device=dev)
    fn = _build.lib().kvq_ce_fwd_ids
    fn.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _VP]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(logits2d.data_ptr(), targets.data_ptr(), nll.data_ptr(), ids.data_ptr(), rows,
                  vocab, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "kvq_ce_fwd_ids")
    ce_fwd_ids.launches += 1
    return nll, ids


ce_fwd_ids.launches = 0


def ce_bwd(logits2d, targets, lse, scale) -> torch.Tensor:
    """The logits' gradient. A CPU tensor takes :func:`ce_bwd_reference`; a
    CUDA tensor launches ``kvq_ce_bwd`` or raises, and each launch adds one
    to ``ce_bwd.launches``."""
    if logits2d.device.type == "cpu":
        return ce_bwd_reference(logits2d, targets, lse, scale)
    _check(logits2d, targets, "ce_bwd")
    rows, vocab = logits2d.shape
    dev = logits2d.device
    for name, t in (("lse", lse), ("scale", scale)):
        if t.dtype != torch.float32 or t.shape != (rows,) or not t.is_contiguous():
            raise TypeError(f"ce_bwd takes contiguous f32 (rows,) {name}")
    out = torch.empty_like(logits2d)
    fn = _build.lib().kvq_ce_bwd
    fn.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _VP]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(logits2d.data_ptr(), targets.data_ptr(), lse.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), rows, vocab, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "kvq_ce_bwd")
    ce_bwd.launches += 1
    return out


ce_bwd.launches = 0


class FusedCE(torch.autograd.Function):
    """``fused_ce_loss_ids`` with its custom VJP (``ce_pallas.py:263-283``)."""

    @staticmethod
    def forward(ctx, logits, target_ids, valid_row, reference):
        b, s, v = logits.shape
        logits2d = logits.reshape(b * s, v)
        targets = target_ids.reshape(-1).to(torch.int32).contiguous()
        fwd = ce_fwd_ids_reference if reference else ce_fwd_ids
        nll, ids = fwd(logits2d, targets)
        w = valid_row.float().repeat_interleave(s)
        denom = torch.clamp(valid_row.float().sum(), min=1.0) * s
        loss = (nll * w).sum() / denom
        lse = nll + logits2d.gather(1, targets.long()[:, None])[:, 0].float()
        ctx.save_for_backward(logits2d, targets, lse, w, denom)
        ctx.reference, ctx.shape = reference, (b, s, v)
        ctx.mark_non_differentiable(ids)
        return loss, ids.reshape(b, s)

    @staticmethod
    def backward(ctx, g, _g_ids):
        logits2d, targets, lse, w, denom = ctx.saved_tensors
        scale = ((g / denom) * w).contiguous()
        bwd = ce_bwd_reference if ctx.reference else ce_bwd
        return bwd(logits2d, targets, lse, scale).reshape(ctx.shape), None, None, None


def fused_ce_loss_ids(logits, target_ids, valid_row, reference: bool = False):
    """(B, S, V) logits, (B, S) targets, (B,) 1/0 valid rows -> (scalar mean
    NLL over the valid rows, (B, S) int32 argmax ids). ``reference=True``
    takes the plain versions on any device."""
    return FusedCE.apply(logits, target_ids, valid_row, reference)
