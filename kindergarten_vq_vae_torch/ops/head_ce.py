"""Fused MLM-head vocab projection + cross-entropy + argmax: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``kindergarten_vq_vae_tpu/ops/head_ce_pallas.py``
``fused_head_ce_loss`` (l.299-373): from the MLM transform's output (B, S, H),
the tied word table (V, H) and the head bias (V,), the mean NLL over the
valid rows and the (B, S) argmax ids, without the (B*S, V) logits ever
reaching a separate CE pass. The forward kernel (``csrc/head_ce.cu``
``kvq_head_ce_fwd``, TPU kernel #9 ``_fwd_kernel`` l.67) computes each
logits tile on the tensor cores, rounds it where the logits path rounds
(``bf16(x @ E^T) + bf16(b)``) and reduces it to per-row NLL, lse and ids;
``mode="store"`` also writes the bf16 logits for the backward, ``"flash"``
recomputes them there. The backward kernel (``kvq_head_ce_bwd``, #10
``_bwd_kernel`` l.179) writes ``g = (softmax - one_hot) * scale`` in bf16,
the bias gradient as f32 column sums of the f32 ``g``, and ``dx = g @ E``.
Around them, as ``_fused_fwd`` / ``_fused_bwd`` (l.321-370): the table is
cast to the compute dtype once per call, ``denom = max(sum(valid), 1) * S``
unless given, ``scale = g / denom * w``, and ``d_table = g^T @ x`` in f32
outside the kernel (l.365-367: an XLA matmul with f32 output; here the
port's own GEMM, ``kvq_head_ce_dtable``, on CUDA).

On CUDA ``g`` is kept with a leading dimension rounded up to 8 (its pad
columns zero), because the GEMMs that read it need 16-byte rows; the
functions here hand it around as a (rows, V) view.
"""

from __future__ import annotations

import ctypes

import torch

from kindergarten_vq_vae_torch import _build
from kindergarten_vq_vae_torch.ops.ce import (
    ce_fwd_ids_reference,
    ce_grad_reference,
    target_logits,
)

_VP, _I = ctypes.c_void_p, ctypes.c_int
MODES = ("store", "flash")
TILE = 128  # the kernels' row and vocab tiles (csrc/layer_common.cuh BM, BN)
LD_ALIGN = 8  # g's leading dimension: V rounded up to this


def _logits_reference(x2, table_c, bias):
    """``x @ E^T + bf16(b)`` in the compute dtype: the vocab projection of the
    logits path, with its rounding points."""
    return x2 @ table_c.t() + bias.to(x2.dtype)


def head_ce_fwd_reference(x2, table_c, bias, targets, mode: str):
    """Plain #9: (nll, lse, ids, logits or None); the logits are returned in
    ``"store"`` mode only, as the kernel writes them."""
    logits = _logits_reference(x2, table_c, bias)
    nll, ids = ce_fwd_ids_reference(logits, targets)
    lse = nll + target_logits(logits, targets)
    return nll, lse, ids, logits if mode == "store" else None


def head_ce_bwd_reference(saved, table_c, bias, targets, lse, scale, mode: str):
    """Plain #10: (g in the compute dtype, dx, dbias f32). ``saved`` is the
    stored logits (``"store"``) or x (``"flash"``, the logits recomputed)."""
    logits = saved if mode == "store" else _logits_reference(saved, table_c, bias)
    gm = ce_grad_reference(logits, targets, lse, scale)
    g = gm.to(logits.dtype)
    return g, g @ table_c, gm.sum(0)


def table_grad_reference(g, x2) -> torch.Tensor:
    """``g^T @ x`` in f32 (plain)."""
    return g.t().float() @ x2.float()


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"fused head + CE mode {mode!r}: expected one of {MODES}")


def _check_head(table_c, bias, targets, rows, dev):
    """Check the operands both kernels take; return (V, H)."""
    v, h = table_c.shape
    _build.check_tensor("table", table_c, (v, h), torch.bfloat16, dev)
    _build.check_tensor("bias", bias, (v,), torch.float32, dev)
    _build.check_tensor("targets", targets, (rows,), torch.int32, dev)
    if h % 8:
        raise ValueError(f"the hidden width {h} must be a multiple of 8")
    return v, h


def head_ce_fwd(x2, table_c, bias, targets, mode: str):
    """#9: (nll, lse, ids, logits or None) of (rows, H) bf16 x, the (V, H)
    bf16 table, the (V,) f32 bias and (rows,) int32 targets. A CPU tensor
    takes :func:`head_ce_fwd_reference`; a CUDA tensor launches
    ``kvq_head_ce_fwd`` or raises, and each call adds one to
    ``head_ce_fwd.launches``."""
    _check_mode(mode)
    if x2.device.type == "cpu":
        return head_ce_fwd_reference(x2, table_c, bias, targets, mode)
    rows, dev = x2.shape[0], x2.device
    v, h = _check_head(table_c, bias, targets, rows, dev)
    _build.check_tensor("x", x2, (rows, h), torch.bfloat16, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    ntiles = -(-v // TILE)
    parts_f32 = torch.empty((3, ntiles, rows), **f32)
    parts_i32 = torch.empty((ntiles, rows), dtype=torch.int32, device=dev)
    logits = torch.empty((rows, v), dtype=torch.bfloat16, device=dev) if mode == "store" else None
    nll, lse = torch.empty((rows,), **f32), torch.empty((rows,), **f32)
    ids = torch.empty((rows,), dtype=torch.int32, device=dev)
    _build.launch("kvq_head_ce_fwd", [_VP] * 4 + [_I] * 3 + [_VP] * 6, x2.data_ptr(),
                  table_c.data_ptr(), bias.data_ptr(), targets.data_ptr(), rows, v, h,
                  None if logits is None else logits.data_ptr(), parts_f32.data_ptr(),
                  parts_i32.data_ptr(), nll.data_ptr(), lse.data_ptr(), ids.data_ptr(),
                  device=dev)
    head_ce_fwd.launches += 1
    return nll, lse, ids, logits


head_ce_fwd.launches = 0


def head_ce_bwd(saved, table_c, bias, targets, lse, scale, mode: str):
    """#10: (g, dx, dbias) as :func:`head_ce_bwd_reference`; ``saved`` is the
    stored logits (``"store"``) or x (``"flash"``). A CPU tensor takes the
    plain version; a CUDA tensor launches ``kvq_head_ce_bwd`` (g and the
    dbias partials, their sum, and the dx GEMM) or raises, and each call adds
    one to ``head_ce_bwd.launches``. ``g`` is a (rows, V) view of a buffer
    whose rows are V rounded up to 8 wide."""
    _check_mode(mode)
    if saved.device.type == "cpu":
        return head_ce_bwd_reference(saved, table_c, bias, targets, lse, scale, mode)
    rows, dev = saved.shape[0], saved.device
    v, h = _check_head(table_c, bias, targets, rows, dev)
    x2 = saved if mode == "flash" else None
    logits = saved if mode == "store" else None
    if x2 is not None:
        _build.check_tensor("x", x2, (rows, h), torch.bfloat16, dev)
    else:
        _build.check_tensor("logits", logits, (rows, v), torch.bfloat16, dev)
    for name, t in (("lse", lse), ("scale", scale)):
        _build.check_tensor(name, t, (rows,), torch.float32, dev)
    ldg = -(-v // LD_ALIGN) * LD_ALIGN
    g = torch.empty((rows, ldg), dtype=torch.bfloat16, device=dev)
    dparts = torch.empty((-(-rows // TILE), v), dtype=torch.float32, device=dev)
    dbias = torch.empty((v,), dtype=torch.float32, device=dev)
    dx = torch.empty((rows, h), dtype=torch.bfloat16, device=dev)
    _build.launch("kvq_head_ce_bwd", [_VP] * 7 + [_I] * 3 + [_VP, _I] + [_VP] * 3,
                  None if x2 is None else x2.data_ptr(), table_c.data_ptr(), bias.data_ptr(),
                  None if logits is None else logits.data_ptr(), targets.data_ptr(),
                  lse.data_ptr(), scale.data_ptr(), rows, v, h, g.data_ptr(), ldg,
                  dparts.data_ptr(), dbias.data_ptr(), dx.data_ptr(), device=dev)
    head_ce_bwd.launches += 1
    return g[:, :v], dx, dbias


head_ce_bwd.launches = 0


def table_grad(g, x2) -> torch.Tensor:
    """``d_table = g^T @ x`` (V, H) in f32. A CPU tensor takes
    :func:`table_grad_reference`; a CUDA tensor launches the port's wmma GEMM
    (``kvq_head_ce_dtable``) over ``g`` as :func:`head_ce_bwd` returns it."""
    if g.device.type == "cpu":
        return table_grad_reference(g, x2)
    rows, v = g.shape
    h = x2.shape[1]
    ldg = g.stride(0)
    if (g.dtype != torch.bfloat16 or g.stride(1) != 1 or ldg % LD_ALIGN or g.data_ptr() % 16):
        raise ValueError("table_grad takes g as head_ce_bwd returns it: bf16 rows of a width "
                         "that is a multiple of 8, 16-byte aligned")
    _build.check_tensor("x", x2, (rows, h), torch.bfloat16, g.device)
    out = torch.empty((v, h), dtype=torch.float32, device=g.device)
    _build.launch("kvq_head_ce_dtable", [_VP, _I, _VP, _I, _I, _I, _VP], g.data_ptr(), ldg,
                  x2.data_ptr(), rows, v, h, out.data_ptr(), device=g.device)
    return out


class FusedHeadCE(torch.autograd.Function):
    """``fused_head_ce_loss`` with its custom VJP (``_fused_fwd`` /
    ``_fused_bwd``, ``head_ce_pallas.py:321-370``)."""

    @staticmethod
    def forward(ctx, hidden, table, bias, target_ids, valid_row, denom, mode, reference):
        _check_mode(mode)
        b, s, h = hidden.shape
        x2 = hidden.reshape(b * s, h).contiguous()
        targets = target_ids.reshape(-1).to(torch.int32).contiguous()
        table_c = table.to(hidden.dtype).contiguous()  # once per call (l.335 / l.357)
        bias_c = bias.float().contiguous()
        fwd = head_ce_fwd_reference if reference else head_ce_fwd
        nll, lse, ids, logits = fwd(x2, table_c, bias_c, targets, mode)
        w = valid_row.float().repeat_interleave(s)
        if denom is None:
            denom = torch.clamp(valid_row.float().sum(), min=1.0) * s
        denom = torch.as_tensor(denom, dtype=torch.float32, device=hidden.device)
        loss = (nll * w).sum() / denom
        ctx.save_for_backward(logits if mode == "store" else x2, x2, table_c, bias_c, targets,
                              lse, w, denom)
        ctx.mode, ctx.reference, ctx.shape = mode, reference, (b, s, h)
        ctx.dtypes = (table.dtype, bias.dtype)
        ctx.mark_non_differentiable(ids)
        return loss, ids.reshape(b, s)

    @staticmethod
    def backward(ctx, g_loss, _g_ids):
        saved, x2, table_c, bias_c, targets, lse, w, denom = ctx.saved_tensors
        scale = ((g_loss / denom) * w).contiguous()
        if ctx.reference:
            bwd, tgrad = head_ce_bwd_reference, table_grad_reference
        else:
            bwd, tgrad = head_ce_bwd, table_grad
        g, dx, dbias = bwd(saved, table_c, bias_c, targets, lse, scale, ctx.mode)
        d_table = tgrad(g, x2)
        return (dx.reshape(ctx.shape), d_table.to(ctx.dtypes[0]), dbias.to(ctx.dtypes[1]),
                None, None, None, None, None)


def fused_head_ce_loss(hidden, table, bias, target_ids, valid_row, denom=None,
                       mode: str = "store", reference: bool = False):
    """(B, S, H) transformed hidden states, the (V, H) tied table (f32; cast
    to the hidden states' dtype here), the (V,) f32 bias, (B, S) targets and
    (B,) 1/0 valid rows -> (scalar mean NLL, (B, S) int32 argmax ids).
    ``denom``: the normaliser, ``max(sum(valid_row), 1) * S`` when None.
    ``reference=True`` takes the plain versions on any device."""
    return FusedHeadCE.apply(hidden, table, bias, target_ids, valid_row, denom, mode, reference)
