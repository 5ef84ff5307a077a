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

On CUDA the store-mode logits and ``g`` are kept with a leading dimension
rounded up to 8 (their pad columns zero), because the GEMMs and the 16-byte
loads that read them need 16-byte rows; the functions here hand them around
as (rows, V) views. Every product runs on the port's wgmma + TMA GEMM
(``csrc/gemm_sm90.cuh``): #9 and #10's flash recompute with the CE work in
its epilogue, at one pinned tile width (:data:`HEAD_TILE_N`) so that both
see the same logits; ``dx`` and ``d_table`` as its NN and TN split-K
products, planned by ``ops/gemm.py`` ``gemm_plan``.

f32 operands (JAX's parity dtype: x, the table, the logits and ``g`` f32,
``l = x @ E^T + b`` with no rounding between the product and the CE) take
the f32 instances (``kvq_head_ce_*_f32``), on the port's f32 GEMM
(``csrc/gemm_f32.cu``, 3xTF32): #9 and #10's flash recompute as its NT
product with a CE epilogue on 128 x 128 tiles, store mode's backward as a
pass over the f32 logits that sums dbias in the epilogue's order (flash
equals store to the bit), ``dx`` and ``d_table`` as its NN and TN split-K
products (planned by ``gemm_f32_plan``) over g's padded rows. Each f32 call
also adds one to its wrapper's ``f32_launches``.
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
from kindergarten_vq_vae_torch.ops.gemm import (
    TILE_M,
    GemmPlan,
    gemm_f32_plan,
    gemm_plan,
    sm_count,
)

_VP, _I = ctypes.c_void_p, ctypes.c_int
MODES = ("store", "flash")
# the CE epilogues' vocab tile (csrc/head_ce.cu HEAD_TILE_N), pinned: #9 and
# #10's flash recompute must cut the logits alike
HEAD_TILE_N = 128
LD_ALIGN = 8  # the stored logits' and g's leading dimension: V rounded up to this
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def padded_ld(v: int) -> int:
    """The leading dimension of the store-mode logits and of ``g``."""
    return -(-v // LD_ALIGN) * LD_ALIGN


def fwd_partials_shapes(rows: int, v: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """#9's per-(vocab tile, row) partials: f32 (max, sum of exp, target
    logit) planes and the int32 first-argmax plane."""
    tiles = -(-v // HEAD_TILE_N)
    return (3, tiles, rows), (tiles, rows)


def dbias_partials_shape(rows: int, v: int) -> tuple[int, int]:
    """#10's per-(row tile, column) dbias partials."""
    return -(-rows // TILE_M), v


def dx_plan(rows: int, h: int, v: int, sms: int) -> GemmPlan:
    """The plan of ``dx = g @ E`` (NN, K = V, bf16 out)."""
    return gemm_plan(rows, h, v, False, sms, "bf16")


def dtable_plan(v: int, h: int, rows: int, sms: int, f32: bool = False) -> GemmPlan:
    """The plan of ``d_table = g^T @ x`` (TN, split-K over the rows, f32 out),
    on the bf16 GEMM or, with ``f32``, on the f32 one."""
    return gemm_f32_plan(v, h, rows, sms) if f32 else gemm_plan(v, h, rows, True, sms)


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


def _check_dtype(x2) -> torch.dtype:
    """The compute dtype of the kernels' call: x's, bf16 or f32."""
    if x2.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x has dtype {x2.dtype}, expected torch.bfloat16 or torch.float32")
    return x2.dtype


def _check_head(table_c, bias, targets, rows, dev, dtype):
    """Check the operands both kernels take; return (V, H)."""
    v, h = table_c.shape
    _build.check_tensor("table", table_c, (v, h), dtype, dev)
    _build.check_tensor("bias", bias, (v,), torch.float32, dev)
    _build.check_tensor("targets", targets, (rows,), torch.int32, dev)
    if h % 8:
        raise ValueError(f"the hidden width {h} must be a multiple of 8")
    return v, h


def _check_logits(logits, rows, v, dev, dtype):
    """Check the store-mode logits #10 reads: ``dtype`` (rows, V) with unit
    column stride and rows a multiple of 8 elements apart, 16-byte aligned."""
    if logits.device != dev:
        raise ValueError(f"logits is on {logits.device}, expected {dev}")
    if logits.dtype != dtype:
        raise TypeError(f"logits has dtype {logits.dtype}, expected {dtype}")
    if tuple(logits.shape) != (rows, v):
        raise ValueError(f"logits has shape {tuple(logits.shape)}, expected {(rows, v)}")
    ld = logits.stride(0)
    if logits.stride(1) != 1 or ld < v or ld % LD_ALIGN or logits.data_ptr() % 16:
        raise ValueError("head_ce_bwd takes the logits as head_ce_fwd returns them: rows a "
                         f"multiple of {LD_ALIGN} elements apart, 16-byte aligned")


def head_ce_fwd(x2, table_c, bias, targets, mode: str):
    """#9: (nll, lse, ids, logits or None) of (rows, H) x, the (V, H) table
    in x's dtype (bf16 or f32), the (V,) f32 bias and (rows,) int32 targets.
    A CPU tensor takes :func:`head_ce_fwd_reference`; a CUDA tensor launches
    ``kvq_head_ce_fwd`` (or ``kvq_head_ce_fwd_f32``) or raises, and each
    call adds one to ``head_ce_fwd.launches`` (and an f32 one to
    ``head_ce_fwd.f32_launches``). The store-mode logits, in x's dtype, are a
    (rows, V) view of a buffer whose rows are :func:`padded_ld` wide."""
    _check_mode(mode)
    if x2.device.type == "cpu":
        return head_ce_fwd_reference(x2, table_c, bias, targets, mode)
    rows, dev, dtype = x2.shape[0], x2.device, _check_dtype(x2)
    v, h = _check_head(table_c, bias, targets, rows, dev, dtype)
    _build.check_tensor("x", x2, (rows, h), dtype, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    pf_shape, pi_shape = fwd_partials_shapes(rows, v)
    parts_f32 = torch.empty(pf_shape, **f32)
    parts_i32 = torch.empty(pi_shape, dtype=torch.int32, device=dev)
    ldl = padded_ld(v)
    logits = torch.empty((rows, ldl), dtype=dtype, device=dev) if mode == "store" else None
    nll, lse = torch.empty((rows,), **f32), torch.empty((rows,), **f32)
    ids = torch.empty((rows,), dtype=torch.int32, device=dev)
    ptrs = (x2.data_ptr(), table_c.data_ptr(), bias.data_ptr(), targets.data_ptr(), rows, v, h,
            None if logits is None else logits.data_ptr(), ldl)
    outs = (parts_f32.data_ptr(), parts_i32.data_ptr(), nll.data_ptr(), lse.data_ptr(),
            ids.data_ptr())
    if dtype == torch.float32:
        _build.launch("kvq_head_ce_fwd_f32", [_VP] * 4 + [_I] * 3 + [_VP, _I] + [_VP] * 5,
                      *ptrs, *outs, device=dev)
        head_ce_fwd.f32_launches += 1
    else:
        _build.launch("kvq_head_ce_fwd", [_VP] * 4 + [_I] * 3 + [_VP, _I, _I] + [_VP] * 5 + [_I],
                      *ptrs, HEAD_TILE_N, *outs, sm_count(dev), device=dev)
    head_ce_fwd.launches += 1
    return nll, lse, ids, None if logits is None else logits[:, :v]


head_ce_fwd.launches = 0
head_ce_fwd.f32_launches = 0  # the share of ``launches`` on f32 operands


def head_ce_bwd(saved, table_c, bias, targets, lse, scale, mode: str):
    """#10: (g, dx, dbias) as :func:`head_ce_bwd_reference`; ``saved`` is the
    stored logits (``"store"``) or x (``"flash"``), in the table's dtype (bf16
    or f32). A CPU tensor takes the plain version; a CUDA tensor launches
    ``kvq_head_ce_bwd`` or ``kvq_head_ce_bwd_f32`` (g and the dbias
    partials, their sum, and the dx GEMM) or raises, and each call adds one
    to ``head_ce_bwd.launches`` (and an f32 one to
    ``head_ce_bwd.f32_launches``). Store mode takes the logits as
    :func:`head_ce_fwd` returns them (rows a multiple of 8 elements apart).
    ``g`` is a (rows, V) view of a buffer whose rows are :func:`padded_ld`
    wide, its pad columns 0."""
    _check_mode(mode)
    if saved.device.type == "cpu":
        return head_ce_bwd_reference(saved, table_c, bias, targets, lse, scale, mode)
    rows, dev, dtype = saved.shape[0], saved.device, _check_dtype(table_c)
    v, h = _check_head(table_c, bias, targets, rows, dev, dtype)
    x2 = saved if mode == "flash" else None
    logits = saved if mode == "store" else None
    if x2 is not None:
        _build.check_tensor("x", x2, (rows, h), dtype, dev)
        ldl = 0
    else:
        _check_logits(logits, rows, v, dev, dtype)
        ldl = logits.stride(0)
    for name, t in (("lse", lse), ("scale", scale)):
        _build.check_tensor(name, t, (rows,), torch.float32, dev)
    ldg, sms = padded_ld(v), sm_count(dev)
    g = torch.empty((rows, ldg), dtype=dtype, device=dev)
    dparts = torch.empty(dbias_partials_shape(rows, v), dtype=torch.float32, device=dev)
    dbias = torch.empty((v,), dtype=torch.float32, device=dev)
    dx = torch.empty((rows, h), dtype=dtype, device=dev)
    ptrs = (None if x2 is None else x2.data_ptr(), table_c.data_ptr(), bias.data_ptr(),
            None if logits is None else logits.data_ptr(), ldl, targets.data_ptr(),
            lse.data_ptr(), scale.data_ptr(), rows, v, h)
    outs = (g.data_ptr(), ldg, dparts.data_ptr(), dbias.data_ptr(), dx.data_ptr())
    if dtype == torch.float32:
        _build.launch("kvq_head_ce_bwd_f32", [_VP] * 4 + [_I] + [_VP] * 3 + [_I] * 3 + [_VP, _I]
                      + [_VP] * 3, *ptrs, *outs, device=dev)
        head_ce_bwd.f32_launches += 1
    else:
        plan = dx_plan(rows, h, v, sms)
        _build.launch("kvq_head_ce_bwd", [_VP] * 4 + [_I] + [_VP] * 3 + [_I] * 4 + [_VP, _I]
                      + [_VP] * 3 + [_I] * 3, *ptrs, HEAD_TILE_N, *outs, plan.tile_n,
                      plan.kchunk, sms, device=dev)
    head_ce_bwd.launches += 1
    return g[:, :v], dx, dbias


head_ce_bwd.launches = 0
head_ce_bwd.f32_launches = 0


def table_grad(g, x2) -> torch.Tensor:
    """``d_table = g^T @ x`` (V, H) in f32. A CPU tensor takes
    :func:`table_grad_reference`; a CUDA tensor launches the GEMM's TN
    split-K product (``kvq_head_ce_dtable``, or ``kvq_head_ce_dtable_f32``
    on f32 operands) over ``g`` as :func:`head_ce_bwd` returns it, or raises,
    and each call adds one to ``table_grad.launches`` (and an f32 one to
    ``table_grad.f32_launches``)."""
    if g.device.type == "cpu":
        return table_grad_reference(g, x2)
    rows, v = g.shape
    h = x2.shape[1]
    ldg = g.stride(0)
    if (g.dtype not in KERNEL_DTYPES or g.stride(1) != 1 or ldg % LD_ALIGN or ldg < v
            or g.data_ptr() % 16):
        raise ValueError("table_grad takes g as head_ce_bwd returns it: bf16 or f32 rows of a "
                         "width that is a multiple of 8, 16-byte aligned")
    _build.check_tensor("x", x2, (rows, h), g.dtype, g.device)
    f32, sms = g.dtype == torch.float32, sm_count(g.device)
    plan = dtable_plan(v, h, rows, sms, f32)
    out = torch.empty((v, h), dtype=torch.float32, device=g.device)
    ws = torch.empty((plan.splits, v, h), dtype=torch.float32, device=g.device)
    if f32:
        _build.launch("kvq_head_ce_dtable_f32", [_VP, _I, _VP] + [_I] * 3 + [_VP, _I, _I, _VP],
                      g.data_ptr(), ldg, x2.data_ptr(), rows, v, h, out.data_ptr(), plan.splits,
                      plan.kchunk, ws.data_ptr(), device=g.device)
        table_grad.f32_launches += 1
    else:
        _build.launch("kvq_head_ce_dtable", [_VP, _I, _VP] + [_I] * 3 + [_VP] + [_I] * 3
                      + [_VP, _I], g.data_ptr(), ldg, x2.data_ptr(), rows, v, h, out.data_ptr(),
                      plan.tile_n, plan.splits, plan.kchunk, ws.data_ptr(), sms, device=g.device)
    table_grad.launches += 1
    return out


table_grad.launches = 0
table_grad.f32_launches = 0


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
