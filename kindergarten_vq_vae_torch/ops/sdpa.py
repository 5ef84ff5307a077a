"""Scaled-dot-product attention of the per-module trunk: kernels #11 / #12 and their plain versions.

Counterpart of ``kindergarten_vq_vae_tpu/ops/sdpa_pallas.py`` (``fused_sdpa``
l.299-331, ``_sdpa_fwd_kernel`` l.103, ``_sdpa_bwd_kernel`` l.142): q (B, S_q,
H), k and v (B, S_k, H) to the context (B, S_q, H) in q's dtype, with a
(B, S_k) key-validity mask or None, a causal flag and hash dropout on the
probabilities keyed on one int32 seed per call (op id = the head, as
``_dropout_keep_scale`` l.77 keys it). The kernels are ``kvq_sdpa_fwd`` /
``kvq_sdpa_bwd`` of ``csrc/sdpa.cu``, over the attention device code the
fused layer uses (``csrc/attention.cuh``) in bf16 and, on f32 operands
(JAX's parity dtype, in which ``_sdpa_fwd_kernel`` computes too), over its
f32 instance (``csrc/attention_f32.cuh``: 3xTF32 ``mma.sync``, the same
keep masks).

:func:`sdpa_forward_reference` and :func:`sdpa_backward_reference` are the
same functions in plain PyTorch, at the kernels' rounding points (those of
``ops/layer.py`` ``_attention`` / :func:`~kindergarten_vq_vae_torch.ops.layer.attention_grads`):
f32 scores, ``p = e / z``, the keep mask after it, p rounded to q's dtype
before ``p @ v``; in the backward, ds rounded before dq and dk.

:func:`fused_sdpa` is the entry the trunk calls. Under autograd it runs
:class:`FusedSdpa`, which saves q, k, v and the mask and recomputes the
probabilities in its backward, as ``_fused_sdpa_fwd`` / ``_fused_sdpa_bwd``
(l.316-328) do; gradients reach q, k and v only. The TPU's sentence tile
(``block_b``, the run config's ``sdpa_block_b``) has no counterpart.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from kindergarten_vq_vae_torch import _build
from kindergarten_vq_vae_torch.ops.dropout import keep_scale, keep_threshold, seed_u32
from kindergarten_vq_vae_torch.ops.layer import MAX_HEAD_DIM, MAX_SEQ, _attention, attention_grads

_VP, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_FWD_ARGS = [_VP, _I, _VP, _VP, _I, _VP, _VP, _I] + [_I] * 6 + [_U, _U, _F, _I]
_BWD_ARGS = [_VP, _I, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I] + [_I] * 6 + [_U, _U, _F, _I]
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def sdpa_forward_reference(q, k, v, mask, seed, num_heads: int, causal: bool = False,
                           rate: float = 0.0) -> torch.Tensor:
    """Plain version of #11: the context (B, S_q, H) in q's dtype."""
    return _attention(q, k, v, mask, causal, num_heads, seed or 0, 0, rate).to(q.dtype)


def sdpa_backward_reference(q, k, v, mask, seed, g, num_heads: int, causal: bool = False,
                            rate: float = 0.0):
    """Plain version of #12: (dq, dk, dv) in q's dtype."""
    return attention_grads(q, k, v, mask, g, num_heads, causal, seed or 0, 0, rate)


def _check_rate(rate: float, seed) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate must lie in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed (an int32)")


def _rows_even(t: torch.Tensor) -> bool:
    """``t`` (B, S, W) has evenly strided rows and unit column stride, as a
    contiguous tensor or a split view of a packed one does."""
    return t.stride(2) == 1 and t.stride(0) == t.shape[1] * t.stride(1)


def _check_kernel_inputs(q, k, v, mask, num_heads: int, what: str) -> None:
    """Raise unless the kernels can read q, k, v and the mask as given: all
    three bf16 or all three f32."""
    dev = q.device
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"{what}: q (B, S_q, H), k and v (B, S_k, H), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, H = q.shape
    sk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != H or b == 0:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k {tuple(k.shape)} do not pair")
    lengths_ok = 1 <= min(sq, sk) <= max(sq, sk) <= MAX_SEQ
    if H % num_heads or H // num_heads > MAX_HEAD_DIM or not lengths_ok:
        raise ValueError(f"{what} takes head_dim <= {MAX_HEAD_DIM} and sequences of 1..{MAX_SEQ}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected torch.bfloat16 or torch.float32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected q's {q.dtype}")
    if mask is not None:
        _build.check_tensor("mask", mask, (b, sk), torch.int32, dev)
    # the kernels read rows at a stride, and k and v at one stride
    if not all(_rows_even(t) for t in (q, k, v)) or k.stride() != v.stride():
        raise ValueError(f"{what} reads evenly strided rows (contiguous tensors or split views "
                         "of one packed tensor), with k and v at one stride")


def sdpa_forward(q, k, v, mask, seed, num_heads: int, causal: bool = False, rate: float = 0.0,
                 cross: bool = False) -> torch.Tensor:
    """#11, replacing ``_sdpa_fwd_kernel`` (``sdpa_pallas.py:103``). A CPU
    tensor takes :func:`sdpa_forward_reference`; a CUDA tensor launches
    ``kvq_sdpa_fwd`` (bf16, or its f32 instance on f32 operands) or raises.
    Each launch adds one to ``sdpa_forward.launches``, on f32 operands to
    ``sdpa_forward.f32_launches`` and, with ``cross`` (the trunk's
    cross-attention: shapes cannot tell it apart), to
    ``sdpa_forward.cross_launches``."""
    _check_rate(rate, seed)
    if q.device.type == "cpu":
        return sdpa_forward_reference(q, k, v, mask, seed, num_heads, causal, rate)
    if q.device.type != "cuda":
        raise ValueError(f"sdpa_forward runs on CPU or CUDA tensors, got {q.device}")
    _check_kernel_inputs(q, k, v, mask, num_heads, "sdpa_forward")
    b, sq, H = q.shape
    f32 = q.dtype == torch.float32
    out = torch.empty((b, sq, H), dtype=q.dtype, device=q.device)
    _build.launch("kvq_sdpa_fwd", _FWD_ARGS, q.data_ptr(), q.stride(1), k.data_ptr(),
                  v.data_ptr(), k.stride(1), None if mask is None else mask.data_ptr(),
                  out.data_ptr(), H, b, num_heads, H // num_heads, sq, k.shape[1], int(causal),
                  seed_u32(seed or 0), keep_threshold(rate), keep_scale(rate), int(f32),
                  device=q.device)
    sdpa_forward.launches += 1
    sdpa_forward.f32_launches += int(f32)
    sdpa_forward.cross_launches += int(cross)
    return out


sdpa_forward.launches = 0
sdpa_forward.f32_launches = 0  # the share of ``launches`` on f32 operands
sdpa_forward.cross_launches = 0  # the cross-attention share of ``launches``


def sdpa_backward(q, k, v, mask, seed, g, num_heads: int, causal: bool = False,
                  rate: float = 0.0, cross: bool = False):
    """#12, replacing ``_sdpa_bwd_kernel`` (``sdpa_pallas.py:142``):
    (dq, dk, dv) in q's dtype. A CPU tensor takes
    :func:`sdpa_backward_reference`; a CUDA tensor launches ``kvq_sdpa_bwd``
    (bf16, or its f32 instance) or raises, counted as :func:`sdpa_forward`
    counts."""
    _check_rate(rate, seed)
    if q.device.type == "cpu":
        return sdpa_backward_reference(q, k, v, mask, seed, g, num_heads, causal, rate)
    if q.device.type != "cuda":
        raise ValueError(f"sdpa_backward runs on CPU or CUDA tensors, got {q.device}")
    _check_kernel_inputs(q, k, v, mask, num_heads, "sdpa_backward")
    b, sq, H = q.shape
    sk = k.shape[1]
    g = g.contiguous()
    _build.check_tensor("g", g, (b, sq, H), q.dtype, q.device)
    f32 = q.dtype == torch.float32
    dq = torch.empty((b, sq, H), dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty((b, sk, H), dtype=q.dtype, device=q.device) for _ in range(2))
    _build.launch("kvq_sdpa_bwd", _BWD_ARGS, q.data_ptr(), q.stride(1), k.data_ptr(),
                  v.data_ptr(), k.stride(1), None if mask is None else mask.data_ptr(),
                  g.data_ptr(), dq.data_ptr(), H, dk.data_ptr(), dv.data_ptr(), H, b, num_heads,
                  H // num_heads, sq, sk, int(causal), seed_u32(seed or 0), keep_threshold(rate),
                  keep_scale(rate), int(f32), device=q.device)
    sdpa_backward.launches += 1
    sdpa_backward.f32_launches += int(f32)
    sdpa_backward.cross_launches += int(cross)
    return dq, dk, dv


sdpa_backward.launches = 0
sdpa_backward.f32_launches = 0
sdpa_backward.cross_launches = 0


class FusedSdpa(torch.autograd.Function):
    """#11 forward, #12 backward (or, with ``reference``, their plain
    versions on any device), recomputing the probabilities from the saved
    q, k, v."""

    @staticmethod
    def forward(ctx, num_heads, causal, rate, seed, reference, cross, mask, q, k, v):
        if reference:
            out = sdpa_forward_reference(q, k, v, mask, seed, num_heads, causal, rate)
        else:
            out = sdpa_forward(q, k, v, mask, seed, num_heads, causal, rate, cross)
        ctx.args = (num_heads, causal, rate, seed, reference, cross)
        ctx.save_for_backward(q, k, v, mask)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        num_heads, causal, rate, seed, reference, cross = ctx.args
        if reference:
            grads = sdpa_backward_reference(q, k, v, mask, seed, g, num_heads, causal, rate)
        else:
            grads = sdpa_backward(q, k, v, mask, seed, g, num_heads, causal, rate, cross)
        return (None,) * 7 + tuple(grads)


def fused_sdpa(q, k, v, mask, seed, num_heads: int, causal: bool = False, rate: float = 0.0,
               reference: bool = False, cross: bool = False) -> torch.Tensor:
    """Block-diagonal SDPA: q (B, S_q, H), k / v (B, S_k, H) -> (B, S_q, H).

    ``mask``: (B, S_k) int32 key validity or None (all valid); ``seed``: the
    int32 of the attention dropout (ignored at rate 0); ``cross``: count the
    launches as cross-attention. When a gradient is needed the call runs
    :class:`FusedSdpa`; otherwise the custom op ``kvq::sdpa_fwd``
    (:func:`sdpa_forward`), or the plain version with ``reference``."""
    _check_rate(rate, seed)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FusedSdpa.apply(num_heads, causal, rate, seed, reference, cross, mask, q, k, v)
    if reference:
        return sdpa_forward_reference(q, k, v, mask, seed, num_heads, causal, rate)
    return torch.ops.kvq.sdpa_fwd(q, k, v, mask, seed or 0, num_heads, causal, rate, cross)


# #11 as the custom op ``kvq::sdpa_fwd`` (``torch.export`` keeps it as one
# node): on CPU tensors the plain version, on CUDA tensors the kernel; the
# fake implementation gives the context's shape and dtype.
_OPS = torch.library.Library("kvq", "FRAGMENT")
_OPS.define("sdpa_fwd(Tensor q, Tensor k, Tensor v, Tensor? mask, int seed, int num_heads, "
            "bool causal, float rate, bool cross) -> Tensor")
_OPS.impl("sdpa_fwd", lambda q, k, v, mask, seed, nh, causal, rate, cross:
          sdpa_forward_reference(q, k, v, mask, seed, nh, causal, rate), "CPU")
_OPS.impl("sdpa_fwd", sdpa_forward, "CUDA")
torch.library.register_fake("kvq::sdpa_fwd", lambda q, *_: q.new_empty(q.shape), lib=_OPS)
