"""Multi-head attention without dropout: kernel #13 and its plain version.

Counterpart of ``kindergarten_vq_vae_tpu/ops/attention_pallas.py``
(``fused_mha`` l.191-223, ``_mha_kernel`` l.65, ``_mha_reference``
l.173-188): q, k, v (B, S, H) to the context (B, S, H), with a (B, S)
key-validity mask or None and a causal flag. It differs from #11
(``ops/sdpa.py``) in two places: a masked or causal score is *replaced* by
``NEG_INF`` rather than having it added (so a fully masked row is uniform
over every key), and ``p = e * (1 / z)``. The kernel is ``kvq_mha_fwd`` of
``csrc/sdpa.cu``, the WHERE_MASK instance of ``csrc/attention.cuh``'s
attention kernel or, on f32 operands (JAX's parity dtype), of
``csrc/attention_f32.cuh``'s.

:func:`mha_reference` is ``_mha_reference`` with the kernel's rounding
points: f32 scores, the softmax in f32, p rounded to q's dtype before
``p @ v``, f32 sums (in f32 the same function as the JAX reference). The
backward is autograd through :func:`mha_reference` on the saved inputs, as
``_fused_mha_bwd`` (l.208-220) takes ``jax.vjp`` of ``_mha_reference``. No
model path calls :func:`fused_mha`, in the JAX package or here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from kindergarten_vq_vae_torch import _build
from kindergarten_vq_vae_torch.ops.layer import NEG_INF, SHORT_HEAD_DIM, _heads, _merge
from kindergarten_vq_vae_torch.ops.sdpa import _check_kernel_inputs

_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_VP, _I, _VP, _VP, _I, _VP, _VP, _I] + [_I] * 6


def mha_reference(q, k, v, mask, num_heads: int, causal: bool = False) -> torch.Tensor:
    """Plain version of #13: the context (B, S, H) in q's dtype."""
    b, s, H = q.shape
    scores = _heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2) / math.sqrt(
        H // num_heads)
    ok = torch.ones((b, 1, s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    if mask is not None:
        ok = ok & (mask[:, None, None, :] > 0)
    probs = torch.softmax(torch.where(ok, scores, NEG_INF), dim=-1).to(q.dtype)
    return _merge(probs.float() @ _heads(v, num_heads)).to(q.dtype)


def mha_forward(q, k, v, mask, num_heads: int, causal: bool = False) -> torch.Tensor:
    """#13, replacing ``_mha_kernel`` (``attention_pallas.py:65``). A CPU
    tensor takes :func:`mha_reference`; a CUDA tensor launches
    ``kvq_mha_fwd`` (bf16, or its f32 instance on f32 operands) or raises,
    adding one to ``mha_forward.launches`` (and an f32 one to
    ``mha_forward.f32_launches``)."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, mask, num_heads, causal)
    if q.device.type != "cuda":
        raise ValueError(f"mha_forward runs on CPU or CUDA tensors, got {q.device}")
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"mha_forward takes one sequence length, got {q.shape[1]} and "
                         f"{k.shape[1]}")
    _check_kernel_inputs(q, k, v, mask, num_heads, "mha_forward")
    b, s, H = q.shape
    f32 = q.dtype == torch.float32
    out = torch.empty((b, s, H), dtype=q.dtype, device=q.device)
    _build.launch("kvq_mha_fwd", _ARGS, q.data_ptr(), q.stride(1), k.data_ptr(), v.data_ptr(),
                  k.stride(1), None if mask is None else mask.data_ptr(), out.data_ptr(), H, b,
                  num_heads, H // num_heads, s, int(causal), int(f32), device=q.device)
    mha_forward.launches += 1
    mha_forward.f32_launches += int(f32)
    mha_forward.wide_launches += int(H // num_heads > SHORT_HEAD_DIM)
    return out


mha_forward.launches = 0
mha_forward.f32_launches = 0  # the share of ``launches`` on f32 operands
mha_forward.wide_launches = 0  # the share with head_dim past SHORT_HEAD_DIM


class FusedMha(torch.autograd.Function):
    """#13 forward; the backward differentiates :func:`mha_reference` on the
    saved inputs."""

    @staticmethod
    def forward(ctx, num_heads, causal, reference, mask, q, k, v):
        fwd = mha_reference if reference else mha_forward
        ctx.args = (num_heads, causal)
        ctx.save_for_backward(q, k, v, mask)
        return fwd(q, k, v, mask, num_heads, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = mha_reference(*leaves, mask, *ctx.args)
            grads = torch.autograd.grad(out, leaves, g)
        return (None,) * 4 + grads


def fused_mha(q, k, v, mask, num_heads: int, causal: bool = False,
              reference: bool = False) -> torch.Tensor:
    """Tiny-sequence MHA: q, k, v (B, S, H); mask (B, S) int32 or None.
    Under autograd it runs :class:`FusedMha`; otherwise :func:`mha_forward`,
    or :func:`mha_reference` with ``reference``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FusedMha.apply(num_heads, causal, reference, mask, q, k, v)
    return (mha_reference if reference else mha_forward)(q, k, v, mask, num_heads, causal)
