"""VQ bottleneck: the CUDA kernel's wrapper.

Counterpart of ``kindergarten_vq_vae_tpu/ops/vq_pallas.py``
``fused_vector_quantize`` (l.187). The kernel (``csrc/vq_fwd.cu``) returns
the straight-through ``z_q`` (``z + (codebook[idx] - z)``, the bits of the
plain version's eager expression), indices, per-code counts and sums, and
the sum of ``(z_q - z)^2``; the loss, perplexity, :class:`VQOutput` and the
gradient (:class:`~kindergarten_vq_vae_torch.ops.vq.VQCore`, plain PyTorch
as in JAX) are shared with the plain version
:func:`kindergarten_vq_vae_torch.ops.vq.vector_quantize`.
"""

from __future__ import annotations

import ctypes

import torch

from kindergarten_vq_vae_torch import _build
from kindergarten_vq_vae_torch.ops.vq import VQOutput, assemble, vq_raw

MAX_DIM = 1024          # csrc/vq_fwd.cu holds a row in 32 registers a lane

_VP, _I = ctypes.c_void_p, ctypes.c_int
_plans: dict[tuple[int, int, int], tuple[int, ...] | None] = {}


def vq_plan(rows: int, d: int, n_e: int) -> tuple[int, ...] | None:
    """The kernel's launch plan for a shape, from ``kvq_vq_plan`` (cached):
    ``(warps a block, rows a block, blocks, partial width, prep floats)``, or
    None for a shape it does not take (``D > 1024``, or a codebook whose
    per-code sums do not fit in shared memory beside it)."""
    key = (rows, d, n_e)
    if key not in _plans:
        fn = _build.lib().kvq_vq_plan
        fn.argtypes, fn.restype = [_I, _I, _I, ctypes.POINTER(_I)], _I
        out = (_I * 5)()
        _plans[key] = tuple(out) if fn(rows, d, n_e, out) == 0 else None
    return _plans[key]


def vector_quantize_kernel(z: torch.Tensor, codebook: torch.Tensor, beta: float) -> VQOutput:
    """Quantize ``z`` (B, S, D) f32 against ``codebook`` (n_e, D) f32;
    gradients flow to both through the JAX package's custom VJP.

    A CPU tensor takes the plain raw forward. A CUDA tensor launches
    ``csrc/vq_fwd.cu`` on the current stream, or raises; each launch adds one
    to ``vector_quantize_kernel.launches``. The raw forward is the custom op
    ``kvq::vq_fwd`` on either device, with or without a gradient (the
    gradient is ``VQCore``'s, around it)."""
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vector_quantize_kernel runs on CPU or CUDA tensors, got {z.device}")
    return assemble(z, codebook, beta, _raw_op)


vector_quantize_kernel.launches = 0


def _split(zq, idx, stats, n_e: int, d: int):
    """``(z_q, indices, counts, sum_z, diff)`` with the last three views of ``stats``."""
    ned = n_e * d
    return zq, idx, stats[ned:ned + n_e], stats[:ned].view(n_e, d), stats[ned + n_e]


def _raw_op(z: torch.Tensor, codebook: torch.Tensor):
    """Raw forward of (rows, D) ``z`` through the custom op ``kvq::vq_fwd``:
    ``(z_q, indices, counts, sum_z, diff)``, ``z_q`` already the
    straight-through value; ``counts``, ``sum_z`` and ``diff`` are views of
    one stats buffer."""
    return _split(*torch.ops.kvq.vq_fwd(z, codebook), *codebook.shape)


_raw_op.returns_ste = True  # z_q is z + (z_q - z) already


def _launch_packed(z: torch.Tensor, codebook: torch.Tensor):
    """``(z_q, indices, stats)``: ``stats`` holds ``sum_z`` (n_e * D), the
    counts (n_e) and ``diff`` (1), in that order."""
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[-1] != codebook.shape[1]:
        raise ValueError(f"z (rows, D) and codebook (n_e, D) expected, got "
                         f"{tuple(z.shape)} and {tuple(codebook.shape)}")
    for name, t in (("z", z), ("codebook", codebook)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, expected {z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, d = z.shape
    n_e = codebook.shape[0]
    plan = vq_plan(m, d, n_e) if m > 0 and n_e > 0 else None
    if plan is None:
        raise ValueError(f"the VQ kernel takes 1 <= rows, D <= {MAX_DIM} and a codebook whose "
                         f"per-code sums fit in shared memory beside it; got rows={m}, D={d}, "
                         f"n_e={n_e}")
    _, _, blocks, width, prep = plan

    dev = z.device
    zq = torch.empty((m, d), dtype=torch.float32, device=dev)
    idx = torch.empty((m,), dtype=torch.int64, device=dev)
    ws = torch.empty((prep + blocks * width,), dtype=torch.float32, device=dev)
    stats = torch.empty((width,), dtype=torch.float32, device=dev)
    _build.launch("kvq_vq_fwd", [_VP] * 6 + [_I] * 3, z.data_ptr(), codebook.data_ptr(),
                  zq.data_ptr(), idx.data_ptr(), ws.data_ptr(), stats.data_ptr(), m, d, n_e,
                  device=dev)
    vector_quantize_kernel.launches += 1
    return zq, idx, stats[:n_e * d + n_e + 1]


def _vq_fwd_cpu(z, codebook):
    zq, idx, counts, sum_z, diff = vq_raw(z, codebook)
    return z + (zq - z), idx, torch.cat([sum_z.reshape(-1), counts, diff.reshape(1)])


# The raw forward as the custom op ``kvq::vq_fwd`` (``torch.export`` keeps
# it as one node; ``assemble``'s eager ops stay around it): on CPU tensors
# the plain version with the straight-through value, on CUDA tensors the
# kernel; the fake implementation gives the shapes and dtypes.
_OPS = torch.library.Library("kvq", "FRAGMENT")
_OPS.define("vq_fwd(Tensor z, Tensor codebook) -> (Tensor, Tensor, Tensor)")
_OPS.impl("vq_fwd", _vq_fwd_cpu, "CPU")
_OPS.impl("vq_fwd", _launch_packed, "CUDA")
torch.library.register_fake(
    "kvq::vq_fwd",
    lambda z, cb: (z.new_empty(z.shape), z.new_empty(z.shape[:1], dtype=torch.int64),
                   z.new_empty((cb.shape[0] * (cb.shape[1] + 1) + 1,))),
    lib=_OPS)
