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
    to ``vector_quantize_kernel.launches``."""
    if z.device.type == "cpu":
        return assemble(z, codebook, beta, vq_raw)
    if z.device.type != "cuda":
        raise ValueError(f"vector_quantize_kernel runs on CPU or CUDA tensors, got {z.device}")
    return assemble(z, codebook, beta, _launch)


vector_quantize_kernel.launches = 0


def _launch(z: torch.Tensor, codebook: torch.Tensor):
    """Raw forward of (rows, D) ``z`` on the card: ``(z_q, indices, counts,
    sum_z, diff)``, ``z_q`` already the straight-through value; ``counts``,
    ``sum_z`` and ``diff`` are views of one stats buffer."""
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
    ned = n_e * d
    return zq, idx, stats[ned:ned + n_e], stats[:ned].view(n_e, d), stats[ned + n_e]


_launch.returns_ste = True  # z_q is z + (z_q - z) already: assemble adds nothing
