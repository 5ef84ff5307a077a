"""VQ bottleneck: the CUDA kernel's wrapper.

Counterpart of ``kindergarten_vq_vae_tpu/ops/vq_pallas.py``
``fused_vector_quantize`` (l.187). The kernel (``csrc/vq_fwd.cu``) returns
the straight-through ``z_q`` (``z + (codebook[idx] - z)``, the bits of the
plain version's eager expression), indices, per-code counts and sums, and
the sum of ``(z_q - z)^2``; the loss, perplexity, :class:`VQOutput` and the
gradient (:class:`~kindergarten_vq_vae_torch.ops.vq.VQCore`, plain PyTorch
as in JAX) are shared with the plain version
:func:`kindergarten_vq_vae_torch.ops.vq.vector_quantize`. Under a device mesh
with dp ranks both take the data-parallel form of ``assemble``
(``fused_vector_quantize_sharded``): ``z`` is the rank's rows and the
statistics are summed over dp.

Past the one-pass kernel (a codebook past ~37 codes at D 768, or D above
1,024) the kernel takes its general path: the distances' products on the
3xTF32 GEMM, a screen that keeps every code that may be the minimum and a
recheck of those in the one-pass order's f32 sums (the same codes, bit for
bit, as the CUDA-core path it replaced), and the per-code sums over the
rows grouped by code. The raw forward returns that grouping beside its
outputs, and ``VQCore`` keeps it on ``ctx`` for the backward's codebook
gradient.
"""

from __future__ import annotations

import ctypes

import torch

from kindergarten_vq_vae_torch import _build
from kindergarten_vq_vae_torch.ops.vq import VQOutput, assemble, vq_raw

_VP, _I = ctypes.c_void_p, ctypes.c_int
_plans: dict[tuple[int, int, int], tuple[int, ...] | None] = {}


def vq_plan(rows: int, d: int, n_e: int) -> tuple[int, ...] | None:
    """The kernel's launch plan for a shape, from ``kvq_vq_plan`` (cached):
    ``(warps a block, rows a block, blocks, partial width, prep floats)``, or
    None for an empty shape. ``warps`` is 0 on the general path, which takes
    a codebook whose per-code sums do not fit in shared memory beside it
    (above ~37 codes at D = 768) or ``D > 1024``: its distances screened on
    the tensor cores and the codes that may be the minimum rechecked in the
    one-pass order's f32 sums, the per-code sums over the rows grouped by
    code (``csrc/vq_fwd.cu``); its blocks are 0 and its prep floats its
    whole scratch."""
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
    ``(z_q, indices, counts, sum_z, diff, group)``, ``z_q`` already the
    straight-through value; ``counts``, ``sum_z`` and ``diff`` are views of
    one stats buffer; ``group`` the general path's grouping of the rows by
    code (for the codebook gradient), else None."""
    zq, idx, stats, group = torch.ops.kvq.vq_fwd(z, codebook)
    return (*_split(zq, idx, stats, *codebook.shape), group if group.numel() else None)


_raw_op.returns_ste = True  # z_q is z + (z_q - z) already


def _launch_packed(z: torch.Tensor, codebook: torch.Tensor):
    """``(z_q, indices, stats, group)``: ``stats`` holds ``sum_z`` (n_e * D),
    the counts (n_e) and ``diff`` (1), in that order; ``group`` (int32) is
    the general path's grouping of the rows by code, which
    ``codebook_grad`` takes as it is (empty on the one-pass path)."""
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
        raise ValueError(f"the VQ kernel takes at least one row, column and code; got rows={m}, "
                         f"D={d}, n_e={n_e}")
    warps, _, blocks, width, prep = plan
    if warps == 0 and d % 4 == 0 and z.data_ptr() % 16:
        z = z.clone()  # the general path's GEMM reads 16-byte aligned rows

    dev = z.device
    zq = torch.empty((m, d), dtype=torch.float32, device=dev)
    idx = torch.empty((m,), dtype=torch.int64, device=dev)
    ws = torch.empty((prep + blocks * width,), dtype=torch.float32, device=dev)
    stats = torch.empty((width,), dtype=torch.float32, device=dev)
    group = torch.empty((_group_ints(m, d, n_e),), dtype=torch.int32, device=dev)
    _build.launch("kvq_vq_fwd", [_VP] * 7 + [_I] * 3, z.data_ptr(), codebook.data_ptr(),
                  zq.data_ptr(), idx.data_ptr(), ws.data_ptr(), stats.data_ptr(),
                  group.data_ptr() if group.numel() else None, m, d, n_e, device=dev)
    vector_quantize_kernel.launches += 1
    return zq, idx, stats[:n_e * d + n_e + 1], group


def _group_ints(m: int, d: int, n_e: int) -> int:
    """The ints of the grouping that the raw forward of (m, D) rows by n_e
    codes returns: ``vq_group_ints`` on the general path, else 0."""
    plan = vq_plan(m, d, n_e) if m > 0 and n_e > 0 else None
    return vq_group_ints(m, d, n_e) if plan is not None and plan[0] == 0 else 0


def vq_group_ints(rows: int, d: int, n_e: int) -> int:
    """The ints of the general path's grouping of (rows, D) by n_e codes
    (``kvq_vq_group_ints``)."""
    fn = _build.lib().kvq_vq_group_ints
    fn.argtypes, fn.restype = [_I, _I, _I], _I
    return int(fn(rows, d, n_e))


def vq_screen_kappa(d: int) -> float:
    """The card's kappa of the general path's screen at width ``d``
    (``kvq_vq_screen_kappa``; :func:`~kindergarten_vq_vae_torch.ops.vq.screen_kappa`
    is its plain version)."""
    fn = _build.lib().kvq_vq_screen_kappa
    fn.argtypes, fn.restype = [_I], ctypes.c_float
    return float(fn(d))


def vq_general_screen(z: torch.Tensor, codebook: torch.Tensor):
    """The general path on CUDA tensors ``z`` (rows, D) and ``codebook``
    (n_e, D), f32, with what its screen saw (``kvq_vq_fwd_screen``): ``(z_q,
    indices, stats, cross, rechecked)``, ``cross`` (rows, n_e) the
    tensor-core products (z - c) . (e_k - c) and ``rechecked`` (rows,) int32
    the codes each row summed exactly (n_e: every code). For the card's
    checks: it does not count as a launch of ``vector_quantize_kernel``.
    Raises where the shape takes the one-pass kernel."""
    (m, d), n_e = z.shape, codebook.shape[0]
    plan = vq_plan(m, d, n_e)
    if plan is None or plan[0] != 0:
        raise ValueError(f"({m}, {d}) x {n_e} takes the one-pass kernel, not the general path")
    _, _, _, width, prep = plan
    dev, n_pad = z.device, (n_e + 3) // 4 * 4
    zq = torch.empty((m, d), dtype=torch.float32, device=dev)
    idx = torch.empty((m,), dtype=torch.int64, device=dev)
    ws = torch.empty((prep,), dtype=torch.float32, device=dev)
    stats = torch.empty((width,), dtype=torch.float32, device=dev)
    cross = torch.empty((m, n_pad), dtype=torch.float32, device=dev)
    rechecked = torch.empty((m,), dtype=torch.int32, device=dev)
    _build.launch("kvq_vq_fwd_screen", [_VP] * 8 + [_I] * 3, z.data_ptr(), codebook.data_ptr(),
                  zq.data_ptr(), idx.data_ptr(), ws.data_ptr(), stats.data_ptr(),
                  cross.data_ptr(), rechecked.data_ptr(), m, d, n_e, device=dev)
    return zq, idx, stats[:n_e * d + n_e + 1], cross[:, :n_e], rechecked


def _vq_fwd_cpu(z, codebook):
    zq, idx, counts, sum_z, diff = vq_raw(z, codebook)
    return (z + (zq - z), idx, torch.cat([sum_z.reshape(-1), counts, diff.reshape(1)]),
            z.new_empty((0,), dtype=torch.int32))


# The raw forward as the custom op ``kvq::vq_fwd`` (``torch.export`` keeps
# it as one node; ``assemble``'s eager ops stay around it): on CPU tensors
# the plain version with the straight-through value, on CUDA tensors the
# kernel; the fake implementation gives the shapes and dtypes. Its last
# output is the general path's grouping of the rows (empty on the CPU and on
# the one-pass path).
_OPS = torch.library.Library("kvq", "FRAGMENT")
_OPS.define("vq_fwd(Tensor z, Tensor codebook) -> (Tensor, Tensor, Tensor, Tensor)")
_OPS.impl("vq_fwd", _vq_fwd_cpu, "CPU")
_OPS.impl("vq_fwd", _launch_packed, "CUDA")
torch.library.register_fake(
    "kvq::vq_fwd",
    lambda z, cb: (z.new_empty(z.shape), z.new_empty(z.shape[:1], dtype=torch.int64),
                   z.new_empty((cb.shape[0] * (cb.shape[1] + 1) + 1,)),
                   z.new_empty((_group_ints(z.shape[0], z.shape[1], cb.shape[0])
                                if z.device.type == "cuda" else 0,), dtype=torch.int32)),
    lib=_OPS)
