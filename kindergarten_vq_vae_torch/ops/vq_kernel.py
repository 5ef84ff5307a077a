"""VQ bottleneck: the CUDA kernel's wrapper.

Counterpart of ``kindergarten_vq_vae_tpu/ops/vq_pallas.py``
``fused_vector_quantize`` (l.187). The kernel (``csrc/vq_fwd.cu``) returns
the raw ``z_q``, indices, per-code counts and sums, and the sum of
``(z_q - z)^2``; the loss, perplexity, :class:`VQOutput` and the gradient
(:class:`~kindergarten_vq_vae_torch.ops.vq.VQCore`, plain PyTorch as in JAX)
are shared with the plain version
:func:`kindergarten_vq_vae_torch.ops.vq.vector_quantize`.
"""

from __future__ import annotations

import ctypes

import torch

from kindergarten_vq_vae_torch import _build
from kindergarten_vq_vae_torch.ops.vq import VQOutput, assemble, vq_raw

MAX_DIM = 1024          # csrc/vq_fwd.cu holds a row in 32 registers per lane
MAX_SMEM = 232_448      # dynamic shared memory a Hopper block may use

_VP = ctypes.c_void_p


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
    """Raw forward of (rows, D) ``z`` on the card: ``(z_q, indices, counts, sum_z, diff)``."""
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
    lib = _build.lib()
    lib.kvq_vq_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.kvq_vq_smem_bytes.restype = ctypes.c_size_t
    if m == 0 or n_e == 0 or d > MAX_DIM or lib.kvq_vq_smem_bytes(d, n_e) > MAX_SMEM:
        raise ValueError(f"the VQ kernel takes 1 <= rows, D <= {MAX_DIM} and a codebook "
                         f"that fits shared memory twice; got rows={m}, D={d}, n_e={n_e}")
    lib.kvq_vq_rows_per_block.restype = ctypes.c_int
    nblk = -(-m // lib.kvq_vq_rows_per_block())

    dev = z.device
    zq = torch.empty((m, d), dtype=torch.float32, device=dev)
    idx = torch.empty((m,), dtype=torch.int64, device=dev)
    part_counts = torch.empty((nblk, n_e), dtype=torch.float32, device=dev)
    part_sumz = torch.empty((nblk, n_e, d), dtype=torch.float32, device=dev)
    part_diff = torch.empty((nblk,), dtype=torch.float32, device=dev)
    counts = torch.empty((n_e,), dtype=torch.float32, device=dev)
    sumz = torch.empty((n_e, d), dtype=torch.float32, device=dev)
    diff = torch.empty((), dtype=torch.float32, device=dev)

    fn = lib.kvq_vq_fwd
    fn.argtypes = [_VP] * 10 + [ctypes.c_int] * 3 + [_VP]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):  # the library's runtime launches on the current device
        code = fn(z.data_ptr(), codebook.data_ptr(), zq.data_ptr(), idx.data_ptr(),
                  part_counts.data_ptr(), part_sumz.data_ptr(), part_diff.data_ptr(),
                  counts.data_ptr(), sumz.data_ptr(), diff.data_ptr(), m, d, n_e,
                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "kvq_vq_fwd")
    vector_quantize_kernel.launches += 1
    return zq, idx, counts, sumz, diff
