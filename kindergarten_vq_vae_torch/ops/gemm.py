"""The layer GEMM: ``C = epi(op(A) @ op(B))``, the CUDA kernel's wrapper and its plain version.

Every projection of the fused BertLayer goes through it (``ops/layer.py``):
the forward's ``A @ W + b`` (NN, inside ``kvq_bert_layer_fwd``), the data
gradients ``dY @ W^T`` (NT) and the weight gradients ``X^T @ dY`` (TN). The
JAX package writes them as ``_mm`` / ``_mm_nt`` / ``_mm_tn`` with the GELU
of ``_gelu_fwd`` / ``_gelu_grad`` (``kindergarten_vq_vae_tpu/ops/
layer_pallas.py:121-139, 214-221``), inside TPU kernels #1 and #2. The
kernel is ``csrc/gemm_sm90.cuh`` (wgmma + TMA, ``sm_90a``);
:func:`gemm_reference` is the same function in plain PyTorch at the same
rounding points: bf16 operands, f32 products and sums, then the epilogue:

- ``f32`` / ``bf16``: the sum (plus ``bias``), stored in that dtype;
- ``gelu_erf`` / ``gelu_tanh``: bf16 ``gelu(sum + bias)``, and with
  ``out2`` the pre-GELU ``u`` in bf16;
- ``add_f32`` / ``add_bf16``: ``sum + aux`` (aux f32);
- ``dgelu_erf`` / ``dgelu_tanh``: ``du = sum * gelu'(aux)`` (aux the bf16
  ``u``) in bf16, with ``out2`` also in f32, and with ``colsum`` the f32
  du's column sums (the layer's b1 gradient): the kernel sums each 128-row
  tile's du in its epilogue, in a fixed order, and the tiles' partials in
  another (so the f32 du need not be written).

The weight gradients (``a_t``) sum over all rows in f32, in chunks of rows
whose partial products are added in a fixed order, and round once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from kindergarten_vq_vae_torch import _build

SQRT_2 = math.sqrt(2.0)
TANH_C = math.sqrt(2.0 / math.pi)
_ERF_P = (1.1283797055e+00, 1.0276548145e-01, -1.8438367938e-04,
          -6.2571958331e-04, 8.9712590414e-05, -5.9856910908e-06,
          1.5896024415e-07)

# the kernel's tile (csrc/gemm_sm90.cuh TILE_M, TILE_K)
TILE_M, TILE_K = 128, 64
# epilogues whose arithmetic or aux traffic outlasts a 192-wide tile's
# products: 128-wide tiles, behind two epilogue warpgroups (measured on an
# H100, PERF.md)
HEAVY_EPIS = ("gelu_erf", "gelu_tanh", "add_f32", "add_bf16", "dgelu_erf", "dgelu_tanh")
MAX_SPLITS = 16
# the plan's model of the card: the bf16 tensor-core rate of one SM and the
# memory rate (H100 SXM, dense), for the split-K partials' round trip
_SM_FLOPS = 989e12 / 132
_HBM_BYTES_PER_S = 3.35e12

_EPI = {"f32": 0, "bf16": 1, "gelu_erf": 2, "gelu_tanh": 3, "add_f32": 4, "add_bf16": 5,
        "dgelu_erf": 6, "dgelu_tanh": 7}
_OUT_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16, "gelu_erf": torch.bfloat16,
              "gelu_tanh": torch.bfloat16, "add_f32": torch.float32, "add_bf16": torch.bfloat16,
              "dgelu_erf": torch.bfloat16, "dgelu_tanh": torch.bfloat16}
# the epilogues of each layout: NN (the forward), NT (data gradients), TN (weight gradients)
_LAYOUT_EPIS = {(False, False): ("f32", "bf16", "gelu_erf", "gelu_tanh"),
                (False, True): ("f32", "bf16", "add_f32", "add_bf16", "dgelu_erf", "dgelu_tanh"),
                (True, False): ("f32", "bf16")}


def _erf_p(z2):
    acc = torch.full_like(z2, _ERF_P[-1])
    for c in _ERF_P[-2::-1]:
        acc = acc * z2 + c
    return acc


def _erf_dp(z2):
    """p'(z) as a polynomial in z^2 (``_erf_dp`` l.202)."""
    acc = torch.full_like(z2, 13.0 * _ERF_P[-1])
    for d, c in zip((11, 9, 7, 5, 3, 1), _ERF_P[-2::-1]):
        acc = acc * z2 + d * c
    return acc


def gelu(u: torch.Tensor, exact: bool) -> torch.Tensor:
    """f32 GELU as the kernel computes it (tanh-erf polynomial when exact)."""
    if exact:
        z = u / SQRT_2
        return 0.5 * u * (1.0 + torch.tanh(z * _erf_p(z * z)))
    w = TANH_C * (u + 0.044715 * u * u * u)
    return 0.5 * u * (1.0 + torch.tanh(w))


def gelu_grad(u: torch.Tensor, exact: bool) -> torch.Tensor:
    """d gelu / du of the form :func:`gelu` computes (``_gelu_grad`` l.221)."""
    if exact:
        z = u * (1.0 / SQRT_2)
        z2 = z * z
        t = torch.tanh(z * _erf_p(z2))
        return 0.5 * (1.0 + t) + (0.5 / SQRT_2) * u * (1.0 - t * t) * _erf_dp(z2)
    w = TANH_C * (u + 0.044715 * u * u * u)
    t = torch.tanh(w)
    return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * TANH_C * (1.0 + 3.0 * 0.044715 * u * u)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How the kernel cuts one product: ``tile_n``-wide output tiles, and K
    in ``splits`` chunks of ``kchunk`` (a multiple of :data:`TILE_K`)."""

    tile_n: int
    splits: int
    kchunk: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def tile_widths(split_k: bool, epi: str) -> tuple[int, ...]:
    """The kernel's tile widths for a product: the weight gradients' split-K
    partials 256 or 192, a heavy epilogue 128, any other 192."""
    return (256, 192) if split_k else (128,) if epi in HEAVY_EPIS else (192,)


@functools.lru_cache(maxsize=1024)
def gemm_plan(M: int, N: int, K: int, split_k: bool, sms: int, epi: str = "f32") -> GemmPlan:
    """The tile width and, for a weight gradient (``split_k``), the split of
    K that the kernel's persistent grid of ``sms`` CTAs finishes soonest:
    whole waves of 128 x ``tile_n`` x ``kchunk`` units at the tensor-core rate,
    plus the f32 partials' write and read. Ties go to the wider tile and to
    fewer splits."""
    if min(M, N, K, sms) < 1:
        raise ValueError(f"gemm_plan needs positive sizes, got M={M} N={N} K={K} sms={sms}")
    best, best_t = None, math.inf
    for tile_n in tile_widths(split_k, epi):
        tiles = _ceil(M, TILE_M) * _ceil(N, tile_n)
        for splits in range(1, (MAX_SPLITS if split_k else 1) + 1):
            kchunk = _ceil(_ceil(K, splits), TILE_K) * TILE_K
            if _ceil(K, kchunk) != splits:
                continue  # the same chunks as fewer splits
            t = _ceil(tiles * splits, sms) * 2 * TILE_M * tile_n * kchunk / _SM_FLOPS
            if split_k:
                t += 2 * splits * M * N * 4 / _HBM_BYTES_PER_S
            if t < best_t:
                best, best_t = GemmPlan(tile_n, splits, kchunk), t
    return best


_SMS: dict[int, int] = {}


def sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors (the GEMM's grid cap)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _shape(a, b, a_t: bool, b_t: bool) -> tuple[int, int, int]:
    M = a.shape[1] if a_t else a.shape[0]
    K = a.shape[0] if a_t else a.shape[1]
    N = b.shape[0] if b_t else b.shape[1]
    if (b.shape[1] if b_t else b.shape[0]) != K:
        raise ValueError(f"inner dimensions differ: op(A) {(M, K)}, B {tuple(b.shape)} "
                         f"(a_t={a_t}, b_t={b_t})")
    return M, N, K


def gemm_reference(a, b, *, a_t: bool = False, b_t: bool = False, epi: str = "f32", bias=None,
                   aux=None, out2: bool = False, colsum: bool = False):
    """Plain version of :func:`gemm`: A (M, K) or, with ``a_t``, (K, M); B
    (K, N) or, with ``b_t``, (N, K); f32 products and sums, then the epilogue
    (module docstring). Returns C, or the tuple of C, C2 (``out2``) and the
    f32 du's column sums (``colsum``, dgelu epilogues only)."""
    if colsum and not epi.startswith("dgelu"):
        raise ValueError(f"colsum is the column sum of the f32 du; epilogue {epi!r} has none")
    M, N, K = _shape(a, b, a_t, b_t)
    acc = (a.float().T if a_t else a.float()) @ (b.float().T if b_t else b.float())
    if bias is not None:
        acc = acc + bias.float()
    if epi in ("f32", "bf16"):
        return acc.to(_OUT_DTYPE[epi])
    if epi.startswith("gelu"):
        m = gelu(acc, epi == "gelu_erf").to(torch.bfloat16)
        return (m, acc.to(torch.bfloat16)) if out2 else m
    if epi.startswith("add"):
        return (acc + aux.float()).to(_OUT_DTYPE[epi])
    if epi.startswith("dgelu"):
        du = acc * gelu_grad(aux.float(), epi == "dgelu_erf")
        outs = (du.to(torch.bfloat16),) + ((du,) if out2 else ()) + ((du.sum(0),) if colsum else ())
        return outs if len(outs) > 1 else outs[0]
    raise ValueError(f"unknown epilogue {epi!r}")


def _check(name, t, shape, dtype, dev):
    _build.check_tensor(name, t, shape, dtype, dev)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (paired stores and TMA)")


_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_int] * 7
             + [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
             + [ctypes.c_void_p] * 2)


def gemm(a, b, *, a_t: bool = False, b_t: bool = False, epi: str = "f32", bias=None, aux=None,
         out2: bool = False, colsum: bool = False):
    """C (M, N) = epi(op(A) @ op(B) [+ bias]), the contract of
    :func:`gemm_reference`. Layouts: NN (neither; epilogues f32, bf16,
    gelu_*, with an optional f32 bias (N,)), NT (``b_t``; f32, bf16, add_*,
    dgelu_*, these with ``colsum`` too) and TN (``a_t``, the weight
    gradients; f32, bf16). A CPU tensor
    takes the plain version; a CUDA tensor launches ``csrc/gemm_sm90.cuh``
    (bf16 operands, contiguous, widths multiples of 8) or raises, and each
    call adds one to ``gemm.launches``. The layer forward's C sequence
    launches the same kernel for its products: ``ops/layer.py`` adds those
    to ``gemm.launches`` and to ``gemm.forward_launches``."""
    if a.device.type == "cpu":
        return gemm_reference(a, b, a_t=a_t, b_t=b_t, epi=epi, bias=bias, aux=aux, out2=out2,
                              colsum=colsum)
    if a.device.type != "cuda":
        raise ValueError(f"gemm runs on CPU or CUDA tensors, got {a.device}")
    if epi not in _LAYOUT_EPIS.get((a_t, b_t), ()):
        raise ValueError(f"the GEMM kernel has no epilogue {epi!r} for a_t={a_t}, b_t={b_t}")
    if out2 and not epi.startswith(("gelu", "dgelu")):
        raise ValueError(f"out2 is the pre-GELU u or the f32 du; epilogue {epi!r} has none")
    if colsum and not epi.startswith("dgelu"):
        raise ValueError(f"colsum is the column sum of the f32 du; epilogue {epi!r} has none")
    if bias is not None and (a_t or b_t):
        raise ValueError("only the forward's layout (NN) adds a bias")
    dev = a.device
    M, N, K = _shape(a, b, a_t, b_t)
    if a.shape[1] % 8 or b.shape[1] % 8 or N % 8:
        raise ValueError(f"the GEMM kernel needs rows of a multiple of 8 elements, got A "
                         f"{tuple(a.shape)}, B {tuple(b.shape)}")
    _check("a", a, a.shape, torch.bfloat16, dev)
    _check("b", b, b.shape, torch.bfloat16, dev)
    if bias is not None:
        _build.check_tensor("bias", bias, (N,), torch.float32, dev)
    aux_dtype = {"add": torch.float32, "dgelu": torch.bfloat16}.get(epi.split("_")[0])
    if aux_dtype is None and aux is not None:
        raise ValueError(f"epilogue {epi!r} reads no aux")
    if aux_dtype is not None:
        if aux is None:
            raise ValueError(f"epilogue {epi!r} needs aux")
        _check("aux", aux, (M, N), aux_dtype, dev)
    plan = gemm_plan(M, N, K, a_t, sm_count(dev), epi)
    c = torch.empty((M, N), dtype=_OUT_DTYPE[epi], device=dev)
    c2 = None
    if out2:
        c2 = torch.empty((M, N), dtype=torch.bfloat16 if epi.startswith("gelu") else torch.float32,
                         device=dev)
    ws = torch.empty((plan.splits, M, N), dtype=torch.float32, device=dev) if a_t else None
    parts = sums = None
    if colsum:  # one partial row per 128-row tile
        parts = torch.empty((_ceil(M, TILE_M), N), dtype=torch.float32, device=dev)
        sums = torch.empty((N,), dtype=torch.float32, device=dev)
    _build.launch("kvq_gemm_sm90", _ARGTYPES, int(a_t), int(b_t), a.data_ptr(), a.shape[1],
                  b.data_ptr(), b.shape[1], M, N, K, _EPI[epi], plan.tile_n, plan.splits,
                  plan.kchunk, c.data_ptr(), N, None if c2 is None else c2.data_ptr(), N,
                  None if aux is None else aux.data_ptr(), N,
                  None if bias is None else bias.data_ptr(),
                  None if ws is None else ws.data_ptr(), sm_count(dev),
                  None if parts is None else parts.data_ptr(),
                  None if sums is None else sums.data_ptr(), device=dev)
    gemm.launches += 1
    outs = (c,) + ((c2,) if out2 else ()) + ((sums,) if colsum else ())
    return outs if len(outs) > 1 else c


gemm.launches = 0
gemm.forward_launches = 0  # the share of ``launches`` made inside layer forwards
