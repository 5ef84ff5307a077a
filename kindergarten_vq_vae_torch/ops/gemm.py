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

f32 operands (an f32 run: JAX's parity dtype, in which ``_mm`` and its
kin run too) take the f32 instance, ``csrc/gemm_f32.cu``: 3xTF32 products on
wgmma (each operand split into a TF32 high part and its remainder, three TF32
products summed in f32: within a few 1e-7 of an f32 product; single-pass
TF32 would miss the f32 bars by far) with the same epilogues, every output
f32 (``f32``, ``gelu_*`` with the f32 u, ``add_f32``, ``dgelu_*`` with
``colsum``). The GELU and GELU-gradient outputs are in the operands' dtype,
here and in :func:`gemm_reference`.
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
# each epilogue's output dtype; None: the operands' dtype
_OUT_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16, "gelu_erf": None,
              "gelu_tanh": None, "add_f32": torch.float32, "add_bf16": torch.bfloat16,
              "dgelu_erf": None, "dgelu_tanh": None}
# the epilogues of each layout: NN (the forward), NT (data gradients), TN
# (weight gradients); on bf16 operands, and on f32 ones (every output f32)
_LAYOUT_EPIS = {(False, False): ("f32", "bf16", "gelu_erf", "gelu_tanh"),
                (False, True): ("f32", "bf16", "add_f32", "add_bf16", "dgelu_erf", "dgelu_tanh"),
                (True, False): ("f32", "bf16")}
_F32_LAYOUT_EPIS = {(False, False): ("f32", "gelu_erf", "gelu_tanh"),
                    (False, True): ("f32", "add_f32", "dgelu_erf", "dgelu_tanh"),
                    (True, False): ("f32",)}
# the f32 instance's tile (csrc/gemm_f32.cuh TILE_M, TILE_N, TILE_K), and its
# model of the card: one persistent CTA on each SM, whose 3xTF32 products run
# three TF32 products at the TF32 tensor-core rate (H100 SXM, dense) for one
# f32 product
F32_TILE, F32_TILE_K = 128, 32
_F32_SM_FLOPS = 494.7e12 / 3 / 132


def _out_dtype(epi: str, operands: torch.dtype) -> torch.dtype:
    return _OUT_DTYPE[epi] or operands


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


@functools.lru_cache(maxsize=1024)
def gemm_f32_plan(M: int, N: int, K: int, sms: int) -> GemmPlan:
    """The split of K of an f32 weight gradient (TN) that the f32 instance's
    persistent grid (one CTA on each of ``sms`` SMs walking 128 x 128 tiles)
    finishes soonest: whole waves of ``kchunk``-deep units at its 3xTF32
    rate, plus the f32 partials' write and read. Ties go to fewer splits."""
    if min(M, N, K, sms) < 1:
        raise ValueError(f"gemm_f32_plan needs positive sizes, got M={M} N={N} K={K} sms={sms}")
    tiles = _ceil(M, F32_TILE) * _ceil(N, F32_TILE)
    best, best_t = None, math.inf
    for splits in range(1, MAX_SPLITS + 1):
        kchunk = _ceil(_ceil(K, splits), F32_TILE_K) * F32_TILE_K
        if _ceil(K, kchunk) != splits:
            continue  # the same chunks as fewer splits
        t = (_ceil(tiles * splits, sms) * 2 * F32_TILE * F32_TILE * kchunk / _F32_SM_FLOPS
             + 2 * splits * M * N * 4 / _HBM_BYTES_PER_S)
        if t < best_t:
            best, best_t = GemmPlan(F32_TILE, splits, kchunk), t
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
    (module docstring): the GELU output and u, and the GELU gradient's du, in
    the operands' dtype. Returns C, or the tuple of C, C2 (``out2``) and the
    f32 du's column sums (``colsum``, dgelu epilogues only)."""
    if colsum and not epi.startswith("dgelu"):
        raise ValueError(f"colsum is the column sum of the f32 du; epilogue {epi!r} has none")
    M, N, K = _shape(a, b, a_t, b_t)
    cdtype = a.dtype
    acc = (a.float().T if a_t else a.float()) @ (b.float().T if b_t else b.float())
    if bias is not None:
        acc = acc + bias.float()
    if epi in ("f32", "bf16"):
        return acc.to(_OUT_DTYPE[epi])
    if epi.startswith("gelu"):
        m = gelu(acc, epi == "gelu_erf").to(cdtype)
        return (m, acc.to(cdtype)) if out2 else m
    if epi.startswith("add"):
        return (acc + aux.float()).to(_OUT_DTYPE[epi])
    if epi.startswith("dgelu"):
        du = acc * gelu_grad(aux.float(), epi == "dgelu_erf")
        outs = (du.to(cdtype),) + ((du,) if out2 else ()) + ((du.sum(0),) if colsum else ())
        return outs if len(outs) > 1 else outs[0]
    raise ValueError(f"unknown epilogue {epi!r}")


def _check(name, t, shape, dtype, dev):
    _build.check_tensor(name, t, shape, dtype, dev)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (paired stores and TMA)")


_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_int] * 7
             + [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
             + [ctypes.c_void_p] * 2)
_F32_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)


def gemm(a, b, *, a_t: bool = False, b_t: bool = False, epi: str = "f32", bias=None, aux=None,
         out2: bool = False, colsum: bool = False):
    """C (M, N) = epi(op(A) @ op(B) [+ bias]), the contract of
    :func:`gemm_reference`. Layouts: NN (neither; epilogues f32, bf16,
    gelu_*, with an optional f32 bias (N,)), NT (``b_t``; f32, bf16, add_*,
    dgelu_*, these with ``colsum`` too) and TN (``a_t``, the weight
    gradients; f32, bf16). A CPU tensor takes the plain version; a CUDA
    tensor launches ``csrc/gemm_sm90.cuh`` (bf16 operands) or, for f32
    operands, ``csrc/gemm_f32.cu`` (the epilogues with an f32 output), both
    contiguous with widths multiples of 8, or raises. Each call adds one to
    ``gemm.launches`` (and an f32 one to ``gemm.f32_launches``). The layer
    forward's C sequence launches the same kernels for its products:
    ``ops/layer.py`` adds those to ``gemm.launches``, to
    ``gemm.forward_launches`` and, in f32, to ``gemm.f32_launches``."""
    if a.device.type == "cpu":
        return gemm_reference(a, b, a_t=a_t, b_t=b_t, epi=epi, bias=bias, aux=aux, out2=out2,
                              colsum=colsum)
    if a.device.type != "cuda":
        raise ValueError(f"gemm runs on CPU or CUDA tensors, got {a.device}")
    f32 = a.dtype == torch.float32
    dtype = torch.float32 if f32 else torch.bfloat16
    if epi not in (_F32_LAYOUT_EPIS if f32 else _LAYOUT_EPIS).get((a_t, b_t), ()):
        raise ValueError(f"the {dtype} GEMM kernel has no epilogue {epi!r} for a_t={a_t}, "
                         f"b_t={b_t}")
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
    _check("a", a, a.shape, dtype, dev)
    _check("b", b, b.shape, dtype, dev)
    if bias is not None:
        _build.check_tensor("bias", bias, (N,), torch.float32, dev)
    aux_dtype = {"add": torch.float32, "dgelu": dtype}.get(epi.split("_")[0])
    if aux_dtype is None and aux is not None:
        raise ValueError(f"epilogue {epi!r} reads no aux")
    if aux_dtype is not None:
        if aux is None:
            raise ValueError(f"epilogue {epi!r} needs aux")
        _check("aux", aux, (M, N), aux_dtype, dev)
    c = torch.empty((M, N), dtype=_out_dtype(epi, dtype), device=dev)
    c2 = None
    if out2:
        c2 = torch.empty((M, N), dtype=dtype if epi.startswith("gelu") else torch.float32,
                         device=dev)
    parts = sums = None
    if colsum:  # one partial row per 128-row tile
        parts = torch.empty((_ceil(M, TILE_M), N), dtype=torch.float32, device=dev)
        sums = torch.empty((N,), dtype=torch.float32, device=dev)
    if f32:
        plan = gemm_f32_plan(M, N, K, sm_count(dev)) if a_t else GemmPlan(F32_TILE, 1, K)
        ws = torch.empty((plan.splits, M, N), dtype=torch.float32, device=dev) if a_t else None
        _build.launch("kvq_gemm_f32", _F32_ARGTYPES, int(a_t), int(b_t), a.data_ptr(),
                      a.shape[1], b.data_ptr(), b.shape[1], M, N, K, _EPI[epi], plan.splits,
                      plan.kchunk, c.data_ptr(), N, _ptr(c2), N, _ptr(aux), N, _ptr(bias),
                      _ptr(ws), _ptr(parts), _ptr(sums), device=dev)
        gemm.f32_launches += 1
    else:
        plan = gemm_plan(M, N, K, a_t, sm_count(dev), epi)
        ws = torch.empty((plan.splits, M, N), dtype=torch.float32, device=dev) if a_t else None
        _build.launch("kvq_gemm_sm90", _ARGTYPES, int(a_t), int(b_t), a.data_ptr(), a.shape[1],
                      b.data_ptr(), b.shape[1], M, N, K, _EPI[epi], plan.tile_n, plan.splits,
                      plan.kchunk, c.data_ptr(), N, _ptr(c2), N, _ptr(aux), N, _ptr(bias),
                      _ptr(ws), sm_count(dev), _ptr(parts), _ptr(sums), device=dev)
    gemm.launches += 1
    outs = (c,) + ((c2,) if out2 else ()) + ((sums,) if colsum else ())
    return outs if len(outs) > 1 else c


def _ptr(t):
    return None if t is None else t.data_ptr()


gemm.launches = 0
gemm.f32_launches = 0  # the share of ``launches`` on f32 operands
gemm.forward_launches = 0  # the share of ``launches`` made inside layer forwards
