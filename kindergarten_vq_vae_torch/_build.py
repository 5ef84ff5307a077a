"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all at
once, and the objects are linked into one shared library with a plain C
interface under ``build/`` (next to this file), loaded with :mod:`ctypes`.
Nothing here runs at import: the CPU tests import every module of the
package on machines without ``nvcc`` or a card. The library is rebuilt when
a source or header is newer than it. A failed build raises. The wrappers
check their tensors with :func:`check_tensor` and call an entry point with
:func:`launch`.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libkvq_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_entries: dict[str, object] = {}  # entry points with their signatures set
build_log = ""  # nvcc's output of the last build in this process (ptxas register/smem report)


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = _sources() + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return any(os.path.getmtime(s) > built for s in deps)


def build() -> None:
    """Compile every ``csrc/*.cu`` at once, one nvcc each, and link them into
    ``build/libkvq_kernels.so`` (atomically)."""
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    jobs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            build_log = "".join(logs)
            raise RuntimeError("\n".join(failed))
        tmp = f"{LIB_PATH}.{tag}"
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = "".join(logs) + proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{build_log}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            _lib = ctypes.CDLL(LIB_PATH)
            _lib.kvq_error_string.argtypes = [ctypes.c_int]
            _lib.kvq_error_string.restype = ctypes.c_char_p
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib().kvq_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_tensor(name, t, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``, 16-byte aligned when bf16 (the GEMMs load 16-byte chunks)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype == torch.bfloat16 and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the GEMM loads 16-byte chunks)")


def launch(name: str, argtypes: list, *args, device) -> None:
    """Call the C entry point ``name`` with ``args`` (``argtypes`` their
    ctypes types) and, last, the current CUDA stream of ``device``; raise on
    a CUDA error. The library's runtime launches on the current device."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(lib(), name)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        check(fn(*args, stream), name)
    else:
        with torch.cuda.device(device):
            check(fn(*args, stream), name)
