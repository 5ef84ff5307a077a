"""Single-pass AMSGrad update over many leaves: the CUDA kernel's wrapper and its plain version.

Counterpart of ``kindergarten_vq_vae_tpu/ops/adam_pallas.py`` (TPU kernel
#14, ``_adam_kernel`` l.46; the plain form ``_leaf_update_jnp`` l.92-99).
Per element, with the scalars of :class:`AdamScalars`::

    g' = g + wd * p;  mu = omb1 * g' + b1 * mu;  nu = omb2 * g'^2 + b2 * nu
    vmax = max(vmax, nu / bc2);  p -= lr * (mu / bc1) / (sqrt(vmax) + eps)

in place on ``p``, ``mu``, ``nu`` and ``vmax``. A leaf whose gradient is
None is updated with a zero gradient (its moments decay and it still
moves), as optax updates a leaf whose gradient is 0.

:func:`amsgrad_update` takes lists of leaves: CPU tensors go through
:func:`adam_update_reference`; CUDA tensors launch ``csrc/adam.cu`` once
for all leaves, or raise, and each launch adds one to
``amsgrad_update.launches``. Bound on the H100: 36 B per element (32 B
without a gradient) over 3.35 TB/s, ~2.7 ms for the ~248M trainable
elements of the bert-base Shelgon3-VQ.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from kindergarten_vq_vae_torch import _build

_VP, _F = ctypes.c_void_p, ctypes.c_float
_ARGTYPES = [_VP, _VP, ctypes.c_int] + [_F] * 9 + [_VP]


@dataclasses.dataclass(frozen=True)
class AdamScalars:
    """The update's scalars, each an f32 value held as a Python float."""

    lr: float
    wd: float
    b1: float
    b2: float
    eps: float
    bc1: float
    bc2: float
    omb1: float
    omb2: float

    def values(self) -> tuple[float, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def adam_update_reference(p, g, mu, nu, vmax, s: AdamScalars) -> None:
    """Plain version, one leaf, in place: one PyTorch operation per step of
    the formula, in the kernel's order. The scalars are 0-dim tensors on the
    leaf's device, so each division is an IEEE division (PyTorch turns a
    division of a CUDA tensor by a Python scalar into a multiplication by
    its reciprocal)."""
    t = {k: torch.tensor(v, dtype=torch.float32, device=p.device)
         for k, v in dataclasses.asdict(s).items()}
    gg = (torch.zeros_like(p) if g is None else g) + t["wd"] * p
    mu.copy_(t["omb1"] * gg + t["b1"] * mu)
    nu.copy_(t["omb2"] * (gg * gg) + t["b2"] * nu)
    torch.maximum(vmax, nu / t["bc2"], out=vmax)
    p.sub_(t["lr"] * ((mu / t["bc1"]) / (torch.sqrt(vmax) + t["eps"])))


class LeafTable:
    """The kernel's device tables for a fixed list of leaves: the chunk
    table, built once, and the leaf table, rebuilt every step because the
    gradients are new tensors every step (the step sets ``.grad`` to None and
    autograd allocates them anew; keeping them across steps would add an
    accumulation pass over every gradient). The leaf table goes to the card
    by one asynchronous copy from pinned memory; PyTorch's pinned allocator
    keeps the host buffer until that copy has run, and the table keeps a
    reference to it until the next step."""

    def __init__(self, params, mu, nu, vmax):
        self.params, self.mu, self.nu, self.vmax = params, mu, nu, vmax
        dev = params[0].device
        for name, leaves in (("params", params), ("mu", mu), ("nu", nu), ("vmax", vmax)):
            for t, p in zip(leaves, params):
                if (t.dtype != torch.float32 or t.device != dev or not t.is_contiguous()
                        or t.shape != p.shape):
                    raise TypeError(f"amsgrad_update takes contiguous f32 leaves on one device "
                                    f"({name}: {t.dtype} {tuple(t.shape)} on {t.device})")
        lib = _build.lib()
        lib.kvq_adam_chunk.restype = ctypes.c_longlong
        chunk = lib.kvq_adam_chunk()
        rows = [(i, s) for i, p in enumerate(params) for s in range(0, p.numel(), chunk)]
        self.n_chunks = len(rows)
        self.chunks = torch.tensor(rows, dtype=torch.int64).reshape(-1, 2).to(dev)
        self._host = None

    def leaves(self, grads) -> torch.Tensor:
        rows = np.zeros((len(self.params), 6), dtype=np.int64)
        keep = []
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if g is not None:
                if g.dtype != torch.float32 or g.device != p.device or g.shape != p.shape:
                    raise TypeError(f"gradient {i}: {g.dtype} {tuple(g.shape)} on {g.device}, "
                                    f"expected f32 {tuple(p.shape)} on {p.device}")
                g = g.contiguous()
                keep.append(g)
            rows[i] = (p.data_ptr(), 0 if g is None else g.data_ptr(), self.mu[i].data_ptr(),
                       self.nu[i].data_ptr(), self.vmax[i].data_ptr(), p.numel())
        self._host = torch.from_numpy(rows).pin_memory()
        self._grads = keep  # alive until the launch that reads them is queued
        return self._host.to(self.params[0].device, non_blocking=True)


def amsgrad_update(params, grads, mu, nu, vmax, s: AdamScalars,
                   table: LeafTable | None = None) -> None:
    """One AMSGrad step in place over lists of leaves (``grads`` may hold
    None). CPU leaves take :func:`adam_update_reference` leaf by leaf; CUDA
    leaves take one launch of ``csrc/adam.cu`` over all of them, through
    ``table`` (built here when not given), or raise."""
    if not params:
        return
    dev = params[0].device
    if dev.type == "cpu":
        for leaf in zip(params, grads, mu, nu, vmax):
            adam_update_reference(*leaf, s)
        return
    if dev.type != "cuda":
        raise ValueError(f"amsgrad_update runs on CPU or CUDA tensors, got {dev}")
    table = table or LeafTable(params, mu, nu, vmax)
    leaves = table.leaves(grads)
    fn = _build.lib().kvq_adam_amsgrad
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(leaves.data_ptr(), table.chunks.data_ptr(), table.n_chunks, *s.values(),
                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "kvq_adam_amsgrad")
    amsgrad_update.launches += 1


amsgrad_update.launches = 0
