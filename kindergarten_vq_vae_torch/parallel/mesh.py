"""Device mesh over ``torch.distributed``: ranks, process groups, the
Megatron sharding rules, the batch split and the collectives of the mesh path.

Counterpart of ``kindergarten_vq_vae_tpu/parallel/mesh.py``. JAX builds one
process over many devices and lets GSPMD place the collectives; the port
takes PyTorch's idiom, one process a device (SPMD under ``torchrun``), and
places them by hand:

- a mesh of ``shape`` over ``axis_names`` holds rank ``r`` at
  ``unravel_index(r, shape)`` (the last axis varies fastest, as JAX lays
  its devices out) and the process groups its collectives use: the dp
  group, flattened over the axes whose names start with "dp" (JAX's
  ``dp_axes``; the one "dp" axis's group on a ``("dp", "tp")`` mesh), and
  the tp group;
- the dp index is the row-major index over the dp axes (JAX's shard index,
  ``nn/bert.py`` l.515-519); a rank holds the dp index's contiguous rows of
  every global batch, and the tp ranks of one dp group hold the same rows;
- the sharding rules are ``_rule_for_path`` word for word, on the port's
  parameter names (JAX's paths with dots, ``ckpt/bridge.py``); a leaf whose
  dims do not divide stays replicated. tp-sharded leaves are stored as
  shards (:class:`TPShards`), gathered whole before use, their gradients
  reduce-scattered over tp;
- the collectives (all-reduce over dp, all-gather and reduce-scatter over
  tp, the dp gather of rows) are the :class:`Mesh` methods. NCCL serves
  CUDA ranks, one a device; gloo serves CPU ranks and several ranks that
  share one card. gloo takes CUDA tensors for all-reduce and broadcast
  only, so on gloo the other collectives of CUDA tensors go through host
  copies. A group of one rank is no group: its collectives return their
  input.

The training and eval steps take the mesh as an argument; below them the
loss function's forward runs under :func:`use_mesh`, and the code it calls
(models, layers, losses, the VQ) reads the mesh from there and from nowhere
else (:func:`active_mesh`). Under it the draws of per-row randomness
(dropout masks, perturbation, Gumbel noise) are made at the global batch's
shape from a generator seeded alike on every rank, and each rank keeps its
rows (:func:`global_draw`), so a dp run draws what one process draws; the
hash-dropout seeds of the layer and SDPA kernels, which hash local row ids,
are folded with the dp index (:func:`fold_active`), as JAX folds them; and
the batch statistics and losses are summed over dp (:func:`dp_sum`,
:func:`dp_mean`), with the local share's gradient.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import math
import os
import socket
import time
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist

SEED_FOLD = 0x632BE5AB  # nn/bert.py l.519
DEFAULT_TIMEOUT_S = 600.0


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_device(device_type: str) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (modulo the cards present,
    so that several ranks can share one) or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None, device="cpu",
                     timeout: float = DEFAULT_TIMEOUT_S) -> tuple[int, int]:
    """Join the process group once a process; returns ``(rank, world_size)``.

    With no ``init_method``: ``env://`` when ``RANK`` is set (``torchrun``),
    else a world of this one process. ``backend`` defaults to NCCL for a
    CUDA ``device`` and gloo for the CPU; NCCL's absence raises, and gloo
    on CUDA must be asked for (several ranks on one card). A collective
    that waits ``timeout`` seconds raises instead of hanging."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev_type = torch.device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    if backend == "nccl" and (dev_type != "cuda" or not dist.is_nccl_available()):
        raise RuntimeError(f"backend 'nccl' needs CUDA ranks and a PyTorch built with NCCL "
                           f"(device {device}, NCCL available: {dist.is_nccl_available()})")
    if init_method is None:
        if "RANK" in os.environ:
            init_method = "env://"
        else:
            init_method, world_size, rank = f"tcp://localhost:{free_port()}", 1, 0
    if init_method == "env://":
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
    if world_size is None or rank is None:
        raise ValueError(f"init_method {init_method!r} needs world_size and rank")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return rank, world_size


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def check_mesh_shape(shape, axis_names) -> None:
    """``ValueError`` unless ``shape`` and ``axis_names`` pair up, no axis
    name repeats, and the mesh's size is the world's."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh_shape {shape} and mesh_axis_names {axis_names} must pair up, "
                         "one distinct name an axis")
    n, world = math.prod(shape), world_size()
    if n != world:
        raise ValueError(f"mesh_shape {shape} holds {n} ranks, the world has {world}")


def _is_dp(name) -> bool:
    return str(name).startswith("dp")


class Mesh:
    """A mesh of the world's ranks; see the module docstring. ``comm_ms``
    sums each collective's wall time by kind while ``timed`` is set (the
    collective is then bracketed by device syncs)."""

    def __init__(self, shape, axis_names, device="cpu"):
        check_mesh_shape(shape, axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.device = torch.device(device)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, self.shape))
        ranks = np.arange(math.prod(self.shape)).reshape(self.shape)
        dp = [i for i, n in enumerate(self.axis_names) if _is_dp(n)]
        tp = [i for i, n in enumerate(self.axis_names) if n == "tp"]
        self.dp_size = math.prod(self.shape[i] for i in dp)
        self.dp_index = int(np.ravel_multi_index([self.coords[i] for i in dp],
                                                 [self.shape[i] for i in dp])) if dp else 0
        self.tp_size = math.prod(self.shape[i] for i in tp)
        self.tp_index = self.coords[tp[0]] if tp else 0
        # every rank creates every group, in one order (torch.distributed's rule)
        self.dp_group = self._group(ranks, dp)
        self.tp_group = self._group(ranks, tp)
        self.timed = False
        self.comm_ms: dict[str, float] = defaultdict(float)

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, rank {self.rank})"

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def _group(self, ranks: np.ndarray, axes: list[int]):
        """The group of the ranks that differ from this one only along
        ``axes`` (None when it holds one rank)."""
        if math.prod(self.shape[i] for i in axes) == 1:
            return None
        moved = np.moveaxis(ranks, axes, list(range(len(axes))))
        blocks = moved.reshape(math.prod(self.shape[i] for i in axes), -1).T
        mine = None
        for block in blocks:
            group = dist.new_group([int(r) for r in block])
            if self.rank in block:
                mine = group
        return mine

    # ---------------------------------------------------------------- collectives

    @contextlib.contextmanager
    def _timing(self, kind: str):
        if not self.timed:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.comm_ms[kind] += (time.perf_counter() - t0) * 1e3

    @staticmethod
    def _host_staged(t: torch.Tensor, group) -> bool:
        return t.device.type == "cuda" and dist.get_backend(group) == "gloo"

    def all_reduce(self, t: torch.Tensor, group, kind: str = "all_reduce") -> torch.Tensor:
        """Sum ``t`` over ``group`` in place; returns it."""
        if group is not None:
            with self._timing(kind):
                dist.all_reduce(t, group=group)
        return t

    def all_reduce_dp(self, t: torch.Tensor, kind: str = "dp_all_reduce") -> torch.Tensor:
        return self.all_reduce(t, self.dp_group, kind)

    def all_gather(self, t: torch.Tensor, group, kind: str = "all_gather") -> torch.Tensor:
        """The group's ``t`` stacked on a new leading axis, in group rank order."""
        if group is None:
            return t[None]
        with self._timing(kind):
            src = t.detach().contiguous()
            if self._host_staged(src, group):
                src = src.cpu()
            parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, src, group=group)
            return torch.stack(parts).to(t.device)

    def gather_rows_dp(self, t: torch.Tensor) -> torch.Tensor:
        """Every dp rank's rows of ``t`` in dp order (the global batch's rows)."""
        return self.all_gather(t, self.dp_group, "dp_all_gather").flatten(0, 1)

    def reduce_scatter(self, t: torch.Tensor, group, kind: str = "reduce_scatter") -> torch.Tensor:
        """``t`` (group size, n): the sum over the group of its row this rank's
        group rank indexes."""
        if group is None:
            return t[0]
        with self._timing(kind):
            src = t.contiguous()
            if self._host_staged(src, group):
                src = src.cpu()
            out = torch.empty_like(src[0])
            dist.reduce_scatter(out, list(src.unbind(0)), group=group)
            return out.to(t.device)


def make_mesh(shape=(), axis_names=(), device="cpu") -> Mesh | None:
    """A :class:`Mesh` of the world's ranks; shape ``()`` gives None (the
    one-device path). The process group must be joined first
    (:func:`init_distributed`) unless the mesh holds one rank."""
    if not shape:
        return None
    return Mesh(shape, axis_names, device)


def dp_axes(mesh: Mesh) -> tuple:
    """All data-parallel axes, e.g. ("dp_host", "dp") on a 3-axis mesh."""
    return tuple(n for n in mesh.axis_names if _is_dp(n))


def _rule_for_path(path: tuple, names: tuple) -> tuple:
    tp = "tp" if "tp" in names else None
    if tp is None:
        return ()
    last2 = path[-2:] if len(path) >= 2 else path
    # column-parallel kernels: shard the output features
    if last2 in (("qkv", "kernel"), ("q", "kernel"), ("kv", "kernel"), ("intermediate", "kernel")):
        return (None, tp)
    if last2 in (("qkv", "bias"), ("q", "bias"), ("kv", "bias"), ("intermediate", "bias")):
        return (tp,)
    # row-parallel kernels: shard the input features
    if last2 in (("out", "kernel"), ("output", "kernel")):
        return (tp, None)
    # vocab-sharded embedding table (also the tied MLM head kernel)
    if last2 == ("word_embeddings", "embedding"):
        return (tp, None)
    if path[-1] == "decoder_bias":  # (V,) vocab-aligned bias
        return (tp,)
    return ()


def param_sharding_rules(named_shapes: dict, mesh: Mesh) -> dict[str, tuple]:
    """``{name: spec}`` for ``{name: tensor or shape}``: a spec is JAX's
    ``PartitionSpec`` as a tuple (``()`` replicated, ``(None, "tp")``
    the second dim over tp, ...), replicated where the dims do not divide."""
    out = {}
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    for name, leaf in named_shapes.items():
        spec = _rule_for_path(tuple(name.split(".")), mesh.axis_names)
        dims = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        ok = all(part is None or (axis < len(dims) and dims[axis] % sizes[part] == 0)
                 for axis, part in enumerate(spec))
        out[name] = spec if ok else ()
    return out


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's contiguous rows of every array of a global batch (the
    dp index's share; scalars and ``n_valid``, the global count, whole)."""
    out = {}
    for k, v in batch.items():
        if k == "n_valid" or np.ndim(v) == 0:
            out[k] = v
            continue
        b = v.shape[0]
        if b % mesh.dp_size:
            raise ValueError(f"batch {k} of {b} rows does not split over {mesh.dp_size} dp ranks")
        local = b // mesh.dp_size
        out[k] = v[mesh.dp_index * local:(mesh.dp_index + 1) * local]
    return out


def fold_seeds(seeds: list[int], shard: int) -> list[int]:
    """``seeds + shard * int32(0x632BE5AB)`` with int32 wrap (JAX l.519)."""
    return [((s + shard * SEED_FOLD + 2**31) % 2**32) - 2**31 for s in seeds]


# ---------------------------------------------------------------- the active mesh

_ACTIVE: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar("kvq_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Within the block (a loss function's forward) the code reads ``mesh``
    through :func:`active_mesh` (see the module docstring); None leaves the
    one-process behaviour."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Mesh | None:
    return _ACTIVE.get()


def global_draw(shape, draw) -> torch.Tensor:
    """``draw(shape)``, or under a mesh with dp ranks this rank's rows of
    ``draw`` at the global shape (``shape[0]`` times the dp size rows)."""
    mesh = _ACTIVE.get()
    if mesh is None or mesh.dp_size == 1:
        return draw(tuple(shape))
    b = shape[0]
    full = draw((b * mesh.dp_size,) + tuple(shape[1:]))
    return full[mesh.dp_index * b:(mesh.dp_index + 1) * b]


def global_numel(t: torch.Tensor) -> int:
    """``t``'s element count over the global batch (rows on the dp ranks)."""
    mesh = _ACTIVE.get()
    return t.numel() * (1 if mesh is None else mesh.dp_size)


def fold_active(seeds: list[int]) -> list[int]:
    """:func:`fold_seeds` with the active mesh's dp index (unchanged without one)."""
    mesh = _ACTIVE.get()
    return seeds if mesh is None or mesh.dp_size == 1 else fold_seeds(seeds, mesh.dp_index)


class _Reduced(torch.autograd.Function):
    """The value of a dp sum, the gradient of the local share."""

    @staticmethod
    def forward(ctx, local, value):
        return value

    @staticmethod
    def backward(ctx, g):
        return g, None


def dp_sum(*parts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each of ``parts`` summed over the active mesh's dp ranks, in one
    all-reduce of f32 values. A part that takes a gradient keeps the local
    share's: the parameters' gradient all-reduce adds the shares up, so an
    all-reduce in the backward would count them dp times. Without dp ranks
    the parts come back as they are."""
    mesh = _ACTIVE.get()
    if mesh is None or mesh.dp_group is None:
        return parts
    flat = torch.cat([p.detach().float().reshape(-1) for p in parts])
    mesh.all_reduce_dp(flat, "dp_stats")
    out, off = [], 0
    for p in parts:
        v = flat[off:off + p.numel()].reshape(p.shape).to(p.dtype)
        off += p.numel()
        out.append(_Reduced.apply(p, v) if p.requires_grad else v)
    return tuple(out)


def dp_mean(*parts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Means over each rank's rows made means over the global batch (equal
    row counts a rank), as :func:`dp_sum` of ``part / dp``."""
    mesh = _ACTIVE.get()
    if mesh is None or mesh.dp_group is None:
        return parts
    return dp_sum(*(p / mesh.dp_size for p in parts))


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of ``t`` (every dp rank's, in dp order) under
    the active mesh, else ``t``."""
    mesh = _ACTIVE.get()
    return t if mesh is None else mesh.gather_rows_dp(t)


# ---------------------------------------------------------------- tp storage


@dataclasses.dataclass
class TPLeaf:
    """A tp-sharded parameter: ``param`` (whole, in the model) is gathered
    from the tp ranks' ``shard``s (this rank's slice along ``dim``, the
    master copy the update writes); ``grad`` is the shard's reduced gradient."""

    param: torch.nn.Parameter
    dim: int
    shard: torch.Tensor
    grad: torch.Tensor | None = None


class TPShards:
    """The tp-sharded leaves of a model (JAX's ``shard_params``): ``leaves``
    maps a name to its :class:`TPLeaf`; empty without a tp axis of 2 or
    more ranks. Gathers and reduce-scatters go through one flat buffer."""

    def __init__(self, mesh: Mesh, named_params):
        self.mesh = mesh
        self.leaves: dict[str, TPLeaf] = {}
        named = list(named_params)
        if mesh.tp_size == 1:
            return
        specs = param_sharding_rules({n: p for n, p in named}, mesh)
        for name, p in named:
            spec = specs[name]
            if "tp" in spec:
                dim = spec.index("tp")
                shard = p.detach().chunk(mesh.tp_size, dim)[mesh.tp_index].clone()
                self.leaves[name] = TPLeaf(p, dim, shard.contiguous())

    def __contains__(self, name: str) -> bool:
        return name in self.leaves

    def __bool__(self) -> bool:
        return bool(self.leaves)

    def shard_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole leaf-shaped tensor."""
        leaf = self.leaves[name]
        return full.chunk(self.mesh.tp_size, leaf.dim)[self.mesh.tp_index]

    @torch.no_grad()
    def gather(self, shards: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        """Whole tensors of every tp rank's ``shards`` (by leaf name, the same
        names on every rank; by default the leaves' own shards, gathered
        into their parameters), through one all-gather."""
        own = shards is None
        if own:
            shards = {n: leaf.shard for n, leaf in self.leaves.items()}
        if not shards:
            return {}
        flat = torch.cat([s.reshape(-1) for s in shards.values()])
        rows = self.mesh.all_gather(flat, self.mesh.tp_group, "tp_all_gather")
        out, off = {}, 0
        for name, s in shards.items():
            leaf, n = self.leaves[name], s.numel()
            whole = torch.cat([rows[k, off:off + n].view(s.shape)
                               for k in range(self.mesh.tp_size)], leaf.dim)
            if own:
                whole = leaf.param.copy_(whole)
            out[name] = whole
            off += n
        return out

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Each leaf's whole gradient on this rank, reduce-scattered over tp
        and divided by the tp size (the tp ranks of a dp group compute the
        same gradient, so this is the mean), then summed over dp, into
        ``leaf.grad``; the parameter's ``.grad`` is dropped."""
        leaves = list(self.leaves.values())
        if not leaves:
            return
        tp = self.mesh.tp_size
        total = sum(leaf.shard.numel() for leaf in leaves)
        buf = torch.empty((tp, total), dtype=torch.float32, device=leaves[0].shard.device)
        off = 0
        for leaf in leaves:
            g = leaf.param.grad if leaf.param.grad is not None else torch.zeros_like(leaf.param)
            n = leaf.shard.numel()
            for k, part in enumerate(g.chunk(tp, leaf.dim)):
                buf[k, off:off + n].view(leaf.shard.shape).copy_(part)
            off += n
            leaf.param.grad = None
        flat = self.mesh.reduce_scatter(buf, self.mesh.tp_group, "tp_reduce_scatter").div_(tp)
        self.mesh.all_reduce_dp(flat, "dp_all_reduce")
        off = 0
        for leaf in leaves:
            n = leaf.shard.numel()
            leaf.grad = flat[off:off + n].view(leaf.shard.shape)
            off += n


def reduce_gradients(mesh: Mesh, named_params, shards: TPShards | None = None) -> None:
    """After ``backward``: replicated leaves' gradients summed over dp in one
    flat bucket, in place; tp-sharded leaves through
    :meth:`TPShards.reduce_grads`. Leaves without a gradient are skipped
    (the same leaves on every rank)."""
    grads = [p.grad for n, p in named_params
             if p.grad is not None and not (shards and n in shards)]
    if mesh.dp_group is not None and grads:
        flat = torch.cat([g.reshape(-1) for g in grads])
        mesh.all_reduce_dp(flat, "dp_all_reduce")
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()
    if shards:
        shards.reduce_grads()
