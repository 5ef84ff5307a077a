"""Flat-npy checkpoints in the JAX package's format: best slots, async writes, resume bundles.

Counterpart of ``kindergarten_vq_vae_tpu/ckpt/checkpoint.py`` l.45-331: a
directory of ``<i>.npy`` leaves plus ``manifest.json`` mapping each
'/'-joined tree key to ``{"file", "dtype", "shape"[, "bitcast"]}``. A leaf
whose dtype numpy lacks (bfloat16) is stored as its same-width unsigned view
and marked ``bitcast``; it is read back here as a ``torch.bfloat16`` tensor,
without ``ml_dtypes``. A best slot is the model's parameters under their
Flax paths, so each side reads the other's slots. Writes are atomic (a tmp
directory and a rename).

- :func:`save_checkpoint_multi`: one write of a bundle, then hardlinked
  clones under the other slot names;
- :class:`AsyncCheckpointWriter`: the device-to-host copy happens in the
  caller, before it returns (the next train step overwrites the parameters
  in place), and only the disk write runs on a background thread;
- :func:`write_checkpoint` / :func:`read_checkpoint` of any tree: a best
  slot, or the engine's resume bundle (parameters, optimizer state, step);
- :func:`load_params` (``init_from_ckpt``) and :func:`load_bagon_into_model`
  (``from_pretrained_bagon``) load a bundle into a model.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax

MANIFEST = "manifest.json"


def best_ckpt_name(model_name: str, stat: str, stage: str) -> str:
    return f"{model_name}_ckpt_{stat}_{stage}_best"


def _load_leaf(path: str, entry: dict):
    arr = np.load(os.path.join(path, entry["file"]), allow_pickle=False)
    if "bitcast" not in entry:
        return arr
    if entry["dtype"] != "bfloat16":
        raise ValueError(f"cannot read a {entry['dtype']} leaf ({entry['file']}) without ml_dtypes")
    return torch.from_numpy(arr.astype(np.uint16).view(np.int16)).view(torch.bfloat16)


def read_checkpoint(path: str) -> dict:
    """Nested dict of leaves (numpy arrays; bfloat16 leaves as torch tensors)."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    root: dict = {}
    for key, entry in manifest.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _load_leaf(path, entry)
    return root


def _flatten(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            yield from _flatten(tree[k], key)
        else:
            yield key, tree[k]


def _fetch(tree: dict) -> list[tuple[str, np.ndarray, dict]]:
    """Every leaf on the host as ``(key, array, manifest entry)``: the
    synchronous device-to-host part of a save."""
    out = []
    for key, leaf in _flatten(tree):
        entry: dict = {}
        if isinstance(leaf, torch.Tensor):
            # a copy on the CPU too: the caller changes its tensors in place
            leaf = leaf.detach().to("cpu", copy=True)
            if leaf.dtype == torch.bfloat16:
                entry.update(dtype="bfloat16", shape=list(leaf.shape), bitcast="uint16")
                arr = leaf.view(torch.int16).numpy().view(np.uint16)
            else:
                arr = leaf.numpy()
        else:
            arr = np.array(leaf)
        entry.setdefault("dtype", str(arr.dtype))
        entry.setdefault("shape", list(arr.shape))
        out.append((key, arr, entry))
    return out


def _write_leaves(path: str, leaves) -> None:
    tmp = path + ".tmp-write"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for i, (key, arr, entry) in enumerate(leaves):
        entry = {"file": f"{i}.npy", **entry}
        np.save(os.path.join(tmp, entry["file"]), arr, allow_pickle=False)
        manifest[key] = entry
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def write_checkpoint(path: str, tree: dict) -> None:
    """Write a nested dict of numpy arrays / tensors as ``<path>/<i>.npy`` +
    manifest, atomically."""
    _write_leaves(os.path.abspath(path), _fetch(tree))


def _clone_dir(first: str, p: str) -> None:
    """Atomically clone a bundle directory through hardlinks (copies across
    file systems)."""
    tmp = p + ".tmp-write"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for name in os.listdir(first):
        src, dst = os.path.join(first, name), os.path.join(tmp, name)
        try:
            os.link(src, dst)
        except OSError:
            shutil.copy2(src, dst)
    if os.path.exists(p):
        shutil.rmtree(p)
    os.replace(tmp, p)


def save_checkpoint_multi(paths: list[str], tree: dict) -> None:
    """The same bundle under several best-slot names: one write, then
    hardlinked clones."""
    if not paths:
        return
    first = os.path.abspath(paths[0])
    write_checkpoint(first, tree)
    for p in paths[1:]:
        _clone_dir(first, os.path.abspath(p))


class AsyncCheckpointWriter:
    """Background disk writer for bundles (``checkpoint.py:202-295``).

    ``save_multi`` copies every leaf to the host before it returns, so the
    caller may overwrite its tensors at once; the disk write and the rename
    run on a daemon thread. One pending job per destination group (keyed by
    its first path): a newer submission replaces an unstarted older one.
    ``wait()`` drains the queue and re-raises the first background error."""

    def __init__(self):
        self._cond = threading.Condition()
        self._queue: dict = {}
        self._inflight = False
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None

    def save_multi(self, paths: list[str], tree: dict, after=None) -> None:
        """Queue a bundle write (and its clones); ``after`` (no arguments)
        runs on the writer thread once the bundle is durable."""
        if not paths:
            return
        leaves = _fetch(tree)  # synchronous: the tensors change with the next step
        paths = [os.path.abspath(p) for p in paths]

        def job():
            _write_leaves(paths[0], leaves)
            for p in paths[1:]:
                _clone_dir(paths[0], p)
            if after is not None:
                after()

        with self._cond:
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError("async checkpoint write failed") from err
            self._queue[paths[0]] = job
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, name="ckpt-writer",
                                                daemon=True)
                self._thread.start()
            self._cond.notify_all()

    def save(self, path: str, tree: dict, after=None) -> None:
        self.save_multi([path], tree, after=after)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
                key = next(iter(self._queue))
                job = self._queue.pop(key)
                self._inflight = True
            try:
                job()
            except BaseException as e:  # noqa: BLE001 - surfaced on wait() / the next save
                with self._cond:
                    if self._error is None:
                        self._error = e
            with self._cond:
                self._inflight = False
                self._cond.notify_all()

    def wait(self) -> None:
        """Block until every queued write is durable; re-raise errors."""
        with self._cond:
            while self._queue or self._inflight:
                self._cond.wait()
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError("async checkpoint write failed") from err


@torch.no_grad()
def load_params(model: torch.nn.Module, path: str, prefixes: tuple[str, ...] = ()) -> None:
    """Copy a bundle's parameters into ``model`` in place: every parameter, or
    only those under ``prefixes``; a missing or misshapen leaf raises."""
    loaded = params_from_jax(read_checkpoint(path))
    for name, p in model.named_parameters():
        if prefixes and name.split(".")[0] not in prefixes:
            continue
        if name not in loaded:
            raise KeyError(f"checkpoint {path} has no leaf {name!r}")
        src = loaded[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch for {name!r}: checkpoint {tuple(src.shape)} vs "
                             f"model {tuple(p.shape)}")
        p.copy_(src.to(p.dtype))


def load_bagon_into_model(model: torch.nn.Module, bagon_ckpt_path: str) -> None:
    """Warm-start a Shelgon-family model from a Bagon bundle: its encoder and
    decoder; the bottleneck stays as initialised."""
    load_params(model, bagon_ckpt_path, prefixes=("encoder", "decoder"))


def model_tree(model: torch.nn.Module) -> dict:
    """The model's parameters (tensors, not copied) as the Flax tree a best slot holds."""
    root: dict = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        node = root
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = p
    return root
