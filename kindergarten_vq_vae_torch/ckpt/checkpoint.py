"""Flat-npy checkpoints in the JAX package's format.

Counterpart of ``kindergarten_vq_vae_tpu/ckpt/checkpoint.py`` l.84-165: a
directory of ``<i>.npy`` leaves plus ``manifest.json`` mapping each
'/'-joined tree key to ``{"file", "dtype", "shape"[, "bitcast"]}``. A leaf
whose dtype numpy lacks (bfloat16) is stored as its same-width unsigned view
and marked ``bitcast``; it is read back here as a ``torch.bfloat16`` tensor,
without ``ml_dtypes``.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

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


def write_checkpoint(path: str, tree: dict) -> None:
    """Write a nested dict of numpy arrays / tensors as ``<path>/<i>.npy`` +
    manifest, atomically (tmp dir + rename), as ``_write_leaves`` does."""
    tmp = path + ".tmp-write"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        entry = {"file": f"{i}.npy"}
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                entry.update(dtype="bfloat16", shape=list(leaf.shape), bitcast="uint16")
                arr = leaf.view(torch.int16).numpy().view(np.uint16)
            else:
                arr = leaf.numpy()
        else:
            arr = np.asarray(leaf)
        entry.setdefault("dtype", str(arr.dtype))
        entry.setdefault("shape", list(arr.shape))
        np.save(os.path.join(tmp, entry["file"]), arr, allow_pickle=False)
        manifest[key] = entry
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
