"""Weight bridge between the JAX package's Flax param tree and the port's modules.

The port's modules carry the Flax names and layouts (kernels ``(in, out)``),
so the bridge is a key walk: ``encoder/layer_0/self_attn/qkv/kernel`` is
the state-dict entry ``encoder.layer_0.self_attn.qkv.kernel``, unchanged and
untransposed. ``load_state_dict(strict=True)`` then rejects any missing,
unexpected or misshapen leaf.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """Flax param tree (nested dict of numpy arrays or tensors) -> state dict."""
    out: dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(params_from_jax(v, key))
        else:
            out[key] = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
    return out


def params_to_jax(model: torch.nn.Module | Mapping) -> dict:
    """Module (or state dict) -> Flax param tree: nested dict of numpy arrays
    (bfloat16 tensors stay tensors: numpy has no bfloat16)."""
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model
    root: dict = {}
    for key, t in state.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        t = t.detach().cpu()
        node[parts[-1]] = t if t.dtype == torch.bfloat16 else t.numpy()
    return root
