"""Shared analysis utilities.

Counterpart of ``kindergarten_vq_vae_tpu/analyses/common.py``:
:func:`load_run` rebuilds a run's model from its ``run_conf.json`` (the
config's explicit ``model_name`` picks the model) and its best-val
``loss_recon`` slot, and :func:`batched_apply` runs a function over
fixed-size batches of a column store. The parameters live in the module,
so ``load_run`` returns ``(cfg, model)`` where JAX returns ``(cfg, model,
params)``, and the analyses take the model alone.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax
from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name, read_checkpoint
from kindergarten_vq_vae_torch.config import RunConfig, refuse_unported_route
from kindergarten_vq_vae_torch.data.dataset import padded_batches
from kindergarten_vq_vae_torch.models import build_model


def load_run(run_path: str, ckpt_name: str | None = None, device="cuda"):
    """``(cfg, model)`` of a run directory: the model built as
    ``Reconstructor`` builds it (logits head, eval mode) on ``device``, with
    the slot ``ckpt_name`` (the best-val ``loss_recon`` slot by default)
    loaded strictly. On CUDA an f32 run needs full-f32 matrix products
    (``refuse_unported_route``)."""
    cfg = RunConfig.load(os.path.join(run_path, "run_conf.json"))
    device = torch.device(device)
    refuse_unported_route(cfg, device)
    model = build_model(cfg, device=device).eval()
    if ckpt_name is None:
        ckpt_name = best_ckpt_name(cfg.model_name, "loss_recon", "val")
    model.load_state_dict(params_from_jax(read_checkpoint(os.path.join(run_path, ckpt_name))),
                          strict=True)
    return cfg, model


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy (bf16 as f32: numpy has no bfloat16)."""
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_concat(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_concat([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_concat([t[i] for t in trees]) for i in range(len(first)))
    return np.concatenate(trees)


def device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def as_tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@torch.inference_mode()
def batched_apply(fn, arrays: dict, batch_size: int, lim_batches_pct: float = 1.0,
                  device="cuda"):
    """Run ``fn(**batch)`` over fixed-size batches of a column store (numpy
    arrays of equal length, handed to ``fn`` as tensors on ``device``); the
    tail batch is padded with its first row and every output trimmed back.
    Returns the outputs (a tensor, or dicts / tuples of them) concatenated
    as numpy arrays."""
    n = len(next(iter(arrays.values())))
    n_batches = max(1, int(-(-n // batch_size) * lim_batches_pct))
    outs = []
    for _, m, chunk in padded_batches(arrays, batch_size, n_batches):
        out = fn(**{k: as_tensor(v, device) for k, v in chunk.items()})
        outs.append(_tree_map(lambda x: to_numpy(x)[:m], out))
    return _tree_concat(outs)
