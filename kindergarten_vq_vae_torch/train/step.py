"""The training step: loss and gradients, the optimizer update, step + 1.

Counterpart of ``kindergarten_vq_vae_tpu/train/engine.py`` l.240-295
(``Engine._build_train_step``) for the flagship defaults. The port updates
in place: :class:`TrainState` holds the model (its parameters are the
params), the optimizer state and the step count, and ``step(state, batch)``
returns the same state with its ``aux``. After a step each parameter's
``.grad`` holds that step's gradient (None where the loss does not reach
the parameter, as the encoder's pooler).

What the JAX engine can do that this step refuses, each with its ROADMAP
item: the EMA codebook update and dead-code revival (modules to port,
training slice: ``ops/vq.py``), the freezing modes (``model_mode`` other
than ``"full"``: item 3), ``wandb_watch_model`` (item 4), and input
perturbation (``train/variants.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.train.optim import Adam, AdamState
from kindergarten_vq_vae_torch.train.variants import make_loss_fn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt_state: AdamState
    step: int = 0


def _refuse_unported(cfg: RunConfig) -> None:
    refused = {
        "vq_ema_update": (cfg.vq_ema_update, "modules to port, training slice: ops/vq.py"),
        "vq_dead_code_threshold": (cfg.vq_dead_code_threshold > 0,
                                   "modules to port, training slice: ops/vq.py"),
        "model_mode": (cfg.model_mode != "full", "modules to port: item 3, train/freezing.py"),
        "wandb_watch_model": (cfg.wandb_watch_model, "modules to port: item 4, the engine"),
    }
    for name, (on, item) in refused.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP, {item})")


def init_train_state(cfg: RunConfig, model: nn.Module) -> TrainState:
    """Fresh optimizer state for ``model``'s parameters."""
    return TrainState(model, Adam(cfg).init(list(model.parameters())))


def make_train_step(cfg: RunConfig, device, generator: torch.Generator,
                    deterministic: bool = False, reference: bool = False,
                    mark: Optional[Callable[[str], None]] = None) -> Callable:
    """``step(state, batch) -> (state, aux)``. ``generator`` (on ``device``)
    draws the dropout: the layers' hash-dropout seeds and the embedding
    masks. ``deterministic=True`` turns dropout off (the CPU parity tests);
    ``reference=True`` takes every kernel's plain version. ``mark``, when
    given, is called with ``"forward"``, ``"backward"``, ``"update"`` as each
    phase starts and ``"end"`` after the update (a profiler records CUDA
    events there)."""
    _refuse_unported(cfg)
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the step on {device}")
    loss_fn = make_loss_fn(cfg, "train", reference=reference)
    opt = Adam(cfg)

    _mark = mark or (lambda phase: None)

    def step(state: TrainState, batch: dict):
        params = list(state.model.parameters())
        for p in params:
            p.grad = None
        _mark("forward")
        loss, aux = loss_fn(state.model, batch, generator, deterministic)
        _mark("backward")
        loss.backward()
        _mark("update")
        opt.update(params, [p.grad for p in params], state.opt_state)
        _mark("end")
        state.step += 1
        return state, {k: v.detach() for k, v in aux.items()}

    return step
