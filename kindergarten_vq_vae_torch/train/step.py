"""The training and eval steps.

Counterpart of ``kindergarten_vq_vae_tpu/train/engine.py`` l.240-305
(``Engine._build_train_step`` / ``_build_eval_step``). The port updates in
place: :class:`TrainState` holds the model (its parameters are the params),
the optimizer state over the trainable leaves, the EMA codebook state, the
dead-code counters and the step count, and ``step(state, batch)`` returns
the same state with its ``aux``. One train step is, in the JAX order
(l.248-292): loss and gradients; with ``wandb_watch_model``, the global
gradient norm and the per-leaf gradient norms (``grad_norm``,
``watch_grads``, one stacked vector); the update of the trainable leaves
(frozen leaves and their moments untouched); the EMA codebook overwrite;
the dead-code reset; step + 1. After a step each parameter's ``.grad``
holds that step's gradient, a frozen parameter's too, as JAX computes the
gradient of every leaf (None where the loss does not reach the parameter,
as the encoder's pooler).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.ops.vq import (
    EMAState,
    dead_code_reset,
    ema_codebook_update,
    init_ema_state,
)
from kindergarten_vq_vae_torch.train.freezing import trainable_mask
from kindergarten_vq_vae_torch.train.optim import AdamState, make_optimizer
from kindergarten_vq_vae_torch.train.variants import make_loss_fn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt_state: AdamState
    step: int = 0
    ema: Optional[EMAState] = None
    dead_steps: Optional[torch.Tensor] = None  # (n_e,) int32 dead-code counters
    mask: dict = dataclasses.field(default_factory=dict)  # {parameter name: trainable}

    def trainable(self) -> list[tuple[str, nn.Parameter]]:
        return [(n, p) for n, p in self.model.named_parameters() if self.mask.get(n, True)]


def model_mask(cfg: RunConfig, model: nn.Module) -> dict[str, bool]:
    return trainable_mask([n for n, _ in model.named_parameters()], cfg.model_mode,
                          cross_attn_trainable=cfg.cross_attn_make_trainable,
                          tie_word_embeddings=cfg.tie_word_embeddings)


def init_train_state(cfg: RunConfig, model: nn.Module) -> TrainState:
    """Fresh optimizer state for ``model``'s trainable parameters, and the EMA
    state and dead-code counters where the run asks for them."""
    mask = model_mask(cfg, model)
    device = next(model.parameters()).device
    state = TrainState(model, AdamState(0, [], [], None), mask=mask)
    state.opt_state = make_optimizer(cfg, device).init([p for _, p in state.trainable()])
    # the codebook state exists only under the VQ (JAX engine.py:193-199)
    vq = cfg.model_name == "shelgon3" and cfg.vq_mode == "VectorQuantizer"
    if vq and cfg.vq_ema_update:
        state.ema = init_ema_state(model.vector_quantizer.codebook)
    if vq and cfg.vq_dead_code_threshold > 0:
        state.dead_steps = torch.zeros(cfg.vq_n_e, dtype=torch.int32, device=device)
    return state


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(t.float())))


def make_train_step(cfg: RunConfig, device, generator: torch.Generator,
                    deterministic: bool = False, reference: bool = False,
                    mark: Optional[Callable[[str], None]] = None) -> Callable:
    """``step(state, batch) -> (state, aux)``. ``generator`` (on ``device``)
    draws the dropout (the layers' hash-dropout seeds and the embedding
    masks), the perturbation and the dead-code re-seeds. ``deterministic=True``
    turns dropout off (the CPU parity tests); ``reference=True`` takes every
    kernel's plain version. ``mark``, when given, is called with
    ``"forward"``, ``"backward"``, ``"update"`` as each phase starts and
    ``"end"`` after the update (a profiler records CUDA events there)."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the step on {device}")
    loss_fn = make_loss_fn(cfg, "train", reference=reference)
    opt = make_optimizer(cfg, device)
    decay, threshold = cfg.vq_ema_decay, cfg.vq_dead_code_threshold
    _mark = mark or (lambda phase: None)

    def step(state: TrainState, batch: dict):
        named = state.trainable()
        params = [p for _, p in named]
        for p in state.model.parameters():
            p.grad = None
        _mark("forward")
        loss, aux = loss_fn(state.model, batch, generator, deterministic)
        _mark("backward")
        loss.backward()
        aux = {k: v.detach() for k, v in aux.items()}
        if cfg.wandb_watch_model:
            zero = torch.zeros((), device=device)
            norms = torch.stack([zero if p.grad is None else _norm(p.grad)
                                 for _, p in state.model.named_parameters()])
            aux["grad_norm"] = torch.sqrt(torch.sum(torch.square(norms)))
            aux["watch_grads"] = norms
        _mark("update")
        opt.update(params, [p.grad for p in params], state.opt_state)
        with torch.no_grad():
            codebook = getattr(getattr(state.model, "vector_quantizer", None), "codebook", None)
            if state.ema is not None:
                new_cb, state.ema = ema_codebook_update(codebook, state.ema, aux["ema_counts"],
                                                        aux["ema_sum_z"], decay)
                codebook.copy_(new_cb)
            if state.dead_steps is not None:
                new_cb, state.dead_steps = dead_code_reset(
                    codebook, state.dead_steps, aux["ema_counts"], aux["z_rows"], generator,
                    threshold=threshold)
                codebook.copy_(new_cb)
        _mark("end")
        state.step += 1
        return state, aux

    return step


def make_eval_step(cfg: RunConfig, stage: str, reference: bool = False) -> Callable:
    """``eval_step(model, batch, generator) -> aux`` of a val or test stage:
    no dropout, no gradient (the layers take the serving launches, without
    residuals)."""
    loss_fn = make_loss_fn(cfg, stage, reference=reference)

    @torch.no_grad()
    def eval_step(model: nn.Module, batch: dict, generator: torch.Generator) -> dict:
        _, aux = loss_fn(model, batch, generator, True)
        return aux

    return eval_step
