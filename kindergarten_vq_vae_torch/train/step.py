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

Under a device mesh (``mesh``, :mod:`~kindergarten_vq_vae_torch.parallel.mesh`)
the batch is the rank's rows and the model holds whole parameters on every
rank; the tp-sharded leaves' master copies and optimizer moments are the
rank's shards (:class:`~kindergarten_vq_vae_torch.parallel.mesh.TPShards`).
After ``backward`` the replicated leaves' gradients are summed over dp in
one flat bucket and the sharded leaves' reduce-scattered over tp, then
summed over dp (their ``.grad`` dropped, the shard's gradient in
``TPLeaf.grad``); the update (#14 on CUDA: the port keeps the kernel under
a mesh, where JAX turns its own off) runs on the rank's leaves and shards;
the shards are then gathered back into the whole parameters. The EMA and
the dead-code reset take the global batch's statistics and rows, and draw
alike on every rank.
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
from kindergarten_vq_vae_torch.parallel.mesh import Mesh, TPShards, make_mesh, reduce_gradients
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
    shards: Optional[TPShards] = None  # the tp-sharded leaves under a mesh with tp ranks

    def trainable(self) -> list[tuple[str, nn.Parameter]]:
        return [(n, p) for n, p in self.model.named_parameters() if self.mask.get(n, True)]

    def update_leaves(self) -> list[tuple[str, torch.Tensor, Optional[torch.Tensor]]]:
        """``(name, tensor, gradient)`` of every trainable leaf the update
        writes: the parameter, or its shard under tp sharding."""
        out = []
        for n, p in self.trainable():
            if self.shards and n in self.shards:
                leaf = self.shards.leaves[n]
                out.append((n, leaf.shard, leaf.grad))
            else:
                out.append((n, p, p.grad))
        return out


def model_mask(cfg: RunConfig, model: nn.Module) -> dict[str, bool]:
    return trainable_mask([n for n, _ in model.named_parameters()], cfg.model_mode,
                          cross_attn_trainable=cfg.cross_attn_make_trainable,
                          tie_word_embeddings=cfg.tie_word_embeddings)


def init_train_state(cfg: RunConfig, model: nn.Module, mesh: Optional[Mesh] = None) -> TrainState:
    """Fresh optimizer state for ``model``'s trainable parameters (their tp
    shards under a ``mesh`` with tp ranks), and the EMA state and dead-code
    counters where the run asks for them."""
    mask = model_mask(cfg, model)
    device = next(model.parameters()).device
    state = TrainState(model, AdamState(0, [], [], None), mask=mask)
    if mesh is not None:
        state.shards = TPShards(mesh, model.named_parameters())
    state.opt_state = make_optimizer(cfg, device).init([t for _, t, _ in state.update_leaves()])
    # the codebook state exists only under the VQ (JAX engine.py:193-199)
    vq = cfg.model_name == "shelgon3" and cfg.vq_mode == "VectorQuantizer"
    if vq and cfg.vq_ema_update:
        state.ema = init_ema_state(model.vector_quantizer.codebook)
    if vq and cfg.vq_dead_code_threshold > 0:
        state.dead_steps = torch.zeros(cfg.vq_n_e, dtype=torch.int32, device=device)
    return state


def _sq_norms(state: TrainState, device) -> torch.Tensor:
    """Each leaf's squared gradient norm (0 without a gradient); a tp-sharded
    leaf's summed over its tp shards."""
    zero = torch.zeros((), device=device)
    shards = state.shards
    sq = []
    for n, p in state.model.named_parameters():
        g = shards.leaves[n].grad if shards and n in shards else p.grad
        sq.append(zero if g is None else torch.sum(torch.square(g.float())))
    sq = torch.stack(sq)
    if shards:
        tp_rows = torch.tensor([n in shards for n, _ in state.model.named_parameters()],
                               device=device)
        part = torch.where(tp_rows, sq, zero)
        shards.mesh.all_reduce(part, shards.mesh.tp_group, "tp_all_reduce")
        sq = torch.where(tp_rows, part, sq)
    return sq


def make_train_step(cfg: RunConfig, device, generator: torch.Generator,
                    deterministic: bool = False, reference: bool = False,
                    mark: Optional[Callable[[str], None]] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """``step(state, batch) -> (state, aux)``. ``generator`` (on ``device``)
    draws the dropout (the layers' hash-dropout seeds and the embedding
    masks), the perturbation and the dead-code re-seeds. ``deterministic=True``
    turns dropout off (the CPU parity tests); ``reference=True`` takes every
    kernel's plain version. ``mark``, when given, is called with
    ``"forward"``, ``"backward"``, ``"update"`` as each phase starts and
    ``"end"`` after the update (a profiler records CUDA events there).
    ``mesh``: the device mesh of the run (one built from ``cfg.mesh_shape``
    when None and the config has one); the state's tp shards must be of
    it, and ``generator`` seeded alike on every rank."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the step on {device}")
    if mesh is None and cfg.mesh_shape:
        mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axis_names, device)
    loss_fn = make_loss_fn(cfg, "train", reference=reference, mesh=mesh)
    opt = make_optimizer(cfg, device)
    decay, threshold = cfg.vq_ema_decay, cfg.vq_dead_code_threshold
    _mark = mark or (lambda phase: None)

    def step(state: TrainState, batch: dict):
        for p in state.model.parameters():
            p.grad = None
        _mark("forward")
        loss, aux = loss_fn(state.model, batch, generator, deterministic)
        _mark("backward")
        loss.backward()
        aux = {k: v.detach() for k, v in aux.items()}
        if mesh is not None:
            reduce_gradients(mesh, state.model.named_parameters(), state.shards)
        if cfg.wandb_watch_model:
            norms = torch.sqrt(_sq_norms(state, device))
            aux["grad_norm"] = torch.sqrt(torch.sum(torch.square(norms)))
            aux["watch_grads"] = norms
        _mark("update")
        leaves = state.update_leaves()
        opt.update([t for _, t, _ in leaves], [g for _, _, g in leaves], state.opt_state)
        if state.shards:
            state.shards.gather()
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


def train_gradients(cfg: RunConfig, state: TrainState, batch: dict, generator: torch.Generator,
                    mesh: Optional[Mesh] = None) -> list[torch.Tensor]:
    """Every parameter's whole gradient of the train loss on ``batch`` (dropout
    drawn from ``generator``) at the current parameters, in
    ``named_parameters`` order, zeros where the loss does not reach a leaf
    (the gradient histograms' recomputation, JAX engine l.459-486). Under a
    ``mesh`` the gradients are reduced as the step reduces them and the tp
    leaves' gathered whole: a collective that every rank calls. The
    parameters' ``.grad`` are overwritten."""
    named = list(state.model.named_parameters())
    for _, p in named:
        p.grad = None
    loss, _ = make_loss_fn(cfg, "train", mesh=mesh)(state.model, batch, generator, False)
    loss.backward()
    whole = {}
    if mesh is not None:
        reduce_gradients(mesh, named, state.shards)
        if state.shards:
            whole = state.shards.gather({n: leaf.grad for n, leaf in state.shards.leaves.items()})
    return [whole[n] if n in whole else torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in named]


def make_eval_step(cfg: RunConfig, stage: str, reference: bool = False,
                   mesh: Optional[Mesh] = None) -> Callable:
    """``eval_step(model, batch, generator) -> aux`` of a val or test stage:
    no dropout, no gradient (the layers take the serving launches, without
    residuals); under a ``mesh``, on the rank's rows with global stats."""
    loss_fn = make_loss_fn(cfg, stage, reference=reference, mesh=mesh)

    @torch.no_grad()
    def eval_step(model: nn.Module, batch: dict, generator: torch.Generator) -> dict:
        _, aux = loss_fn(model, batch, generator, True)
        return aux

    return eval_step
