"""Adam / AMSGrad with L2 weight decay and MultiStepLR, over the trainable leaves.

Counterpart of ``kindergarten_vq_vae_tpu/train/optim.py`` (``make_optimizer``:
``add_decayed_weights -> scale_by_amsgrad -> scale_by_learning_rate``, masked
by ``multi_transform`` + ``set_to_zero``) and of ``ops/adam_pallas.py``
(``resolve_fused_update`` l.106-129, ``FusedAdam`` l.132-201):

- L2 is added to the gradient before the moments (torch ``Adam(weight_decay)``,
  not AdamW);
- ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, with ``1-b``
  computed in f64 and rounded to f32, as optax's python-float ``1 - decay``;
- bias corrections ``1 - b**count`` in f32;
- AMSGrad takes the max of the *bias-corrected* ``nu_hat`` (``torch.optim.Adam
  (amsgrad=True)`` maxes the raw second moment, a different update);
- the update is ``mu_hat / (sqrt(nu_max) + eps)``, times ``-lr``;
- MultiStepLR is optax's piecewise-constant schedule over the optimizer's
  own count: the rate is scaled by ``gamma`` for each milestone ``<= count``;
  as in ``make_lr_schedule``, any other ``lr_scheduler`` means a constant rate.

The optimizer holds only the trainable leaves (the freezing mask of
:mod:`~kindergarten_vq_vae_torch.train.freezing`): a frozen leaf and its
moments are never touched, as ``set_to_zero`` leaves them. Everything is in
place. A leaf without a gradient is updated with a zero gradient, as optax
updates a leaf whose gradient is 0.

``fused_update`` picks the update (:func:`resolve_fused_update`): with
AMSGrad, ``"auto"`` and ``"on"`` take the single-pass update of
:mod:`~kindergarten_vq_vae_torch.ops.adam`, which launches kernel #14 on
CUDA (a divergence: the JAX ``"auto"`` resolves to the optax chain because
of a TPU-runtime crash that does not bind the port); ``"jnp"`` takes that
update's plain version on any device; ``"off"``, or Adam without AMSGrad,
the optax-form update leaf by leaf (:class:`Adam`). On the CPU every mode
but ``"off"`` runs the plain single-pass version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.ops.adam import (
    AdamScalars,
    LeafTable,
    adam_update_reference,
    amsgrad_update,
)

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    nu_max: list[torch.Tensor] | None  # None without amsgrad


def learning_rate(cfg: RunConfig, count: int) -> np.float32:
    """``optax.piecewise_constant_schedule(lr, {m: gamma})`` at ``count``, in f32."""
    v = np.float32(cfg.lr)
    if cfg.lr_scheduler == "MultiStepLR" and cfg.milestones:
        for threshold in sorted(int(m) for m in cfg.milestones):
            if count >= threshold:
                v = np.float32(np.float32(cfg.gamma) * v)
    return v


def scalars(cfg: RunConfig, count: int) -> AdamScalars:
    """The update's f32 scalars for the step that takes the count from
    ``count`` to ``count + 1`` (``FusedAdam.apply`` l.166-176)."""
    f32 = np.float32
    c = f32(count + 1)
    return AdamScalars(
        lr=float(learning_rate(cfg, count)), wd=float(f32(cfg.weight_decay)), b1=float(f32(B1)),
        b2=float(f32(B2)), eps=float(f32(EPS)), bc1=float(f32(1.0) - f32(B1) ** c),
        bc2=float(f32(1.0) - f32(B2) ** c), omb1=float(f32(1.0 - B1)), omb2=float(f32(1.0 - B2)))


def resolve_fused_update(cfg: RunConfig, device) -> str | None:
    """``"kernel"`` (#14 on CUDA), ``"plain"`` (its plain version) or None
    (the optax-form update)."""
    if not cfg.amsgrad or cfg.fused_update == "off":
        return None
    if cfg.fused_update not in ("auto", "on", "jnp"):
        raise ValueError(f"fused_update={cfg.fused_update!r}: expected auto, on, off or jnp")
    if cfg.fused_update == "jnp" or torch.device(device).type == "cpu":
        return "plain"
    return "kernel"


def _zeros(params):
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


class Adam:
    """The optax chain of ``make_optimizer(cfg)``, leaf by leaf."""

    def __init__(self, cfg: RunConfig):
        self.cfg = cfg

    def init(self, params) -> AdamState:
        return AdamState(0, _zeros(params), _zeros(params),
                         _zeros(params) if self.cfg.amsgrad else None)

    @torch.no_grad()
    def update(self, params, grads, state: AdamState) -> None:
        """One step in place: ``params``, ``state``."""
        s = scalars(self.cfg, state.count)
        for i, (p, g) in enumerate(zip(params, grads)):
            g = torch.zeros_like(p) if g is None else g.float()
            if self.cfg.weight_decay:
                g = g + s.wd * p
            mu = state.mu[i].mul_(s.b1).add_(s.omb1 * g)
            nu = state.nu[i].mul_(s.b2).add_(s.omb2 * (g * g))
            nu_hat = nu / s.bc2
            if state.nu_max is not None:
                nu_hat = torch.maximum(state.nu_max[i], nu_hat, out=state.nu_max[i])
            p.add_((mu / s.bc1) / (torch.sqrt(nu_hat) + s.eps) * -s.lr)
        state.count += 1


class FusedAdam:
    """The single-pass AMSGrad update (``FusedAdam`` of ``adam_pallas.py``):
    one launch of kernel #14 per step over every leaf (``path="kernel"``), or
    its plain version leaf by leaf (``path="plain"``)."""

    def __init__(self, cfg: RunConfig, path: str):
        if path not in ("kernel", "plain"):
            raise ValueError(f"path={path!r}: expected 'kernel' or 'plain'")
        self.cfg, self.path = cfg, path
        self._table: LeafTable | None = None

    def init(self, params) -> AdamState:
        self._table = None
        return AdamState(0, _zeros(params), _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(self, params, grads, state: AdamState) -> None:
        s = scalars(self.cfg, state.count)
        if self.path == "plain":
            for leaf in zip(params, grads, state.mu, state.nu, state.nu_max):
                adam_update_reference(*leaf, s)
        else:
            if self._table is None or self._table.mu is not state.mu:
                self._table = LeafTable(params, state.mu, state.nu, state.nu_max)
            amsgrad_update(params, grads, state.mu, state.nu, state.nu_max, s, self._table)
        state.count += 1


def make_optimizer(cfg: RunConfig, device) -> Adam | FusedAdam:
    path = resolve_fused_update(cfg, device)
    return Adam(cfg) if path is None else FusedAdam(cfg, path)
