"""Adam / AMSGrad with L2 weight decay and MultiStepLR, in optax's form.

Counterpart of ``kindergarten_vq_vae_tpu/train/optim.py`` (``make_optimizer``:
``add_decayed_weights -> scale_by_amsgrad -> scale_by_learning_rate``) and of
the single-pass form in ``ops/adam_pallas.py`` l.13-20 / l.92-99:

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

Plain PyTorch, in place, one leaf at a time under ``no_grad``. The AMSGrad
kernel (TPU kernel #14, ``adam_pallas.py:46``) is not ported yet (ROADMAP).
A parameter without a gradient is updated with a zero gradient, as optax
updates a leaf whose gradient is 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kindergarten_vq_vae_torch.config import RunConfig

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


class Adam:
    """The optax chain of ``make_optimizer(cfg)`` over a list of parameters."""

    def __init__(self, cfg: RunConfig):
        if cfg.fused_update == "on":
            raise NotImplementedError(
                "fused_update='on' needs the AMSGrad kernel, not ported yet (ROADMAP, TPU "
                "kernels: #14)")
        self.cfg = cfg
        self.omb1 = float(np.float32(1.0 - B1))
        self.omb2 = float(np.float32(1.0 - B2))

    def init(self, params) -> AdamState:
        def zeros():
            return [torch.zeros_like(p, dtype=torch.float32) for p in params]

        return AdamState(0, zeros(), zeros(), zeros() if self.cfg.amsgrad else None)

    @torch.no_grad()
    def update(self, params, grads, state: AdamState) -> None:
        """One step in place: ``params``, ``state``."""
        count = state.count + 1
        lr = learning_rate(self.cfg, state.count)
        bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
        wd = self.cfg.weight_decay
        for i, (p, g) in enumerate(zip(params, grads)):
            g = torch.zeros_like(p) if g is None else g.float()
            if wd:
                g = g + wd * p
            mu = state.mu[i].mul_(B1).add_(self.omb1 * g)
            nu = state.nu[i].mul_(B2).add_(self.omb2 * (g * g))
            nu_hat = nu / bc2
            if state.nu_max is not None:
                nu_hat = torch.maximum(state.nu_max[i], nu_hat, out=state.nu_max[i])
            p.add_((mu / bc1) / (torch.sqrt(nu_hat) + EPS) * float(-lr))
        state.count = count
