"""Parameter counts per component.

Counterpart of ``kindergarten_vq_vae_tpu/utils/params.py``
``params_summary_dict``: for each named component (``encoder``,
``decoder``), its trainable, frozen and total parameter counts, the
trainability read from a ``{parameter name: trainable}`` mask (everything
trainable without one).
"""

from __future__ import annotations

from torch import nn


def params_summary_dict(model: nn.Module, components=("encoder", "decoder"),
                        mask: dict[str, bool] | None = None) -> dict:
    out = {}
    for comp in components:
        tot = nt = 0
        for name, p in model.named_parameters():
            if name.split(".")[0] != comp:
                continue
            tot += p.numel()
            if mask is None or mask.get(name, True):
                nt += p.numel()
        out[comp] = {"n_trainable_params": nt, "n_not_trainable_params": tot - nt,
                     "n_params": tot}
    return out
