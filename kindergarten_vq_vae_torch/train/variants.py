"""Per-variant loss functions of the training step.

Counterpart of ``kindergarten_vq_vae_tpu/train/variants.py`` (l.219-427):
``loss_fn(model, batch, generator, deterministic) -> (loss, aux)`` for
Bagon and Shelgon3 (VectorQuantizer mode), with ``_recon`` choosing the
streaming CE + argmax (``fused_ce``, the single-device default) or
``kl_recon_loss`` + argmax, ``_valid_row`` weighting by ``n_valid``, and the
JAX package's ``aux`` keys. ``batch`` holds ``input_ids`` / ``attention_mask``
(B, S) tensors on the model's device and ``n_valid`` (an int).

Input perturbation (``*_perturb_*_pct``) is refused: the JAX package draws
it from ``jax.random``, and it is not ported yet (ROADMAP, modules to port,
training slice: ``utils/tensor.py``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.ops.ce import fused_ce_loss_ids
from kindergarten_vq_vae_torch.train.losses import kl_recon_loss
from kindergarten_vq_vae_torch.utils.metrics import padding_tokens_pct, seq_acc

# stats that are scalars and get accumulated per epoch, per variant
STAT_KEYS = {
    "bagon": ("loss_recon", "loss_full", "metric_acc", "padding_tokens_pct"),
    "shelgon3": ("loss_recon", "loss_vq", "loss_full", "metric_perp", "metric_acc",
                 "padding_tokens_pct"),
}


def _valid_row(batch) -> torch.Tensor:
    b = batch["input_ids"].shape[0]
    return (torch.arange(b, device=batch["input_ids"].device) < batch["n_valid"]).float()


def make_loss_fn(cfg: RunConfig, stage: str, reference: bool = False) -> Callable:
    """The loss function of a stage ('train' | 'val' | 'test'). ``reference``
    runs every kernel's plain version (the comparison baseline on the card)."""
    for side in ("encoder", "decoder"):
        if not math.isclose(getattr(cfg, f"{side}_perturb_{stage}_pct"), 0.0):
            raise NotImplementedError(
                f"{side}_perturb_{stage}_pct: input perturbation is not ported yet (ROADMAP, "
                "modules to port, training slice: utils/tensor.py)")
    name = cfg.model_name
    if name not in STAT_KEYS:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP, modules to port: item 7)")
    is_training = stage == "train"

    def _recon(logits, target_ids, valid):
        if cfg.fused_ce:
            return fused_ce_loss_ids(logits, target_ids, valid, reference)
        return kl_recon_loss(logits, target_ids, valid), torch.argmax(logits, -1)

    def bagon_loss(model, batch, generator, deterministic):
        valid = _valid_row(batch)
        dec_src = batch.get("dec_input_ids", batch["input_ids"])
        dec_mask = batch.get("dec_attention_mask", batch["attention_mask"])
        out = model(batch["input_ids"], batch["attention_mask"], dec_src, dec_mask,
                    reference=reference, deterministic=deterministic, generator=generator)
        # unperturbed, the decoder ids are the target either way
        # (the JAX package's bagon_target_unperturbed picks between two equal tensors)
        loss_recon, recon_ids = _recon(out["logits"], dec_src, valid)
        acc, acc_per_sentence = seq_acc(recon_ids, dec_src)
        aux = {
            "loss_recon": loss_recon,
            "loss_full": loss_recon,
            "metric_acc": acc,
            "padding_tokens_pct": padding_tokens_pct(batch["input_ids"]),
            "recon_ids": recon_ids,
            "acc_per_sentence": acc_per_sentence,
            "target_ids": dec_src,
        }
        return loss_recon, aux

    def shelgon3_loss(model, batch, generator, deterministic):
        valid = _valid_row(batch)
        ids = batch["input_ids"]
        out = model(ids, batch["attention_mask"], reference=reference,
                    deterministic=deterministic, is_training=is_training, generator=generator)
        loss_recon, recon_ids = _recon(out["logits"], ids, valid)
        loss_recon = loss_recon * cfg.loss_recon_rescale_factor * cfg.loss_recon_weight
        loss_vq = out["vq_loss"] * cfg.loss_vq_rescale_factor * cfg.loss_vq_weight
        loss_full = loss_recon + loss_vq
        acc, acc_per_sentence = seq_acc(recon_ids, ids)
        aux = {
            "loss_recon": loss_recon,
            "loss_vq": loss_vq,
            "loss_full": loss_full,
            "metric_perp": out["perplexity"],
            "metric_acc": acc,
            "padding_tokens_pct": padding_tokens_pct(ids),
            "recon_ids": recon_ids,
            "acc_per_sentence": acc_per_sentence,
            "target_ids": ids,
            "min_encoding_indices": out["min_encoding_indices"],
            "ema_counts": out["ema_stats"]["counts"],
            "ema_sum_z": out["ema_stats"]["sum_z"],
        }
        return loss_full, aux

    return {"bagon": bagon_loss, "shelgon3": shelgon3_loss}[name]
