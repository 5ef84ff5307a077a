"""Per-variant loss functions of the train, val and test stages.

Counterpart of ``kindergarten_vq_vae_tpu/train/variants.py`` (l.149-154,
l.219-459): ``loss_fn(model, batch, generator, deterministic) -> (loss, aux)``
for Bagon, Shelgon, Shelgon2 and Shelgon3 (either quantizer), with
``_recon`` choosing the fused head + CE + argmax (``fused_head_ce`` "store"
/ "flash"), the streaming CE + argmax (``fused_ce``, the single-device
default) or ``kl_recon_loss`` + argmax, ``_valid_row`` weighting by
``n_valid``, and the JAX package's ``aux`` keys. ``batch`` holds ``input_ids`` /
``attention_mask`` (B, S) tensors on the model's device and ``n_valid`` (an
int), and for Shelgon the 5-factor ``labels`` / ``one_hot``, for Shelgon2
the 8-factor ``labels8`` / ``one_hot8``; a GPT-2 decoder's run also holds
its BPE ``dec_input_ids`` / ``dec_attention_mask``, which Bagon's and
Shelgon's decoders read (Shelgon2 and Shelgon3 feed the encoder's ids to
the decoder, as JAX does). Each stage perturbs its inputs by
its own ``*_perturb_{stage}_pct``, drawn from ``generator``
(:mod:`~kindergarten_vq_vae_torch.utils.tensor`): Bagon both sides, with
the recon target the perturbed decoder ids unless
``bagon_target_unperturbed``; Shelgon whole columns of both sides (masks
None where ``use_mask_encoder`` / ``use_mask_decoder`` are off), the target
the clean decoder ids; Shelgon3 only the decoder input, the target staying
the clean ids; Shelgon2 corrupts the decoder input inside the model by its
stage's ``mask_pct_{stage}`` (JAX builds one model per stage with it). The
generator also draws the Gumbel noise. With ``vq_dead_code_threshold > 0``
the Shelgon3-VQ aux carries ``z_rows``, the first ``4 * n_e`` encoder
outputs, for dead-code revival.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from kindergarten_vq_vae_torch.config import RunConfig, refuse_unported
from kindergarten_vq_vae_torch.ops.ce import fused_ce_loss_ids
from kindergarten_vq_vae_torch.ops.head_ce import fused_head_ce_loss
from kindergarten_vq_vae_torch.parallel.mesh import active_mesh, dp_sum, gather_rows, use_mesh
from kindergarten_vq_vae_torch.train.losses import kl_onehot_loss, kl_recon_loss
from kindergarten_vq_vae_torch.utils.metrics import padding_tokens_pct, seq_acc
from kindergarten_vq_vae_torch.utils.tensor import (
    replace_pct_rand_columns,
    replace_pct_rand_values,
)

# stats that are scalars and get accumulated per epoch, per variant
STAT_KEYS = {
    "bagon": ("loss_recon", "loss_full", "metric_acc", "padding_tokens_pct"),
    "shelgon": ("loss_recon", "loss_pred", "loss_full", "metric_acc", "metric_acc_pred",
                "padding_tokens_pct"),
    "shelgon2": ("loss_recon", "loss_latent", "loss_full", "metric_acc", "metric_latent_acc",
                 "padding_tokens_pct"),
    "shelgon3": ("loss_recon", "loss_vq", "loss_full", "metric_perp", "metric_acc",
                 "padding_tokens_pct"),
}

# the label columns each variant's loss reads from the batch
LABEL_KEYS = {"shelgon": ("labels", "one_hot"), "shelgon2": ("labels8", "one_hot8")}

# direction for "best" tracking: min for losses, max for metrics
BEST_MODES = {
    "loss_recon": "min",
    "loss_pred": "min",
    "loss_latent": "min",
    "loss_vq": "min",
    "loss_full": "min",
    "metric_acc": "max",
    "metric_acc_pred": "max",
    "metric_latent_acc": "max",
    "metric_perp": "max",  # perplexity should approach the codebook size
}

# stats that trigger a best-checkpoint write, per variant
CKPT_KEYS = {
    "bagon": ("loss_recon", "metric_acc"),
    "shelgon": ("loss_recon", "metric_acc"),
    "shelgon2": ("loss_recon", "metric_acc"),
    "shelgon3": ("loss_recon", "metric_acc", "loss_vq"),
}


def load_codebook_init(cfg: RunConfig) -> np.ndarray | None:
    """The codebook's initial values from ``vq_codebook_init_values_path``, or None."""
    path = cfg.vq_codebook_init_values_path
    if path is None:
        return None
    return np.load(path) if path.endswith(".npy") else np.load(path, allow_pickle=True)


def _valid_row(batch) -> torch.Tensor:
    """1/0 by row: valid where the row's index in the global batch is below
    ``n_valid``; under a device mesh the rows are the dp index's share."""
    ids = batch["input_ids"]
    b = ids.shape[0]
    mesh = active_mesh()
    start = 0 if mesh is None else mesh.dp_index * b
    return (torch.arange(start, start + b, device=ids.device) < batch["n_valid"]).float()


def _resolve_head_ce(cfg: RunConfig, mesh=None) -> str | None:
    """The fused head + CE mode of the loss path, or None for the logits path
    (JAX l.70-93). It needs a BERT decoder with tied embeddings; "store" and
    "flash" are honoured on any device, and "auto" is "store" under a mesh
    (JAX resolves it so under a TPU mesh: the fused kernel never holds the
    (rows, V) logits) and None without one."""
    if "gpt" in cfg.decoder_model_name or not cfg.tie_word_embeddings:
        return None
    if cfg.fused_head_ce == "auto" and (mesh is not None or cfg.mesh_shape):
        return "store"
    return cfg.fused_head_ce if cfg.fused_head_ce in ("store", "flash") else None


def make_loss_fn(cfg: RunConfig, stage: str, reference: bool = False, mesh=None) -> Callable:
    """The loss function of a stage ('train' | 'val' | 'test'). ``reference``
    runs every kernel's plain version (the comparison baseline on the card).
    Where :func:`_resolve_head_ce` gives a mode, the model must be built with
    ``build_model(cfg, fused_head=True)``, as JAX's ``make_loss_fn`` builds
    its own (l.229-230).

    Under a ``mesh`` (:class:`~kindergarten_vq_vae_torch.parallel.mesh.Mesh`)
    the batch holds this rank's rows and ``n_valid`` the global count: the
    forward runs under :func:`~kindergarten_vq_vae_torch.parallel.mesh.use_mesh`
    (global-shape draws, folded seeds, the sharded VQ), each loss divides by
    the global batch's normaliser and is summed over dp with the local
    share's gradient, the row means of ``aux`` are global means, and
    ``z_rows`` comes from the global batch. The logits route keeps the
    streaming CE (#7 / #8) under the global normaliser, where JAX falls back
    to XLA's CE (l.259): a recorded divergence."""
    refuse_unported(cfg)
    name = cfg.model_name
    if name not in STAT_KEYS:
        raise ValueError(f"unknown model_name {name}")
    is_training = stage == "train"
    vocab = cfg.vocab_size
    dec_vocab = cfg.decoder_vocab_size or vocab
    enc_pct = getattr(cfg, f"encoder_perturb_{stage}_pct")
    dec_pct = getattr(cfg, f"decoder_perturb_{stage}_pct")
    mask_pct = getattr(cfg, f"mask_pct_{stage}")
    head_mode = _resolve_head_ce(cfg, mesh)
    vq = cfg.vq_mode == "VectorQuantizer"

    def _rows(batch) -> float | None:
        """The global batch's valid rows (at least 1) under a mesh, else None
        (each loss then counts its own)."""
        mesh = active_mesh()
        if mesh is None:
            return None
        b = batch["input_ids"].shape[0]
        return float(max(min(int(batch["n_valid"]), b * mesh.dp_size), 1))

    def _denom(rows, per_row: int):
        return None if rows is None else rows * per_row

    def _global(sums=(), means=()):
        """Under a mesh, in one dp all-reduce: the ``sums`` (losses under the
        global normaliser) summed and the ``means`` over the rank's rows made
        means over the global batch."""
        mesh = active_mesh()
        if mesh is None or mesh.dp_group is None:
            return (*sums, *means)
        return dp_sum(*sums, *(m / mesh.dp_size for m in means))

    def _recon(out, target_ids, valid, rows):
        """(loss_recon, recon_ids): the fused head + CE + argmax when its mode
        is set, else the streaming CE + argmax over the logits, else
        ``kl_recon_loss`` and an argmax (JAX l.246-261)."""
        denom = _denom(rows, target_ids.shape[1])
        if head_mode is not None:
            if "mlm_hidden" not in out:
                raise ValueError(f"fused_head_ce={cfg.fused_head_ce!r} needs a model built with "
                                 "build_model(cfg, fused_head=True)")
            loss, ids = fused_head_ce_loss(out["mlm_hidden"], out["head_table"],
                                           out["head_bias"], target_ids, valid, denom,
                                           mode=head_mode, reference=reference)
        elif cfg.fused_ce:
            loss, ids = fused_ce_loss_ids(out["logits"], target_ids, valid, reference, denom)
        else:
            logits = out["logits"]
            loss, ids = kl_recon_loss(logits, target_ids, valid, denom), torch.argmax(logits, -1)
        # under a mesh the rank's share of the global mean, summed over dp (for
        # the fused head, JAX's fused_head_ce_loss_sharded)
        return (*_global((loss,)), ids)

    def bagon_loss(model, batch, generator, deterministic):
        valid, rows = _valid_row(batch), _rows(batch)
        dec_src = batch.get("dec_input_ids", batch["input_ids"])
        dec_mask = batch.get("dec_attention_mask", batch["attention_mask"])
        enc_ids = replace_pct_rand_values(batch["input_ids"], enc_pct, 0, vocab, generator)
        dec_ids = replace_pct_rand_values(dec_src, dec_pct, 0, dec_vocab, generator)
        out = model(enc_ids, batch["attention_mask"], dec_ids, dec_mask,
                    reference=reference, deterministic=deterministic, generator=generator)
        target_ids = dec_src if cfg.bagon_target_unperturbed else dec_ids
        loss_recon, recon_ids = _recon(out, target_ids, valid, rows)
        acc, acc_per_sentence = seq_acc(recon_ids, target_ids)
        acc, pad = _global(means=(acc, padding_tokens_pct(batch["input_ids"])))
        aux = {
            "loss_recon": loss_recon,
            "loss_full": loss_recon,
            "metric_acc": acc,
            "padding_tokens_pct": pad,
            "recon_ids": recon_ids,
            "acc_per_sentence": acc_per_sentence,
            "target_ids": target_ids,
        }
        return loss_recon, aux

    def shelgon_loss(model, batch, generator, deterministic):
        valid, rows = _valid_row(batch), _rows(batch)
        dec_src = batch.get("dec_input_ids", batch["input_ids"])
        # whole columns (JAX l.313-316)
        enc_ids = replace_pct_rand_columns(batch["input_ids"], enc_pct, 0, vocab, generator)
        dec_ids = replace_pct_rand_columns(dec_src, dec_pct, 0, dec_vocab, generator)
        enc_mask = batch["attention_mask"] if cfg.use_mask_encoder else None
        dec_mask = (batch.get("dec_attention_mask", batch["attention_mask"])
                    if cfg.use_mask_decoder else None)
        out = model(enc_ids, enc_mask, dec_ids, dec_mask, reference=reference,
                    deterministic=deterministic, generator=generator)
        # the target is the unperturbed decoder ids (JAX l.328-331)
        loss_recon, recon_ids = _recon(out, dec_src, valid, rows)
        loss_pred = kl_onehot_loss(out["pred_latent_logits"], batch["one_hot"], valid,
                                   _denom(rows, batch["one_hot"].shape[1]))
        acc, acc_per_sentence = seq_acc(recon_ids, dec_src)
        acc_pred, _ = seq_acc(torch.argmax(out["pred_latent_classes"], dim=-1), batch["labels"])
        loss_pred, acc, acc_pred, pad = _global(
            (loss_pred,), (acc, acc_pred, padding_tokens_pct(batch["input_ids"])))
        loss_full = loss_recon + loss_pred
        aux = {
            "loss_recon": loss_recon,
            "loss_pred": loss_pred,
            "loss_full": loss_full,
            "metric_acc": acc,
            "metric_acc_pred": acc_pred,
            "padding_tokens_pct": pad,
            "recon_ids": recon_ids,
            "acc_per_sentence": acc_per_sentence,
            "target_ids": dec_src,
        }
        return loss_full, aux

    def shelgon2_loss(model, batch, generator, deterministic):
        valid, rows = _valid_row(batch), _rows(batch)
        ids = batch["input_ids"]
        out = model(ids, batch["attention_mask"], reference=reference,
                    deterministic=deterministic, generator=generator, mask_pct=mask_pct)
        loss_recon, recon_ids = _recon(out, ids, valid, rows)
        # (B, 3, F) -> (B, F, 3) before the loss (JAX l.349-350)
        latent_logits = out["gen_factors_logits"].permute(0, 2, 1)
        loss_latent = kl_onehot_loss(latent_logits, batch["one_hot8"], valid,
                                     _denom(rows, latent_logits.shape[1]))
        acc, acc_per_sentence = seq_acc(recon_ids, ids)
        acc_latent, _ = seq_acc(out["gen_factors_labels"], batch["labels8"])
        loss_latent, acc, acc_latent, pad = _global(
            (loss_latent,), (acc, acc_latent, padding_tokens_pct(ids)))
        loss_recon = loss_recon * cfg.loss_recon_rescale_factor * cfg.loss_recon_weight
        loss_latent = loss_latent * cfg.loss_latent_rescale_factor * cfg.loss_latent_weight
        loss_full = loss_recon + loss_latent
        aux = {
            "loss_recon": loss_recon,
            "loss_latent": loss_latent,
            "loss_full": loss_full,
            "metric_acc": acc,
            "metric_latent_acc": acc_latent,
            "padding_tokens_pct": pad,
            "recon_ids": recon_ids,
            "acc_per_sentence": acc_per_sentence,
            "target_ids": ids,
            "gen_factors_labels": out["gen_factors_labels"],
        }
        return loss_full, aux

    def shelgon3_loss(model, batch, generator, deterministic):
        valid, rows = _valid_row(batch), _rows(batch)
        ids = batch["input_ids"]
        dec_input = None
        if dec_pct:
            dec_input = replace_pct_rand_values(ids, dec_pct, 0, dec_vocab, generator)
        out = model(ids, batch["attention_mask"], reference=reference,
                    deterministic=deterministic, is_training=is_training, generator=generator,
                    decoder_input_ids=dec_input)
        loss_recon, recon_ids = _recon(out, ids, valid, rows)
        loss_recon = loss_recon * cfg.loss_recon_rescale_factor * cfg.loss_recon_weight
        loss_vq = out["vq_loss"] * cfg.loss_vq_rescale_factor * cfg.loss_vq_weight
        loss_full = loss_recon + loss_vq
        acc, acc_per_sentence = seq_acc(recon_ids, ids)
        acc, pad = _global(means=(acc, padding_tokens_pct(ids)))
        aux = {
            "loss_recon": loss_recon,
            "loss_vq": loss_vq,
            "loss_full": loss_full,
            "metric_perp": out["perplexity"],
            "metric_acc": acc,
            "padding_tokens_pct": pad,
            "recon_ids": recon_ids,
            "acc_per_sentence": acc_per_sentence,
            "target_ids": ids,
            "min_encoding_indices": out["min_encoding_indices"],
        }
        if out["ema_stats"] is not None:
            aux["ema_counts"] = out["ema_stats"]["counts"]
            aux["ema_sum_z"] = out["ema_stats"]["sum_z"]
        if cfg.vq_dead_code_threshold > 0 and vq:
            k = 4 * cfg.vq_n_e
            z_rows = out["encoder_last_hidden_state"].reshape(-1, cfg.vq_e_dim)[:k].detach()
            aux["z_rows"] = gather_rows(z_rows)[:k]
        return loss_full, aux

    loss_fn = {"bagon": bagon_loss, "shelgon": shelgon_loss, "shelgon2": shelgon2_loss,
               "shelgon3": shelgon3_loss}[name]
    if mesh is None:
        return loss_fn

    def mesh_loss_fn(model, batch, generator, deterministic):
        with use_mesh(mesh):
            return loss_fn(model, batch, generator, deterministic)

    return mesh_loss_fn
