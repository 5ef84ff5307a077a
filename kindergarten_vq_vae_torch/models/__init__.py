"""Model builders: a run config to a module, and seeded weights.

Counterpart of ``kindergarten_vq_vae_tpu/train/variants.py`` ``bert_configs``
/ ``build_model`` / ``init_params`` for Bagon, Shelgon, Shelgon2 and
Shelgon3 (either quantizer), each with a BERT or a GPT-2 decoder.
"""

from __future__ import annotations

import torch
from torch import nn

from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.models.bagon import Bagon
from kindergarten_vq_vae_torch.models.shelgon import Shelgon
from kindergarten_vq_vae_torch.models.shelgon2 import Shelgon2
from kindergarten_vq_vae_torch.models.shelgon3 import GumbelQuantizer, Shelgon3
from kindergarten_vq_vae_torch.nn.bert import BertConfig
from kindergarten_vq_vae_torch.nn.gpt2 import GPT2Config

__all__ = ["Bagon", "Shelgon", "Shelgon2", "Shelgon3", "bert_configs", "build_model",
           "init_weights"]


def _route(value: str, name: str) -> bool:
    """A trunk switch of the run config: "on" and "auto" are True, "off" is
    False, on every device. A recorded divergence from JAX's
    ``_resolve_auto_flag`` / ``_resolve_fused_layer`` (``train/variants.py``
    l.40-63), whose "auto" is off on the CPU because Pallas runs interpreted
    there: the port's plain versions are no interpreters, so "auto" keeps the
    fused layer on every device."""
    if value not in ("auto", "on", "off"):
        raise ValueError(f"{name} must be 'auto', 'on' or 'off', got {value!r}")
    return value != "off"


def bert_configs(cfg: RunConfig, fused_head: bool = False
                 ) -> tuple[BertConfig, BertConfig | GPT2Config]:
    """(encoder BertConfig, decoder BertConfig or GPT2Config) of a run; a
    ``decoder_model_name`` holding "gpt" selects the GPT-2 decoder (JAX
    l.126-139: the run's widths, its dropout, tied embeddings,
    cross-attention, GPT-2's positions and LayerNorm eps).
    ``fused_head``: the BERT decoder hands the fused head + CE its inputs
    instead of logits. ``fused_layer`` chooses the trunk (the whole-layer
    kernels or the per-module layers) and ``fused_attn`` the per-module
    layers' attention core (#11 / #12 or einsum); ``remat`` is read and
    ignored (ROADMAP)."""
    common = dict(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size,
        hidden_dropout=cfg.hidden_dropout, attention_dropout=cfg.attention_dropout,
        tie_word_embeddings=cfg.tie_word_embeddings, gelu_exact=cfg.gelu_exact, dtype=cfg.dtype,
        fused_layer=_route(cfg.fused_layer, "fused_layer"),
        fused_sdpa=_route(cfg.fused_attn, "fused_attn"),
    )
    enc = BertConfig(add_pooler=True, **common)
    dec_vocab = cfg.decoder_vocab_size or cfg.vocab_size
    if "gpt" in cfg.decoder_model_name:
        return enc, GPT2Config(
            vocab_size=dec_vocab, hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
            num_heads=cfg.num_heads, hidden_dropout=cfg.hidden_dropout,
            attention_dropout=cfg.attention_dropout,
            tie_word_embeddings=cfg.tie_word_embeddings, add_cross_attention=True,
            dtype=cfg.dtype)
    dec = BertConfig(is_decoder=True, add_cross_attention=True, add_pooler=False,
                     fused_head=fused_head, **{**common, "vocab_size": dec_vocab})
    return enc, dec


def build_model(cfg: RunConfig, device=None, fused_head: bool = False) -> nn.Module:
    """The run's model with uninitialised parameters on ``device``. With
    ``fused_head`` its output carries the fused head + CE's inputs in place of
    the logits (the training and eval steps of a ``fused_head_ce`` run);
    the parameters are the same either way. Shelgon2's ``mask_pct`` is the
    loss's argument, not the model's: one model serves every stage."""
    enc, dec = bert_configs(cfg, fused_head)
    name, seq_len = cfg.model_name, cfg.tokenized_sentence_max_length
    if name == "bagon":
        return Bagon(enc, dec, device)
    if name == "shelgon":
        return Shelgon(enc, dec, emb_size=cfg.emb_size, seq_len=seq_len,
                       num_latent_classes=cfg.num_latent_classes,
                       num_labels_per_class=cfg.num_labels_per_class, device=device)
    if name == "shelgon2":
        return Shelgon2(enc, dec, word_emb_size=cfg.word_embedding_size, sentence_len=seq_len,
                        num_latent_gen_factors=cfg.num_latent_gen_factors, device=device)
    if name == "shelgon3":
        return Shelgon3(enc, dec, vq_mode=cfg.vq_mode, vq_n_e=cfg.vq_n_e, vq_e_dim=cfg.vq_e_dim,
                        vq_beta=cfg.vq_beta, vq_temperature=cfg.vq_temperature,
                        vq_kl_div_scale=cfg.vq_kl_div_scale,
                        vq_straight_through=cfg.vq_straight_through,
                        vq_ema_update=cfg.vq_ema_update, device=device)
    raise ValueError(f"unknown model_name {name}")


INIT_STD = 0.02  # bert-base initializer_range, as the JAX package's BertConfig


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation with the JAX package's distributions: normal(0.02)
    kernels (every leaf named ``kernel`` or ``*_kernel``), embedding and
    position tables (GPT-2's bare ``wpe`` too), zero biases (``bias`` /
    ``*_bias``), unit LayerNorm scales, a uniform(+-1/n_e) VQ codebook and a
    normal(0.02) Gumbel codebook (JAX
    ``models/shelgon3.py:115``). ``generator`` must live on the parameters'
    device."""
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if leaf == "kernel" or leaf.endswith("_kernel") or leaf in (
                    "embedding", "position_embeddings", "wpe"):
                p.normal_(0.0, INIT_STD, generator=generator)
            elif leaf == "bias" or leaf.endswith("_bias"):
                p.zero_()
            elif leaf == "scale":
                p.fill_(1.0)
            elif leaf == "codebook" and isinstance(mod, GumbelQuantizer):
                p.normal_(0.0, INIT_STD, generator=generator)
            elif leaf == "codebook":
                n_e = p.shape[0]
                p.uniform_(-1.0 / n_e, 1.0 / n_e, generator=generator)
            else:
                raise KeyError(f"no initialiser for parameter {mod_name}.{leaf}")
    return model
