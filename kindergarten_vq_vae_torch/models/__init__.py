"""Model builders: a run config to a module, and seeded weights.

Counterpart of ``kindergarten_vq_vae_tpu/train/variants.py`` ``bert_configs``
/ ``build_model`` / ``init_params`` for the models the port has.
"""

from __future__ import annotations

import torch
from torch import nn

from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.models.bagon import Bagon
from kindergarten_vq_vae_torch.models.shelgon3 import Shelgon3
from kindergarten_vq_vae_torch.nn.bert import BertConfig

__all__ = ["Bagon", "Shelgon3", "bert_configs", "build_model", "init_weights"]


def bert_configs(cfg: RunConfig, fused_head: bool = False) -> tuple[BertConfig, BertConfig]:
    """(encoder, decoder) BertConfigs of a run; ``fused_head``: the decoder
    hands the fused head + CE its inputs instead of logits."""
    if "gpt" in cfg.decoder_model_name:
        raise NotImplementedError(
            "the GPT-2 decoder is not ported yet (ROADMAP, modules to port: item 7, nn/gpt2.py)")
    common = dict(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size,
        hidden_dropout=cfg.hidden_dropout, attention_dropout=cfg.attention_dropout,
        tie_word_embeddings=cfg.tie_word_embeddings, gelu_exact=cfg.gelu_exact, dtype=cfg.dtype,
    )
    enc = BertConfig(add_pooler=True, **common)
    dec = BertConfig(is_decoder=True, add_cross_attention=True, add_pooler=False,
                     fused_head=fused_head,
                     **{**common, "vocab_size": cfg.decoder_vocab_size or cfg.vocab_size})
    return enc, dec


def build_model(cfg: RunConfig, device=None, fused_head: bool = False) -> nn.Module:
    """The run's model with uninitialised parameters on ``device``. With
    ``fused_head`` its output carries the fused head + CE's inputs in place of
    the logits (the training and eval steps of a ``fused_head_ce`` run);
    the parameters are the same either way."""
    enc, dec = bert_configs(cfg, fused_head)
    if cfg.model_name == "bagon":
        return Bagon(enc, dec, device)
    if cfg.model_name == "shelgon3":
        return Shelgon3(enc, dec, vq_mode=cfg.vq_mode, vq_n_e=cfg.vq_n_e, vq_e_dim=cfg.vq_e_dim,
                        vq_beta=cfg.vq_beta, vq_ema_update=cfg.vq_ema_update, device=device)
    raise NotImplementedError(
        f"model {cfg.model_name!r} is not ported yet (ROADMAP, modules to port: item 7)")


INIT_STD = 0.02  # bert-base initializer_range, as the JAX package's BertConfig


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation with the JAX package's distributions: normal(0.02)
    kernels and embedding tables, zero biases, unit LayerNorm scales, and a
    uniform(+-1/n_e) codebook. ``generator`` must live on the parameters' device."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("kernel", "embedding", "position_embeddings", "decoder_kernel"):
            p.normal_(0.0, INIT_STD, generator=generator)
        elif leaf in ("bias", "decoder_bias"):
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "codebook":
            n_e = p.shape[0]
            p.uniform_(-1.0 / n_e, 1.0 / n_e, generator=generator)
        else:
            raise KeyError(f"no initialiser for parameter {name}")
    return model
