"""Bagon: BERT encoder + BERT-LM-head decoder autoencoder, no bottleneck.

Counterpart of ``kindergarten_vq_vae_tpu/models/bagon.py``: the encoder's
last hidden state is the decoder's cross-attention memory. With
``output_attentions`` the decoder's self- and cross-attention probabilities
come back as ``decoder_attentions`` / ``decoder_cross_attentions`` (l.53-55).
"""

from __future__ import annotations

import torch
from torch import nn

from kindergarten_vq_vae_torch.nn.bert import BertConfig, BertLMHeadModel, BertModel

# decoder-output keys forwarded by every model: the plain logits, or the
# fused-head triple that ops/head_ce.fused_head_ce_loss consumes
HEAD_KEYS = ("logits", "mlm_hidden", "head_table", "head_bias")


class Bagon(nn.Module):
    def __init__(self, enc_cfg: BertConfig, dec_cfg: BertConfig, device=None):
        super().__init__()
        self.encoder = BertModel(enc_cfg, device)
        self.decoder = BertLMHeadModel(dec_cfg, device)

    def forward(self, encoder_input_ids, encoder_attention_mask, decoder_input_ids,
                decoder_attention_mask, reference: bool = False, deterministic: bool = True,
                generator: torch.Generator | None = None, output_attentions: bool = False) -> dict:
        enc = self.encoder(encoder_input_ids, encoder_attention_mask, reference=reference,
                           deterministic=deterministic, generator=generator)
        dec = self.decoder(decoder_input_ids, decoder_attention_mask,
                           encoder_hidden_states=enc["last_hidden_state"], reference=reference,
                           deterministic=deterministic, generator=generator,
                           output_attentions=output_attentions)
        return {
            **{k: dec[k] for k in HEAD_KEYS if k in dec},
            "encoder_last_hidden_state": enc["last_hidden_state"],
            "encoder_pooler_output": enc["pooler_output"],
            **decoder_attentions(dec),
        }


def decoder_attentions(dec: dict) -> dict:
    """The decoder's attention probabilities under the models' keys, when it returned them."""
    if "attentions" not in dec:
        return {}
    return {"decoder_attentions": dec["attentions"],
            "decoder_cross_attentions": dec["cross_attentions"]}
