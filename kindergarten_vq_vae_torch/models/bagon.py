"""Bagon: BERT encoder + BERT-LM-head decoder autoencoder, no bottleneck.

Counterpart of ``kindergarten_vq_vae_tpu/models/bagon.py``: the encoder's
last hidden state is the decoder's cross-attention memory.
"""

from __future__ import annotations

import torch
from torch import nn

from kindergarten_vq_vae_torch.nn.bert import BertConfig, BertLMHeadModel, BertModel


class Bagon(nn.Module):
    def __init__(self, enc_cfg: BertConfig, dec_cfg: BertConfig, device=None):
        super().__init__()
        self.encoder = BertModel(enc_cfg, device)
        self.decoder = BertLMHeadModel(dec_cfg, device)

    def forward(self, encoder_input_ids, encoder_attention_mask, decoder_input_ids,
                decoder_attention_mask, reference: bool = False, deterministic: bool = True,
                generator: torch.Generator | None = None) -> dict:
        enc = self.encoder(encoder_input_ids, encoder_attention_mask, reference=reference,
                           deterministic=deterministic, generator=generator)
        dec = self.decoder(decoder_input_ids, decoder_attention_mask,
                           encoder_hidden_states=enc["last_hidden_state"], reference=reference,
                           deterministic=deterministic, generator=generator)
        return {
            "logits": dec["logits"],
            "encoder_last_hidden_state": enc["last_hidden_state"],
            "encoder_pooler_output": enc["pooler_output"],
        }
