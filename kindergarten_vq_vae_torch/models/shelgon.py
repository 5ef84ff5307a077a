"""Shelgon: Bagon with a Gumbel-softmax latent-class bottleneck (supervised).

Counterpart of ``kindergarten_vq_vae_tpu/models/shelgon.py``:

- ``proj_in``: ``proj_in_dense`` (emb -> labels per class), then the k=1
  Conv1d over the sequence-as-channels axis, a dense along the sequence axis:
  ``einsum('bsl,cs->bcl') + bias[c]``, the ``pred_latent_logits`` (B, C, L);
- the Gumbel softmax over the label axis (tau 1, soft), its noise drawn from
  ``generator``, or the caller's ``override_latent_classes`` (the traversal
  and arithmetic hook);
- ``proj_out`` mirrors ``proj_in`` into the ``conditioning`` (B, S, E) that
  the decoder cross-attends to.

The bottleneck runs in f32, as JAX's dtype-less ``nn.Dense`` and f32 params
promote the bf16 encoder output; the conditioning enters the decoder layers
as the VQ's f32 ``z_q`` does (cast per layer, its gradient returned in f32).
Either attention mask may be None (``use_mask_encoder`` /
``use_mask_decoder`` off), which the layers take as no padding.
"""

from __future__ import annotations

import torch
from torch import nn

from kindergarten_vq_vae_torch.models.bagon import HEAD_KEYS, decoder_attentions, make_decoder
from kindergarten_vq_vae_torch.nn.bert import BertConfig, BertModel, Dense, _f32
from kindergarten_vq_vae_torch.nn.gpt2 import GPT2Config
from kindergarten_vq_vae_torch.ops.gumbel import gumbel_softmax


class Shelgon(nn.Module):
    def __init__(self, enc_cfg: BertConfig, dec_cfg: BertConfig | GPT2Config, emb_size: int = 768,
                 seq_len: int = 14, num_latent_classes: int = 5, num_labels_per_class: int = 3,
                 gumbel_tau: float = 1.0, device=None):
        super().__init__()
        self.gumbel_tau = gumbel_tau
        self.encoder = BertModel(enc_cfg, device)
        self.proj_in_dense = Dense(enc_cfg.hidden_size, num_labels_per_class, device)
        self.proj_in_conv_kernel = _f32((num_latent_classes, seq_len), device)
        self.proj_in_conv_bias = _f32((num_latent_classes,), device)
        self.proj_out_conv_kernel = _f32((seq_len, num_latent_classes), device)
        self.proj_out_conv_bias = _f32((seq_len,), device)
        self.proj_out_dense = Dense(num_labels_per_class, emb_size, device)
        self.decoder = make_decoder(dec_cfg, device)

    def proj_in(self, h: torch.Tensor) -> torch.Tensor:
        """Encoder states (B, S, E) -> latent logits (B, C, L), in f32."""
        x = self.proj_in_dense(h, torch.float32)
        return (torch.einsum("bsl,cs->bcl", x, self.proj_in_conv_kernel)
                + self.proj_in_conv_bias[None, :, None])

    def proj_out(self, classes: torch.Tensor) -> torch.Tensor:
        """Latent classes (B, C, L) -> conditioning (B, S, E), in f32."""
        y = (torch.einsum("bcl,sc->bsl", classes, self.proj_out_conv_kernel)
             + self.proj_out_conv_bias[None, :, None])
        return self.proj_out_dense(y, torch.float32)

    def bottleneck(self, h: torch.Tensor, generator: torch.Generator | None,
                   override_latent_classes=None):
        """``(pred_latent_logits, pred_latent_classes, conditioning)`` of encoder states."""
        logits = self.proj_in(h)
        if override_latent_classes is None:
            classes = gumbel_softmax(logits, self.gumbel_tau, False, -1, generator)
        else:
            classes = override_latent_classes
        return logits, classes, self.proj_out(classes)

    def forward(self, encoder_input_ids, encoder_attention_mask, decoder_input_ids,
                decoder_attention_mask, reference: bool = False, deterministic: bool = True,
                generator: torch.Generator | None = None, override_latent_classes=None,
                output_attentions: bool = False) -> dict:
        """``generator`` draws the dropout and the Gumbel noise (needed unless
        ``override_latent_classes`` is given); ``reference=True`` runs every
        kernel's plain version."""
        h = self.encoder(encoder_input_ids, encoder_attention_mask, reference=reference,
                         deterministic=deterministic, generator=generator)["last_hidden_state"]
        logits, classes, conditioning = self.bottleneck(h, generator, override_latent_classes)
        dec = self.decoder(decoder_input_ids, decoder_attention_mask,
                           encoder_hidden_states=conditioning, reference=reference,
                           deterministic=deterministic, generator=generator,
                           output_attentions=output_attentions)
        return {
            **{k: dec[k] for k in HEAD_KEYS if k in dec},
            "pred_latent_logits": logits,
            "pred_latent_classes": classes,
            "conditioning": conditioning,
            "encoder_last_hidden_state": h,
            **decoder_attentions(dec),
        }
