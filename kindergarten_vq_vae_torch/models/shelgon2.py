"""Shelgon2: per-generative-factor discretizers on the pooled sentence embedding.

Counterpart of ``kindergarten_vq_vae_tpu/models/shelgon2.py``:

- the encoder's ``pooler_output`` (B, E) feeds one
  :class:`GenerativeFactorDiscretizer` per factor, in ``FACTOR_NAMES``
  order: ``proj_in`` (emb -> 3), the Gumbel softmax (tau 1, soft; noise
  drawn from ``generator``, one draw a factor in that order) or the
  caller's override, its argmax as the label, ``proj_out`` (3 -> emb);
- :class:`SentenceDiscretizer` stacks the factors' embeddings to (B, F, E)
  and maps factors to sentence positions with a k=1 Conv1d as a dense:
  ``einsum('bfe,sf->bse') + bias[s]``, the ``discretized_sentence`` that the
  decoder cross-attends to;
- the decoder's input ids are corrupted by ``mask_pct`` (uniform ids at
  ``floor(mask_pct * numel)`` positions) when not ``deterministic``.

``gen_factors_logits`` (B, 3, F) stacks the Gumbel samples, as JAX does.
The bottleneck runs in f32 (JAX's dtype-less ``nn.Dense`` promote the bf16
pooler output). JAX builds one model per stage with that stage's
``mask_pct``; the port's engine builds one model for every stage, so the
loss passes its stage's pct to :meth:`Shelgon2.forward`.
"""

from __future__ import annotations

import torch
from torch import nn

from kindergarten_vq_vae_torch.models.bagon import HEAD_KEYS, decoder_attentions, make_decoder
from kindergarten_vq_vae_torch.nn.bert import BertConfig, BertModel, Dense, _f32
from kindergarten_vq_vae_torch.nn.gpt2 import GPT2Config
from kindergarten_vq_vae_torch.ops.gumbel import gumbel_softmax
from kindergarten_vq_vae_torch.utils.tensor import replace_pct_rand_values

FACTOR_NAMES = (
    "gram_num_obj",
    "sentence_type",
    "gender",
    "gram_num_subject",
    "gram_num_person",
    "negation",
    "tense",
    "style",
)


class GenerativeFactorDiscretizer(nn.Module):
    def __init__(self, word_emb_size: int, gen_factor_num_values: int = 3, device=None):
        super().__init__()
        self.proj_in = Dense(word_emb_size, gen_factor_num_values, device)
        self.proj_out = Dense(gen_factor_num_values, word_emb_size, device)

    def forward(self, embedded_sentences, override_logits=None, generator=None):
        """``(recon (B, E), soft (B, 3), label (B,))``."""
        logits = self.proj_in(embedded_sentences, torch.float32)
        if override_logits is None:
            soft = gumbel_softmax(logits, 1.0, False, -1, generator)
        else:
            soft = override_logits
        label = torch.argmax(soft, dim=-1)
        return self.proj_out(soft, torch.float32), soft, label


class SentenceDiscretizer(nn.Module):
    def __init__(self, word_emb_size: int, sentence_len: int, num_latent_gen_factors: int = 8,
                 device=None):
        super().__init__()
        self.names = FACTOR_NAMES[:num_latent_gen_factors]
        for name in self.names:
            self.add_module(f"{name}_discretizer",
                            GenerativeFactorDiscretizer(word_emb_size, device=device))
        self.contract_kernel = _f32((sentence_len, num_latent_gen_factors), device)
        self.contract_bias = _f32((sentence_len,), device)

    def forward(self, embedded_sentences, overrides=None, generator=None):
        """``(discretized (B, S, E), gen_factors_logits (B, 3, F), labels (B, F))``."""
        overrides = overrides or {}
        embs, softs, labels = [], [], []
        for name in self.names:
            emb, soft, label = getattr(self, f"{name}_discretizer")(
                embedded_sentences, overrides.get(name), generator)
            embs.append(emb)
            softs.append(soft)
            labels.append(label)
        stacked = torch.stack(embs, dim=1)  # (B, F, E)
        discretized = (torch.einsum("bfe,sf->bse", stacked, self.contract_kernel)
                       + self.contract_bias[None, :, None])
        return discretized, torch.stack(softs, dim=-1), torch.stack(labels, dim=-1)


class Shelgon2(nn.Module):
    def __init__(self, enc_cfg: BertConfig, dec_cfg: BertConfig | GPT2Config,
                 word_emb_size: int = 768,
                 sentence_len: int = 14, num_latent_gen_factors: int = 8, device=None):
        super().__init__()
        self.dec_vocab_size = dec_cfg.vocab_size
        self.encoder = BertModel(enc_cfg, device)
        self.sentence_discretizer = SentenceDiscretizer(word_emb_size, sentence_len,
                                                        num_latent_gen_factors, device)
        self.decoder = make_decoder(dec_cfg, device)

    def forward(self, input_ids, attention_mask, reference: bool = False,
                deterministic: bool = True, generator: torch.Generator | None = None,
                overrides=None, mask_pct: float = 0.0, output_attentions: bool = False) -> dict:
        """``generator`` draws the dropout, the Gumbel noise of each factor
        without an override in ``overrides`` ({factor name: (B, 3)}) and, with
        ``mask_pct > 0`` and not ``deterministic``, the decoder input's
        corruption; ``reference=True`` runs every kernel's plain version."""
        pooled = self.encoder(input_ids, attention_mask, reference=reference,
                              deterministic=deterministic, generator=generator)["pooler_output"]
        discretized, gen_logits, gen_labels = self.sentence_discretizer(pooled, overrides,
                                                                        generator)
        decoder_input_ids = input_ids
        if mask_pct > 0.0 and not deterministic:
            decoder_input_ids = replace_pct_rand_values(input_ids, mask_pct, 0,
                                                        self.dec_vocab_size, generator)
        dec = self.decoder(decoder_input_ids, attention_mask, encoder_hidden_states=discretized,
                           reference=reference, deterministic=deterministic, generator=generator,
                           output_attentions=output_attentions)
        return {
            **{k: dec[k] for k in HEAD_KEYS if k in dec},
            "gen_factors_logits": gen_logits,
            "gen_factors_labels": gen_labels,
            "discretized_sentence": discretized,
            "encoder_pooler_output": pooled,
            **decoder_attentions(dec),
        }
