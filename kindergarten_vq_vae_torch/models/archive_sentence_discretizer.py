"""Archived shared-weight sentence discretizer (a superseded variant).

Counterpart of ``kindergarten_vq_vae_tpu/models/archive_sentence_discretizer.py``,
the predecessor of Shelgon2's per-factor discretizers, kept so the two
packages hold the same modules; no model uses it. One shared dense maps the
sentence embedding to the factors, each scalar factor is expanded to the
support by a shared dense, a Gumbel softmax (tau 1, soft; noise from
``generator``) runs over the support, then shared denses expand back to the
word-embedding width and (a k=1 Conv1d as a dense) to the sentence length.
In f32, as JAX's dtype-less ``nn.Dense``.
"""

from __future__ import annotations

import torch
from torch import nn

from kindergarten_vq_vae_torch.nn.bert import Dense, _f32
from kindergarten_vq_vae_torch.ops.gumbel import gumbel_softmax


class ArchiveSentenceDiscretizer(nn.Module):
    def __init__(self, word_embedding_size: int, sentence_length: int,
                 num_latent_generative_factors: int = 8, max_support_size: int = 3, device=None):
        super().__init__()
        f = num_latent_generative_factors
        self.sentence_to_latent_factors = Dense(word_embedding_size, f, device)
        self.latent_factors_expand = Dense(1, max_support_size, device)
        self.expand_word_embedding_dim = Dense(max_support_size, word_embedding_size, device)
        self.expand_sentence_length_kernel = _f32((sentence_length, f), device)
        self.expand_sentence_length_bias = _f32((sentence_length,), device)

    def forward(self, embedded_sentences, generator: torch.Generator | None = None):
        """``(latent_sentences (B, S, E), latent_factors (B, F, 3), their argmax (B, F))``."""
        latent = self.sentence_to_latent_factors(embedded_sentences, torch.float32)  # (B, F)
        latent = self.latent_factors_expand(latent[..., None], torch.float32)  # (B, F, 3)
        latent_factors = gumbel_softmax(latent, 1.0, False, -1, generator)
        sent = self.expand_word_embedding_dim(latent_factors, torch.float32)  # (B, F, E)
        latent_sentences = (torch.einsum("bfe,sf->bse", sent, self.expand_sentence_length_kernel)
                            + self.expand_sentence_length_bias[None, :, None])
        return latent_sentences, latent_factors, torch.argmax(latent_factors, dim=-1)
