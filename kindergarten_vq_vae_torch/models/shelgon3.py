"""Shelgon3: BERT encoder, VQ codebook bottleneck, BERT-LM-head decoder.

Counterpart of ``kindergarten_vq_vae_tpu/models/shelgon3.py`` l.62-99 and
l.130-228, VectorQuantizer mode: the encoder output is quantized against
the codebook and the decoder cross-attends to ``z_q``; gradients reach the
encoder and the codebook through the VQ's custom VJP
(:class:`~kindergarten_vq_vae_torch.ops.vq.VQCore`). ``deterministic`` and
``is_training`` mean what they mean in the JAX module (``is_training`` only
steers the Gumbel quantizer there, which the port does not have yet).
CUDA tensors always take the VQ kernel: the JAX package's row threshold
(``VQ_FUSED_MAX_ROWS``) was interpolated on a TPU and does not carry over.
"""

from __future__ import annotations

import torch
from torch import nn

from kindergarten_vq_vae_torch.models.bagon import HEAD_KEYS
from kindergarten_vq_vae_torch.nn.bert import BertConfig, BertLMHeadModel, BertModel
from kindergarten_vq_vae_torch.ops.vq import VQOutput, vector_quantize
from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel


class VectorQuantizer(nn.Module):
    def __init__(self, n_e: int, e_dim: int, beta: float, ema_update: bool = False, device=None):
        super().__init__()
        self.n_e, self.beta, self.ema_update = n_e, beta, ema_update
        self.codebook = nn.Parameter(torch.empty((n_e, e_dim), dtype=torch.float32, device=device))

    def forward(self, z: torch.Tensor, reference: bool = False) -> VQOutput:
        quantize = vector_quantize if reference else vector_quantize_kernel
        # under the EMA update the codebook takes no gradient (the engine
        # overwrites it from the batch statistics), as in JAX (l.83-85)
        codebook = self.codebook.detach() if self.ema_update else self.codebook
        return quantize(z.float().contiguous(), codebook, self.beta)


class Shelgon3(nn.Module):
    def __init__(self, enc_cfg: BertConfig, dec_cfg: BertConfig, vq_mode: str = "VectorQuantizer",
                 vq_n_e: int = 9, vq_e_dim: int = 768, vq_beta: float = 0.69,
                 vq_ema_update: bool = False, device=None):
        super().__init__()
        if vq_mode != "VectorQuantizer":
            raise NotImplementedError(
                f"vq_mode={vq_mode!r} is not ported yet (ROADMAP, modules to port: "
                "item 7, ops/gumbel.py and the GumbelQuantizer)")
        if enc_cfg.hidden_size != vq_e_dim:
            raise ValueError("embedding dim of encoder output must match e_dim")
        self.encoder = BertModel(enc_cfg, device)
        self.vector_quantizer = VectorQuantizer(vq_n_e, vq_e_dim, vq_beta, vq_ema_update, device)
        self.decoder = BertLMHeadModel(dec_cfg, device)

    def forward(self, input_ids, attention_mask, reference: bool = False,
                deterministic: bool = True, is_training: bool = False,
                generator: torch.Generator | None = None, decoder_input_ids=None) -> dict:
        """The same ids feed encoder and decoder (the reference's forward),
        unless ``decoder_input_ids`` (the perturbed ids of the JAX package's
        opt-in decoder perturbation, l.156-161) feed the decoder.
        ``reference=True`` runs every kernel's plain version instead;
        ``deterministic=False`` turns dropout on, drawn from ``generator``."""
        del is_training  # steers only the Gumbel quantizer
        embeds = self.encoder(input_ids, attention_mask, reference=reference,
                              deterministic=deterministic, generator=generator)["last_hidden_state"]
        vq = self.vector_quantizer(embeds, reference)
        dec_ids = input_ids if decoder_input_ids is None else decoder_input_ids
        dec = self.decoder(dec_ids, attention_mask, encoder_hidden_states=vq.z_q,
                           reference=reference, deterministic=deterministic, generator=generator)
        return {
            **{k: dec[k] for k in HEAD_KEYS if k in dec},
            "vq_loss": vq.loss,
            "perplexity": vq.perplexity,
            "min_encoding_indices": vq.indices,
            "z_q": vq.z_q,
            "encoder_last_hidden_state": embeds,
            "ema_stats": {"counts": vq.counts, "sum_z": vq.sum_z},
        }
