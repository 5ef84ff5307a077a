"""Shelgon3: BERT encoder, codebook bottleneck, BERT-LM-head (or GPT-2) decoder.

Counterpart of ``kindergarten_vq_vae_tpu/models/shelgon3.py`` l.62-228: the
encoder output is quantized and the decoder cross-attends to ``z_q``.

- ``vq_mode="VectorQuantizer"``: against the codebook; gradients reach the
  encoder and the codebook through the VQ's custom VJP
  (:class:`~kindergarten_vq_vae_torch.ops.vq.VQCore`). CUDA tensors always
  take the VQ kernel: the JAX package's row threshold
  (``VQ_FUSED_MAX_ROWS``) was interpolated on a TPU and does not carry over.
- ``vq_mode="GumbelQuantizer"`` (l.102-127, l.188-203): a Gumbel-softmax
  mix of a ``normal(0.02)`` codebook in f32 (JAX's dtype-less params promote
  the bf16 encoder output), its noise drawn from ``generator``
  (:mod:`~kindergarten_vq_vae_torch.ops.gumbel`); ``is_training`` steers it
  (hard outside training); the perplexity is the count of distinct codes
  and ``ema_stats`` is None.

Under a device mesh with dp ranks (a loss function's
:func:`~kindergarten_vq_vae_torch.parallel.mesh.use_mesh`) the batch is the
rank's rows: the VQ takes its data-parallel form (the statistics summed
over dp, :func:`~kindergarten_vq_vae_torch.ops.vq.assemble`; JAX l.86-98),
and the Gumbel regulariser and code count are the global batch's.

``deterministic`` and ``is_training`` mean what they mean in the JAX module.
"""

from __future__ import annotations

import torch
from torch import nn

from kindergarten_vq_vae_torch.models.bagon import HEAD_KEYS, decoder_attentions, make_decoder
from kindergarten_vq_vae_torch.nn.bert import BertConfig, BertModel, _f32
from kindergarten_vq_vae_torch.nn.gpt2 import GPT2Config
from kindergarten_vq_vae_torch.ops.gumbel import (
    GumbelQuantizeOutput,
    gumbel_quantize,
    unique_count_perplexity,
)
from kindergarten_vq_vae_torch.ops.vq import VQOutput, vector_quantize
from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel
from kindergarten_vq_vae_torch.parallel.mesh import dp_mean


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


class GumbelQuantizer(nn.Module):
    """``proj_kernel`` (E, n_embed), ``proj_bias``, ``codebook`` (n_embed, D), f32."""

    def __init__(self, enc_out_size: int, n_embed: int, embedding_dim: int, temperature: float,
                 kl_div_scale: float, straight_through: bool, device=None):
        super().__init__()
        self.temperature, self.kl_div_scale = temperature, kl_div_scale
        self.straight_through = straight_through
        self.proj_kernel = _f32((enc_out_size, n_embed), device)
        self.proj_bias = _f32((n_embed,), device)
        self.codebook = _f32((n_embed, embedding_dim), device)

    def forward(self, z: torch.Tensor, is_training: bool,
                generator: torch.Generator | None) -> GumbelQuantizeOutput:
        return gumbel_quantize(z.float(), self.proj_kernel, self.proj_bias, self.codebook,
                               self.temperature, self.kl_div_scale, self.straight_through,
                               is_training, generator)


class Shelgon3(nn.Module):
    def __init__(self, enc_cfg: BertConfig, dec_cfg: BertConfig | GPT2Config,
                 vq_mode: str = "VectorQuantizer",
                 vq_n_e: int = 9, vq_e_dim: int = 768, vq_beta: float = 0.69,
                 vq_temperature: float = 1.0, vq_kl_div_scale: float = 5e-4,
                 vq_straight_through: bool = False, vq_ema_update: bool = False, device=None):
        super().__init__()
        if enc_cfg.hidden_size != vq_e_dim:
            raise ValueError("embedding dim of encoder output must match e_dim")
        self.vq_mode, self.vq_n_e = vq_mode, vq_n_e
        self.encoder = BertModel(enc_cfg, device)
        if vq_mode == "VectorQuantizer":
            self.vector_quantizer = VectorQuantizer(vq_n_e, vq_e_dim, vq_beta, vq_ema_update,
                                                    device)
        elif vq_mode == "GumbelQuantizer":
            self.gumbel_quantizer = GumbelQuantizer(enc_cfg.hidden_size, vq_n_e, vq_e_dim,
                                                    vq_temperature, vq_kl_div_scale,
                                                    vq_straight_through, device)
        else:
            raise ValueError(f"{vq_mode} vector quantizer mode NOT supported")
        self.decoder = make_decoder(dec_cfg, device)

    def forward(self, input_ids, attention_mask, reference: bool = False,
                deterministic: bool = True, is_training: bool = False,
                generator: torch.Generator | None = None, decoder_input_ids=None,
                output_attentions: bool = False) -> dict:
        """The same ids feed encoder and decoder (the reference's forward),
        unless ``decoder_input_ids`` (the perturbed ids of the JAX package's
        opt-in decoder perturbation, l.156-161) feed the decoder.
        ``reference=True`` runs every kernel's plain version instead;
        ``deterministic=False`` turns dropout on, drawn from ``generator``,
        which also draws the Gumbel quantizer's noise;
        ``output_attentions`` adds the decoder's ``decoder_attentions`` /
        ``decoder_cross_attentions`` (l.225-227)."""
        embeds = self.encoder(input_ids, attention_mask, reference=reference,
                              deterministic=deterministic, generator=generator)["last_hidden_state"]
        if self.vq_mode == "VectorQuantizer":
            vq = self.vector_quantizer(embeds, reference)
            z_q, vq_loss, perplexity, indices = vq.z_q, vq.loss, vq.perplexity, vq.indices
            ema_stats = {"counts": vq.counts, "sum_z": vq.sum_z}
        else:
            gq = self.gumbel_quantizer(embeds, is_training, generator)
            (diff,) = dp_mean(gq.diff)
            z_q, vq_loss, indices, ema_stats = gq.z_q, diff, gq.indices[..., None], None
            perplexity = unique_count_perplexity(gq.indices, self.vq_n_e)
        dec_ids = input_ids if decoder_input_ids is None else decoder_input_ids
        dec = self.decoder(dec_ids, attention_mask, encoder_hidden_states=z_q,
                           reference=reference, deterministic=deterministic, generator=generator,
                           output_attentions=output_attentions)
        return {
            **{k: dec[k] for k in HEAD_KEYS if k in dec},
            "vq_loss": vq_loss,
            "perplexity": perplexity,
            "min_encoding_indices": indices,
            "z_q": z_q,
            "encoder_last_hidden_state": embeds,
            "ema_stats": ema_stats,
            **decoder_attentions(dec),
        }
