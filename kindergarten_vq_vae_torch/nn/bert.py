"""BERT encoder and BERT-LM-head decoder with cross-attention.

Counterpart of ``kindergarten_vq_vae_tpu/nn/bert.py`` on its fused-trunk
path (``_fused_trunk`` l.366-466): embeddings + LayerNorm (+ dropout), one
:func:`~kindergarten_vq_vae_torch.ops.layer.fused_bert_layer` call per layer,
the pooler, and the MLM head with the tied 2-D vocab matmul.

Training (``deterministic=False``) draws one int32 seed per layer for the
layers' hash dropout from an explicit :class:`torch.Generator` over the
int32 range, as ``_fused_trunk`` l.398-408 draws them from the flax RNG;
``deterministic=True`` gives zero seeds and zero rates. The embedding
dropout (l.125) is flax-RNG dropout in JAX and cannot be reproduced; the
port draws its mask from the same generator. Gradients reach the
embeddings, the MLM head and the tied table through autograd, and the
layers through :class:`~kindergarten_vq_vae_torch.ops.layer.FusedBertLayer`.

Parameters keep the Flax names and layouts (``Dense.kernel`` is ``(in, out)``,
``LayerNorm.scale``), so the state dict of a module here is the Flax param
tree with '.' for '/'. Parameters are f32; every forward computes in
``cfg.dtype``, casting matmul kernels to it as the JAX trunk does, while
biases and LayerNorm parameters stay f32 inside the layers.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from kindergarten_vq_vae_torch.ops.layer import (
    DEC_WEIGHTS,
    ENC_WEIGHTS,
    LayerGeom,
    fused_bert_layer,
)

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    is_decoder: bool = False
    add_cross_attention: bool = False
    add_pooler: bool = True
    tie_word_embeddings: bool = True
    gelu_exact: bool = True
    dtype: torch.dtype = torch.float32  # compute dtype; parameters are always f32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, kept values
    divided by it, in x's dtype; the mask is drawn from ``generator``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _f32(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)``: ``x @ kernel + bias`` in the compute dtype."""

    def __init__(self, fin: int, fout: int, device=None):
        super().__init__()
        self.kernel = _f32((fin, fout), device)
        self.bias = _f32((fout,), device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return torch.matmul(x.to(dtype), self.kernel.to(dtype)) + self.bias.to(dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics with the fast variance."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _f32((dim,), device)
        self.bias = _f32((dim,), device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
        y = (x - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(dtype)


class Embed(nn.Module):
    def __init__(self, num: int, dim: int, device=None):
        super().__init__()
        self.embedding = _f32((num, dim), device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, device)
        self.position_embeddings = _f32((cfg.max_position_embeddings, cfg.hidden_size), device)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, cfg.hidden_size, device)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)

    def forward(self, input_ids: torch.Tensor, dtype: torch.dtype, rate: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        seq_len = input_ids.shape[1]
        tok_type = self.token_type_embeddings(torch.zeros_like(input_ids))
        x = self.word_embeddings(input_ids) + self.position_embeddings[None, :seq_len] + tok_type
        x = self.layer_norm(x, dtype)
        return dropout(x, rate, generator) if rate > 0.0 else x


class _Block(nn.Module):
    """A parameter container: ``_Block(qkv=Dense(...), ...)``."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


class BertLayer(nn.Module):
    """Parameters of one post-LN layer under the Flax names; the math is in
    :mod:`kindergarten_vq_vae_torch.ops.layer`."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        h, f, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.self_attn = _Block(qkv=Dense(h, 3 * h, device), out=Dense(h, h, device),
                                layer_norm=LayerNorm(h, eps, device))
        if cfg.add_cross_attention:
            self.cross_attn = _Block(q=Dense(h, h, device), kv=Dense(h, 2 * h, device),
                                     out=Dense(h, h, device), layer_norm=LayerNorm(h, eps, device))
        self.mlp = _Block(intermediate=Dense(h, f, device), output=Dense(f, h, device),
                          layer_norm=LayerNorm(h, eps, device))

    def weights(self, dtype: torch.dtype, use_cross: bool) -> tuple[torch.Tensor, ...]:
        """Flat weights in ENC_WEIGHTS / DEC_WEIGHTS order, matmul kernels in ``dtype``."""
        sa, mlp = self.self_attn, self.mlp
        ws = [sa.qkv.kernel, sa.qkv.bias, sa.out.kernel, sa.out.bias,
              sa.layer_norm.scale, sa.layer_norm.bias]
        if use_cross:
            ca = self.cross_attn
            ws += [ca.q.kernel, ca.q.bias, ca.kv.kernel, ca.kv.bias, ca.out.kernel, ca.out.bias,
                   ca.layer_norm.scale, ca.layer_norm.bias]
        ws += [mlp.intermediate.kernel, mlp.intermediate.bias, mlp.output.kernel, mlp.output.bias,
               mlp.layer_norm.scale, mlp.layer_norm.bias]
        names = DEC_WEIGHTS if use_cross else ENC_WEIGHTS
        return tuple(w.to(dtype) if n.startswith("w") else w for n, w in zip(names, ws))


class BertModel(nn.Module):
    """BERT trunk. Encoder mode: ``last_hidden_state`` and ``pooler_output``.
    Decoder mode (``is_decoder`` + ``add_cross_attention``): causal
    self-attention and per-layer cross-attention onto ``encoder_hidden_states``."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, device))
        if cfg.add_pooler:
            self.pooler = Dense(cfg.hidden_size, cfg.hidden_size, device)

    def forward(self, input_ids, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None, reference: bool = False, deterministic: bool = True,
                generator: torch.Generator | None = None) -> dict:
        """``reference=True`` runs the layers' plain version on any device
        (the kernel's comparison baseline); otherwise CUDA tensors go through
        the layer kernels. ``deterministic=False`` turns dropout on and needs
        ``generator`` (on the inputs' device)."""
        cfg = self.cfg
        dtype = cfg.dtype
        drop = not deterministic and (cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0)
        if drop and generator is None:
            raise ValueError("dropout (deterministic=False) needs a torch.Generator")
        hid_rate = cfg.hidden_dropout if drop else 0.0
        attn_rate = cfg.attention_dropout if drop else 0.0
        x = self.embeddings(input_ids, dtype, hid_rate, generator)
        has_cross = cfg.add_cross_attention and encoder_hidden_states is not None
        geom = LayerGeom(
            num_heads=cfg.num_heads, head_dim=cfg.head_dim, intermediate=cfg.intermediate_size,
            causal=cfg.is_decoder, has_cross=has_cross, eps=cfg.layer_norm_eps,
            gelu_exact=cfg.gelu_exact, attn_rate=attn_rate, hid_rate=hid_rate,
        )
        seeds = [0] * cfg.num_layers
        if drop:
            seeds = torch.randint(INT32_MIN, INT32_MAX, (cfg.num_layers,), generator=generator,
                                  device=generator.device, dtype=torch.int64).tolist()
        enc = None
        if has_cross:
            # the f32 VQ output enters the decoder layers in the compute dtype,
            # as layer_pallas.py:861 casts it; under autograd each layer casts
            # it and returns its gradient in the f32 it came in
            enc = encoder_hidden_states.contiguous()
            if not (torch.is_grad_enabled() and enc.requires_grad):
                enc = enc.to(dtype)
        smask = None if attention_mask is None else attention_mask.to(torch.int32).contiguous()
        cmask = None
        if has_cross and encoder_attention_mask is not None:
            cmask = encoder_attention_mask.to(torch.int32).contiguous()
        for i in range(cfg.num_layers):
            ws = getattr(self, f"layer_{i}").weights(dtype, has_cross)
            x = fused_bert_layer(geom, x, enc, smask, cmask, ws, seeds[i], reference=reference)
        pooled = torch.tanh(self.pooler(x[:, 0], dtype)) if cfg.add_pooler else None
        return {"last_hidden_state": x, "pooler_output": pooled}


class BertMLMHead(nn.Module):
    """HF ``cls.predictions``: dense + GELU + LayerNorm, then the vocab
    projection (tied to the word-embedding table when configured)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.transform_dense = Dense(cfg.hidden_size, cfg.hidden_size, device)
        self.transform_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.decoder_bias = _f32((cfg.vocab_size,), device)
        if not cfg.tie_word_embeddings:
            self.decoder_kernel = _f32((cfg.hidden_size, cfg.vocab_size), device)

    def forward(self, x: torch.Tensor, word_embedding_table: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.cfg, self.cfg.dtype
        x = self.transform_dense(x, dtype)
        x = F.gelu(x.float(), approximate="none" if cfg.gelu_exact else "tanh").to(dtype)
        x = self.transform_layer_norm(x, dtype)
        kernel = word_embedding_table.T if cfg.tie_word_embeddings else self.decoder_kernel
        # the vocab projection as one 2-D matmul over all rows
        b, s, h = x.shape
        logits = x.reshape(b * s, h) @ kernel.to(dtype) + self.decoder_bias.to(dtype)
        return logits.reshape(b, s, cfg.vocab_size)


class BertLMHeadModel(nn.Module):
    """BertModel (no pooler) + MLM head: the decoder of the encoder-decoder pair."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        cfg = dataclasses.replace(cfg, add_pooler=False)
        self.bert = BertModel(cfg, device)
        self.mlm_head = BertMLMHead(cfg, device)

    def forward(self, input_ids, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None, reference: bool = False, deterministic: bool = True,
                generator: torch.Generator | None = None) -> dict:
        out = self.bert(input_ids, attention_mask, encoder_hidden_states,
                        encoder_attention_mask, reference=reference, deterministic=deterministic,
                        generator=generator)
        table = self.bert.embeddings.word_embeddings.embedding
        out["logits"] = self.mlm_head(out["last_hidden_state"], table)
        return out
