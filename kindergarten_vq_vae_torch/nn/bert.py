"""BERT encoder and BERT-LM-head decoder with cross-attention.

Counterpart of ``kindergarten_vq_vae_tpu/nn/bert.py`` on both of its trunk
routes. With ``cfg.fused_layer`` (the fused-trunk path, ``_fused_trunk``
l.366-466): embeddings + LayerNorm (+ dropout), one
:func:`~kindergarten_vq_vae_torch.ops.layer.fused_bert_layer` call per layer.
Without it, or when attention probabilities are asked for (l.564-581): the
per-module layers ``BertSelfAttention`` / ``BertCrossAttention`` / ``BertMlp``
(l.155-250), whose projections are plain matmuls and whose attention core is
:func:`~kindergarten_vq_vae_torch.ops.sdpa.fused_sdpa` (kernels #11 / #12)
when ``cfg.fused_sdpa`` is set and probabilities are not asked for, else the
einsum route (l.134-140). Then the pooler, and the MLM head with the tied
2-D vocab matmul or, with ``fused_head`` (l.602-611 and l.659-666), its
transform alone.

The per-module layers keep the flax modules' rounding points: each
``Dense`` gives its output in the compute dtype, residual sums are in the
compute dtype, GELU runs in f32 and is cast back, and on the einsum route
the scores, their scaling and the bias add are in the compute dtype with
the softmax in f32.

Training (``deterministic=False``) draws one int32 seed per fused layer, or
per SDPA attention module, from an explicit :class:`torch.Generator` over
the int32 range, all of a trunk's seeds in one draw, as ``_fused_trunk``
l.398-408 and ``_sdpa_seed`` l.143-152 draw them from the flax RNG;
``deterministic=True`` gives zero seeds and zero rates. The other dropout
sites (the embeddings l.125, the per-module layers' hidden sites and the
einsum route's probabilities) are flax-RNG dropout in JAX and cannot be
reproduced; the port draws their masks from the same generator. Under a
device mesh (a loss function's
:func:`~kindergarten_vq_vae_torch.parallel.mesh.use_mesh`) the trunk runs on
the rank's rows with whole weights: the seeds are drawn as above and then
folded with the dp index, as JAX's ``_fused_trunk_sharded`` folds the fused
trunk's (l.513-519); JAX's per-module route runs on global rows under GSPMD
and folds nothing, a recorded divergence; the masks are the rank's rows of
a draw at the global shape. Gradients
reach the embeddings, the MLM head and the tied table through autograd, the
fused layers through
:class:`~kindergarten_vq_vae_torch.ops.layer.FusedBertLayer` and the SDPA
core through :class:`~kindergarten_vq_vae_torch.ops.sdpa.FusedSdpa`.

Parameters keep the Flax names and layouts (``Dense.kernel`` is ``(in, out)``,
``LayerNorm.scale``), the same tree on both routes, so the state dict of a
module here is the Flax param tree with '.' for '/'. Parameters are f32;
every forward computes in ``cfg.dtype``, casting matmul kernels to it as the
JAX trunk does, while biases and LayerNorm parameters stay f32 inside the
fused layers.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from kindergarten_vq_vae_torch.ops.layer import (
    DEC_WEIGHTS,
    ENC_WEIGHTS,
    LayerGeom,
    fused_bert_layer,
)
from kindergarten_vq_vae_torch.ops.sdpa import fused_sdpa
from kindergarten_vq_vae_torch.parallel.mesh import fold_active, global_draw

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
NEG_INF = -1e9  # finite mask value, as the JAX package's


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
    # the decoder returns the MLM transform's output, the tied table and the
    # head bias for the fused head + CE (ops/head_ce.py) instead of logits
    fused_head: bool = False
    # the trunk's route: the whole-layer kernels (#1 / #2), or with
    # fused_layer off the per-module layers, whose attention core is #11 /
    # #12 with fused_sdpa and the einsum route without it
    fused_layer: bool = True
    fused_sdpa: bool = True
    dtype: torch.dtype = torch.float32  # compute dtype; parameters are always f32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, kept values
    divided by it, in x's dtype; the mask is drawn from ``generator`` (at the
    global batch's shape under a mesh:
    :func:`~kindergarten_vq_vae_torch.parallel.mesh.global_draw`)."""
    keep = global_draw(x.shape, lambda shape: torch.rand(
        shape, generator=generator, device=x.device)) >= rate
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


@dataclasses.dataclass(frozen=True)
class _Run:
    """What one per-module trunk call hands its modules."""

    cfg: BertConfig
    attn_rate: float
    hid_rate: float
    generator: torch.Generator | None
    output_attentions: bool
    reference: bool

    @property
    def sdpa(self) -> bool:
        """The attention core is #11 / #12 (JAX l.167, l.209)."""
        return self.cfg.fused_sdpa and not self.output_attentions

    def hidden_dropout(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.hid_rate, self.generator) if self.hid_rate > 0.0 else x


def _attention_probs(q, k, bias, dtype) -> torch.Tensor:
    """``_attention_probs`` (JAX l.134-140): q, k (B, S, nh, hd) in the
    compute dtype; the scores, their ``/ sqrt(hd)`` and the bias add in it,
    the softmax in f32, the probabilities (B, nh, S_q, S_k) cast back."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.new_tensor(math.sqrt(q.shape[-1]))
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    return torch.softmax(scores.float(), dim=-1).to(dtype)


def _einsum_attention(q, k, v, bias, run: _Run):
    """The einsum route: (context (B, S_q, H), probabilities before dropout)."""
    cfg = run.cfg
    nh, hd = cfg.num_heads, cfg.head_dim
    (b, sq, h), sk = q.shape, k.shape[1]
    probs = _attention_probs(q.reshape(b, sq, nh, hd), k.reshape(b, sk, nh, hd), bias, cfg.dtype)
    dropped = dropout(probs, run.attn_rate, run.generator) if run.attn_rate > 0.0 else probs
    ctx = torch.einsum("bhqk,bkhd->bqhd", dropped, v.reshape(b, sk, nh, hd))
    return ctx.reshape(b, sq, h), probs


class _Block(nn.Module):
    """A parameter container: ``_Block(qkv=Dense(...), ...)``."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


class BertSelfAttention(_Block):
    """Fused-QKV self-attention, causal in a decoder (JAX l.155-193)."""

    def forward(self, x, mask, seed: int, run: _Run):
        cfg, dtype = run.cfg, run.cfg.dtype
        q, k, v = self.qkv(x, dtype).split(cfg.hidden_size, dim=-1)
        probs = None
        if run.sdpa:
            ctx = fused_sdpa(q, k, v, mask, seed, cfg.num_heads, causal=cfg.is_decoder,
                             rate=run.attn_rate, reference=run.reference)
        else:
            s = x.shape[1]
            bias = torch.zeros((1, 1, s, s), dtype=dtype, device=x.device)
            if mask is not None:
                bias = bias + (1.0 - mask[:, None, None, :].to(dtype)) * NEG_INF
            if cfg.is_decoder:
                causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
                bias = bias + torch.where(causal, 0.0, NEG_INF)[None, None].to(dtype)
            ctx, probs = _einsum_attention(q, k, v, bias, run)
        out = run.hidden_dropout(self.out(ctx, dtype))
        return self.layer_norm(x + out, dtype), probs


class BertCrossAttention(_Block):
    """Queries from the decoder states, fused KV from the encoder states (JAX l.196-234)."""

    def forward(self, x, kv_states, mask, seed: int, run: _Run):
        cfg, dtype = run.cfg, run.cfg.dtype
        q = self.q(x, dtype)
        k, v = self.kv(kv_states, dtype).split(cfg.hidden_size, dim=-1)
        probs = None
        if run.sdpa:
            ctx = fused_sdpa(q, k, v, mask, seed, cfg.num_heads, rate=run.attn_rate,
                             reference=run.reference, cross=True)
        else:
            bias = None if mask is None else (1.0 - mask[:, None, None, :].to(dtype)) * NEG_INF
            ctx, probs = _einsum_attention(q, k, v, bias, run)
        out = run.hidden_dropout(self.out(ctx, dtype))
        return self.layer_norm(x + out, dtype), probs


class BertMlp(_Block):
    """Dense + GELU + Dense, residual, LayerNorm (JAX l.237-250)."""

    def forward(self, x, run: _Run):
        cfg, dtype = run.cfg, run.cfg.dtype
        y = self.intermediate(x, dtype)
        y = F.gelu(y.float(), approximate="none" if cfg.gelu_exact else "tanh").to(dtype)
        y = run.hidden_dropout(self.output(y, dtype))
        return self.layer_norm(x + y, dtype)


class BertLayer(nn.Module):
    """One post-LN layer under the Flax names: the per-module forward here,
    or its flat weights for the fused kernels of
    :mod:`kindergarten_vq_vae_torch.ops.layer`."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        h, f, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.self_attn = BertSelfAttention(qkv=Dense(h, 3 * h, device), out=Dense(h, h, device),
                                           layer_norm=LayerNorm(h, eps, device))
        if cfg.add_cross_attention:
            self.cross_attn = BertCrossAttention(q=Dense(h, h, device), kv=Dense(h, 2 * h, device),
                                                 out=Dense(h, h, device),
                                                 layer_norm=LayerNorm(h, eps, device))
        self.mlp = BertMlp(intermediate=Dense(h, f, device), output=Dense(f, h, device),
                           layer_norm=LayerNorm(h, eps, device))

    def forward(self, x, enc, smask, cmask, seeds: tuple[int, int], run: _Run):
        """(x, self-attention probabilities, cross-attention probabilities);
        the probabilities are None on the SDPA route and without cross-attention."""
        x, self_probs = self.self_attn(x, smask, seeds[0], run)
        cross_probs = None
        if enc is not None:
            x, cross_probs = self.cross_attn(x, enc, cmask, seeds[1], run)
        return self.mlp(x, run), self_probs, cross_probs

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


def _seeds(n: int, generator: torch.Generator) -> list[int]:
    """``n`` int32 seeds in one draw and one host copy; under a mesh with dp
    ranks folded with the dp index (``_fused_trunk_sharded`` l.513-519: the
    kernels hash local row ids, which repeat on every rank)."""
    return fold_active(torch.randint(INT32_MIN, INT32_MAX, (n,), generator=generator,
                                     device=generator.device, dtype=torch.int64).tolist())


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
                generator: torch.Generator | None = None, output_attentions: bool = False) -> dict:
        """``reference=True`` runs the kernels' plain versions on any device
        (the comparison baseline); otherwise CUDA tensors go through the
        layer kernels or, on the per-module route, the SDPA kernels.
        ``deterministic=False`` turns dropout on and needs ``generator`` (on
        the inputs' device). ``output_attentions`` takes the per-module einsum
        route and adds ``attentions`` / ``cross_attentions``: per layer the
        (B, nh, S_q, S_k) probabilities before dropout, in the compute dtype
        (None for cross-attention in an encoder), as JAX l.564-591 does."""
        cfg = self.cfg
        dtype = cfg.dtype
        drop = not deterministic and (cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0)
        if drop and generator is None:
            raise ValueError("dropout (deterministic=False) needs a torch.Generator")
        hid_rate = cfg.hidden_dropout if drop else 0.0
        attn_rate = cfg.attention_dropout if drop else 0.0
        x = self.embeddings(input_ids, dtype, hid_rate, generator)
        has_cross = cfg.add_cross_attention and encoder_hidden_states is not None
        smask = None if attention_mask is None else attention_mask.to(torch.int32).contiguous()
        cmask = None
        if has_cross and encoder_attention_mask is not None:
            cmask = encoder_attention_mask.to(torch.int32).contiguous()
        layers = [getattr(self, f"layer_{i}") for i in range(cfg.num_layers)]
        out = {}
        if cfg.fused_layer and not output_attentions:
            geom = LayerGeom(
                num_heads=cfg.num_heads, head_dim=cfg.head_dim, intermediate=cfg.intermediate_size,
                causal=cfg.is_decoder, has_cross=has_cross, eps=cfg.layer_norm_eps,
                gelu_exact=cfg.gelu_exact, attn_rate=attn_rate, hid_rate=hid_rate,
            )
            seeds = _seeds(cfg.num_layers, generator) if drop else [0] * cfg.num_layers
            enc = None
            if has_cross:
                # the f32 VQ output enters the decoder layers in the compute dtype,
                # as layer_pallas.py:861 casts it; under autograd each layer casts
                # it and returns its gradient in the f32 it came in
                enc = encoder_hidden_states.contiguous()
                if not (torch.is_grad_enabled() and enc.requires_grad):
                    enc = enc.to(dtype)
            for layer, seed in zip(layers, seeds):
                x = fused_bert_layer(geom, x, enc, smask, cmask, layer.weights(dtype, has_cross),
                                     seed, reference=reference)
        else:
            run = _Run(cfg, attn_rate, hid_rate, generator, output_attentions, reference)
            n = cfg.num_layers * (2 if has_cross else 1)
            seeds = _seeds(n, generator) if run.sdpa and attn_rate > 0.0 else [0] * n
            enc = encoder_hidden_states if has_cross else None
            self_attns, cross_attns = [], []
            for i, layer in enumerate(layers):
                pair = (seeds[2 * i], seeds[2 * i + 1]) if has_cross else (seeds[i], 0)
                x, sp, cp = layer(x, enc, smask, cmask, pair, run)
                self_attns.append(sp)
                cross_attns.append(cp)
            if output_attentions:
                out.update(attentions=tuple(self_attns), cross_attentions=tuple(cross_attns))
        pooled = torch.tanh(self.pooler(x[:, 0], dtype)) if cfg.add_pooler else None
        return {"last_hidden_state": x, "pooler_output": pooled, **out}


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

    def forward(self, x: torch.Tensor, word_embedding_table: torch.Tensor, project: bool = True):
        """The (B, S, V) logits; with ``project=False`` the transformed hidden
        states and the f32 bias instead (the fused head + CE projects)."""
        cfg, dtype = self.cfg, self.cfg.dtype
        x = self.transform_dense(x, dtype)
        x = F.gelu(x.float(), approximate="none" if cfg.gelu_exact else "tanh").to(dtype)
        x = self.transform_layer_norm(x, dtype)
        if not project:
            return x, self.decoder_bias
        kernel = word_embedding_table.T if cfg.tie_word_embeddings else self.decoder_kernel
        # the vocab projection as one 2-D matmul over all rows
        b, s, h = x.shape
        logits = x.reshape(b * s, h) @ kernel.to(dtype) + self.decoder_bias.to(dtype)
        return logits.reshape(b, s, cfg.vocab_size)


class BertLMHeadModel(nn.Module):
    """BertModel (no pooler) + MLM head: the decoder of the encoder-decoder
    pair. Its output holds ``logits``, or with ``cfg.fused_head``
    ``mlm_hidden``, ``head_table`` (the f32 tied table) and ``head_bias``;
    the parameters are the same either way."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        cfg = dataclasses.replace(cfg, add_pooler=False)
        self.bert = BertModel(cfg, device)
        self.mlm_head = BertMLMHead(cfg, device)

    def forward(self, input_ids, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None, reference: bool = False, deterministic: bool = True,
                generator: torch.Generator | None = None, output_attentions: bool = False) -> dict:
        out = self.bert(input_ids, attention_mask, encoder_hidden_states,
                        encoder_attention_mask, reference=reference, deterministic=deterministic,
                        generator=generator, output_attentions=output_attentions)
        table = self.bert.embeddings.word_embeddings.embedding
        if self.mlm_head.cfg.fused_head:
            if not self.mlm_head.cfg.tie_word_embeddings:
                raise ValueError("fused_head needs the tied word table")
            out["mlm_hidden"], out["head_bias"] = self.mlm_head(out["last_hidden_state"], table,
                                                                project=False)
            out["head_table"] = table
        else:
            out["logits"] = self.mlm_head(out["last_hidden_state"], table)
        return out
