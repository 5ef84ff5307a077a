"""GPT-2 LM with cross-attention: the decoder option of the encoder-decoder pair.

Counterpart of ``kindergarten_vq_vae_tpu/nn/gpt2.py``, the HF
``GPT2LMHeadModel(add_cross_attention=True)`` architecture:

- pre-LN blocks: ``ln_1`` -> causal self-attention (a fused ``c_attn``,
  H -> 3H) -> ``c_proj`` -> + residual; ``ln_cross_attn`` -> cross-attention
  (``q_attn`` from the decoder states, ``crossattention_c_attn`` H -> 2H
  from the encoder states) -> ``crossattention_c_proj`` -> + residual;
  ``ln_2`` -> ``c_fc`` -> tanh GELU (HF ``gelu_new``) -> ``mlp_c_proj`` ->
  + residual; then ``ln_f``;
- the causal bias and the padding bias with the finite ``NEG_INF``, the
  scores in the compute dtype, the softmax in f32 and cast back;
- the LM head tied to ``wte`` (``x @ wte.T``, no bias), or the untied
  ``lm_head_kernel``.

The rounding points are JAX's: every Dense and LayerNorm output, the GELU
output and the residual sums are in the compute dtype; the token and
position embeddings are summed (and dropped out) in f32, then cast. The
tanh GELU takes the compute dtype, which PyTorch computes in f32 and rounds
once, where ``jax.nn.gelu`` runs in the compute dtype. The causal and
padding biases are built once a forward and shared by the blocks. Dropout
sits at JAX's six sites (the embeddings, the self-attention probabilities,
``c_proj``, the cross-attention probabilities, ``crossattention_c_proj``,
``mlp_c_proj``); flax draws it from its RNG, which torch cannot redraw, so
the masks come from the step's :class:`torch.Generator`, as the BERT
trunk's per-module sites do. The blocks are plain PyTorch on every device:
JAX runs them as XLA, not as a Pallas kernel, so ``reference`` is accepted
and ignored.

Parameters keep the Flax names and ``(in, out)`` kernels (``wpe`` a bare
leaf, ``wte.embedding``), so ``ckpt/bridge.py``'s key walk loads a JAX
GPT-2 tree without a transpose, and HF's Conv1D weights, also ``(in, out)``,
convert without one (:func:`convert_gpt2_state_dict`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kindergarten_vq_vae_torch.nn.bert import (
    NEG_INF,
    Dense,
    Embed,
    LayerNorm,
    _Block,
    _einsum_attention,
    _f32,
    dropout,
)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    add_cross_attention: bool = True
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.float32  # compute dtype; parameters are always f32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size


@dataclasses.dataclass(frozen=True)
class _Run:
    """What one forward hands its blocks: the dropout rates and their generator."""

    cfg: GPT2Config
    attn_rate: float
    hid_rate: float
    generator: torch.Generator | None

    def drop(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        return dropout(x, rate, self.generator) if rate > 0.0 else x


class GPT2Block(_Block):
    """One pre-LN block (JAX l.72-124)."""

    def __init__(self, cfg: GPT2Config, device=None):
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        children = dict(ln_1=LayerNorm(h, eps, device), c_attn=Dense(h, 3 * h, device),
                        c_proj=Dense(h, h, device))
        if cfg.add_cross_attention:
            children.update(ln_cross_attn=LayerNorm(h, eps, device), q_attn=Dense(h, h, device),
                            crossattention_c_attn=Dense(h, 2 * h, device),
                            crossattention_c_proj=Dense(h, h, device))
        children.update(ln_2=LayerNorm(h, eps, device),
                        c_fc=Dense(h, cfg.intermediate_size, device),
                        mlp_c_proj=Dense(cfg.intermediate_size, h, device))
        super().__init__(**children)

    def forward(self, x, bias, encoder_hidden_states, cross_bias, run: _Run):
        """(x, cross-attention probabilities or None); ``bias`` the causal +
        padding bias (1 or B, 1, S, S), ``cross_bias`` the encoder padding
        bias or None, both in the compute dtype."""
        cfg, dtype = run.cfg, run.cfg.dtype
        h = cfg.hidden_size

        q, k, v = self.c_attn(self.ln_1(x, dtype), dtype).split(h, dim=-1)
        ctx, _ = _einsum_attention(q, k, v, bias, run)
        x = x + run.drop(self.c_proj(ctx, dtype), run.hid_rate)

        cross_probs = None
        if cfg.add_cross_attention and encoder_hidden_states is not None:
            q = self.q_attn(self.ln_cross_attn(x, dtype), dtype)
            k, v = self.crossattention_c_attn(encoder_hidden_states.to(dtype),
                                              dtype).split(h, dim=-1)
            ctx, cross_probs = _einsum_attention(q, k, v, cross_bias, run)
            x = x + run.drop(self.crossattention_c_proj(ctx, dtype), run.hid_rate)

        y = F.gelu(self.c_fc(self.ln_2(x, dtype), dtype), approximate="tanh")
        x = x + run.drop(self.mlp_c_proj(y, dtype), run.hid_rate)
        return x.to(dtype), cross_probs


class GPT2LMHeadModel(nn.Module):
    """GPT-2 LM with cross-attention; the call of
    :class:`~kindergarten_vq_vae_torch.nn.bert.BertLMHeadModel`, so either
    decoder drops into the models."""

    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.hidden_size, device)
        self.wpe = _f32((cfg.max_position_embeddings, cfg.hidden_size), device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", GPT2Block(cfg, device))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        if not cfg.tie_word_embeddings:
            self.lm_head_kernel = _f32((cfg.hidden_size, cfg.vocab_size), device)

    def forward(self, input_ids, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None, reference: bool = False, deterministic: bool = True,
                generator: torch.Generator | None = None, output_attentions: bool = False) -> dict:
        """``logits`` (B, S, V) and ``last_hidden_state`` (after ``ln_f``);
        with ``output_attentions`` also ``cross_attentions`` (per block, the
        probabilities before dropout) and ``attentions`` as ``()``, as JAX
        l.160-163. ``reference`` is ignored: no kernel runs here."""
        cfg, dtype = self.cfg, self.cfg.dtype
        drop = not deterministic and (cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0)
        if drop and generator is None:
            raise ValueError("dropout (deterministic=False) needs a torch.Generator")
        run = _Run(cfg, cfg.attention_dropout if drop else 0.0,
                   cfg.hidden_dropout if drop else 0.0, generator)
        b, s = input_ids.shape
        x = run.drop(self.wte(input_ids) + self.wpe[None, :s], run.hid_rate).to(dtype)
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        bias = torch.where(causal, 0.0, NEG_INF)[None, None].to(dtype)
        if attention_mask is not None:
            bias = bias + (1.0 - attention_mask[:, None, None, :].to(dtype)) * NEG_INF
        cross_bias = None
        if encoder_attention_mask is not None:
            cross_bias = (1.0 - encoder_attention_mask[:, None, None, :].to(dtype)) * NEG_INF
        cross = []
        for i in range(cfg.num_layers):
            x, cp = getattr(self, f"layer_{i}")(x, bias, encoder_hidden_states, cross_bias, run)
            cross.append(cp)
        x = self.ln_f(x, dtype)
        # the head as one 2-D product over all rows: contiguous (B * S, V)
        # logits, the CE kernels' layout
        kernel = (self.wte.embedding.to(dtype).T if cfg.tie_word_embeddings
                  else self.lm_head_kernel.to(dtype))
        logits = (x.reshape(b * s, cfg.hidden_size) @ kernel).reshape(b, s, cfg.vocab_size)
        out = {"logits": logits, "last_hidden_state": x}
        if output_attentions:
            out.update(cross_attentions=tuple(cross), attentions=())
        return out


_CROSS = ("ln_cross_attn", "q_attn", "crossattention_c_attn", "crossattention_c_proj")


def _tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu()
    return torch.from_numpy(np.array(t))


def convert_gpt2_state_dict(sd, cfg: GPT2Config, fresh: dict | None = None) -> dict:
    """An HF ``GPT2LMHeadModel`` state dict (tensors or arrays) ->
    :class:`GPT2LMHeadModel`'s state dict (JAX l.168-216). HF's Conv1D
    weights are ``(in, out)``, as the port's kernels, so nothing is
    transposed. A block whose cross-attention keys are missing (a plain LM
    checkpoint) keeps them from ``fresh`` (the freshly initialised decoder's
    state dict), as ``from_encoder_decoder_pretrained`` does."""
    out: dict[str, torch.Tensor] = {
        "wte.embedding": _tensor(sd["transformer.wte.weight"]),
        "wpe": _tensor(sd["transformer.wpe.weight"]),
    }

    def put(dst: str, src: str, weight: str) -> None:
        out[f"{dst}.{weight}"] = _tensor(sd[f"{src}.weight"])
        out[f"{dst}.bias"] = _tensor(sd[f"{src}.bias"])

    put("ln_f", "transformer.ln_f", "scale")
    for i in range(cfg.num_layers):
        dst, hp = f"layer_{i}", f"transformer.h.{i}"
        for name, src, w in (("ln_1", "ln_1", "scale"), ("c_attn", "attn.c_attn", "kernel"),
                             ("c_proj", "attn.c_proj", "kernel"), ("ln_2", "ln_2", "scale"),
                             ("c_fc", "mlp.c_fc", "kernel"),
                             ("mlp_c_proj", "mlp.c_proj", "kernel")):
            put(f"{dst}.{name}", f"{hp}.{src}", w)
        if not cfg.add_cross_attention:
            continue
        if f"{hp}.crossattention.q_attn.weight" in sd:
            put(f"{dst}.ln_cross_attn", f"{hp}.ln_cross_attn", "scale")
            put(f"{dst}.q_attn", f"{hp}.crossattention.q_attn", "kernel")
            put(f"{dst}.crossattention_c_attn", f"{hp}.crossattention.c_attn", "kernel")
            put(f"{dst}.crossattention_c_proj", f"{hp}.crossattention.c_proj", "kernel")
        else:
            if fresh is None:
                raise ValueError("the checkpoint has no cross-attention: pass the fresh "
                                 "decoder's state dict")
            for k, v in fresh.items():
                if k.startswith(f"{dst}.") and k.split(".")[1] in _CROSS:
                    out[k] = _tensor(v)
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        out["lm_head_kernel"] = _tensor(sd["lm_head.weight"]).T.contiguous()
    return out
