"""HF torch BERT state dicts <-> the port's parameters.

Counterpart of ``kindergarten_vq_vae_tpu/nn/convert_hf.py``. The converters
replicate the initialisation of
``EncoderDecoderModel.from_encoder_decoder_pretrained("bert-base-uncased",
...)`` (the reference's ``models/bagon/Bagon.py:25-31``): the encoder takes
every pretrained weight; the decoder takes every pretrained MLM weight, and
its cross-attention blocks, which an MLM checkpoint lacks, keep their fresh
initial values. They take any state-dict-like mapping of tensors or arrays
(a local checkpoint, or an HF model built from a config) and never import
``transformers``. torch ``Linear`` weights are ``(out, in)`` and the port's
kernels ``(in, out)``, so these maps transpose; Q / K / V (and the
cross-attention's K / V) are packed into the fused projections. The
``export_*`` functions invert them. HF GPT-2 state dicts convert with
:func:`~kindergarten_vq_vae_torch.nn.gpt2.convert_gpt2_state_dict`.

The port's side is a flat state dict: :class:`~kindergarten_vq_vae_torch.nn.bert.BertModel`'s
names for an encoder (``layer_0.self_attn.qkv.kernel``),
:class:`~kindergarten_vq_vae_torch.nn.bert.BertLMHeadModel`'s for a decoder
(``bert.…``, ``mlm_head.…``), the Flax paths joined by '.'.
"""

from __future__ import annotations

import numpy as np
import torch

from kindergarten_vq_vae_torch.nn.bert import BertConfig, BertLMHeadModel, BertModel
from kindergarten_vq_vae_torch.nn.gpt2 import _tensor


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _linear(sd, src: str) -> dict[str, torch.Tensor]:
    return {"kernel": _tensor(sd[f"{src}.weight"]).T.contiguous(),
            "bias": _tensor(sd[f"{src}.bias"])}


def _layer_norm(sd, src: str) -> dict[str, torch.Tensor]:
    return {"scale": _tensor(sd[f"{src}.weight"]), "bias": _tensor(sd[f"{src}.bias"])}


def _packed(parts: list[dict]) -> dict[str, torch.Tensor]:
    return {"kernel": torch.cat([p["kernel"] for p in parts], dim=1),
            "bias": torch.cat([p["bias"] for p in parts])}


def _trunk(sd, cfg: BertConfig, src: str, dst: str, fresh: dict | None) -> dict:
    """A BertModel trunk under the HF prefix ``src``, as the port's names
    under ``dst``; the cross-attention and the pooler that the checkpoint
    lacks come from ``fresh`` (JAX ``_trunk_params``)."""
    out: dict[str, torch.Tensor] = {}

    def put(name: str, leaves: dict) -> None:
        out.update({f"{dst}{name}.{k}": v for k, v in leaves.items()})

    emb = f"{src}embeddings"
    for name, hf in (("word_embeddings.embedding", "word_embeddings"),
                     ("position_embeddings", "position_embeddings"),
                     ("token_type_embeddings.embedding", "token_type_embeddings")):
        out[f"{dst}embeddings.{name}"] = _tensor(sd[f"{emb}.{hf}.weight"])
    put("embeddings.layer_norm", _layer_norm(sd, f"{emb}.LayerNorm"))
    for i in range(cfg.num_layers):
        hp, lp = f"{src}encoder.layer.{i}", f"layer_{i}"
        put(f"{lp}.self_attn.qkv", _packed([_linear(sd, f"{hp}.attention.self.{n}")
                                            for n in ("query", "key", "value")]))
        put(f"{lp}.self_attn.out", _linear(sd, f"{hp}.attention.output.dense"))
        put(f"{lp}.self_attn.layer_norm", _layer_norm(sd, f"{hp}.attention.output.LayerNorm"))
        put(f"{lp}.mlp.intermediate", _linear(sd, f"{hp}.intermediate.dense"))
        put(f"{lp}.mlp.output", _linear(sd, f"{hp}.output.dense"))
        put(f"{lp}.mlp.layer_norm", _layer_norm(sd, f"{hp}.output.LayerNorm"))
        if not cfg.add_cross_attention:
            continue
        if f"{hp}.crossattention.self.query.weight" in sd:
            put(f"{lp}.cross_attn.q", _linear(sd, f"{hp}.crossattention.self.query"))
            put(f"{lp}.cross_attn.kv", _packed([_linear(sd, f"{hp}.crossattention.self.{n}")
                                                for n in ("key", "value")]))
            put(f"{lp}.cross_attn.out", _linear(sd, f"{hp}.crossattention.output.dense"))
            put(f"{lp}.cross_attn.layer_norm",
                _layer_norm(sd, f"{hp}.crossattention.output.LayerNorm"))
        else:
            if fresh is None:
                raise ValueError("the checkpoint has no cross-attention: pass the fresh "
                                 "decoder's state dict")
            out.update({k: _tensor(v) for k, v in fresh.items()
                        if k.startswith(f"{dst}{lp}.cross_attn.")})
    if cfg.add_pooler:
        if f"{src}pooler.dense.weight" in sd:
            put("pooler", _linear(sd, f"{src}pooler.dense"))
        elif fresh is not None and f"{dst}pooler.kernel" in fresh:
            out.update({k: _tensor(v) for k, v in fresh.items()
                        if k.startswith(f"{dst}pooler.")})
    return out


def convert_encoder_state_dict(sd, cfg: BertConfig, fresh: dict | None = None) -> dict:
    """An HF ``BertModel`` state dict (or a ``bert.``-prefixed one) -> the
    state dict of the port's :class:`BertModel`."""
    src = "bert." if any(k.startswith("bert.") for k in sd) else ""
    return _trunk(sd, cfg, src, "", fresh)


def convert_decoder_state_dict(sd, cfg: BertConfig, fresh: dict | None = None) -> dict:
    """An HF ``BertLMHeadModel`` state dict -> the state dict of the port's
    :class:`BertLMHeadModel`; ``fresh`` (the fresh decoder's state dict)
    supplies the cross-attention an MLM checkpoint lacks."""
    out = _trunk(sd, cfg, "bert.", "bert.", fresh)
    head = "cls.predictions"
    out.update({f"mlm_head.transform_dense.{k}": v
                for k, v in _linear(sd, f"{head}.transform.dense").items()})
    out.update({f"mlm_head.transform_layer_norm.{k}": v
                for k, v in _layer_norm(sd, f"{head}.transform.LayerNorm").items()})
    out["mlm_head.decoder_bias"] = _tensor(sd[f"{head}.bias"])
    if not cfg.tie_word_embeddings:
        out["mlm_head.decoder_kernel"] = _tensor(sd[f"{head}.decoder.weight"]).T.contiguous()
    return out


def init_encoder_decoder(generator: torch.Generator, enc_cfg: BertConfig, dec_cfg: BertConfig,
                         encoder_state_dict=None, decoder_state_dict=None, device=None):
    """(encoder :class:`BertModel`, decoder :class:`BertLMHeadModel`)
    initialised from ``generator`` (on ``device``) and warm-started from HF
    state dicts where given, with ``from_encoder_decoder_pretrained``'s
    semantics: the decoder's cross-attention keeps its fresh values when the
    checkpoint lacks it."""
    from kindergarten_vq_vae_torch.models import init_weights

    encoder = init_weights(BertModel(enc_cfg, device), generator)
    decoder = init_weights(BertLMHeadModel(dec_cfg, device), generator)
    if encoder_state_dict is not None:
        encoder.load_state_dict(
            convert_encoder_state_dict(encoder_state_dict, enc_cfg, encoder.state_dict()),
            strict=True)
    if decoder_state_dict is not None:
        decoder.load_state_dict(
            convert_decoder_state_dict(decoder_state_dict, dec_cfg, decoder.state_dict()),
            strict=True)
    return encoder, decoder


def _state(params) -> dict:
    return params.state_dict() if isinstance(params, torch.nn.Module) else params


def _export_trunk(p: dict, cfg: BertConfig, src: str, dst: str) -> dict:
    """The port's trunk leaves under ``src`` -> HF keys under ``dst`` (numpy)."""
    sd: dict[str, np.ndarray] = {}
    h = cfg.hidden_size

    def leaf(name):
        return _np(p[f"{src}{name}"])

    def linear(hf: str, name: str, cols=slice(None)) -> None:
        sd[f"{hf}.weight"] = np.ascontiguousarray(leaf(f"{name}.kernel")[:, cols].T)
        sd[f"{hf}.bias"] = leaf(f"{name}.bias")[cols]

    def layer_norm(hf: str, name: str) -> None:
        sd[f"{hf}.weight"], sd[f"{hf}.bias"] = leaf(f"{name}.scale"), leaf(f"{name}.bias")

    emb = f"{dst}embeddings"
    sd[f"{emb}.word_embeddings.weight"] = leaf("embeddings.word_embeddings.embedding")
    sd[f"{emb}.position_embeddings.weight"] = leaf("embeddings.position_embeddings")
    sd[f"{emb}.token_type_embeddings.weight"] = leaf("embeddings.token_type_embeddings.embedding")
    layer_norm(f"{emb}.LayerNorm", "embeddings.layer_norm")
    for i in range(cfg.num_layers):
        hp, lp = f"{dst}encoder.layer.{i}", f"layer_{i}"
        for j, n in enumerate(("query", "key", "value")):
            linear(f"{hp}.attention.self.{n}", f"{lp}.self_attn.qkv", slice(j * h, (j + 1) * h))
        linear(f"{hp}.attention.output.dense", f"{lp}.self_attn.out")
        layer_norm(f"{hp}.attention.output.LayerNorm", f"{lp}.self_attn.layer_norm")
        if f"{src}{lp}.cross_attn.q.kernel" in p:
            linear(f"{hp}.crossattention.self.query", f"{lp}.cross_attn.q")
            linear(f"{hp}.crossattention.self.key", f"{lp}.cross_attn.kv", slice(0, h))
            linear(f"{hp}.crossattention.self.value", f"{lp}.cross_attn.kv", slice(h, 2 * h))
            linear(f"{hp}.crossattention.output.dense", f"{lp}.cross_attn.out")
            layer_norm(f"{hp}.crossattention.output.LayerNorm", f"{lp}.cross_attn.layer_norm")
        linear(f"{hp}.intermediate.dense", f"{lp}.mlp.intermediate")
        linear(f"{hp}.output.dense", f"{lp}.mlp.output")
        layer_norm(f"{hp}.output.LayerNorm", f"{lp}.mlp.layer_norm")
    if f"{src}pooler.kernel" in p:
        linear(f"{dst}pooler.dense", "pooler")
    return sd


def export_encoder_state_dict(params, cfg: BertConfig) -> dict:
    """The port's :class:`BertModel` (or its state dict) -> an HF
    ``BertModel`` state dict of numpy arrays (the reference's
    ``encoder_state_dict`` bundle entry)."""
    return _export_trunk(_state(params), cfg, "", "")


def export_decoder_state_dict(params, cfg: BertConfig) -> dict:
    """The port's :class:`BertLMHeadModel` (or its state dict) -> an HF
    ``BertLMHeadModel`` state dict of numpy arrays, so weights trained here
    load into the reference's PyTorch stack."""
    p = _state(params)
    sd = _export_trunk(p, cfg, "bert.", "bert.")
    head = "cls.predictions"
    sd[f"{head}.transform.dense.weight"] = np.ascontiguousarray(
        _np(p["mlm_head.transform_dense.kernel"]).T)
    sd[f"{head}.transform.dense.bias"] = _np(p["mlm_head.transform_dense.bias"])
    sd[f"{head}.transform.LayerNorm.weight"] = _np(p["mlm_head.transform_layer_norm.scale"])
    sd[f"{head}.transform.LayerNorm.bias"] = _np(p["mlm_head.transform_layer_norm.bias"])
    sd[f"{head}.bias"] = _np(p["mlm_head.decoder_bias"])
    sd[f"{head}.decoder.bias"] = _np(p["mlm_head.decoder_bias"])
    if cfg.tie_word_embeddings:
        sd[f"{head}.decoder.weight"] = sd["bert.embeddings.word_embeddings.weight"]
    else:
        sd[f"{head}.decoder.weight"] = np.ascontiguousarray(
            _np(p["mlm_head.decoder_kernel"]).T)
    return sd
