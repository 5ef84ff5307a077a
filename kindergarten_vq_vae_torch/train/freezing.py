"""Freezing modes as a trainable mask over the model's parameter names.

Counterpart of ``kindergarten_vq_vae_tpu/train/freezing.py``. The port's
parameter names are the Flax paths joined by '.'
(``encoder.layer_0.self_attn.qkv.kernel``), so the mask is the same
decision taken on the same path:

- ``full``: everything trainable;
- ``dec-head-ft``: the encoder and decoder frozen except the decoder's MLM
  head (``transform_dense``, ``decoder_kernel``, ``decoder_bias``; its
  LayerNorm stays frozen), the word-embedding table when the head is tied to
  it (in the reference the tied head's weight IS that table), and the
  decoder's cross-attention when ``cross_attn_trainable``;
- ``enc-head-ft-dec-head-ft``: that, plus the encoder's last layer and pooler;
- ``vq-ft``: the encoder and decoder frozen entirely.

Parameters outside the encoder and decoder (the codebook) are trainable in
every mode. The GPT-2 decoder's rules wait for that decoder (ROADMAP,
"other variants").
"""

from __future__ import annotations

from kindergarten_vq_vae_torch.utils.consts import SUPPORTED_MODEL_MODES


def _num_encoder_layers(paths) -> int:
    layers = {int(p[1].split("_")[1]) for p in paths
              if p[0] == "encoder" and len(p) > 1 and p[1].startswith("layer_")}
    return max(layers) + 1 if layers else 0


def trainable_mask(names, mode: str, cross_attn_trainable: bool = True,
                   tie_word_embeddings: bool = True) -> dict[str, bool]:
    """``{parameter name: trainable}`` for an iterable of parameter names."""
    if mode not in SUPPORTED_MODEL_MODES:
        raise ValueError(f"Invalid model mode {mode}, please use one of the following: "
                         + ", ".join(SUPPORTED_MODEL_MODES))
    paths = {name: tuple(name.split(".")) for name in names}
    n_layers = _num_encoder_layers(paths.values())

    def decide(path) -> bool:
        top = path[0]
        if mode == "full" or top not in ("encoder", "decoder"):
            return True
        if mode == "vq-ft":
            return False
        trainable = False
        if top == "decoder":
            if path[1] == "mlm_head":
                trainable = path[2] in ("transform_dense", "decoder_kernel", "decoder_bias")
            elif path[1] == "bert":
                if tie_word_embeddings and path[2:5] == ("embeddings", "word_embeddings",
                                                         "embedding"):
                    trainable = True
                if len(path) > 3 and path[3] == "cross_attn" and cross_attn_trainable:
                    trainable = True
        if mode == "enc-head-ft-dec-head-ft" and top == "encoder":
            if path[1] in (f"layer_{n_layers - 1}", "pooler"):
                trainable = True
        return trainable

    return {name: decide(path) for name, path in paths.items()}
