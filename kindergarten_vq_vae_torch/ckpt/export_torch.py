"""Export a run to the reference's torch ``.pth`` checkpoint bundle.

Counterpart of ``kindergarten_vq_vae_tpu/ckpt/export_torch.py``. The
reference saves ``{"model_state_dict", "encoder_state_dict",
"decoder_state_dict"}`` with ``torch.save`` and reloads every analysis and
warm start from that bundle; this module writes it from the port's model,
so weights trained here load into the reference's PyTorch stack with
``load_state_dict(strict=True)``.

Key layouts per variant, as JAX's module writes them:

- Bagon: ``encoder.*`` / ``decoder.*`` (HF ``BertModel`` /
  ``BertLMHeadModel``, from ``nn/convert_hf.py``'s ``export_*``).
- Shelgon: + ``proj_in.{0,1}.*`` / ``proj_out.{0,1}.*``, Sequential(Linear,
  Conv1d) / Sequential(Conv1d, Linear); a k=1 Conv1d weight is (out, in, 1)
  where the port's einsum kernel is (out, in).
- Shelgon2: + ``sentence_discretizer.<factor>_discretizer.proj_{in,out}.*``
  and ``sentence_discretizer.latent_factors_contract.*``; the port's
  ``negation`` factor is the reference's ``sentence_neg``.
- Shelgon3: + ``vector_quantizer.embedding.weight`` (VQ) or
  ``vector_quantizer.proj.*`` + ``vector_quantizer.embed.weight`` (Gumbel).

A run with the GPT-2 decoder raises ``ValueError``: the reference stack has
no GPT-2 decoder. Nothing here imports ``transformers``.

Usage::

    python -m kindergarten_vq_vae_torch.ckpt.export_torch <run_dir> \\
        [--ckpt <checkpoint_name>] [--out bundle.pth] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from kindergarten_vq_vae_torch.ckpt.bridge import params_to_jax
from kindergarten_vq_vae_torch.nn.convert_hf import (
    export_decoder_state_dict,
    export_encoder_state_dict,
)
from kindergarten_vq_vae_torch.nn.gpt2 import GPT2LMHeadModel

# the port's factor name -> the reference's discretizer attribute
_FACTOR_RENAME = {"negation": "sentence_neg"}


def _linear(sd: dict, prefix: str, dense: dict) -> None:
    sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(dense["kernel"]).T)
    sd[f"{prefix}.bias"] = np.asarray(dense["bias"])


def _conv1d(sd: dict, prefix: str, kernel, bias) -> None:
    # the (out, in) einsum kernel -> torch Conv1d (out, in, 1)
    sd[f"{prefix}.weight"] = np.asarray(kernel)[:, :, None]
    sd[f"{prefix}.bias"] = np.asarray(bias)


def _variant_extras(model_name: str, params: dict) -> dict:
    """The non-BERT modules of each variant, in the reference's key layout;
    ``params`` is the model's Flax-layout tree (``ckpt/bridge.py``)."""
    sd: dict = {}
    if model_name == "bagon":
        return sd
    if model_name == "shelgon":
        _linear(sd, "proj_in.0", params["proj_in_dense"])
        _conv1d(sd, "proj_in.1", params["proj_in_conv_kernel"], params["proj_in_conv_bias"])
        _conv1d(sd, "proj_out.0", params["proj_out_conv_kernel"], params["proj_out_conv_bias"])
        _linear(sd, "proj_out.1", params["proj_out_dense"])
        return sd
    if model_name == "shelgon2":
        disc = params["sentence_discretizer"]
        for name, sub in disc.items():
            if not name.endswith("_discretizer"):
                continue
            ref = _FACTOR_RENAME.get(name[:-len("_discretizer")], name[:-len("_discretizer")])
            _linear(sd, f"sentence_discretizer.{ref}_discretizer.proj_in", sub["proj_in"])
            _linear(sd, f"sentence_discretizer.{ref}_discretizer.proj_out", sub["proj_out"])
        _conv1d(sd, "sentence_discretizer.latent_factors_contract", disc["contract_kernel"],
                disc["contract_bias"])
        return sd
    if model_name == "shelgon3":
        if "vector_quantizer" in params:
            sd["vector_quantizer.embedding.weight"] = np.asarray(
                params["vector_quantizer"]["codebook"])
        elif "gumbel_quantizer" in params:
            gq = params["gumbel_quantizer"]
            sd["vector_quantizer.proj.weight"] = np.asarray(gq["proj_kernel"]).T[:, :, None]
            sd["vector_quantizer.proj.bias"] = np.asarray(gq["proj_bias"])
            sd["vector_quantizer.embed.weight"] = np.asarray(gq["codebook"])
        return sd
    raise ValueError(f"unknown model_name {model_name!r}")


def export_reference_bundle(cfg, model: torch.nn.Module) -> dict:
    """``{"model_state_dict", "encoder_state_dict", "decoder_state_dict"}``
    of numpy arrays, in the reference's exact key layout."""
    if isinstance(model.decoder, GPT2LMHeadModel):
        raise ValueError("the reference stack has no GPT-2 decoder; export requires a BERT "
                         "decoder")
    enc_sd = export_encoder_state_dict(model.encoder, model.encoder.cfg)
    dec_sd = export_decoder_state_dict(model.decoder, model.decoder.bert.cfg)
    model_sd = {f"encoder.{k}": v for k, v in enc_sd.items()}
    model_sd.update({f"decoder.{k}": v for k, v in dec_sd.items()})
    model_sd.update(_variant_extras(cfg.model_name, params_to_jax(model)))
    return {"model_state_dict": model_sd, "encoder_state_dict": enc_sd,
            "decoder_state_dict": dec_sd}


def save_reference_bundle(bundle: dict, out_path: str) -> None:
    """``torch.save`` with tensor values, as the reference's ``torch.load``
    consumers read it."""
    torched = {top: {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in sd.items()}
               for top, sd in bundle.items()}
    torch.save(torched, out_path)


def _main(argv=None):
    import argparse
    import os

    from kindergarten_vq_vae_torch.analyses.common import load_run

    p = argparse.ArgumentParser(
        description="export a run checkpoint to the reference's torch .pth bundle")
    p.add_argument("run_dir")
    p.add_argument("--ckpt", default=None, help="checkpoint name inside the run dir "
                   "(default: the val-best recon checkpoint)")
    p.add_argument("--out", default=None, help="output .pth path "
                   "(default: <run_dir>/<model>_reference_export.pth)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg, model = load_run(args.run_dir, ckpt_name=args.ckpt, device=args.device)
    bundle = export_reference_bundle(cfg, model)
    out = args.out or os.path.join(args.run_dir, f"{cfg.model_name}_reference_export.pth")
    save_reference_bundle(bundle, out)
    n = sum(len(sd) for sd in bundle.values())
    print(f"{n} tensors -> {out}")


if __name__ == "__main__":
    _main()
