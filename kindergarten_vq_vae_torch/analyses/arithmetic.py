"""Latent arithmetic: a factor direction added at one of three injection points.

Counterpart of ``kindergarten_vq_vae_tpu/analyses/arithmetic.py`` (the
reference's ``analyses/latent_arithmetics/``): encode two groups, take
Δ = mean(A) − mean(B), add Δ to the latents of held-out targets and decode
(on CUDA the layer kernels). The three modes:

- ``conditioning``: Δ in Shelgon's post-``proj_out`` conditioning space;
- ``sentence``: Δ in Shelgon's raw encoder-output space, the shifted states
  pushed through the bottleneck (``proj_in``, Gumbel softmax, ``proj_out``);
- ``bagon``: Δ directly on Bagon's encoder outputs.

Shelgon's Gumbel noise comes from a generator seeded 0 on each forward, the
counterpart of JAX's ``key(0)``.

Each mode raises ``ValueError`` before any forward on a run with the GPT-2
decoder: JAX decodes the shifted latents through ``BertLMHeadModel(dec_cfg)``
(l.94-105), which cannot take a ``GPT2Config``, so no mode runs there (a
recorded divergence in the exception only). The decoder inputs of
:func:`masked_decoder_inputs` and :func:`randomized_decoder_inputs` feed
only these modes.
"""

from __future__ import annotations

import numpy as np
import torch

from kindergarten_vq_vae_torch.analyses.common import (
    as_tensor,
    device_of,
    refuse_gpt2_decoder,
    to_numpy,
)


def _decode_ids(tokenizer, ids):
    return tokenizer.batch_decode(np.asarray(ids)) if tokenizer is not None else None


def masked_decoder_inputs(tokenizer, input_ids, attention_mask):
    """All-[MASK] decoder inputs, padding kept: masking every visible
    position forces the reconstruction through cross-attention to the
    (edited) latent, where clean teacher-forced inputs would let an accurate
    decoder copy them and hide the edit."""
    from kindergarten_vq_vae_torch.data.tokenizer import MASK

    ids = np.asarray(input_ids)
    return np.where(np.asarray(attention_mask) == 1, tokenizer.vocab[MASK], ids)


def randomized_decoder_inputs(tokenizer, input_ids, attention_mask, pct=0.9, seed=0):
    """Decoder inputs corrupted as corruption-trained models saw them:
    ``replace_pct_rand_values`` with uniform vocab ids (the engine's
    ``decoder_perturb_train_pct``), drawn from a CPU generator seeded with
    ``seed``, padding kept."""
    from kindergarten_vq_vae_torch.utils.tensor import replace_pct_rand_values

    ids = np.asarray(input_ids)
    corrupted = replace_pct_rand_values(torch.from_numpy(ids.copy()), float(pct), 0,
                                        tokenizer.vocab_size,
                                        torch.Generator().manual_seed(seed)).numpy()
    return np.where(np.asarray(attention_mask) == 1, corrupted, ids)


def _decoder_apply(decoder, ids, mask, hidden) -> torch.Tensor:
    """Argmax ids of the decoder over ``hidden`` as its cross-attention memory."""
    device = hidden.device
    logits = decoder(as_tensor(np.asarray(ids), device), as_tensor(np.asarray(mask), device),
                     encoder_hidden_states=hidden)["logits"]
    return torch.argmax(logits, dim=-1)


def _refuse_gpt2(model) -> None:
    refuse_gpt2_decoder(model, "latent arithmetic",
                        "it decodes through a BERT LM head, as the JAX package's does")


def _gumbel_generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def _shelgon_conditioning(model, input_ids, attention_mask):
    """(conditioning, encoder_last_hidden_state) of a Shelgon forward."""
    device = device_of(model)
    ids, mask = as_tensor(np.asarray(input_ids), device), as_tensor(np.asarray(attention_mask),
                                                                     device)
    out = model(ids, mask, ids, mask, generator=_gumbel_generator(device))
    return out["conditioning"], out["encoder_last_hidden_state"]


def _result(model, delta, dec_ids, targets, base_hidden, shifted_hidden, tokenizer) -> dict:
    """Δ and the decoder's ids over the base and the shifted memory."""
    mask = targets["attention_mask"]
    base = _decoder_apply(model.decoder, dec_ids, mask, base_hidden).cpu().numpy()
    shifted = _decoder_apply(model.decoder, dec_ids, mask, shifted_hidden).cpu().numpy()
    return {
        "delta": to_numpy(delta),
        "base_recon_ids": base,
        "shifted_recon_ids": shifted,
        "base_recon": _decode_ids(tokenizer, base),
        "shifted_recon": _decode_ids(tokenizer, shifted),
    }


@torch.inference_mode()
def latent_arithmetic_shelgon_conditioning(model, group_a, group_b, targets, tokenizer=None,
                                           decoder_input_ids=None) -> dict:
    """Δ in Shelgon's conditioning (post-``proj_out``) space. ``group_a`` /
    ``group_b`` / ``targets`` hold ``input_ids`` and ``attention_mask``;
    ``decoder_input_ids`` overrides the teacher-forced decoder inputs."""
    _refuse_gpt2(model)
    cond_a, _ = _shelgon_conditioning(model, **group_a)
    cond_b, _ = _shelgon_conditioning(model, **group_b)
    delta = torch.mean(cond_a, dim=0) - torch.mean(cond_b, dim=0)
    dec_ids = targets["input_ids"] if decoder_input_ids is None else decoder_input_ids
    cond_t, _ = _shelgon_conditioning(model, **targets)
    return _result(model, delta, dec_ids, targets, cond_t, cond_t + delta, tokenizer)


@torch.inference_mode()
def latent_arithmetic_shelgon_sentence(model, group_a, group_b, targets, tokenizer=None,
                                       decoder_input_ids=None) -> dict:
    """Δ in Shelgon's raw encoder-output space, pushed through the bottleneck."""
    _refuse_gpt2(model)
    _, h_a = _shelgon_conditioning(model, **group_a)
    _, h_b = _shelgon_conditioning(model, **group_b)
    delta = torch.mean(h_a, dim=0) - torch.mean(h_b, dim=0)
    dec_ids = targets["input_ids"] if decoder_input_ids is None else decoder_input_ids
    _, h_t = _shelgon_conditioning(model, **targets)
    device = h_t.device
    cond_shift = model.bottleneck(h_t + delta, _gumbel_generator(device))[2]
    cond_base = model.bottleneck(h_t, _gumbel_generator(device))[2]
    return _result(model, delta, dec_ids, targets, cond_base, cond_shift, tokenizer)


@torch.inference_mode()
def latent_arithmetic_bagon(model, group_a, group_b, targets, tokenizer=None,
                            decoder_input_ids=None) -> dict:
    """Δ directly in Bagon encoder space. ``group_a`` / ``group_b`` /
    ``targets`` hold ``input_ids`` and ``attention_mask``;
    ``decoder_input_ids`` overrides the teacher-forced decoder inputs (see
    :func:`masked_decoder_inputs`)."""
    _refuse_gpt2(model)
    device = device_of(model)

    def encode(d):
        out = model.encoder(as_tensor(np.asarray(d["input_ids"]), device),
                            as_tensor(np.asarray(d["attention_mask"]), device))
        return out["last_hidden_state"]

    dec_ids = targets["input_ids"] if decoder_input_ids is None else decoder_input_ids
    h_a, h_b, h_t = encode(group_a), encode(group_b), encode(targets)
    delta = torch.mean(h_a, dim=0) - torch.mean(h_b, dim=0)
    return _result(model, delta, dec_ids, targets, h_t, h_t + delta, tokenizer)


def _factor_groups(split, factor: str, value_a: str, value_b: str, n: int):
    """Two sentence groups of a split, chosen by an explicit factor value
    (the reference builds its Δ from factor-opposite sentences)."""
    from kindergarten_vq_vae_torch.utils.consts import EXPLICIT_FACTOR_VALUES

    col = list(EXPLICIT_FACTOR_VALUES).index(factor)
    values = EXPLICIT_FACTOR_VALUES[factor]
    labels = np.asarray(split.labels)

    def pick(value):
        idx = np.where(labels[:, col] == values.index(value))[0][:n]
        if len(idx) == 0:
            raise ValueError(f"no sentences with {factor}={value}")
        return {"input_ids": np.asarray(split.input_ids)[idx],
                "attention_mask": np.asarray(split.attention_mask)[idx]}

    return pick(value_a), pick(value_b)


def _main(argv=None):
    """Δ = mean(group A) − mean(group B) on train sentences, added to held-out
    latents, reconstructions printed and written as JSON."""
    import argparse
    import json
    import os

    from kindergarten_vq_vae_torch.analyses.common import load_run
    from kindergarten_vq_vae_torch.train.run import load_data

    p = argparse.ArgumentParser(description="latent arithmetic (conditioning | sentence | bagon)")
    p.add_argument("run_dir")
    p.add_argument("--mode", default="bagon", choices=("conditioning", "sentence", "bagon"),
                   help="injection point; conditioning and sentence take a shelgon run")
    p.add_argument("--factor", default="verb_tense", help="explicit factor, e.g. verb_tense")
    p.add_argument("--a", default="present", help="factor value of group A")
    p.add_argument("--b", default="past", help="factor value of group B")
    p.add_argument("--n", type=int, default=64, help="sentences per group / targets")
    p.add_argument("--dec-input", default="clean", choices=("clean", "mask", "rand"),
                   help="decoder teacher-forcing inputs: the target ids, all-[MASK], or "
                        "random-token corruption at --dec-rand-pct")
    p.add_argument("--dec-rand-pct", type=float, default=0.9)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg, model = load_run(args.run_dir, device=args.device)
    splits, tokenizer = load_data(cfg)
    group_a, group_b = _factor_groups(splits["train"], args.factor, args.a, args.b, args.n)
    # targets: held-out val sentences with group B's value (Δ should flip them toward A)
    targets, _ = _factor_groups(splits["val"], args.factor, args.b, args.a, args.n)
    dec_ids = None
    if args.dec_input == "mask":
        dec_ids = masked_decoder_inputs(tokenizer, targets["input_ids"],
                                        targets["attention_mask"])
    elif args.dec_input == "rand":
        dec_ids = randomized_decoder_inputs(tokenizer, targets["input_ids"],
                                            targets["attention_mask"], pct=args.dec_rand_pct)
    fn = {"conditioning": latent_arithmetic_shelgon_conditioning,
          "sentence": latent_arithmetic_shelgon_sentence,
          "bagon": latent_arithmetic_bagon}[args.mode]
    res = fn(model, group_a, group_b, targets, tokenizer, decoder_input_ids=dec_ids)
    for base, shifted in zip(res.get("base_recon") or [], res.get("shifted_recon") or []):
        print(f"base   : {base}\nshifted: {shifted}\n")
    out = args.out or os.path.join(args.run_dir, f"latent_arithmetic_{args.mode}.json")
    with open(out, "w") as f:
        json.dump({k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in res.items()}, f)
    print(f"results -> {out}")


if __name__ == "__main__":
    _main()
