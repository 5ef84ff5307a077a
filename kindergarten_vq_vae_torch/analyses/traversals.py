"""Latent traversals for the Shelgon latent-class bottleneck.

Counterpart of ``kindergarten_vq_vae_tpu/analyses/traversals.py`` (the
reference's ``latent_traversals_Shelgon_latent_classes.py``): encode
sentences, replace their (num_classes, num_labels) latent classes with a
hand-written matrix through the model's ``override_latent_classes`` hook,
decode through ``proj_out`` and the decoder, and set the original
reconstructions beside the traversed ones. On CUDA the layers run as the
kernels. The plain forward's Gumbel noise comes from a generator seeded 0,
the counterpart of JAX's ``key(0)``.
"""

from __future__ import annotations

import numpy as np
import torch

from kindergarten_vq_vae_torch.analyses.common import as_tensor, device_of, to_numpy


def filter_by_factor(decoded_df, factor_name: str, factor_value: str,
                     acc_threshold: float = 0.999):
    """Sentences above ``acc_threshold`` with a given explicit factor value
    (the traversal scripts' input selection)."""
    df = decoded_df[decoded_df.sentence_acc > acc_threshold]
    return df[df[factor_name] == factor_value].reset_index(drop=True)


@torch.inference_mode()
def latent_traversals_shelgon(model, input_ids: np.ndarray, attention_mask: np.ndarray,
                              override_matrix: np.ndarray, tokenizer=None,
                              decoder_input_ids=None) -> dict:
    """``override_matrix``: (num_latent_classes, num_labels_per_class), or a
    (B, C, L) batch of them. Returns the original and traversed
    reconstruction ids and the original latent classes (decoded sentences
    too when a tokenizer is given). ``decoder_input_ids`` overrides the
    teacher-forced decoder inputs (e.g. all-[MASK], see
    ``analyses.arithmetic.masked_decoder_inputs``)."""
    device = device_of(model)
    ids = as_tensor(np.asarray(input_ids), device)
    mask = as_tensor(np.asarray(attention_mask), device)
    dec_ids = ids if decoder_input_ids is None else as_tensor(np.asarray(decoder_input_ids), device)

    def run(override=None):
        out = model(ids, mask, dec_ids, mask, deterministic=True,
                    generator=torch.Generator(device=device).manual_seed(0),
                    override_latent_classes=override)
        return torch.argmax(out["logits"], dim=-1), out["pred_latent_classes"]

    orig_ids, orig_latents = run()
    override = torch.as_tensor(np.asarray(override_matrix, np.float32), device=device)
    if override.ndim == 2:
        override = override.expand(ids.shape[0], *override.shape)
    trav_ids, _ = run(override)
    result = {
        "original_recon_ids": orig_ids.cpu().numpy(),
        "traversed_recon_ids": trav_ids.cpu().numpy(),
        "original_latent_classes": to_numpy(orig_latents),
    }
    if tokenizer is not None:
        result["original_sentences"] = tokenizer.batch_decode(np.asarray(input_ids))
        result["original_recon"] = tokenizer.batch_decode(result["original_recon_ids"])
        result["traversed_recon"] = tokenizer.batch_decode(result["traversed_recon_ids"])
    return result


def _main(argv=None):
    """Pick max-accuracy sentences (optionally filtered by an explicit factor
    value), re-encode them, override their latent classes with a
    hand-written matrix, and print original against traversed
    reconstructions."""
    import argparse
    import json
    import os

    from kindergarten_vq_vae_torch.analyses.common import load_run
    from kindergarten_vq_vae_torch.train.run import load_data

    p = argparse.ArgumentParser(description="latent traversals (Shelgon latent classes)")
    p.add_argument("run_dir")
    p.add_argument("--factor", default=None, help="explicit factor column, e.g. verb_tense")
    p.add_argument("--value", default=None, help="factor value, e.g. present")
    p.add_argument("--override", default=None,
                   help="JSON (num_classes, num_labels) one-hot matrix or a path to a .json "
                        "holding one; default sets every class to label 0")
    p.add_argument("--n", type=int, default=16, help="max sentences to traverse")
    p.add_argument("--dec-input", default="clean", choices=("clean", "mask", "rand"),
                   help="decoder teacher-forcing inputs: the target ids, all-[MASK], or "
                        "random-token corruption at --dec-rand-pct")
    p.add_argument("--dec-rand-pct", type=float, default=0.9)
    p.add_argument("--out", default=None, help="write results JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg, model = load_run(args.run_dir, device=args.device)
    if cfg.model_name != "shelgon":
        raise ValueError(f"latent traversals need a shelgon run, not {cfg.model_name!r}")
    splits, tokenizer = load_data(cfg)
    feather = os.path.join(args.run_dir, "max_acc_sentences.feather")
    sentences = None
    if os.path.exists(feather):
        import pandas as pd

        df = pd.read_feather(feather)
        if args.factor and args.value:
            df = filter_by_factor(df, args.factor, args.value, acc_threshold=-1.0)
        sentences = list(df["input_sentence"])[: args.n]
    if sentences:
        ids, mask = tokenizer.encode_batch(sentences, cfg.tokenized_sentence_max_length,
                                           cfg.tokenizer_add_special_tokens)
    else:
        te = splits["test"]
        ids, mask = np.asarray(te.input_ids[: args.n]), np.asarray(te.attention_mask[: args.n])

    if args.override:
        raw = args.override
        if os.path.exists(raw):
            with open(raw) as f:
                raw = f.read()
        override = np.asarray(json.loads(raw), np.float32)
    else:
        override = np.zeros((cfg.num_latent_classes, cfg.num_labels_per_class), np.float32)
        override[:, 0] = 1.0

    dec_ids = None
    if args.dec_input == "mask":
        from kindergarten_vq_vae_torch.analyses.arithmetic import masked_decoder_inputs

        dec_ids = masked_decoder_inputs(tokenizer, ids, mask)
    elif args.dec_input == "rand":
        from kindergarten_vq_vae_torch.analyses.arithmetic import randomized_decoder_inputs

        dec_ids = randomized_decoder_inputs(tokenizer, ids, mask, pct=args.dec_rand_pct)

    res = latent_traversals_shelgon(model, ids, mask, override, tokenizer,
                                    decoder_input_ids=dec_ids)
    for orig, trav in zip(res.get("original_recon", []), res.get("traversed_recon", [])):
        print(f"orig: {orig}\ntrav: {trav}\n")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                       for k, v in res.items()}, f)
        print(f"results -> {args.out}")
    return res


if __name__ == "__main__":
    _main()
