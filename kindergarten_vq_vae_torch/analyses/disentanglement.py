"""Unsupervised VQ disentanglement: word -> codebook-index distributions.

Counterpart of ``kindergarten_vq_vae_tpu/analyses/disentanglement.py`` (the
reference's ``unsupervised_vq_disentanglement.py:107-235``). Over a share of
all three splits, map every token's codebook index (``min_encoding_indices``
of a Shelgon3-VQ forward in eval mode; on CUDA the layer and VQ kernels)
back to its source word, and write

- the populated codes                     -> ``dSentences_vq_vector_populated.txt``
- per-word code histograms (words of interest) -> ``dSentences_words_of_interest_histograms.json``
- the code -> word inventory               -> ``dSentences_vq_words_distrib.json``
- per-factor code metrics (:func:`factor_code_metrics`) -> ``dSentences_vq_factor_metrics.json``

Words are aligned to tokens after the ``[CLS]`` offset, each word taking
``len(tokenizer.encode_word(word))`` positions, as in JAX.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from kindergarten_vq_vae_torch.analyses.common import as_tensor, device_of
from kindergarten_vq_vae_torch.data.dataset import padded_batches
from kindergarten_vq_vae_torch.utils.consts import CLEAN_FACTOR_NAMES

WORDS_OF_INTEREST = (
    "i", "you", "he", "she", "it", "we", "they",
    "am", "are", "is", "was", "were",
    "not",
    "do", "does", "will",
)


def factor_code_metrics(codes, mask, labels, n_e, factor_names=CLEAN_FACTOR_NAMES):
    """Quantitative factor <-> code disentanglement (JAX l.39-110).

    Each token position is a latent dimension whose value is the assigned
    code. For every factor f and position s, the mutual information
    I(label_f ; code_s) over the sentences whose mask covers s, normalised
    by H(label_f). Per factor:

    - ``nmi``: max_s I/H (1.0 = some position's code determines f)
    - ``position``: the argmax s
    - ``gap``: (I_top - I_second)/H over positions (MIG-style)
    - ``purity``: token-level majority-vote accuracy of predicting f from
      the code alone, with the majority-class ``baseline``.

    codes (N, S) int; mask (N, S) 0/1; labels (N, F) int. Pure numpy.
    """
    codes = np.asarray(codes)
    mask = np.asarray(mask).astype(bool)
    labels = np.asarray(labels)
    n, s = codes.shape
    out = {}
    for f in range(labels.shape[1]):
        lab = labels[:, f]
        vals = np.unique(lab)
        p_v = np.array([(lab == v).mean() for v in vals])
        h_f = float(-(p_v * np.log(np.maximum(p_v, 1e-12))).sum())
        name = factor_names[f] if f < len(factor_names) else f"factor_{f}"
        if h_f <= 1e-12:  # constant factor: nothing to disentangle
            out[name] = {"nmi": 0.0, "position": -1, "gap": 0.0,
                         "purity": 1.0, "baseline": 1.0, "entropy": 0.0}
            continue
        mis = np.zeros(s)
        for pos in range(s):
            keep = mask[:, pos]
            if keep.sum() < 2:
                continue
            c, l = codes[keep, pos], lab[keep]
            joint = np.zeros((n_e, len(vals)))
            for vi, v in enumerate(vals):
                joint[:, vi] = np.bincount(c[l == v], minlength=n_e)
            joint /= max(joint.sum(), 1.0)
            pc = joint.sum(1, keepdims=True)
            pl = joint.sum(0, keepdims=True)
            nz = joint > 0
            mis[pos] = float((joint[nz] * np.log(joint[nz] / (pc @ pl)[nz])).sum())
        order = np.argsort(mis)[::-1]
        top, second = mis[order[0]], (mis[order[1]] if s > 1 else 0.0)
        # token-level purity: majority-vote factor value per code
        keep = mask.reshape(-1)
        c_all = codes.reshape(-1)[keep]
        l_all = np.repeat(lab[:, None], s, axis=1).reshape(-1)[keep]
        joint = np.zeros((n_e, len(vals)))
        for vi, v in enumerate(vals):
            joint[:, vi] = np.bincount(c_all[l_all == v], minlength=n_e)
        tot = max(joint.sum(), 1.0)
        purity = float(joint.max(1).sum() / tot)
        baseline = float(joint.sum(0).max() / tot)
        out[name] = {
            "nmi": float(top / h_f),
            "position": int(order[0]),
            "gap": float((top - second) / h_f),
            "purity": purity,
            "baseline": baseline,
            "entropy": h_f,
        }
    return out


def tabulate_word_codes(codes, ids, sentences, tokenizer, woi_distrib: dict, code_words: dict,
                        seen_codes: set) -> None:
    """Add one batch's rows to the tables: every word's codes into
    ``code_words`` and ``seen_codes``, a word of interest's first code into
    ``woi_distrib`` (JAX l.156-167). ``codes`` and ``ids`` are (m, S);
    ``sentences`` the m raw sentences, or None to decode ``ids``."""
    for row in range(len(codes)):
        sent = sentences[row] if sentences else tokenizer.decode(ids[row])
        # align: position 0 is [CLS] when specials are present
        s_i = 1 if ids[row][0] == tokenizer.cls_token_id else 0
        for word in sent.split(" "):
            n_tok = len(tokenizer.encode_word(word))
            v_is = [int(codes[row][s_i + j]) for j in range(n_tok)]
            for v in v_is:
                seen_codes.add(v)
                code_words[v].add(word)
            s_i += n_tok
            if word in woi_distrib:
                woi_distrib[word].append(v_is[0])


@torch.inference_mode()
def unsupervised_vq_disentanglement(cfg, model, splits: dict, tokenizer,
                                    results_dir: str | None = None, lim_batches_pct: float = 0.1,
                                    batch_size: int = 512, words_of_interest=WORDS_OF_INTEREST):
    """``(populated codes, words-of-interest histograms, code -> words,
    factor metrics or None)`` over the first ``lim_batches_pct`` of the
    batches of each split, written into ``results_dir`` when given."""
    n_e = cfg.vq_n_e
    device = device_of(model)
    woi_distrib: dict[str, list[int]] = {w: [] for w in words_of_interest}
    code_words: dict[int, set] = {k: set() for k in range(n_e)}
    seen_codes: set[int] = set()
    all_codes, all_masks, all_labels = [], [], []

    for split in ("train", "val", "test"):
        ds = splits[split]
        n_batches = max(1, int((-(-len(ds) // batch_size)) * lim_batches_pct))
        cols = {"ids": ds.input_ids, "mask": ds.attention_mask}
        for start, m, chunk in padded_batches(cols, batch_size, n_batches):
            ids, mask = chunk["ids"], chunk["mask"]
            sl = slice(start, start + m)
            out = model(as_tensor(ids, device), as_tensor(mask, device))
            codes = out["min_encoding_indices"][..., 0][:m].cpu().numpy()  # (m, S)
            if ds.labels is not None:
                all_codes.append(codes)
                all_masks.append(np.asarray(mask[:m]))
                all_labels.append(np.asarray(ds.labels[sl]))
            tabulate_word_codes(codes, ids, ds.sentences[sl] if ds.sentences else None,
                                tokenizer, woi_distrib, code_words, seen_codes)

    histograms = {w: {k: vals.count(k) for k in range(n_e)} for w, vals in woi_distrib.items()}
    code_words_out = {k: sorted(v) for k, v in code_words.items()}
    factor_metrics = (
        factor_code_metrics(np.concatenate(all_codes), np.concatenate(all_masks),
                            np.concatenate(all_labels), n_e)
        if all_codes else None
    )

    if results_dir is not None:
        os.makedirs(results_dir, exist_ok=True)
        with open(os.path.join(results_dir, "dSentences_vq_vector_populated.txt"), "w") as f:
            f.write(f"the following VQ latent vectors were populated: {sorted(seen_codes)}")
        with open(os.path.join(results_dir, "dSentences_words_of_interest_histograms.json"),
                  "w") as f:
            json.dump(histograms, f)
        with open(os.path.join(results_dir, "dSentences_vq_words_distrib.json"), "w") as f:
            json.dump(code_words_out, f)
        if factor_metrics is not None:
            with open(os.path.join(results_dir, "dSentences_vq_factor_metrics.json"), "w") as f:
                json.dump(factor_metrics, f, indent=1)

    return sorted(seen_codes), histograms, code_words_out, factor_metrics


def _main(argv=None):
    import argparse

    from kindergarten_vq_vae_torch.analyses.common import load_run
    from kindergarten_vq_vae_torch.train.run import load_data

    p = argparse.ArgumentParser(description="unsupervised VQ disentanglement (ref "
                                "analyses/unsupervised_vq_disentanglement)")
    p.add_argument("run_dir")
    p.add_argument("--results-dir", default=None)
    p.add_argument("--lim-batches-pct", type=float, default=0.1)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg, model = load_run(args.run_dir, device=args.device)
    splits, tokenizer = load_data(cfg)
    results_dir = args.results_dir or f"{args.run_dir}/unsupervised_vq_disentanglement"
    codes, histograms, code_words, metrics = unsupervised_vq_disentanglement(
        cfg, model, splits, tokenizer, results_dir=results_dir,
        lim_batches_pct=args.lim_batches_pct, batch_size=args.batch_size)
    print(f"populated codes: {codes}")
    if metrics is not None:
        for name, m in metrics.items():
            print(f"  {name}: nmi={m['nmi']:.3f}@pos{m['position']} gap={m['gap']:.3f} "
                  f"purity={m['purity']:.3f} (baseline {m['baseline']:.3f})")
    print(f"results -> {results_dir}")


if __name__ == "__main__":
    _main()
