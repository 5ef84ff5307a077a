"""Max-accuracy sentence filter.

Counterpart of ``kindergarten_vq_vae_tpu/analyses/max_acc.py`` (the reference's
``analyses/get_max_acc_sentences.py:24-33``) — filter
``decoded_sentences.feather`` to ``sentence_acc > 0.999``, write a markdown
table + feather used by the traversal/arithmetic analyses.
"""

from __future__ import annotations

import os


def get_max_acc_sentences(run_path: str, threshold: float = 0.999, out_dir: str | None = None):
    import pandas as pd

    src = os.path.join(run_path, "decoded_sentences.feather")
    if os.path.exists(src):
        df = pd.read_feather(src)
    else:
        df = pd.read_json(os.path.join(run_path, "decoded_sentences.jsonl"), lines=True)
    filtered = df[df.sentence_acc > threshold].reset_index(drop=True)

    out_dir = out_dir or run_path
    os.makedirs(out_dir, exist_ok=True)
    filtered.to_feather(os.path.join(out_dir, "max_acc_sentences.feather"))
    with open(os.path.join(out_dir, "max_acc_sentences.md"), "w") as f:
        f.write(filtered.to_markdown(index=False))
    return filtered


def _main():
    import argparse

    p = argparse.ArgumentParser(
        description="filter decoded_sentences to sentence_acc > threshold "
                    "(ref analyses/get_max_acc_sentences.py:24-33)")
    p.add_argument("run_dir")
    p.add_argument("--threshold", type=float, default=0.999)
    p.add_argument("--out-dir", default=None)
    args = p.parse_args()
    df = get_max_acc_sentences(args.run_dir, args.threshold, args.out_dir)
    print(f"{len(df)} max-acc sentences -> {args.out_dir or args.run_dir}/max_acc_sentences.feather")


if __name__ == "__main__":
    _main()
