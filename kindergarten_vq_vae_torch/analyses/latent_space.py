"""Latent-space scatter visualization.

Counterpart of ``kindergarten_vq_vae_tpu/analyses/latent_space.py`` (the
reference's ``latent_space_visualization.py``): sentence latents (the
encoder's pooler output; on CUDA the layer kernels), filtered to chosen
factor combinations, min-max scaled in two dimensions and scatter-plotted
(when matplotlib is present) coloured by combination.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from kindergarten_vq_vae_torch.analyses.common import as_tensor, device_of, to_numpy
from kindergarten_vq_vae_torch.data.dataset import padded_batches


@torch.inference_mode()
def compute_sentence_latents(model, input_ids, attention_mask, batch_size: int = 512,
                             out_path: str | None = None) -> np.ndarray:
    """(N, H) f32 sentence latents, the encoder's pooler output, over a
    dataset in batches (the reference's cached ``sentence_latent_reps``);
    saved as ``.npy`` to ``out_path`` when given."""
    device = device_of(model)
    cols = {"ids": input_ids, "mask": attention_mask}
    chunks = [to_numpy(model.encoder(as_tensor(c["ids"], device), as_tensor(c["mask"], device))
                       ["pooler_output"][:m])
              for _, m, c in padded_batches(cols, batch_size)]
    latents = np.concatenate(chunks)
    if out_path is not None:
        np.save(out_path, latents)
    return latents


def _minmax(x):
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo + 1e-12)


def latent_space_visualization(latents: np.ndarray, labels: np.ndarray, class_combos: list[tuple],
                               out_path: str | None = None, dims: tuple[int, int] = (0, 1)):
    """``latents`` (N, D); ``labels`` (N, F); ``class_combos`` the label
    tuples to keep. Returns the plotted points per combo; writes a PNG when
    matplotlib is available and ``out_path`` is given."""
    points = {}
    for combo in class_combos:
        sel = np.all(labels == np.asarray(combo), axis=1)
        if sel.any():
            pts = latents[sel][:, list(dims)]
            points[combo] = np.stack([_minmax(pts[:, 0]), _minmax(pts[:, 1])], axis=1)

    if out_path is not None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return points
        fig, ax = plt.subplots(figsize=(5, 4))
        for combo, pts in points.items():
            ax.scatter(pts[:, 0], pts[:, 1], s=8, label=str(combo), alpha=0.7)
        ax.legend(fontsize=6)
        ax.set_title("sentence latent space")
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return points


def _main(argv=None):
    """Compute (or load the cached) sentence latents of a run, filter them to
    factor combinations, min-max scale two dimensions and scatter-plot them."""
    import argparse
    import json

    from kindergarten_vq_vae_torch.analyses.common import load_run
    from kindergarten_vq_vae_torch.train.run import load_data

    p = argparse.ArgumentParser(description="latent-space scatter visualization")
    p.add_argument("run_dir")
    p.add_argument("--split", default="test", choices=("train", "val", "test"))
    p.add_argument("--combos", default=None,
                   help="JSON list of 5-factor label tuples to plot; default: the 8 most "
                        "frequent combinations")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--dims", default="0,1")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg, model = load_run(args.run_dir, device=args.device)
    splits, _ = load_data(cfg)
    split = splits[args.split]
    labels = np.asarray(split.labels)
    cache = os.path.join(args.run_dir, f"sentence_latent_reps_{args.split}.npy")
    if os.path.exists(cache):
        latents = np.load(cache)
    else:
        latents = compute_sentence_latents(model, np.asarray(split.input_ids),
                                           np.asarray(split.attention_mask),
                                           batch_size=args.batch_size, out_path=cache)
    if args.combos:
        combos = [tuple(c) for c in json.loads(args.combos)]
    else:
        uniq, counts = np.unique(labels, axis=0, return_counts=True)
        combos = [tuple(int(v) for v in row) for row in uniq[np.argsort(-counts)][:8]]
    dims = tuple(int(d) for d in args.dims.split(","))
    out_png = os.path.join(args.run_dir, "latent_space_visualization.png")
    points = latent_space_visualization(latents, labels, combos, out_path=out_png, dims=dims)
    print(f"{len(points)} combos plotted -> {out_png} (latents cached at {cache})")


if __name__ == "__main__":
    _main()
