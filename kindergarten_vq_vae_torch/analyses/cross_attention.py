"""Cross- and self-attention extraction, and heatmaps.

Counterpart of ``kindergarten_vq_vae_tpu/analyses/cross_attention.py`` (the
reference's ``extract_model_cross_attention.py`` and
``plot_model_cross_attention.py``): the decoder runs with
``output_attentions=True`` (the per-module route, as in JAX) over batches;
each batch's maps are averaged over its rows, then over the batches, for
the cross- and the self-attention alike. Every variant takes its own
forward (JAX l.40-47); the Gumbel noise of Shelgon, Shelgon2 and
Shelgon3-Gumbel comes from a generator seeded 0 on each batch, the
counterpart of JAX's ``key(0)``.

A run with the GPT-2 decoder raises ``ValueError`` before any forward: that
decoder returns no self-attention maps (``attentions = ()``, JAX
``nn/gpt2.py:164``), so JAX's ``jnp.stack`` of them fails (l.51); the port
says why instead (a recorded divergence in the exception only).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from kindergarten_vq_vae_torch.analyses.common import as_tensor, device_of, refuse_gpt2_decoder
from kindergarten_vq_vae_torch.data.dataset import padded_batches


@torch.inference_mode()
def extract_cross_attention(model, input_ids: np.ndarray, attention_mask: np.ndarray,
                            batch_size: int = 256, model_kind: str = "auto",
                            out_path: str | None = None) -> dict:
    """Mean attention maps over the dataset: ``cross_attns`` and
    ``self_attns``, each (layers, heads, S, S) f32; an ``.npz`` at
    ``out_path`` when given. The means are taken in f32 (a recorded
    divergence: JAX keeps them in the compute dtype, where rounding each
    bf16 mean moves a row's sum off 1 by up to ~6e-3)."""
    refuse_gpt2_decoder(model, "extract_cross_attention",
                        "the GPT-2 decoder returns no self-attention maps")
    if model_kind == "auto":
        model_kind = type(model).__name__.lower()
    device = device_of(model)
    sums_cross = sums_self = None
    n_batches = 0
    for _, _, chunk in padded_batches({"ids": input_ids, "mask": attention_mask}, batch_size):
        ids_t, mask_t = as_tensor(chunk["ids"], device), as_tensor(chunk["mask"], device)
        kw = dict(output_attentions=True, generator=torch.Generator(device=device).manual_seed(0))
        if model_kind in ("bagon", "shelgon"):
            out = model(ids_t, mask_t, ids_t, mask_t, **kw)
        elif model_kind == "shelgon3":
            out = model(ids_t, mask_t, is_training=False, **kw)
        else:
            out = model(ids_t, mask_t, **kw)
        # (layers, B, heads, S, S) -> mean over the batch -> (layers, heads, S, S)
        cross = torch.stack(out["decoder_cross_attentions"]).float().mean(1)
        self_ = torch.stack(out["decoder_attentions"]).float().mean(1)
        sums_cross = cross if sums_cross is None else sums_cross + cross
        sums_self = self_ if sums_self is None else sums_self + self_
        n_batches += 1
    result = {"cross_attns": (sums_cross / n_batches).cpu().numpy(),
              "self_attns": (sums_self / n_batches).cpu().numpy()}
    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.savez(out_path, **result)
    return result


def plot_cross_attention(attns: np.ndarray, out_dir: str, prefix: str = "cross_attn"):
    """Heatmaps per layer and head, plus the head mean of each layer and the
    mean over both; the PNG paths, or an empty list without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return []

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    n_layers, n_heads = attns.shape[:2]

    def _save(mat, name, title):
        fig, ax = plt.subplots(figsize=(4, 3.5))
        im = ax.imshow(mat, cmap="viridis", aspect="auto")
        fig.colorbar(im, ax=ax)
        ax.set_title(title)
        ax.set_xlabel("key position")
        ax.set_ylabel("query position")
        path = os.path.join(out_dir, f"{name}.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)

    for layer in range(n_layers):
        for head in range(n_heads):
            _save(attns[layer, head], f"{prefix}_l{layer}_h{head}", f"layer {layer} head {head}")
        _save(attns[layer].mean(axis=0), f"{prefix}_l{layer}_headmean",
              f"layer {layer} (head mean)")
    _save(attns.mean(axis=(0, 1)), f"{prefix}_layerheadmean", "layer+head mean")
    return paths


def _main(argv=None):
    import argparse

    from kindergarten_vq_vae_torch.analyses.common import load_run
    from kindergarten_vq_vae_torch.train.run import load_data

    p = argparse.ArgumentParser(description="cross-attention extraction + heatmaps (ref "
                                "analyses/cross_attention)")
    p.add_argument("run_dir")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg, model = load_run(args.run_dir, device=args.device)
    splits, _ = load_data(cfg)
    test = splits["test"]
    out_path = f"{args.run_dir}/attention_maps.npz"
    result = extract_cross_attention(model, test.input_ids, test.attention_mask,
                                     batch_size=args.batch_size, model_kind=cfg.model_name,
                                     out_path=out_path)
    print(f"saved {out_path}: cross {result['cross_attns'].shape}, "
          f"self {result['self_attns'].shape}")
    if args.plot:
        paths = plot_cross_attention(result["cross_attns"], f"{args.run_dir}/attention_plots")
        print(f"{len(paths)} heatmaps -> {args.run_dir}/attention_plots")


if __name__ == "__main__":
    _main()
