"""Offline k-means codebook initialisation.

Counterpart of ``kindergarten_vq_vae_tpu/train/codebook_init.py`` (the
reference's ``models/shelgon3/vq_codebook_init_weights.py``): encode the
train split with a frozen Bagon encoder in eval mode, flatten the hidden
states to ``(N * S, H)``, run k-means with ``n_e`` codes and save the
codebook as a ``.npy`` that ``vq_codebook_init_values_path`` reads. The
work is split in three so that each part can be held against JAX:
:func:`encode_rows` (the sweep; on CUDA every layer is kernel #1),
:func:`~kindergarten_vq_vae_torch.ops.vq.kmeans_codebook_init_with` and
:func:`codebook_diagnostics`.

    python -m kindergarten_vq_vae_torch.train.codebook_init \\
        [--bagon-ckpt RUN_DIR/bagon_ckpt_loss_recon_val_best] \\
        [--config run_conf.json] [--n-e 9] [--out codebook_init.npy] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch import nn

from kindergarten_vq_vae_torch.ckpt.checkpoint import load_params
from kindergarten_vq_vae_torch.config import RunConfig, refuse_unported_route
from kindergarten_vq_vae_torch.data.dataset import padded_batches
from kindergarten_vq_vae_torch.models import bert_configs, init_weights
from kindergarten_vq_vae_torch.nn.bert import BertModel
from kindergarten_vq_vae_torch.ops.vq import kmeans_codebook_init

# rows of z_flat cast to f32 at a time by the amplitude statistics
STAT_CHUNK_ROWS = 65536


def bagon_encoder(cfg: RunConfig, bagon_ckpt_path: str | None = None, seed: int = 0,
                  device="cuda") -> BertModel:
    """The run's encoder in eval mode: loaded from a Bagon bundle's
    ``encoder`` leaves, or (without one) a Bagon encoder initialised from
    ``seed``."""
    device = torch.device(device)
    refuse_unported_route(cfg, device)
    enc_cfg, _ = bert_configs(dataclasses.replace(cfg, model_name="bagon"))
    holder = nn.Module()  # parameter names under "encoder.", as in a Bagon bundle
    holder.encoder = BertModel(enc_cfg, device)
    init_weights(holder, torch.Generator(device=device).manual_seed(seed))
    if bagon_ckpt_path is not None:
        load_params(holder, bagon_ckpt_path, prefixes=("encoder",))
    return holder.encoder.eval()


@torch.inference_mode()
def encode_rows(encoder: BertModel, input_ids: np.ndarray, attention_mask: np.ndarray,
                batch_size: int = 2048) -> torch.Tensor:
    """``(N * S, H)`` last hidden states of ``encoder`` over the rows, in its
    compute dtype on its device: batches of ``batch_size``, the last padded
    with its first row and trimmed (JAX l.78-92)."""
    device = next(encoder.parameters()).device
    n, seq = input_ids.shape
    h = encoder.cfg.hidden_size
    z_flat = torch.empty((n * seq, h), dtype=encoder.cfg.dtype, device=device)
    cols = {"ids": np.asarray(input_ids, np.int64), "mask": np.asarray(attention_mask, np.int32)}
    for start, m, c in padded_batches(cols, batch_size):
        out = encoder(torch.from_numpy(c["ids"]).to(device), torch.from_numpy(c["mask"]).to(device))
        z_flat[start * seq:(start + m) * seq] = out["last_hidden_state"][:m].reshape(-1, h)
    return z_flat


@torch.inference_mode()
def amplitude_stats(z_flat: torch.Tensor, chunk_rows: int = STAT_CHUNK_ROWS) -> tuple[float, float]:
    """``(mean over columns of the per-column std, RMS)`` of ``z_flat`` in
    f32 (JAX l.110-116), in chunks of ``chunk_rows`` cast to f32 and summed
    into f64, never a second full f32 copy of ``z_flat`` (at the full corpus
    that copy is ~4 GB): the column means first, then the squared
    deviations from them."""
    n, d = z_flat.shape
    f64 = dict(dtype=torch.float64, device=z_flat.device)
    col_sum, col_dev, sq = torch.zeros(d, **f64), torch.zeros(d, **f64), torch.zeros((), **f64)
    for i in range(0, n, chunk_rows):
        c = z_flat[i:i + chunk_rows].float()
        col_sum += c.sum(0)
        sq += (c * c).sum()
    mean = (col_sum / n).float()
    for i in range(0, n, chunk_rows):
        dev = z_flat[i:i + chunk_rows].float() - mean
        col_dev += (dev * dev).sum(0)
    std = torch.sqrt(col_dev / n).mean()
    return float(std), float(torch.sqrt(sq / (n * d)))


def codebook_diagnostics(z_flat: torch.Tensor, codebook: np.ndarray) -> dict:
    """The collapse detectors of JAX l.94-144, with the same keys: the
    encoder outputs' per-element std and RMS and their ``amplitude_ratio``
    (encoder variation below bf16's relative resolution of the activation
    magnitude is erased by a bf16 trunk at eval), the centroids' pairwise
    distances and norms, the RMS distance of a row to its nearest centroid
    on the f64 subsample ``z_flat[:: max(1, N // 65536)]`` (centred by the
    subsample's mean) and ``separation_ratio``, the smallest centroid
    distance over that in-cluster RMS."""
    z_std, z_rms = amplitude_stats(z_flat)
    n_e = codebook.shape[0]
    d = codebook[:, None, :] - codebook[None, :, :]
    dist = np.sqrt((d * d).sum(-1))
    iu = np.triu_indices(n_e, 1)
    samp = z_flat[:: max(1, z_flat.shape[0] // 65536)].double().cpu().numpy()
    c64 = np.asarray(codebook, np.float64)
    gmean = samp.mean(0, keepdims=True)
    d2 = (((samp - gmean) ** 2).sum(1, keepdims=True) + ((c64 - gmean) ** 2).sum(1)
          - 2.0 * (samp - gmean) @ (c64 - gmean).T)
    rms_in = float(np.sqrt(np.maximum(d2.min(1), 0.0).mean()))
    return {
        "encoder_per_element_std": z_std,
        "encoder_per_element_rms": z_rms,
        "amplitude_ratio": z_std / max(z_rms, 1e-12),
        "centroid_dist_min": float(dist[iu].min()),
        "centroid_dist_mean": float(dist[iu].mean()),
        "centroid_norm_mean": float(np.linalg.norm(codebook, axis=1).mean()),
        "in_cluster_rms": rms_in,
        "separation_ratio": float(dist[iu].min() / max(rms_in, 1e-12)),
    }


def compute_codebook_init(cfg: RunConfig, train_split, bagon_ckpt_path: str | None = None,
                          n_e: int | None = None, batch_size: int = 2048,
                          out_path: str | None = None, seed: int = 0,
                          return_diagnostics: bool = False, device="cuda"):
    """The ``(n_e, hidden)`` f32 codebook init (saved as ``.npy`` to
    ``out_path`` if given), and with ``return_diagnostics`` the dict of
    :func:`codebook_diagnostics`. The encoder comes from ``bagon_ckpt_path``
    or is a Bagon encoder initialised from ``seed``; the k-means rows are
    drawn from a CPU generator seeded with ``seed``."""
    n_e = n_e or cfg.vq_n_e
    encoder = bagon_encoder(cfg, bagon_ckpt_path, seed, device)
    z_flat = encode_rows(encoder, train_split.input_ids, train_split.attention_mask, batch_size)
    del encoder
    with torch.inference_mode():
        codebook = kmeans_codebook_init(z_flat, n_e, torch.Generator().manual_seed(seed))
    codebook = codebook.float().cpu().numpy()
    if out_path is not None:
        np.save(out_path, codebook)
    if not return_diagnostics:
        return codebook
    diag = codebook_diagnostics(z_flat, codebook)
    print(f"[codebook_init] diagnostics: {diag}", flush=True)
    return codebook, diag


def _main(argv=None):
    """Encode the train split with a (frozen) Bagon encoder, k-means the
    flattened hidden states and save the ``(n_e, hidden)`` init values as
    ``.npy`` (the reference's ``vq_codebook_init_weights.py``)."""
    import argparse

    from kindergarten_vq_vae_torch.train.run import load_data

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--bagon-ckpt", default=None,
                    help="Bagon checkpoint dir (random-init encoder if omitted)")
    ap.add_argument("--config", default=None, help="run_conf.json for geometry")
    ap.add_argument("--n-e", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--out", default="codebook_init.npy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = RunConfig.load(args.config) if args.config else RunConfig()
    if cfg.model_name != "shelgon3":
        cfg = dataclasses.replace(cfg, model_name="shelgon3")
    splits, _ = load_data(cfg)
    t0 = time.perf_counter()
    cb = compute_codebook_init(cfg, splits["train"], bagon_ckpt_path=args.bagon_ckpt,
                               n_e=args.n_e, batch_size=args.batch, out_path=args.out,
                               seed=args.seed, device=args.device)
    print(f"[codebook_init] saved {cb.shape} -> {args.out} ({len(splits['train'])} train "
          f"sentences, {time.perf_counter() - t0:.3f} s)")


if __name__ == "__main__":
    _main()
