#!/usr/bin/env python3
"""Device time of the port's attention kernels, for an A/B of two trees on one card.

    python3 scripts/ab_attention.py [--root DIR] [--iters 50] [--dtype bfloat16|float32]
                                    [--batch 2048] [--seq 12] [--heads 12]

Imports ``kindergarten_vq_vae_torch`` from ``--root`` (default: this
checkout), so the same script times another commit unpacked beside it
(``git archive <commit> | tar -x -C runs/<dir>``); run both trees in turns
(parent, change, change, parent) in one call. Each entry is the mean device
time of one call (CUDA events around ``--iters`` calls after a warm-up) at
the bert-base widths: ``--batch`` sentences x ``--seq`` tokens (dropout 0.1;
2048 x 12 by default, the step's shape; past 32 tokens, e.g. ``--batch 256
--seq 64``, the long kernels of csrc/attention_long.cu), H 768, ``--heads``
heads (12; 4 or fewer: head_dim past 128, attention_long.cu's wide kernels
in 64-column chunks: ``--heads 4`` at ``--seq`` 12, 64 and 512 with
``--batch`` 2048, 256 and 16 times the head_dim-192 rows of PERF.md), and the
bucket-256 serving forward at ``--seq`` tokens (rate 0), in
``--dtype`` (bf16 by default; float32 times the f32 instances,
csrc/attention_f32.cuh):

- ``attn_fwd_*``: the attention forward inside #1 alone (``attention_forward``,
  where the tree has it);
- ``sdpa_fwd_*`` (#11; the same device code as #1's attention, op ids from
  0), ``sdpa_bwd_*`` (#12), ``attn_bwd_*`` (#3 self from a packed qkv with a
  padded mask, #4 cross from q and a packed kv, op ids from 13), ``mha``
  (#13, padded mask);
- ``library_*``: ``F.scaled_dot_product_attention`` and its autograd
  backward at the same shapes (rate 0, head transposes), a yardstick, its
  backend pinned with ``torch.nn.attention.sdpa_kernel`` (``backends`` in
  the output): flash in bf16 (which takes no mask: the padded keys stay
  unmasked; up to head_dim 256), memory-efficient otherwise (with the mask);
- ``serving_forward``: the median host time of 20 synchronized bucket-256
  forwards of a seeded bert-base Shelgon3-VQ (fused layers, ``--dtype``,
  inference mode), the path a served ``/reconstruct`` runs.

The last line is one JSON object with the times, the card's name and
``nvidia-smi``'s name and power limit. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, H, TRAIN_BATCH, BUCKET = 12, 768, 2048, 256


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _library(q, k, v, mask, causal: bool, nh: int):
    """``F.scaled_dot_product_attention``'s forward call and its autograd
    backward's call on the same inputs (rate 0, ``nh`` heads), its backend
    pinned (flash in bf16 up to head_dim 256, without the mask;
    memory-efficient otherwise), and that backend's name."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, _ = q.shape
    heads = [t.reshape(b, t.shape[1], nh, H // nh).transpose(1, 2) for t in (q, k, v)]
    flash = q.dtype == torch.bfloat16 and H // nh <= 256
    backend = SDPBackend.FLASH_ATTENTION if flash else SDPBackend.EFFICIENT_ATTENTION
    attn = None
    if not flash and (mask is not None or causal):
        attn = torch.ones(b, 1, s, k.shape[1], dtype=torch.bool, device="cuda")
        if mask is not None:
            attn = attn & (mask[:, None, None, :] > 0)
        if causal:
            attn = attn & torch.ones(s, k.shape[1], dtype=torch.bool, device="cuda").tril()
    kw = {"is_causal": causal} if flash else {"attn_mask": attn}
    with torch.enable_grad(), sdpa_kernel([backend]):
        leaves = [t.detach().contiguous().requires_grad_() for t in heads]
        out = F.scaled_dot_product_attention(*leaves, **kw)
    gh = torch.randn_like(out)

    def fwd():
        with torch.no_grad(), sdpa_kernel([backend]):
            return F.scaled_dot_product_attention(*heads, **kw)

    def bwd():
        with sdpa_kernel([backend]):
            return torch.autograd.grad(out, leaves, gh, retain_graph=True)

    return fwd, bwd, backend.name + (" (keys unmasked)" if flash and mask is not None else "")


def _serving_forward_ms(dtype: str, seq: int, nh: int, rounds: int = 20) -> float:
    import torch

    from kindergarten_vq_vae_torch.config import RunConfig
    from kindergarten_vq_vae_torch.models import build_model, init_weights

    cfg = RunConfig(model_name="shelgon3", compute_dtype=dtype, num_heads=nh)
    model = init_weights(build_model(cfg, device="cuda"),
                         torch.Generator(device="cuda").manual_seed(0)).eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(1, cfg.vocab_size, (BUCKET, seq), device="cuda", generator=g)
    lens = torch.randint(1, seq + 1, (BUCKET,), device="cuda", generator=g)
    mask = (torch.arange(seq, device="cuda")[None] < lens[:, None]).to(torch.int32)
    times = []
    with torch.inference_mode():
        for i in range(rounds + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(ids, mask)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    del model
    torch.cuda.empty_cache()
    return statistics.median(times[2:])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--batch", type=int, default=TRAIN_BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--heads", type=int, default=12)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_attention.py needs a CUDA device")
    from kindergarten_vq_vae_torch.ops import layer
    from kindergarten_vq_vae_torch.ops.attention import mha_forward
    from kindergarten_vq_vae_torch.ops.dropout import cross_op
    from kindergarten_vq_vae_torch.ops.sdpa import sdpa_backward, sdpa_forward

    if not os.path.abspath(layer.__file__).startswith(root + os.sep):
        sys.exit(f"imported {layer.__file__}, not the tree at {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    seed, it, ms, backends = 12345, args.iters, {}, {}
    dtype, S, NH = getattr(torch, args.dtype), args.seq, args.heads

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    def mask(batch):
        lens = torch.randint(1, S + 1, (batch,), device="cuda", generator=g)
        return (torch.arange(S, device="cuda")[None] < lens[:, None]).to(torch.int32)

    with torch.no_grad():
        for kind, batch, rate in (("self", args.batch, 0.1), ("cross", args.batch, 0.1),
                                  ("serving", BUCKET, 0.0)):
            cross = kind == "cross"
            if cross:
                packed, kv = rand(batch, S, H), rand(batch, S, 2 * H)
                q, (k, v) = packed, kv.split(H, -1)
            else:
                packed, kv = rand(batch, S, 3 * H), None
                q, k, v = packed.split(H, -1)
            m = None if cross else mask(batch)
            causal, op = False, cross_op(NH) if cross else 0
            gr = rand(batch, S, H)
            if hasattr(layer, "attention_forward"):
                ms[f"attn_fwd_{kind}"] = _time_ms(
                    lambda: layer.attention_forward(packed, kv, m, NH, causal, seed, op, rate), it)
            ms[f"sdpa_fwd_{kind}"] = _time_ms(
                lambda: sdpa_forward(q, k, v, m, seed, NH, causal, rate, cross), it)
            lib_fwd, lib_bwd, backends[kind] = _library(q, k, v, m, causal, NH)
            ms[f"library_fwd_{kind}"] = _time_ms(lib_fwd, it)
            if kind == "serving":
                continue
            ms[f"sdpa_bwd_{kind}"] = _time_ms(
                lambda: sdpa_backward(q, k, v, m, seed, gr, NH, causal, rate, cross), it)
            ms[f"attn_bwd_{kind}"] = _time_ms(
                lambda: layer.attention_backward(packed, kv, m, gr, NH, causal, seed, op, rate), it)
            with torch.enable_grad():
                ms[f"library_bwd_{kind}"] = _time_ms(lib_bwd, it)
            if kind == "self":
                ms["mha"] = _time_ms(lambda: mha_forward(q, k, v, m, NH), it)
    ms["serving_forward"] = _serving_forward_ms(args.dtype, S, NH)
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "dtype": args.dtype, "batch": args.batch, "seq": S, "heads": NH,
                      "iters": it,
                      "backends": backends, "ms": ms}))


if __name__ == "__main__":
    main()
