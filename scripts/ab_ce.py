#!/usr/bin/env python3
"""Device time of the CE backward kernel (#8), for an A/B of two trees on one card.

    python3 scripts/ab_ce.py [--root DIR] [--iters 20]

Imports ``kindergarten_vq_vae_torch`` from ``--root`` (default: this
checkout), so the same script times another commit unpacked beside it
(``git archive <commit> | tar -x -C runs/<dir>``); run both trees in turns
(parent, change, change, parent) in one call. At the training step's rows,
24,576 (batch 2048 x 12), and the vocabularies of the BERT decoder (30,522)
and the GPT-2 decoder (50,257), in bf16 and f32, with logits of std 3 at
offset 0 (as a model's are) and uniform targets, each entry holds:

- ``ms``: the mean device time of one ``ce_bwd`` call (CUDA events around
  ``--iters`` calls after a warm-up; the 1.5-4.9 GB of logits dwarf the
  50 MB L2, so every call reads them from device memory);
- ``bound_ms``: the logits read and the gradient written once, with the
  per-row targets, lse and scale, over 3.35 TB/s (the operations, 5 an
  element at 67 TFLOP/s, take less), and ``share`` = bound / ms;
- ``library_ms``: the autograd backward of ``F.cross_entropy(reduction=
  'none')`` fed ``scale``, the same function in one PyTorch call;
- ``copy_ms``: ``Tensor.copy_`` of the logits into a tensor of their size,
  the same bytes read and written with no arithmetic (what a device copy
  reaches of the byte bound);
- ``max_rel``: the kernel's largest difference from ``ce_bwd_reference``
  over the largest magnitude.

The last line is one JSON object with the entries, the card's name and
``nvidia-smi``'s name and power limit. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, VOCABS, HBM_BYTES_PER_S = 24576, (30522, 50257), 3.35e12


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("ab_ce.py needs a CUDA device")
    from kindergarten_vq_vae_torch.ops import ce

    if not os.path.abspath(ce.__file__).startswith(root + os.sep):
        sys.exit(f"imported {ce.__file__}, not the tree at {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for vocab in VOCABS:
            x = (3.0 * torch.randn(ROWS, vocab, device="cuda", generator=g)).to(dtype)
            t = torch.randint(0, vocab, (ROWS,), device="cuda", generator=g, dtype=torch.int32)
            with torch.no_grad():
                lse = torch.logsumexp(x.float(), 1)
                scale = torch.full((ROWS,), 1.0 / ROWS, device="cuda")
                got = ce.ce_bwd(x, t, lse, scale)
                want = ce.ce_bwd_reference(x, t, lse, scale)
                rel = ((got.float() - want).abs().max() / want.abs().max()).item()
                del got, want
                ms = _time_ms(lambda: ce.ce_bwd(x, t, lse, scale), args.iters)
            with torch.enable_grad():
                leaf = x.detach().requires_grad_()
                nll = F.cross_entropy(leaf, t.long(), reduction="none")
                lib_ms = _time_ms(lambda: torch.autograd.grad(nll, leaf, scale.to(nll.dtype),
                                                              retain_graph=True), args.iters)
            dst = torch.empty_like(x)
            copy_ms = _time_ms(lambda: dst.copy_(x), args.iters)
            del dst
            nbytes = 2 * x.numel() * x.element_size() + 3 * 4 * ROWS
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            key = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_{vocab}"
            out[key] = {"ms": ms, "bound_ms": bound, "share": bound / ms, "library_ms": lib_ms,
                        "copy_ms": copy_ms, "max_rel": rel}
            print(f"{key}: ce_bwd {ms:.4f} ms ({bound / ms:.1%} of {bound:.4f}), library "
                  f"{lib_ms:.4f} ms, copy_ {copy_ms:.4f} ms, max rel {rel:.2e}", flush=True)
            del x, t, lse, scale, leaf, nll
            torch.cuda.empty_cache()
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "iters": args.iters, "ce_bwd": out}))


if __name__ == "__main__":
    main()
