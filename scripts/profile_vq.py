#!/usr/bin/env python3
"""Where the time of the VQ general path (#5 past the one-pass kernel) and of
the codebook gradient (5+) goes, kernel by kernel, on one CUDA card.

    python3 scripts/profile_vq.py [--rows 24576] [--iters 10]

At ``--rows`` rows (the training step's 24,576 by default), 512 codes x 768
and 1,024 codes x 1,280, seeded z ~ N(0, 1) and codes uniform in +-1/n_e,
and 512 x 768 collapsed: the rows shifted along one direction (4 sqrt(D)),
as a freshly initialised encoder's rows share a direction, so that a few
codes take every row (the long codes' path of the grouped sums):

- the raw forward (``ops/vq_kernel.py`` ``_launch_packed``) and the codebook
  gradient (``ops/vq.py`` ``codebook_grad``) alone, and the codebook gradient
  from the grouping the forward leaves (the training step's route), as device
  time per call (a CUDA graph of ``--iters`` calls replayed between CUDA
  events);
- ``torch.profiler`` device time per call of each kernel over five calls of
  the forward and five of the codebook gradient from the forward's grouping
  (the GEMM of the distances' products, the screen and recheck, the grouping's
  count, scan and scatter, the grouped sums; ``n`` launches in all).

The last line is one JSON object with the card's name and ``nvidia-smi``'s
name and power limit beside the numbers. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _graph_ms(fn, calls: int) -> float:
    """Device time of one call: ``calls`` calls in a CUDA graph replayed
    between CUDA events, after a warm-up off the capture."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * calls)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=24576)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_vq.py needs a CUDA device")
    from kindergarten_vq_vae_torch.ops.vq import codebook_grad
    from kindergarten_vq_vae_torch.ops.vq_kernel import _launch_packed

    g = torch.Generator(device="cuda").manual_seed(24)
    out = {}
    for d, n_e, collapsed in ((768, 512, False), (1280, 1024, False), (768, 512, True)):
        z = torch.randn(args.rows, d, device="cuda", generator=g)
        e = (torch.rand(n_e, d, device="cuda", generator=g) * 2 - 1) / n_e
        if collapsed:  # rows along one direction: a few codes take them all
            u = torch.randn(d, device="cuda", generator=g)
            z = z + 4.0 * u / u.norm() * d**0.5
        gd = torch.tensor(0.37 / args.rows, device="cuda")
        _, idx, _, group = _launch_packed(z, e)
        case = {"vq_ms": _graph_ms(lambda: _launch_packed(z, e), args.iters),
                "codebook_grad_ms": _graph_ms(lambda: codebook_grad(z, idx, e, gd), args.iters),
                "codebook_grad_from_forward_ms": _graph_ms(
                    lambda: codebook_grad(z, idx, e, gd, group), args.iters)}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                _launch_packed(z, e)
                codebook_grad(z, idx, e, gd, group)
            torch.cuda.synchronize()
        kernels = {}
        for ev in prof.key_averages():
            if ev.device_time_total > 0:
                name = ev.key.replace("void ", "").replace("(anonymous namespace)::", "")
                name = name.replace("kvq::", "").replace("f32gemm::", "").split("(")[0]
                kernels[name[:80]] = {"ms": ev.device_time_total / 5 / 1e3, "n": ev.count}
        case["kernels"] = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"]))
        used = torch.bincount(idx, minlength=n_e)
        case["codes_used"], case["rows_of_the_largest_code"] = int((used > 0).sum()), int(used.max())
        out[f"{n_e}x{d}" + (" collapsed" if collapsed else "")] = case
        print(f"{n_e} codes x {d}{' collapsed' if collapsed else ''}, {args.rows} rows "
              f"({case['codes_used']} codes used, the largest {case['rows_of_the_largest_code']} "
              f"rows): vq {case['vq_ms']:.4f} ms, codebook_grad "
              f"{case['codebook_grad_ms']:.4f} ms, from the forward's grouping "
              f"{case['codebook_grad_from_forward_ms']:.4f} ms", flush=True)
        for name, k in case["kernels"].items():
            print(f"  {name:80s} {k['ms']:.4f} ms a call (n={k['n']})")
        del z, e, idx, group
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi[0] if smi else "",
                      "rows": args.rows, "cases": out}))


if __name__ == "__main__":
    main()
