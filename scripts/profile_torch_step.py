#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch port goes, on one CUDA card.

    python3 scripts/profile_torch_step.py [--batch 2048] [--steps 3] [--fused-head-ce off]

Builds a seeded full-width bert-base Shelgon3-VQ (bf16, dropout 0.1 / 0.1,
AMSGrad lr 1e-4; ``--fused-head-ce store`` or ``flash``: the loss through the
fused head + CE, kernels #9 and #10, in place of the logits path), warms up,
then reports for one batch of ``--batch`` x 12 tokens:

- the wall time of a step (host clock around a synchronized step);
- device time of forward, backward and optimizer update (CUDA events at the
  step's phase marks; the update is kernel #14);
- ``torch.profiler`` device time over ``--steps`` steps, grouped by kernel
  family and divided by the step count, the ten largest kernels of the
  catch-all PyTorch family, and the device idle share
  ``1 - kernel time / wall``.

The last line is one JSON object with the numbers. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# kernel-name fragment -> family, first match wins
FAMILIES = (
    ("adam_amsgrad_kernel", "AMSGrad update (kernel #14)"),
    ("head_ce_fwd_kernel", "fused head + CE forward (#9)"),
    ("head_ce_merge_kernel", "fused head + CE forward (#9)"),
    ("head_ce_bwd_kernel", "fused head + CE backward (#10: g, dbias partials)"),
    ("gemm_kernel<false, false", "fused head + CE backward (#10: dx GEMM, wmma)"),
    ("gemm_kernel<true, false, 0>", "fused head table gradient (wmma GEMM, f32 out)"),
    ("gemm_bias_kernel", "layer GEMM, forward (wmma)"),
    ("gemm_kernel<false, true", "layer GEMM, dgrad (wmma)"),
    ("gemm_kernel<true, false, 8>", "layer GEMM, wgrad split-K partials (wmma)"),
    ("gemm_kernel<true, false", "layer GEMM, wgrad (wmma)"),
    ("splitk_reduce", "split-K sums (layer wgrad; #10's dbias)"),
    ("attention_bwd_kernel", "attention backward"),
    ("attention_kernel", "attention forward"),
    ("residual_layernorm", "residual + LayerNorm forward"),
    ("ln_bwd_kernel", "LayerNorm backward"),
    ("parts_reduce", "column sums (LN / bias gradients)"),
    ("colsum_kernel", "column sums (LN / bias gradients)"),
    ("ce_fwd_kernel", "CE forward"),
    ("ce_bwd", "CE backward"),
    ("vq_", "VQ forward"),
    ("nvjet", "cuBLAS (head, pooler, MLM transform)"),
    ("gemm", "cuBLAS (head, pooler, MLM transform)"),
    ("cutlass", "cuBLAS (head, pooler, MLM transform)"),
    ("Memset", "memset"),
    ("Memcpy", "memcpy"),
)


OTHER = "torch elementwise / reduction (casts, embeddings, VQ backward)"


def family(name: str) -> str:
    for frag, fam in FAMILIES:
        if frag in name:
            return fam
    return OTHER


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--fused-head-ce", choices=("off", "store", "flash"), default="off")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_step.py needs a CUDA device")
    from kindergarten_vq_vae_torch.config import RunConfig
    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = RunConfig(model_name="shelgon3", compute_dtype="bfloat16",
                    fused_head_ce=args.fused_head_ce)
    model = init_weights(build_model(cfg, device="cuda", fused_head=args.fused_head_ce != "off"),
                         torch.Generator(device="cuda").manual_seed(0))
    state = init_train_state(cfg, model)
    ids = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab_size, (args.batch, 12)))
    ids = ids.cuda()
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids, dtype=torch.int32),
             "n_valid": args.batch}

    events = []  # (phase, CUDA event) of the step being timed; None: not timing

    def mark(phase):
        if events is not None:
            events.append((phase, torch.cuda.Event(enable_timing=True)))
            events[-1][1].record()

    step = make_train_step(cfg, "cuda", torch.Generator(device="cuda").manual_seed(0), mark=mark)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()

    walls, phases = [], collections.defaultdict(list)
    for _ in range(args.steps):
        events.clear()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        for (phase, a), (_, b) in zip(events, events[1:]):
            phases[phase].append(a.elapsed_time(b))
    events = None

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / args.steps
    by_family, launches = collections.defaultdict(float), collections.Counter()
    other = collections.defaultdict(float)  # the catch-all family, by kernel name
    for evt in prof.events():
        dev = getattr(evt, "device_type", None)
        if dev is not None and str(dev).endswith("CUDA") and evt.device_time_total > 0:
            fam = family(evt.name)
            by_family[fam] += evt.device_time_total / 1e3 / args.steps
            launches[fam] += 1
            if fam == OTHER:
                other[evt.name[:120]] += evt.device_time_total / 1e3 / args.steps
    kernels_ms = sum(by_family.values())
    out = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "batch": args.batch,
        "fused_head_ce": args.fused_head_ce,
        "wall_ms_median": statistics.median(walls),
        "phase_ms_median": {k: statistics.median(v) for k, v in phases.items()},
        "profiled_wall_ms": prof_wall, "kernels_ms": kernels_ms,
        "idle_share": (1.0 - kernels_ms / prof_wall) if kernels_ms else None,
        "by_family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
        "launches_per_step": {k: v / args.steps for k, v in launches.items()},
        "largest_other_ms": dict(sorted(other.items(), key=lambda kv: -kv[1])[:10]),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    for k, v in out["by_family_ms"].items():
        print(f"{v:10.3f} ms  {out['launches_per_step'][k]:8.1f} launches  {k}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
