#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch port goes, on one CUDA card.

    python3 scripts/profile_torch_step.py [--batch 2048] [--steps 3] [--fused-head-ce off]
                                          [--fused-layer auto] [--model shelgon3]
                                          [--decoder bert]

Builds a seeded full-width bert-base Shelgon3-VQ, or with ``--model`` Shelgon3
with the Gumbel quantizer, Shelgon, Shelgon2 (``mask_pct_train`` 0.1; the
batch carries seeded 5- and 8-factor labels) or Bagon; with ``--decoder
gpt2`` its decoder is GPT-2-small (12 blocks, vocabulary 50,257; the batch
carries seeded decoder ids for Bagon and Shelgon) (bf16, dropout 0.1 / 0.1,
AMSGrad lr 1e-4; ``--fused-head-ce store`` or ``flash``: the loss through the
fused head + CE, kernels #9 and #10, in place of the logits path;
``--fused-layer off``: the per-module trunk, cuBLAS projections around the
SDPA kernels #11 / #12, in place of the fused layers), warms up,
then reports for one batch of ``--batch`` x 12 tokens:

- the wall time of a step (host clock around a synchronized step);
- device time of forward, backward and optimizer update (CUDA events at the
  step's phase marks; the update is kernel #14);
- ``torch.profiler`` device time over ``--steps`` steps, grouped by kernel
  family and divided by the step count, the ten largest kernels of the
  catch-all PyTorch family, and the device idle share
  ``1 - kernel time / wall``;
- the bottleneck alone (the VQ, the Gumbel quantizer, Shelgon's
  ``bottleneck`` or Shelgon2's ``sentence_discretizer``; none for Bagon):
  ``torch.profiler`` device time and launches of its forward and backward
  on the step's shapes (random bf16 encoder states), per call;
- with ``--decoder gpt2``, the GPT-2 decoder alone the same way: its
  forward (dropout on, the tied head's logits included) and backward on
  random bf16 encoder states and seeded decoder ids.

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

CUBLAS = "cuBLAS (head, pooler, MLM transform; per-module and GPT-2 projections)"
# kernel-name fragment -> family, first match wins
FAMILIES = (
    ("adam_amsgrad_kernel", "AMSGrad update (kernel #14)"),
    ("gemm_kernel<128, false, false, 9>", "fused head + CE forward (#9: GEMM + CE epilogue)"),
    ("head_ce_merge_kernel", "fused head + CE forward (#9: merge)"),
    ("gemm_kernel<128, false, false, 10>", "fused head + CE backward (#10: g, dbias partials)"),
    ("head_ce_grad_kernel", "fused head + CE backward (#10: g, dbias partials)"),
    ("sm90::gemm_kernel<128, false, true", "layer GEMM, forward (wgmma)"),
    ("sm90::gemm_kernel<192, false, true", "layer GEMM, forward (wgmma)"),
    ("sm90::gemm_kernel<128, false, false", "layer GEMM, dgrad (wgmma)"),
    ("sm90::gemm_kernel<192, false, false", "layer GEMM, dgrad (wgmma)"),
    ("sm90::gemm_kernel<192, true, true", "layer GEMM, wgrad split-K partials (wgmma)"),
    ("sm90::gemm_kernel<256, true, true", "layer GEMM, wgrad split-K partials (wgmma)"),
    ("splitk_reduce", "split-K sums (layer wgrad)"),
    ("sm90::", "layer GEMM, other (wgmma)"),
    # csrc/attention.cuh: attention_bwd_kernel<VEC>, attention_kernel<WHERE_MASK, VEC>
    ("attention_bwd_kernel", "attention backward (#3 / #4 in #2, or #12)"),
    ("attention_kernel", "attention forward (in #1, or #11 / #13)"),
    # csrc/layernorm.cu; its colparts_reduce_kernel goes to the family of the
    # kernel before it (REDUCE_AFTER)
    ("residual_layernorm_kernel", "residual + LayerNorm forward"),
    ("ln_bwd_kernel", "LayerNorm backward"),
    ("colsum_kernel", "column sums (bias gradients)"),
    ("ce_fwd_kernel", "CE forward"),
    ("ce_bwd", "CE backward"),
    ("vq_", "VQ forward"),
    ("nvjet", CUBLAS),
    ("gemm", CUBLAS),
    ("cutlass", CUBLAS),
    ("Memset", "memset"),
    ("Memcpy", "memcpy"),
)


OTHER = "torch elementwise / reduction (casts, embeddings, VQ backward)"
# #10's first kernel, then the kernels that follow it on the stream: the
# fused head's products run on the layer GEMM's instantiations and are told
# apart by their place (ops/head_ce.py FusedHeadCE.backward: head_ce_bwd,
# then table_grad)
HEAD_BWD_FIRST = ("gemm_kernel<128, false, false, 10>", "head_ce_grad_kernel")
HEAD_BWD_NEXT = (
    ("splitk_reduce", "fused head + CE backward (#10: dbias sum)"),
    ("sm90::gemm_kernel<", "fused head + CE backward (#10: dx = g @ E, NN GEMM)"),
    ("sm90::gemm_kernel<", "fused head table gradient (TN split-K partials)"),
    ("splitk_reduce", "fused head table gradient (split-K sum)"),
)


# the fixed-order sum of per-block column partials (csrc/layernorm.cu), by
# the kernel that wrote the partials, first match wins: the LayerNorm
# backward's dgamma / dbeta / dbias, the bias column sums, b1 from the
# GELU-gradient GEMM's epilogue (EPI_DGELU_ERF 6 / EPI_DGELU_TANH 7), which
# the split-K sums (splitk_reduce) are not, and the VQ's per-code statistics
REDUCE = "colparts_reduce"
REDUCE_AFTER = (
    ("vq_assign_kernel", "VQ forward"),
    ("ln_bwd_kernel", "LayerNorm backward"),
    ("colsum_kernel", "column sums (bias gradients)"),
    ("gemm_kernel<128, false, false, 6>", "column sums (b1: the GELU-gradient GEMM's partials)"),
    ("gemm_kernel<128, false, false, 7>", "column sums (b1: the GELU-gradient GEMM's partials)"),
)


def family(name: str) -> str:
    for frag, fam in FAMILIES:
        if frag in name:
            return fam
    return OTHER


# --model: the run-config fields that make each model from the defaults
MODELS = {
    "shelgon3": {"model_name": "shelgon3"},
    "shelgon3-gumbel": {"model_name": "shelgon3", "vq_mode": "GumbelQuantizer"},
    "shelgon": {"model_name": "shelgon"},
    "shelgon2": {"model_name": "shelgon2", "mask_pct_train": 0.1},
    "bagon": {"model_name": "bagon"},
}
# --decoder: the run-config fields of each decoder
DECODERS = {"bert": {}, "gpt2": {"decoder_model_name": "gpt2", "decoder_vocab_size": 50257}}


def _profiled(fn, calls: int) -> dict:
    """Device ms and launches a call of ``fn`` (after two warm-up calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [evt for evt in prof.events()
               if str(getattr(evt, "device_type", None)).endswith("CUDA")
               and evt.device_time_total > 0]
    names = collections.Counter(evt.name[:80] for evt in kernels)
    return {"device_ms": sum(evt.device_time_total for evt in kernels) / 1e3 / calls,
            "launches": len(kernels) / calls,
            "kernels": {k: v / calls for k, v in names.most_common(12)}}


def profile_gpt2_decoder(model, cfg, batch: dict, calls: int) -> dict:
    """Device ms and launches of one forward + backward of the GPT-2 decoder
    alone (dropout on, the tied head included) on random bf16 encoder states."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    ids = batch["dec_input_ids"] if "dec_input_ids" in batch else batch["input_ids"]
    h = torch.randn(*ids.shape, cfg.hidden_size, generator=gen, device="cuda").bfloat16()
    h.requires_grad_()

    def fn():
        for p in (h, *model.decoder.parameters()):
            p.grad = None
        out = model.decoder(ids, batch["attention_mask"], encoder_hidden_states=h,
                            deterministic=False, generator=gen)
        out["logits"].sum().backward()

    return _profiled(fn, calls)


def profile_bottleneck(model, cfg, batch: int, calls: int) -> dict:
    """Device ms and launches of one forward + backward of the model's
    bottleneck alone, on random bf16 encoder states of the step's shape."""
    import torch

    if cfg.model_name == "bagon":
        return None
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = (batch,) if cfg.model_name == "shelgon2" else (batch, 12)
    h = torch.randn(*rows, cfg.hidden_size, generator=gen, device="cuda").bfloat16()
    h.requires_grad_()
    if cfg.model_name == "shelgon":
        def fn():
            logits, classes, cond = model.bottleneck(h, gen)
            return cond.sum() + logits.sum()
    elif cfg.model_name == "shelgon2":
        def fn():
            disc, softs, _ = model.sentence_discretizer(h, None, gen)
            return disc.sum() + softs.sum()
    elif cfg.vq_mode == "GumbelQuantizer":
        def fn():
            out = model.gumbel_quantizer(h, True, gen)
            return out.z_q.sum() + out.diff
    else:
        def fn():
            out = model.vector_quantizer(h)
            return out.z_q.sum() + out.loss
    return _profiled(lambda: fn().backward(), calls)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--fused-head-ce", choices=("off", "store", "flash"), default="off")
    ap.add_argument("--fused-layer", choices=("auto", "off"), default="auto")
    ap.add_argument("--model", choices=tuple(MODELS), default="shelgon3")
    ap.add_argument("--decoder", choices=tuple(DECODERS), default="bert")
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
    cfg = RunConfig(compute_dtype="bfloat16", fused_head_ce=args.fused_head_ce,
                    fused_layer=args.fused_layer, **MODELS[args.model], **DECODERS[args.decoder])
    model = init_weights(build_model(cfg, device="cuda", fused_head=args.fused_head_ce != "off"),
                         torch.Generator(device="cuda").manual_seed(0))
    state = init_train_state(cfg, model)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (args.batch, 12))).cuda()
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids, dtype=torch.int32),
             "n_valid": args.batch}
    for k, n in (("labels", 5), ("labels8", 8)):
        batch[k] = torch.from_numpy(rng.integers(0, 3, (args.batch, n))).cuda()
        batch[k.replace("labels", "one_hot")] = torch.nn.functional.one_hot(batch[k], 3)
    if args.decoder == "gpt2":  # the BPE side of the dual tokenization (Bagon, Shelgon)
        batch["dec_input_ids"] = torch.from_numpy(
            rng.integers(1, cfg.decoder_vocab_size, (args.batch, 12))).cuda()
        batch["dec_attention_mask"] = batch["attention_mask"]

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
    kernels = sorted((evt for evt in prof.events()
                      if str(getattr(evt, "device_type", None)).endswith("CUDA")
                      and evt.device_time_total > 0), key=lambda evt: evt.time_range.start)
    after_head = []  # the families still expected after #10's first kernel
    prev = ""  # the kernel before this one on the stream
    for evt in kernels:
        if REDUCE in evt.name:
            fam = next((f for frag, f in REDUCE_AFTER if frag in prev),
                       "column sums (partials of an unknown kernel)")
        elif after_head and after_head[0][0] in evt.name:
            fam = after_head.pop(0)[1]
        else:
            if after_head:
                print(f"warning: {evt.name[:80]} where {after_head[0][1]} was expected; "
                      "attributed by name")
                after_head = []
            fam = family(evt.name)
            if any(frag in evt.name for frag in HEAD_BWD_FIRST):
                after_head = list(HEAD_BWD_NEXT)
        prev = evt.name
        by_family[fam] += evt.device_time_total / 1e3 / args.steps
        launches[fam] += 1
        if fam == OTHER:
            other[evt.name[:120]] += evt.device_time_total / 1e3 / args.steps
    kernels_ms = sum(by_family.values())
    out = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "batch": args.batch,
        "model": args.model, "decoder": args.decoder,
        "fused_head_ce": args.fused_head_ce, "fused_layer": args.fused_layer,
        "wall_ms_median": statistics.median(walls),
        "phase_ms_median": {k: statistics.median(v) for k, v in phases.items()},
        "profiled_wall_ms": prof_wall, "kernels_ms": kernels_ms,
        "idle_share": (1.0 - kernels_ms / prof_wall) if kernels_ms else None,
        "by_family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
        "launches_per_step": {k: v / args.steps for k, v in launches.items()},
        "largest_other_ms": dict(sorted(other.items(), key=lambda kv: -kv[1])[:10]),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "bottleneck": profile_bottleneck(model, cfg, args.batch, args.steps),
    }
    if args.decoder == "gpt2":
        out["gpt2_decoder"] = profile_gpt2_decoder(model, cfg, batch, args.steps)
    for k, v in out["by_family_ms"].items():
        print(f"{v:10.3f} ms  {out['launches_per_step'][k]:8.1f} launches  {k}")
    for what in ("bottleneck", "gpt2_decoder"):
        if out.get(what):
            print(f"{what} alone, forward + backward: {out[what]['device_ms']:.3f} ms, "
                  f"{out[what]['launches']:.1f} launches")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
