#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases (each raises on failure, so the exit code is 0 only if all pass):

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles ``kindergarten_vq_vae_torch/csrc/*.cu`` into
   ``kindergarten_vq_vae_torch/build/`` (first use);
3. kernels vs plain, serving: the layer forward and the VQ kernel against
   their plain PyTorch versions on the card at the shapes of a bucket-256
   bert-base forward (256 sentences x 12 tokens), with padded masks, and each
   one's time beside the plain one's, its bound and, for the layer, the time
   of ``nn.TransformerEncoderLayer`` / ``nn.TransformerDecoderLayer`` on the
   same weights;
4. kernels vs plain, training: the layer forward in training mode (dropout
   0.1 / 0.1, residuals kept), the layer backward, the attention backward
   (self and cross) and the three CE kernels (#6, #7, #8) at the shapes of
   the batch-2048 bert-base training step, and layers whose weights make
   every keep mask visible (self and cross heads, the three hidden sites,
   forward and backward; held to the plain masks); ``fused_ce_loss`` (#6
   forward, #8 backward) driven once through its autograd;
4b. fused head + CE kernels vs plain: #9 and #10, store and flash, at the
   step's head shapes (24,576 rows x 768 x 30,522, bf16) and at ragged rows
   with an odd vocabulary; the table gradient's GEMM; each one's time beside
   the plain one's, its bound and its library yardstick (cuBLAS + PyTorch
   calls computing the same function, named as printed);
5. AMSGrad (kernel #14) vs its plain version over the whole bert-base
   Shelgon3-VQ parameter list: 3 steps with weight decay, a milestone, a
   frozen subset left out and the gradient-less pooler, held bit for bit;
   its time beside the plain single-pass version's, the per-leaf update's,
   its bound and ``torch.optim.Adam(fused=True, amsgrad=True)`` on the same
   leaves (a same-bytes yardstick only: it maxes the raw second moment);
6. serving slice: a full-width bert-base Shelgon3-VQ run (12 + 12 layers,
   H 768, vocab 30522, 9 codes, bf16) with seeded weights, written as a
   flat-npy checkpoint and served over HTTP through the kernels; launch
   counts are checked, and one bucket-256 forward of the kernel path and of
   the plain path is held against an f32 forward of the same weights;
7. serving timing: median bucket-256 forward, kernel path and plain path;
8. training slice: the same model trained for 8 steps at batch 2048 x 12
   (dropout 0.1 / 0.1, AMSGrad lr 1e-4) on one fixed batch through the
   kernels: launch counts per step (kernel #14 once, the plain update never),
   finite and falling loss, median step time, sentences/s and peak memory;
   then 4 steps each with ``fused_head_ce`` "store" and "flash" from the
   same weights and dropout (#9 and #10 once a step, #7 and #8 never), the
   first step's loss held to the default path's;
9. gradients at batch 256: the kernel path's, the plain bf16 path's and the
   two fused-head kernel paths' gradients, each held against an f32 plain
   step on the same weights, dropout and batch;
10. training entry point: a small corpus generated into a temporary
   directory, then ``python -m kindergarten_vq_vae_torch.cli shelgon3`` (in
   process) trains the same full-width model at batch 2048 for 2 epochs, runs
   val and test, writes ``run_conf.json``, one best-val slot and
   ``history.json``; the launch counts of its train, val and test steps are
   checked, and the run directory is served through ``Reconstructor``; then
   a 1-epoch run with ``--set fused_head_ce='store'`` the same way (#9 once
   a step and an eval batch, #10 once a step), served through the logits
   path.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BUCKET = 256
SEQ = 12
WORDS = ("i you he she we they it eat eats buy buys fix fixes paint paints see sees like likes "
         "want wants the a an this that my your apple mango fence car house door window book "
         "red big small old new green blue quickly slowly today now will not is are was were "
         "do does did have has had and or but").split()

# kernel-vs-plain tolerances. Layer: the output is a bf16 LayerNorm output of
# O(1) magnitude (|y| up to ~8, where one bf16 ulp is 3.1e-2); kernel and
# plain share every rounding point and differ only in f32 summation order and
# exp/tanh ulps, which flip an occasional bf16 rounding -> max abs 6e-2
# (two ulps at the top of the range), mean abs 2e-3. VQ: the gather, the
# argmin over identical expansions and the counts are exact; f32 sums in
# another order -> rel 1e-5.
LAYER_MAX_ABS, LAYER_MEAN_ABS = 6e-2, 2e-3
VQ_REL = 1e-5
# whole slice: after 24 bf16 layers the two bf16 paths sit about one bf16
# ulp apart on average (rounding flips compound: 6.8e-3 mean abs on the
# encoder output, measured on an H100 80GB HBM3 at 700 W), so they are not
# held to each other but each to an f32 forward of the same weights: the
# kernel path may be no more than 25% further from it than the plain bf16
# path, and may pick no more than 1% more codes that differ from the f32 codes.
PATH_SLACK, CODE_SLACK = 1.25, 0.01
# training kernels vs plain, on the same inputs: every residual and every
# gradient within 2e-2 of its leaf's largest magnitude (shared rounding
# points; an f32 sum in another order flips an occasional bf16 rounding of
# an intermediate, one ulp is 0.4%); CE ids exact, NLL within 1e-4 absolute
# (values ~15, f32 sums in another order), dlogits within 1e-2 of the
# largest (one bf16 ulp).
TRAIN_REL, CE_NLL_ABS, CE_GRAD_REL = 2e-2, 1e-4, 1e-2
# fused head + CE (#9, #10) vs plain. The kernel's logits come from the wmma
# GEMM, the plain ones from cuBLAS: f32 sums in another order, so a bf16 logit
# may sit one ulp away at each of its two roundings (x @ E^T, then + b), at
# most 2 ulps at the top of the range. The kernel's NLL / lse / ids are held
# to the plain CE over its own logits (CE_NLL_ABS, ids exact); against the
# plain version the NLL moves by at most 2 dl (dl = the largest logit
# difference: lse and the target logit each by dl), and the ids must agree
# wherever the plain top-2 logits are more than 2 dl apart, and on at least
# HEAD_IDS_SHARE of all rows. Flash equals store bit for bit (the same code
# computes each tile). The backward on the same logits: g within one bf16
# ulp of its largest (CE_GRAD_REL), dx within TRAIN_REL of its largest,
# dbias (f32 sums in another order) within HEAD_DBIAS_REL; the table
# gradient (bf16 products summed in f32 in another order) within
# HEAD_DTABLE_REL. The first fused-head training step's loss within
# HEAD_LOSS_REL of the default path's on the same weights and dropout.
HEAD_IDS_SHARE, HEAD_DBIAS_REL, HEAD_DTABLE_REL, HEAD_LOSS_REL = 0.99, 1e-3, 1e-4, 1e-3
HEAD_MODES, FUSED_STEPS = ("store", "flash"), 4
# the bias before each hidden site of the mask-visible layer: large enough
# that VISIBLE_BIAS / (1 - 0.1) - mean stays above the O(1) LayerNorm input
# it is added to in every row
VISIBLE_BIAS = 1000.0
TRAIN_BATCH, GRAD_BATCH, TRAIN_STEPS, VOCAB = 2048, 256, 8, 30522
# the H100 SXM's published peaks (dense): bf16 tensor cores, f32 outside them, HBM3
PEAK_BF16, PEAK_F32, HBM_BYTES_PER_S = 989e12, 67e12, 3.35e12
# AMSGrad phase: steps, and the ops per element of its formula (5 multiplies,
# 4 adds, 2 divisions, a square root and a max: 13)
ADAM_STEPS, ADAM_OPS = 3, 13
# engine phase: corpus cut (8 verbs and 8 objects per pool: 36,864 clean
# sentences), train batches per epoch kept by lim_batches_train_pct
ENGINE_CUT, ENGINE_EPOCHS, ENGINE_TRAIN_PCT = dict(num_verbs=8, num_objects=8), 2, 0.3


def _fail(msg: str) -> None:
    raise RuntimeError(msg)


def _require_checkout_and_card():
    if not os.path.isdir(os.path.join(ROOT, "kindergarten_vq_vae_torch")):
        sys.exit("chip_smoke.py runs from a checkout of the repository "
                 "(kindergarten_vq_vae_torch/ not found beside it)")
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)


def _time_ms(fn, iters: int = 50) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls."""
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


def _paired_ms(kernel_fn, plain_fn, iters: int = 50) -> tuple[float, float]:
    """Both versions in turns (plain, kernel, kernel, plain); means of each pair."""
    p1, k1 = _time_ms(plain_fn, iters), _time_ms(kernel_fn, iters)
    k2, p2 = _time_ms(kernel_fn, iters), _time_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _rel_max(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by the name its count goes under."""
    from kindergarten_vq_vae_torch.ops.adam import amsgrad_update
    from kindergarten_vq_vae_torch.ops.ce import ce_bwd, ce_fwd, ce_fwd_ids
    from kindergarten_vq_vae_torch.ops.head_ce import head_ce_bwd, head_ce_fwd
    from kindergarten_vq_vae_torch.ops.layer import (
        attention_backward,
        fused_bert_layer,
        layer_backward,
    )
    from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel

    return {"layer_fwd": fused_bert_layer, "layer_bwd": layer_backward,
            "attn_bwd": attention_backward, "vq": vector_quantize_kernel,
            "ce_fwd_ids": ce_fwd_ids, "ce_fwd": ce_fwd, "ce_bwd": ce_bwd,
            "head_ce_fwd": head_ce_fwd, "head_ce_bwd": head_ce_bwd, "adam": amsgrad_update}


def _counters() -> dict:
    """Every wrapper's launch count; the attention backward's split into self
    and cross, and the layer forwards that kept residuals (training) apart."""
    w = _wrappers()
    counts = {k: fn.launches for k, fn in w.items()}
    cross = w["attn_bwd"].cross_launches
    counts.update(attn_bwd_self=counts.pop("attn_bwd") - cross, attn_bwd_cross=cross,
                  layer_fwd_resid=w["layer_fwd"].residual_launches)
    return counts


def _reset_counters() -> None:
    w = _wrappers()
    for fn in w.values():
        fn.launches = 0
    w["attn_bwd"].cross_launches = 0
    w["layer_fwd"].residual_launches = 0


def _nbytes(*objs) -> int:
    """Bytes of every tensor among ``objs`` (nested in tuples and lists)."""
    import torch

    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += _nbytes(*o)
    return total


def _bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time in ms for the work: the larger of its bytes over the
    card's memory rate and its operations over ``peak``, and which it is."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _layer_flops(b: int, s: int, decoder: bool, H: int = 768, F: int = 3072,
                 nh: int = 12) -> float:
    """Matrix-product FLOPs of one post-LN BERT layer forward (self attention,
    the cross attention of a decoder over ``s`` encoder positions, the MLP)."""
    M, hd = b * s, H // nh
    f = 2 * M * H * 3 * H + 2 * M * H * H + 4 * M * H * F + 4 * b * nh * s * s * hd
    if decoder:
        f += 2 * M * H * H + 4 * M * H * H + 2 * M * H * H + 4 * b * nh * s * s * hd
    return f


def phase_device() -> tuple[str, str]:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {name}")
    print(f"nvidia-smi name,power.limit: {smi}")
    return name, smi


def phase_build() -> None:
    from kindergarten_vq_vae_torch import _build

    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s ({_build.LIB_PATH})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")


def _layer_case(decoder: bool, g, batch: int = BUCKET, rate: float = 0.0):
    import torch

    from kindergarten_vq_vae_torch.ops.layer import DEC_WEIGHTS, ENC_WEIGHTS, LayerGeom

    dev = torch.device("cuda")
    H, NH, F = 768, 12, 3072
    geom = LayerGeom(num_heads=NH, head_dim=H // NH, intermediate=F, causal=decoder,
                     has_cross=decoder, eps=1e-12, gelu_exact=True, attn_rate=rate, hid_rate=rate)
    x = torch.randn(batch, SEQ, H, device=dev, generator=g).bfloat16()
    enc = torch.randn(batch, SEQ, H, device=dev, generator=g).bfloat16() if decoder else None
    lens = torch.randint(1, SEQ + 1, (batch,), device=dev, generator=g)
    smask = (torch.arange(SEQ, device=dev)[None] < lens[:, None]).to(torch.int32)
    shapes, ws = geom.weight_shapes(), []
    for n in DEC_WEIGHTS if decoder else ENC_WEIGHTS:
        r = torch.randn(shapes[n], device=dev, generator=g)
        ws.append((0.02 * r).bfloat16() if n.startswith("w") else 1.0 + 0.1 * r if n.startswith("g")
                  else 0.02 * r)
    return geom, x, enc, smask, ws


def phase_kernels() -> dict:
    import torch

    from kindergarten_vq_vae_torch.ops.layer import bert_layer_reference, fused_bert_layer
    from kindergarten_vq_vae_torch.ops.vq import vector_quantize
    from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel

    g = torch.Generator(device="cuda").manual_seed(SEED)
    res = {"layer": {"max_abs_err": 0.0, "ms": [], "plain_ms": [], "bound": [],
                     "library_ms": []}, "vq": {}}
    with torch.inference_mode():
        for decoder in (False, True):
            geom, x, enc, smask, ws = _layer_case(decoder, g)
            out = fused_bert_layer(geom, x, enc, smask, None, ws)
            torch.cuda.synchronize()
            ref = bert_layer_reference(geom, x, enc, smask, None, ws)
            lib_fn = _library_layer(decoder, x, enc, smask, ws)
            lib_err = (lib_fn().float() - ref.float()).abs().max().item()
            err = (out.float() - ref.float()).abs()
            mx, mean = err.max().item(), err.mean().item()
            what = "decoder (causal + cross)" if decoder else "encoder"
            print(f"layer {what} ({BUCKET},{SEQ},768) bf16: max abs {mx:.4e} (tol {LAYER_MAX_ABS}), "
                  f"mean abs {mean:.4e} (tol {LAYER_MEAN_ABS}), finite {bool(torch.isfinite(out).all())}")
            if not (torch.isfinite(out).all() and mx <= LAYER_MAX_ABS and mean <= LAYER_MEAN_ABS):
                _fail(f"layer kernel disagrees with its plain version ({what})")
            k_ms, p_ms = _paired_ms(lambda: fused_bert_layer(geom, x, enc, smask, None, ws),
                                    lambda: bert_layer_reference(geom, x, enc, smask, None, ws))
            lib_ms = _time_ms(lib_fn)
            bound = _bound(_layer_flops(BUCKET, SEQ, decoder), _nbytes(x, enc, smask, ws, out),
                           PEAK_BF16)
            print(f"layer {what}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]}), nn.Transformer{'Decoder' if decoder else 'Encoder'}"
                  f"Layer {lib_ms:.4f} ms (max abs {lib_err:.3e} from the plain version)")
            res["layer"]["max_abs_err"] = max(res["layer"]["max_abs_err"], mx)
            res["layer"]["ms"].append(k_ms)
            res["layer"]["plain_ms"].append(p_ms)
            res["layer"]["bound"].append(bound)
            res["layer"]["library_ms"].append(lib_ms)

        n_e, d = 9, 768
        z = torch.randn(BUCKET, SEQ, d, device="cuda", generator=g)
        e = (torch.rand(n_e, d, device="cuda", generator=g) * 2 - 1) / n_e
        centers = 361.0 + 1e-3 * torch.randn(n_e, d, device="cuda", generator=g, dtype=torch.float64)
        assign = torch.randint(0, n_e, (BUCKET * SEQ,), device="cuda", generator=g)
        z_far = (centers[assign] + 2e-4 * torch.randn(BUCKET * SEQ, d, device="cuda", generator=g,
                                                      dtype=torch.float64)).float().reshape(z.shape)
        max_err = 0.0  # over the kernel's float outputs at the serving shape (random case)
        for case, (zz, ee) in (("random", (z, e)), ("far from origin", (z_far, centers.float()))):
            k = vector_quantize_kernel(zz, ee, 0.69)
            torch.cuda.synchronize()
            p = vector_quantize(zz, ee, 0.69)
            exact = (torch.equal(k.indices, p.indices) and torch.equal(k.z_q, p.z_q)
                     and torch.equal(k.counts, p.counts))
            rel = {f: (abs(getattr(k, f) - getattr(p, f)).max() / abs(getattr(p, f)).max()).item()
                   for f in ("loss", "perplexity", "sum_z")}
            if case == "random":
                max_err = max((getattr(k, f) - getattr(p, f)).abs().max().item()
                              for f in ("z_q", "sum_z", "loss", "perplexity"))
            print(f"vq {case} ({BUCKET * SEQ},{d})x{n_e} f32: idx/z_q/counts exact {exact}, "
                  f"rel err loss {rel['loss']:.2e} perplexity {rel['perplexity']:.2e} "
                  f"sum_z {rel['sum_z']:.2e} (tol {VQ_REL})")
            if not exact or max(rel.values()) > VQ_REL:
                _fail(f"VQ kernel disagrees with its plain version ({case})")
        if not torch.equal(vector_quantize_kernel(z_far, centers.float(), 0.69).indices.reshape(-1),
                           assign):
            _fail("VQ kernel misses the true assignments far from the origin")
        k_ms, p_ms = _paired_ms(lambda: vector_quantize_kernel(z, e, 0.69),
                                lambda: vector_quantize(z, e, 0.69))
        bound = _vq_bound(z, e, vector_quantize_kernel(z, e, 0.69))
        print(f"vq: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]})")
        res["vq"] = {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "bound": [bound]}
    layer = res["layer"]
    res["layer"] = {"max_abs_err": layer["max_abs_err"], "ms": statistics.mean(layer["ms"]),
                    "plain_ms": statistics.mean(layer["plain_ms"]), "bound": layer["bound"],
                    "library_ms": statistics.mean(layer["library_ms"])}
    return res


def _vq_bound(z, e, out) -> tuple[float, str]:
    """Reads z and the codebook, writes z_q, the codes, the counts and the
    per-code sums; 3 f32 operations per (row, code, dim) for the distances."""
    rows, d = z.numel() // z.shape[-1], z.shape[-1]
    return _bound(3 * rows * e.shape[0] * d,
                  _nbytes(z, e, out.z_q, out.indices, out.counts, out.sum_z), PEAK_F32)


def _library_layer(decoder: bool, x, enc, smask, ws):
    """``nn.TransformerEncoderLayer`` / ``nn.TransformerDecoderLayer`` in eval
    mode (post-LN, exact GELU, eps 1e-12, bf16) on the weights of a
    serving-layer case; returns its call. Timed as the library yardstick
    only: the port never calls it."""
    import torch
    from torch import nn

    from kindergarten_vq_vae_torch.ops.layer import DEC_WEIGHTS, ENC_WEIGHTS

    W = dict(zip(DEC_WEIGHTS if decoder else ENC_WEIGHTS, ws))
    cls = nn.TransformerDecoderLayer if decoder else nn.TransformerEncoderLayer
    mod = cls(d_model=768, nhead=12, dim_feedforward=3072, dropout=0.0, activation="gelu",
              layer_norm_eps=1e-12, batch_first=True, norm_first=False, device="cuda",
              dtype=torch.bfloat16).eval()

    with torch.no_grad():
        mod.self_attn.in_proj_weight.copy_(W["wqkv"].t())
        mod.self_attn.in_proj_bias.copy_(W["bqkv"])
        mod.self_attn.out_proj.weight.copy_(W["wo"].t())
        mod.self_attn.out_proj.bias.copy_(W["bo"])
        mod.linear1.weight.copy_(W["w1"].t())
        mod.linear1.bias.copy_(W["b1"])
        mod.linear2.weight.copy_(W["w2"].t())
        mod.linear2.bias.copy_(W["b2"])
        last = mod.norm3 if decoder else mod.norm2
        for norm, gname, bname in ((mod.norm1, "g1", "be1"), (last, "g3", "be3")):
            norm.weight.copy_(W[gname])
            norm.bias.copy_(W[bname])
        if decoder:
            mod.multihead_attn.in_proj_weight.copy_(torch.cat([W["wq"], W["wkv"]], 1).t())
            mod.multihead_attn.in_proj_bias.copy_(torch.cat([W["bq"], W["bkv"]]))
            mod.multihead_attn.out_proj.weight.copy_(W["wco"].t())
            mod.multihead_attn.out_proj.bias.copy_(W["bco"])
            mod.norm2.weight.copy_(W["g2"])
            mod.norm2.bias.copy_(W["be2"])
    pad = smask == 0
    if not decoder:
        return lambda: mod(x, src_key_padding_mask=pad)
    causal = torch.ones(SEQ, SEQ, dtype=torch.bool, device="cuda").triu(1)
    return lambda: mod(x, enc, tgt_mask=causal, tgt_key_padding_mask=pad, tgt_is_causal=True)


def _ulps(a, b) -> int:
    """Largest distance in units of the last place between two f32 tensors."""
    import torch

    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)  # sign-magnitude to a monotone line
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def phase_adam(names: tuple[str, str]) -> dict:
    """Kernel #14 against its plain version over the bert-base parameter list."""
    import dataclasses

    import torch

    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.ops.adam import amsgrad_update
    from kindergarten_vq_vae_torch.train.optim import Adam, FusedAdam

    cfg = dataclasses.replace(_train_cfg(), weight_decay=0.01, lr_scheduler="MultiStepLR",
                              milestones=(2,), gamma=0.5)
    model = build_model(cfg, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    named = [(n, p.detach()) for n, p in model.named_parameters()]
    # a frozen subset (the encoder's embeddings) stays out of the table, as a
    # model_mode mask leaves it, and must come out untouched (no stray write
    # past a leaf); the pooler gets no gradient, as in the step
    leaves = [(n, p) for n, p in named if not n.startswith("encoder.embeddings.")]
    frozen = {n: p.clone() for n, p in named if n.startswith("encoder.embeddings.")}
    start = [p.clone() for _, p in leaves]
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    grads = [[None if n.startswith("encoder.pooler.")
              else 1e-3 * torch.randn(p.shape, device="cuda", generator=g) for n, p in leaves]
             for _ in range(ADAM_STEPS)]
    pk = [p for _, p in leaves]  # the model's own tensors, updated in place
    pp = [p.clone() for p in start]
    opt_k, opt_p = FusedAdam(cfg, "kernel"), FusedAdam(cfg, "plain")
    st_k, st_p = opt_k.init(pk), opt_p.init(pp)
    _reset_counters()
    for step in range(ADAM_STEPS):
        opt_k.update(pk, grads[step], st_k)
        opt_p.update(pp, grads[step], st_p)
    torch.cuda.synchronize()
    launches = amsgrad_update.launches
    worst, max_abs = 0, 0.0
    for what, a, b in (("p", pk, pp), ("mu", st_k.mu, st_p.mu), ("nu", st_k.nu, st_p.nu),
                       ("nu_max", st_k.nu_max, st_p.nu_max)):
        for (n, _), x, y in zip(leaves, a, b):
            if not torch.equal(x, y):
                worst = max(worst, _ulps(x, y))
                max_abs = max(max_abs, (x - y).abs().max().item())
                print(f"  amsgrad {what} {n}: {_ulps(x, y)} ulps apart")
    # every leaf moved, but a zero leaf without gradient (the pooler's bias:
    # g + wd * p is 0, so its moments and its step stay 0, as in optax)
    moved = all(not torch.equal(x, p) for x, p, gr in zip(pk, start, grads[0])
                if gr is not None or bool(p.any()))
    n_el = sum(p.numel() for _, p in leaves)
    print(f"amsgrad ({len(leaves)} leaves, {n_el} elements, {sum(t.numel() for t in frozen.values())}"
          f" frozen left out, pooler without gradient) x {ADAM_STEPS} steps, wd 0.01, milestone 2: "
          f"launches {launches}, kernel vs plain max {worst} ulps (tol 0), every leaf moved {moved}")
    if launches != ADAM_STEPS or worst != 0 or not moved:
        _fail("the AMSGrad kernel disagrees with its plain version")
    if any(not torch.equal(p, frozen[n]) for n, p in named if n in frozen):
        _fail("a frozen leaf moved")

    k_ms, p_ms = _paired_ms(lambda: opt_k.update(pk, grads[0], st_k),
                            lambda: opt_p.update(pp, grads[0], st_p), 10)
    per_leaf_ms = _time_ms(lambda: Adam(cfg).update(pp, grads[0], st_p), 10)
    nbytes = sum(p.numel() * (36 if gr is not None else 32) for p, gr in zip(pk, grads[0]))
    bound = _bound(ADAM_OPS * n_el, nbytes, PEAK_F32)
    del st_p, pp
    torch.cuda.empty_cache()
    yard = [torch.nn.Parameter(p.clone()) for p in pk]
    for y, gr in zip(yard, grads[0]):
        y.grad = gr
    torch_adam = torch.optim.Adam(yard, lr=cfg.lr, weight_decay=cfg.weight_decay, amsgrad=True,
                                  fused=True)
    yard_ms = _time_ms(torch_adam.step, 10)
    print(f"amsgrad: kernel {k_ms:.4f} ms, plain single-pass {p_ms:.4f} ms, per-leaf update "
          f"(fused_update='off') {per_leaf_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
          f"{nbytes} B); torch.optim.Adam(fused=True, amsgrad=True) on the same leaves "
          f"{yard_ms:.4f} ms (same-bytes yardstick only: another function) "
          f"({names[0]}; nvidia-smi: {names[1]})")
    del model, named, leaves, start, grads, pk, st_k, yard, torch_adam
    torch.cuda.empty_cache()
    return {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms, "bound": [bound],
            "per_leaf_ms": per_leaf_ms, "yardstick_ms": yard_ms}


def _sentences(n: int, rng) -> list[str]:
    return [" ".join(rng.choice(WORDS) for _ in range(rng.randint(1, SEQ - 2))) for _ in range(n)]


def _write_run(root: str) -> str:
    import dataclasses

    import torch

    from kindergarten_vq_vae_torch.ckpt.bridge import params_to_jax
    from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name, write_checkpoint
    from kindergarten_vq_vae_torch.config import RunConfig
    from kindergarten_vq_vae_torch.data.tokenizer import WordTokenizer
    from kindergarten_vq_vae_torch.models import build_model, init_weights

    data_dir, run = os.path.join(root, "data"), os.path.join(root, "run")
    os.makedirs(data_dir)
    os.makedirs(run)
    cfg = RunConfig(model_name="shelgon3", vocab_size=30522, hidden_size=768, num_layers=12,
                    num_heads=12, intermediate_size=3072, compute_dtype="bfloat16", vq_n_e=9,
                    vq_e_dim=768, data_dir=data_dir, tokenized_sentence_max_length=SEQ)
    with open(os.path.join(run, "run_conf.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    WordTokenizer(WORDS).save(os.path.join(data_dir, cfg.tokenizer_file))
    model = build_model(cfg, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    write_checkpoint(os.path.join(run, best_ckpt_name("shelgon3", "loss_recon", "val")),
                     params_to_jax(model))
    return run


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=300) as resp:
        return json.loads(resp.read())


def _post(port: int, path: str, sentences: list[str]):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps({"sentences": sentences}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _check_results(results, sentences, rec):
    ids, mask = rec.tokenizer.encode_batch(sentences, SEQ)
    if [r["input"] for r in results] != sentences:
        _fail("/reconstruct returned other inputs than it was sent")
    for r, m in zip(results, mask):
        if not (0.0 <= r["token_acc"] <= 1.0 and isinstance(r["reconstruction"], str)
                and len(r["codes"]) == int(m.sum()) and all(0 <= c < 9 for c in r["codes"])):
            _fail(f"/reconstruct result malformed: {r}")


def _compare_paths(rec, ids, mask) -> dict:
    """Kernel path and plain path (both in the run's bf16) against an f32
    forward of the same weights through the plain path."""
    import dataclasses

    import torch

    from kindergarten_vq_vae_torch.models import build_model

    f32 = build_model(dataclasses.replace(rec.cfg, compute_dtype="float32"), device="cuda").eval()
    f32.load_state_dict(rec.model.state_dict())
    valid = mask.bool()
    with torch.inference_mode():
        ref = f32(ids, mask, reference=True)
        outs = {"kernel": rec.model(ids, mask), "plain": rec.model(ids, mask, reference=True)}
    torch.cuda.synchronize()
    ref_logits = ref["logits"].float()
    top2 = ref_logits.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > 0.05) & valid
    stats = {"logits_finite": bool(torch.isfinite(outs["kernel"]["logits"]).all()),
             "logits_shape": list(outs["kernel"]["logits"].shape)}
    for path, out in outs.items():
        enc_err = (out["encoder_last_hidden_state"].float() - ref["encoder_last_hidden_state"]).abs()
        logit_err = (out["logits"].float() - ref_logits).abs()
        codes = out["min_encoding_indices"][..., 0] == ref["min_encoding_indices"][..., 0]
        ids_ok = out["logits"].float().argmax(-1) == ref_logits.argmax(-1)
        stats[path] = {
            "encoder_max_abs": enc_err.max().item(), "encoder_mean_abs": enc_err.mean().item(),
            "logits_max_abs": logit_err.max().item(), "logits_mean_abs": logit_err.mean().item(),
            "code_agreement": codes[valid].float().mean().item(),
            "recon_id_agreement": ids_ok[clear].float().mean().item(),
        }
    k, p = outs["kernel"], outs["plain"]
    stats["kernel_vs_plain_code_agreement"] = (
        (k["min_encoding_indices"] == p["min_encoding_indices"])[..., 0][valid].float().mean().item())
    del f32
    torch.cuda.empty_cache()
    return stats


def phase_slice(names: tuple[str, str]) -> dict:
    import random

    import numpy as np
    import torch

    from kindergarten_vq_vae_torch.serve.http_server import serve_http
    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor

    rng = random.Random(SEED)
    with tempfile.TemporaryDirectory(prefix="kvq_chip_smoke_") as root:
        t0 = time.perf_counter()
        run = _write_run(root)
        torch.cuda.empty_cache()
        rec = Reconstructor(run, device="cuda")
        print(f"slice: bert-base shelgon3-VQ run written and loaded in "
              f"{time.perf_counter() - t0:.1f} s, buckets {rec.buckets}")

    server = serve_http(rec, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        few, many = _sentences(3, rng), _sentences(20, rng)
        _reset_counters()
        health = _get(port, "/health")
        recon_few = _post(port, "/reconstruct", few)["results"]
        recon_many = _post(port, "/reconstruct", many)["results"]
        codes = _post(port, "/codes", few)["codes"]
        latents = np.asarray(_post(port, "/encode", few)["latents"])
        counts = _counters()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        _fail("HTTP server thread did not stop")

    if health != {"status": "ok", "model": "shelgon3"}:
        _fail(f"/health answered {health}")
    _check_results(recon_few, few, rec)
    _check_results(recon_many, many, rec)
    if [len(c) for c in codes] != [len(r["codes"]) for r in recon_few]:
        _fail("/codes disagrees with /reconstruct on code counts")
    if latents.shape != (3, 768) or not np.isfinite(latents).all():
        _fail(f"/encode returned latents of shape {latents.shape}")
    # three full forwards (two /reconstruct, one /codes): 24 layers + 1 VQ
    # each; /encode runs the 12 encoder layers once; no training kernel
    want = {k: 0 for k in counts}
    want.update(layer_fwd=3 * 24 + 12, vq=3)
    print(f"slice: HTTP /health /reconstruct(3) /reconstruct(20) /codes(3) /encode(3) ok; "
          f"launches {counts} (expected {want})")
    if counts != want:
        _fail("the serving path did not go through the kernels as expected")
    launches = {"layer": counts["layer_fwd"], "vq": counts["vq"]}

    # one bucket-256 forward: kernel path and plain path, both bf16, each held
    # against an f32 forward of the same weights (plain path, TF32 off)
    sents = _sentences(BUCKET, rng)
    ids_np, mask_np = rec.tokenizer.encode_batch(sents, SEQ)
    ids = torch.from_numpy(ids_np).cuda()
    mask = torch.from_numpy(mask_np).cuda()
    stats = _compare_paths(rec, ids, mask)
    print(f"slice bucket-{BUCKET} forward vs an f32 forward: {json.dumps(stats)}")
    if not stats["logits_finite"] or stats["logits_shape"] != [BUCKET, SEQ, 30522]:
        _fail("bucket-256 forward: logits not finite or misshapen")
    for what in ("encoder_mean_abs", "logits_mean_abs"):
        if stats["kernel"][what] > PATH_SLACK * stats["plain"][what]:
            _fail(f"kernel path is further from the f32 forward than the plain path ({what})")
    if stats["kernel"]["code_agreement"] < stats["plain"]["code_agreement"] - CODE_SLACK:
        _fail("kernel path picks other codes than the f32 forward more often than the plain path")
    if min(stats["kernel"]["recon_id_agreement"], stats["plain"]["recon_id_agreement"]) < 0.999:
        _fail("reconstruction ids disagree with the f32 forward where its top-2 gap is clear")

    # median bucket-256 forward, both paths in turns
    times = {"kernel": [], "plain": []}
    with torch.inference_mode():
        for _ in range(2):
            rec.forward(ids, mask)
            rec.forward(ids, mask, reference=True)
        for i in range(10):
            order = ("kernel", "plain") if i % 2 == 0 else ("plain", "kernel")
            for path in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rec.forward(ids, mask, reference=path == "plain")
                torch.cuda.synchronize()
                times[path].append((time.perf_counter() - t0) * 1e3)
    med = {path: statistics.median(v) for path, v in times.items()}
    for path in ("kernel", "plain"):
        print(f"bucket-{BUCKET} x seq {SEQ} forward, {path} path: median {med[path]:.3f} ms "
              f"over {len(times[path])} ({names[0]}; nvidia-smi: {names[1]})")
    return {"launches": launches, "forward_ms": med}


def _finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def _leaf_errors(got, want) -> float:
    """Largest :func:`_rel_max` over paired outputs (pairs of None skipped);
    inf if an output is not finite."""
    pairs = [(a, b) for a, b in zip(got, want) if b is not None]
    if not all(_finite(a) for a, _ in pairs):
        return float("inf")
    return max(_rel_max(a, b) for a, b in pairs)


def _visible_layer(decoder: bool, batch: int):
    """A bert-base layer (dropout 0.1 / 0.1) whose outputs show its keep masks.
    q = k = 0 gives every key the same probability and v is the one-hot of the
    key position (x, and enc for cross-attention), so a context entry is
    p * keep per (query, key, head). Every other weight is 0 and the biases
    before the hidden sites (bo, bco, b2) are VISIBLE_BIAS, so each residual
    sum is VISIBLE_BIAS * keep plus an O(1) term, and its LayerNorm output is
    positive exactly where the site keeps."""
    import torch

    from kindergarten_vq_vae_torch.ops.layer import DEC_WEIGHTS, ENC_WEIGHTS, LayerGeom

    H, hd = 768, 64
    geom = LayerGeom(num_heads=12, head_dim=hd, intermediate=3072, causal=decoder,
                     has_cross=decoder, eps=1e-12, gelu_exact=True, attn_rate=0.1, hid_rate=0.1)
    onehot = torch.zeros(batch, SEQ, H, device="cuda")
    for h in range(12):
        onehot[:, torch.arange(SEQ), h * hd + torch.arange(SEQ)] = 1.0
    onehot = onehot.bfloat16()
    shapes, ws = geom.weight_shapes(), []
    for n in DEC_WEIGHTS if decoder else ENC_WEIGHTS:
        w = torch.zeros(shapes[n], device="cuda")
        if n in ("wqkv", "wkv"):  # v = the layer's input
            w[:, -H:] = torch.eye(H, device="cuda")
        if n.startswith("g"):
            w += 1.0
        if n in ("bo", "bco", "b2"):
            w += VISIBLE_BIAS
        ws.append(w.bfloat16() if n.startswith("w") else w)
    return geom, onehot, (onehot if decoder else None), ws


def _check_keep_masks(seed: int) -> None:
    """Every keep mask of the training kernels, held to the plain mask.

    Forward, batch 2048: the self-attention heads (op ids 0..11, causal in the
    decoder) through ctx, the cross-attention heads (``cross_op(12) + h``)
    through ctx2, and the hidden sites 1000 / 1001 / 1002 through x1, x2 and
    out, each equal to the plain mask. Backward, batch 256 (3072 rows): with
    ctx and ctx2 = [I; 0] and m = I as residuals, the weight gradients of wo,
    wco and w2 are the masked row gradients of the three hidden sites (rows
    0..767, 0..767, 0..3071); each is exactly 0 where the plain mask drops,
    and nonzero where it keeps unless the plain gradient there is below 1e-4
    of its largest."""
    import torch

    from kindergarten_vq_vae_torch.ops.dropout import (
        OP_ATTN_OUT,
        OP_CROSS_OUT,
        OP_MLP_OUT,
        attention_keep,
        cross_op,
        hidden_keep,
    )
    from kindergarten_vq_vae_torch.ops.layer import (
        DEC_WEIGHTS,
        layer_backward,
        layer_backward_reference,
        layer_forward,
        residual_names,
    )

    rows, kept = TRAIN_BATCH * SEQ, []
    tril = torch.ones(SEQ, SEQ, dtype=torch.bool, device="cuda").tril()
    for decoder in (False, True):
        geom, x, enc, ws = _visible_layer(decoder, TRAIN_BATCH)
        with torch.no_grad():
            out, resid = layer_forward(geom, x, enc, None, None, ws, seed)
        R = dict(zip(residual_names(geom), resid), out=out)
        heads = (("ctx", 0),) + ((("ctx2", cross_op(12)),) if decoder else ())
        for name, op0 in heads:
            ctx = R[name].view(TRAIN_BATCH, SEQ, 12, 64)[..., :SEQ]
            for h in range(12):
                keep = attention_keep(seed, op0 + h, TRAIN_BATCH, SEQ, SEQ, 0.1, "cuda") > 0
                if decoder and name == "ctx":
                    keep &= tril
                if not torch.equal(ctx[:, :, h] > 0, keep):
                    _fail(f"keep mask of {name} head {h} (op {op0 + h}) differs from the plain "
                          f"mask ({'decoder' if decoder else 'encoder'})")
                kept.append(keep[:, tril].float().mean().item() if decoder and name == "ctx"
                            else keep.float().mean().item())
        sites = (("x1", OP_ATTN_OUT),) + ((("x2", OP_CROSS_OUT),) if decoder else ()) + (
            ("out", OP_MLP_OUT),)
        for name, op in sites:
            keep = hidden_keep(seed, op, rows, 768, 0.1, "cuda") > 0
            if not torch.equal(R[name].reshape(rows, 768) > 0, keep):
                _fail(f"hidden keep mask {op} differs from the plain mask through {name} "
                      f"({'decoder' if decoder else 'encoder'})")
            kept.append(keep.float().mean().item())
        del out, resid, R

    geom, x, enc, ws = _visible_layer(True, BUCKET)
    M = BUCKET * SEQ
    with torch.no_grad():
        out, resid = layer_forward(geom, x, enc, None, None, ws, seed)
    names, resid = residual_names(geom), list(resid)
    for n, width in (("ctx", 768), ("ctx2", 768), ("m", 3072)):
        resid[names.index(n)] = torch.eye(M, width, dtype=torch.bfloat16, device="cuda")
    gy = (0.1 * torch.randn(x.shape, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(SEED))).bfloat16()
    args = (geom, x, enc, None, None, ws, seed, tuple(resid), out, gy)
    got = dict(zip(DEC_WEIGHTS, layer_backward(*args)[2]))
    want = dict(zip(DEC_WEIGHTS, layer_backward_reference(*args)[2]))
    for wname, op in (("wo", OP_ATTN_OUT), ("wco", OP_CROSS_OUT), ("w2", OP_MLP_OUT)):
        g, w = got[wname].float(), want[wname].float()
        keep = hidden_keep(seed, op, g.shape[0], 768, 0.1, "cuda") > 0
        lost = (g == 0) & keep & (w.abs() > 1e-4 * w.abs().max())
        if bool((g[~keep] != 0).any()) or bool(lost.any()) or bool((w[~keep] != 0).any()):
            _fail(f"hidden keep mask {op} of the backward differs from the plain mask "
                  f"(d{wname}: {int((g[~keep] != 0).sum())} dropped entries nonzero, "
                  f"{int(lost.sum())} kept entries zero)")
    print(f"keep masks equal to the plain masks: forward at batch {TRAIN_BATCH} (self heads "
          f"0..11, cross heads {cross_op(12)}..{cross_op(12) + 11}, hidden sites 1000/1001/1002 "
          f"through x1/x2/out), backward at batch {BUCKET} (sites 1000/1001/1002 through "
          f"dwo/dwco/dw2); kept shares {min(kept):.4f}..{max(kept):.4f} (rate 0.1)")
    del out, resid, got, want


def phase_train_kernels() -> dict:
    """Each training kernel against its plain version at the shapes of the
    batch-2048 bert-base step, and its time beside the plain one's."""
    import torch
    import torch.nn.functional as F

    from kindergarten_vq_vae_torch.ops.ce import (
        ce_bwd,
        ce_bwd_reference,
        ce_fwd,
        ce_fwd_ids,
        ce_fwd_ids_reference,
        ce_fwd_reference,
        fused_ce_loss,
    )
    from kindergarten_vq_vae_torch.ops.dropout import cross_op
    from kindergarten_vq_vae_torch.ops.vq import vector_quantize
    from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel
    from kindergarten_vq_vae_torch.ops.layer import (
        attention_backward,
        attention_backward_reference,
        layer_backward,
        layer_backward_reference,
        layer_forward,
        layer_forward_reference,
        residual_names,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    res = {k: {"max_abs_err": 0.0, "ms": [], "plain_ms": [], "bound": []}
           for k in ("layer_fwd", "layer_bwd", "attn_bwd_self", "attn_bwd_cross")}

    def note(key, err, k_ms, p_ms, bound):
        res[key]["max_abs_err"] = max(res[key]["max_abs_err"], err)
        res[key]["ms"].append(k_ms)
        res[key]["plain_ms"].append(p_ms)
        res[key]["bound"].append(bound)
        print(f"{key} {what}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]})")

    rows = TRAIN_BATCH * SEQ
    for decoder in (False, True):
        what = "decoder" if decoder else "encoder"
        geom, x, enc, smask, ws = _layer_case(decoder, g, TRAIN_BATCH, rate=0.1)
        seed = int(torch.randint(-2**31, 2**31 - 1, (1,), generator=g, device="cuda"))
        with torch.no_grad():
            out, resid = layer_forward(geom, x, enc, smask, None, ws, seed)
            torch.cuda.synchronize()
            out_p, res_p = layer_forward_reference(geom, x, enc, smask, None, ws, seed)
            err = (out.float() - out_p.float()).abs()
            rel = _leaf_errors(resid, res_p)
            print(f"train layer fwd {what} ({TRAIN_BATCH},{SEQ},768) bf16 dropout 0.1/0.1: out "
                  f"max abs {err.max().item():.4e} mean abs {err.mean().item():.4e}, residuals "
                  f"{residual_names(geom)} max rel {rel:.3e} (tol {TRAIN_REL})")
            if not (_finite(out) and err.max() <= LAYER_MAX_ABS
                    and err.mean() <= LAYER_MEAN_ABS and rel <= TRAIN_REL):
                _fail(f"training layer forward disagrees with its plain version ({what})")
            k_ms, p_ms = _paired_ms(
                lambda: layer_forward(geom, x, enc, smask, None, ws, seed),
                lambda: layer_forward_reference(geom, x, enc, smask, None, ws, seed), 10)
            fwd_flops = _layer_flops(TRAIN_BATCH, SEQ, decoder)
            note("layer_fwd", err.max().item(), k_ms, p_ms,
                 _bound(fwd_flops, _nbytes(x, enc, smask, ws, out, resid), PEAK_BF16))

            gy = (0.1 * torch.randn(x.shape, device="cuda", generator=g)).bfloat16()
            enc_dtype = torch.float32 if decoder else None  # z_q feeds the decoder in f32
            args = (geom, x, enc, smask, None, ws, seed, res_p, out_p, gy, enc_dtype)
            got = layer_backward(*args)
            torch.cuda.synchronize()
            want = layer_backward_reference(*args)
            flat_got, flat_want = (got[0], got[1], *got[2]), (want[0], want[1], *want[2])
            rel = _leaf_errors(flat_got, flat_want)
            abs_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(flat_got, flat_want) if b is not None)
            print(f"train layer bwd {what}: dx, denc and {len(got[2])} weight gradients, max rel "
                  f"{rel:.3e} (tol {TRAIN_REL})")
            if rel > TRAIN_REL or (decoder and got[1].dtype != torch.float32):
                _fail(f"layer backward disagrees with its plain version ({what})")
            k_ms, p_ms = _paired_ms(lambda: layer_backward(*args),
                                    lambda: layer_backward_reference(*args), 10)
            # each product of the forward twice (the input's and the weight's gradient)
            note("layer_bwd", abs_err, k_ms, p_ms,
                 _bound(2 * fwd_flops, _nbytes(args[:-1], flat_got), PEAK_BF16))

            # the attention backward at the shapes the layer backward gives it
            names = residual_names(geom)
            if decoder:
                a_args = (resid[names.index("qc")].view(TRAIN_BATCH, SEQ, 768),
                          resid[names.index("kvc")].view(TRAIN_BATCH, SEQ, 1536), None,
                          gy, 12, False, seed, cross_op(12), 0.1)
            else:
                a_args = (resid[names.index("qkv")].view(TRAIN_BATCH, SEQ, 2304), None, smask,
                          gy, 12, False, seed, 0, 0.1)
            key = "attn_bwd_cross" if decoder else "attn_bwd_self"
            got = attention_backward(*a_args)
            torch.cuda.synchronize()
            want = attention_backward_reference(*a_args)
            got, want = (got, want) if decoder else ((got,), (want,))
            rel = _leaf_errors(got, want)
            print(f"{key}: max rel {rel:.3e} (tol {TRAIN_REL})")
            if rel > TRAIN_REL:
                _fail(f"attention backward disagrees with its plain version ({key})")
            k_ms, p_ms = _paired_ms(lambda: attention_backward(*a_args),
                                    lambda: attention_backward_reference(*a_args), 10)
            # five products per head: scores again, dV, dP, dQ, dK
            note(key, max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want)),
                 k_ms, p_ms, _bound(10 * TRAIN_BATCH * 12 * SEQ * SEQ * 64,
                                    _nbytes(a_args, got), PEAK_BF16))
        del out, resid, out_p, res_p, got, want

    _check_keep_masks(seed)

    # the VQ at the step's rows: the encoder output of 2048 x 12 tokens
    z = torch.randn(TRAIN_BATCH, SEQ, 768, device="cuda", generator=g)
    e = (torch.rand(9, 768, device="cuda", generator=g) * 2 - 1) / 9
    with torch.no_grad():
        k = vector_quantize_kernel(z, e, 0.69)
        torch.cuda.synchronize()
        p = vector_quantize(z, e, 0.69)
        exact = all(torch.equal(getattr(k, f), getattr(p, f)) for f in ("indices", "z_q", "counts"))
        rel = max(_rel_max(getattr(k, f), getattr(p, f)) for f in ("loss", "perplexity", "sum_z"))
        print(f"vq ({rows},768)x9 f32: idx/z_q/counts exact {exact}, max rel {rel:.2e} "
              f"(tol {VQ_REL})")
        if not exact or rel > VQ_REL:
            _fail("VQ kernel disagrees with its plain version at the training rows")
        k_ms, p_ms = _paired_ms(lambda: vector_quantize_kernel(z, e, 0.69),
                                lambda: vector_quantize(z, e, 0.69), 10)
        bound = _vq_bound(z, e, k)
        res["vq"] = {"max_abs_err": max((getattr(k, f) - getattr(p, f)).abs().max().item()
                                        for f in ("z_q", "sum_z", "loss", "perplexity")),
                     "ms": [k_ms], "plain_ms": [p_ms], "bound": [bound]}
        print(f"vq at the training rows: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]})")
    del z, k, p

    # streaming CE at the step's logits shape, with ties inside and across blocks
    logits = (3.0 * torch.randn(rows, VOCAB, device="cuda", generator=g)).bfloat16()
    logits[0, [5, 9000, 30000]] = 40.0
    logits[1, [7, 8]] = 40.0
    logits[2] = 0.5
    t = torch.randint(0, VOCAB, (rows,), device="cuda", generator=g, dtype=torch.int32)
    with torch.no_grad():
        nll, ids = ce_fwd_ids(logits, t)
        torch.cuda.synchronize()
        nll_p, ids_p = ce_fwd_ids_reference(logits, t)
        nll_err = (nll - nll_p).abs().max().item()
        ids_ok = torch.equal(ids, ids_p) and ids[:3].tolist() == [5, 7, 0]
        print(f"ce fwd ({rows},{VOCAB}) bf16: ids exact {ids_ok}, nll max abs {nll_err:.3e} "
              f"(tol {CE_NLL_ABS})")
        if not ids_ok or nll_err > CE_NLL_ABS:
            _fail("CE forward kernel disagrees with its plain version")
        k_ms, p_ms = _paired_ms(lambda: ce_fwd_ids(logits, t),
                                lambda: ce_fwd_ids_reference(logits, t), 10)
        # max, subtract, exp, add per logit
        bound = _bound(4 * rows * VOCAB, _nbytes(logits, t, nll, ids), PEAK_F32)
        res["ce_fwd_ids"] = {"max_abs_err": nll_err, "ms": [k_ms], "plain_ms": [p_ms],
                             "bound": [bound]}
        print(f"ce fwd ids: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]})")

        # #6: the NLL alone; one PyTorch call computes the same function
        nll6 = ce_fwd(logits, t)
        torch.cuda.synchronize()
        err6 = (nll6 - ce_fwd_reference(logits, t)).abs().max().item()
        same = torch.equal(nll6, nll)
        lib_ce = F.cross_entropy(logits, t.long(), reduction="none")
        print(f"ce fwd (#6) ({rows},{VOCAB}) bf16: nll max abs {err6:.3e} (tol {CE_NLL_ABS}), "
              f"equal to #7's {same}; F.cross_entropy max abs "
              f"{(lib_ce.float() - nll).abs().max().item():.3e} (bf16 out)")
        if err6 > CE_NLL_ABS or not same:
            _fail("CE forward kernel #6 disagrees with its plain version")
        k_ms, p_ms = _paired_ms(lambda: ce_fwd(logits, t), lambda: ce_fwd_reference(logits, t), 10)
        lib_ms = _time_ms(lambda: F.cross_entropy(logits, t.long(), reduction="none"), 10)
        bound = _bound(4 * rows * VOCAB, _nbytes(logits, t, nll6), PEAK_F32)
        res["ce_fwd"] = {"max_abs_err": err6, "ms": [k_ms], "plain_ms": [p_ms], "bound": [bound],
                         "library_ms": lib_ms,
                         "library": "F.cross_entropy(reduction='none')"}
        print(f"ce fwd (#6): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}), F.cross_entropy(reduction='none') {lib_ms:.4f} ms")
        lse = nll_p + logits.float().gather(1, t.long()[:, None])[:, 0]
        scale = torch.full((rows,), 1.0 / rows, device="cuda")
        got = ce_bwd(logits, t, lse, scale)
        torch.cuda.synchronize()
        want = ce_bwd_reference(logits, t, lse, scale)
        rel = _rel_max(got, want)
        print(f"ce bwd ({rows},{VOCAB}) bf16: max rel {rel:.3e} (tol {CE_GRAD_REL})")
        if rel > CE_GRAD_REL:
            _fail("CE backward kernel disagrees with its plain version")
        k_ms, p_ms = _paired_ms(lambda: ce_bwd(logits, t, lse, scale),
                                lambda: ce_bwd_reference(logits, t, lse, scale), 10)
        # subtract, exp, one-hot subtract, scale, round per logit
        bound = _bound(5 * rows * VOCAB, _nbytes(logits, t, lse, scale, got), PEAK_F32)
        res["ce_bwd"] = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                         "ms": [k_ms], "plain_ms": [p_ms], "bound": [bound]}
        print(f"ce bwd: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]})")
    del got, want

    # fused_ce_loss through its autograd: #6 forward, #8 backward (no model path
    # calls it, in the JAX package or here: this run is its path)
    x3 = logits.view(TRAIN_BATCH, SEQ, VOCAB).detach().requires_grad_()
    valid = torch.ones(TRAIN_BATCH, device="cuda")
    _reset_counters()
    loss = fused_ce_loss(x3, t.view(TRAIN_BATCH, SEQ), valid)
    loss.backward()
    torch.cuda.synchronize()
    ce_loss_counts = _counters()
    want_counts = {k: 0 for k in ce_loss_counts}
    want_counts.update(ce_fwd=1, ce_bwd=1)
    print(f"fused_ce_loss at ({TRAIN_BATCH},{SEQ},{VOCAB}): loss {loss.item():.4f}, launches "
          f"{ce_loss_counts}")
    if ce_loss_counts != want_counts or not _finite(x3.grad):
        _fail(f"fused_ce_loss did not run #6 and #8 once each: {ce_loss_counts}")
    del logits, x3, loss
    torch.cuda.empty_cache()
    out = {k: {"max_abs_err": v["max_abs_err"], "ms": statistics.mean(v["ms"]),
               "plain_ms": statistics.mean(v["plain_ms"]), "bound": v["bound"],
               "library_ms": v.get("library_ms"), "library": v.get("library")}
           for k, v in res.items()}
    out["ce_loss_launches"] = ce_loss_counts
    return out


def _head_case(g, rows: int, vocab: int):
    """Operands of the fused head + CE at the bert-base width: x ~ N(0, 1) and
    a 0.05-scale table give logits of std ~1.4, as a trained head's spread."""
    import torch

    x = torch.randn(rows, 768, device="cuda", generator=g).bfloat16()
    table = (0.05 * torch.randn(vocab, 768, device="cuda", generator=g)).bfloat16()
    bias = 0.1 * torch.randn(vocab, device="cuda", generator=g)
    t = torch.randint(0, vocab, (rows,), device="cuda", generator=g, dtype=torch.int32)
    return x, table, bias, t


def phase_head_kernels(names: tuple[str, str]) -> dict:
    """#9 and #10 (store and flash) against their plain versions at the step's
    head shapes and at ragged rows with an odd vocabulary, the table
    gradient's GEMM, and their times."""
    import torch
    import torch.nn.functional as F

    from kindergarten_vq_vae_torch.ops.ce import ce_bwd, ce_fwd_ids_reference, target_logits
    from kindergarten_vq_vae_torch.ops.head_ce import (
        head_ce_bwd,
        head_ce_bwd_reference,
        head_ce_fwd,
        head_ce_fwd_reference,
        table_grad,
        table_grad_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    res = {}
    for case, rows, vocab in (("step", TRAIN_BATCH * SEQ, VOCAB), ("ragged", 1037, VOCAB - 1)):
        x, table, bias, t = _head_case(g, rows, vocab)
        scale = torch.rand(rows, device="cuda", generator=g) / rows
        with torch.no_grad():
            fwd = {m: head_ce_fwd(x, table, bias, t, m) for m in HEAD_MODES}
            torch.cuda.synchronize()
            nll, lse, ids, logits = fwd["store"]
            flash_same = all(torch.equal(a, b) for a, b in zip(fwd["store"][:3], fwd["flash"][:3]))
            nll_p, _, ids_p, logits_p = head_ce_fwd_reference(x, table, bias, t, "store")
            dl = (logits.float() - logits_p.float()).abs().max().item()
            ulp_top = 2.0 ** (math.floor(math.log2(logits_p.float().abs().max().item())) - 7)
            nll_own, ids_own = ce_fwd_ids_reference(logits, t)
            lse_own = nll_own + target_logits(logits, t)
            own_err = max((nll - nll_own).abs().max().item(), (lse - lse_own).abs().max().item())
            top2 = logits_p.float().topk(2, dim=1).values
            clear = top2[:, 0] - top2[:, 1] > 2 * dl
            ids_clear = torch.equal(ids[clear], ids_p[clear])
            ids_share = (ids == ids_p).float().mean().item()
            nll_err = (nll - nll_p).abs().max().item()
            ids_own_ok = torch.equal(ids, ids_own)
            del top2, logits_p, nll_own, ids_own
            print(f"head_ce_fwd {case} ({rows},768)x{vocab} bf16: logits max abs {dl:.3e} "
                  f"(tol {2 * ulp_top:.3e}: 2 bf16 ulps at the top), nll/lse vs the plain CE over "
                  f"its own logits {own_err:.3e} (tol {CE_NLL_ABS}), ids equal to it "
                  f"{ids_own_ok}; vs plain: nll "
                  f"{nll_err:.3e} (tol 2 dl), ids equal where the top-2 gap > 2 dl "
                  f"({int(clear.sum())} of {rows} rows) {ids_clear}, in all {ids_share:.5f} "
                  f"(tol {HEAD_IDS_SHARE}); flash = store bit for bit {flash_same}")
            if not (dl <= 2 * ulp_top and own_err <= CE_NLL_ABS and nll_err <= 2 * dl + CE_NLL_ABS
                    and ids_clear and ids_share >= HEAD_IDS_SHARE and flash_same and ids_own_ok):
                _fail(f"fused head + CE forward disagrees with its plain version ({case})")

            bwd = {m: head_ce_bwd(logits if m == "store" else x, table, bias, t, lse, scale, m)
                   for m in HEAD_MODES}
            torch.cuda.synchronize()
            gk, dxk, dbk = bwd["store"]
            bflash_same = all(torch.equal(a, b) for a, b in zip(bwd["store"], bwd["flash"]))
            gp, dxp, dbp = head_ce_bwd_reference(logits, table, bias, t, lse, scale, "store")
            ld = gk.stride(0)
            pad_zero = bool((gk.as_strided((rows, ld), (ld, 1))[:, vocab:] == 0).all())
            errs = {"g": _rel_max(gk, gp), "dx": _rel_max(dxk, dxp), "dbias": _rel_max(dbk, dbp)}
            bwd_abs = max((a.float() - b.float()).abs().max().item()
                          for a, b in ((gk, gp), (dxk, dxp), (dbk, dbp)))
            del gp, dxp
            dt = table_grad(gk, x)
            torch.cuda.synchronize()
            errs["d_table"] = _rel_max(dt, table_grad_reference(gk, x))
            print(f"head_ce_bwd {case}: rel to the largest, g {errs['g']:.3e} (tol "
                  f"{CE_GRAD_REL}), dx {errs['dx']:.3e} (tol {TRAIN_REL}), dbias "
                  f"{errs['dbias']:.3e} (tol {HEAD_DBIAS_REL}), d_table {errs['d_table']:.3e} "
                  f"(tol {HEAD_DTABLE_REL}); flash = store bit for bit {bflash_same}; g's row "
                  f"{ld} wide, pad columns 0 {pad_zero}")
            if not (errs["g"] <= CE_GRAD_REL and errs["dx"] <= TRAIN_REL
                    and errs["dbias"] <= HEAD_DBIAS_REL and errs["d_table"] <= HEAD_DTABLE_REL
                    and bflash_same and pad_zero and dbk.dtype == torch.float32
                    and dt.dtype == torch.float32):
                _fail(f"fused head + CE backward disagrees with its plain version ({case})")
            if case != "step":
                continue

            # times at the step's shapes; bounds: the GEMMs' operations at the bf16
            # peak against each input read and each output written once
            flops = 2 * rows * vocab * 768
            bias_c = bias.bfloat16()

            def lib_fwd():
                lg = torch.matmul(x, table.t()) + bias_c
                return F.cross_entropy(lg, t.long(), reduction="none"), lg.argmax(1)

            def lib_bwd():
                gg = ce_bwd(logits, t, lse, scale)
                return torch.matmul(gg, table), gg.sum(0, dtype=torch.float32)

            lib_fwd_ms, lib_bwd_ms = _time_ms(lib_fwd, 10), _time_ms(lib_bwd, 10)
            for m in HEAD_MODES:
                saved = logits if m == "store" else x
                k_ms, p_ms = _paired_ms(lambda m=m: head_ce_fwd(x, table, bias, t, m),
                                        lambda m=m: head_ce_fwd_reference(x, table, bias, t, m), 10)
                bound = _bound(flops, _nbytes(x, table, bias, t, fwd[m]), PEAK_BF16)
                res[f"fwd_{m}"] = {
                    "max_abs_err": max(own_err, nll_err), "ms": k_ms, "plain_ms": p_ms,
                    "bound": [bound], "library_ms": lib_fwd_ms,
                    "library": "cuBLAS head GEMM (torch.matmul) + bias + F.cross_entropy + argmax"}
                print(f"head_ce_fwd {m}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                      f"{bound[0]:.4f} ms ({bound[1]}), cuBLAS head GEMM + F.cross_entropy + "
                      f"argmax {lib_fwd_ms:.4f} ms")
                k_ms, p_ms = _paired_ms(
                    lambda m=m, saved=saved: head_ce_bwd(saved, table, bias, t, lse, scale, m),
                    lambda m=m, saved=saved: head_ce_bwd_reference(saved, table, bias, t, lse,
                                                                   scale, m), 10)
                bound = _bound(flops * (2 if m == "flash" else 1),
                               _nbytes(saved, table, bias, t, lse, scale, bwd[m]), PEAK_BF16)
                res[f"bwd_{m}"] = {
                    "max_abs_err": bwd_abs, "ms": k_ms, "plain_ms": p_ms, "bound": [bound],
                    "library_ms": lib_bwd_ms,
                    "library": "#8 + cuBLAS dgrad GEMM (torch.matmul) + column sum"}
                print(f"head_ce_bwd {m}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                      f"{bound[0]:.4f} ms ({bound[1]}), #8 + cuBLAS dgrad GEMM + column sum "
                      f"{lib_bwd_ms:.4f} ms")
            k_ms, p_ms = _paired_ms(lambda: table_grad(gk, x), lambda: table_grad_reference(gk, x),
                                    10)
            wgrad_ms = _time_ms(lambda: torch.matmul(gk.t(), x), 10)
            bound = _bound(flops, _nbytes(gk, x, dt), PEAK_BF16)
            res["d_table"] = {"ms": k_ms, "plain_ms": p_ms, "bound": [bound],
                              "library_ms": wgrad_ms}
            print(f"d_table (port wmma GEMM, f32 out): {k_ms:.4f} ms, plain (f32 torch.matmul) "
                  f"{p_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), cuBLAS wgrad "
                  f"torch.matmul(g.T, x) (bf16 out) {wgrad_ms:.4f} ms ({names[0]}; nvidia-smi: "
                  f"{names[1]})")
        del fwd, bwd, logits, gk, dxk, dbk, dt, x, table
        torch.cuda.empty_cache()
    return res


def _train_cfg():
    from kindergarten_vq_vae_torch.config import RunConfig

    # the JAX engine's defaults: dropout 0.1 / 0.1, AMSGrad lr 1e-4, streaming CE
    return RunConfig(model_name="shelgon3", vocab_size=VOCAB, hidden_size=768, num_layers=12,
                     num_heads=12, intermediate_size=3072, compute_dtype="bfloat16", vq_n_e=9,
                     vq_e_dim=768, tokenized_sentence_max_length=SEQ)


def _train_batch(batch: int) -> dict:
    """bench.py's batch: uniform ids in [1, vocab), no padding, from the seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(1, VOCAB, (batch, SEQ))).cuda()
    return {"input_ids": ids, "attention_mask": torch.ones_like(ids, dtype=torch.int32),
            "n_valid": batch}


class _plain_update_refused:
    """Within the block, the plain versions of the update (the single-pass
    one of ``ops/adam.py`` and the per-leaf ``train/optim.Adam``) raise: on
    the card the step's update is kernel #14 alone."""

    def __enter__(self):
        from kindergarten_vq_vae_torch.ops import adam
        from kindergarten_vq_vae_torch.train import optim

        def refuse(*args, **kwargs):
            _fail("the plain update ran on the training path")

        self.saved = (optim.adam_update_reference, optim.Adam.update, adam.adam_update_reference)
        optim.adam_update_reference = adam.adam_update_reference = refuse
        optim.Adam.update = refuse
        return self

    def __exit__(self, *exc):
        from kindergarten_vq_vae_torch.ops import adam
        from kindergarten_vq_vae_torch.train import optim

        optim.adam_update_reference, optim.Adam.update, adam.adam_update_reference = self.saved


def phase_train(names: tuple[str, str], head_ce: str = "auto", steps: int = TRAIN_STEPS) -> dict:
    """The training slice (``head_ce``: its ``fused_head_ce``); returns the
    kernels' launch counts over its steps and its losses."""
    import dataclasses

    import torch

    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step

    cfg = dataclasses.replace(_train_cfg(), fused_head_ce=head_ce)
    fused = head_ce in HEAD_MODES
    torch.cuda.empty_cache()
    model = build_model(cfg, device="cuda", fused_head=fused)
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    state = init_train_state(cfg, model)
    step = make_train_step(cfg, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    batch = _train_batch(TRAIN_BATCH)
    n_params = sum(p.numel() for p in model.parameters())
    # per step: 24 layer forwards (keeping residuals) and backwards; 24 self- and
    # 12 cross-attention backwards inside them; one VQ; the CE forward and
    # backward (#7, #8) or, with the fused head, #9 and #10; one AMSGrad update
    # over every leaf
    per_step = {k: 0 for k in _counters()}
    per_step.update(layer_fwd=24, layer_fwd_resid=24, layer_bwd=24, attn_bwd_self=24,
                    attn_bwd_cross=12, vq=1, adam=1)
    per_step.update({"head_ce_fwd": 1, "head_ce_bwd": 1} if fused
                    else {"ce_fwd_ids": 1, "ce_bwd": 1})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    with _plain_update_refused():
        _reset_counters()
        for i in range(steps):
            before = _counters()
            t0 = time.perf_counter()
            state, aux = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            after = _counters()
            delta = {k: after[k] - before[k] for k in after}
            if delta != per_step:
                _fail(f"train step {i} ({head_ce}) launched {delta}, expected {per_step}")
            losses.append({k: float(aux[k]) for k in ("loss_full", "loss_recon", "loss_vq",
                                                       "metric_perp", "metric_acc")})
        counts = _counters()
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    print(f"train slice (fused_head_ce {head_ce!r}): bert-base shelgon3-VQ, {n_params} parameters, "
          f"batch {TRAIN_BATCH} x {SEQ}, dropout 0.1/0.1, AMSGrad lr 1e-4, {steps} steps; "
          f"launches per step {per_step}, total {counts}")
    for i, (loss, dt) in enumerate(zip(losses, times)):
        print(f"  step {i}: {json.dumps(loss)} {dt * 1e3:.1f} ms")
    full = [loss["loss_full"] for loss in losses]
    if not all(math.isfinite(v) for v in full) or full[-1] >= full[0]:
        _fail(f"train loss not finite or not falling: {full}")
    if state.step != steps:
        _fail(f"train state counted {state.step} steps")
    print(f"train step (fused_head_ce {head_ce!r}): median {med * 1e3:.1f} ms over steps "
          f"1-{steps - 1}, {TRAIN_BATCH / med:.1f} sentences/s, max_memory_allocated "
          f"{peak / 2**30:.2f} GiB ({names[0]}; nvidia-smi: {names[1]})")
    del state, model, step, aux
    torch.cuda.empty_cache()
    return {"counts": counts, "losses": losses, "median_ms": med * 1e3, "peak_gib": peak / 2**30}


def phase_grads() -> None:
    """Batch-256 gradients of the kernel path, of the plain bf16 path and of
    the fused-head kernel paths (store, flash), each against an f32 plain
    step (logits path) of the same weights, dropout seeds and batch."""
    import dataclasses

    import torch

    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.train.variants import make_loss_fn

    cfg = _train_cfg()
    batch = _train_batch(GRAD_BATCH)
    model = build_model(cfg, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    f32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"), device="cuda")
    f32.load_state_dict(model.state_dict())
    fused = build_model(cfg, device="cuda", fused_head=True)
    fused.load_state_dict(model.state_dict())

    def grads(m, reference, head_ce="auto"):
        for p in m.parameters():
            p.grad = None
        loss, _ = make_loss_fn(dataclasses.replace(cfg, fused_head_ce=head_ce), "train",
                               reference=reference)(
            m, batch, torch.Generator(device="cuda").manual_seed(SEED + 2), False)
        loss.backward()
        return {n: p.grad.float() for n, p in m.named_parameters() if p.grad is not None}

    ref = grads(f32, True)
    stats = {}
    paths = (("kernel", model, False, "auto"), ("plain", model, True, "auto"),
             ("kernel, fused head store", fused, False, "store"),
             ("kernel, fused head flash", fused, False, "flash"))
    for path, m, reference, head_ce in paths:
        got = grads(m, reference, head_ce)
        if got.keys() != ref.keys():
            _fail(f"{path} path: gradients reach other leaves than the f32 step")
        num = sum(((got[n] - ref[n]) ** 2).sum().item() for n in ref)
        den = sum((ref[n] ** 2).sum().item() for n in ref)
        leaf = {n: ((got[n] - ref[n]).norm() / ref[n].norm()).item() for n in ref
                if ref[n].norm() > 0}
        worst = max(leaf, key=leaf.get)
        finite = all(_finite(v) for v in got.values())
        stats[path] = {"global_rel_l2": (num / den) ** 0.5, "worst_leaf_rel_l2": leaf[worst],
                       "worst_leaf": worst, "finite": finite}
    print(f"gradients at batch {GRAD_BATCH} vs an f32 plain step ({len(ref)} leaves): "
          f"{json.dumps(stats)}")
    for path in ("kernel", "kernel, fused head store", "kernel, fused head flash"):
        for what in ("global_rel_l2", "worst_leaf_rel_l2"):
            if not stats[path]["finite"] or stats[path][what] > PATH_SLACK * stats["plain"][what]:
                _fail(f"{path} path: gradients further from f32 than the plain bf16 path ({what})")
    del model, f32, fused
    torch.cuda.empty_cache()


def phase_engine(names: tuple[str, str], head_ce: str = "auto",
                 epochs: int = ENGINE_EPOCHS) -> dict:
    """The training entry point: the CLI on a generated corpus (``--set
    fused_head_ce`` when ``head_ce`` is not "auto"), its run directory, its
    launch counts, and the run directory served (through the logits path)."""
    import numpy as np
    import torch

    from kindergarten_vq_vae_torch import cli
    from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name, read_checkpoint
    from kindergarten_vq_vae_torch.data.generate import generate_dsentences
    from kindergarten_vq_vae_torch.data.prepare import prepare_all
    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor

    with tempfile.TemporaryDirectory(prefix="kvq_chip_engine_") as root:
        data_dir, runs_dir = os.path.join(root, "data"), os.path.join(root, "runs")
        t0 = time.perf_counter()
        generate_dsentences(data_dir, **ENGINE_CUT)
        n = len(prepare_all(data_dir, max_length=SEQ)["sentences_clean"])
        t_data = time.perf_counter() - t0
        # the JAX package's defaults are the full-width bf16 Shelgon3-VQ run
        # (dropout 0.1 / 0.1, AMSGrad lr 1e-4, fused_update "auto")
        sets = {"n_epochs": epochs, "batch_size": TRAIN_BATCH, "data_dir": data_dir,
                "runs_dir": runs_dir, "tokenized_sentence_max_length": SEQ,
                "lim_batches_train_pct": ENGINE_TRAIN_PCT, "ckpt_every_n_epochs": 0,
                "ckpt_slots": ("loss_recon:val",), "seed": SEED}
        if head_ce != "auto":
            sets["fused_head_ce"] = head_ce
        argv = ["shelgon3", "--device", "cuda"]
        for k, v in sets.items():
            argv += ["--set", f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"]
        n_train, n_val = int(n * 0.6), int(n * 0.2)
        steps = epochs * int(n_train // TRAIN_BATCH * ENGINE_TRAIN_PCT)
        evals = epochs * -(-n_val // TRAIN_BATCH) + -(-(n - n_train - n_val) // TRAIN_BATCH)
        torch.cuda.empty_cache()
        with _plain_update_refused():
            _reset_counters()
            t0 = time.perf_counter()
            engine = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counters()
        want = {k: 0 for k in counts}
        want.update(layer_fwd=24 * (steps + evals), layer_fwd_resid=24 * steps,
                    layer_bwd=24 * steps, attn_bwd_self=24 * steps, attn_bwd_cross=12 * steps,
                    vq=steps + evals, adam=steps)
        if head_ce in HEAD_MODES:
            want.update(head_ce_fwd=steps + evals, head_ce_bwd=steps)
        else:
            want.update(ce_fwd_ids=steps + evals, ce_bwd=steps)
        print(f"engine: python -m kindergarten_vq_vae_torch.cli {' '.join(argv)}: {wall:.1f} s "
              f"(corpus of {n} sentences made in {t_data:.1f} s); {steps} train steps, {evals} "
              f"eval batches; launches {counts} (expected {want})")
        if counts != want:
            _fail("the training entry point did not go through the kernels as expected")

        run = engine.run_path
        with open(os.path.join(run, "run_conf.json")) as f:
            conf = json.load(f)
        with open(os.path.join(run, "history.json")) as f:
            history = json.load(f)
        slot = os.path.join(run, best_ckpt_name("shelgon3", "loss_recon", "val"))
        tree = read_checkpoint(slot)
        files = sorted(os.listdir(run))
        print(f"engine run directory {os.path.basename(run)}: {files}")
        if not (conf["model_name"] == "shelgon3" and conf["hidden_size"] == 768
                and conf["num_layers"] == 12 and conf["vocab_size"] == VOCAB
                and conf["batch_size"] == TRAIN_BATCH and conf["run_id"] == os.path.basename(run)
                and conf["fused_head_ce"] == head_ce):
            _fail(f"run_conf.json does not describe the run: {conf}")
        if tree["vector_quantizer"]["codebook"].shape != (9, 768):
            _fail("the best-val slot does not hold the model")
        if [sorted(h) for h in history] != ([["epoch", "train", "val"]] * epochs
                                            + [["epoch", "test"]]):
            _fail(f"history.json has other entries than the run's stages: {history}")
        stats = [h[stage] for h in history for stage in ("train", "val", "test") if stage in h]
        keys = ("loss_recon", "loss_vq", "loss_full", "metric_acc", "metric_perp")
        if not all(math.isfinite(st[k]) for st in stats for k in keys):
            _fail("the run's stats are not finite")
        if history[-1]["test"]["n_els"] != n - n_train - n_val:
            _fail("the test stage did not cover the test split")
        for h in history:
            for stage, st in h.items():
                if stage != "epoch":
                    print(f"  epoch {h['epoch']} {stage}: loss_recon {st['loss_recon']:.4f} "
                          f"loss_vq {st['loss_vq']:.4f} acc {st['metric_acc']:.2f}% perp "
                          f"{st['metric_perp']:.3f}, {st['sentences_per_sec']:.1f} sentences/s "
                          f"(steady state), stage wall {st['stage_wall_s']:.2f} s over "
                          f"{st['n_els']} sentences")

        rng = np.random.default_rng(SEED)
        sentences = [engine.splits["test"].sentences[i] for i in rng.choice(n - n_train - n_val, 5)]
        del engine
        torch.cuda.empty_cache()
        rec = Reconstructor(run, device="cuda")
        _reset_counters()
        recon = rec.reconstruct(sentences)
        codes = rec.codes(sentences)
        served = _counters()
        want_served = {k: 0 for k in served}
        want_served.update(layer_fwd=48, vq=2)  # two forwards: /reconstruct and /codes
        if ([r["input"] for r in recon] != sentences or [r["codes"] for r in recon] != codes
                or not all(0.0 <= r["token_acc"] <= 1.0 and all(0 <= c < 9 for c in r["codes"])
                           for r in recon)
                or served != want_served or rec.model.decoder.mlm_head.cfg.fused_head):
            _fail(f"serving the trained run failed: {recon} {served}")
        print(f"engine run (fused_head_ce {head_ce!r}) served through Reconstructor (logits "
              f"path, launches {served}): {recon[0]}")
        train = [h["train"] for h in history if "train" in h]
        print(f"engine (fused_head_ce {head_ce!r}): train "
              f"{statistics.mean(t['sentences_per_sec'] for t in train):.1f} "
              f"sentences/s (steady state, mean of {len(train)} epochs), stage wall times "
              f"{[round(st['stage_wall_s'], 3) for st in stats]} s ({names[0]}; nvidia-smi: "
              f"{names[1]})")
    del rec
    torch.cuda.empty_cache()
    return counts


def main() -> None:
    _require_checkout_and_card()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False

    names = phase_device()
    phase_build()
    kern = phase_kernels()
    tk = phase_train_kernels()
    hk = phase_head_kernels(names)
    adam = phase_adam(names)
    sl = phase_slice(names)
    tr = {"auto": phase_train(names)}
    for mode in HEAD_MODES:
        tr[mode] = phase_train(names, mode, FUSED_STEPS)
        first, want = tr[mode]["losses"][0]["loss_full"], tr["auto"]["losses"][0]["loss_full"]
        rel = abs(first - want) / abs(want)
        print(f"fused head {mode}: first-step loss {first:.6f}, default path {want:.6f}, rel "
              f"{rel:.2e} (tol {HEAD_LOSS_REL}); step {tr[mode]['median_ms']:.1f} ms vs "
              f"{tr['auto']['median_ms']:.1f} ms, peak {tr[mode]['peak_gib']:.2f} GiB vs "
              f"{tr['auto']['peak_gib']:.2f} GiB ({names[0]}; nvidia-smi: {names[1]})")
        if rel > HEAD_LOSS_REL:
            _fail(f"the fused head ({mode}) changes the first step's loss")
    phase_grads()
    eng = phase_engine(names)
    eng_store = phase_engine(names, "store", 1)
    n = tr["auto"]["counts"]
    src, tpu = "kindergarten_vq_vae_torch/csrc/", "kindergarten_vq_vae_tpu/ops/"

    def row(name, source, replaces, launches, m):
        bound_ms = statistics.mean(b[0] for b in m["bound"])
        bound_by = {b[1] for b in m["bound"]}
        return {"name": name, "route": "cuda", "source": src + source, "replaces": tpu + replaces,
                "launches": launches, "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by.pop() if len(bound_by) == 1 else "operations",
                "library_ms": m.get("library_ms"), "library": m.get("library")}

    # serving rows: per call at bucket 256, the mean of one encoder-geometry and
    # one decoder-geometry layer, launches from the HTTP run; training rows: at
    # batch 2048, launches from the training slice's run (the fused head's from
    # its own mode's run, #6's from the fused_ce_loss run); amsgrad_update: over
    # the whole parameter list, launches from the training entry point's run
    table = {"kernels": [
        row("fused_bert_layer", "layer_fwd.cu", "layer_pallas.py:489", sl["launches"]["layer"],
            kern["layer"]),
        row("vector_quantize_kernel", "vq_fwd.cu", "vq_pallas.py:41", sl["launches"]["vq"],
            kern["vq"]),
        row("layer_forward (training mode)", "layer_fwd.cu", "layer_pallas.py:489",
            n["layer_fwd"], tk["layer_fwd"]),
        row("layer_backward", "layer_bwd.cu", "layer_pallas.py:552", n["layer_bwd"],
            tk["layer_bwd"]),
        row("attention_backward (self)", "layer_bwd.cu", "layer_pallas.py:696",
            n["attn_bwd_self"], tk["attn_bwd_self"]),
        row("attention_backward (cross)", "layer_bwd.cu", "layer_pallas.py:712",
            n["attn_bwd_cross"], tk["attn_bwd_cross"]),
        row("vector_quantize_kernel (training)", "vq_fwd.cu", "vq_pallas.py:41", n["vq"],
            tk["vq"]),
        row("ce_fwd", "ce.cu", "ce_pallas.py:34", tk["ce_loss_launches"]["ce_fwd"], tk["ce_fwd"]),
        row("ce_fwd_ids", "ce.cu", "ce_pallas.py:63", n["ce_fwd_ids"], tk["ce_fwd_ids"]),
        row("ce_bwd", "ce.cu", "ce_pallas.py:104", n["ce_bwd"], tk["ce_bwd"]),
        *[row(f"head_ce_fwd ({m})", "head_ce.cu", "head_ce_pallas.py:67",
              tr[m]["counts"]["head_ce_fwd"], hk[f"fwd_{m}"]) for m in HEAD_MODES],
        *[row(f"head_ce_bwd ({m})", "head_ce.cu", "head_ce_pallas.py:179",
              tr[m]["counts"]["head_ce_bwd"], hk[f"bwd_{m}"]) for m in HEAD_MODES],
        row("amsgrad_update", "adam.cu", "adam_pallas.py:46", eng["adam"], adam),
    ]}
    print(f"engine launches, default run {eng}, store run {eng_store}")
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
