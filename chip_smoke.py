#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases (each raises on failure, so the exit code is 0 only if all pass):

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles ``kindergarten_vq_vae_torch/csrc/*.cu`` into
   ``kindergarten_vq_vae_torch/build/`` (first use);
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card at the shapes of a bucket-256 bert-base forward (256 sentences x 12
   tokens), with padded masks, and each one's time beside the plain one's;
4. slice: a full-width bert-base Shelgon3-VQ run (12 + 12 layers, H 768,
   vocab 30522, 9 codes, bf16) with seeded weights, written as a flat-npy
   checkpoint and served over HTTP through both kernels; launch counts are
   checked, and one bucket-256 forward of the kernel path and of the plain
   path is held against an f32 forward of the same weights;
5. timing: median bucket-256 forward, kernel path and plain path.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
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


def _paired_ms(kernel_fn, plain_fn) -> tuple[float, float]:
    """Both versions in turns (plain, kernel, kernel, plain); means of each pair."""
    p1, k1, k2, p2 = _time_ms(plain_fn), _time_ms(kernel_fn), _time_ms(kernel_fn), _time_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


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


def _layer_case(decoder: bool, g):
    import torch

    from kindergarten_vq_vae_torch.ops.layer import DEC_WEIGHTS, ENC_WEIGHTS, LayerGeom

    dev = torch.device("cuda")
    H, NH, F = 768, 12, 3072
    geom = LayerGeom(num_heads=NH, head_dim=H // NH, intermediate=F, causal=decoder,
                     has_cross=decoder, eps=1e-12, gelu_exact=True)
    x = torch.randn(BUCKET, SEQ, H, device=dev, generator=g).bfloat16()
    enc = torch.randn(BUCKET, SEQ, H, device=dev, generator=g).bfloat16() if decoder else None
    lens = torch.randint(1, SEQ + 1, (BUCKET,), device=dev, generator=g)
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
    res = {"layer": {"max_abs_err": 0.0, "ms": [], "plain_ms": []}, "vq": {}}
    with torch.inference_mode():
        for decoder in (False, True):
            geom, x, enc, smask, ws = _layer_case(decoder, g)
            out = fused_bert_layer(geom, x, enc, smask, None, ws)
            torch.cuda.synchronize()
            ref = bert_layer_reference(geom, x, enc, smask, None, ws)
            err = (out.float() - ref.float()).abs()
            mx, mean = err.max().item(), err.mean().item()
            what = "decoder (causal + cross)" if decoder else "encoder"
            print(f"layer {what} ({BUCKET},{SEQ},768) bf16: max abs {mx:.4e} (tol {LAYER_MAX_ABS}), "
                  f"mean abs {mean:.4e} (tol {LAYER_MEAN_ABS}), finite {bool(torch.isfinite(out).all())}")
            if not (torch.isfinite(out).all() and mx <= LAYER_MAX_ABS and mean <= LAYER_MEAN_ABS):
                _fail(f"layer kernel disagrees with its plain version ({what})")
            k_ms, p_ms = _paired_ms(lambda: fused_bert_layer(geom, x, enc, smask, None, ws),
                                    lambda: bert_layer_reference(geom, x, enc, smask, None, ws))
            print(f"layer {what}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
            res["layer"]["max_abs_err"] = max(res["layer"]["max_abs_err"], mx)
            res["layer"]["ms"].append(k_ms)
            res["layer"]["plain_ms"].append(p_ms)

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
        print(f"vq: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        res["vq"] = {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}
    return res


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

    from kindergarten_vq_vae_torch.ops.layer import fused_bert_layer
    from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel
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
        fused_bert_layer.launches = 0
        vector_quantize_kernel.launches = 0
        health = _get(port, "/health")
        recon_few = _post(port, "/reconstruct", few)["results"]
        recon_many = _post(port, "/reconstruct", many)["results"]
        codes = _post(port, "/codes", few)["codes"]
        latents = np.asarray(_post(port, "/encode", few)["latents"])
        launches = {"layer": fused_bert_layer.launches, "vq": vector_quantize_kernel.launches}
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
    # each; /encode runs the 12 encoder layers once
    want = {"layer": 3 * 24 + 12, "vq": 3}
    print(f"slice: HTTP /health /reconstruct(3) /reconstruct(20) /codes(3) /encode(3) ok; "
          f"launches {launches} (expected {want})")
    if launches != want:
        _fail("the main path did not go through the kernels as expected")

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


def main() -> None:
    _require_checkout_and_card()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False

    names = phase_device()
    phase_build()
    kern = phase_kernels()
    sl = phase_slice(names)
    layer = kern["layer"]
    table = {"kernels": [
        {"name": "fused_bert_layer", "route": "cuda",
         "source": "kindergarten_vq_vae_torch/csrc/layer_fwd.cu",
         "replaces": "kindergarten_vq_vae_tpu/ops/layer_pallas.py:489",
         "launches": sl["launches"]["layer"], "max_abs_err": layer["max_abs_err"],
         # per call, mean of one encoder-geometry and one decoder-geometry layer
         "ms": sum(layer["ms"]) / len(layer["ms"]),
         "plain_ms": sum(layer["plain_ms"]) / len(layer["plain_ms"])},
        {"name": "vector_quantize_kernel", "route": "cuda",
         "source": "kindergarten_vq_vae_torch/csrc/vq_fwd.cu",
         "replaces": "kindergarten_vq_vae_tpu/ops/vq_pallas.py:41",
         "launches": sl["launches"]["vq"], "max_abs_err": kern["vq"]["max_abs_err"],
         "ms": kern["vq"]["ms"], "plain_ms": kern["vq"]["plain_ms"]},
    ]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
