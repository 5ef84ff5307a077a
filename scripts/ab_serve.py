#!/usr/bin/env python3
"""Host-bound serving forward of the port, for an A/B of trees in turns in one process.

    python3 scripts/ab_serve.py [--roots DIR [DIR ...]] [--rounds 100] [--blocks 3]
                                [--layer-rounds 200] [--artifact]

Loads ``kindergarten_vq_vae_torch`` from each ``--roots`` tree in turn
(default: this checkout; another commit unpacked beside it with ``git
archive <commit> | tar -x -C runs/<dir>``): a tree's modules are dropped
from ``sys.modules`` before the next tree is imported, and each tree's
objects keep calling their own functions, so every tree serves in the same
process, and the trees take their forwards in turns. One process puts both
trees under the same host load, which moves the medians of one tree by tens
of percent from process to process. The trees must hold the same
``csrc/`` (the script checks): they share the first tree's kernel library,
since a second copy of it in one process fails its launches (CUDA error 1),
so what differs between them is their host code alone.

The ``kvq::`` custom ops (``torch.library``) are one process-wide
registry, which two trees cannot both fill. So while a tree is imported,
its ``torch.library.Library("kvq", ...)`` and ``register_fake`` calls are
recorded instead of registered; the script then defines each op once (the
trees must give it the same schema) with one trampoline a dispatch key that
calls the kernel of the tree whose forward runs, re-pointed before each of
its forwards. The trampoline adds one Python call to each op call of a
tree that has the ops (25 a forward here), a cost the measured times
include.

The model is ``chip_smoke.py`` phase 6's: a bert-base Shelgon3-VQ run (12 +
12 layers, H 768, vocabulary 30,522, 9 codes, bf16) of seeded weights,
written as a flat-npy checkpoint and served through each tree's
``Reconstructor``. The number is phase 7's: the wall time of one
bucket-256 forward (256 sentences x 12 tokens) of the kernel path, a
synchronisation before and after it, with Python's cyclic collector
paused; ``--blocks`` blocks of ``--rounds`` rounds, each round one forward
of every tree, the order reversed every round; the median of each block and
of all. Then ``--layer-rounds`` rounds of each tree's host time for one
decoder-layer call of that model (``ops/layer.py`` ``fused_bert_layer``
at bucket 256, no gradient): the host clock over 8 calls issued after a
synchronisation, before the one that ends the round (8 calls queue about
80 launches, far from the launch queue's limit, so the host does not wait
for the card), over 8; the median per tree. ``--artifact`` also exports the
run at bucket 256 with the last tree (which must have ``serve/export.py``)
and times the artifact's forward in the same turns.

The last line is one JSON object with the medians, every time, the card's
name and ``nvidia-smi``'s name and power limit. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "kindergarten_vq_vae_torch"
BUCKET, SEQ = 256, 12


# the kvq ops: their schemas (the first tree's), each tree's kernels by
# (op, dispatch key or "Fake"), and the kernels the trampolines call now
_SCHEMAS: dict[str, str] = {}
_KERNELS: dict[str, dict[tuple[str, str], object]] = {}
_ACTIVE: dict[tuple[str, str], object] = {}
_OPS = None  # the one torch.library.Library of the kvq ops


class _RecordedLibrary:
    """Stands in for ``torch.library.Library`` while a tree is imported."""

    def __init__(self, ns, kind, *args, **kwargs):
        if (ns, kind) != ("kvq", "FRAGMENT"):
            sys.exit(f"a tree registers ops as torch.library.Library({ns!r}, {kind!r}); "
                     "ab_serve.py records only kvq fragments")
        self.kernels = _KERNELS[_RecordedLibrary.tree]

    def define(self, schema, *args, **kwargs):
        name = schema.split("(", 1)[0]
        if _SCHEMAS.setdefault(name, schema) != schema:
            sys.exit(f"the trees' kvq::{name} schemas differ: {_SCHEMAS[name]} / {schema}")
        return name

    def impl(self, name, fn, key, *args, **kwargs):
        self.kernels[(name, key)] = fn


def _record_fake(qualname, fn=None, *, lib=None, **kwargs):
    if not isinstance(lib, _RecordedLibrary):
        sys.exit(f"register_fake({qualname!r}) outside a kvq fragment")
    lib.kernels[(qualname.split("::", 1)[1], "Fake")] = fn
    return fn


def _register_ops(torch) -> None:
    """Define every recorded op once, each dispatch key's kernel (and the
    fake) a trampoline to ``_ACTIVE``; the library lives as long as the
    process."""
    global _OPS
    _OPS = torch.library.Library("kvq", "FRAGMENT")
    keys = {k for kernels in _KERNELS.values() for k in kernels}
    for schema in _SCHEMAS.values():
        _OPS.define(schema)
    for name, key in sorted(keys):
        def trampoline(*args, _k=(name, key)):
            return _ACTIVE[_k](*args)
        if key == "Fake":
            torch.library.register_fake(f"kvq::{name}", trampoline, lib=_OPS)
        else:
            _OPS.impl(name, trampoline, key)


def _import_tree(root: str, tree: str, names: tuple[str, ...]):
    """``PKG.<name>`` of each of ``names`` imported from the tree at
    ``root``, the modules of any tree imported before dropped from
    ``sys.modules`` first and the tree's kvq ops recorded under ``tree``."""
    import torch

    for mod in [m for m in sys.modules if m == PKG or m.startswith(PKG + ".")]:
        del sys.modules[mod]
    _KERNELS[tree] = {}
    _RecordedLibrary.tree = tree
    real = torch.library.Library, torch.library.register_fake
    torch.library.Library, torch.library.register_fake = _RecordedLibrary, _record_fake
    sys.path.insert(0, root)
    try:
        mods = [importlib.import_module(f"{PKG}.{name}") for name in names]
    finally:
        sys.path.remove(root)
        torch.library.Library, torch.library.register_fake = real
    for mod in mods:
        if not os.path.abspath(mod.__file__).startswith(os.path.join(root, PKG) + os.sep):
            sys.exit(f"imported {mod.__file__}, not the tree at {root}")
    return mods


def _csrc(root: str) -> dict:
    d = os.path.join(root, PKG, "csrc")
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _write_run(root: str) -> str:
    """The run directory, written with the tree imported last."""
    import torch

    bridge = importlib.import_module(f"{PKG}.ckpt.bridge")
    ckpt = importlib.import_module(f"{PKG}.ckpt.checkpoint")
    config = importlib.import_module(f"{PKG}.config")
    tokenizer = importlib.import_module(f"{PKG}.data.tokenizer")
    models = importlib.import_module(f"{PKG}.models")

    data_dir, run = os.path.join(root, "data"), os.path.join(root, "run")
    os.makedirs(data_dir)
    os.makedirs(run)
    cfg = config.RunConfig(model_name="shelgon3", vocab_size=30522, hidden_size=768,
                           num_layers=12, num_heads=12, intermediate_size=3072,
                           compute_dtype="bfloat16", vq_n_e=9, vq_e_dim=768, data_dir=data_dir,
                           tokenized_sentence_max_length=SEQ)
    with open(os.path.join(run, "run_conf.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    tokenizer.WordTokenizer("i you he she eat buy the a apple car".split()).save(
        os.path.join(data_dir, cfg.tokenizer_file))
    model = models.init_weights(models.build_model(cfg, device="cuda"),
                                torch.Generator(device="cuda").manual_seed(0))
    ckpt.write_checkpoint(os.path.join(run, ckpt.best_ckpt_name("shelgon3", "loss_recon", "val")),
                          bridge.params_to_jax(model))
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=[ROOT])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--layer-rounds", type=int, default=200)
    ap.add_argument("--artifact", action="store_true")
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]

    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_serve.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(1, 30522, (BUCKET, SEQ), device="cuda", generator=g, dtype=torch.int32)
    mask = (torch.arange(SEQ, device="cuda")[None] < torch.randint(
        2, SEQ + 1, (BUCKET, 1), device="cuda", generator=g)).int()
    if any(_csrc(r) != _csrc(roots[0]) for r in roots[1:]):
        sys.exit("the trees' csrc/ differ: they cannot share one kernel library")
    recs, layer_ops, lib = {}, {}, None
    with tempfile.TemporaryDirectory(prefix="kvq_ab_serve_") as tmp:
        run = None
        for i, root in enumerate(roots):
            tree = f"tree{i}"
            # every module that may define kvq ops, so that none is imported later
            names = ["serve.reconstructor", "ops.layer", "ops.sdpa", "ops.vq_kernel"]
            if args.artifact and i == len(roots) - 1:
                names.append("serve.export")
            mods = _import_tree(root, tree, tuple(names))
            rec_mod, layer_ops[tree], export = mods[0], mods[1], mods[-1]
            build = importlib.import_module(f"{PKG}._build")
            if lib is None:
                lib = build.lib()
            build._lib = lib
            run = run or _write_run(tmp)
            recs[tree] = rec_mod.Reconstructor(run, device="cuda")
        _register_ops(torch)
        kernels = {k: _KERNELS[k] for k in recs}
        if args.artifact:
            kernels["artifact"] = _KERNELS[tree]
            _ACTIVE.update(kernels["artifact"])
            out, _ = export.export_reconstructor(run, bucket=BUCKET,
                                                 out_path=os.path.join(tmp, "art"))
            recs["artifact"] = rec_mod.Reconstructor(run, device="cuda", artifact=out)
    with torch.inference_mode():
        ref = None
        for k, rec in recs.items():
            _ACTIVE.clear()
            _ACTIVE.update(kernels[k])
            for _ in range(3):
                got = rec.forward(ids, mask)
            if ref is None:
                ref = got
            elif not all(torch.equal(a, b) for a, b in zip(got, ref)):
                sys.exit(f"{k}'s ids or codes differ from tree0's")
    times = {k: [] for k in recs}
    blocks = []
    gc.disable()
    try:
        with torch.inference_mode():
            for _ in range(args.blocks):
                block = {k: [] for k in recs}
                for r in range(args.rounds):
                    for k in (list(recs) if r % 2 == 0 else list(recs)[::-1]):
                        _ACTIVE.clear()
                        _ACTIVE.update(kernels[k])
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        recs[k].forward(ids, mask)
                        torch.cuda.synchronize()
                        block[k].append((time.perf_counter() - t0) * 1e3)
                blocks.append({k: statistics.median(v) for k, v in block.items()})
                for k, v in block.items():
                    times[k] += v
            layer_us = _layer_host_us(torch, recs, layer_ops, kernels, ids.shape,
                                      mask, args.layer_rounds)
    finally:
        gc.enable()
    med = {k: statistics.median(v) for k, v in times.items()}
    for i, b in enumerate(blocks):
        print(f"block {i}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in b.items()), flush=True)
    print("all: " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
          + "".join(f"; tree{i} / tree0 {med[f'tree{i}'] / med['tree0'] - 1:+.2%}"
                    for i in range(1, len(roots))) + f" ({smi})", flush=True)
    layer_med = {k: statistics.median(v) for k, v in layer_us.items()}
    print("decoder-layer call, host: " + ", ".join(f"{k} {v:.2f} us" for k, v in layer_med.items())
          + "".join(f"; tree{i} / tree0 {layer_med[f'tree{i}'] / layer_med['tree0'] - 1:+.2%}"
                    for i in range(1, len(roots))) + f" ({smi})", flush=True)
    print(json.dumps({"roots": roots, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "bucket": BUCKET, "rounds": args.rounds, "blocks": blocks,
                      "median_ms": med, "times_ms": times, "layer_rounds": args.layer_rounds,
                      "layer_host_median_us": layer_med, "layer_host_us": layer_us}))


def _layer_host_us(torch, recs, layer_ops, kernels, shape, mask, rounds: int) -> dict:
    """Each tree's host microseconds for one decoder-layer call of its served
    model (layer 0, cross-attention on), in turns; 8 calls a round."""
    cases = {}
    for tree, ops in layer_ops.items():
        bert = recs[tree].model.decoder.bert
        cfg = bert.cfg
        geom = ops.LayerGeom(num_heads=cfg.num_heads, head_dim=cfg.head_dim,
                             intermediate=cfg.intermediate_size, causal=cfg.is_decoder,
                             has_cross=True, eps=cfg.layer_norm_eps, gelu_exact=cfg.gelu_exact,
                             attn_rate=0.0, hid_rate=0.0)
        g = torch.Generator(device="cuda").manual_seed(2)
        x = torch.randn((*shape, cfg.hidden_size), device="cuda", generator=g).to(cfg.dtype)
        m = mask.to(torch.int32).contiguous()
        cases[tree] = (ops.fused_bert_layer, geom, x, x.clone(), m, m,
                       bert.layer_0.weights(cfg.dtype, True))
    out = {k: [] for k in cases}
    for r in range(rounds):
        for k in (list(cases) if r % 2 == 0 else list(cases)[::-1]):
            fn, geom, x, enc, smask, cmask, ws = cases[k]
            _ACTIVE.clear()
            _ACTIVE.update(kernels[k])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(8):
                fn(geom, x, enc, smask, cmask, ws, 0)
            out[k].append((time.perf_counter() - t0) * 1e6 / 8)
            torch.cuda.synchronize()
    return out


if __name__ == "__main__":
    main()
