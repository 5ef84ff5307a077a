#!/usr/bin/env python3
"""The training engine's throughput against the bare step, for an A/B of trees in turns.

    python3 scripts/ab_engine.py [--roots DIR [DIR ...]] [--rounds 2] [--steps 8]

Each ``--roots`` tree (default: this checkout; another commit unpacked
beside it with ``git archive <commit> | tar -x -C runs/<dir>``) runs in a
process of its own, the trees in turns (``--rounds`` 2: A B B A), each
process on its own tree's ``kindergarten_vq_vae_torch`` and kernel library
(built at first use into that tree's ``build/``). A process
measures, on one card, bert-base Shelgon3-VQ at batch 2048 x 12 (bf16,
dropout 0.1 / 0.1, AMSGrad; the CLI's defaults, as ``chip_smoke.py``'s
engine phase):

- the bare step: ``train/step.py``'s step on one batch already on the card,
  ``--steps`` steps, each timed on the host clock to a synchronisation; the
  median over all but the first, as sentences/s (``chip_smoke.py`` phase
  8's number); each step's ``loss_full`` (as ``float.hex``), held to the
  first tree's first run bit for bit;
- the engine: ``python -m kindergarten_vq_vae_torch.cli shelgon3`` in
  process, one epoch of 10 train steps on a generated corpus (8 verbs and 8
  objects a pool: 36,864 sentences; made once, in the first process) with
  its val stage; its train stage's steady-state ``sentences_per_sec`` from
  ``history.json`` (step 0 out, no synchronisation between steps);
- the synchronisations of two bare steps, counted by
  ``torch.cuda.set_sync_debug_mode("warn")``, each with the file and line
  that asked for it (a step that waits for the card bounds how far the
  engine's host work can run ahead of it).

The last line is one JSON object: each tree's runs (bare and engine
sentences/s, their ratio, the synchronisations), the card's name and
``nvidia-smi``'s name and power limit. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEQ = 2048, 12
CUT = dict(num_verbs=8, num_objects=8)


def cli_run(data_dir: str, runs_dir: str, **sets) -> tuple[object, list]:
    """``python -m kindergarten_vq_vae_torch.cli shelgon3`` in process on the
    card: one epoch at batch 2048 with its val stage, no test stage, ``sets``
    over those; the engine and its ``history.json``."""
    from kindergarten_vq_vae_torch import cli

    sets = {"n_epochs": 1, "batch_size": BATCH, "data_dir": data_dir, "runs_dir": runs_dir,
            "tokenized_sentence_max_length": SEQ, "lim_batches_train_pct": 1.0,
            "ckpt_every_n_epochs": 0, "test_stage": False, "seed": 0, **sets}
    argv = ["shelgon3", "--device", "cuda"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"]
    engine = cli.main(argv)
    with open(os.path.join(engine.run_path, "history.json")) as f:
        return engine, json.load(f)


def worker(root: str, data_dir: str, steps: int) -> dict:
    """One tree's bare step and engine run; see the module docstring."""
    sys.path.insert(0, root)
    import warnings

    import numpy as np
    import torch

    from kindergarten_vq_vae_torch import _build
    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step

    if not os.path.abspath(_build.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"{_build.__file__} is not of the tree {root}")
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    if not os.path.exists(os.path.join(data_dir, "dSentences_input_ids.npy")):
        from kindergarten_vq_vae_torch.data.generate import generate_dsentences
        from kindergarten_vq_vae_torch.data.prepare import prepare_all

        generate_dsentences(data_dir, **CUT)
        prepare_all(data_dir, max_length=SEQ)

    with tempfile.TemporaryDirectory(prefix="kvq_ab_engine_") as runs:
        engine, history = cli_run(data_dir, runs)
        torch.cuda.synchronize()
        train = history[0]["train"]
        cfg, split = engine.cfg, engine.splits["train"]
        del engine
    torch.cuda.empty_cache()

    model = build_model(cfg, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(0))
    state = init_train_state(cfg, model)
    step = make_train_step(cfg, "cuda", torch.Generator(device="cuda").manual_seed(1))
    rows = np.arange(BATCH)
    batch = {k: torch.as_tensor(np.asarray(getattr(split, k)[rows], dtype=np.int64),
                                device="cuda") for k in ("input_ids", "attention_mask")}
    batch["n_valid"] = BATCH
    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(aux["loss_full"]).hex())
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    bare = BATCH / statistics.median(times[1:])
    return {"root": root, "build_s": build_s, "bare_sentences_per_sec": bare,
            "bare_step_ms": [t * 1e3 for t in times], "bare_losses": losses,
            "engine_sentences_per_sec": train["sentences_per_sec"],
            "engine_over_bare": train["sentences_per_sec"] / bare,
            "engine_stage_wall_s": train["stage_wall_s"], "train_steps": train["n_els"] // BATCH,
            "syncs_in_two_steps": len(syncs), "sync_calls": syncs[:6], "history": history}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=[ROOT])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--data-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.data_dir, args.steps)))
        return

    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_engine.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    roots = [os.path.abspath(r) for r in args.roots]
    order = [r for i in range(args.rounds) for r in (roots if i % 2 == 0 else roots[::-1])]
    runs = {r: [] for r in roots}
    with tempfile.TemporaryDirectory(prefix="kvq_ab_engine_data_") as data_dir:
        for r in order:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", r,
                                  "--data-dir", data_dir, "--steps", str(args.steps)],
                                 capture_output=True, text=True, cwd=r)
            if out.returncode != 0:
                sys.exit(f"the worker on {r} failed:\n{out.stdout[-4000:]}{out.stderr[-4000:]}")
            res = json.loads(out.stdout.strip().splitlines()[-1])
            runs[r].append(res)
            same = res["bare_losses"] == runs[roots[0]][0]["bare_losses"]
            print(f"{r}: bare step {res['bare_sentences_per_sec']:.1f} sentences/s, its "
                  f"losses the first tree's bits {same}, engine "
                  f"{res['engine_sentences_per_sec']:.1f} sentences/s "
                  f"({res['engine_over_bare']:.4f} of the bare step; {res['train_steps']} "
                  f"train steps), host synchronisations in two bare steps "
                  f"{res['syncs_in_two_steps']} {res['sync_calls']} "
                  f"({torch.cuda.get_device_name(0)}; nvidia-smi: {smi})", flush=True)
    print(json.dumps({"runs": runs, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
