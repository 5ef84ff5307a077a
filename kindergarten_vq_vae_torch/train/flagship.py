"""The flagship-quality pipeline: Bagon, k-means codebook init, VQ fine-tune,
decoder adaptation.

Counterpart of ``scripts/flagship_quality.py`` (l.30-316), the reference's
own recipe at full geometry, with the same flags, stages, gates and JSON
summary:

1. train a bert-base Bagon (or reuse one, ``--bagon-run``);
2. k-means codebook init from its frozen encoder over the train split
   (:func:`~kindergarten_vq_vae_torch.train.codebook_init.compute_codebook_init`),
   written as ``codebook_init.npy`` into the Bagon run directory; two gates
   abort here: ``separation_ratio < 0.1`` exits 3 (the encoder collapsed)
   and ``amplitude_ratio < 2^-7`` exits 4 (its variation is below bf16's
   eval resolution);
3. Shelgon3-VQ warm-started from the Bagon checkpoint with the k-means
   codebook, ``model_mode="vq-ft"`` (or reuse a stage-3 run, ``--vq-run``);
4. optionally (``--stage4-epochs``) continue the stage-3 checkpoint with
   ``--stage4-mode`` trainable at ``--stage4-lr``.

The lean pipeline (the default) writes only the ``loss_recon:val`` slot,
once at each stage's last epoch, skips the decode dump, and runs the test
stage only in the last stage; ``--full-eval`` keeps every stage whole. The
summary goes to stdout as one JSON line (and to ``--out``). Each stage runs
on the card unless ``--cpu`` is given.

    python scripts/flagship_quality_torch.py [--bagon-epochs 60] [--vq-epochs 40]
        [--batch 256] [--runs-dir ./runs] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name
from kindergarten_vq_vae_torch.config import RunConfig

# the stage-2 gates: each diagnostic's floor and the exit code when it fires
SEPARATION_FLOOR, AMPLITUDE_FLOOR = 0.1, 2.0 ** -7
GATE_EXIT = {"separation_ratio": 3, "amplitude_ratio": 4}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="flagship-quality pipeline (Bagon -> k-means "
                                 "codebook init -> Shelgon3-VQ vq-ft -> decoder adaptation)")
    ap.add_argument("--bagon-epochs", type=int, default=60)
    ap.add_argument("--vq-epochs", type=int, default=40)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--runs-dir", default="./runs")
    ap.add_argument("--bagon-run", default=None,
                    help="reuse an existing Bagon run dir (skip stage 1)")
    ap.add_argument("--dec-perturb", type=float, default=0.0,
                    help="decoder-input perturbation pct for TRAIN in stages 1+3 (the "
                    "reference's input perturbator); with clean teacher-forced decoder inputs "
                    "the copy path collapses the encoder representation")
    ap.add_argument("--out", default=None, help="write the JSON summary here too")
    ap.add_argument("--stage4-epochs", type=int, default=0,
                    help="optional stage 4 (decoder adaptation): continue the stage-3 vq-ft "
                    "checkpoint with --stage4-mode trainable at --stage4-lr")
    ap.add_argument("--stage4-mode", default="full",
                    help="model_mode for stage 4 (full | dec-head-ft | ...)")
    ap.add_argument("--stage4-lr", type=float, default=2e-5)
    ap.add_argument("--stage4-perturb", type=float, default=None,
                    help="decoder-input corruption for stage 4 (default: --dec-perturb)")
    ap.add_argument("--vq-run", default=None,
                    help="reuse an existing stage-3 run dir (skip stages 1-3)")
    ap.add_argument("--ema", action="store_true",
                    help="EMA codebook updates in stages 3+4 (vq_ema_update)")
    ap.add_argument("--tiny", action="store_true",
                    help="4-layer/256-hidden smoke geometry (CPU wiring check)")
    ap.add_argument("--lim-batches", type=float, default=1.0,
                    help="train/val/test batch fraction per epoch (smoke runs)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--data-dir", default=None, help="override data_dir")
    ap.add_argument("--full-eval", action="store_true",
                    help="run the test stage + decode dump + all best slots in EVERY stage "
                    "(reference per-run semantics); default is the lean pipeline")
    return ap


def device_of(args) -> str:
    return "cpu" if args.cpu else "cuda"


def base_cfg(args, model_name: str, n_epochs: int, final: bool = False) -> RunConfig:
    """A stage's run config: the defaults, the pipeline's flags and the lean
    (or ``--full-eval``) checkpoint and eval settings (JAX l.103-152)."""
    flat = RunConfig().get_config()
    flat.update(
        model_name=model_name,
        batch_size=args.batch,
        n_epochs=n_epochs,
        runs_dir=args.runs_dir,
        # no mid-run resume bundles: a crashed stage is rerun
        resume_save_every_n_epochs=0,
        decoder_perturb_train_pct=args.dec_perturb,
        # denoising target: the corruption must break the teacher-forced copy path
        bagon_target_unperturbed=args.dec_perturb > 0,
        n_epochs_to_decode_after=n_epochs,
        lim_batches_train_pct=args.lim_batches,
        lim_batches_val_pct=args.lim_batches,
        lim_batches_test_pct=args.lim_batches,
    )
    if args.full_eval:
        flat.update(ckpt_every_n_epochs=15)
    else:
        # one best-slot write a stage (the only checkpoint a later stage
        # reads); the test stage only in the last stage; no decode dump
        flat.update(ckpt_every_n_epochs=0, ckpt_slots=["loss_recon:val"], decode_dump=False,
                    test_stage=final)
    if args.data_dir:
        flat.update(data_dir=args.data_dir)
    if args.tiny:
        flat.update(hidden_size=256, num_layers=4, num_heads=4, intermediate_size=512,
                    vq_e_dim=256, enc_out_size=256, emb_size=256, word_embedding_size=256)
    return RunConfig.from_flat_dict(flat)


def _isscalar(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def last_stats(engine) -> tuple[str, dict]:
    """(stage, scalar stats) of the last history entry: the lean pipeline
    skips intermediate test stages, so test where it ran, else val."""
    last = engine.history[-1]
    stage = "test" if "test" in last else "val"
    return stage, {k: float(v) for k, v in last[stage].items() if _isscalar(v)}


def _train(cfg: RunConfig, args, name: str, summary: dict):
    from kindergarten_vq_vae_torch.train.run import run_training

    t0 = time.time()
    engine = run_training(cfg, device=device_of(args))
    stage, stats = last_stats(engine)
    summary[name] = {"run_dir": engine.run_path, "eval_stage": stage,
                     f"{stage}_stats": stats, "wall_s": round(time.time() - t0, 1)}
    return engine


def stage1(args, summary: dict) -> str:
    """Train the Bagon (or reuse ``--bagon-run``); returns its run directory."""
    if args.bagon_run:
        print(f"[flagship] stage 1 skipped, reusing {args.bagon_run}", flush=True)
        return args.bagon_run
    engine = _train(base_cfg(args, "bagon", args.bagon_epochs), args, "bagon", summary)
    print(f"[flagship] stage 1 done: {json.dumps(summary['bagon'])}", flush=True)
    return engine.run_path


def stage2(args, bagon_dir: str, summary: dict) -> dict:
    """k-means codebook init from the stage-1 encoder; returns the diagnostics."""
    from kindergarten_vq_vae_torch.train.codebook_init import compute_codebook_init
    from kindergarten_vq_vae_torch.train.run import load_data

    t0 = time.time()
    vq_cfg = base_cfg(args, "shelgon3", args.vq_epochs)
    splits, _ = load_data(vq_cfg)
    cb_path = os.path.join(bagon_dir, "codebook_init.npy")
    _, diag = compute_codebook_init(
        vq_cfg, splits["train"],
        bagon_ckpt_path=os.path.join(bagon_dir, best_ckpt_name("bagon", "loss_recon", "val")),
        out_path=cb_path, return_diagnostics=True, device=device_of(args))
    summary["codebook_init"] = {"path": cb_path, "wall_s": round(time.time() - t0, 1), **diag}
    print(f"[flagship] stage 2 done: {cb_path}", flush=True)
    return diag


def gate(diag: dict) -> int | None:
    """The exit code of the first stage-2 gate that fires, else None (JAX
    l.205-241). The separation gate: the centroids sit inside the clusters'
    own noise (a collapsed encoder), so vq-ft cannot recover utilization. The
    amplitude gate: the encoder's per-element variation is below bf16's
    relative resolution (~2^-8) of the activation magnitude, so a bf16
    trunk erases the structure at deterministic eval."""
    if diag["separation_ratio"] < SEPARATION_FLOOR:
        print(f"[flagship] ABORT: degenerate codebook init "
              f"(separation_ratio={diag['separation_ratio']:.3f}, "
              f"centroid_dist_min={diag['centroid_dist_min']:.2e}) — the "
              f"Bagon encoder collapsed; raise --dec-perturb.", flush=True)
        return GATE_EXIT["separation_ratio"]
    if diag["amplitude_ratio"] < AMPLITUDE_FLOOR:
        print(f"[flagship] ABORT: encoder variation below bf16 eval "
              f"resolution (amplitude_ratio={diag['amplitude_ratio']:.2e} "
              f"< 2^-7; std={diag['encoder_per_element_std']:.2e}, "
              f"rms={diag['encoder_per_element_rms']:.2f}) — stage-3 "
              f"deterministic-eval VQ would be degenerate; train stage 1 "
              f"longer (more --bagon-epochs).", flush=True)
        return GATE_EXIT["amplitude_ratio"]
    return None


def stage3(args, bagon_dir: str, summary: dict) -> str:
    """Shelgon3-VQ warm-started from the Bagon with the k-means codebook,
    ``vq-ft``; returns its run directory."""
    flat = base_cfg(args, "shelgon3", args.vq_epochs).get_config()
    flat.update(model_mode="vq-ft",
                from_pretrained_bagon=os.path.join(bagon_dir,
                                                   best_ckpt_name("bagon", "loss_recon", "val")),
                vq_codebook_init_values_path=os.path.join(bagon_dir, "codebook_init.npy"),
                vq_ema_update=args.ema)
    engine = _train(RunConfig.from_flat_dict(flat), args, "shelgon3_vq_ft", summary)
    print(f"[flagship] stage 3 done: {json.dumps(summary['shelgon3_vq_ft'])}", flush=True)
    return engine.run_path


def stage4(args, vq_dir: str, summary: dict) -> None:
    """Decoder adaptation (optional): continue the stage-3 checkpoint with
    ``--stage4-mode`` trainable at ``--stage4-lr``. vq-ft freezes the
    decoder, so its clean accuracy is capped by how well a decoder trained on
    continuous encoder states reads z_q; perplexity stays in the metrics."""
    from kindergarten_vq_vae_torch.train.run import run_training

    if not args.stage4_epochs:
        return
    t0 = time.time()
    flat = base_cfg(args, "shelgon3", args.stage4_epochs, final=True).get_config()
    p4 = args.dec_perturb if args.stage4_perturb is None else args.stage4_perturb
    flat.update(model_mode=args.stage4_mode,
                init_from_ckpt=os.path.join(vq_dir,
                                            best_ckpt_name("shelgon3", "loss_recon", "val")),
                lr=args.stage4_lr, decoder_perturb_train_pct=p4, bagon_target_unperturbed=p4 > 0,
                vq_ema_update=args.ema)
    engine = run_training(RunConfig.from_flat_dict(flat), device=device_of(args))
    summary["shelgon3_stage4"] = {
        "run_dir": engine.run_path,
        "mode": args.stage4_mode,
        "lr": args.stage4_lr,
        "dec_perturb": p4,
        "test_stats": {k: float(v) for k, v in engine.history[-1]["test"].items()},
        "wall_s": round(time.time() - t0, 1),
    }
    print(f"[flagship] stage 4 done: {json.dumps(summary['shelgon3_stage4'])}", flush=True)


def _report(args, summary: dict) -> None:
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)


def main(argv=None) -> dict:
    """The whole pipeline; returns the summary. A firing stage-2 gate prints
    the summary so far and exits with its code (3 or 4)."""
    args = build_parser().parse_args(argv)
    summary: dict = {}
    if args.vq_run:
        print(f"[flagship] stages 1-3 skipped, reusing {args.vq_run}", flush=True)
        stage4(args, args.vq_run, summary)
        _report(args, summary)
        return summary
    bagon_dir = stage1(args, summary)
    code = gate(stage2(args, bagon_dir, summary))
    if code is not None:
        _report(args, summary)
        sys.exit(code)
    vq_dir = stage3(args, bagon_dir, summary)
    stage4(args, vq_dir, summary)
    _report(args, summary)
    return summary


if __name__ == "__main__":
    main()
