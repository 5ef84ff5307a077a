"""Post-hoc test-stage evaluation of a finished run directory, on the PyTorch port.

The twin of ``scripts/eval_run.py``: rebuilds the model from
``run_conf.json``, reloads the best-val ``loss_recon`` slot and prints every
test-stage stat as one JSON line. Runs on the card unless ``--cpu`` is given.

    python scripts/eval_run_torch.py RUN_DIR [--lim-batches 1.0] [--cpu]
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--lim-batches", type=float, default=1.0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from kindergarten_vq_vae_torch.config import RunConfig
    from kindergarten_vq_vae_torch.train.engine import Engine
    from kindergarten_vq_vae_torch.train.run import load_data

    cfg = RunConfig.load(os.path.join(args.run_dir, "run_conf.json"))
    cfg = dataclasses.replace(cfg, lim_batches_test_pct=args.lim_batches)
    splits, tokenizer = load_data(cfg)
    engine = Engine(cfg, splits, tokenizer=tokenizer, run_path=args.run_dir,
                    device="cpu" if args.cpu else "cuda")
    stats = {k: float(v) for k, v in engine.test(console_print=False).items()}
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
