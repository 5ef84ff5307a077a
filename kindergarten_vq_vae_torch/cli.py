"""Training entry point of the port.

    python -m kindergarten_vq_vae_torch.cli shelgon3 --set n_epochs=2 --set batch_size=2048
    python -m kindergarten_vq_vae_torch.cli shelgon3 --set vq_mode=GumbelQuantizer
    python -m kindergarten_vq_vae_torch.cli shelgon2 --set mask_pct_train=0.1
    python -m kindergarten_vq_vae_torch.cli bagon --config run_conf.json --device cpu
    python -m kindergarten_vq_vae_torch.cli shelgon3 --resume runs/<run_id>
    torchrun --nproc-per-node 4 -m kindergarten_vq_vae_torch.cli shelgon3 \
        --set "mesh_shape=(2, 2)" --set "mesh_axis_names=('dp', 'tp')"

Counterpart of ``models/_cli.py`` (and the ``models/<variant>/main.py``
entry points over it): the config is a ``run_conf.json``-style file
(``--config``; with ``--resume``, the run's own ``run_conf.json``), every
field can be overridden with ``--set key=value`` (a Python literal, else a
string), and ``--resume RUN_DIR`` continues a run from its resume bundle.
The run trains on the card (``--device cuda``, bf16 through the kernels)
unless ``--device cpu`` asks for the plain versions on the CPU. With a
``mesh_shape``, every rank of a ``torchrun`` world runs this entry point
(one process a card over NCCL, or CPU ranks over gloo with ``--device
cpu``).
"""

from __future__ import annotations

import argparse
import ast
import os

from kindergarten_vq_vae_torch.config import RunConfig


def apply_overrides(cfg: RunConfig, overrides: list[str]) -> RunConfig:
    flat = cfg.get_config()
    for item in overrides:
        key, _, raw = item.partition("=")
        if key not in flat:
            raise KeyError(f"unknown config key: {key}")
        try:
            flat[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            flat[key] = raw
    return RunConfig.from_flat_dict(flat)


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(description="Train a model on dSentences (PyTorch port)")
    parser.add_argument("model_name", help="bagon | shelgon | shelgon2 | shelgon3")
    parser.add_argument("--config", default=None, help="path to a run_conf.json-style config")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="override any config field (repeatable)")
    parser.add_argument("--resume", default=None, metavar="RUN_DIR",
                        help="continue a run from RUN_DIR/resume_state (written when "
                             "resume_save_every_n_epochs > 0); the config defaults to "
                             "RUN_DIR/run_conf.json")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.config:
        cfg = RunConfig.load(args.config)
    elif args.resume:
        cfg = RunConfig.load(os.path.join(args.resume, "run_conf.json"))
    else:
        cfg = RunConfig()
    cfg = RunConfig.from_flat_dict({**cfg.get_config(), "model_name": args.model_name})
    cfg = apply_overrides(cfg, args.set)

    import torch.distributed as dist

    from kindergarten_vq_vae_torch.train.run import run_training

    joined = dist.is_initialized()
    try:
        return run_training(cfg, resume_from=args.resume, device=args.device)
    finally:
        if dist.is_initialized() and not joined:  # the group run_training joined
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
