"""One full sharded train step on a mesh of n CPU processes.

    python -m kindergarten_vq_vae_torch.parallel.dryrun 4

The twin of ``__graft_entry__.py`` ``dryrun_multichip`` (l.140-218): JAX
makes n virtual devices in one process, the port starts n gloo processes
(one rank each, :func:`launch`) and picks JAX's mesh by n: ``(2, n // 4,
2)`` over ``("dp_host", "dp", "tp")`` from 8, ``(n // 2, 2)`` over ``("dp",
"tp")`` from 4, else ``(n,)`` over ``("dp",)``. Each rank builds JAX's tiny
flagship config (Shelgon3-VQ, ``fused_layer="on"``, ``fused_head_ce="store"``,
f32) from seed 0, takes its rows of one seeded global batch and runs one
train step with dropout; rank 0 prints ``dryrun_multichip(n): mesh={...}
loss=... OK``. A rank that fails ends the others and the run raises.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from kindergarten_vq_vae_torch.parallel.mesh import free_port

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launch(n: int, argv: list[str], timeout: float = 300.0) -> list[str]:
    """Run ``python argv`` from the repository's root as ranks ``0..n-1`` of
    one world (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT`` set, one CPU thread a rank) and return their standard
    outputs. The first rank to
    fail, or the deadline, ends every rank and raises ``RuntimeError`` with
    that rank's error output."""
    port = free_port()
    procs, files = [], []
    deadline = time.monotonic() + timeout
    try:
        for rank in range(n):
            e = dict(os.environ)
            e.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                     MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            files.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *argv], env=e, cwd=REPO, text=True,
                                          stdout=out, stderr=err))
        failed, timed_out = None, False
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            if failed is None and time.monotonic() > deadline:
                failed = next(r for r, p in enumerate(procs) if p.poll() is None)
                timed_out = True
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        logs = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            logs.append((out.read(), err.read()))
            out.close()
            err.close()
    if failed is not None:
        why = f"timed out after {timeout:g} s" if timed_out else f"exit {procs[failed].returncode}"
        raise RuntimeError(f"rank {failed} of {n} failed ({why}):\n{logs[failed][1][-4000:]}")
    return [out for out, _ in logs]


def mesh_for(n: int) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """JAX's dry-run mesh of n devices (``__graft_entry__.py`` l.172-178)."""
    if n >= 8:
        return (2, n // 4, 2), ("dp_host", "dp", "tp")
    if n >= 4:
        return (n // 2, 2), ("dp", "tp")
    return (n,), ("dp",)


def flagship_cfg():
    """JAX's tiny flagship config (``__graft_entry__.py`` ``_flagship_cfg(tiny=True)``)."""
    from kindergarten_vq_vae_torch.config import RunConfig

    return RunConfig(model_name="shelgon3", vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, intermediate_size=128, compute_dtype="float32", vq_e_dim=64,
                     enc_out_size=64, vq_n_e=9, fused_layer="on", fused_head_ce="store",
                     batch_size=8, tokenized_sentence_max_length=12)


def dryrun_multichip(n: int, timeout: float = 300.0) -> str:
    """One train step on n gloo CPU ranks on JAX's mesh for n; prints and
    returns rank 0's line."""
    argv = ["-m", "kindergarten_vq_vae_torch.parallel.dryrun", str(n), "--worker"]
    line = launch(n, argv, timeout)[0].strip().splitlines()[-1]
    print(line)
    return line


def _worker(n: int) -> None:
    import torch

    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.parallel.mesh import init_distributed, make_mesh, shard_batch
    from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step

    torch.set_num_threads(1)
    init_distributed(backend="gloo", device="cpu", timeout=60.0)
    shape, axis_names = mesh_for(n)
    mesh = make_mesh(shape, axis_names)
    cfg = flagship_cfg()
    # the batch must divide the total data-parallel degree (JAX l.182-184)
    dp = mesh.dp_size
    b = max(2 * dp, 8 - (8 % dp) if 8 % dp else 8)
    s = cfg.tokenized_sentence_max_length
    model = init_weights(build_model(cfg, fused_head=True), torch.Generator().manual_seed(0))
    state = init_train_state(cfg, model, mesh)
    step = make_train_step(cfg, "cpu", torch.Generator().manual_seed(1), mesh=mesh)
    rng = np.random.default_rng(0)
    batch = shard_batch(mesh, {
        "input_ids": torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, s))),
        "attention_mask": torch.ones((b, s), dtype=torch.int32), "n_valid": b})
    state, aux = step(state, batch)
    loss = float(aux["loss_full"])
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} in the multichip dry run")
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}): mesh={dict(zip(axis_names, shape))} "
              f"loss={loss:.4f} OK", flush=True)
    torch.distributed.destroy_process_group()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="one sharded train step on n CPU processes")
    parser.add_argument("n", type=int, help="ranks (processes)")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        _worker(args.n)
        return
    dryrun_multichip(args.n)


if __name__ == "__main__":
    main()
