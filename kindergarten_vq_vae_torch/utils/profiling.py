"""Tracing and timing helpers.

Counterpart of ``kindergarten_vq_vae_tpu/utils/profiling.py``: :func:`trace`
records a :mod:`torch.profiler` trace where JAX records a
``jax.profiler`` one, :class:`StepTimer` is the same wall-clock step timer
with the same summary, and :func:`benchmark_fn` times calls with one device
synchronisation at the end of the timed loop, as JAX blocks once.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str, device="cuda", name: str = "trace.json"):
    """Profile the block (host activity, and the card's on a CUDA
    ``device``) and write a Chrome trace to ``<log_dir>/<name>`` (view it in
    Perfetto or ``chrome://tracing``). Yields the profiler, whose
    ``key_averages()`` tabulate the block."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, name))


class StepTimer:
    """Wall-clock step timer with warmup exclusion and percentile summary."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._t0 = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[int(n * 0.9)],
            "min_s": ts[0],
            "max_s": ts[-1],
        }


def benchmark_fn(fn, args, n_steps: int = 20, warmup: int = 2, device="cuda") -> dict:
    """Time ``fn(*args)``: ``warmup`` calls, a synchronisation, then
    ``n_steps`` calls and one synchronisation of ``device`` at the end (the
    card's throughput; a synchronisation a call would time the host's
    dispatch instead)."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        fn(*args)
    _sync(device)
    dt = (time.perf_counter() - t0) / n_steps
    return {"mean_s": dt, "steps_per_sec": 1.0 / dt}
