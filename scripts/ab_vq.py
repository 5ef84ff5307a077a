#!/usr/bin/env python3
"""The VQ general path (#5 past the one-pass kernel) and the codebook
gradient (5+) of two trees on one card, in turns, with their bits compared.

    python3 scripts/ab_vq.py --parent DIR [--iters 10]

``--parent`` is another commit of the repository unpacked in a directory
(``git archive <commit> | tar -x -C runs/<dir>``). The script runs the
parent, this tree, this tree and the parent, each in its own process that
imports ``kindergarten_vq_vae_torch`` from its tree (and builds its kernels
there on first use), on the same seeded inputs at the step's 24,576 rows:

- ``random_512``: z ~ N(0, 1) x 768 against 512 codes uniform in +-1/512;
- ``random_1024``: the same x 1,280 against 1,024 codes;
- ``adversarial``: 512 codes x 768 on a shell of norm ~27.6, ~0.06 apart,
  with duplicate codes across 128-code tiles (2 = 5 = 200, 130 = 300 =
  511, 128 = 129), the rows near random codes (the rows' nearest codes are
  within f32 near ties of each other far more often than on random data);
- ``collapsed``: ``random_512``'s rows shifted along one direction (4
  sqrt(D)), as a freshly initialised encoder's rows share a direction: a
  few codes take every row (the grouped sums' long codes).

For each it times the raw forward (``ops/vq_kernel.py`` ``_launch_packed``:
indices, the straight-through z_q and the per-code statistics) and the
codebook gradient (``ops/vq.py`` ``codebook_grad`` given those indices) as
device time per call (a CUDA graph of ``--iters`` calls replayed between CUDA
events), and saves the indices and the SHA-256 of the other outputs' bytes. Then it checks that every run's indices
equal the first parent run's bit for bit (the script exits 1 where they do
not), and reports whether z_q, the statistics (sum_z, counts, the sum of
(z_q - z)^2) and the codebook gradient have the same bits too.

The last line is one JSON object: the card's name and ``nvidia-smi``'s name
and power limit, each run's times, and the comparisons. It imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, ROWS = 24, 24576
CASES = {"random_512": (768, 512), "random_1024": (1280, 1024), "adversarial": (768, 512),
         "collapsed": (768, 512)}


def _inputs(case: str, g):
    """The seeded rows, codebook and the gradient's g of a case (made the
    same way in both trees' processes)."""
    import torch

    d, n_e = CASES[case]
    if case != "adversarial":
        z = torch.randn(ROWS, d, device="cuda", generator=g)
        e = (torch.rand(n_e, d, device="cuda", generator=g) * 2 - 1) / n_e
        if case == "collapsed":
            u = torch.randn(d, device="cuda", generator=g)
            z = z + 4.0 * u / u.norm() * d**0.5
    else:
        base = torch.randn(d, device="cuda", generator=g)
        base *= 27.6 / base.norm()
        e = base + 0.06 / 2**0.5 * torch.randn(n_e, d, device="cuda", generator=g) / d**0.5
        for a, b in ((5, 2), (200, 2), (300, 130), (511, 130), (129, 128)):
            e[a] = e[b]
        pick = torch.randint(0, n_e, (ROWS,), device="cuda", generator=g)
        z = e[pick] + 0.02 / d**0.5 * torch.randn(ROWS, d, device="cuda", generator=g)
    return z.contiguous(), e.contiguous(), torch.tensor(0.37 / ROWS, device="cuda")


def _graph_ms(fn, calls: int) -> float:
    """Device time of one call: ``calls`` calls in a CUDA graph, replayed
    between CUDA events (warm-up off the capture first)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * calls)


def _digest(t) -> str:
    """The SHA-256 of a tensor's bytes (its bits, compared across trees)."""
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def child(root: str, save: str, iters: int) -> None:
    """One tree's run: times and outputs of every case."""
    sys.path.insert(0, root)
    import torch

    from kindergarten_vq_vae_torch import _build
    from kindergarten_vq_vae_torch.ops.vq import codebook_grad
    from kindergarten_vq_vae_torch.ops.vq_kernel import _launch_packed

    _build.lib()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    times, outs = {}, {}
    for case in CASES:
        z, e, gd = _inputs(case, g)
        zq, idx, stats = _launch_packed(z, e)[:3]  # a newer tree's also returns the grouping
        de = codebook_grad(z, idx, e, gd)
        torch.cuda.synchronize()
        times[case] = {"vq_ms": _graph_ms(lambda: _launch_packed(z, e), iters),
                       "codebook_grad_ms": _graph_ms(lambda: codebook_grad(z, idx, e, gd), iters)}
        outs[case] = {"idx": idx.cpu(), **{f: _digest(t) for f, t in
                                          (("zq", zq), ("stats", stats), ("de", de))}}
        del z, e, zq, idx, stats, de
        torch.cuda.empty_cache()
    torch.save(outs, save)
    print(json.dumps({"root": root, "times": times}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=False)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--save", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.save, args.iters)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_vq.py needs a CUDA device")
    if args.parent is None or not os.path.isdir(os.path.join(args.parent, "kindergarten_vq_vae_torch")):
        sys.exit("--parent: a tree of the repository with kindergarten_vq_vae_torch/ in it")
    parent = os.path.abspath(args.parent)
    order = [("parent", parent), ("tree", ROOT), ("tree", ROOT), ("parent", parent)]
    runs, saved = [], []
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "runs") if os.path.isdir(
            os.path.join(ROOT, "runs")) else None) as tmp:
        for i, (name, root) in enumerate(order):
            save = os.path.join(tmp, f"{i}.pt")
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                                  "--save", save, "--iters", str(args.iters)],
                                 capture_output=True, text=True, cwd=root)
            if out.returncode != 0:
                sys.exit(f"{name} run failed ({out.returncode}):\n{out.stdout[-4000:]}\n"
                         f"{out.stderr[-4000:]}")
            run = json.loads(out.stdout.strip().splitlines()[-1])
            run["tree"] = name
            runs.append(run)
            saved.append(torch.load(save))
            print(f"{name}: " + "; ".join(
                f"{c} vq {t['vq_ms']:.4f} ms, codebook_grad {t['codebook_grad_ms']:.4f} ms"
                for c, t in run["times"].items()), flush=True)
    ref = saved[0]
    same = {c: {"idx": all(torch.equal(s[c]["idx"], ref[c]["idx"]) for s in saved[1:]),
                **{f: all(s[c][f] == ref[c][f] for s in saved[1:]) for f in ("zq", "stats", "de")}}
            for c in CASES}
    for c in CASES:
        print(f"{c}: every run's bits equal the parent's: " +
              ", ".join(f"{f} {v}" for f, v in same[c].items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi[0] if smi else "",
                      "runs": runs, "bits_equal_to_parent": same}))
    if not all(same[c]["idx"] for c in CASES):
        sys.exit("the indices differ from the parent's")


if __name__ == "__main__":
    main()
