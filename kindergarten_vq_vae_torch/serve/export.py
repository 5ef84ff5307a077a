"""Ahead-of-time serving artifacts: the served forward as a ``torch.export`` program.

Counterpart of ``kindergarten_vq_vae_tpu/serve/export.py``: a run's
deterministic reconstruction forward is traced ONCE at one static bucket and
saved, and served later without the model-building Python in the serving
process. The parameters stay OUT of the artifact: the exported program takes
them as a call argument (a dict of tensors, through
:func:`torch.func.functional_call`), so one artifact serves any checkpoint of
the same geometry and holds no weights.

The kernels go into the program as the custom ops ``kvq::layer_fwd`` (#1),
``kvq::vq_fwd`` (#5) and ``kvq::sdpa_fwd`` (#11), registered when this module
imports them; on the card they launch the same kernels as the live forward,
on the CPU their plain versions. A program holds the device of its trace,
so an artifact exported on the CPU serves on the CPU and one exported on the
card serves on the card.

The Gumbel noise of Shelgon, Shelgon2 and Shelgon3-Gumbel comes, in the live
forward, from a generator seeded 0 on each forward; a trace cannot carry a
generator, so the program takes the noise as inputs, and the call that
:func:`load_exported` returns draws it as ``Reconstructor.forward`` does (the
same ``ops/gumbel.py`` ``sample_gumbels``, shapes and order): the artifact
gives the live forward's ids and codes bit for bit.

Artifact layout: ``<out>.pt2`` (``torch.export.save``) and ``<out>.json``
(``model_name``, ``seq_len``, ``bucket``, ``device``, ``ckpt_name``,
``compute_dtype`` and the noise's shapes and dtypes).

Usage::

    python -m kindergarten_vq_vae_torch.serve.export <run_dir> \\
        [--bucket 256] [--ckpt name] [--out path] [--device cuda|cpu] [--check]
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from kindergarten_vq_vae_torch.ops import layer as _layer  # noqa: F401  (kvq::layer_fwd)
from kindergarten_vq_vae_torch.ops import sdpa as _sdpa  # noqa: F401  (kvq::sdpa_fwd)
from kindergarten_vq_vae_torch.ops import vq_kernel as _vq  # noqa: F401  (kvq::vq_fwd)
from kindergarten_vq_vae_torch.ops.gumbel import GumbelFeed, sample_gumbels
from kindergarten_vq_vae_torch.serve.reconstructor import (
    Reconstructor,
    model_inputs,
    served_outputs,
)

class _Served(nn.Module):
    """``(params, ids, mask, noise) -> (recon_ids, codes)``: the served
    forward with the parameters and the Gumbel noise as arguments. The model
    is held outside the module tree, so none of its tensors enter the
    program."""

    def __init__(self, model: nn.Module, model_name: str):
        super().__init__()
        self._fwd = (model, model_name)

    def forward(self, params: dict, ids, mask, noise: list):
        model, model_name = self._fwd
        args, kwargs = model_inputs(model_name, ids, mask)
        out = torch.func.functional_call(model, params, args,
                                         {**kwargs, "generator": GumbelFeed(noise)})
        return served_outputs(out, ids)


def _params(model: nn.Module) -> dict:
    return {k: v.detach() for k, v in model.state_dict().items()}


def _noise_specs(served: _Served, params: dict, ids, mask) -> list:
    """The (shape, dtype) of each Gumbel draw of one forward, in order, from
    a run on fake tensors (no kernel launches, no memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model, model_name = served._fwd
    feed = GumbelFeed()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode, torch.no_grad():
        fake = {k: mode.from_tensor(v) for k, v in params.items()}
        args, kwargs = model_inputs(model_name, mode.from_tensor(ids), mode.from_tensor(mask))
        torch.func.functional_call(model, fake, args, {**kwargs, "generator": feed})
    return [[list(shape), str(dtype)] for shape, dtype in feed.specs]


def _draw(specs: list, device) -> list:
    """The noise of one forward as ``Reconstructor.forward`` draws it."""
    gen = torch.Generator(device=device).manual_seed(0)
    return [sample_gumbels(torch.empty(shape, dtype=getattr(torch, dtype.removeprefix("torch.")),
                                       device=device), gen)
            for shape, dtype in specs]


def export_reconstructor(run_path: str, bucket: int = 256, ckpt_name: str | None = None,
                         out_path: str | None = None, device="cuda"):
    """Export the run's reconstruction forward at a fixed bucket on
    ``device``; returns (artifact path without its suffix, meta dict). The
    program's calling convention is ``(params, ids[bucket, seq],
    mask[bucket, seq], noise) -> (recon_ids, codes)``; :func:`load_exported`
    supplies the noise."""
    r = Reconstructor(run_path, ckpt_name, batch_buckets=(bucket,), device=device)
    served = _Served(r.model, r.model_name)
    params = _params(r.model)
    ids = torch.ones((bucket, r.seq_len), dtype=torch.int32, device=r.device)
    mask = torch.ones_like(ids)
    specs = _noise_specs(served, params, ids, mask)
    with torch.no_grad():
        prog = torch.export.export(served, (params, ids, mask, _draw(specs, r.device)),
                                   strict=False)
    # the program keeps its example inputs, the parameters among them, and
    # would save them: the artifact holds the graph alone
    prog.example_inputs = None
    out = out_path or os.path.join(run_path, f"serve_{r.model_name}_b{bucket}")
    torch.export.save(prog, out + ".pt2")
    meta = {
        "model_name": r.model_name,
        "seq_len": r.seq_len,
        "bucket": bucket,
        "device": r.device.type,
        "ckpt_name": ckpt_name,
        "compute_dtype": r.cfg.compute_dtype,
        "gumbel_noise": specs,
    }
    with open(out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return out, meta


def load_exported(artifact_path: str, device="cuda"):
    """(call_fn, meta) from an exported artifact. ``call_fn(params, ids,
    mask)`` runs the saved program with the noise drawn as the live forward
    draws it (``call_fn.program``: the loaded ``ExportedProgram``); the
    artifact must have been exported for ``device``'s type."""
    with open(artifact_path + ".json") as f:
        meta = json.load(f)
    device = torch.device(device)
    if meta["device"] != device.type:
        raise ValueError(f"artifact {artifact_path} was exported for {meta['device']}, "
                         f"asked to serve on {device.type}")
    program = torch.export.load(artifact_path + ".pt2")
    prog = program.module()
    specs, shape = meta["gumbel_noise"], (meta["bucket"], meta["seq_len"])

    def call(params, ids, mask):
        if tuple(ids.shape) != shape or tuple(mask.shape) != shape:
            raise ValueError(f"artifact {artifact_path} was exported for (bucket, seq) {shape}, "
                             f"got ids {tuple(ids.shape)} and mask {tuple(mask.shape)}")
        with torch.no_grad():
            return prog(params, ids, mask, _draw(specs, ids.device))

    call.program = program
    return call, meta


def _main(argv=None):
    import argparse

    import numpy as np

    p = argparse.ArgumentParser(
        description="export a run's reconstruction forward as a torch.export serving artifact")
    p.add_argument("run_dir")
    p.add_argument("--bucket", type=int, default=256)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--check", action="store_true",
                   help="load the artifact and compare it with the live forward on random ids")
    args = p.parse_args(argv)

    out, meta = export_reconstructor(args.run_dir, bucket=args.bucket, ckpt_name=args.ckpt,
                                     out_path=args.out, device=args.device)
    size = os.path.getsize(out + ".pt2")
    print(f"exported {meta['model_name']} bucket={meta['bucket']} device={meta['device']} "
          f"-> {out}.pt2 ({size / 1e6:.2f} MB)")
    if args.check:
        r = Reconstructor(args.run_dir, args.ckpt, batch_buckets=(args.bucket,),
                          device=args.device)
        call, _ = load_exported(out, device=args.device)
        rng = np.random.default_rng(0)
        top = min(100, r.cfg.vocab_size, r.decoder_vocab_size)
        ids = torch.from_numpy(rng.integers(1, top, (args.bucket, r.seq_len)).astype(np.int32))
        ids = ids.to(r.device)
        mask = torch.ones_like(ids)
        with torch.inference_mode():
            got = call(_params(r.model), ids, mask)
            want = r.forward(ids, mask)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise SystemExit("check FAILED: the artifact disagrees with the live forward")
        print("check OK: the loaded program matches the live forward")


if __name__ == "__main__":
    _main()
