"""The port's single-pass AMSGrad update (kernel #14's plain version) vs the JAX package's.

Five steps with L2 decay 0.01 and a MultiStepLR milestone at step 3, over
leaves that cover the kernel's cases: a 2-D lane-aligned leaf (through the
Pallas kernel in interpret mode on the JAX side), a 1-D leaf, a leaf of odd
length (the tied MLM bias's case), a leaf without a gradient (optax updates
it with g = 0; the port passes None) and a frozen leaf. The port's plain
version is held to JAX's ``FusedAdam`` (Pallas in interpret mode, and its
``path="jnp"``) and to the optax chain of ``make_optimizer(cfg, mask)`` at
rel 1e-6: both sides compute the same f32 expressions in the same order, and
rel 1e-6 (~8 ulps) leaves room for XLA's CPU fusion contracting a multiply
and an add into an FMA, which PyTorch's one-kernel-per-operation plain
version never does. The frozen leaf, and on the port side its moments, stay
bit-identical. The step count and the scalars follow the host's f32
arithmetic of ``FusedAdam.apply``.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.adam_pallas import FusedAdam as JaxFusedAdam
from kindergarten_vq_vae_tpu.train.config import OptimConfig
from kindergarten_vq_vae_tpu.train.optim import make_optimizer as jax_make_optimizer
from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.ops.adam import AdamScalars, adam_update_reference, amsgrad_update
from kindergarten_vq_vae_torch.train.optim import (
    FusedAdam,
    make_optimizer,
    resolve_fused_update,
    scalars,
)

SHAPES = {"w": (16, 128), "b": (96,), "odd": (61,), "nograd": (8, 128), "frozen": (8, 128)}
MASK = {k: k != "frozen" for k in SHAPES}
OPT = dict(lr=3e-3, weight_decay=0.01, lr_scheduler="MultiStepLR", milestones=(3,), gamma=0.1)
REL = 1e-6


def _params():
    rng = np.random.default_rng(0)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    g["nograd"] = np.zeros(SHAPES["nograd"], np.float32)
    return g


def _jax_runs(params, n_steps):
    cfg = OptimConfig(**OPT)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tx = jax_make_optimizer(cfg, MASK)
    out = {}
    for name, opt in (("kernel", JaxFusedAdam(cfg, MASK, interpret=True)),
                      ("jnp", JaxFusedAdam(cfg, MASK, path="jnp")), ("optax", tx)):
        p, st = jp, opt.init(jp)
        for step in range(n_steps):
            g = {k: jnp.asarray(v) for k, v in _grads(step).items()}
            if name == "optax":
                upd, st = opt.update(g, st, p)
                p = optax.apply_updates(p, upd)
            else:
                p, st = opt.apply(g, st, p)
        out[name] = {k: np.asarray(v) for k, v in p.items()}
    return out


def _port_run(params, n_steps, fused_update="on"):
    cfg = RunConfig(amsgrad=True, fused_update=fused_update, **OPT)
    names = [k for k in SHAPES if MASK[k]]
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = make_optimizer(cfg, "cpu")
    st = opt.init([tp[k] for k in names])
    for step in range(n_steps):
        g = _grads(step)
        opt.update([tp[k] for k in names],
                   [None if k == "nograd" else torch.from_numpy(g[k]) for k in names], st)
    return {k: v.numpy() for k, v in tp.items()}, st


def test_plain_update_matches_jax_fused_adam_and_optax():
    params = _params()
    want = _jax_runs(params, 5)
    got, st = _port_run(params, 5)
    assert st.count == 5
    for path, ref in want.items():
        for k in SHAPES:
            np.testing.assert_allclose(got[k], ref[k], rtol=REL, atol=0, err_msg=f"{path}:{k}")
    np.testing.assert_array_equal(got["frozen"], params["frozen"])
    assert not np.array_equal(got["nograd"], params["nograd"])  # moved by the L2 term


@pytest.mark.parametrize("fused_update, amsgrad, device, want", [
    ("auto", True, "cuda", "kernel"), ("on", True, "cuda", "kernel"),
    ("jnp", True, "cuda", "plain"), ("off", True, "cuda", None), ("auto", False, "cuda", None),
    ("auto", True, "cpu", "plain"), ("on", True, "cpu", "plain"),
])
def test_resolve_fused_update(fused_update, amsgrad, device, want):
    cfg = RunConfig(fused_update=fused_update, amsgrad=amsgrad)
    assert resolve_fused_update(cfg, device) == want


def test_off_path_matches_the_fused_path():
    """The optax-form update ("off") and the single-pass one ("on") agree to
    rel 1e-6 over the same steps (the same f32 arithmetic, ordered per leaf
    in a different way)."""
    params = _params()
    got_on, _ = _port_run(params, 5, "on")
    got_off, st = _port_run(params, 5, "off")
    assert st.count == 5
    for k in SHAPES:
        np.testing.assert_allclose(got_off[k], got_on[k], rtol=REL, atol=0, err_msg=k)


def test_scalars_follow_the_host_f32_arithmetic():
    cfg = RunConfig(**OPT)
    s = scalars(cfg, 3)
    f32 = np.float32
    assert s.lr == float(f32(OPT["lr"]) * f32(0.1))  # milestone 3 reached at count 3
    assert s.bc1 == float(f32(1.0) - f32(0.9) ** f32(4))
    assert s.omb2 == float(f32(1.0 - 0.999)) != float(f32(1.0) - f32(0.999))


def test_amsgrad_update_on_cpu_tensors_is_the_plain_version():
    rng = np.random.default_rng(7)
    shapes = [(5, 3), (7,)]
    s = AdamScalars(*(float(np.float32(v)) for v in (1e-2, 0.1, 0.9, 0.999, 1e-8, 0.1, 0.001,
                                                     0.1, 0.001)))
    leaves = [[torch.from_numpy(rng.normal(size=sh).astype(np.float32)) for sh in shapes]
              for _ in range(5)]
    a = [[t.clone() for t in leaf] for leaf in leaves]
    before = amsgrad_update.launches
    amsgrad_update(a[0], [a[1][0], None], a[2], a[3], [v.abs() for v in a[4]], s)
    b = [[t.clone() for t in leaf] for leaf in leaves]
    vmax = [v.abs() for v in b[4]]
    for i in range(2):
        adam_update_reference(b[0][i], b[1][0] if i == 0 else None, b[2][i], b[3][i], vmax[i], s)
    for x, y in zip(a[0] + a[2] + a[3], b[0] + b[2] + b[3]):
        assert torch.equal(x, y)
    assert amsgrad_update.launches == before  # no kernel on the CPU


def test_fused_adam_rejects_unknown_path():
    with pytest.raises(ValueError):
        FusedAdam(RunConfig(), "pallas")
