"""The port's multi-device layer vs the JAX package's: sharding rules, batch
slices, seed folds, and the sharded VQ, head + CE and training loss on a
``(2, 2)`` ``dp x tp`` mesh of four gloo CPU processes.

The JAX references run in this process on the 8 virtual CPU devices of
``tests/conftest.py`` (Pallas in interpret mode, as ``tests/test_parallel.py``
runs it). The port runs in worker processes started by
``kindergarten_vq_vae_torch.parallel.dryrun.launch`` (one gloo rank each,
60 s process-group timeout, one CPU thread); they import neither jax nor
this package's tests, and take their inputs and hand back their results as
``.npz`` files under ``tmp_path``. One spawn of four ranks makes every
mesh check, while this process computes the JAX references. Bars:

- sharded VQ vs ``fused_vector_quantize_sharded``: ``test_parallel.py``
  l.99-140 (loss rtol 1e-5, z_q and both gradients atol 1e-5, counts exact,
  perplexity rtol 1e-4);
- sharded head + CE (the port's head + CE on a rank's rows under the global
  normaliser, the share summed over dp, as the loss functions run it) vs
  ``fused_head_ce_loss_sharded`` in store and flash:
  ``tests/test_torch_head_ce.py``'s f32 bars (loss rtol 1e-5, ids exact,
  gradients rtol 2e-5, atol 1e-6);
- the "val" loss and every parameter gradient of a tiny f32 Shelgon3-VQ,
  with ``n_valid`` 7 of the global 8 rows (the last row, on dp rank 1, is
  invalid: a valid mask by local row index would count it): the port on
  the mesh (whole-layer trunk and per-module trunk with the store head, the
  whole-layer trunk with the streaming CE #7 / #8) vs JAX's
  ``make_loss_fn(cfg, "val", mesh)`` (per-module trunk, sharded Pallas VQ,
  sharded store head) at JAX's own bars (loss rtol 2e-5; gradients atol
  5e-5 * scale + 1e-6, rtol 5e-3, ``test_parallel.py`` l.300-310); and vs
  the port's one-process loss on the global batch: the mesh's reductions
  are f32 sums of two partials, so the loss is held to rtol 1e-6 and each
  gradient to rtol 1e-6 beside atol 1e-6 of its leaf's largest element
  (an element that is a sum of cancelling terms keeps an absolute error);
- ``wandb_watch_model``'s gradient norms on the mesh (a tp leaf's summed
  over its two shards) against the one-process gradients' (rtol 1e-5);
- ``wandb_watch_histograms``' recomputed train gradients on the mesh (with
  dropout rates 0, whose draws a dp mesh folds apart from one process's)
  against the one-process train gradients, at the one-process bars;
- one train step on the 3-axis mesh ``(2, 1, 2)`` (``dp_host x dp x tp``)
  gives the ``(2, 2)`` mesh's loss and parameters: both split the batch
  over two dp ranks and the parameters over two tp ranks.
"""

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from kindergarten_vq_vae_tpu.data.dataset import BatchIterator as JaxBatchIterator
from kindergarten_vq_vae_tpu.data.dataset import DSentences as JaxDSentences
from kindergarten_vq_vae_tpu.ops.head_ce_pallas import (
    fused_head_ce_loss_sharded as jax_head_ce_sharded,
)
from kindergarten_vq_vae_tpu.ops.vq_pallas import fused_vector_quantize_sharded
from kindergarten_vq_vae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kindergarten_vq_vae_tpu.parallel.mesh import param_sharding_rules as jax_rules
from kindergarten_vq_vae_tpu.parallel.mesh import shard_batch as jax_shard_batch
from kindergarten_vq_vae_tpu.parallel.mesh import shard_params as jax_shard_params
from kindergarten_vq_vae_tpu.train.config import RunConfig as JaxRunConfig
from kindergarten_vq_vae_tpu.train.variants import init_params
from kindergarten_vq_vae_tpu.train.variants import make_loss_fn as jax_make_loss_fn
from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.data.dataset import BatchIterator, DSentences
from kindergarten_vq_vae_torch.models import build_model
from kindergarten_vq_vae_torch.parallel.dryrun import launch
from kindergarten_vq_vae_torch.parallel.mesh import fold_seeds, param_sharding_rules
from kindergarten_vq_vae_torch.train.variants import make_loss_fn

B, S, V, H = 8, 12, 256, 64
N_VALID = 7
TINY = dict(model_name="shelgon3", vocab_size=V, hidden_size=H, num_layers=2, num_heads=4,
            intermediate_size=128, compute_dtype="float32", vq_e_dim=H, enc_out_size=H,
            vq_n_e=9, batch_size=B, tokenized_sentence_max_length=S)
# (name, port overrides): the JAX reference is the first's with fused_layer "off"
LOSS_CASES = (("layer_store", dict(fused_layer="on", fused_head_ce="store")),
              ("module_store", dict(fused_layer="off", fused_head_ce="store")),
              ("layer_logits", dict(fused_layer="on", fused_head_ce="off")))
JAX_TILES = dict(layer_block_b_fwd=8, layer_block_b_bwd=8, layer_attn_chunk=4,
                 head_ce_block_r=32, head_ce_block_v=128, vq_use_fused=True)
HEAD_MODES = ("store", "flash")

WORKER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.models import build_model
from kindergarten_vq_vae_torch.ops.head_ce import fused_head_ce_loss
from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel
from kindergarten_vq_vae_torch.parallel.mesh import (
    TPShards, dp_sum, init_distributed, make_mesh, reduce_gradients, shard_batch, use_mesh)
from kindergarten_vq_vae_torch.train.step import (
    init_train_state, make_train_step, train_gradients)
from kindergarten_vq_vae_torch.train.variants import make_loss_fn

d = sys.argv[1]
cases = json.loads(sys.argv[2])
rank, _ = init_distributed(backend="gloo", device="cpu", timeout=60.0)
mesh = make_mesh((2, 2), ("dp", "tp"))
inp = dict(np.load(os.path.join(d, "inputs.npz")))
t = {k: torch.from_numpy(v) for k, v in inp.items()}
out = {}


def rows(x):
    return shard_batch(mesh, {"x": x})["x"]


# the sharded VQ: forward, and the gradients of loss + sum(z_q / 2)
z = rows(t["vq_z"]).clone().requires_grad_(True)
e = t["vq_e"].clone().requires_grad_(True)
with use_mesh(mesh):
    o = vector_quantize_kernel(z, e, 0.25)
(o.loss + (o.z_q * 0.5).sum()).backward()
mesh.all_reduce_dp(e.grad)
out.update(vq_loss=o.loss.detach(), vq_zq=mesh.gather_rows_dp(o.z_q.detach()),
           vq_counts=o.counts, vq_perp=o.perplexity, vq_dz=mesh.gather_rows_dp(z.grad),
           vq_de=e.grad)

# the sharded head + CE as the loss functions run it: the rank's rows under
# the global normaliser, the share summed over dp
for mode in ("store", "flash"):
    x = rows(t["head_x"]).clone().requires_grad_(True)
    tab = t["head_table"].clone().requires_grad_(True)
    bias = t["head_bias"].clone().requires_grad_(True)
    valid = rows(t["head_valid"])
    with use_mesh(mesh):
        (n_valid,) = dp_sum(valid.sum())
        part, ids = fused_head_ce_loss(x, tab, bias, rows(t["head_tgt"]), valid,
                                       torch.clamp(n_valid, min=1.0) * x.shape[1], mode)
        (loss,) = dp_sum(part)
    loss.backward()
    mesh.all_reduce_dp(tab.grad)
    mesh.all_reduce_dp(bias.grad)
    out.update({f"head_{mode}_loss": loss.detach(), f"head_{mode}_ids": mesh.gather_rows_dp(ids),
                f"head_{mode}_dx": mesh.gather_rows_dp(x.grad), f"head_{mode}_dtable": tab.grad,
                f"head_{mode}_dbias": bias.grad})

params = {k[2:]: v for k, v in t.items() if k.startswith("p.")}
batch = shard_batch(mesh, {"input_ids": t["ids"], "attention_mask": t["mask"],
                           "n_valid": int(t["n_valid"])})

# the val loss and every parameter's gradient, reduced over the mesh
for name, over in cases:
    cfg = RunConfig(**over)
    model = build_model(cfg, fused_head=cfg.fused_head_ce != "off")
    model.load_state_dict(params)
    loss, aux = make_loss_fn(cfg, "val", mesh=mesh)(model, batch, torch.Generator(), True)
    loss.backward()
    shards = TPShards(mesh, model.named_parameters())
    reduce_gradients(mesh, model.named_parameters(), shards)
    whole = shards.gather({n: leaf.grad for n, leaf in shards.leaves.items()})
    out[f"{name}_loss"] = loss.detach()
    for k in ("loss_recon", "loss_vq", "metric_perp", "metric_acc"):
        out[f"{name}_{k}"] = aux[k]
    for n, p in model.named_parameters():
        g = whole.get(n, p.grad)
        if g is not None:
            out[f"{name}_g.{n}"] = g

# one step without dropout, with the gradient norms (each tp leaf's over its shards)
cfg = RunConfig(**{**cases[0][1], "wandb_watch_model": True})
model = build_model(cfg, fused_head=True)
model.load_state_dict(params)
step = make_train_step(cfg, "cpu", torch.Generator(), deterministic=True, mesh=mesh)
_, aux = step(init_train_state(cfg, model, mesh), batch)
out.update(watch_grads=aux["watch_grads"], grad_norm=aux["grad_norm"])

# the gradient histograms' recomputation (train stage, dropout rates 0)
cfg = RunConfig(**{**cases[0][1], "hidden_dropout": 0.0, "attention_dropout": 0.0})
model = build_model(cfg, fused_head=True)
model.load_state_dict(params)
grads = train_gradients(cfg, init_train_state(cfg, model, mesh), batch, torch.Generator(), mesh)
out.update({f"hist_g.{n}": g for (n, _), g in zip(model.named_parameters(), grads)})

# one train step (dropout on) on (2, 2) and on (2, 1, 2) from the same weights and seed
cfg = RunConfig(**cases[0][1])
for shape, axes in (((2, 2), ("dp", "tp")), ((2, 1, 2), ("dp_host", "dp", "tp"))):
    m = make_mesh(shape, axes)
    model = build_model(cfg, fused_head=True)
    model.load_state_dict(params)
    state = init_train_state(cfg, model, m)
    step = make_train_step(cfg, "cpu", torch.Generator().manual_seed(5), mesh=m)
    state, aux = step(state, shard_batch(m, {"input_ids": t["ids"], "attention_mask": t["mask"],
                                             "n_valid": int(t["n_valid"])}))
    tag = "x".join(map(str, shape))
    out[f"step_{tag}_loss"] = aux["loss_full"]
    out[f"step_{tag}_qkv"] = model.encoder.layer_0.self_attn.qkv.kernel.detach()
    out[f"step_{tag}_cb"] = model.vector_quantizer.codebook.detach()
if rank == 0:
    np.savez(os.path.join(d, "out.npz"), **{k: v.detach().numpy() for k, v in out.items()})
torch.distributed.destroy_process_group()
'''


def _port_cfg(**over) -> RunConfig:
    return RunConfig(**{**TINY, **over})


def _jax_cfg(**over) -> JaxRunConfig:
    return JaxRunConfig.from_flat_dict(_port_cfg(**{**JAX_TILES, **over}).get_config())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if hasattr(v, "items") else {key: np.asarray(v)})
    return out


def _shapes_mesh(shape, names):
    return types.SimpleNamespace(shape=shape, axis_names=names)


@pytest.mark.parametrize("shape, names", [((4, 2), ("dp", "tp")),
                                          ((2, 1, 2), ("dp_host", "dp", "tp"))])
def test_sharding_rules_match_jax(shape, names):
    """Every leaf of a tiny Shelgon3 gets JAX's spec for its path, the
    undivisible ones replicated."""
    jcfg = _jax_cfg(vocab_size=255)  # an odd vocabulary: its two leaves stay replicated
    shapes = jax.eval_shape(lambda: init_params(jcfg, jax.random.key(0)))
    params = {".".join(k): v for k, v in flatten_dict(shapes).items()}
    shardings = jax_rules(shapes, jax_make_mesh(shape, names))
    want = {".".join(k): tuple(v.spec) for k, v in flatten_dict(shardings).items()}
    model = build_model(_port_cfg(vocab_size=255))
    got = param_sharding_rules(dict(model.named_parameters()), _shapes_mesh(shape, names))
    assert set(got) == set(params) == set(want)
    assert got == want
    assert got["encoder.embeddings.word_embeddings.embedding"] == ()
    assert got["encoder.layer_0.self_attn.qkv.kernel"] == (None, "tp")


@pytest.mark.parametrize("count", [2, 4])
def test_batch_slices_match_jax(count):
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 100, (50, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    for idx in range(count):
        kw = dict(batch_size=16, shuffle=True, seed=3, process_index=idx, process_count=count)
        got = list(BatchIterator(DSentences(input_ids=ids, attention_mask=mask), **kw))
        want = list(JaxBatchIterator(JaxDSentences(input_ids=ids, attention_mask=mask), **kw))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g["input_ids"].shape == (16 // count, 12)
            for k in ("input_ids", "index", "n_valid"):
                np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match="must divide"):
        next(iter(BatchIterator(DSentences(input_ids=ids, attention_mask=mask), batch_size=6,
                                process_count=4)))


def test_seed_fold_matches_jax():
    edges = [-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1, 0x632BE5AB, -0x632BE5AB]
    for shard in range(8):
        want = np.asarray(jnp.asarray(edges, jnp.int32) + jnp.int32(shard) * jnp.int32(0x632BE5AB))
        assert fold_seeds(edges, shard) == want.tolist()


def _inputs():
    rng = np.random.default_rng(0)
    inp = {
        "vq_z": rng.normal(size=(B, S, 128)).astype(np.float32),
        "vq_e": rng.normal(size=(9, 128)).astype(np.float32),
        "head_x": rng.normal(size=(B, S, H)).astype(np.float32),
        "head_table": (0.1 * rng.normal(size=(V, H))).astype(np.float32),
        "head_bias": (0.1 * rng.normal(size=(V,))).astype(np.float32),
        "head_tgt": rng.integers(0, V, (B, S)).astype(np.int32),
        "head_valid": (np.arange(B) < N_VALID).astype(np.float32),
        "ids": rng.integers(1, V, (B, S)).astype(np.int64),
        "mask": np.ones((B, S), np.int32),
        "n_valid": np.int64(N_VALID),
    }
    params = jax.tree_util.tree_map(np.asarray, init_params(_jax_cfg(), jax.random.key(0)))
    inp.update({f"p.{k}": v for k, v in _flat(params).items()})
    return inp, params


def _jax_refs(inp, params):
    """The JAX package's sharded functions and mesh loss on the (2, 2) mesh."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    mesh = jax_make_mesh((2, 2), ("dp", "tp"))
    ref = {}
    z = jax.device_put(inp["vq_z"], NamedSharding(mesh, P("dp")))
    e = jnp.asarray(inp["vq_e"])

    def vq_loss(zz, ee):
        o = fused_vector_quantize_sharded(zz, ee, 0.25, mesh)
        return o.loss + jnp.sum(o.z_q * 0.5), o

    (_, o), (dz, de) = jax.jit(jax.value_and_grad(vq_loss, argnums=(0, 1), has_aux=True))(z, e)
    ref.update(vq_loss=o.loss, vq_zq=o.z_q, vq_counts=o.counts, vq_perp=o.perplexity, vq_dz=dz,
               vq_de=de)
    dp = P("dp")
    x, tgt, valid = (jax.device_put(inp[k], NamedSharding(mesh, dp))
                     for k in ("head_x", "head_tgt", "head_valid"))
    for mode in HEAD_MODES:
        def head(xx, tab, bias, mode=mode):
            return jax_head_ce_sharded(xx, tab, bias, tgt, valid, mesh, ("dp",), mode, 32, 128,
                                       True)

        (loss, ids), grads = jax.jit(jax.value_and_grad(head, argnums=(0, 1, 2), has_aux=True))(
            x, jnp.asarray(inp["head_table"]), jnp.asarray(inp["head_bias"]))
        ref.update({f"head_{mode}_loss": loss, f"head_{mode}_ids": ids,
                    **{f"head_{mode}_{k}": g for k, g in zip(("dx", "dtable", "dbias"), grads)}})
    cfg = _jax_cfg(fused_layer="off", fused_head_ce="store")
    loss_fn = jax_make_loss_fn(cfg, "val", mesh=mesh)
    rngs = {k: jax.random.key(i) for i, k in enumerate(("dropout", "gumbel", "perturb"))}
    batch = jax_shard_batch(mesh, {"input_ids": inp["ids"].astype(np.int32),
                                   "attention_mask": inp["mask"],
                                   "n_valid": np.int32(N_VALID)})
    with mesh:
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p, b: loss_fn(p, b, rngs, True), has_aux=True))(
            jax_shard_params(mesh, params), batch)
    ref["loss"] = loss
    ref.update({k: aux[k] for k in ("loss_recon", "loss_vq", "metric_perp", "metric_acc")})
    ref.update({f"g.{k}": v for k, v in _flat(jax.tree_util.tree_map(np.asarray, grads)).items()})
    return {k: np.asarray(v) for k, v in ref.items()}


def _one_process(inp, over, stage="val"):
    """The port's one-process loss and gradients on the global batch (the
    train stage with dropout on, drawn from an unseeded generator)."""
    cfg = _port_cfg(**over)
    model = build_model(cfg, fused_head=cfg.fused_head_ce != "off")
    model.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in inp.items()
                           if k.startswith("p.")})
    batch = {"input_ids": torch.from_numpy(inp["ids"]),
             "attention_mask": torch.from_numpy(inp["mask"]), "n_valid": N_VALID}
    loss, _ = make_loss_fn(cfg, stage)(model, batch, torch.Generator(), stage != "train")
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy() for n, p in model.named_parameters()
                         if p.grad is not None}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The four-rank spawn's results beside the JAX references computed meanwhile."""
    d = tmp_path_factory.mktemp("mesh")
    inp, params = _inputs()
    np.savez(d / "inputs.npz", **inp)
    cases = [[name, {**TINY, **over}] for name, over in LOSS_CASES]
    import json

    box = {}

    def spawn():
        try:
            launch(4, ["-c", WORKER, str(d), json.dumps(cases)], timeout=240.0)
        except RuntimeError as err:  # re-raised in the test's thread
            box["error"] = err

    worker = threading.Thread(target=spawn)
    worker.start()
    try:
        ref = _jax_refs(inp, params)
    finally:
        worker.join(timeout=300.0)
    assert not worker.is_alive(), "the mesh workers outlived their deadline"
    if "error" in box:
        raise box["error"]
    return inp, ref, dict(np.load(d / "out.npz"))


def test_vq_sharded_matches_jax(mesh_run):
    _, ref, got = mesh_run
    np.testing.assert_allclose(got["vq_loss"], ref["vq_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["vq_zq"], ref["vq_zq"], atol=1e-5)
    np.testing.assert_array_equal(got["vq_counts"], ref["vq_counts"])
    np.testing.assert_allclose(got["vq_perp"], ref["vq_perp"], rtol=1e-4)
    np.testing.assert_allclose(got["vq_dz"], ref["vq_dz"], atol=1e-5)
    np.testing.assert_allclose(got["vq_de"], ref["vq_de"], atol=1e-5)


@pytest.mark.parametrize("mode", HEAD_MODES)
def test_head_ce_sharded_matches_jax(mesh_run, mode):
    _, ref, got = mesh_run
    np.testing.assert_allclose(got[f"head_{mode}_loss"], ref[f"head_{mode}_loss"], rtol=1e-5)
    np.testing.assert_array_equal(got[f"head_{mode}_ids"], ref[f"head_{mode}_ids"])
    for k in ("dx", "dtable", "dbias"):
        np.testing.assert_allclose(got[f"head_{mode}_{k}"], ref[f"head_{mode}_{k}"], rtol=2e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", [name for name, _ in LOSS_CASES])
def test_mesh_loss_and_grads_match_jax_and_one_process(mesh_run, case):
    inp, ref, got = mesh_run
    loss1, grads1 = _one_process(inp, dict(LOSS_CASES)[case])
    np.testing.assert_allclose(got[f"{case}_loss"], ref["loss"], rtol=2e-5)
    for k in ("loss_recon", "loss_vq", "metric_perp", "metric_acc"):
        np.testing.assert_allclose(got[f"{case}_{k}"], ref[k], rtol=2e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got[f"{case}_loss"], loss1, rtol=1e-6)
    names = sorted(k[2:] for k in ref if k.startswith("g."))
    assert sorted(k[len(case) + 3:] for k in got if k.startswith(f"{case}_g.")) == sorted(
        n for n in names if n in grads1)
    scale = max(float(np.abs(ref[f"g.{n}"]).max()) for n in names)
    for n in grads1:
        g = got[f"{case}_g.{n}"]
        np.testing.assert_allclose(g, ref[f"g.{n}"], atol=5e-5 * scale + 1e-6, rtol=5e-3,
                                   err_msg=f"{n} vs JAX")
        np.testing.assert_allclose(g, grads1[n], rtol=1e-6,
                                   atol=1e-6 * float(np.abs(grads1[n]).max()),
                                   err_msg=f"{n} vs one process")


def test_three_axis_mesh_step_matches_two_axis(mesh_run):
    _, _, got = mesh_run
    assert np.isfinite(got["step_2x2_loss"])
    for k in ("loss", "qkv", "cb"):
        np.testing.assert_array_equal(got[f"step_2x1x2_{k}"], got[f"step_2x2_{k}"], err_msg=k)


def test_mesh_gradient_norms_match_one_process(mesh_run):
    """``wandb_watch_model``'s per-leaf norms on the mesh (a tp leaf's summed
    over its shards) against those of the one-process gradients."""
    inp, _, got = mesh_run
    _, grads1 = _one_process(inp, dict(LOSS_CASES)["layer_store"])
    names = [n for n, _ in build_model(_port_cfg(fused_head_ce="store"),
                                       fused_head=True).named_parameters()]
    want = np.array([np.sqrt(np.sum(np.square(grads1[n].astype(np.float64)))) if n in grads1
                     else 0.0 for n in names])
    np.testing.assert_allclose(got["watch_grads"], want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["grad_norm"], np.sqrt(np.sum(want ** 2)), rtol=1e-5)


def test_mesh_histogram_gradients_match_one_process(mesh_run):
    """``wandb_watch_histograms``' recomputed train gradients on the mesh
    (every rank's share summed, the tp leaves gathered whole) against the
    one-process train gradients, at the one-process bars above; a leaf the
    loss does not reach has zeros."""
    inp, _, got = mesh_run
    over = {**dict(LOSS_CASES)["layer_store"], "hidden_dropout": 0.0, "attention_dropout": 0.0}
    _, grads1 = _one_process(inp, over, "train")
    names = [n for n, _ in build_model(_port_cfg(**over), fused_head=True).named_parameters()]
    assert sorted(k[7:] for k in got if k.startswith("hist_g.")) == sorted(names)
    for n in names:
        g = got[f"hist_g.{n}"]
        if n not in grads1:
            assert not g.any(), n
            continue
        np.testing.assert_allclose(g, grads1[n], rtol=1e-6,
                                   atol=1e-6 * float(np.abs(grads1[n]).max()), err_msg=n)
