"""Checkpoint reader, weight bridge and import hygiene of the PyTorch port."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ckpt.checkpoint import restore_checkpoint, save_checkpoint
from kindergarten_vq_vae_tpu.train.config import ModelConfig, RunConfig
from kindergarten_vq_vae_tpu.train.variants import init_params
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax, params_to_jax
from kindergarten_vq_vae_torch.ckpt.checkpoint import read_checkpoint, write_checkpoint
from kindergarten_vq_vae_torch.config import RunConfig as TorchRunConfig
from kindergarten_vq_vae_torch.models import build_model, init_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_cfg(model_name):
    return RunConfig(model=ModelConfig(
        model_name=model_name, vocab_size=40, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, compute_dtype="float32", vq_e_dim=32, enc_out_size=32, vq_n_e=5))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, key)
        else:
            yield key, v


def test_reads_jax_checkpoint_with_bf16_leaf(tmp_path):
    tree = {"a": {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
                  "h": jnp.asarray([1.5, -2.25, 3.0e-3], jnp.bfloat16)},
            "n": jnp.asarray([3, 4], jnp.int32)}
    save_checkpoint(str(tmp_path / "ck"), tree)
    got = read_checkpoint(str(tmp_path / "ck"))
    np.testing.assert_array_equal(got["a"]["w"], np.asarray(tree["a"]["w"]))
    np.testing.assert_array_equal(got["n"], np.asarray(tree["n"]))
    h = got["a"]["h"]
    assert isinstance(h, torch.Tensor) and h.dtype == torch.bfloat16
    np.testing.assert_array_equal(h.float().numpy(), np.asarray(tree["a"]["h"], np.float32))


def test_written_checkpoint_reads_back_in_jax(tmp_path):
    tree = {"x": {"k": np.ones((2, 2), np.float32)}, "b": torch.tensor([0.5, 1.0]).bfloat16()}
    write_checkpoint(str(tmp_path / "ck"), tree)
    got = restore_checkpoint(str(tmp_path / "ck"))
    np.testing.assert_array_equal(np.asarray(got["x"]["k"]), tree["x"]["k"])
    assert got["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["b"], np.float32), [0.5, 1.0])


@pytest.mark.parametrize("model_name", ["shelgon3", "bagon"])
def test_bridge_round_trip_and_strict_load(model_name):
    cfg = _tiny_cfg(model_name)
    tree = jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.key(0)))
    back = params_to_jax(params_from_jax(tree))
    want, got = dict(_leaves(tree)), dict(_leaves(back))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    tcfg = TorchRunConfig.from_flat_dict(cfg.get_config())
    model = build_model(tcfg)
    model.load_state_dict(params_from_jax(tree), strict=True)  # every Flax leaf, no extras
    for k, v in dict(_leaves(params_to_jax(model))).items():
        np.testing.assert_array_equal(v, want[k])


def test_store_mode_run_loads_into_the_fused_head_model():
    """A ``fused_head_ce="store"`` JAX run has the logits model's parameter
    tree (JAX ``nn/bert.py:610``), so its weights load strictly into the
    port's fused-head model, whose decoder then hands out the tied table."""
    cfg = _tiny_cfg("shelgon3")
    cfg = RunConfig(model=dataclasses.replace(cfg.model, fused_head_ce="store"), data=cfg.data)
    tree = jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.key(0)))
    model = build_model(TorchRunConfig.from_flat_dict(cfg.get_config()), fused_head=True)
    model.load_state_dict(params_from_jax(tree), strict=True)
    ids = torch.ones((2, 12), dtype=torch.long)
    out = model(ids, torch.ones_like(ids))
    assert "logits" not in out and out["mlm_hidden"].shape == (2, 12, 32)
    assert out["head_table"] is model.decoder.bert.embeddings.word_embeddings.embedding
    np.testing.assert_array_equal(out["head_table"].detach().numpy(),
                                  tree["decoder"]["bert"]["embeddings"]["word_embeddings"]
                                  ["embedding"])
    np.testing.assert_array_equal(out["head_bias"].detach().numpy(),
                                  tree["decoder"]["mlm_head"]["decoder_bias"])


def test_seeded_init_is_reproducible():
    tcfg = TorchRunConfig(model_name="shelgon3", vocab_size=40, hidden_size=32, num_layers=1,
                          num_heads=2, intermediate_size=64, vq_e_dim=32, vq_n_e=5)
    a = init_weights(build_model(tcfg), torch.Generator().manual_seed(1)).state_dict()
    b = init_weights(build_model(tcfg), torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    cb = a["vector_quantizer.codebook"]
    assert cb.abs().max() <= 1.0 / 5
    assert torch.equal(a["encoder.layer_0.mlp.layer_norm.scale"], torch.ones(32))


ENTRY_POINT_MODULES = (
    "cli", "train.engine", "train.run", "train.freezing", "train.optim", "train.step",
    "ops.adam", "ops.ce", "ops.head_ce", "data.generate", "data.prepare", "data.dataset", "utils.consts",
    "utils.console", "utils.params", "utils.tensor", "ckpt.checkpoint",
)


def test_package_imports_no_jax_and_builds_nothing():
    """Every module of the port (the training entry point's among them)
    imports without jax/flax/optax, the JAX package, nvcc or triton, and
    importing builds no kernel; so does ``chip_smoke.py``."""
    code = (
        "import pkgutil, sys, importlib, runpy\n"
        "import kindergarten_vq_vae_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'triton', 'kindergarten_vq_vae_tpu')]\n"
        "assert not bad, bad\n"
        "from kindergarten_vq_vae_torch import _build\n"
        "assert _build._lib is None\n"
        "print(' '.join(names))\n"
    )
    env = {**os.environ, "PATH": "/usr/bin:/bin"}  # no nvcc on the path
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert {f"kindergarten_vq_vae_torch.{m}" for m in ENTRY_POINT_MODULES} <= walked


@pytest.mark.parametrize("override", [
    {"vq_mode": "GumbelQuantizer"}, {"decoder_model_name": "gpt2"}, {"model_name": "shelgon2"},
])
def test_unported_configs_name_their_roadmap_item(override):
    """The Gumbel quantizer, Shelgon2 and the GPT-2 decoder, ported since,
    load the JAX package's initial weights strictly."""
    base = dict(model_name="shelgon3", vocab_size=40, hidden_size=32, num_layers=1, num_heads=2,
                intermediate_size=64, vq_e_dim=32, enc_out_size=32, word_embedding_size=32,
                vq_n_e=5, compute_dtype="float32")
    tcfg = TorchRunConfig(**{**base, **override})
    jcfg = RunConfig.from_flat_dict(tcfg.get_config())
    tree = jax.tree_util.tree_map(np.asarray, init_params(jcfg, jax.random.key(0)))
    build_model(tcfg).load_state_dict(params_from_jax(tree), strict=True)
