"""The port's freezing masks vs the JAX package's, and a frozen step.

``trainable_mask`` over the port's parameter names equals the JAX mask over
the Flax tree, key by key (exact: both are booleans), for the four modes
and both settings of ``cross_attn_make_trainable``, on a tiny Shelgon3-VQ
(the codebook is outside the encoder and decoder) and on a tiny Bagon with
untied embeddings. One ``vq-ft`` training step on the CPU leaves every
frozen leaf bit-identical and moves the codebook; the optimizer holds
moments for the trainable leaves only.
"""

import jax
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.train.config import ModelConfig, RunConfig
from kindergarten_vq_vae_tpu.train.freezing import trainable_mask as jax_trainable_mask
from kindergarten_vq_vae_tpu.train.variants import init_params
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax
from kindergarten_vq_vae_torch.config import RunConfig as TorchRunConfig
from kindergarten_vq_vae_torch.models import build_model
from kindergarten_vq_vae_torch.train.freezing import trainable_mask
from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step
from kindergarten_vq_vae_torch.utils.consts import SUPPORTED_MODEL_MODES

TINY = dict(vocab_size=40, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            compute_dtype="float32", vq_e_dim=32, enc_out_size=32, vq_n_e=5)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, v


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, tied in (("shelgon3", True), ("bagon", False)):
        cfg = RunConfig(model=ModelConfig(model_name=name, tie_word_embeddings=tied, **TINY))
        out[name] = (jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.key(0))), tied)
    return out


@pytest.mark.parametrize("cross", [True, False])
@pytest.mark.parametrize("mode", SUPPORTED_MODEL_MODES)
@pytest.mark.parametrize("model_name", ["shelgon3", "bagon"])
def test_mask_equals_jax(trees, model_name, mode, cross):
    params, tied = trees[model_name]
    want = dict(_flat(jax_trainable_mask(params, mode, cross_attn_trainable=cross,
                                         tie_word_embeddings=tied)))
    got = trainable_mask(list(params_from_jax(params)), mode, cross_attn_trainable=cross,
                         tie_word_embeddings=tied)
    assert got == {k: bool(v) for k, v in want.items()}


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="Invalid model mode"):
        trainable_mask(["encoder.pooler.kernel"], "half")


def test_vq_ft_step_leaves_frozen_leaves_untouched(trees):
    params, _ = trees["shelgon3"]
    tcfg = TorchRunConfig(model_name="shelgon3", model_mode="vq-ft", lr=1e-2, **TINY)
    model = build_model(tcfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = init_train_state(tcfg, model)
    assert [n for n, _ in state.trainable()] == ["vector_quantizer.codebook"]
    assert len(state.opt_state.mu) == 1
    step = make_train_step(tcfg, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 40, (4, 12)))
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids, dtype=torch.int32),
             "n_valid": 4}
    state, _ = step(state, batch)
    for n, p in model.named_parameters():
        if n == "vector_quantizer.codebook":
            assert not torch.equal(p, before[n])
        else:
            assert torch.equal(p, before[n]), n
