"""The port's training step vs the JAX package's, on the CPU, in f32.

A tiny Shelgon3-VQ (2 + 2 layers, H 64, 4 heads, F 128, vocab 523, S 12,
9 codes) with the JAX package's initial weights carried across by
``ckpt/bridge.py``, ``deterministic=True`` (dropout off on both sides: the
layer-level tests hold the hash dropout bit for bit), a batch with padded
rows and ``n_valid < B``. Three steps of ``make_train_step`` are held
against ``jax.value_and_grad(make_loss_fn(cfg, "train"))`` plus the optax
chain of ``make_optimizer`` (weight decay and a MultiStepLR milestone on),
each side carrying its own parameters:

- the scalar stats to rel 1e-5 (f32 sums in another order);
- ``recon_ids`` and the VQ codes exactly;
- every gradient leaf to max|port - jax| / max|jax| <= 1e-4 (the layer
  tests' criterion; after a step the two sides' parameters already differ
  in the last bits);
- every parameter after step 3 to max|port - jax| <= 2e-2 * lr. A step
  moves a parameter by up to lr whatever the gradient's size, so an element
  whose gradient is 1e-3 of its leaf's largest carries the 1e-4 gradient
  criterion as a relative error of ~1e-1 into its moments: measured, the
  worst such step differs by 6.3e-3 * lr. Elements whose gradient is
  rounding noise in both frameworks (|g| <= 1e-6 of the leaf's largest at
  some step; the key-projection bias, whose exact gradient is 0) are set
  aside: AMSGrad turns noise into steps of up to lr with a sign that
  neither framework determines (measured: 0.48 * lr).

The step's update is the single-pass AMSGrad of ``fused_update="auto"``
(kernel #14's plain version on the CPU). The optax-form optimizer alone is
held against the optax chain over 5 steps at rel 1e-6. Bagon runs one step
under the same criteria, and Shelgon3 three more with
``fused_head_ce="flash"`` (the fused head + CE on both sides). With
``fused_layer="off"`` on both sides, Shelgon3 three steps and Bagon one run
through the per-module trunk, once with ``fused_attn="on"`` (JAX: the Pallas
SDPA kernels in interpret mode; the port: #11 / #12's plain versions) and
once with ``"off"`` (the einsum route on both sides), under the same
criteria. The last test lists what the step still refuses, each with its
ROADMAP item, and takes one step of each variant ported since.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kindergarten_vq_vae_tpu.train.config import DataConfig, ModelConfig, OptimConfig, RunConfig
from kindergarten_vq_vae_tpu.train.optim import make_optimizer
from kindergarten_vq_vae_tpu.train.variants import init_params, make_loss_fn
from kindergarten_vq_vae_tpu.utils import metrics as jm
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax
from kindergarten_vq_vae_torch.config import RunConfig as TorchRunConfig
from kindergarten_vq_vae_torch.models import build_model, init_weights
from kindergarten_vq_vae_torch.train.optim import Adam
from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step
from kindergarten_vq_vae_torch.utils.metrics import (
    padding_tokens_pct,
    perplexity_from_counts,
    seq_acc,
)

B, S, V, N_VALID = 6, 12, 523, 4
OPTIM = OptimConfig(lr=1e-3, weight_decay=0.01, lr_scheduler="MultiStepLR", milestones=(2,),
                    gamma=0.5)


def _cfg(model_name, fused_head_ce="auto", fused_layer="auto", fused_attn="auto"):
    return RunConfig(
        model=ModelConfig(model_name=model_name, vocab_size=V, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128, compute_dtype="float32",
                          vq_e_dim=64, enc_out_size=64, vq_n_e=9, fused_head_ce=fused_head_ce,
                          head_ce_block_r=64, head_ce_block_v=256, fused_layer=fused_layer,
                          fused_attn=fused_attn, sdpa_block_b=4),
        data=DataConfig(batch_size=B, tokenized_sentence_max_length=S), optim=OPTIM)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, S + 1, B)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.integers(1, V, (B, S)) * mask).astype(np.int32)
    return ids, mask


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, np.asarray(v)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _run(model_name, n_steps, fused_head_ce="auto", fused_layer="auto", fused_attn="auto"):
    cfg = _cfg(model_name, fused_head_ce, fused_layer, fused_attn)
    params = init_params(cfg, jax.random.key(0))
    tcfg = TorchRunConfig.from_flat_dict(cfg.get_config())
    model = build_model(tcfg, fused_head=fused_head_ce != "auto")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    state = init_train_state(tcfg, model)
    step = make_train_step(tcfg, "cpu", torch.Generator().manual_seed(0), deterministic=True)

    grad_fn = jax.jit(jax.value_and_grad(make_loss_fn(cfg, "train"), has_aux=True),
                      static_argnums=3)
    tx = make_optimizer(cfg.optim)
    opt_state = tx.init(params)
    rngs = {k: jax.random.key(1) for k in ("dropout", "gumbel", "perturb")}
    ids, mask = _batch()
    jbatch = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask),
              "n_valid": jnp.int32(N_VALID)}
    tbatch = {"input_ids": torch.from_numpy(ids).long(), "attention_mask": torch.from_numpy(mask),
              "n_valid": N_VALID}
    noisy = {}
    for _ in range(n_steps):
        (_, jaux), grads = grad_fn(params, jbatch, rngs, True)
        state, aux = step(state, tbatch)
        keys = ["loss_recon", "loss_full", "metric_acc", "padding_tokens_pct"]
        if model_name == "shelgon3":
            keys += ["loss_vq", "metric_perp"]
            np.testing.assert_array_equal(aux["min_encoding_indices"].numpy(),
                                          np.asarray(jaux["min_encoding_indices"]))
        for k in keys:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_array_equal(aux["recon_ids"].numpy(), np.asarray(jaux["recon_ids"]))
        tgrads = {n: p.grad for n, p in model.named_parameters()}
        for name, g in _flat(jax.device_get(grads)):
            got = np.zeros_like(g) if tgrads[name] is None else tgrads[name].numpy()
            assert _rel(got, g) <= 1e-4, name
            noisy[name] = noisy.get(name, False) | (np.abs(g) <= 1e-6 * np.abs(g).max())
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    tparams = dict(model.named_parameters())
    for name, want in _flat(jax.device_get(params)):
        diff = np.abs(tparams[name].detach().numpy() - want)
        assert np.where(noisy[name], 0.0, diff).max() <= 2e-2 * OPTIM.lr, name


def test_shelgon3_train_steps_match_jax():
    _run("shelgon3", 3)


def test_shelgon3_fused_head_flash_train_steps_match_jax():
    """The same three steps with ``fused_head_ce="flash"`` on both sides: the
    fused head + CE (JAX: Pallas #9/#10 in interpret mode; the port: their
    plain versions) in place of the logits path."""
    _run("shelgon3", 3, "flash")


def test_bagon_train_step_matches_jax():
    _run("bagon", 1)


@pytest.mark.parametrize("fused_attn", ["on", "off"])
def test_shelgon3_unfused_train_steps_match_jax(fused_attn):
    _run("shelgon3", 3, fused_layer="off", fused_attn=fused_attn)


@pytest.mark.parametrize("fused_attn", ["on", "off"])
def test_bagon_unfused_train_step_matches_jax(fused_attn):
    _run("bagon", 1, fused_layer="off", fused_attn=fused_attn)


def test_optimizer_matches_optax_chain():
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = {f"p{i}": rng.normal(size=s).astype(np.float32) for i, s in enumerate(shapes)}
    tx = make_optimizer(OPTIM)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    tcfg = TorchRunConfig(lr=OPTIM.lr, weight_decay=OPTIM.weight_decay,
                          lr_scheduler=OPTIM.lr_scheduler, milestones=OPTIM.milestones,
                          gamma=OPTIM.gamma)
    opt = Adam(tcfg)
    tp = [torch.from_numpy(params[k].copy()) for k in sorted(params)]
    ts = opt.init(tp)
    for _ in range(5):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, [torch.from_numpy(grads[k]) for k in sorted(params)], ts)
    for k, t in zip(sorted(params), tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=0)
    assert ts.count == 5


def test_metrics_match_jax():
    ids, _ = _batch(1)
    recon = ids.copy()
    recon[0, :3] += 1
    got, want = seq_acc(torch.from_numpy(recon), torch.from_numpy(ids)), jm.seq_acc(
        jnp.asarray(recon), jnp.asarray(ids))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(float(padding_tokens_pct(torch.from_numpy(ids))),
                               float(jm.padding_tokens_pct(jnp.asarray(ids))), rtol=1e-6)
    counts = np.array([5.0, 0.0, 3.0, 1.0], np.float32)
    np.testing.assert_allclose(float(perplexity_from_counts(torch.from_numpy(counts), 9)),
                               float(jm.perplexity_from_counts(jnp.asarray(counts), 9)), rtol=1e-6)


@pytest.mark.parametrize("override, item", [
    ({"model_name": "shelgon"}, None), ({"model_name": "shelgon2"}, None),
    ({"vq_mode": "GumbelQuantizer"}, None),
    # the id it had while the GPT-2 decoder was refused under that ROADMAP item
    pytest.param({"decoder_model_name": "gpt2"}, None, id="override3-other variants"),
    ({"mesh_shape": (2,)}, "multi-device"),
])
def test_step_refuses_what_is_not_ported(override, item):
    """A mesh raises, naming its ROADMAP item; the variants and the GPT-2
    decoder, ported since (``item`` None), take a step with finite stats."""
    tcfg = TorchRunConfig(**{**dict(model_name="shelgon3", vocab_size=40, hidden_size=32,
                                    num_layers=1, num_heads=2, intermediate_size=64, vq_e_dim=32,
                                    emb_size=32, word_embedding_size=32, vq_n_e=5,
                                    compute_dtype="float32"), **override})
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            make_train_step(tcfg, "cpu", torch.Generator())
        return
    step = make_train_step(tcfg, "cpu", torch.Generator().manual_seed(0))
    model = init_weights(build_model(tcfg), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    labels, labels8 = rng.integers(0, 3, (B, 5)), rng.integers(0, 3, (B, 8))
    batch = {"input_ids": torch.from_numpy(rng.integers(1, 40, (B, S))),
             "attention_mask": torch.ones(B, S, dtype=torch.int32), "n_valid": B,
             "labels": torch.from_numpy(labels), "one_hot": torch.eye(3)[labels],
             "labels8": torch.from_numpy(labels8), "one_hot8": torch.eye(3)[labels8]}
    state, aux = step(init_train_state(tcfg, model), batch)
    assert state.step == 1 and torch.isfinite(aux["loss_full"])
