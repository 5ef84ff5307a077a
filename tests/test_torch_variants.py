"""The port's Shelgon, Shelgon2 and Shelgon3-Gumbel vs the JAX package's.

On the CPU in f32, at a tiny size (2 + 2 layers, H 64, 4 heads, F 128,
vocab 523, S 12, 9 codes), with the JAX package's initial weights carried
across by ``ckpt/bridge.py`` and loaded with ``strict=True``.

The Gumbel noise cannot be redrawn in torch, so each side draws the same
arrays (``test_torch_gumbel.NoiseFeed``, reset before each forward or step:
one array per draw in the modules' order, Shelgon2's eight factors apart).

- the forwards (deterministic), with and without the hooks (Shelgon's
  ``override_latent_classes``, Shelgon2's ``overrides``), Shelgon with
  both masks None, Shelgon3-Gumbel in training (soft, straight-through)
  and in eval (hard): every float output to rel 1e-5 of its largest, ids
  and labels exactly;
- one step of ``make_train_step`` per variant against
  ``jax.value_and_grad(make_loss_fn(cfg, "train"))`` and the optax chain,
  under ``tests/test_torch_train.py``'s criteria: stats to rel 1e-5, ids
  exactly, every gradient leaf within 1e-4 of its leaf's largest, every
  parameter after the step within 2e-2 * lr outside the elements whose
  gradient is rounding noise. Shelgon's ``proj_in_conv_bias`` adds the same
  value to every label of a class, which the softmax over the labels and
  the loss do not see: its exact gradient is 0, so on both sides it is
  held below 1e-6 of the largest gradient of the step, and the update may
  move it anywhere within the optimizer's reach (``ZERO_GRAD``);
- ``kl_onehot_loss`` with its gradient, and ``replace_pct_rand_columns_with``
  given JAX's draws;
- the archived sentence discretizer's forward (no model uses it);
- ``init_weights``' distributions for the new leaves against JAX's
  initialisers;
- a CPU CLI run of each variant (run directory, history, best slot), and a
  Shelgon2 run served by ``Reconstructor`` against the JAX package's.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kindergarten_vq_vae_tpu.models.archive_sentence_discretizer import (
    ArchiveSentenceDiscretizer as JaxArchive,
)
from kindergarten_vq_vae_tpu.serve.reconstructor import Reconstructor as JaxReconstructor
from kindergarten_vq_vae_tpu.train.config import RunConfig as JaxRunConfig
from kindergarten_vq_vae_tpu.train.losses import kl_onehot_loss as jax_kl_onehot
from kindergarten_vq_vae_tpu.train.optim import make_optimizer
from kindergarten_vq_vae_tpu.train.variants import build_model as jax_build_model
from kindergarten_vq_vae_tpu.train.variants import init_params
from kindergarten_vq_vae_tpu.train.variants import make_loss_fn as jax_make_loss_fn
from kindergarten_vq_vae_tpu.utils.tensor import replace_pct_rand_columns as jax_replace_cols
from kindergarten_vq_vae_torch import cli
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax
from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name
from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.data.generate import generate_dsentences
from kindergarten_vq_vae_torch.data.prepare import prepare_all
from kindergarten_vq_vae_torch.models import build_model, init_weights
from kindergarten_vq_vae_torch.models.archive_sentence_discretizer import (
    ArchiveSentenceDiscretizer,
)
from kindergarten_vq_vae_torch.models.shelgon2 import FACTOR_NAMES
from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor
from kindergarten_vq_vae_torch.train.losses import kl_onehot_loss
from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step
from kindergarten_vq_vae_torch.train.variants import STAT_KEYS
from kindergarten_vq_vae_torch.utils.tensor import (
    replace_pct_rand_columns,
    replace_pct_rand_columns_with,
)
from test_torch_gumbel import NoiseFeed

B, S, V, N_VALID = 6, 12, 523, 4
LR = 1e-3
BASE = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            compute_dtype="float32", vq_e_dim=64, enc_out_size=64, emb_size=64,
            word_embedding_size=64, vq_n_e=9, batch_size=B, tokenized_sentence_max_length=S,
            lr=LR, weight_decay=0.01)
VARIANTS = {
    "shelgon": dict(model_name="shelgon"),
    "shelgon-masks-off": dict(model_name="shelgon", use_mask_encoder=False,
                              use_mask_decoder=False),
    "shelgon2": dict(model_name="shelgon2", mask_pct_train=0.1),
    "shelgon3-gumbel": dict(model_name="shelgon3", vq_mode="GumbelQuantizer"),
    "shelgon3-gumbel-straight-through": dict(model_name="shelgon3", vq_mode="GumbelQuantizer",
                                             vq_straight_through=True),
}
FWD_REL = 1e-5
ZERO_GRAD = ("proj_in_conv_bias",)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, np.asarray(v)


@functools.lru_cache(maxsize=None)
def _jax_init(variant: str):
    cfg = RunConfig(**{**BASE, **VARIANTS[variant]})
    jcfg = JaxRunConfig.from_flat_dict(cfg.get_config())
    return cfg, jcfg, jax.tree_util.tree_map(np.asarray, init_params(jcfg, jax.random.key(0)))


def _setup(variant: str):
    """(port cfg, JAX cfg, JAX initial params, port model with them loaded strictly)."""
    cfg, jcfg, params = _jax_init(variant)
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    return cfg, jcfg, params, model


def _batch(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, S + 1, B)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.integers(1, V, (B, S)) * mask).astype(np.int32)
    labels, labels8 = rng.integers(0, 3, (B, 5)), rng.integers(0, 3, (B, 8))
    eye = np.eye(3, dtype=np.int32)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels.astype(np.int32),
            "one_hot": eye[labels], "labels8": labels8.astype(np.int32), "one_hot8": eye[labels8]}


def _overrides(name: str, seed=1):
    """Shelgon's (B, 5, 3) latent classes, or Shelgon2's overrides of two factors."""
    rng = np.random.default_rng(seed)

    def soft(*shape):
        x = np.exp(rng.normal(size=shape))
        return (x / x.sum(-1, keepdims=True)).astype(np.float32)

    if name == "shelgon":
        return soft(B, 5, 3)
    return {FACTOR_NAMES[1]: soft(B, 3), FACTOR_NAMES[6]: soft(B, 3)}


FORWARD_CASES = [
    ("shelgon", False, True), ("shelgon", True, True), ("shelgon-masks-off", False, True),
    ("shelgon2", False, True), ("shelgon2", True, True), ("shelgon3-gumbel", False, True),
    ("shelgon3-gumbel-straight-through", False, True), ("shelgon3-gumbel", False, False),
]


@pytest.mark.parametrize("variant, hook, is_training", FORWARD_CASES,
                         ids=[f"{v}{'-hook' if h else ''}{'' if t else '-eval'}"
                              for v, h, t in FORWARD_CASES])
def test_forward_matches_jax(monkeypatch, variant, hook, is_training):
    cfg, jcfg, params, model = _setup(variant)
    feed = NoiseFeed(monkeypatch)
    name = cfg.model_name
    batch = _batch()
    ids, mask = batch["input_ids"], batch["attention_mask"]
    jmodel = jax_build_model(jcfg)
    kw = dict(deterministic=True, rngs={"gumbel": jax.random.key(5)})
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    if name == "shelgon":
        masks = (mask, mask) if cfg.use_mask_encoder else (None, None)
        tmasks = (tmask, tmask) if cfg.use_mask_encoder else (None, None)
        over = _overrides(name) if hook else None
        want = jmodel.apply({"params": params}, ids, masks[0], ids, masks[1],
                            override_latent_classes=over, **kw)
        got = model(tids, tmasks[0], tids, tmasks[1],
                    override_latent_classes=None if over is None else torch.from_numpy(over))
        floats, exact = ("logits", "pred_latent_logits", "pred_latent_classes", "conditioning"), ()
    elif name == "shelgon2":
        over = _overrides(name) if hook else None
        want = jmodel.apply({"params": params}, ids, mask, overrides=over, **kw)
        got = model(tids, tmask, overrides=None if over is None else
                    {k: torch.from_numpy(v) for k, v in over.items()})
        floats = ("logits", "gen_factors_logits", "discretized_sentence", "encoder_pooler_output")
        exact = ("gen_factors_labels",)
        assert feed.calls == {"jax": 8 - 2 * hook, "torch": 8 - 2 * hook}
    else:
        want = jmodel.apply({"params": params}, ids, mask, is_training=is_training, **kw)
        got = model(tids, tmask, is_training=is_training)
        floats, exact = ("logits", "z_q", "vq_loss", "perplexity"), ("min_encoding_indices",)
        assert want["ema_stats"] is None and got["ema_stats"] is None
    for k in floats:
        assert got[k].dtype == torch.float32
        assert _rel(got[k].detach().numpy(), want[k]) <= FWD_REL, k
    for k in exact:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert feed.calls["jax"] == feed.calls["torch"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_steps_match_jax(monkeypatch, variant, n_steps=1):
    cfg, jcfg, params, model = _setup(variant)
    feed = NoiseFeed(monkeypatch)
    name = cfg.model_name
    state = init_train_state(cfg, model)
    step = make_train_step(cfg, "cpu", torch.Generator().manual_seed(0), deterministic=True)
    assert state.ema is None and state.dead_steps is None
    grad_fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(jcfg, "train"), has_aux=True),
                      static_argnums=3)
    tx = make_optimizer(jcfg.optim)
    opt_state = tx.init(params)
    rngs = {k: jax.random.key(1) for k in ("dropout", "gumbel", "perturb")}
    batch = _batch()
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items()}, "n_valid": jnp.int32(N_VALID)}
    tbatch = {**{k: torch.from_numpy(v).long() for k, v in batch.items()}, "n_valid": N_VALID}
    exact = {"shelgon3": "min_encoding_indices", "shelgon2": "gen_factors_labels"}.get(name)
    noisy = {}
    for _ in range(n_steps):
        feed.reset()
        (_, jaux), grads = grad_fn(params, jbatch, rngs, True)
        state, aux = step(state, tbatch)
        for k in STAT_KEYS[name]:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_array_equal(aux["recon_ids"].numpy(), np.asarray(jaux["recon_ids"]))
        if exact:
            np.testing.assert_array_equal(aux[exact].numpy(), np.asarray(jaux[exact]))
        assert "ema_counts" not in aux and "ema_counts" not in jaux
        tgrads = {n: p.grad for n, p in model.named_parameters()}
        jgrads = dict(_flat(jax.device_get(grads)))
        top = max(np.abs(g).max() for g in jgrads.values())
        for leaf, g in jgrads.items():
            got = np.zeros_like(g) if tgrads[leaf] is None else tgrads[leaf].numpy()
            if leaf in ZERO_GRAD:
                assert max(np.abs(got).max(), np.abs(g).max()) <= 1e-6 * top, leaf
                noisy[leaf] = np.ones(g.shape, bool)
                continue
            assert _rel(got, g) <= 1e-4, leaf
            noisy[leaf] = noisy.get(leaf, False) | (np.abs(g) <= 1e-6 * np.abs(g).max())
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    tparams = dict(model.named_parameters())
    for leaf, want in _flat(jax.device_get(params)):
        diff = np.abs(tparams[leaf].detach().numpy() - want)
        assert np.where(noisy[leaf], 0.0, diff).max() <= 2e-2 * LR, leaf


def test_archive_sentence_discretizer_matches_jax(monkeypatch):
    """The archived discretizer (no model uses it) on the JAX module's initial
    weights, both sides fed the same noise: every output to rel 1e-5."""
    feed = NoiseFeed(monkeypatch)
    jmod = JaxArchive(word_embedding_size=64, sentence_length=S)
    x = np.random.default_rng(4).normal(size=(B, 64)).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init({"params": jax.random.key(0), "gumbel": jax.random.key(1)},
                              jnp.asarray(x))["params"])
    feed.reset()
    want = jmod.apply({"params": params}, jnp.asarray(x), rngs={"gumbel": jax.random.key(2)})
    model = ArchiveSentenceDiscretizer(64, S)
    model.load_state_dict(params_from_jax(params), strict=True)
    got = model(torch.from_numpy(x))
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape and _rel(g.detach().numpy(), w) <= FWD_REL
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert feed.calls == {"jax": 1, "torch": 1}


@pytest.mark.parametrize("rows", [3, 8])
def test_kl_onehot_loss_matches_jax(rows):
    rng = np.random.default_rng(rows)
    logits = rng.normal(size=(B, rows, 3)).astype(np.float32)
    one_hot = np.eye(3, dtype=np.int32)[rng.integers(0, 3, (B, rows))]
    valid = (np.arange(B) < N_VALID).astype(np.float32)
    want, jgrad = jax.value_and_grad(jax_kl_onehot)(jnp.asarray(logits), jnp.asarray(one_hot),
                                                   jnp.asarray(valid))
    x = torch.from_numpy(logits).requires_grad_()
    got = kl_onehot_loss(x, torch.from_numpy(one_hot), torch.from_numpy(valid))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert _rel(x.grad.numpy(), jgrad) <= 1e-6
    assert not x.grad[N_VALID:].any()


@pytest.mark.parametrize("pct, axis", [(0.25, 1), (0.5, 1), (0.5, 0), (1.0, 1)])
def test_replace_pct_rand_columns_matches_jax_given_its_draws(pct, axis):
    ids = np.random.default_rng(0).integers(1, 50, (6, 12)).astype(np.int32)
    key = jax.random.key(3)
    want = np.asarray(jax_replace_cols(key, jnp.asarray(ids), pct, 0, 50, axis))
    k_perm, k_noise = jax.random.split(key)
    ranks = np.array(jax.random.permutation(k_perm, ids.shape[axis]))
    noise = np.array(jax.random.randint(k_noise, ids.shape, 0, 50, dtype=jnp.int32))
    got = replace_pct_rand_columns_with(torch.from_numpy(ids), pct, torch.from_numpy(ranks),
                                        torch.from_numpy(noise), axis)
    np.testing.assert_array_equal(got.numpy(), want)
    # the generator form: exactly floor(pct * dim) whole columns change
    zeros = torch.zeros(6, 12, dtype=torch.int64)  # noise from [1, 9) never equals 0
    out = replace_pct_rand_columns(zeros, pct, 1, 9, torch.Generator().manual_seed(5), axis)
    changed = (out != 0).all(dim=1 - axis)
    assert int(changed.sum()) == int(zeros.shape[axis] * pct)
    assert int((out != 0).sum()) == int(changed.sum()) * zeros.shape[1 - axis]
    assert replace_pct_rand_columns(zeros, 0.0, 1, 9, torch.Generator()) is zeros


@pytest.mark.parametrize("variant", ["shelgon", "shelgon2", "shelgon3-gumbel"])
def test_init_weights_follows_jax_initialisers(variant):
    cfg, _, params, _ = _setup(variant)
    got = dict(init_weights(build_model(cfg), torch.Generator().manual_seed(1)).named_parameters())
    new = [(k, v) for k, v in _flat(params) if not k.startswith(("encoder.", "decoder."))]
    assert new
    for leaf, want in new:
        t = got[leaf].detach().numpy()
        if leaf.endswith("bias"):
            assert not t.any() and not want.any(), leaf
        else:  # normal(0.02): kernels, the conv kernels and the Gumbel codebook
            assert 0.7 < t.std() / want.std() < 1.4 and 0.01 < t.std() < 0.03, leaf
            assert abs(t.mean()) < 3 * 0.02 / np.sqrt(t.size), leaf


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    generate_dsentences(d, num_verbs=2, num_objects=2)
    prepare_all(d, max_length=S)
    return d


CLI = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
           compute_dtype="float32", vq_e_dim=32, enc_out_size=32, emb_size=32,
           word_embedding_size=32, vq_n_e=4, batch_size=16, tokenized_sentence_max_length=S,
           lim_batches_train_pct=0.04, lim_batches_val_pct=0.1, lim_batches_test_pct=0.1,
           n_epochs=1, n_epochs_to_decode_after=100, ckpt_slots=("loss_recon:val",))


@pytest.mark.parametrize("model_name, over", [
    ("shelgon", {"encoder_perturb_train_pct": 0.2, "decoder_perturb_train_pct": 0.2}),
    ("shelgon2", {"mask_pct_train": 0.1}), ("shelgon3", {"vq_mode": "GumbelQuantizer"}),
])
def test_cli_runs_on_cpu(corpus, tmp_path, model_name, over):
    sets = {**CLI, **over, "data_dir": corpus, "runs_dir": str(tmp_path)}
    argv = [model_name, "--device", "cpu"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"]
    engine = cli.main(argv)
    run = engine.run_path
    history = json.loads(open(os.path.join(run, "history.json")).read())
    assert [sorted(h) for h in history] == [["epoch", "train", "val"], ["epoch", "test"]]
    for stats in (history[0]["train"], history[0]["val"], history[1]["test"]):
        assert all(np.isfinite(stats[k]) for k in STAT_KEYS[model_name])
    assert os.path.exists(os.path.join(run, best_ckpt_name(model_name, "loss_recon", "val")))
    assert RunConfig.load(os.path.join(run, "run_conf.json")).model_name == model_name
    if model_name != "shelgon2":
        return
    sentences = ["i eat the apple", "she will not be eating the apples", "do we eat the apple"]
    with pytest.MonkeyPatch.context() as mp:
        NoiseFeed(mp, per_shape=True)
        got = Reconstructor(run, device="cpu").reconstruct(sentences)
        want = JaxReconstructor(run).reconstruct(sentences)
    assert [r["input"] for r in got] == sentences
    for g, w in zip(got, want):
        assert g["reconstruction"] == w["reconstruction"] and "codes" not in g
        assert g["token_acc"] == pytest.approx(w["token_acc"])
    latents = Reconstructor(run, device="cpu").encode(sentences)
    assert latents.shape == (3, 32) and np.isfinite(latents).all()
