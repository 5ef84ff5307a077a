"""The port's training entry point (Engine, run directory, CLI) vs the JAX package's.

A tiny Shelgon3-VQ (2 + 2 layers, H 32, 2 heads, F 64, vocab 128, 4 codes,
f32) on a small generated corpus (2 verbs, 2 objects), batch 16, 2 epochs
with 6 train and 8 val batches each.

- Parity: the JAX ``Engine`` and the port's ``Engine`` start from the same
  parameters (JAX ``init_params``, carried over by the bridge), with dropout
  0 so that the shuffled batch order (the same numpy permutation on both
  sides) is the only randomness. Once with ``fused_update="auto"`` (JAX: the
  optax chain; the port: kernel #14's plain version) and once with ``"on"``
  and ``model_mode="vq-ft"`` (JAX: ``FusedAdam``'s single-expression path).
  Each epoch's train and val ``loss_recon``, ``loss_vq`` and
  ``metric_perp`` agree to rel 1e-4 (measured: 2e-7). The two sides'
  gradients differ in the last f32 bits (f32 sums in another order), and
  AMSGrad turns an element whose gradient is rounding noise into a step of
  up to lr = 1e-3 with a sign neither side determines
  (``tests/test_torch_train.py`` measured 0.48 * lr); over these 12 steps
  that moves the epoch means far less than 1e-4, which leaves a factor 500
  for other CPUs' rounding. ``metric_acc`` is a share of tokens in percent:
  one argmax flipped by such noise among the 1,152 tokens of a train epoch
  moves it by 0.087, so it is held within 0.1 percent points (measured:
  5e-6).
- A best-val slot written by the port reads back through JAX's
  ``restore_checkpoint`` (with the JAX parameter tree as its template) with
  the port's final parameters, exactly.
- Resume: a run saved after epoch 1 and continued by a fresh ``Engine``
  (dropout 0.1, decoder perturbation, the EMA codebook and dead-code
  revival all on) gives the uninterrupted run's history exactly, timings
  aside.
- ``wandb_watch_histograms``: the per-leaf 64-bin histograms equal the JAX
  engine's ``_stacked_hists`` on the same tensors exactly (the same f32
  arithmetic), and an epoch logs one value and one gradient histogram per
  leaf.
- The CLI trains in a subprocess with ``--device cpu`` and writes
  ``run_conf.json``, ``history.json`` with the test stats, the best slots
  and the decoded sentences; the port's ``Reconstructor`` serves that run
  directory and agrees with the JAX package's ``Reconstructor`` on it.
- A ``fused_head_ce="store"`` CLI run (in process) has the history of the
  same run on the logits path at the parity bars above, and its run
  directory is served through the logits path.
- ``_prefetch`` (the engine's depth-2 host-to-device double buffer, which
  every run above goes through) yields every batch once, in order, with
  each batch's put issued one batch ahead of the consumer, and drains the
  queue at the end; at depth 1 it puts each batch just before its step.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ckpt.checkpoint import restore_checkpoint
from kindergarten_vq_vae_tpu.data.dataset import DSentences as JaxDSentences
from kindergarten_vq_vae_tpu.serve.reconstructor import Reconstructor as JaxReconstructor
from kindergarten_vq_vae_tpu.train.config import RunConfig as JaxRunConfig
from kindergarten_vq_vae_tpu.train.engine import Engine as JaxEngine
from kindergarten_vq_vae_tpu.train.engine import _stacked_hists as jax_stacked_hists
from kindergarten_vq_vae_tpu.train.variants import init_params
from kindergarten_vq_vae_torch import cli
from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name
from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.data.dataset import DSentences, split_dataset
from kindergarten_vq_vae_torch.data.generate import generate_dsentences
from kindergarten_vq_vae_torch.data.prepare import prepare_all
from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor
from kindergarten_vq_vae_torch.train.engine import Engine, stacked_hists

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model_name="shelgon3", vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, compute_dtype="float32", vq_e_dim=32, enc_out_size=32,
            vq_n_e=4, hidden_dropout=0.0, attention_dropout=0.0, batch_size=16,
            tokenized_sentence_max_length=12, lim_batches_train_pct=0.07,
            lim_batches_val_pct=0.3, lim_batches_test_pct=0.3, lr=1e-3, n_epochs=2,
            n_epochs_to_decode_after=100, export_checkpoint=False)
STATS = ("loss_recon", "loss_vq", "metric_perp")
REL, ACC_ABS = 1e-4, 0.1
TIMING = ("sentences_per_sec", "stage_wall_s")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    generate_dsentences(d, num_verbs=2, num_objects=2)
    art = prepare_all(d, max_length=12)
    cols = dict(input_ids=art["input_ids"], attention_mask=art["attention_mask"],
                labels=art["latent_classes_labels_clean"],
                one_hot=art["latent_classes_one_hot_clean"], sentences=art["sentences_clean"])
    return d, cols


def _splits(cols, cls=DSentences):
    names = ("train", "val", "test")
    return dict(zip(names, split_dataset(cls(**cols))))


def _cfg(**kw) -> RunConfig:
    return RunConfig(**{**TINY, **kw})


def _flat_jax(cfg: RunConfig) -> JaxRunConfig:
    return JaxRunConfig.from_flat_dict(cfg.get_config())


@pytest.mark.parametrize("over", [dict(fused_update="auto"),
                                  dict(fused_update="on", model_mode="vq-ft")])
def test_epochs_match_jax_engine(corpus, over):
    _, cols = corpus
    cfg = _cfg(**over)
    jcfg = _flat_jax(cfg)
    params = jax.tree_util.tree_map(np.asarray, init_params(jcfg, jax.random.key(0)))
    jhist = JaxEngine(jcfg, _splits(cols, JaxDSentences), params=params).fit(console_print=False)
    thist = Engine(cfg, _splits(cols), params=params, device="cpu").fit(console_print=False)
    assert [h["epoch"] for h in thist] == [h["epoch"] for h in jhist] == [1, 2]
    for th, jh in zip(thist, jhist):
        for stage in ("train", "val"):
            assert th[stage]["n_els"] == jh[stage]["n_els"]
            for k in STATS:
                np.testing.assert_allclose(th[stage][k], jh[stage][k], rtol=REL,
                                           err_msg=f"epoch {th['epoch']} {stage} {k}")
            assert abs(th[stage]["metric_acc"] - jh[stage]["metric_acc"]) <= ACC_ABS
    if over.get("model_mode") == "vq-ft":  # frozen encoder and decoder: only the codebook moved
        assert thist[0]["train"]["loss_vq"] != thist[1]["train"]["loss_vq"]


def test_best_val_slot_reads_back_in_jax(corpus, tmp_path):
    _, cols = corpus
    cfg = _cfg(export_checkpoint=True, ckpt_every_n_epochs=0, ckpt_slots=("loss_recon:val",))
    params = jax.tree_util.tree_map(np.asarray, init_params(_flat_jax(cfg), jax.random.key(0)))
    eng = Engine(cfg, _splits(cols), run_path=str(tmp_path), params=params, device="cpu")
    eng.fit(console_print=False)
    assert sorted(os.listdir(tmp_path)) == [best_ckpt_name("shelgon3", "loss_recon", "val")]
    got = restore_checkpoint(str(tmp_path / best_ckpt_name("shelgon3", "loss_recon", "val")),
                             template=params)
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    state = eng.model.state_dict()
    assert len(flat) == len(state)
    for path, leaf in flat:
        name = ".".join(p.key for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), state[name].numpy(), err_msg=name)


def _history_without_timing(history):
    return [{k: ({s: v for s, v in stats.items() if s not in TIMING} if isinstance(stats, dict)
                 else stats) for k, stats in h.items()} for h in history]


def test_resumed_run_equals_uninterrupted_run(corpus, tmp_path):
    _, cols = corpus
    cfg = _cfg(hidden_dropout=0.1, attention_dropout=0.1, decoder_perturb_train_pct=0.1,
               vq_ema_update=True, vq_dead_code_threshold=2, weight_decay=0.01,
               resume_save_every_n_epochs=1, seed=5)
    whole = Engine(cfg, _splits(cols), run_path=str(tmp_path / "whole"), device="cpu")
    want = whole.fit(console_print=False)

    first = Engine(dataclasses.replace(cfg, n_epochs=1), _splits(cols),
                   run_path=str(tmp_path / "killed"), device="cpu")
    first.fit(console_print=False)
    resumed = Engine(cfg, _splits(cols), run_path=str(tmp_path / "killed"), device="cpu")
    assert resumed.restore_resume() == 2
    got = resumed.fit(console_print=False)
    assert _history_without_timing(got) == _history_without_timing(want)
    assert resumed.state.step == whole.state.step
    for (n, a), b in zip(resumed.model.state_dict().items(), whole.model.state_dict().values()):
        assert torch.equal(a, b), n


def test_cli_run_dir_served_by_reconstructor(corpus, tmp_path):
    data_dir, _ = corpus
    sets = {**TINY, "export_checkpoint": True, "data_dir": data_dir, "runs_dir": str(tmp_path),
            "n_epochs_to_decode_after": 1, "lim_batches_test_pct": 0.1}
    argv = [sys.executable, "-m", "kindergarten_vq_vae_torch.cli", "shelgon3", "--device", "cpu"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"]
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (run_id,) = os.listdir(tmp_path)
    run = tmp_path / run_id
    conf = json.loads((run / "run_conf.json").read_text())
    assert conf["run_id"] == run_id and conf["n_params"]["encoder"]["n_params"] > 0
    assert RunConfig.from_flat_dict(conf) == RunConfig(**sets)
    history = json.loads((run / "history.json").read_text())
    assert [sorted(h) for h in history] == [["epoch", "train", "val"]] * 2 + [["epoch", "test"]]
    assert np.isfinite(history[-1]["test"]["loss_recon"])
    assert (run / best_ckpt_name("shelgon3", "loss_recon", "val") / "manifest.json").exists()
    assert any(n.startswith("decoded_sentences") for n in os.listdir(run))
    assert "001 | train" in out.stdout and "002 | val" in out.stdout

    sentences = ["i eat the apple", "she will not be eating the apples", "do we eat the apple"]
    got = Reconstructor(str(run), device="cpu").reconstruct(sentences)
    want = JaxReconstructor(str(run)).reconstruct(sentences)
    assert [r["input"] for r in got] == sentences
    for g, w in zip(got, want):
        assert g["codes"] == w["codes"] and g["reconstruction"] == w["reconstruction"]
        assert 0.0 <= g["token_acc"] <= 1.0


def test_cli_fused_head_store_run(corpus, tmp_path):
    """A ``fused_head_ce="store"`` run through the CLI (in process, the plain
    versions on the CPU) trains, runs val and test and writes a run directory
    with the history of the same run on the logits path (``"auto"``, from the
    same seeded weights and batch order) at the parity bars above; its run
    directory is served through the logits path, as the default run's is."""
    data_dir, _ = corpus
    runs = {}
    for mode in ("auto", "store"):
        sets = {**TINY, "n_epochs": 1, "export_checkpoint": True, "data_dir": data_dir,
                "runs_dir": str(tmp_path / mode), "fused_head_ce": mode, "decode_dump": False,
                "lim_batches_test_pct": 0.1}
        argv = ["shelgon3", "--device", "cpu"]
        for k, v in sets.items():
            argv += ["--set", f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"]
        engine = cli.main(argv)
        assert engine._fused_head == (mode == "store")
        runs[mode] = engine.run_path
    hist = {m: json.loads(open(os.path.join(r, "history.json")).read()) for m, r in runs.items()}
    assert [sorted(h) for h in hist["store"]] == [["epoch", "train", "val"], ["epoch", "test"]]
    for got, want in zip(hist["store"], hist["auto"]):
        for stage in set(got) - {"epoch"}:
            for k in STATS:
                np.testing.assert_allclose(got[stage][k], want[stage][k], rtol=REL,
                                           err_msg=f"{stage} {k}")
            assert abs(got[stage]["metric_acc"] - want[stage]["metric_acc"]) <= ACC_ABS
    conf = json.loads(open(os.path.join(runs["store"], "run_conf.json")).read())
    assert conf["fused_head_ce"] == "store"
    sentences = ["i eat the apple", "do we eat the apple"]
    got = Reconstructor(runs["store"], device="cpu")
    want = Reconstructor(runs["auto"], device="cpu").reconstruct(sentences)
    assert not got.model.decoder.mlm_head.cfg.fused_head
    for g, w in zip(got.reconstruct(sentences), want):
        assert g["codes"] == w["codes"] and g["reconstruction"] == w["reconstruction"]


class _FakeWandb:
    def __init__(self):
        self.logged = []

    def log(self, d):
        self.logged.append(d)


def test_watch_histograms_match_jax(corpus):
    rng = np.random.default_rng(4)
    leaves = {"w": rng.normal(size=(40, 24)).astype(np.float32),
              "b": rng.uniform(-3, 7, 300).astype(np.float32),
              "const": np.full((5,), 0.25, np.float32)}
    names, counts, ranges = jax_stacked_hists(leaves)
    got_c, got_r = stacked_hists([torch.from_numpy(leaves[n]) for n in names])
    np.testing.assert_array_equal(got_c, np.asarray(counts))
    np.testing.assert_array_equal(got_r, np.asarray(ranges))

    _, cols = corpus
    fake = _FakeWandb()
    eng = Engine(_cfg(n_epochs=1, wandb_watch_model=True, wandb_watch_histograms=True),
                 _splits(cols), device="cpu")
    eng.fit(wandb_run=fake, console_print=False)
    train_log = fake.logged[0]
    names = [n for n, _ in eng.model.named_parameters()]
    assert train_log["train/grad_norm"] > 0
    for name in names:
        for key in (f"gradients/{name}", f"parameters/{name}"):
            h = train_log[key]
            assert len(h["values"]) == 64 and len(h["bins"]) == 65, key
            assert sum(h["values"]) == dict(eng.model.named_parameters())[name].numel()


@pytest.mark.parametrize("depth, n", [(2, 5), (2, 1), (2, 0), (1, 3), (3, 4)])
def test_prefetch_order_depth_and_drain(depth, n):
    from kindergarten_vq_vae_torch.train.engine import _prefetch

    log = []

    def put(b):
        log.append(("put", b))
        return b * 10

    for batch, dev in _prefetch(iter(range(n)), put, depth):
        log.append(("step", batch, dev))
    assert [e[1] for e in log if e[0] == "step"] == list(range(n))
    assert all(dev == b * 10 for _, b, dev in (e for e in log if e[0] == "step"))
    for i in range(n):  # batch i's step comes after the puts of batches up to i + depth - 1
        at = log.index(("step", i, i * 10))
        assert {b for kind, b, *_ in log[:at] if kind == "put"} == set(range(min(n, i + depth)))
