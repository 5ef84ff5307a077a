"""The port's training engine on a device mesh of two gloo CPU processes.

The twin of ``tests/test_mesh_engine_e2e.py``: a tiny f32 Shelgon3-VQ on a
small generated corpus (2 verbs, 2 objects), batch 16. One spawn of two
ranks (``kindergarten_vq_vae_torch.parallel.dryrun.launch``, 60 s
process-group timeout; the workers import neither jax nor the tests) runs:

- two epochs on the ``(2,)`` dp mesh with dropout 0, so that the shuffled
  batch order is the only randomness: each epoch's train and val losses
  and perplexity track this process's one-process engine within rtol 2e-3
  (``test_mesh_engine_e2e.py`` l.130-141), with the same element counts;
  the test stage then reloads the best-val slot that rank 0 wrote; the
  gradient histograms are on (every rank recomputes, rank 0 logs);
- on the ``(1, 2)`` tp mesh, with dropout 0.1, decoder perturbation, the
  EMA codebook and dead-code revival on: an uninterrupted two-epoch run and
  a run stopped after epoch one and resumed by a fresh engine give the same
  history (rtol 1e-6) and the same parameters; the resume bundle holds whole
  optimizer moments, the format of an unmeshed run;
- rank 1 writes no file: its ``open`` for writing, ``os.replace``,
  ``os.makedirs`` and ``shutil.rmtree`` are recorded and must stay unused.

Beside it: ``dryrun_multichip(2)`` and ``(4)`` (JAX's meshes ``(2,)`` and
``(2, 2)``; the ``(2, 1, 2)`` step is in ``tests/test_torch_parallel.py``),
a rank that fails or hangs ending the whole run, and a CUDA mesh refused
without NCCL.
"""

import json
import os

import numpy as np
import pytest
import torch

from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name, read_checkpoint
from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.data.generate import generate_dsentences
from kindergarten_vq_vae_torch.data.prepare import prepare_all
from kindergarten_vq_vae_torch.parallel.dryrun import dryrun_multichip, launch
from kindergarten_vq_vae_torch.parallel.mesh import init_distributed
from kindergarten_vq_vae_torch.train.engine import Engine
from kindergarten_vq_vae_torch.train.run import load_data

TINY = dict(model_name="shelgon3", vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, compute_dtype="float32", vq_e_dim=32, enc_out_size=32,
            vq_n_e=4, hidden_dropout=0.0, attention_dropout=0.0, batch_size=16,
            tokenized_sentence_max_length=12, lim_batches_train_pct=0.05,
            lim_batches_val_pct=0.1, lim_batches_test_pct=0.1, lr=1e-3, n_epochs=2,
            n_epochs_to_decode_after=100, export_checkpoint=True, generate_if_missing=False)
RESUME = dict(hidden_dropout=0.1, attention_dropout=0.1, decoder_perturb_train_pct=0.1,
              vq_ema_update=True, vq_dead_code_threshold=2, resume_save_every_n_epochs=1,
              seed=5, mesh_shape=(1, 2), mesh_axis_names=("dp", "tp"))
STATS = ("loss_full", "loss_recon", "loss_vq", "metric_perp")

WORKER = r'''
import builtins, dataclasses, json, os, shutil, sys
import torch

torch.set_num_threads(1)
from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.parallel.mesh import init_distributed
from kindergarten_vq_vae_torch.train.engine import Engine
from kindergarten_vq_vae_torch.train.run import load_data

d = sys.argv[1]
dp_conf, resume_conf = json.loads(sys.argv[2]), json.loads(sys.argv[3])
rank, _ = init_distributed(backend="gloo", device="cpu", timeout=60.0)
writes = []
if rank != 0:
    def spy(fn, is_write=lambda *a, **k: True):
        def wrapped(*a, **k):
            if is_write(*a, **k):
                writes.append(f"{fn.__name__}{a[:1]}")
            return fn(*a, **k)
        return wrapped

    builtins.open = spy(builtins.open, lambda f, mode="r", *a, **k: any(c in mode for c in "wax+"))
    os.replace, os.makedirs, shutil.rmtree = (spy(os.replace), spy(os.makedirs),
                                              spy(shutil.rmtree))
out = {}
cfg = RunConfig(**{**dp_conf, "mesh_shape": tuple(dp_conf["mesh_shape"]),
                   "mesh_axis_names": tuple(dp_conf["mesh_axis_names"])})
splits, tok = load_data(cfg)
eng = Engine(cfg, splits, tok, run_path=os.path.join(d, "dp"), device="cpu")
out["dp"] = eng.fit(console_print=False)
out["dp_test"] = eng.test(console_print=False)


class Run:  # a wandb run's log, on rank 0
    logs = []

    def log(self, d):
        self.logs.append(d)


last = [h["train"] for h in eng.history if "train" in h][-1]
eng._log_epoch(cfg.n_epochs, "train", last, {}, Run() if rank == 0 else None, False)
out["hists"] = {k: [sum(v["values"]), len(v["bins"])] for log in Run.logs for k, v in log.items()
                if k.startswith(("gradients/", "parameters/"))}
out["numels"] = {n: p.numel() for n, p in eng.model.named_parameters()}

cfg = RunConfig(**{**resume_conf, "mesh_shape": tuple(resume_conf["mesh_shape"]),
                   "mesh_axis_names": tuple(resume_conf["mesh_axis_names"])})
whole = Engine(cfg, splits, tok, run_path=os.path.join(d, "whole"), device="cpu")
out["whole"] = whole.fit(console_print=False)
first = Engine(dataclasses.replace(cfg, n_epochs=1), splits, tok,
               run_path=os.path.join(d, "killed"), device="cpu")
first.fit(console_print=False)
resumed = Engine(cfg, splits, tok, run_path=os.path.join(d, "killed"), device="cpu")
out["resumed_start"] = resumed.restore_resume()
out["resumed"] = resumed.fit(console_print=False)
out["same_params"] = all(torch.equal(a, b) for a, b in zip(
    resumed.model.state_dict().values(), whole.model.state_dict().values()))

# the entry point as torchrun starts it: rank 0 makes the run directory
from kindergarten_vq_vae_torch import cli

cli.main(["shelgon3", "--device", "cpu", "--config", os.path.join(d, "cli_conf.json")])
out["writes"] = writes
print(json.dumps(out, default=float))
'''


def _conf(**over) -> dict:
    return {**TINY, **over}


def _plain(history, keys=STATS):
    return [{stage: [h[stage][k] for k in keys] + [h[stage]["n_els"]] for stage in ("train", "val")}
            for h in history if "train" in h]


@pytest.fixture(scope="module")
def mesh_engine(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_engine")
    data = str(d / "data")
    generate_dsentences(data, num_verbs=2, num_objects=2)
    prepare_all(data, max_length=12)
    for sub in ("dp", "whole", "killed"):
        os.makedirs(d / sub)
    dp_conf = _conf(data_dir=data, mesh_shape=[2], mesh_axis_names=["dp"],
                    wandb_watch_histograms=True)
    resume_conf = _conf(data_dir=data, **{**RESUME, "mesh_shape": [1, 2],
                                          "mesh_axis_names": ["dp", "tp"]})
    RunConfig(**_conf(data_dir=data, runs_dir=str(d / "runs"), mesh_shape=(2,),
                      mesh_axis_names=("dp",), n_epochs=1, decode_dump=True,
                      n_epochs_to_decode_after=1)).save(str(d / "cli_conf.json"))
    os.makedirs(d / "runs")
    outs = launch(2, ["-c", WORKER, str(d), json.dumps(dp_conf), json.dumps(resume_conf)],
                  timeout=240.0)
    rank0, rank1 = (json.loads(o.strip().splitlines()[-1]) for o in outs)
    return d, data, rank0, rank1


def test_dp_engine_tracks_one_process_engine(mesh_engine):
    d, data, rank0, rank1 = mesh_engine
    cfg = RunConfig(**_conf(data_dir=data))
    splits, tok = load_data(cfg)
    flat = Engine(cfg, splits, tok, device="cpu").fit(console_print=False)
    got, want = _plain(rank0["dp"]), _plain(flat)
    assert [list(h) for h in got] == [["train", "val"]] * 2
    for g, w in zip(got, want):
        for stage in g:
            assert g[stage][-1] == w[stage][-1]  # the same element counts
            np.testing.assert_allclose(g[stage][:-1], w[stage][:-1], rtol=2e-3, err_msg=stage)
    assert _plain(rank1["dp"]) == got  # every rank holds the global stats
    assert np.isfinite(rank0["dp_test"]["loss_full"])
    assert os.path.isdir(d / "dp" / best_ckpt_name("shelgon3", "loss_recon", "val"))


def test_dp_engine_logs_histograms_from_rank_zero(mesh_engine):
    """``wandb_watch_histograms`` under the mesh: every rank recomputes the
    gradients at each train epoch's log (a rank left out would hang the
    reduction), and rank 0 logs a 64-bin histogram of each leaf's values and
    gradient."""
    _, _, rank0, rank1 = mesh_engine
    assert rank1["hists"] == {}
    want = {f"{kind}/{n}": [k, 65] for n, k in rank0["numels"].items()
            for kind in ("gradients", "parameters")}
    assert rank0["hists"] == want


def test_tp_resumed_run_equals_uninterrupted(mesh_engine):
    d, _, rank0, _ = mesh_engine
    assert rank0["resumed_start"] == 2
    got, want = _plain(rank0["resumed"]), _plain(rank0["whole"])
    for g, w in zip(got, want):
        for stage in g:
            np.testing.assert_allclose(g[stage], w[stage], rtol=1e-6, err_msg=stage)
    assert rank0["same_params"]
    # whole moments, as an unmeshed run writes them
    tree = read_checkpoint(str(d / "killed" / "resume_state"))
    for key in ("mu", "nu", "nu_max"):
        assert np.shape(tree["opt_state"][key]["encoder.layer_0.self_attn.qkv.kernel"]) == (32, 96)
    assert np.shape(tree["params"]["encoder"]["embeddings"]["word_embeddings"]["embedding"]) == (
        128, 32)


def test_only_rank_zero_writes(mesh_engine):
    d, _, rank0, rank1 = mesh_engine
    assert rank1["writes"] == []
    assert sorted(os.listdir(d / "killed")) == sorted(
        os.listdir(d / "whole")) and "resume_meta.json" in os.listdir(d / "killed")


def test_cli_under_a_mesh_writes_one_run(mesh_engine):
    """``cli.main`` on both ranks: one run directory (rank 0's, broadcast),
    its ``run_conf.json``, ``history.json`` with the test stats and the
    decode dump of the global batches."""
    d, _, _, _ = mesh_engine
    (run,) = os.listdir(d / "runs")
    files = set(os.listdir(d / "runs" / run))
    assert {"run_conf.json", "history.json"} <= files
    with open(d / "runs" / run / "history.json") as f:
        hist = json.load(f)
    assert [sorted(h) for h in hist] == [["epoch", "train", "val"], ["epoch", "test"]]
    dump = [f for f in files if f.startswith("decoded_sentences")]
    assert len(dump) == 1
    if dump[0].endswith(".jsonl"):
        with open(d / "runs" / run / dump[0]) as f:
            rows = [json.loads(line) for line in f]
        n = sum(h[s]["n_els"] for h in hist for s in ("train", "val", "test") if s in h)
        assert len(rows) == n


@pytest.mark.parametrize("n, mesh", [(2, "{'dp': 2}"), (4, "{'dp': 2, 'tp': 2}")])
def test_dryrun_multichip(n, mesh, capsys):
    """The twin of ``__graft_entry__.dryrun_multichip``: JAX's mesh for n."""
    line = dryrun_multichip(n, timeout=120.0)
    assert line.startswith(f"dryrun_multichip({n}): mesh={mesh} loss=") and line.endswith(" OK")
    assert np.isfinite(float(line.split("loss=")[1].split()[0]))


def test_a_failing_or_hanging_rank_ends_the_run():
    with pytest.raises(RuntimeError, match=r"rank 1 of 3 failed \(exit 7\)"):
        launch(3, ["-c", "import os, sys, time\n"
                         "if os.environ['RANK'] == '1': sys.exit(7)\n"
                         "time.sleep(60)"], timeout=30.0)
    with pytest.raises(RuntimeError, match="timed out"):
        launch(2, ["-c", "import time; time.sleep(60)"], timeout=1.0)


def test_a_cuda_mesh_needs_nccl():
    if torch.distributed.is_nccl_available() and torch.cuda.is_available():
        pytest.skip("this build has NCCL and a card")
    with pytest.raises(RuntimeError, match="nccl"):
        init_distributed(device="cuda")
    assert not torch.distributed.is_initialized()
