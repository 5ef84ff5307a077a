"""The port's flagship pipeline and run tools, on the CPU.

- ``scripts/flagship_quality_torch.py --tiny --cpu`` end to end in a fresh
  interpreter, with the flags, JSON keys and bounds with which
  ``tests/test_flagship_pipeline.py`` runs ``scripts/flagship_quality.py``:
  Bagon, k-means codebook init, Shelgon3-VQ vq-ft and a decoder-adaptation
  stage on a tiny generated corpus.
- The stage-2 gates on forced diagnostics: ``separation_ratio < 0.1``
  exits 3 and ``amplitude_ratio < 2^-7`` exits 4, each after writing the
  summary so far, and stage 3 runs only when neither fires.
- A tiny f32 Shelgon3-VQ run directory trained by the port's CLI is
  evaluated by ``scripts/eval_run.py --cpu`` (the JAX package) and
  ``scripts/eval_run_torch.py --cpu``: the same keys, every stat within
  1e-4 relative (f32 forwards in another order; measured 1.7e-7), timings
  aside, and the same test-split count; ``scripts/check_checkpoint_torch.py`` rebuilds and runs it.
"""

import json
import os
import subprocess
import sys

import pytest

from kindergarten_vq_vae_torch import cli
from kindergarten_vq_vae_torch.data.generate import generate_dsentences
from kindergarten_vq_vae_torch.train import flagship

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_REL = 1e-4
TIMING = ("sentences_per_sec", "stage_wall_s")


def _script(name: str, *args: str, timeout: int = 600) -> subprocess.CompletedProcess:
    res = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", name), *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, (f"{name} rc={res.returncode}\nstdout tail:\n{res.stdout[-2000:]}"
                                 f"\nstderr tail:\n{res.stderr[-2000:]}")
    return res


def test_flagship_pipeline_tiny_cpu(tmp_path):
    out, runs, data_dir = tmp_path / "flagship.json", tmp_path / "runs", tmp_path / "data"
    generate_dsentences(str(data_dir), num_verbs=1, num_objects=1)
    _script("flagship_quality_torch.py", "--tiny", "--cpu", "--bagon-epochs", "1",
            "--vq-epochs", "1", "--lim-batches", "0.5", "--dec-perturb", "0.5",
            "--stage4-epochs", "1", "--runs-dir", str(runs), "--data-dir", str(data_dir),
            "--out", str(out))
    summary = json.loads(out.read_text())
    assert set(summary) == {"bagon", "codebook_init", "shelgon3_vq_ft", "shelgon3_stage4"}

    # stage 1: the lean pipeline's intermediate stages report their last val sweep
    assert summary["bagon"]["eval_stage"] == "val"
    bagon = summary["bagon"]["val_stats"]
    assert 0.0 <= bagon["metric_acc"] <= 100.0
    assert bagon["loss_recon"] > 0.0

    # stage 2: the codebook artifact and the collapse diagnostics; a barely
    # trained encoder is far from collapsed, so neither gate fired
    diag = summary["codebook_init"]
    assert os.path.exists(diag["path"])
    assert diag["separation_ratio"] >= 0.1
    assert diag["amplitude_ratio"] >= 2.0 ** -7

    # stage 3: vq-ft on the warm start and the k-means init
    vq = summary["shelgon3_vq_ft"]["val_stats"]
    assert 0.0 <= vq["metric_acc"] <= 100.0
    assert 1.0 <= vq["metric_perp"] <= 9.0

    # stage 4: decoder adaptation continued the stage-3 checkpoint
    s4 = summary["shelgon3_stage4"]
    assert s4["mode"] == "full"
    assert 0.0 <= s4["test_stats"]["metric_acc"] <= 100.0
    assert 1.0 <= s4["test_stats"]["metric_perp"] <= 9.0
    assert vq["loss_vq"] >= 0.0


HEALTHY = {"separation_ratio": 1.0, "amplitude_ratio": 0.5, "centroid_dist_min": 1.0,
           "encoder_per_element_std": 0.5, "encoder_per_element_rms": 1.0}


@pytest.mark.parametrize("forced, code", [
    ({"separation_ratio": 0.0999}, 3),
    ({"amplitude_ratio": 2.0 ** -7 * 0.99}, 4),
    ({"separation_ratio": 0.05, "amplitude_ratio": 1e-3}, 3),  # the separation gate first
    ({"separation_ratio": 0.1, "amplitude_ratio": 2.0 ** -7}, None),  # both at their floor
])
def test_stage2_gates(monkeypatch, tmp_path, forced, code):
    calls = []
    monkeypatch.setattr(flagship, "stage1", lambda args, summary: str(tmp_path))

    def stage2(args, bagon_dir, summary):
        diag = {**HEALTHY, **forced}
        summary["codebook_init"] = {"path": "cb.npy", "wall_s": 0.0, **diag}
        return diag

    monkeypatch.setattr(flagship, "stage2", stage2)
    monkeypatch.setattr(flagship, "stage3", lambda args, bagon_dir, summary: calls.append(3))
    monkeypatch.setattr(flagship, "stage4", lambda args, vq_dir, summary: calls.append(4))
    out = tmp_path / "summary.json"
    argv = ["--cpu", "--out", str(out)]
    if code is None:
        flagship.main(argv)
        assert calls == [3, 4]
    else:
        with pytest.raises(SystemExit) as exc:
            flagship.main(argv)
        assert exc.value.code == code and calls == []
    assert json.loads(out.read_text())["codebook_init"]["path"] == "cb.npy"


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny f32 Shelgon3-VQ run trained for one epoch by the port's CLI on the CPU."""
    root = tmp_path_factory.mktemp("run")
    data_dir, runs = str(root / "data"), str(root / "runs")
    generate_dsentences(data_dir, num_verbs=1, num_objects=1)
    sets = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                compute_dtype="float32", vq_e_dim=32, enc_out_size=32, vq_n_e=4, batch_size=32,
                tokenized_sentence_max_length=12, n_epochs=1, lim_batches_train_pct=0.2,
                lr=1e-3, data_dir=data_dir, runs_dir=runs)
    argv = ["shelgon3", "--device", "cpu"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"]
    return cli.main(argv).run_path


def test_eval_run_twins_agree(run_dir):
    want = json.loads(_script("eval_run.py", run_dir, "--cpu").stdout.strip().splitlines()[-1])
    got = json.loads(_script("eval_run_torch.py", run_dir, "--cpu").stdout.strip().splitlines()[-1])
    assert set(got) == set(want)
    with open(os.path.join(run_dir, "run_conf.json")) as f:
        conf = json.load(f)
    assert got["n_els"] == want["n_els"] > 0
    assert all(v == v for v in got.values())  # no NaN
    for k, v in want.items():
        if k not in TIMING:
            assert abs(got[k] - v) <= EVAL_REL * max(abs(v), 1e-12), (k, got[k], v)
    assert conf["model_name"] == "shelgon3"


def test_check_checkpoint_torch_passes(run_dir, capsys):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import check_checkpoint_torch
    finally:
        sys.path.pop(0)
    recons = check_checkpoint_torch.main([run_dir, "--cpu"])
    assert len(recons) == 3 and all(isinstance(r, str) for r in recons)
    assert "checkpoint OK: shelgon3, logits (3, 12, 128)" in capsys.readouterr().out
