"""The port's quality-parity harness (``scripts/parity_harness_torch.py``) on
the CPU: the port's f32 Bagon (plain versions) and HF's ``BertModel`` +
``BertLMHeadModel`` built from config, trained on the same batches of the
harness's corpus (3,110 train / 1,036 val sentences, vocabulary 59), for one
epoch (two take ~65 s on one thread); the port's validation token accuracy
may be no more than 0.02 below HF's, the bar of ``scripts/parity_harness.py``
(measured at one epoch: 0.9958 against 0.9986). The corpus is the JAX
harness's: the same sentences, split and token ids
(``tests/test_torch_data.py`` holds the data modules to the JAX package's
bit for bit)."""

import importlib.util
import os

import pytest

os.environ.setdefault("USE_TF", "0")  # transformers would import TensorFlow for its torch models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _harness():
    spec = importlib.util.spec_from_file_location(
        "parity_harness_torch", os.path.join(ROOT, "scripts", "parity_harness_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_bagon_holds_the_parity_bar_against_hf(tmp_path):
    """On one thread: these tiny products gain nothing from more, and the
    test workers share the machine's cores (~38 s on an 8-core CPU)."""
    import torch

    pytest.importorskip("transformers")
    h = _harness()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = h.main(["--device", "cpu", "--epochs", "1", "--json-out", str(tmp_path / "r.json")])
    finally:
        torch.set_num_threads(threads)
    assert out["device"] == "cpu" and out["epochs"] == 1
    assert 0.9 < out["torch_val_token_acc"] <= 1.0
    assert out["ours_val_token_acc"] >= out["torch_val_token_acc"] - h.ACC_GAP
    assert os.path.exists(tmp_path / "r.json")
