"""The port's serving export, reference bundle and profiling helpers, on the CPU.

Tiny runs (2 + 2 layers, H 32, 2 heads, F 64, vocab 64, 5 codes, seq 12,
f32, seeded weights) written by the port:

- ``serve/export.py``: for every model the reconstructor serves (Bagon,
  Shelgon, Shelgon2, Shelgon3-VQ, Shelgon3-Gumbel, Bagon with the GPT-2
  decoder, a ``fused_layer="off"`` Shelgon3-VQ run), the exported program
  holds the ``kvq::`` ops of its path (``layer_fwd`` #1, ``vq_fwd`` #5,
  ``sdpa_fwd`` #11) and no parameter, and its ids and codes equal the live
  forward's bit for bit (the live forward is held against JAX in
  ``tests/test_torch_serve.py``), through ``load_exported`` and through
  ``Reconstructor(artifact=)``; a mismatched run, bucket or device raises
  with "exported for"; ``_main --check`` checks an artifact and
  ``http_server --artifact`` serves one;
- ``ckpt/export_torch.py``: ``export_reference_bundle`` equal to JAX's,
  array for array and bit for bit, on the same parameters (the port's
  seeded weights as JAX's tree through ``ckpt/bridge.py``), for every variant and both quantizers; the bundle
  loads with ``strict=True`` into HF ``BertModel`` / ``BertLMHeadModel``
  built from a config, and the HF encoder's forward is within 1e-5 of the
  port's; a GPT-2 run is refused as JAX refuses it;
- ``utils/profiling.py``: ``StepTimer.summary`` equal to JAX's on the same
  durations, ``benchmark_fn``'s warm-up and steps, ``trace``'s Chrome trace.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ckpt import export_torch as jax_export_torch
from kindergarten_vq_vae_tpu.train.config import RunConfig as JaxRunConfig
from kindergarten_vq_vae_tpu.train.variants import build_model as jax_build_model
from kindergarten_vq_vae_tpu.utils import profiling as jax_profiling
from kindergarten_vq_vae_torch.ckpt import export_torch
from kindergarten_vq_vae_torch.ckpt.bridge import params_to_jax
from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name, write_checkpoint
from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.data.tokenizer import WordTokenizer
from kindergarten_vq_vae_torch.models import build_model, init_weights
from kindergarten_vq_vae_torch.serve import export
from kindergarten_vq_vae_torch.serve.http_server import make_server
from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor
from kindergarten_vq_vae_torch.utils import profiling

os.environ.setdefault("USE_TF", "0")  # the HF models here are torch's: skip TensorFlow

WORDS = "i you he she we they eat buy fix the a apple mango car house red big".split()
SENTENCES = ["i eat the apple", "he will buy a big red car", "we fix the house", "she",
             "they eat a mango", "you buy the red house"]
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            compute_dtype="float32", emb_size=32, word_embedding_size=32, vq_e_dim=32,
            enc_out_size=32, vq_n_e=5, tokenized_sentence_max_length=12)
GPT2 = dict(decoder_model_name="gpt2", decoder_vocab_size=300)
# (run name, model, config changes, the kvq ops its program holds)
RUNS = {
    "bagon": ("bagon", {}, {"layer_fwd"}),
    "shelgon": ("shelgon", {}, {"layer_fwd"}),
    "shelgon2": ("shelgon2", {}, {"layer_fwd"}),
    "shelgon3": ("shelgon3", {}, {"layer_fwd", "vq_fwd"}),
    "shelgon3_gumbel": ("shelgon3", {"vq_mode": "GumbelQuantizer"}, {"layer_fwd"}),
    "bagon_gpt2": ("bagon", GPT2, {"layer_fwd"}),
    "shelgon3_off": ("shelgon3", {"fused_layer": "off"}, {"vq_fwd", "sdpa_fwd"}),
}
BUCKET = 8
HIDDEN_ABS = 1e-5


def _write_run(root: str, name: str, model_name: str, over: dict) -> str:
    data_dir, run = os.path.join(root, "data"), os.path.join(root, name)
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(run)
    cfg = RunConfig(model_name=model_name, data_dir=data_dir, **{**TINY, **over})
    cfg.save(os.path.join(run, "run_conf.json"))
    WordTokenizer(WORDS).save(os.path.join(data_dir, cfg.tokenizer_file))
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(7))
    write_checkpoint(os.path.join(run, best_ckpt_name(model_name, "loss_recon", "val")),
                     params_to_jax(model))
    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_export"))
    return {name: _write_run(root, name, model, over) for name, (model, over, _) in RUNS.items()}


@pytest.fixture(scope="module")
def artifacts(runs, tmp_path_factory):
    """Each run exported on the CPU at bucket 8, lazily."""
    root = tmp_path_factory.mktemp("artifacts")
    made = {}

    def get(name):
        if name not in made:
            made[name] = export.export_reconstructor(runs[name], bucket=BUCKET,
                                                     out_path=str(root / name), device="cpu")
        return made[name]

    return get


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(1, len(WORDS) + 4, (BUCKET, 12)).astype(np.int32))
    mask = torch.ones_like(ids)
    mask[1, 7:] = 0
    mask[5, 3:] = 0
    return ids, mask


def _launches():
    from kindergarten_vq_vae_torch.ops.layer import fused_bert_layer
    from kindergarten_vq_vae_torch.ops.sdpa import sdpa_forward
    from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel

    return (fused_bert_layer.launches, sdpa_forward.launches, vector_quantize_kernel.launches)


@pytest.mark.parametrize("name", list(RUNS))
def test_artifact_matches_the_live_forward(runs, artifacts, name):
    model_name, over, ops = RUNS[name]
    before = _launches()
    out, meta = artifacts(name)
    assert _launches() == before  # the trace launched nothing
    assert meta == {"model_name": model_name, "seq_len": 12, "bucket": BUCKET, "device": "cpu",
                    "ckpt_name": None, "compute_dtype": "float32",
                    "gumbel_noise": meta["gumbel_noise"]}
    draws = {"shelgon": 1, "shelgon2": 8, "shelgon3_gumbel": 1}.get(name, 0)
    assert len(meta["gumbel_noise"]) == draws
    with open(out + ".json") as f:
        assert json.load(f) == meta

    live = Reconstructor(runs[name], batch_buckets=(BUCKET,), device="cpu")
    served = Reconstructor(runs[name], device="cpu", artifact=out)
    assert served.buckets == (BUCKET,)
    prog = served.exported.program
    targets = {str(n.target) for n in prog.graph.nodes if n.op == "call_function"}
    assert {t.split(".")[1] for t in targets if t.startswith("kvq.")} == ops
    # no parameter in the artifact: no state, no example inputs, at most scalar constants
    assert not prog.state_dict and prog.example_inputs is None
    assert all(t.numel() <= 1 for t in prog.constants.values())
    ids, mask = _batch()
    with torch.inference_mode():
        want = live.forward(ids, mask)
        got = served.forward(ids, mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if draws:  # the noise inputs, the program's last ones, each feed the graph
        inputs = [n for n in prog.graph.nodes if n.op == "placeholder"]
        assert all(n.users for n in inputs[-draws:])
    if name == "shelgon3":  # a request larger than the bucket is cut into chunks
        many = SENTENCES * 3
        assert served.reconstruct(many) == live.reconstruct(many)
        assert served.codes(many) == live.codes(many)


def test_artifact_refuses_another_run_bucket_or_device(runs, artifacts):
    out, _ = artifacts("bagon")
    with pytest.raises(ValueError, match="exported for"):
        Reconstructor(runs["shelgon3"], device="cpu", artifact=out)
    with pytest.raises(ValueError, match="exported for cpu"):
        export.load_exported(out, device="cuda")
    call, _ = export.load_exported(out, device="cpu")
    params = {k: v.detach() for k, v in
              Reconstructor(runs["bagon"], device="cpu").model.state_dict().items()}
    ids, mask = _batch()
    with pytest.raises(ValueError, match="exported for"):
        call(params, ids[:4], mask[:4])


def test_export_main_and_http_serve_an_artifact(runs, tmp_path, capsys):
    out = str(tmp_path / "art")
    export._main([runs["shelgon3"], "--bucket", "4", "--device", "cpu", "--out", out, "--check"])
    assert "check OK" in capsys.readouterr().out
    live = Reconstructor(runs["shelgon3"], device="cpu")
    server = make_server([runs["shelgon3"], "--artifact", out, "--device", "cpu", "--port", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/reconstruct",
            data=json.dumps({"sentences": SENTENCES}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            results = json.loads(resp.read())["results"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert results == live.reconstruct(SENTENCES)


# ---------------------------------------------------------------- reference bundle

BUNDLE_CASES = [("bagon", {}), ("shelgon", {}), ("shelgon2", {}), ("shelgon3", {}),
                ("shelgon3", {"vq_mode": "GumbelQuantizer"})]


def _same_weights(model_name: str, over: dict, seed: int = 3):
    """(cfg, port model, JAX cfg, the model's parameters as JAX's tree)."""
    cfg = RunConfig(model_name=model_name, **{**TINY, "vocab_size": 128, **over})
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(seed))
    return cfg, model.eval(), JaxRunConfig.from_flat_dict(cfg.get_config()), params_to_jax(model)


def _hf_models():
    import transformers

    kw = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=64, max_position_embeddings=512)
    return (transformers.BertModel(transformers.BertConfig(**kw)).eval(),
            transformers.BertLMHeadModel(transformers.BertConfig(
                **kw, is_decoder=True, add_cross_attention=True)).eval())


@pytest.mark.parametrize("model_name, over", BUNDLE_CASES)
def test_reference_bundle_equals_jax_and_loads_into_hf(model_name, over, tmp_path):
    pytest.importorskip("transformers")
    cfg, model, jcfg, params = _same_weights(model_name, over)
    got = export_torch.export_reference_bundle(cfg, model)
    want = jax_export_torch.export_reference_bundle(jcfg, jax_build_model(jcfg, "test"), params)
    assert got.keys() == want.keys()
    for top in want:
        assert got[top].keys() == want[top].keys(), top
        for k, w in want[top].items():
            g = got[top][k]
            assert g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w)), k

    enc, dec = _hf_models()
    to_t = {top: {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in sd.items()}
            for top, sd in got.items()}
    enc.load_state_dict(to_t["encoder_state_dict"], strict=True)
    dec.load_state_dict(to_t["decoder_state_dict"], strict=True)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 128, (3, 12)))
    mask = torch.ones_like(ids)
    mask[0, 8:] = 0
    with torch.no_grad():
        ref = enc(ids, attention_mask=mask).last_hidden_state
        ours = model.encoder(ids.int(), mask.int())["last_hidden_state"]
    assert (ours - ref).abs().max().item() <= HIDDEN_ABS

    out = tmp_path / "bundle.pth"
    export_torch.save_reference_bundle(got, str(out))
    back = torch.load(str(out))
    assert back.keys() == got.keys()
    assert all(torch.equal(back[t][k], to_t[t][k]) for t in got for k in got[t])


def test_reference_bundle_refuses_a_gpt2_run():
    cfg, model, jcfg, params = _same_weights("bagon", GPT2)
    with pytest.raises(ValueError, match="GPT-2"):
        export_torch.export_reference_bundle(cfg, model)
    with pytest.raises(ValueError, match="GPT-2"):
        jax_export_torch.export_reference_bundle(jcfg, jax_build_model(jcfg, "test"), params)


def test_export_torch_main_writes_the_bundle(runs, tmp_path, capsys):
    out = tmp_path / "b.pth"
    export_torch._main([runs["shelgon2"], "--device", "cpu", "--out", str(out)])
    assert f"-> {out}" in capsys.readouterr().out
    back = torch.load(str(out))
    assert "sentence_discretizer.sentence_neg_discretizer.proj_in.weight" in back[
        "model_state_dict"]


# ---------------------------------------------------------------- profiling


def test_step_timer_summary_equals_jax(monkeypatch):
    durations = [0.5, 0.013, 0.011, 0.017, 0.012, 0.019, 0.010, 0.014, 0.016, 0.015, 0.018]
    summaries = []
    for module in (profiling, jax_profiling):
        clock = iter(np.cumsum([0.0] + [x for d in durations for x in (d, 0.001)]).tolist())
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        timer = module.StepTimer(warmup=1)
        for _ in durations:
            with timer:
                pass
        summaries.append(timer.summary())
    monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert summaries[0]["steps"] == 10 and summaries[0]["max_s"] < 0.5
    assert profiling.StepTimer().summary() == jax_profiling.StepTimer().summary()


def test_benchmark_fn_and_trace(tmp_path):
    calls = []
    res = profiling.benchmark_fn(lambda x: calls.append(x), (1,), n_steps=5, warmup=2,
                                 device="cpu")
    assert len(calls) == 7 and res["mean_s"] > 0
    assert res["steps_per_sec"] == pytest.approx(1.0 / res["mean_s"])
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        torch.ones(8) @ torch.ones(8)
    assert prof.key_averages()
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)
