"""The PyTorch port's serving slice vs the JAX package, on the CPU.

A tiny run directory (2 + 2 layers, H 64, 4 heads, F 128, seq 12, f32) is
written by the JAX package itself (init_params + save_checkpoint +
RunConfig.save + tokenizer save) and served by both. On the CPU the JAX model
takes its unfused trunk (exact-erf GELU), the port its plain layer (the
_ERF_P tanh polynomial, within ~1.5e-7 of erf): logits agree to atol 2e-4,
and VQ codes / reconstruction ids agree wherever the JAX top-2 gap exceeds
1e-3 (closer calls may flip on rounding)."""

import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ckpt.checkpoint import save_checkpoint
from kindergarten_vq_vae_tpu.data.tokenizer import WordTokenizer
from kindergarten_vq_vae_tpu.train.config import DataConfig, ModelConfig, RunConfig
from kindergarten_vq_vae_tpu.train.variants import init_params
from kindergarten_vq_vae_torch.ops.layer import fused_bert_layer
from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel

WORDS = ("i you he she we they eat buy fix paint see the a apple mango fence car house "
         "will not is are was red big small old new").split()
SENTENCES = ["i eat the apple", "he is not buying the mango", "we will fix the fence",
             "they paint a big red house", "she", "you see the small old car now",
             "we are the new car", "he will not eat a mango"]
GAP = 1e-3


def _write_run(root, model_name):
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir, exist_ok=True)
    cfg = RunConfig(
        model=ModelConfig(model_name=model_name, vocab_size=64, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128, compute_dtype="float32",
                          vq_e_dim=64, enc_out_size=64, vq_n_e=5),
        data=DataConfig(data_dir=data_dir, tokenized_sentence_max_length=12),
    )
    run = os.path.join(root, model_name)
    os.makedirs(run)
    cfg.save(os.path.join(run, "run_conf.json"))
    WordTokenizer(WORDS).save(os.path.join(data_dir, cfg.data.tokenizer_file))
    params = init_params(cfg, jax.random.key(3))
    save_checkpoint(os.path.join(run, f"{model_name}_ckpt_loss_recon_val_best"), params)
    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_serve"))
    return {name: _write_run(root, name) for name in ("shelgon3", "bagon")}


def _pair(run):
    from kindergarten_vq_vae_tpu.serve.reconstructor import Reconstructor as JaxReconstructor
    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor

    return JaxReconstructor(run, batch_buckets=(4, 16)), Reconstructor(run, batch_buckets=(4, 16),
                                                                       device="cpu")


def _top2_gap(scores, largest):
    s = np.sort(scores, axis=-1)
    return s[..., -1] - s[..., -2] if largest else s[..., 1] - s[..., 0]


@pytest.mark.parametrize("model_name", ["shelgon3", "bagon"])
def test_forward_matches_jax(runs, model_name):
    jrec, rec = _pair(runs[model_name])
    ids, mask = rec.tokenizer.encode_batch(SENTENCES, 12)
    kw = dict(deterministic=True, rngs={"gumbel": jax.random.key(0)})
    if model_name == "shelgon3":
        want = jrec.model.apply({"params": jrec.params}, ids, mask, is_training=False, **kw)
    else:
        want = jrec.model.apply({"params": jrec.params}, ids, mask, ids, mask, **kw)
    with torch.inference_mode():
        ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
        got = rec.model(ids_t, mask_t) if model_name == "shelgon3" else rec.model(ids_t, mask_t, ids_t, mask_t)

    logits_w = np.asarray(want["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), logits_w, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got["encoder_last_hidden_state"].numpy(),
                               np.asarray(want["encoder_last_hidden_state"]), atol=2e-4, rtol=0)
    sure = _top2_gap(logits_w, largest=True) > GAP
    np.testing.assert_array_equal(got["logits"].argmax(-1).numpy()[sure], logits_w.argmax(-1)[sure])

    if model_name == "shelgon3":
        z = np.asarray(want["encoder_last_hidden_state"], np.float64).reshape(-1, 64)
        e = np.asarray(jrec.params["vector_quantizer"]["codebook"], np.float64)
        gap = _top2_gap(((z[:, None, :] - e[None]) ** 2).sum(-1), largest=False).reshape(ids.shape)
        codes_w = np.asarray(want["min_encoding_indices"])[..., 0]
        codes = got["min_encoding_indices"][..., 0].numpy()
        np.testing.assert_array_equal(codes[gap > GAP], codes_w[gap > GAP])
        np.testing.assert_allclose(float(got["vq_loss"]), float(want["vq_loss"]), rtol=1e-4)


@pytest.mark.parametrize("model_name", ["shelgon3", "bagon"])
def test_reconstructor_matches_jax(runs, model_name):
    jrec, rec = _pair(runs[model_name])
    many = (SENTENCES * 3)[:20]  # spans buckets: 16 + 4
    got, want = rec.reconstruct(many), jrec.reconstruct(many)
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert g["input"] == w["input"]
        assert set(g) == set(w)
        assert 0.0 <= g["token_acc"] <= 1.0
        if model_name == "shelgon3":
            assert len(g["codes"]) == len(w["codes"])
            assert all(0 <= c < 5 for c in g["codes"])
    np.testing.assert_allclose(rec.encode(many), np.asarray(jrec.encode(many), np.float32),
                               atol=2e-4, rtol=0)
    if model_name == "shelgon3":
        assert [len(c) for c in rec.codes(many)] == [len(c) for c in jrec.codes(many)]
    else:
        with pytest.raises(ValueError, match="shelgon3"):
            rec.codes(many)
    assert fused_bert_layer.launches == 0
    assert vector_quantize_kernel.launches == 0


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_http_endpoints(runs):
    from kindergarten_vq_vae_torch.serve.http_server import serve_http
    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor

    rec = Reconstructor(runs["shelgon3"], batch_buckets=(4,), device="cpu")
    server = serve_http(rec, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as resp:
            assert json.loads(resp.read()) == {"status": "ok", "model": "shelgon3"}
        out = _post(port, "/reconstruct", {"sentences": SENTENCES[:3]})
        assert [r["input"] for r in out["results"]] == SENTENCES[:3]
        assert len(_post(port, "/codes", {"sentences": SENTENCES[:3]})["codes"]) == 3
        lat = np.asarray(_post(port, "/encode", {"sentences": SENTENCES[:3]})["latents"])
        assert lat.shape == (3, 64) and np.isfinite(lat).all()
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "/reconstruct", {})
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.parametrize("kind", ["WordTokenizer", "WordPieceTokenizer"])
def test_tokenizer_files_encode_as_in_jax(tmp_path, kind):
    from kindergarten_vq_vae_tpu.data import tokenizer as jax_tok
    from kindergarten_vq_vae_torch.data.tokenizer import _BaseTokenizer

    if kind == "WordTokenizer":
        jtok = jax_tok.WordTokenizer(WORDS)
    else:
        jtok = jax_tok.WordPieceTokenizer(["[PAD]", "i", "eat", "the", "app", "##le", "man",
                                           "##go", "##s", "fix", "fence"])
    path = str(tmp_path / "tok.json")
    jtok.save(path)
    tok = _BaseTokenizer.load(path)
    text = SENTENCES + ["I EAT apples", "mangos fix the fences quickly"]
    for specials in (True, False):
        got, want = tok.encode_batch(text, 6, specials), jtok.encode_batch(text, 6, specials)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert [tok.decode(r) for r in got[0]] == [jtok.decode(r) for r in want[0]]


@pytest.mark.parametrize("field,value", [("fused_head_ce", "store"), ("fused_head_ce", "flash"),
                                         ("fused_layer", "off")])
def test_cuda_refuses_f32_runs(runs, tmp_path, monkeypatch, field, value):
    """An f32 run on CUDA is served on every route, the fused head's and the
    per-module trunk's included (each kernel has an f32 instance): the
    reconstructor refuses it only while PyTorch's f32 products are not full
    f32 (TF32 on), raising ``ValueError`` before it builds the model (before
    anything touches CUDA); with full f32 it goes on to build the model."""
    import shutil

    from kindergarten_vq_vae_torch.serve import reconstructor

    run = str(tmp_path / "run")
    shutil.copytree(runs["shelgon3"], run)
    conf_path = os.path.join(run, "run_conf.json")
    with open(conf_path) as f:
        conf = json.load(f)
    assert conf["compute_dtype"] == "float32"
    conf[field] = value
    with open(conf_path, "w") as f:
        json.dump(conf, f)

    class Built(Exception):
        pass

    def no_model(*args, **kwargs):
        raise Built

    monkeypatch.setattr(reconstructor, "build_model", no_model)
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")  # TF32 products
        with pytest.raises(ValueError, match="full f32"):
            reconstructor.Reconstructor(run, device="cuda")
    finally:
        torch.set_float32_matmul_precision(old)
    with pytest.raises(Built):
        reconstructor.Reconstructor(run, device="cuda")
