"""The port's GPT-2 decoder, its BPE tokenizer and its runs vs the JAX package's.

On the CPU at a tiny size (H 32, 2 + 2 layers, 2 heads, F 64, S 12; encoder
vocab 97, decoder vocab 131), the same seed-made numpy inputs and the same
weights on both sides: the port's seeded initialisation, handed to JAX as
its param tree by ``ckpt/bridge.py`` (``params_to_jax``; that JAX's own
initial tree loads strictly into the port is ``test_torch_bridge.py``'s):

- the GPT-2 forward (``nn/gpt2.py``) with a padded ``attention_mask`` and an
  ``encoder_attention_mask``: in f32 the logits, ``last_hidden_state`` and
  every ``cross_attentions`` map within 1e-5 of the largest magnitude of
  JAX's; in bf16 each output no further from JAX's f32 forward than 1.25
  times JAX's bf16 forward is, plus one bf16 ulp at the top of its range
  (the two bf16 forwards round in other places: PyTorch computes the
  port's bf16 tanh GELU in f32 and rounds it once);
- causality: a later token leaves the earlier logits unchanged;
- ``convert_gpt2_state_dict`` on an HF ``GPT2LMHeadModel(add_cross_attention=True)``
  built from a config, with and without its cross-attention keys: the
  converted state dict equals JAX's bit for bit, loads strictly, and its
  forward matches HF's within 1e-5 of the largest logit;
- the BPE tokenizer trained on the tiny corpus: the same vocabulary and
  merges as JAX's, the same ``gpt2_vocab.json`` / ``gpt2_merges.txt`` bytes,
  the same ``encode_batch`` ids and masks; the hand-made merges case of
  ``tests/test_gpt2_integration.py``;
- ``load_data``'s ``dec_input_ids`` / ``dec_attention_mask`` equal to JAX's;
- ``trainable_mask`` over every parameter name of a GPT-2 Bagon equal to
  JAX's flattened mask, for the four modes, with and without
  ``cross_attn_trainable``;
- one train step of Bagon, Shelgon, Shelgon2, Shelgon3-VQ and
  Shelgon3-Gumbel with the GPT-2 decoder, dropout off, against
  ``jax.value_and_grad(make_loss_fn(cfg, "train"))``: the stats to rel
  1e-5, the ids exactly, every gradient leaf within 1e-4 of its leaf's
  largest (Shelgon's ``proj_in_conv_bias``, whose exact gradient is 0,
  below 1e-6 of the step's largest on both sides), JAX's Gumbel noise fed
  to both sides (``test_torch_gumbel.NoiseFeed``);
- one CPU CLI run of a GPT-2 Bagon (the BPE trained and saved, 1 epoch),
  served through the port's ``Reconstructor`` and JAX's on the same run
  with equal reconstructions, and an encoder id outside the decoder's
  vocabulary refused with a ``ValueError``; a CPU CLI run of each other
  model with the GPT-2 decoder, served through the port's ``Reconstructor``.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util


from kindergarten_vq_vae_tpu.data.tokenizer import BPETokenizer as JaxBPE
from kindergarten_vq_vae_tpu.nn import gpt2 as jax_gpt2
from kindergarten_vq_vae_tpu.serve.reconstructor import Reconstructor as JaxReconstructor
from kindergarten_vq_vae_tpu.train.config import RunConfig as JaxRunConfig
from kindergarten_vq_vae_tpu.train.freezing import trainable_mask as jax_trainable_mask
from kindergarten_vq_vae_tpu.train.run import load_data as jax_load_data
from kindergarten_vq_vae_tpu.train.variants import make_loss_fn as jax_make_loss_fn
from kindergarten_vq_vae_torch import cli
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax, params_to_jax
from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name
from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.data.generate import generate_dsentences
from kindergarten_vq_vae_torch.data.prepare import prepare_all
from kindergarten_vq_vae_torch.data.tokenizer import BPETokenizer, _bytes_to_unicode
from kindergarten_vq_vae_torch.models import build_model, init_weights
from kindergarten_vq_vae_torch.nn import gpt2
from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor
from kindergarten_vq_vae_torch.train.freezing import trainable_mask
from kindergarten_vq_vae_torch.train.run import load_data
from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step
from kindergarten_vq_vae_torch.train.variants import STAT_KEYS
from kindergarten_vq_vae_torch.utils.consts import SUPPORTED_MODEL_MODES
from test_torch_gumbel import NoiseFeed

B, S, H, V, DV, N_VALID = 6, 12, 32, 97, 131, 4
SK = 7  # encoder positions of the decoder-alone forward
FWD_REL, BF16_SLACK = 1e-5, 1.25
BASE = dict(decoder_model_name="gpt2", vocab_size=V, decoder_vocab_size=DV, hidden_size=H,
            num_layers=2, num_heads=2, intermediate_size=64, compute_dtype="float32",
            vq_e_dim=H, enc_out_size=H, emb_size=H, word_embedding_size=H, vq_n_e=5,
            batch_size=B, tokenized_sentence_max_length=S, lr=1e-3, weight_decay=0.01)
VARIANTS = {
    "bagon": dict(model_name="bagon"),
    "shelgon": dict(model_name="shelgon"),
    "shelgon2": dict(model_name="shelgon2"),
    "shelgon3-vq": dict(model_name="shelgon3"),
    "shelgon3-gumbel": dict(model_name="shelgon3", vq_mode="GumbelQuantizer"),
}
ZERO_GRAD = ("proj_in_conv_bias",)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _flat(tree) -> dict:
    return {".".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


def _padded(rng, vocab: int, pad: int, b: int = B, s: int = S):
    lens = rng.integers(3, s + 1, b)
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    ids = np.where(mask == 1, rng.integers(0, vocab, (b, s)), pad).astype(np.int32)
    return ids, mask


# ---------------------------------------------------------------- the forward

def _decoder_case(dtype: str):
    jcfg = jax_gpt2.GPT2Config(vocab_size=DV, hidden_size=H, num_layers=2, num_heads=2,
                               dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    tcfg = gpt2.GPT2Config(vocab_size=DV, hidden_size=H, num_layers=2, num_heads=2,
                           dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dtype])
    rng = np.random.default_rng(0)
    ids, mask = _padded(rng, DV - 1, DV - 1, 3)
    enc = rng.normal(size=(3, SK, H)).astype(np.float32)
    emask = (np.arange(SK)[None] < np.array([SK, 4, 2])[:, None]).astype(np.int32)
    return jcfg, tcfg, (ids, mask, enc, emask)


@functools.lru_cache(maxsize=None)
def _weights() -> dict:
    """The decoder-alone case's weights (the port's seeded initialisation) as
    a Flax tree of numpy arrays."""
    model = init_weights(gpt2.GPT2LMHeadModel(_decoder_case("f32")[1]),
                         torch.Generator().manual_seed(0))
    return params_to_jax(model)


@functools.lru_cache(maxsize=None)
def _jax_decoder(dtype: str) -> dict:
    jcfg, _, arrays = _decoder_case(dtype)
    model = jax_gpt2.GPT2LMHeadModel(jcfg)
    out = jax.jit(lambda p, *a: model.apply({"params": p}, *a, output_attentions=True))(
        _weights(), *(jnp.asarray(a) for a in arrays))
    return {"logits": np.asarray(out["logits"], np.float32),
            "last_hidden_state": np.asarray(out["last_hidden_state"], np.float32),
            "cross_attentions": [np.asarray(a, np.float32) for a in out["cross_attentions"]]}


def _port_decoder(dtype: str) -> dict:
    _, tcfg, arrays = _decoder_case(dtype)
    model = gpt2.GPT2LMHeadModel(tcfg)
    model.load_state_dict(params_from_jax(_weights()), strict=True)
    ids, mask, enc, emask = (torch.from_numpy(a) for a in arrays)
    with torch.no_grad():
        out = model(ids.long(), mask, enc, emask, output_attentions=True)
    assert out["attentions"] == () and len(out["cross_attentions"]) == 2
    return {"logits": out["logits"].float().numpy(),
            "last_hidden_state": out["last_hidden_state"].float().numpy(),
            "cross_attentions": [a.float().numpy() for a in out["cross_attentions"]]}


def _outputs(out: dict):
    yield "logits", out["logits"]
    yield "last_hidden_state", out["last_hidden_state"]
    for i, a in enumerate(out["cross_attentions"]):
        yield f"cross_attentions[{i}]", a


def test_gpt2_forward_matches_jax_f32():
    got = dict(_outputs(_port_decoder("f32")))
    for k, want in _outputs(_jax_decoder("f32")):
        assert _rel(got[k], want) <= FWD_REL, k


def test_gpt2_forward_matches_jax_bf16():
    """Each bf16 forward is held to JAX's f32 forward of the same weights:
    the port's may sit no further from it than 1.25 times JAX's bf16
    forward, plus one bf16 ulp (2^-8) of the output's largest magnitude."""
    got, theirs = dict(_outputs(_port_decoder("bf16"))), dict(_outputs(_jax_decoder("bf16")))
    for k, ref in _outputs(_jax_decoder("f32")):
        ours, jax_err = _rel(got[k], ref), _rel(theirs[k], ref)
        assert ours <= BF16_SLACK * jax_err + 2.0 ** -8, (k, ours, jax_err)


def test_gpt2_is_causal():
    _, tcfg, (ids, mask, enc, emask) = _decoder_case("f32")
    model = gpt2.GPT2LMHeadModel(tcfg)
    model.load_state_dict(params_from_jax(_weights()), strict=True)
    a = torch.from_numpy(ids).long()
    b = a.clone()
    b[:, 7] = (b[:, 7] + 1) % DV
    ones = torch.ones_like(a)
    with torch.no_grad():
        la = model(a, ones, torch.from_numpy(enc))["logits"]
        lb = model(b, ones, torch.from_numpy(enc))["logits"]
    assert torch.equal(la[:, :7], lb[:, :7])
    assert not torch.allclose(la[:, 7:], lb[:, 7:])


@pytest.mark.parametrize("with_cross", [True, False], ids=["cross", "fresh-cross"])
def test_convert_gpt2_state_dict_matches_jax(with_cross):
    os.environ.setdefault("USE_TF", "0")  # the HF models here are torch's: skip TensorFlow
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPT2Config(vocab_size=DV, n_embd=H, n_layer=2, n_head=2,
                                     n_positions=1024, add_cross_attention=True,
                                     resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    sd = hf.state_dict()
    if not with_cross:
        sd = {k: v for k, v in sd.items() if "crossattention" not in k and "ln_cross" not in k}
    jcfg, tcfg, (ids, _, enc, _) = _decoder_case("f32")
    fresh = _weights()
    want = params_from_jax(jax_gpt2.convert_gpt2_state_dict(sd, jcfg, fresh))
    got = gpt2.convert_gpt2_state_dict(sd, tcfg, params_from_jax(fresh))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model = gpt2.GPT2LMHeadModel(tcfg)
    model.load_state_dict(got, strict=True)
    if not with_cross:
        assert np.array_equal(got["layer_1.q_attn.kernel"].numpy(),
                              fresh["layer_1"]["q_attn"]["kernel"])
        return
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids).long(), encoder_hidden_states=torch.from_numpy(enc)).logits
        out = model(torch.from_numpy(ids).long(), None, torch.from_numpy(enc))["logits"]
    assert _rel(out.numpy(), ref.numpy()) <= FWD_REL


# ---------------------------------------------------------------- the BPE

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    generate_dsentences(d, num_verbs=2, num_objects=2)
    prepare_all(d, max_length=S)
    return d


def _sentences(d: str) -> list[str]:
    return [str(s) for s in np.load(os.path.join(d, "dSentences_sentences_clean.npy"))]


def test_bpe_training_matches_jax(corpus, tmp_path):
    texts = _sentences(corpus)
    got, want = BPETokenizer.train(texts, vocab_size=300), JaxBPE.train(texts, vocab_size=300)
    assert got.vocab == want.vocab and list(got.vocab) == list(want.vocab)
    assert got.bpe_ranks == want.bpe_ranks and len(got.bpe_ranks) > 10
    files = {}
    for side, tok in (("port", got), ("jax", want)):
        paths = (str(tmp_path / f"{side}_vocab.json"), str(tmp_path / f"{side}_merges.txt"))
        tok.save(*paths)
        files[side] = [open(p, "rb").read() for p in paths]
    assert files["port"] == files["jax"]
    loaded = BPETokenizer.from_files(str(tmp_path / "jax_vocab.json"),
                                     str(tmp_path / "jax_merges.txt"))
    for tok in (got, loaded):
        ids, mask = tok.encode_batch(texts + ["zebra quickly", ""], max_length=S)
        jids, jmask = want.encode_batch(texts + ["zebra quickly", ""], max_length=S)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)
    assert got.decode(got.encode(texts[0])) == " ".join(texts[0].split())
    assert got.batch_decode(ids[:3]) == want.batch_decode(ids[:3])
    w = max(texts[0].split(), key=len)
    assert got.encode_word(w) == want.encode_word(w) and len(got.encode_word(w)) < len(w) + 1


def test_bpe_hand_made_merges():
    """``tests/test_gpt2_integration.py``'s case: merge e + a, then Ġ + ea, ..."""
    b2u = _bytes_to_unicode()
    sp = b2u[ord(" ")]
    merges = [("e", "a"), (sp, "ea"), (f"{sp}ea", "t"), ("ea", "t")]
    vocab = {b2u[b]: b for b in range(256)}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab.setdefault("<|endoftext|>", len(vocab))
    tok = BPETokenizer(vocab, merges)
    ids = tok.encode("eat eat")
    assert ids == [vocab["eat"], vocab[f"{sp}eat"]] == JaxBPE(vocab, merges).encode("eat eat")
    assert tok.decode(ids) == "eat eat" and tok.pad_token_id == tok.eos_token_id
    arr, mask = tok.encode_batch(["eat", "eat eat"], max_length=4)
    assert arr.shape == (2, 4) and mask.sum(1).tolist() == [1, 2]
    assert arr[0, 1] == tok.pad_token_id


def test_load_data_dual_tokenization_matches_jax(corpus, tmp_path):
    """Each side trains and saves the BPE in its own copy of the corpus:
    the same files, the same ``dec_*`` columns in every split."""
    splits = {}
    for side in ("port", "jax"):
        d = str(tmp_path / side)
        shutil.copytree(corpus, d)
        cfg = RunConfig(**{**BASE, "decoder_vocab_size": 300, "data_dir": d})
        if side == "port":
            splits[side] = load_data(cfg)[0]
        else:
            splits[side] = jax_load_data(JaxRunConfig.from_flat_dict(cfg.get_config()))[0]
    for name in ("gpt2_vocab.json", "gpt2_merges.txt"):
        assert (open(tmp_path / "port" / name, "rb").read()
                == open(tmp_path / "jax" / name, "rb").read())
    for split in ("train", "val", "test"):
        got, want = splits["port"][split], splits["jax"][split]
        for k in ("input_ids", "attention_mask", "dec_input_ids", "dec_attention_mask"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert splits["port"]["train"].dec_input_ids.max() < 300
    cfg = RunConfig(**{**BASE, "decoder_vocab_size": 200, "data_dir": str(tmp_path / "port")})
    with pytest.raises(ValueError, match="decoder_vocab_size=200"):
        load_data(cfg)


# ---------------------------------------------------------------- freezing

@functools.lru_cache(maxsize=None)
def _init(variant: str):
    """(port cfg, JAX cfg, the port's seeded initial weights as a Flax tree)."""
    cfg = RunConfig(**{**BASE, **VARIANTS[variant]})
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    return cfg, JaxRunConfig.from_flat_dict(cfg.get_config()), params_to_jax(model)


@pytest.mark.parametrize("cross", [True, False], ids=["cross-trainable", "cross-frozen"])
@pytest.mark.parametrize("mode", SUPPORTED_MODEL_MODES)
def test_trainable_mask_matches_jax(mode, cross):
    _, _, params = _init("bagon")
    want = {".".join(k): v for k, v in traverse_util.flatten_dict(
        jax_trainable_mask(params, mode, cross_attn_trainable=cross)).items()}
    names = list(params_from_jax(params))
    assert any(n.startswith("decoder.layer_0.q_attn") for n in names) and "decoder.wpe" in names
    assert trainable_mask(names, mode, cross_attn_trainable=cross) == want
    if mode == "dec-head-ft":
        assert want["decoder.wte.embedding"] and not want["decoder.wpe"]
        assert want["decoder.layer_1.ln_cross_attn.scale"] == cross
        assert not want["decoder.layer_1.c_attn.kernel"] and not want["decoder.ln_f.scale"]


# ---------------------------------------------------------------- train steps

def _batch(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    ids, mask = _padded(rng, V, 0)
    dec_ids, dec_mask = _padded(rng, DV - 1, DV - 1)
    labels, labels8 = rng.integers(0, 3, (B, 5)), rng.integers(0, 3, (B, 8))
    eye = np.eye(3, dtype=np.int32)
    return {"input_ids": ids, "attention_mask": mask, "dec_input_ids": dec_ids,
            "dec_attention_mask": dec_mask, "labels": labels.astype(np.int32),
            "one_hot": eye[labels], "labels8": labels8.astype(np.int32), "one_hot8": eye[labels8]}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_matches_jax(monkeypatch, variant):
    cfg, jcfg, params = _init(variant)
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    assert isinstance(model.decoder, gpt2.GPT2LMHeadModel)
    feed = NoiseFeed(monkeypatch)
    step = make_train_step(cfg, "cpu", torch.Generator().manual_seed(0), deterministic=True)
    grad_fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(jcfg, "train"), has_aux=True),
                      static_argnums=3)
    rngs = {k: jax.random.key(1) for k in ("dropout", "gumbel", "perturb")}
    batch = _batch()
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items()}, "n_valid": jnp.int32(N_VALID)}
    tbatch = {**{k: torch.from_numpy(v).long() for k, v in batch.items()}, "n_valid": N_VALID}
    (_, jaux), grads = grad_fn(params, jbatch, rngs, True)
    state, aux = step(init_train_state(cfg, model), tbatch)
    assert feed.calls["jax"] == feed.calls["torch"]
    for k in STAT_KEYS[cfg.model_name]:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    for k in ("recon_ids", "target_ids"):
        np.testing.assert_array_equal(aux[k].numpy(), np.asarray(jaux[k]), err_msg=k)
    if cfg.model_name in ("bagon", "shelgon"):  # the BPE ids feed the decoder
        np.testing.assert_array_equal(aux["target_ids"].numpy(), batch["dec_input_ids"])
    jgrads = _flat(jax.device_get(grads))
    tgrads = {n: p.grad for n, p in state.model.named_parameters()}
    assert tgrads.keys() == jgrads.keys()
    top = max(np.abs(g).max() for g in jgrads.values())
    for leaf, g in jgrads.items():
        got = np.zeros_like(g) if tgrads[leaf] is None else tgrads[leaf].numpy()
        if leaf in ZERO_GRAD:
            assert max(np.abs(got).max(), np.abs(g).max()) <= 1e-6 * top, leaf
        else:
            assert _rel(got, g) <= 1e-4, leaf


# ---------------------------------------------------------------- CLI and serving

CLI = dict(decoder_model_name="gpt2", decoder_vocab_size=300, vocab_size=128, hidden_size=32,
           num_layers=1, num_heads=2, intermediate_size=64, compute_dtype="float32",
           vq_e_dim=32, enc_out_size=32, emb_size=32, word_embedding_size=32, vq_n_e=4,
           batch_size=16, tokenized_sentence_max_length=S, lim_batches_train_pct=0.04,
           lim_batches_val_pct=0.1, lim_batches_test_pct=0.1, n_epochs=1,
           n_epochs_to_decode_after=1, ckpt_slots=("loss_recon:val",))
SENTENCES = ["i eat the apple", "she will not be eating the apples", "do we eat the apple"]


def _cli_run(model_name: str, data: str, runs: str, **over):
    """A CPU CLI run of ``model_name`` with the GPT-2 decoder: its engine,
    after checking the run directory (finite stats, the best-val slot)."""
    argv = [model_name, "--device", "cpu"]
    for k, v in {**CLI, **over, "data_dir": data, "runs_dir": runs}.items():
        argv += ["--set", f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"]
    engine = cli.main(argv)
    assert isinstance(engine.model.decoder, gpt2.GPT2LMHeadModel)
    assert engine.splits["train"].dec_input_ids is not None
    history = json.loads(open(os.path.join(engine.run_path, "history.json")).read())
    for stats in (history[0]["train"], history[0]["val"], history[1]["test"]):
        assert all(np.isfinite(stats[k]) for k in STAT_KEYS[model_name])
    assert os.path.exists(os.path.join(engine.run_path,
                                       best_ckpt_name(model_name, "loss_recon", "val")))
    return engine


@pytest.mark.parametrize("model_name, over", [
    ("shelgon", {}), ("shelgon2", {"mask_pct_train": 0.1}), ("shelgon3", {}),
    ("shelgon3", {"vq_mode": "GumbelQuantizer"}),
], ids=["shelgon", "shelgon2", "shelgon3-vq", "shelgon3-gumbel"])
def test_cli_runs_each_model_with_the_gpt2_decoder(corpus, tmp_path_factory, model_name, over):
    """Every model trains, evaluates, checkpoints and is served on the CPU
    with the GPT-2 decoder (the BPE files trained once, then loaded)."""
    data = str(tmp_path_factory.getbasetemp() / "gpt2_data")
    if not os.path.exists(data):
        shutil.copytree(corpus, data)
    engine = _cli_run(model_name, data, str(tmp_path_factory.mktemp("runs")), **over)
    got = Reconstructor(engine.run_path, device="cpu").reconstruct(SENTENCES)
    assert [r["input"] for r in got] == SENTENCES
    assert all(0.0 <= r["token_acc"] <= 1.0 for r in got)
    assert ("codes" in got[0]) == (model_name == "shelgon3")


def test_cli_run_served_as_jax_serves_it(corpus, tmp_path):
    data = str(tmp_path / "data")
    shutil.copytree(corpus, data)
    engine = _cli_run("bagon", data, str(tmp_path / "runs"))
    run = engine.run_path
    assert os.path.exists(os.path.join(data, "gpt2_vocab.json"))
    assert engine.decoded_sentences  # decoded with the encoder tokenizer, as JAX's engine does
    sentences = SENTENCES
    rec = Reconstructor(run, device="cpu")
    got, want = rec.reconstruct(sentences), JaxReconstructor(run).reconstruct(sentences)
    for g, w in zip(got, want):
        assert g["input"] == w["input"] and g["reconstruction"] == w["reconstruction"]
        assert g["token_acc"] == pytest.approx(w["token_acc"])
    ids, mask = rec.tokenizer.encode_batch(sentences, S)
    ids[1, 2] = 300  # outside the decoder's vocabulary of 300
    rec.tokenizer.encode_batch = lambda *args: (ids, mask)
    with pytest.raises(ValueError, match="decoder_vocab_size=300"):
        rec.reconstruct(sentences)
