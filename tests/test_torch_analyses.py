"""The port's analyses vs the JAX package's, on the CPU in f32.

Tiny models (2 + 2 layers, H 32, 2 heads, F 64, vocab 128, 5 codes, f32)
with weights from JAX's ``init_params``, carried over by the bridge, on the
shared tiny corpus (2 verbs, 2 objects, padded to 12 tokens) split as both
packages split it.

- ``factor_code_metrics``: equal dicts on synthetic labels (a copy of the
  same numpy).
- ``unsupervised_vq_disentanglement`` (Shelgon3-VQ): the codes behind the
  tables equal JAX's (f32 distances to 5 codes, far from any tie), so the
  populated codes, the histograms, the code -> words inventory and the
  factor metrics are equal, and the same four files hold the same content.
- ``extract_cross_attention``: both maps within 1e-5 of JAX's (f32
  softmaxes in another order; measured 3.0e-8).
- ``compute_sentence_latents``: within 1e-5 (measured 8.9e-8);
  ``latent_space_visualization``: equal points on the same latents.
- ``latent_arithmetic_bagon``: Δ within 1e-5 (measured 4.8e-7), the base and
  shifted reconstruction ids equal; ``masked_decoder_inputs`` equal;
  ``randomized_decoder_inputs`` keeps the padding and replaces exactly the
  ``floor(pct * numel)`` positions its generator draws; the Shelgon modes
  raise, naming ROADMAP's "other variants".
- ``get_max_acc_sentences``: the same frame as JAX's from the same feather.
- ``batched_apply``: the outputs (a dict and a tuple, padded tail trimmed)
  of JAX's, with and without ``lim_batches_pct``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.analyses import arithmetic as jax_arith
from kindergarten_vq_vae_tpu.analyses import cross_attention as jax_xattn
from kindergarten_vq_vae_tpu.analyses import disentanglement as jax_dis
from kindergarten_vq_vae_tpu.analyses import latent_space as jax_latent
from kindergarten_vq_vae_tpu.analyses.max_acc import get_max_acc_sentences as jax_max_acc
from kindergarten_vq_vae_tpu.data.dataset import DSentences as JaxDSentences
from kindergarten_vq_vae_tpu.data.dataset import split_dataset as jax_split
from kindergarten_vq_vae_tpu.train.config import RunConfig as JaxRunConfig
from kindergarten_vq_vae_tpu.train.variants import build_model as jax_build_model
from kindergarten_vq_vae_tpu.train.variants import init_params
from kindergarten_vq_vae_torch.analyses import arithmetic, cross_attention, disentanglement
from kindergarten_vq_vae_torch.analyses import latent_space
from kindergarten_vq_vae_torch.analyses.max_acc import get_max_acc_sentences
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax
from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.data.dataset import DSentences, split_dataset
from kindergarten_vq_vae_torch.data.tokenizer import WordTokenizer
from kindergarten_vq_vae_torch.models import build_model

ATTN_ABS, LATENT_ABS, DELTA_ABS = 1e-5, 1e-5, 1e-5
TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            compute_dtype="float32", emb_size=32, word_embedding_size=32, vq_e_dim=32,
            enc_out_size=32, vq_n_e=5, tokenized_sentence_max_length=12)
RESULT_FILES = ("dSentences_vq_vector_populated.txt",
                "dSentences_words_of_interest_histograms.json",
                "dSentences_vq_words_distrib.json", "dSentences_vq_factor_metrics.json")


@pytest.fixture(scope="module")
def data(tiny_corpus):
    """Both packages' splits of the same arrays, and both tokenizers."""
    def to12(a):
        a = np.asarray(a, np.int32)[:, :12]
        return np.pad(a, ((0, 0), (0, 12 - a.shape[1])))

    cols = dict(input_ids=to12(tiny_corpus["input_ids"]),
                attention_mask=to12(tiny_corpus["attention_mask"]),
                labels=tiny_corpus["labels_clean"], one_hot=tiny_corpus["one_hot_clean"],
                sentences=list(tiny_corpus["sentences_clean"]))
    names = ("train", "val", "test")
    return {"jax": dict(zip(names, jax_split(JaxDSentences(**cols)))),
            "torch": dict(zip(names, split_dataset(DSentences(**cols)))),
            "jax_tok": tiny_corpus["tokenizer"], "tok": WordTokenizer(tiny_corpus["vocab"])}


def _models(model_name: str, seed: int = 0):
    """(torch cfg, port model, JAX cfg, JAX model, JAX params) with the same weights."""
    cfg = RunConfig(model_name=model_name, **TINY)
    jcfg = JaxRunConfig.from_flat_dict(cfg.get_config())
    params = jax.tree_util.tree_map(np.asarray, init_params(jcfg, jax.random.key(seed)))
    model = build_model(cfg, device="cpu").eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return cfg, model, jcfg, jax_build_model(jcfg, "test"), params


def _batch(split, lo, hi):
    return {"input_ids": split.input_ids[lo:hi], "attention_mask": split.attention_mask[lo:hi]}


def test_factor_code_metrics_equal_jax():
    rng = np.random.default_rng(0)
    n, s, n_e = 600, 6, 9
    labels = rng.integers(0, 3, size=(n, 3))
    labels[:, 2] = 1  # a constant factor
    codes = rng.integers(0, n_e, size=(n, s))
    codes[:, 2] = labels[:, 0] + 3  # factor 0 fully encoded at position 2
    mask = (rng.random((n, s)) < 0.9).astype(np.int32)
    got = disentanglement.factor_code_metrics(codes, mask, labels, n_e)
    assert got == jax_dis.factor_code_metrics(codes, mask, labels, n_e)
    assert got["sentence_type"]["nmi"] > 0.999 and got["sentence_type"]["position"] == 2


def test_disentanglement_matches_jax(data, tmp_path):
    cfg, model, jcfg, jmodel, params = _models("shelgon3")
    want = jax_dis.unsupervised_vq_disentanglement(
        jcfg, jmodel, params, data["jax"], data["jax_tok"], results_dir=str(tmp_path / "jax"),
        lim_batches_pct=0.2, batch_size=32)
    got = disentanglement.unsupervised_vq_disentanglement(
        cfg, model, data["torch"], data["tok"], results_dir=str(tmp_path / "torch"),
        lim_batches_pct=0.2, batch_size=32)
    assert len(got[0]) >= 2 and sum(got[1]["i"].values()) > 0
    for g, w in zip(got, want):
        assert g == w
    for name in RESULT_FILES:
        with open(tmp_path / "torch" / name) as f, open(tmp_path / "jax" / name) as g:
            assert f.read() == g.read(), name


def test_cross_attention_matches_jax(data, tmp_path):
    _, model, _, jmodel, params = _models("shelgon3")
    b = _batch(data["torch"]["train"], 0, 40)  # two full batches of 16 and a padded one
    want = jax_xattn.extract_cross_attention(jmodel, params, b["input_ids"],
                                             b["attention_mask"], batch_size=16)
    got = cross_attention.extract_cross_attention(model, b["input_ids"], b["attention_mask"],
                                                  batch_size=16,
                                                  out_path=str(tmp_path / "maps.npz"))
    for k in ("cross_attns", "self_attns"):
        assert got[k].shape == (2, 2, 12, 12) and got[k].dtype == np.float32
        assert np.abs(got[k] - want[k]).max() <= ATTN_ABS, k
    assert not np.allclose(got["cross_attns"], got["self_attns"])
    with np.load(tmp_path / "maps.npz") as saved:
        np.testing.assert_array_equal(saved["cross_attns"], got["cross_attns"])


def test_sentence_latents_and_scatter_match_jax(data, tmp_path):
    _, model, _, jmodel, params = _models("shelgon3")
    split = data["torch"]["test"]
    ids, mask = split.input_ids[:100], split.attention_mask[:100]
    want = jax_latent.compute_sentence_latents(jmodel, params, ids, mask, batch_size=32)
    got = latent_space.compute_sentence_latents(model, ids, mask, batch_size=32,
                                                out_path=str(tmp_path / "lat.npy"))
    assert got.shape == (100, 32) and got.dtype == np.float32
    assert np.abs(got - want).max() <= LATENT_ABS
    np.testing.assert_array_equal(np.load(tmp_path / "lat.npy"), got)

    labels = np.asarray(split.labels[:100])
    combos = [tuple(int(v) for v in row) for row in np.unique(labels, axis=0)[:4]]
    pts = latent_space.latent_space_visualization(got, labels, combos,
                                                  out_path=str(tmp_path / "scatter.png"))
    want_pts = jax_latent.latent_space_visualization(got, labels, combos)
    assert list(pts) == list(want_pts) and len(pts) == 4
    for combo in pts:
        np.testing.assert_array_equal(pts[combo], want_pts[combo])


def test_latent_arithmetic_bagon_matches_jax(data):
    _, model, _, jmodel, params = _models("bagon", seed=1)
    tr, va = data["torch"]["train"], data["torch"]["val"]
    group_a, group_b = arithmetic._factor_groups(tr, "verb_tense", "present", "past", 8)
    ja, jb = jax_arith._factor_groups(data["jax"]["train"], "verb_tense", "present", "past", 8)
    for g, w in ((group_a, ja), (group_b, jb)):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    targets, _ = arithmetic._factor_groups(va, "verb_tense", "past", "present", 8)
    dec = arithmetic.masked_decoder_inputs(data["tok"], targets["input_ids"],
                                           targets["attention_mask"])
    np.testing.assert_array_equal(
        dec, jax_arith.masked_decoder_inputs(data["jax_tok"], targets["input_ids"],
                                             targets["attention_mask"]))
    for dec_ids in (None, dec):
        want = jax_arith.latent_arithmetic_bagon(jmodel, params, group_a, group_b, targets,
                                                 data["jax_tok"], decoder_input_ids=dec_ids)
        got = arithmetic.latent_arithmetic_bagon(model, group_a, group_b, targets, data["tok"],
                                                 decoder_input_ids=dec_ids)
        assert got["delta"].shape == (12, 32)
        assert np.abs(got["delta"] - want["delta"]).max() <= DELTA_ABS
        for k in ("base_recon_ids", "shifted_recon_ids"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["shifted_recon"] == want["shifted_recon"]


def test_randomized_decoder_inputs_draw_exactly_their_share(data):
    split = data["torch"]["train"]
    ids, mask = split.input_ids[:32], split.attention_mask[:32]
    assert (mask == 0).any()
    pct, seed = 0.3, 5
    got = arithmetic.randomized_decoder_inputs(data["tok"], ids, mask, pct=pct, seed=seed)
    assert got.shape == ids.shape and got.dtype == ids.dtype
    np.testing.assert_array_equal(got[mask == 0], ids[mask == 0])
    # the positions the generator draws: exactly floor(pct * numel) of all of them
    g = torch.Generator().manual_seed(seed)
    ranks = torch.randperm(ids.size, generator=g).reshape(ids.shape).numpy()
    noise = torch.randint(0, data["tok"].vocab_size, ids.shape, generator=g,
                          dtype=torch.int32).numpy()
    drawn = ranks < int(ids.size * pct)
    assert drawn.sum() == int(ids.size * pct)
    np.testing.assert_array_equal(got[drawn & (mask == 1)], noise[drawn & (mask == 1)])
    np.testing.assert_array_equal(got[~drawn], ids[~drawn])


@pytest.mark.parametrize("mode", ["conditioning", "sentence"])
def test_shelgon_arithmetic_modes_wait_for_other_variants(mode, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.*other variants"):
        arithmetic._main([str(tmp_path), "--mode", mode, "--device", "cpu"])


def test_max_acc_matches_jax(tmp_path):
    import pandas as pd

    rows = [{"epoch": 1, "stage": "test", "input_sentence": s, "recon_sentence": r,
             "sentence_acc": a}
            for s, r, a in (("a b", "a b", 1.0), ("c d", "c e", 0.5), ("e f", "e f", 0.9995),
                            ("g h", "g h", 0.999))]
    pd.DataFrame(rows).to_feather(tmp_path / "decoded_sentences.feather")
    want = jax_max_acc(str(tmp_path), out_dir=str(tmp_path / "jax"))
    got = get_max_acc_sentences(str(tmp_path), out_dir=str(tmp_path / "torch"))
    pd.testing.assert_frame_equal(got, want)
    assert list(got.input_sentence) == ["a b", "e f"]
    for name in ("max_acc_sentences.md", "max_acc_sentences.feather"):
        assert os.path.exists(tmp_path / "torch" / name)
    with open(tmp_path / "torch" / "max_acc_sentences.md") as f, \
            open(tmp_path / "jax" / "max_acc_sentences.md") as g:
        assert f.read() == g.read()
    assert json.loads(got.to_json()) == json.loads(want.to_json())


def test_batched_apply_matches_jax():
    from kindergarten_vq_vae_tpu.analyses.common import batched_apply as jax_batched_apply
    from kindergarten_vq_vae_torch.analyses.common import batched_apply

    rng = np.random.default_rng(2)
    arrays = {"a": rng.normal(size=(70, 3)).astype(np.float32),
              "b": rng.integers(0, 9, (70, 4)).astype(np.int32)}

    def fn(a, b):  # a dict and a tuple of outputs, one a reduction over the batch
        return {"s": a.sum(1) + b[:, 0], "pair": (a * 2, b.max() + 0 * b[:, :1])}

    for lim in (1.0, 0.5):
        want = jax_batched_apply(fn, arrays, 16, lim)
        got = batched_apply(fn, arrays, 16, lim, device="cpu")
        assert len(got["s"]) == len(want["s"]) == (70 if lim == 1.0 else 32)
        np.testing.assert_allclose(got["s"], want["s"], rtol=1e-6)
        for g, w in zip(got["pair"], want["pair"]):
            np.testing.assert_allclose(g, w, rtol=1e-6)
