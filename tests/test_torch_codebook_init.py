"""The port's k-means codebook initialisation vs the JAX package's, on the CPU in f32.

- ``kmeans_codebook_init_with`` against JAX's ``kmeans_codebook_init``
  given the rows JAX drew (``jax.random.choice(key, m, (n_e,),
  replace=False)``, which torch cannot reproduce): on seeded Gaussian blobs
  with far-apart centres, on data with fewer distinct rows than codes (so
  some clusters stay empty and keep their centroid), and on blobs far from
  the origin (what the global-mean centring is for). The final assignments
  (each side's rows to its own centroids, by f64 distances) are equal, and
  the centroids within 1e-5 of their largest magnitude (f32 sums in another
  order: measured 0 to 4.5e-7). Rows whose two nearest centroids tie (the
  coinciding centroids of the empty-cluster case) are left out of the
  assignment check.
- ``compute_codebook_init`` on a tiny f32 Bagon whose bundle the JAX
  package wrote, split into its three parts: the encoder sweep's ``z_flat``
  within 1e-5 of JAX's encoder output (measured 9.5e-7: f32 layers in
  another order), the codebook from JAX's ``init_idx`` within 1e-4 of
  JAX's (measured 2.4e-7), and each diagnostic of ``codebook_diagnostics``
  (on JAX's codebook) within 1e-5 relative of JAX's, with the same keys
  (measured at most 1.5e-9).
- ``python -m kindergarten_vq_vae_torch.train.codebook_init`` writes the
  ``.npy``, equal to ``compute_codebook_init``'s codebook.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ckpt.checkpoint import save_checkpoint
from kindergarten_vq_vae_tpu.data.dataset import DSentences as JaxDSentences
from kindergarten_vq_vae_tpu.nn.bert import BertModel as JaxBertModel
from kindergarten_vq_vae_tpu.ops.vq import kmeans_codebook_init as jax_kmeans
from kindergarten_vq_vae_tpu.train.codebook_init import compute_codebook_init as jax_compute
from kindergarten_vq_vae_tpu.train.config import RunConfig as JaxRunConfig
from kindergarten_vq_vae_tpu.train.variants import bert_configs as jax_bert_configs
from kindergarten_vq_vae_tpu.train.variants import init_params
from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.data.dataset import DSentences
from kindergarten_vq_vae_torch.ops.vq import kmeans_codebook_init, kmeans_codebook_init_with
from kindergarten_vq_vae_torch.train import codebook_init as cbi

KMEANS_REL, TIE_REL, Z_ABS, CODEBOOK_ABS, DIAG_REL = 1e-5, 1e-6, 1e-5, 1e-4, 1e-5
TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            compute_dtype="float32", emb_size=32, word_embedding_size=32, vq_e_dim=32,
            enc_out_size=32, vq_n_e=5, tokenized_sentence_max_length=12)


def _assign(z, cent):
    """``(first-nearest centroid, margin)`` of each row by f64 squared
    distances; the margin is the gap to the second-nearest centroid."""
    z, cent = np.asarray(z, np.float64), np.asarray(cent, np.float64)
    d2 = ((z[:, None, :] - cent[None]) ** 2).sum(-1)
    two = np.sort(d2, 1)[:, :2]
    return d2.argmin(1), two[:, 1] - two[:, 0]


def _blobs(rng, n, d, k, scale, spread, offset=0.0):
    centres = rng.normal(size=(k, d)) * scale + offset
    return (centres[rng.integers(0, k, n)] + rng.normal(size=(n, d)) * spread).astype(np.float32)


def _case(name):
    rng = np.random.default_rng(0)
    if name == "blobs":
        return _blobs(rng, 900, 16, 9, 10.0, 1.0), 9
    if name == "empty clusters":
        # 3 distinct rows, 5 codes: at least two initial centroids coincide,
        # the first of them takes every row and the others stay empty
        base = rng.normal(size=(3, 8)).astype(np.float32) * 5
        return base[rng.integers(0, 3, 300)], 5
    # blobs on a shell far from the origin: uncentred, |z|^2 would swamp
    # the differences between the distances
    return _blobs(rng, 600, 32, 6, 4.0, 0.5, offset=1.0e3), 6


@pytest.mark.parametrize("name", ["blobs", "empty clusters", "far from origin"])
def test_kmeans_matches_jax(name):
    z, n_e = _case(name)
    key = jax.random.key(7)
    init_idx = np.array(jax.random.choice(key, len(z), (n_e,), replace=False))
    want = np.asarray(jax_kmeans(key, jnp.asarray(z), n_e))
    got = kmeans_codebook_init_with(torch.from_numpy(z), torch.from_numpy(init_idx)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= KMEANS_REL * np.abs(want).max()
    (a_got, _), (a_want, margin) = _assign(z, got), _assign(z, want)
    # near ties: the two nearest JAX centroids within 1e-6 of the largest
    # squared distance (here only coinciding centroids, in the empty-cluster case)
    far = margin > TIE_REL * margin.max()
    np.testing.assert_array_equal(a_got[far], a_want[far])
    if name == "empty clusters":
        # an empty cluster keeps its centroid (without that rule it would
        # become 0 / 1 = 0): every centroid is one of the 3 distinct rows, up
        # to the rounding of a mean of equal rows
        rows = np.unique(z, axis=0)
        off = np.abs(got[:, None, :] - rows[None]).max(-1).min(1)
        assert len(rows) == 3 and (off <= KMEANS_REL * np.abs(z).max()).all()
    else:
        assert far.all()


def test_kmeans_draw_is_a_seeded_cpu_permutation():
    z, n_e = _case("blobs")
    got = kmeans_codebook_init(torch.from_numpy(z), n_e, torch.Generator().manual_seed(3))
    idx = torch.randperm(len(z), generator=torch.Generator().manual_seed(3))[:n_e]
    assert len(set(idx.tolist())) == n_e
    torch.testing.assert_close(got, kmeans_codebook_init_with(torch.from_numpy(z), idx),
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def bagon_bundle(tmp_path_factory, tiny_corpus):
    """A tiny f32 Bagon written by the JAX package, and a 200-sentence split."""
    jcfg = JaxRunConfig.from_flat_dict({**RunConfig(**TINY).get_config(), "model_name": "bagon"})
    params = jax.tree_util.tree_map(np.asarray, init_params(jcfg, jax.random.key(1)))
    path = str(tmp_path_factory.mktemp("bagon") / "bagon_ckpt_loss_recon_val_best")
    save_checkpoint(path, params)
    ids = np.asarray(tiny_corpus["input_ids"][:200, :12], np.int32)
    mask = np.asarray(tiny_corpus["attention_mask"][:200, :12], np.int32)
    return path, params, ids, mask


def test_compute_codebook_init_matches_jax(bagon_bundle):
    path, params, ids, mask = bagon_bundle
    cfg = RunConfig(model_name="shelgon3", **TINY)
    jcfg = JaxRunConfig.from_flat_dict(cfg.get_config())
    batch, seed = 64, 2  # 200 rows: three full batches and a padded one
    want_cb, want_diag = jax_compute(jcfg, JaxDSentences(input_ids=ids, attention_mask=mask),
                                     bagon_ckpt_path=path, batch_size=batch, seed=seed,
                                     return_diagnostics=True)
    enc_cfg, _ = jax_bert_configs(jcfg)
    want_z = np.asarray(JaxBertModel(enc_cfg).apply(
        {"params": params["encoder"]}, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        deterministic=True)["last_hidden_state"]).reshape(-1, 32)
    init_idx = np.array(jax.random.choice(jax.random.key(seed), len(want_z), (5,),
                                          replace=False))

    encoder = cbi.bagon_encoder(cfg, path, device="cpu")
    z = cbi.encode_rows(encoder, ids, mask, batch)
    assert z.shape == want_z.shape and z.dtype == torch.float32
    assert np.abs(z.numpy() - want_z).max() <= Z_ABS
    codebook = kmeans_codebook_init_with(z, torch.from_numpy(init_idx)).numpy()
    assert np.abs(codebook - want_cb).max() <= CODEBOOK_ABS
    diag = cbi.codebook_diagnostics(z, want_cb)
    assert list(diag) == list(want_diag)
    for k, v in want_diag.items():
        assert abs(diag[k] - v) <= DIAG_REL * abs(v), (k, diag[k], v)

    # the whole function, on the same split: the same keys, its own draw
    got_cb, got_diag = cbi.compute_codebook_init(
        cfg, DSentences(input_ids=ids, attention_mask=mask), bagon_ckpt_path=path,
        batch_size=batch, seed=seed, return_diagnostics=True, device="cpu")
    assert got_cb.shape == (5, 32) and got_cb.dtype == np.float32
    assert list(got_diag) == list(want_diag)
    assert all(np.isfinite(v) for v in got_diag.values())


def test_amplitude_stats_in_chunks_match_one_pass():
    rng = np.random.default_rng(4)
    # rows far from the origin with a small spread: a one-pass E[z^2] - E[z]^2
    # in f32 would cancel most of the variance away
    z = (3.0 + 0.01 * rng.normal(size=(1000, 24))).astype(np.float32)
    std, rms = cbi.amplitude_stats(torch.from_numpy(z), chunk_rows=64)
    z64 = z.astype(np.float64)
    assert abs(std - z64.std(0).mean()) <= 1e-6 * z64.std(0).mean()
    assert abs(rms - np.sqrt((z64 ** 2).mean())) <= 1e-6 * 3.0


def test_main_writes_the_npy(tmp_path, tiny_corpus):
    from kindergarten_vq_vae_torch.data.generate import generate_dsentences
    from kindergarten_vq_vae_torch.data.prepare import prepare_all
    from kindergarten_vq_vae_torch.train.run import load_data

    data_dir = str(tmp_path / "data")
    generate_dsentences(data_dir, num_verbs=1, num_objects=1)
    prepare_all(data_dir, max_length=12)
    cfg = RunConfig(model_name="bagon", data_dir=data_dir, **TINY)
    conf = str(tmp_path / "run_conf.json")
    cfg.save(conf)
    out = str(tmp_path / "codebook_init.npy")
    cbi._main(["--config", conf, "--n-e", "4", "--batch", "256", "--out", out, "--seed", "3",
               "--device", "cpu"])
    got = np.load(out)
    splits, _ = load_data(dataclasses.replace(cfg, model_name="shelgon3"))
    want = cbi.compute_codebook_init(dataclasses.replace(cfg, model_name="shelgon3"),
                                     splits["train"], n_e=4, batch_size=256, seed=3,
                                     device="cpu")
    assert got.shape == (4, 32)
    np.testing.assert_array_equal(got, want)
    with open(conf) as f:
        assert json.load(f)["model_name"] == "bagon"  # _main makes a shelgon3 config of it
    assert os.path.exists(out)
