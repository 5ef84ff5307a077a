"""The port's data pipeline vs the JAX package's, on a small corpus.

The corpus is cut to 2 verbs and 2 objects per pool (4,608 raw sentences).
Everything here is exact: the generator's sentences and labels, every array
``prepare_all`` writes, its tokenizer JSON, vocabulary and word map (byte
for byte), the seed-69 split, and the batches of ``BatchIterator`` (ids,
mask, labels, row order and ``n_valid``) for a given seed and epoch,
shuffled with ``drop_last`` and a ``lim_batches_pct`` cut, and in order with
a padded last batch.
"""

import os

import numpy as np
import pytest

from kindergarten_vq_vae_tpu.data import dataset as jds
from kindergarten_vq_vae_tpu.data import prepare as jprep
from kindergarten_vq_vae_tpu.data.generate import generate_dsentences as jax_generate
from kindergarten_vq_vae_torch.data import dataset as tds
from kindergarten_vq_vae_torch.data.generate import generate_dsentences
from kindergarten_vq_vae_torch.data.prepare import prepare_all

CUT = dict(num_verbs=2, num_objects=2)


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    out = {}
    for side, gen, prep in (("jax", jax_generate, jprep.prepare_all),
                            ("torch", generate_dsentences, prepare_all)):
        d = str(root / side)
        out[side] = (gen(d, **CUT), prep(d, max_length=12), d)
    return out


def test_generated_corpus_equals_jax(prepared):
    (s_j, l_j), _, _ = prepared["jax"]
    (s_t, l_t), _, _ = prepared["torch"]
    assert s_t == s_j and len(s_t) == 4608
    assert l_t.dtype == l_j.dtype
    np.testing.assert_array_equal(l_t, l_j)


def test_prepared_artifacts_equal_jax(prepared):
    _, _, d_j = prepared["jax"]
    _, art, d_t = prepared["torch"]
    files = sorted(os.listdir(d_j))
    assert sorted(os.listdir(d_t)) == files
    for name in files:
        a, b = os.path.join(d_t, name), os.path.join(d_j, name)
        if name.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
    assert art["input_ids"].dtype == np.int32 and art["input_ids"].shape[1] == 12


def _datasets(prepared):
    _, art, _ = prepared["torch"]
    cols = dict(input_ids=art["input_ids"], attention_mask=art["attention_mask"],
                labels=art["latent_classes_labels_clean"],
                one_hot=art["latent_classes_one_hot_clean"],
                labels8=art["latent_classes_labels8_clean"],
                one_hot8=art["latent_classes_one_hot8_clean"],
                sentences=art["sentences_clean"])
    return jds.DSentences(**cols), tds.DSentences(**cols)


@pytest.mark.parametrize("kw, epoch", [
    (dict(batch_size=16, shuffle=True, seed=3, lim_batches_pct=0.1, drop_last=True), 2),
    (dict(batch_size=50), 1),
])
def test_split_and_batches_equal_jax(prepared, kw, epoch):
    ds_j, ds_t = _datasets(prepared)
    splits_j, splits_t = jds.split_dataset(ds_j), tds.split_dataset(ds_t)
    for a, b in zip(splits_t, splits_j):
        np.testing.assert_array_equal(a.input_ids, np.asarray(b.input_ids))
        assert a.sentences == b.sentences
    it_j, it_t = jds.BatchIterator(splits_j[1], **kw), tds.BatchIterator(splits_t[1], **kw)
    it_j.set_epoch(epoch)
    it_t.set_epoch(epoch)
    got, want = list(it_t), list(it_j)
    assert len(got) == len(want) == len(it_t) > 0
    for bt, bj in zip(got, want):
        assert bt.keys() == bj.keys()
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    if not kw.get("drop_last"):
        assert int(got[-1]["n_valid"]) < kw["batch_size"]  # the padded last batch
