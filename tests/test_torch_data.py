"""The port's data pipeline vs the JAX package's, on a small corpus.

The corpus is cut to 2 verbs and 2 objects per pool (4,608 raw sentences).
Everything here is exact: the generator's sentences and labels, every array
``prepare_all`` writes, its tokenizer JSON, vocabulary and word map (byte
for byte), the seed-69 split, and the batches of ``BatchIterator`` (ids,
mask, labels, row order and ``n_valid``) for a given seed and epoch,
shuffled with ``drop_last`` and a ``lim_batches_pct`` cut, and in order with
a padded last batch.

The C++ packer (``data/native.py``, built with g++ where the tests run) against the port's
Python path and the JAX package's packer, bit for bit (word-level,
WordPiece, truncation without special tokens, as ``tests/test_native.py``).
The JAX package's packer runs from a private build (``jax_packer``): its
bridge compiles onto one shared path at first use and latches "unavailable"
for the life of a process whose load failed, which test workers racing to
build a fresh tree hit; a case latches the bridge so and shows the fixture
still gives the JAX packer's arrays.
The entry points ``python -m kindergarten_vq_vae_torch.data.generate`` and
``... .data.prepare`` in a subprocess give the JAX package's files byte for
byte. The memory-mapped lazy rows: lazy and eager ``select`` the same
values (and JAX's lazy select's), a memory-mapped split stays lazy,
``BatchIterator`` the same batches with ``mmap`` on and off at
``process_count`` 1 and 2, ``load_data`` the same splits either way, and
iterating a 384 MB memory-mapped corpus's split adds under 200 MB of
anonymous memory (the twin of ``tests/test_data.py``'s).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from kindergarten_vq_vae_tpu.data import dataset as jds
from kindergarten_vq_vae_tpu.data import prepare as jprep
from kindergarten_vq_vae_tpu.data.generate import generate_dsentences as jax_generate
from kindergarten_vq_vae_tpu.data import native as jnative
from kindergarten_vq_vae_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from kindergarten_vq_vae_torch.data import dataset as tds
from kindergarten_vq_vae_torch.data import native
from kindergarten_vq_vae_torch.data.generate import generate_dsentences
from kindergarten_vq_vae_torch.data.prepare import prepare_all, tokenize_corpus
from kindergarten_vq_vae_torch.data.tokenizer import WordPieceTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def _same_files(got_dir, want_dir):
    files = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == files
    for name in files:
        with open(os.path.join(got_dir, name), "rb") as a, \
                open(os.path.join(want_dir, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's packer library, built from ``native/corpus_tokenizer.cpp``
    with its bridge's flags into a private directory, written beside its
    name and renamed into place (no reader sees a partial file)."""
    lib = str(tmp_path_factory.mktemp("jax_native") / "libcorpus_tokenizer.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                    os.path.abspath(jnative._SRC), "-o", lib + ".tmp"],
                   check=True, capture_output=True)
    os.replace(lib + ".tmp", lib)
    return lib


@pytest.fixture
def jax_packer(jax_native_lib, monkeypatch):
    """``tokenize_corpus_native`` of the JAX package on the private build,
    whatever this process's bridge has latched: each call points ``_LIB`` at
    the build and resets ``_lib`` / ``_tried``; all three are restored after
    the test."""
    monkeypatch.setattr(jnative, "_LIB", jax_native_lib)

    def pack(*args):
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_tried", False)
        return jnative.tokenize_corpus_native(*args)

    return pack


WORDPIECE = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
             "eat", "##ing", "##s", "the", "apple", "he", "she", "was"]


@pytest.mark.parametrize("case", ["word", "wordpiece", "truncated, no specials"])
def test_native_packer_matches_python_and_jax(prepared, jax_packer, case):
    """The packer is built and taken wherever g++ is on the path."""
    _, art, _ = prepared["torch"]
    if case == "wordpiece":
        tok, jtok = WordPieceTokenizer(WORDPIECE), JaxWordPiece(WORDPIECE)
        sents = ["he was eating the apples", "she eats the apple", "zzz unknown token"]
        L, special = 10, True
    else:
        tok, jtok = art["tokenizer"], prepared["jax"][1]["tokenizer"]
        sents = art["sentences_clean"]
        L, special = (4, False) if case.startswith("truncated") else (12, True)
    assert native.available()
    got = native.tokenize_corpus_native(sents, tok, L, special)
    assert got is not None
    want_py = tokenize_corpus(sents, tok, L, special, use_native=False)
    want_jax = jax_packer(sents, jtok, L, special)
    assert want_jax is not None, "the JAX package's packer did not load from its private build"
    for g, p, j in zip(got, want_py, want_jax):
        assert g.dtype == p.dtype == np.int32
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, j)


def test_jax_packer_survives_a_latched_bridge(prepared, jax_packer, monkeypatch):
    """A worker whose first load of the shared library failed (a racing
    build left it half written) keeps the JAX bridge "unavailable"; the
    fixture still runs the JAX package's packer, which gives the port's
    arrays."""
    _, art, _ = prepared["torch"]
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    assert not jnative.available()
    sents = art["sentences_clean"]
    want = jax_packer(sents, prepared["jax"][1]["tokenizer"], 12, True)
    assert want is not None
    for g, j in zip(tokenize_corpus(sents, art["tokenizer"], 12, True, use_native=False), want):
        np.testing.assert_array_equal(g, j)


def test_generate_entry_point_matches_jax(tmp_path):
    subprocess.run([sys.executable, "-m", "kindergarten_vq_vae_torch.data.generate",
                    str(tmp_path / "torch")], cwd=ROOT, check=True, capture_output=True)
    jax_generate(str(tmp_path / "jax"))
    _same_files(tmp_path / "torch", tmp_path / "jax")


def test_prepare_entry_point_matches_jax(prepared, tmp_path):
    """``--max-length 10`` cuts the prepared rows below the corpus's longest."""
    _, _, raw = prepared["jax"]
    out = subprocess.run([sys.executable, "-m", "kindergarten_vq_vae_torch.data.prepare",
                          "--raw-dir", raw, "--out-dir", str(tmp_path / "torch"),
                          "--max-length", "10"], cwd=ROOT, check=True, capture_output=True,
                         text=True).stdout
    art = jprep.prepare_all(raw, str(tmp_path / "jax"), 10)
    assert out.strip() == (f"prepared {len(art['sentences_clean'])} unique sentences, "
                           f"vocab {len(art['vocab'])}, max_length 10")
    _same_files(tmp_path / "torch", tmp_path / "jax")


def test_lazy_select_values_match_eager_and_jax():
    rng = np.random.default_rng(0)
    cols = dict(input_ids=rng.integers(0, 100, (50, 6)).astype(np.int32),
                attention_mask=np.ones((50, 6), np.int32),
                labels=rng.integers(0, 3, (50, 5)).astype(np.int64))
    ds, jds_ = tds.DSentences(**cols), jds.DSentences(**cols)
    idx = rng.permutation(50)[:20]
    eager, lazy = ds.select(idx, lazy=False), ds.select(idx, lazy=True)
    assert isinstance(lazy.input_ids, tds._LazyRows) and isinstance(eager.input_ids, np.ndarray)
    again = lazy.select(np.arange(5, 15))  # lazy over lazy composes the indices
    for k in ("input_ids", "labels"):
        np.testing.assert_array_equal(np.asarray(getattr(lazy, k)), getattr(eager, k))
        np.testing.assert_array_equal(np.asarray(getattr(lazy, k)),
                                      np.asarray(getattr(jds_.select(idx, lazy=True), k)))
        np.testing.assert_array_equal(np.asarray(getattr(again, k)), getattr(eager, k)[5:15])
    assert lazy.input_ids.shape == (20, 6) and lazy.labels.dtype == np.int64


def _mmapped(prepared, tmp_path):
    """The prepared columns in memory and the same columns memory-mapped."""
    _, art, _ = prepared["torch"]
    names = {"input_ids": "input_ids", "attention_mask": "attention_mask",
             "labels": "latent_classes_labels_clean", "one_hot": "latent_classes_one_hot_clean"}
    cols, mapped = {}, {}
    for k, name in names.items():
        cols[k] = art[name]
        np.save(tmp_path / f"{k}.npy", art[name])
        mapped[k] = np.load(tmp_path / f"{k}.npy", mmap_mode="r")
    return tds.DSentences(**cols), tds.DSentences(**mapped)


@pytest.mark.parametrize("process_count", [1, 2])
def test_batches_with_mmap_equal_in_memory(prepared, tmp_path, process_count):
    eager_ds, mapped_ds = _mmapped(prepared, tmp_path)
    eager, mapped = tds.split_dataset(eager_ds), tds.split_dataset(mapped_ds)
    assert isinstance(mapped[0].input_ids, tds._LazyRows)
    assert isinstance(eager[0].input_ids, np.ndarray)
    for rank in range(process_count):
        kw = dict(batch_size=48, shuffle=True, seed=5, drop_last=True, lim_batches_pct=0.2,
                  process_index=rank, process_count=process_count)
        for a, b in ((eager[0], mapped[0]), (eager[1], mapped[1])):
            it_a, it_b = tds.BatchIterator(a, **kw), tds.BatchIterator(b, **kw)
            it_a.set_epoch(3)
            it_b.set_epoch(3)
            got, want = list(it_b), list(it_a)
            assert len(got) == len(want) > 0
            for gb, wb in zip(got, want):
                assert gb.keys() == wb.keys()
                assert len(gb["input_ids"]) == 48 // process_count
                for k in wb:
                    np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_load_data_with_mmap_equals_in_memory(prepared):
    from kindergarten_vq_vae_torch.config import RunConfig
    from kindergarten_vq_vae_torch.train.run import load_data

    _, _, d = prepared["torch"]
    got = {m: load_data(RunConfig(model_name="shelgon3", data_dir=d, mmap=m,
                                  tokenized_sentence_max_length=10))[0] for m in (False, True)}
    for name in ("train", "val", "test"):
        a, b = got[False][name], got[True][name]
        assert isinstance(b.input_ids, tds._LazyRows) and isinstance(a.input_ids, np.ndarray)
        assert a.sentences == b.sentences and b.input_ids.shape == (len(a), 10)
        for k in ("input_ids", "attention_mask", "labels", "one_hot", "labels8", "one_hot8"):
            np.testing.assert_array_equal(np.asarray(getattr(b, k)), getattr(a, k), err_msg=k)


def test_streaming_split_bounded_memory(tmp_path):
    """A 384 MB memory-mapped corpus: the split keeps index indirection and 20
    batches of 256 add under 200 MB of anonymous memory (the permutations
    take ~100 MB; materialised selections would add ~460 MB more)."""
    def anon_mb():
        with open("/proc/self/smaps_rollup") as f:
            for line in f:
                if line.startswith("Anonymous:"):
                    return int(line.split()[1]) / 1024
        raise RuntimeError("no Anonymous line")

    n, L = 8_000_000, 12
    for name in ("ids", "mask"):
        w = np.lib.format.open_memmap(str(tmp_path / f"{name}.npy"), mode="w+", dtype=np.int32,
                                      shape=(n, L))
        w[:] = 1
        del w
    ds = tds.DSentences(input_ids=np.load(tmp_path / "ids.npy", mmap_mode="r"),
                        attention_mask=np.load(tmp_path / "mask.npy", mmap_mode="r"))
    before = anon_mb()
    train, _, _ = tds.split_dataset(ds)
    assert isinstance(train.input_ids, tds._LazyRows) and len(train) == int(n * 0.6)
    it = tds.BatchIterator(train, batch_size=256, shuffle=True, seed=1)
    for seen, batch in enumerate(it):
        assert batch["input_ids"].shape == (256, L)
        if seen == 19:
            break
    delta = anon_mb() - before
    assert delta < 200, f"the memory-mapped split materialised {delta:.0f} MB"
