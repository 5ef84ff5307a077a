"""Offline preprocessing: raw corpus to tokenized static-shape arrays.

The port's copy of ``kindergarten_vq_vae_tpu/data/prepare.py`` (numpy only;
that package cannot be imported without jax): dedup and the clean label
columns, the one-hot labels, the word vocabulary, the word-level tokenizer
and the corpus tokenized once into ``(N, max_length)`` int32 ids and mask,
written under the same file names. Tokenizing takes the Python path
(``tokenize_corpus(use_native=False)`` in the JAX package, whose results are
bit-identical to its C++ packer); the C++ packer ``data/native.py`` is not
ported yet (ROADMAP item 4).
"""

from __future__ import annotations

import json
import os

import numpy as np

from kindergarten_vq_vae_torch.data.tokenizer import WordTokenizer
from kindergarten_vq_vae_torch.utils.consts import CLEAN_FACTOR_COLUMNS, FACTOR_MAX_SUPPORT


def clean_dataset(sentences: list[str], labels: np.ndarray, one_hot: np.ndarray):
    """Dedup the sentences (first occurrence kept) and select the clean label
    columns [2, 5, 6, 7, 8]; the one-hot gets a [-1, -1, -1] sentinel row
    prepended before the same rows are selected, as the reference does."""
    seen: set[str] = set()
    sentences_clean, labels_clean, one_hot_clean, kept = [], [], [], []
    sentinel = np.asarray([[-1] * FACTOR_MAX_SUPPORT])
    cols = list(CLEAN_FACTOR_COLUMNS)
    for i, (s, lab, oh) in enumerate(zip(sentences, labels, one_hot)):
        if s in seen:
            continue
        seen.add(s)
        kept.append(i)
        sentences_clean.append(s)
        labels_clean.append(lab[cols])
        one_hot_clean.append(np.concatenate((sentinel, oh), axis=0)[cols, :])
    return (sentences_clean, np.asarray(labels_clean), np.asarray(one_hot_clean),
            np.asarray(kept))


def labels_to_one_hot(labels: np.ndarray) -> np.ndarray:
    """(N, 9) raw labels -> (N, 8, 3) one-hot, dropping raw factor 0."""
    kept = labels[:, 1:]
    n, f = kept.shape
    out = np.zeros((n, f, FACTOR_MAX_SUPPORT), dtype=np.int64)
    out[np.arange(n)[:, None], np.arange(f)[None, :], kept] = 1
    return out


def export_vocab(sentences: list[str]) -> list[str]:
    """Sorted whitespace-split word vocabulary."""
    vocab: set[str] = set()
    for s in sentences:
        vocab.update(s.split(" "))
    return sorted(vocab)


def word_to_token_id_map(vocab: list[str], tokenizer) -> dict:
    """word -> its token ids, and token id -> the words that contain it."""
    word2ids = {w: tokenizer.encode_word(w) for w in vocab}
    id2word: dict[int, list[str]] = {}
    for w, ids in word2ids.items():
        for i in ids:
            id2word.setdefault(int(i), []).append(w)
    return {"word_to_token_ids": word2ids, "token_id_to_words": id2word}


def find_max_encoded_length(sentences: list[str], tokenizer, add_special_tokens: bool = True):
    return max(len(tokenizer.encode(s, add_special_tokens=add_special_tokens)) for s in sentences)


def tokenize_corpus(sentences: list[str], tokenizer, max_length: int,
                    add_special_tokens: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """The whole corpus as (N, max_length) int32 ids and mask, truncated and
    zero-padded."""
    return tokenizer.encode_batch(sentences, max_length, add_special_tokens)


def prepare_all(raw_dir: str, out_dir: str | None = None, max_length: int | None = None,
                add_special_tokens: bool = True) -> dict:
    """The whole pipeline from ``dSentences_sentences.npy`` and
    ``dSentences_latent_classes_labels.npy`` in ``raw_dir``; writes every
    artifact into ``out_dir`` (default ``raw_dir``) and returns them."""
    out_dir = out_dir or raw_dir
    sentences = [s.decode() if isinstance(s, bytes) else str(s)
                 for s in np.load(os.path.join(raw_dir, "dSentences_sentences.npy"))]
    labels = np.load(os.path.join(raw_dir, "dSentences_latent_classes_labels.npy"))

    one_hot = labels_to_one_hot(labels)
    sentences_c, labels_c, one_hot_c, kept = clean_dataset(sentences, labels, one_hot)
    vocab = export_vocab(sentences_c)
    tokenizer = WordTokenizer(vocab)
    max_len = max_length or find_max_encoded_length(sentences_c, tokenizer, add_special_tokens)
    ids, mask = tokenize_corpus(sentences_c, tokenizer, max_len, add_special_tokens)
    word_map = word_to_token_id_map(vocab, tokenizer)
    labels8_c = labels[kept][:, 1:]
    one_hot8_c = one_hot[kept]

    artifacts = {
        "sentences_clean": sentences_c,
        "latent_classes_labels_clean": labels_c,
        "latent_classes_one_hot_clean": one_hot_c,
        "latent_classes_labels8_clean": labels8_c,
        "latent_classes_one_hot8_clean": one_hot8_c,
        "latent_classes_one_hot_full": one_hot,
        "clean_indices": kept,
        "vocab": vocab,
        "input_ids": ids,
        "attention_mask": mask,
        "max_length": max_len,
        "tokenizer": tokenizer,
    }
    os.makedirs(out_dir, exist_ok=True)

    def save(name, arr):
        np.save(os.path.join(out_dir, f"dSentences_{name}.npy"), arr)

    save("sentences_clean", np.asarray([s.encode() for s in sentences_c]))
    save("latent_classes_labels_clean", labels_c)
    save("latent_classes_one_hot_clean", one_hot_c)
    save("latent_classes_labels8_clean", labels8_c)
    save("latent_classes_one_hot8_clean", one_hot8_c)
    save("latent_classes_one_hot", one_hot)
    save("input_ids", ids)
    save("attention_mask", mask)
    with open(os.path.join(out_dir, "dSentences_vocab.txt"), "w") as f:
        f.write("\n".join(vocab))
    with open(os.path.join(out_dir, "dSentences_word_token_map.json"), "w") as f:
        json.dump(word_map, f)
    tokenizer.save(os.path.join(out_dir, "dSentences_tokenizer.json"))
    return artifacts
