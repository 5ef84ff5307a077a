"""Word-level and WordPiece tokenizers over the JAX package's tokenizer JSON.

Counterpart of ``kindergarten_vq_vae_tpu/data/tokenizer.py`` l.20-167
(``_BaseTokenizer``, ``WordTokenizer``, ``WordPieceTokenizer``): the same
file format (``{"type": ..., "vocab": {...}}``), the same lower-cased
whitespace split, BERT special tokens, truncation and zero padding, so a
run's tokenizer file encodes and decodes identically here.
"""

from __future__ import annotations

import json

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
_SPECIALS = (PAD, UNK, CLS, SEP, MASK)


class _BaseTokenizer:
    vocab: dict[str, int]
    inv_vocab: dict[int, str]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def pad_token_id(self) -> int:
        return self.vocab[PAD]

    @property
    def unk_token_id(self) -> int:
        return self.vocab[UNK]

    @property
    def cls_token_id(self) -> int:
        return self.vocab[CLS]

    @property
    def sep_token_id(self) -> int:
        return self.vocab[SEP]

    def _encode_words(self, words: list[str]) -> list[int]:
        raise NotImplementedError

    def encode(self, sentence: str, add_special_tokens: bool = True) -> list[int]:
        ids = self._encode_words(sentence.strip().lower().split())
        if add_special_tokens:
            return [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    def encode_word(self, word: str) -> list[int]:
        """Ids of one word, no special tokens."""
        return self._encode_words([word.lower()])

    def encode_batch(self, sentences: list[str], max_length: int, add_special_tokens: bool = True):
        """(ids, mask), both int32 (n, max_length), truncated and zero-padded."""
        ids = np.zeros((len(sentences), max_length), dtype=np.int32)
        mask = np.zeros((len(sentences), max_length), dtype=np.int32)
        for i, s in enumerate(sentences):
            enc = self.encode(s, add_special_tokens)[:max_length]
            ids[i, : len(enc)] = enc
            mask[i, : len(enc)] = 1
        return ids, mask

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        special_ids = {self.vocab[s] for s in _SPECIALS if s in self.vocab}
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in special_ids:
                continue
            tok = self.inv_vocab.get(i, UNK)
            if tok.startswith("##") and toks:
                toks[-1] += tok[2:]
            else:
                toks.append(tok)
        return " ".join(toks)

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(row, skip_special_tokens) for row in batch_ids]

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"type": type(self).__name__, "vocab": self.vocab}, f)

    @staticmethod
    def load(path: str) -> "_BaseTokenizer":
        with open(path) as f:
            obj = json.load(f)
        cls = {"WordTokenizer": WordTokenizer, "WordPieceTokenizer": WordPieceTokenizer}[obj["type"]]
        tok = cls.__new__(cls)
        tok.vocab = {k: int(v) for k, v in obj["vocab"].items()}
        tok.inv_vocab = {v: k for k, v in tok.vocab.items()}
        if cls is WordPieceTokenizer:
            tok.max_chars_per_word = 100
        return tok


class WordTokenizer(_BaseTokenizer):
    """Word-level tokenizer over a closed corpus vocabulary."""

    def __init__(self, words: list[str]):
        self.vocab = {s: i for i, s in enumerate(_SPECIALS)}
        for w in words:
            if w not in self.vocab:
                self.vocab[w] = len(self.vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}

    def _encode_words(self, words: list[str]) -> list[int]:
        unk = self.unk_token_id
        return [self.vocab.get(w, unk) for w in words]


class WordPieceTokenizer(_BaseTokenizer):
    """Greedy longest-match-first WordPiece (BERT algorithm, uncased)."""

    def __init__(self, vocab_tokens: list[str], max_chars_per_word: int = 100):
        self.vocab = {t: i for i, t in enumerate(vocab_tokens)}
        for s in _SPECIALS:
            if s not in self.vocab:
                self.vocab[s] = len(self.vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.max_chars_per_word = max_chars_per_word

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token_id]
        pieces: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_token_id]
            pieces.append(cur)
            start = end
        return pieces

    def _encode_words(self, words: list[str]) -> list[int]:
        out: list[int] = []
        for w in words:
            out.extend(self._wordpiece(w))
        return out
