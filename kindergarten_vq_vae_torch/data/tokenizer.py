"""The tokenizers: word-level and WordPiece over the JAX package's tokenizer
JSON, and the GPT-2 decoder's byte-level BPE.

Counterpart of ``kindergarten_vq_vae_tpu/data/tokenizer.py``: l.20-167
(``_BaseTokenizer``, ``WordTokenizer``, ``WordPieceTokenizer``) with the
same file format (``{"type": ..., "vocab": {...}}``), the same lower-cased
whitespace split, BERT special tokens, truncation and zero padding, so a
run's tokenizer file encodes and decodes identically here; and l.169-347
(``_bytes_to_unicode``, ``BPETokenizer``), whose trainer writes the same
``gpt2_vocab.json`` / ``gpt2_merges.txt`` bytes from the same corpus.
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


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> unicode map: printable stand-ins for the
    control bytes; 'Ġ' marks a space."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class BPETokenizer:
    """GPT-2-style byte-level BPE over ``vocab.json`` + ``merges.txt``, with
    pad = eos (the GPT-2 decoder's tokenizer; JAX l.181-347). It trains its
    own merges from a corpus (:meth:`train`), so nothing is downloaded."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 eos_token: str = "<|endoftext|>"):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.eos_token = eos_token
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_files(cls, vocab_json_path: str, merges_path: str) -> "BPETokenizer":
        with open(vocab_json_path) as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    def _mapped(self, chunk: str) -> str:
        return "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))

    @staticmethod
    def _chunks(text: str):
        """Whitespace words, each but the first with GPT-2's leading space."""
        for i, w in enumerate(str(text).strip().split()):
            yield (" " + w) if i > 0 else w

    @classmethod
    def train(cls, texts: list[str], vocab_size: int = 512,
              eos_token: str = "<|endoftext|>") -> "BPETokenizer":
        """Learn byte-level merges from ``texts``: from the 256 byte symbols,
        merge the most frequent adjacent pair (counted over the distinct
        words, weighted by their frequency) until the vocabulary, eos
        included, holds ``vocab_size`` or no pair occurs twice; ties go to
        the larger pair, ``max(..., key=(count, pair))``."""
        from collections import Counter

        byte_encoder = _bytes_to_unicode()
        vocab = {byte_encoder[b]: b for b in range(256)}
        words: Counter = Counter()
        for text in texts:
            for chunk in cls._chunks(text):
                words["".join(byte_encoder[b] for b in chunk.encode("utf-8"))] += 1
        splits = {w: list(w) for w in words}
        merges: list[tuple[str, str]] = []
        for _ in range(max(0, vocab_size - len(vocab) - 1)):  # -1: eos
            pairs: Counter = Counter()
            for w, freq in words.items():
                sym = splits[w]
                for j in range(len(sym) - 1):
                    pairs[(sym[j], sym[j + 1])] += freq
            if not pairs:
                break
            best = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))[0]
            if pairs[best] < 2:
                break
            merges.append(best)
            vocab[best[0] + best[1]] = len(vocab)
            for w in words:
                splits[w] = cls._merge(splits[w], best)
        vocab[eos_token] = len(vocab)
        return cls(vocab, merges, eos_token=eos_token)

    @staticmethod
    def _merge(sym: list[str], pair: tuple[str, str]) -> list[str]:
        out, j = [], 0
        while j < len(sym):
            if j < len(sym) - 1 and (sym[j], sym[j + 1]) == pair:
                out.append(sym[j] + sym[j + 1])
                j += 2
            else:
                out.append(sym[j])
                j += 1
        return out

    def save(self, vocab_json_path: str, merges_path: str) -> None:
        with open(vocab_json_path, "w") as f:
            json.dump(self.vocab, f)
        with open(merges_path, "w") as f:
            f.write("#version: 0.2\n")
            for a, b in sorted(self.bpe_ranks, key=self.bpe_ranks.get):
                f.write(f"{a} {b}\n")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def eos_token_id(self) -> int:
        return self.vocab[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        return self.eos_token_id  # GPT-2 has no pad token: pad = eos

    def _bpe(self, token: str) -> list[str]:
        if token not in self._cache:
            word = list(token)
            while len(word) > 1:
                pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
                best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
                if best not in self.bpe_ranks:
                    break
                word = self._merge(word, best)
            self._cache[token] = word
        return self._cache[token]

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return [self.vocab[p] for chunk in self._chunks(text)
                for p in self._bpe(self._mapped(chunk))]

    def encode_word(self, word: str) -> list[int]:
        return [self.vocab[p] for p in self._bpe(self._mapped(" " + word))]

    def encode_batch(self, sentences: list[str], max_length: int,
                     add_special_tokens: bool = False):
        """(ids, mask), both int32 (n, max_length), truncated and padded with eos."""
        ids = np.full((len(sentences), max_length), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(sentences), max_length), dtype=np.int32)
        for i, s in enumerate(sentences):
            enc = self.encode(s)[:max_length]
            ids[i, : len(enc)] = enc
            mask[i, : len(enc)] = 1
        return ids, mask

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        eos = self.eos_token_id
        text = "".join(self.inv_vocab.get(int(i), "") for i in ids
                       if not (skip_special_tokens and int(i) == eos))
        raw = bytearray(self.byte_decoder[ch] for ch in text if ch in self.byte_decoder)
        return raw.decode("utf-8", errors="replace")

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(row, skip_special_tokens) for row in batch_ids]
