"""ctypes bridge to the host corpus packer (``csrc/corpus_tokenizer.cpp``).

Counterpart of ``kindergarten_vq_vae_tpu/data/native.py``: the packer is
compiled with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` at first use
into ``kindergarten_vq_vae_torch/build/`` (beside the CUDA kernels' library)
and rebuilt when its source is newer; :func:`tokenize_corpus_native`
returns None when no toolchain or library is available, or for a tokenizer
it does not take, and ``data/prepare.py`` ``tokenize_corpus`` then takes the
bit-identical Python path, as the JAX package does. :func:`available` says
which path is taken. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "corpus_tokenizer.cpp")
LIB_PATH = os.path.join(_PKG, "build", "libcorpus_tokenizer.so")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> None:
    """Compile the packer into ``LIB_PATH`` (atomically: test workers may
    build at once)."""
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < os.path.getmtime(SRC):
                _build()
            lib = ctypes.CDLL(LIB_PATH)
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.tokenize_corpus.restype = ctypes.c_int
        lib.tokenize_corpus.argtypes = [
            ctypes.c_char_p,                    # text
            ctypes.POINTER(ctypes.c_long),      # offsets
            ctypes.c_long,                      # n_sentences
            ctypes.c_char_p,                    # vocab blob
            ctypes.c_long,                      # vocab blob length
            ctypes.c_long,                      # n_vocab
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # unk / cls / sep
            ctypes.c_int,                       # word_level
            ctypes.c_int,                       # add_special
            ctypes.c_int,                       # max_len
            ctypes.c_int,                       # n_threads
            ctypes.POINTER(ctypes.c_int),       # out ids
            ctypes.POINTER(ctypes.c_int),       # out mask
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the packer is built and loaded (building it first if needed)."""
    return _load() is not None


def tokenize_corpus_native(sentences: list[str], tokenizer, max_length: int,
                           add_special_tokens: bool = True, n_threads: int | None = None):
    """``(ids, mask)``, both int32 (n, max_length), for a
    :class:`~kindergarten_vq_vae_torch.data.tokenizer.WordTokenizer` or
    :class:`~kindergarten_vq_vae_torch.data.tokenizer.WordPieceTokenizer`,
    truncated and zero-padded as its ``encode_batch``; None when the packer
    is unavailable or the tokenizer is of another type."""
    from kindergarten_vq_vae_torch.data.tokenizer import WordPieceTokenizer, WordTokenizer

    lib = _load()
    if lib is None or not isinstance(tokenizer, (WordTokenizer, WordPieceTokenizer)):
        return None
    n = len(sentences)
    lowered = [s.strip().lower().encode("utf-8") for s in sentences]
    offsets = np.zeros(n + 1, np.int64)
    offsets[1:] = np.cumsum([len(s) for s in lowered], dtype=np.int64)
    tokens = [tokenizer.inv_vocab[i] for i in range(tokenizer.vocab_size)]
    vocab_blob = b"\0".join(t.encode("utf-8") for t in tokens) + b"\0"
    out_ids = np.zeros((n, max_length), np.int32)
    out_mask = np.zeros((n, max_length), np.int32)
    rc = lib.tokenize_corpus(
        b"".join(lowered), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n,
        vocab_blob, len(vocab_blob), tokenizer.vocab_size, tokenizer.unk_token_id,
        tokenizer.cls_token_id, tokenizer.sep_token_id, int(isinstance(tokenizer, WordTokenizer)),
        int(add_special_tokens), max_length, n_threads or os.cpu_count() or 1,
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return (out_ids, out_mask) if rc == 0 else None
