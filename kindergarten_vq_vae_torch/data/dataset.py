"""Packed, pre-tokenized dataset, deterministic splits and the batch iterator.

The port's copy of ``kindergarten_vq_vae_tpu/data/dataset.py`` (numpy only):
the corpus is held as fixed-shape int32 arrays made once by
``data/prepare.py``; the 60/20/20 split is a permutation keyed on seed 69;
batches are numpy slices of a fixed shape, the last partial one padded by
repeating its first row and carrying the true count in ``n_valid``. Given a
seed and an epoch, :class:`BatchIterator` yields the same batches in the same
order as the JAX package's. The JAX package's memory-mapped lazy rows and
multi-process sharding are not ported (``mmap`` loads in full; ROADMAP
items 4 and 10).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from kindergarten_vq_vae_torch.utils.consts import DS_GEN_SEED

_COLUMNS = ("input_ids", "attention_mask", "dec_input_ids", "dec_attention_mask", "labels",
            "one_hot", "labels8", "one_hot8")


@dataclass
class DSentences:
    """Column store: ``input_ids`` / ``attention_mask`` (N, L) int32, the clean
    ``labels`` (N, 5) and ``one_hot`` (N, 5, 3), the optional 8-factor
    ``labels8`` / ``one_hot8`` and the raw ``sentences``."""

    input_ids: np.ndarray
    attention_mask: np.ndarray
    dec_input_ids: np.ndarray | None = None
    dec_attention_mask: np.ndarray | None = None
    labels: np.ndarray | None = None
    one_hot: np.ndarray | None = None
    labels8: np.ndarray | None = None
    one_hot8: np.ndarray | None = None
    sentences: list[str] | None = None

    def __post_init__(self):
        n = len(self.input_ids)
        for name in _COLUMNS[1:]:
            arr = getattr(self, name)
            if arr is not None and len(arr) != n:
                raise ValueError(f"Provided {n} sentences but {len(arr)} rows of {name}; "
                                 "please provide one row per sentence!")

    def __len__(self) -> int:
        return len(self.input_ids)

    def select(self, idx: np.ndarray) -> "DSentences":
        cols = {k: None if getattr(self, k) is None else getattr(self, k)[idx] for k in _COLUMNS}
        sentences = None if self.sentences is None else [self.sentences[i] for i in idx]
        return DSentences(**cols, sentences=sentences)


def split_dataset(ds: DSentences, train_pct: float = 0.6, val_pct: float = 0.2,
                  seed: int = DS_GEN_SEED):
    """Deterministic (train, val, test) split by a seeded permutation."""
    n = len(ds)
    n_train, n_val = int(n * train_pct), int(n * val_pct)
    perm = np.random.default_rng(seed).permutation(n)
    return (ds.select(perm[:n_train]), ds.select(perm[n_train:n_train + n_val]),
            ds.select(perm[n_train + n_val:]))


@dataclass
class BatchIterator:
    """Static-shape batches of ``batch_size`` rows (numpy dicts with
    ``n_valid`` and the row ``index``), shuffled per epoch by ``(seed,
    epoch)`` when ``shuffle``; ``lim_batches_pct`` keeps the first share of
    the batches, never fewer than one."""

    ds: DSentences
    batch_size: int
    shuffle: bool = False
    seed: int = 0
    lim_batches_pct: float = 1.0
    drop_last: bool = False
    _epoch: int = field(default=0, init=False)

    def __len__(self) -> int:
        n = len(self.ds)
        total = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        if self.lim_batches_pct < 1.0 and total > 0:
            return max(1, int(total * self.lim_batches_pct))
        return total

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self):
        n, bs = len(self.ds), self.batch_size
        if self.shuffle:
            order = np.random.default_rng((self.seed, self._epoch)).permutation(n)
        else:
            order = np.arange(n)
        for b in range(len(self)):
            idx = order[b * bs:(b + 1) * bs]
            n_valid = len(idx)
            if n_valid < bs:
                idx = np.concatenate([idx, np.full(bs - n_valid, idx[0] if n_valid else 0)])
            batch = {"input_ids": self.ds.input_ids[idx],
                     "attention_mask": self.ds.attention_mask[idx],
                     "n_valid": np.int32(n_valid), "index": idx}
            for k in _COLUMNS[2:]:
                col = getattr(self.ds, k)
                if col is not None:
                    batch[k] = col[idx]
            yield batch
