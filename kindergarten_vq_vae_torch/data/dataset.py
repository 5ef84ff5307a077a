"""Packed, pre-tokenized dataset, deterministic splits and the batch iterator.

The port's copy of ``kindergarten_vq_vae_tpu/data/dataset.py`` (numpy only):
the corpus is held as fixed-shape int32 arrays made once by
``data/prepare.py``; the 60/20/20 split is a permutation keyed on seed 69;
batches are numpy slices of a fixed shape, the last partial one padded by
repeating its first row and carrying the true count in ``n_valid``. Given a
seed and an epoch, :class:`BatchIterator` yields the same batches in the same
order as the JAX package's; with ``process_count`` > 1 each process takes
its contiguous slice of every global batch (JAX l.175-212). Memory-mapped
columns (``mmap``, ``train/run.py``) stay on disk: :meth:`DSentences.select`
and :func:`split_dataset` keep index indirection over them
(:class:`_LazyRows`, JAX l.27-52), so a batch reads only its rows.
:func:`padded_batches` cuts columns into fixed-size inference batches the
same way.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from kindergarten_vq_vae_torch.utils.consts import DS_GEN_SEED


class _LazyRows:
    """Rows ``idx`` of a column ``base`` (often an ``np.memmap``), never
    materialised: ``col[key]`` reads only the rows ``idx[key]`` from
    ``base``; ``np.asarray(col)`` reads them all."""

    def __init__(self, base, idx: np.ndarray):
        self.base, self.idx = base, idx

    def __len__(self) -> int:
        return len(self.idx)

    @property
    def shape(self):
        return (len(self.idx),) + tuple(np.shape(self.base)[1:])

    @property
    def dtype(self):
        return self.base.dtype

    def __getitem__(self, key):
        return self.base[self.idx[key]]

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.base[self.idx], dtype=dtype)


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

    def select(self, idx: np.ndarray, lazy: bool | None = None) -> "DSentences":
        """Rows ``idx``. ``lazy`` (by default: when ``input_ids`` is memory-
        mapped or already lazy) keeps index indirection over array columns;
        otherwise the rows are copied."""
        if lazy is None:
            lazy = isinstance(self.input_ids, (np.memmap, _LazyRows))

        def sel(col):
            if col is None:
                return None
            if lazy and isinstance(col, _LazyRows):
                return _LazyRows(col.base, col.idx[idx])
            if lazy and isinstance(col, np.ndarray):
                return _LazyRows(col, np.asarray(idx))
            return col[idx]

        sentences = None if self.sentences is None else [self.sentences[i] for i in idx]
        return DSentences(**{k: sel(getattr(self, k)) for k in _COLUMNS}, sentences=sentences)


def split_dataset(ds: DSentences, train_pct: float = 0.6, val_pct: float = 0.2,
                  seed: int = DS_GEN_SEED):
    """Deterministic (train, val, test) split by a seeded permutation;
    memory-mapped columns stay lazy (:meth:`DSentences.select`)."""
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
    the batches, never fewer than one. With ``process_count`` > 1 every
    process computes the same global order and yields only its
    ``process_index``'s contiguous ``batch_size / process_count`` rows of
    each global batch (``batch_size`` stays global, ``n_valid`` the global
    count)."""

    ds: DSentences
    batch_size: int
    shuffle: bool = False
    seed: int = 0
    lim_batches_pct: float = 1.0
    drop_last: bool = False
    process_index: int = 0
    process_count: int = 1
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
            if self.process_count > 1:
                if bs % self.process_count:
                    raise ValueError(f"batch_size {bs} must divide process_count "
                                     f"{self.process_count}")
                local = bs // self.process_count
                idx = idx[self.process_index * local:(self.process_index + 1) * local]
            batch = {"input_ids": self.ds.input_ids[idx],
                     "attention_mask": self.ds.attention_mask[idx],
                     "n_valid": np.int32(n_valid), "index": idx}
            for k in _COLUMNS[2:]:
                col = getattr(self.ds, k)
                if col is not None:
                    batch[k] = col[idx]
            yield batch


def padded_batches(arrays: dict, batch_size: int, n_batches: int | None = None):
    """Yield ``(start, m, chunk)`` over the first ``n_batches`` (all by
    default) batches of ``batch_size`` rows of equal-length ``arrays``: each
    chunk holds every column's rows ``start:start + batch_size``, a short one
    padded by repeating its first row (``m`` rows are real); empty batches
    are skipped."""
    n = len(next(iter(arrays.values())))
    if n_batches is None:
        n_batches = -(-n // batch_size)
    for start in range(0, n_batches * batch_size, batch_size):
        chunk = {k: v[start:start + batch_size] for k, v in arrays.items()}
        m = len(next(iter(chunk.values())))
        if m == 0:
            continue
        if m < batch_size:
            chunk = {k: np.concatenate([v, np.repeat(v[:1], batch_size - m, axis=0)])
                     for k, v in chunk.items()}
        yield start, m, chunk
