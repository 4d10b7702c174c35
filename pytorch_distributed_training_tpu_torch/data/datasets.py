"""Datasets (port of the LM half of ``data/datasets.py``).

The port keeps its own numpy copy of :class:`SyntheticTextDataset`
(``datasets.py:99``): the same per-split transition table and the same
per-index Markov chain, so a seed gives the same arrays as the JAX
package's.  Yields host-shifted ``(inputs [seq_len], targets [seq_len])``
int32 pairs.

``get_dataset`` knows ``synthetic_text``; the ``tokens`` file dataset is
ROADMAP port item P2b and the image datasets (``imagenet``, ``synthetic``)
item P3, each raising ``NotImplementedError``.
"""
from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

__all__ = ["SyntheticTextDataset", "get_dataset"]


class SyntheticTextDataset:
    """Deterministic fake corpus: per-index Markov-chain token sequences
    over a fixed random bigram table (90% table steps, 10% random jumps), so
    short LM runs have learnable next-token structure."""

    def __init__(self, n_samples: int = 1024, vocab_size: int = 512, seq_len: int = 128,
                 split: str = "train", seed: int = 0):
        self.n_samples = int(n_samples)
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        # crc32, not hash(): the same salt in every process
        self._salt = (zlib.crc32(split.encode()) & 0xFFFF) ^ seed
        table_rng = np.random.default_rng(self._salt)
        self._successors = table_rng.integers(
            0, self.vocab_size, (self.vocab_size, 8), dtype=np.int32
        )
        self._succ_rows = None  # python-list view for the sequential walk

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self._salt * 1_000_003 + idx)
        cur = int(rng.integers(0, self.vocab_size))
        choices = rng.integers(0, 8, self.seq_len).tolist()
        jumps = (rng.random(self.seq_len) < 0.1).tolist()
        randoms = rng.integers(0, self.vocab_size, self.seq_len).tolist()
        if self._succ_rows is None:
            self._succ_rows = self._successors.tolist()
        succ = self._succ_rows
        out = [cur]
        for t in range(self.seq_len):
            cur = randoms[t] if jumps[t] else succ[cur][choices[t]]
            out.append(cur)
        toks = np.asarray(out, dtype=np.int32)
        return toks[:-1], toks[1:]


_NOT_YET = {
    "tokens": "the token-file dataset is ROADMAP port item P2b",
    "tokenbin": "the token-file dataset is ROADMAP port item P2b",
    "imagenet": "image datasets are ROADMAP port item P3",
    "synthetic": "image datasets are ROADMAP port item P3",
    "fake": "image datasets are ROADMAP port item P3",
    "fake_imagenet": "image datasets are ROADMAP port item P3",
}


def get_dataset(name: str, root: str, split: str, n_classes: Optional[int] = None,
                n_samples: Optional[int] = None, seq_len: Optional[int] = None, **_):
    """Dataset factory (reference: train_distributed.py:171-181).  For LM
    datasets ``n_classes`` is the vocabulary size; ``n_samples`` defaults
    to 4096 (train) and 512 (val), ``seq_len`` to 128, as in the JAX
    package.  Other keyword arguments (``image_size``) are ignored."""
    key = name.lower()
    if key in _NOT_YET:
        raise NotImplementedError(f"dataset {name!r}: {_NOT_YET[key]}")
    if key in ("synthetic_text", "fake_text"):
        n = n_samples if n_samples else (4_096 if split == "train" else 512)
        return SyntheticTextDataset(n_samples=n, vocab_size=n_classes or 512,
                                    seq_len=seq_len or 128, split=split)
    raise KeyError(f"unknown dataset '{name}' (the port has: synthetic_text)")
