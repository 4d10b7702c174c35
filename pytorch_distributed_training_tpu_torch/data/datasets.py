"""Datasets (port of the synthetic datasets of ``data/datasets.py``).

The port keeps its own numpy copies, so a seed gives the same arrays as
the JAX package's, bit for bit (the same crc32 salt of the split and the
same ``default_rng`` stream per index):

- :class:`SyntheticDataset` (``datasets.py:58``): class-dependent Gaussian
  images, ``(image [H, W, 3] float32, label int64)``, HWC as the JAX
  package feeds its NHWC model;
- :class:`SyntheticTextDataset` (``datasets.py:99``): per-index Markov
  chains over a per-split transition table, host-shifted ``(inputs
  [seq_len], targets [seq_len])`` int32 pairs.

``get_dataset`` knows ``synthetic``/``fake``/``fake_imagenet`` and
``synthetic_text``/``fake_text``; the ``tokens`` file dataset is ROADMAP
port item P2b and ``imagenet`` (ImageFolder and native decode) item P3b,
each raising ``NotImplementedError``.
"""
from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

__all__ = ["SyntheticDataset", "SyntheticTextDataset", "get_dataset"]


class SyntheticDataset:
    """Deterministic fake ImageNet: standard-normal images with a mean shift
    by class, so short runs have something to learn."""

    def __init__(self, n_samples: int = 1280, n_classes: int = 1000, image_size: int = 224,
                 split: str = "train", seed: int = 0):
        self.n_samples = int(n_samples)
        self.n_classes = int(n_classes)
        self.image_size = int(image_size)
        # crc32, not hash(): the same salt in every process
        self._salt = (zlib.crc32(split.encode()) & 0xFFFF) ^ seed

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.int64]:
        rng = np.random.default_rng(self._salt * 1_000_003 + idx)
        label = idx % self.n_classes
        img = rng.standard_normal((self.image_size, self.image_size, 3), dtype=np.float32)
        img += 0.1 * ((label % 16) - 8) / 8.0
        return img, np.int64(label)


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
    "imagenet": "ImageFolder with native decode is ROADMAP port item P3b",
}


def get_dataset(name: str, root: str, split: str, n_classes: Optional[int] = None,
                n_samples: Optional[int] = None, seq_len: Optional[int] = None,
                image_size: int = 224):
    """Dataset factory (reference: train_distributed.py:171-181), with the
    JAX package's defaults: images ``n_samples`` 12,800 (train) and 1,280
    (val), 1000 classes, ``image_size`` 224; LM datasets (``n_classes`` the
    vocabulary size) 4096 and 512 samples, ``seq_len`` 128."""
    key = name.lower()
    if key in _NOT_YET:
        raise NotImplementedError(f"dataset {name!r}: {_NOT_YET[key]}")
    if key in ("synthetic", "fake", "fake_imagenet"):
        n = n_samples if n_samples else (12_800 if split == "train" else 1_280)
        return SyntheticDataset(n_samples=n, n_classes=n_classes or 1000,
                                image_size=image_size, split=split)
    if key in ("synthetic_text", "fake_text"):
        n = n_samples if n_samples else (4_096 if split == "train" else 512)
        return SyntheticTextDataset(n_samples=n, vocab_size=n_classes or 512,
                                    seq_len=seq_len or 128, split=split)
    raise KeyError(f"unknown dataset '{name}' (the port has: synthetic, synthetic_text)")
