"""A plain batch loader and the iteration-based stream over it.

:class:`DataLoader` cuts the sampler's local indices into batches of
``batch_size`` in order and stacks the samples in the calling thread; with
``drop_last=False`` the last partial batch wraps around to full size, as
the JAX loader does (``data/loader.py:132-144``).  The JAX package's worker
pool, native decode and prefetch are ROADMAP port item P3b.

:func:`make_iter_dataloader` turns the epoch loader into the endless
per-iteration stream the trainer draws from, advancing the sampler's
epoch between passes (``utils/__init__.py:92-165``, without its resume
offsets: checkpoint resume is ROADMAP port item P2b).
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

__all__ = ["DataLoader", "make_iter_dataloader"]


class DataLoader:
    def __init__(self, dataset, batch_size: int, sampler, drop_last: bool = False):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.sampler = sampler
        self.drop_last = bool(drop_last)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def _batch_indices(self) -> List[np.ndarray]:
        idx = self.sampler.local_indices()
        batches = []
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start : start + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    break
                chunk = np.resize(np.concatenate([chunk, idx]), self.batch_size)
            batches.append(chunk)
        return batches

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for chunk in self._batch_indices():
            samples = [self.dataset[int(i)] for i in chunk]
            yield (np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples]))


def make_iter_dataloader(loader: DataLoader) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless batches, epoch after epoch (epoch 0 first)."""
    if len(loader) == 0:
        raise ValueError(
            "loader yields no batches (dataset shard smaller than batch size "
            "with drop_last?) — the iteration-based loop would spin forever"
        )

    def stream():
        epoch = 0
        while True:
            loader.set_epoch(epoch)
            yield from loader
            epoch += 1

    return stream()
