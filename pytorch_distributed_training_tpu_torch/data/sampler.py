"""Index-space sharding (port of ``data/sampler.py``, unchanged in meaning).

``DistributedShardSampler`` gives each rank ``indices[rank::num_replicas]``
of a permutation seeded by ``seed + epoch`` (``drop_last`` trims the tail;
otherwise the tail wraps so every rank gets the same count).  In the port a
rank is one process driving one card, where the JAX package's was one host.
One replica gives the reference's single-process samplers
(train_distributed.py:224-225): shuffled, or in order.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["DistributedShardSampler"]


class DistributedShardSampler:
    def __init__(self, dataset_len: int, num_replicas: int, rank: int, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0):
        if not (0 <= rank < num_replicas):
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_len = int(dataset_len)
        self.num_replicas = int(num_replicas)
        self.rank = int(rank)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.seed = int(seed)
        self.epoch = 0
        if self.drop_last:
            self.num_samples = self.dataset_len // self.num_replicas
        else:
            self.num_samples = -(-self.dataset_len // self.num_replicas)
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _global_indices(self) -> np.ndarray:
        if self.shuffle:
            indices = np.random.default_rng(self.seed + self.epoch).permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        if self.drop_last:
            return indices[: self.total_size]
        pad = self.total_size - len(indices)
        return np.concatenate([indices, indices[:pad]]) if pad > 0 else indices

    def local_indices(self) -> np.ndarray:
        return self._global_indices()[self.rank :: self.num_replicas]

    def __iter__(self) -> Iterator[int]:
        return iter(self.local_indices().tolist())

    def __len__(self) -> int:
        return self.num_samples
