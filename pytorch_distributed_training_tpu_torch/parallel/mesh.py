"""The (data, sequence) layout of the ranks as process groups.

Port of what the sequence-parallel path needs of
``pytorch_distributed_training_tpu/parallel/mesh.py``: ``make_sp_mesh``'s
2-D ``(data, sequence)`` mesh, data axis outermost and the sequence axis
minor (``_make_nd_mesh``, JAX ``:36-64``).  One rank is one card, so the
mesh is a layout of the world's ranks: a sequence group is a run of
``n`` consecutive ranks, ``rank = data_idx * n + seq_idx``, and a data
group takes one rank of each sequence group.  The ``model`` axis waits for
tensor parallelism (ROADMAP port item P9).

A model's ``seq_axis`` is the sequence group's exchange
(:attr:`SPLayout.seq_exchange`); the JAX package's axis name ``"sequence"``
names no process group by itself, so the runner puts the exchange in its
place (:func:`resolve_seq_axis` refuses the bare name).
"""
from __future__ import annotations

import torch.distributed as dist

from .sequence import GroupExchange

__all__ = ["DATA_AXIS", "SEQUENCE_AXIS", "SPLayout", "resolve_seq_axis"]

DATA_AXIS = "data"
SEQUENCE_AXIS = "sequence"


class SPLayout:
    """This rank's place in a ``(data, sequence)`` layout of
    ``world_size`` ranks with sequence groups of ``sequence_parallelism``:
    ``data_idx``/``n_data``, ``seq_idx``/``n_seq``, the process groups
    ``data_group`` and ``seq_group`` (``dist.new_group``: every rank builds
    every group, in the same order) and ``seq_exchange``, the sequence
    group as ring attention's exchange."""

    def __init__(self, world_size: int, rank: int, sequence_parallelism: int):
        n = int(sequence_parallelism)
        if n < 1 or world_size % n != 0:
            raise ValueError(f"{world_size} ranks not divisible by sequence ({n})")
        self.n_seq, self.n_data = n, world_size // n
        self.data_idx, self.seq_idx = divmod(rank, n)
        self.seq_ranks = [self.data_idx * n + j for j in range(n)]
        self.data_ranks = [d * n + self.seq_idx for d in range(self.n_data)]
        self.seq_group = self.data_group = None
        for d in range(self.n_data):
            group = dist.new_group([d * n + j for j in range(n)])
            if d == self.data_idx:
                self.seq_group = group
        for j in range(n):
            group = dist.new_group([d * n + j for d in range(self.n_data)])
            if j == self.seq_idx:
                self.data_group = group
        self.seq_exchange = GroupExchange(self.seq_group, self.seq_ranks)


def resolve_seq_axis(seq_axis):
    """The exchange of a model's ``seq_axis``: a :class:`GroupExchange` (or
    any object with its ``size``, ``rank`` and exchanges) as it is; a bare
    axis name raises."""
    if isinstance(seq_axis, str):
        raise ValueError(f"seq_axis {seq_axis!r} names no process group: pass the sequence "
                         "group's exchange (parallel.SPLayout(...).seq_exchange)")
    return seq_axis
