"""The (data, sequence), (data, model) and (data, stage) layouts of the
ranks as process groups.

Port of what the sequence- and tensor-parallel paths need of
``pytorch_distributed_training_tpu/parallel/mesh.py``: ``make_sp_mesh``'s
2-D ``(data, sequence)`` mesh and ``make_3d_mesh``'s ``(data, sequence,
model)`` mesh at sequence 1, and ``make_pp_mesh``'s ``(data, stage)`` mesh
(``parallel/pipeline.py:56-95``), grown by a model or a sequence axis
for PP x TP and PP x SP, the data axis outermost and the other
axis innermost (``_make_nd_mesh``, JAX ``:36-64``, ``:92-111``).  One rank is one
card, so a mesh is a layout of the world's ranks: a sequence (or model)
group is a run of ``n`` consecutive ranks, ``rank = data_idx * n +
inner_idx``, and a data group takes one rank of each.  Every rank builds
every group, in the same order (``dist.new_group`` requires it).  Sequence
and tensor parallelism together (JAX's 3-D GSPMD mesh) stay ROADMAP port
item P9.

A model's ``seq_axis`` is the sequence group's exchange
(:attr:`SPLayout.seq_exchange`); the JAX package's axis name ``"sequence"``
names no process group by itself, so the runner puts the exchange in its
place (:func:`resolve_seq_axis` refuses the bare name).  A model's
``tensor_group`` is the model group (:attr:`TPLayout.tensor_group`), and
ZeRO splits leaves over the data group (:attr:`TPLayout.zero_group`).  A
pipeline stage's model holds its blocks of the stage group
(:attr:`PPLayout.stage`), split over its model group or running its
attention over its sequence group, and the step hops activations and
cotangents to the neighbouring stages through :attr:`PPLayout.stage_exchange`.
"""
from __future__ import annotations

import torch.distributed as dist

from .pipeline import STAGE_AXIS, StageExchange
from .sequence import GroupExchange
from .tensor import TensorGroup

__all__ = ["DATA_AXIS", "MODEL_AXIS", "PPLayout", "SEQUENCE_AXIS", "STAGE_AXIS", "SPLayout",
           "TPLayout", "resolve_seq_axis"]

DATA_AXIS = "data"
SEQUENCE_AXIS = "sequence"
MODEL_AXIS = "model"


class _GridLayout:
    """``world_size`` ranks as ``n_data`` runs of ``n`` consecutive ranks:
    ``data_idx``/``inner_idx``, the inner run's ranks ``inner_ranks`` and
    group ``inner_group``, the data ranks ``data_ranks`` and ``data_group``."""

    def __init__(self, world_size: int, rank: int, n: int, axis: str):
        n = int(n)
        if n < 1 or world_size % n != 0:
            raise ValueError(f"{world_size} ranks not divisible by {axis} ({n})")
        self.n_inner, self.n_data = n, world_size // n
        self.data_idx, self.inner_idx = divmod(rank, n)
        self.inner_ranks = [self.data_idx * n + j for j in range(n)]
        self.data_ranks = [d * n + self.inner_idx for d in range(self.n_data)]
        self.inner_group = self.data_group = None
        for d in range(self.n_data):
            group = dist.new_group([d * n + j for j in range(n)])
            if d == self.data_idx:
                self.inner_group = group
        for j in range(n):
            group = dist.new_group([d * n + j for d in range(self.n_data)])
            if j == self.inner_idx:
                self.data_group = group


class SPLayout(_GridLayout):
    """This rank's place in a ``(data, sequence)`` layout of
    ``world_size`` ranks with sequence groups of ``sequence_parallelism``:
    ``data_idx``/``n_data``, ``seq_idx``/``n_seq``, the process groups
    ``data_group`` and ``seq_group`` and ``seq_exchange``, the sequence
    group as ring attention's exchange."""

    def __init__(self, world_size: int, rank: int, sequence_parallelism: int):
        super().__init__(world_size, rank, sequence_parallelism, SEQUENCE_AXIS)
        self.n_seq, self.seq_idx = self.n_inner, self.inner_idx
        self.seq_ranks, self.seq_group = self.inner_ranks, self.inner_group
        self.seq_exchange = GroupExchange(self.seq_group, self.seq_ranks, dist.get_backend())


class TPLayout(_GridLayout):
    """This rank's place in a ``(data, model)`` layout of ``world_size``
    ranks with model groups of ``tensor_parallelism``:
    ``data_idx``/``n_data``, ``model_idx``/``n_model``, the process groups
    ``data_group`` and ``model_group``, ``tensor_group``, the model group as
    the modules' :class:`.tensor.TensorGroup` (``None`` at
    ``tensor_parallelism`` 1), and ``zero_group``, the data group as ZeRO's
    (:class:`.tensor.ZeroPlan`).  At ``tensor_parallelism`` 1 the layout
    serves pure ZeRO: the data group is the whole world."""

    def __init__(self, world_size: int, rank: int, tensor_parallelism: int):
        super().__init__(world_size, rank, tensor_parallelism, MODEL_AXIS)
        self.n_model, self.model_idx = self.n_inner, self.inner_idx
        self.model_ranks, self.model_group = self.inner_ranks, self.inner_group
        self.tensor_group = (TensorGroup(self.model_group, self.n_model, self.model_idx)
                             if self.n_model > 1 else None)
        self.zero_group = TensorGroup(self.data_group, self.n_data, self.data_idx)


class PPLayout:
    """This rank's place in a ``(data, stage)`` layout of ``world_size``
    ranks with pipelines of ``pipeline_parallelism`` stages, grown by a
    ``model`` axis of ``tensor_parallelism`` or a ``sequence`` axis of
    ``sequence_parallelism`` ranks (JAX ``make_pp_mesh``: data outermost,
    then stage, the inner axis innermost, so ``rank = (data_idx * S +
    stage_idx) * I + inner_idx``; both inner axes at once raise JAX's
    message).  Its groups:

    - ``stage_group`` (``stage``, a :class:`.tensor.TensorGroup`): the ranks
      of the same data and inner index; ``stage_exchange`` hops to the next
      and the previous stage over it (:class:`.pipeline.StageExchange`,
      its peers global ranks, staged through pinned host memory on gloo);
    - ``data_group``: the ranks of the same stage and inner index, the
      step's reduce and ZeRO's group (``zero_group``);
    - the model group (``model_group``, ``tensor_group`` a
      :class:`.tensor.TensorGroup`, ``None`` at 1) or the sequence group
      (``seq_group`` and ``seq_exchange``, ring attention's
      :class:`.sequence.GroupExchange`, ``None`` at 1).

    Every rank builds every group in one order (``dist.new_group`` requires
    it): the stage groups, the data groups, then the inner groups; with no
    inner axis the ranks and groups are the 2-axis layout's."""

    def __init__(self, world_size: int, rank: int, pipeline_parallelism: int,
                 tensor_parallelism: int = 1, sequence_parallelism: int = 1):
        S, T, Q = int(pipeline_parallelism), int(tensor_parallelism), int(sequence_parallelism)
        if T > 1 and Q > 1:
            raise ValueError("pipeline x tensor x sequence (3 inner axes) is not wired; "
                             "pick PP x TP or PP x SP")
        n = S * T * Q
        if S < 1 or T < 1 or Q < 1 or world_size % n != 0:
            raise ValueError(f"{world_size} ranks not divisible by stage x inner ({n})")
        inner = T * Q
        self.n_stage, self.n_inner, self.n_data = S, inner, world_size // n
        self.data_idx, rest = divmod(rank, S * inner)
        self.stage_idx, self.inner_idx = divmod(rest, inner)
        at = lambda d, s, i: (d * S + s) * inner + i  # noqa: E731
        d0, s0, i0 = self.data_idx, self.stage_idx, self.inner_idx
        self.stage_ranks = [at(d0, s, i0) for s in range(S)]
        self.data_ranks = [at(d, s0, i0) for d in range(self.n_data)]
        self.inner_ranks = [at(d0, s0, i) for i in range(inner)]
        self.stage_group = self.data_group = self.inner_group = None
        for d in range(self.n_data):
            for i in range(inner):
                group = dist.new_group([at(d, s, i) for s in range(S)])
                if (d, i) == (d0, i0):
                    self.stage_group = group
        for s in range(S):
            for i in range(inner):
                group = dist.new_group([at(d, s, i) for d in range(self.n_data)])
                if (s, i) == (s0, i0):
                    self.data_group = group
        if inner > 1:
            for d in range(self.n_data):
                for s in range(S):
                    group = dist.new_group([at(d, s, i) for i in range(inner)])
                    if (d, s) == (d0, s0):
                        self.inner_group = group
        backend = dist.get_backend()
        self.stage = TensorGroup(self.stage_group, S, s0)
        self.stage_exchange = StageExchange(self.stage_group, self.stage_ranks, backend)
        self.zero_group = TensorGroup(self.data_group, self.n_data, d0)
        self.n_model, self.model_idx = (T, i0) if T > 1 else (1, 0)
        self.n_seq, self.seq_idx = (Q, i0) if Q > 1 else (1, 0)
        self.model_group = self.inner_group if T > 1 else None
        self.tensor_group = TensorGroup(self.model_group, T, i0) if T > 1 else None
        self.seq_group = self.inner_group if Q > 1 else None
        self.seq_exchange = (GroupExchange(self.seq_group, self.inner_ranks, backend)
                             if Q > 1 else None)


def resolve_seq_axis(seq_axis):
    """The exchange of a model's ``seq_axis``: a :class:`GroupExchange` (or
    any object with its ``size``, ``rank`` and exchanges) as it is; a bare
    axis name raises."""
    if isinstance(seq_axis, str):
        raise ValueError(f"seq_axis {seq_axis!r} names no process group: pass the sequence "
                         "group's exchange (parallel.SPLayout(...).seq_exchange)")
    return seq_axis
