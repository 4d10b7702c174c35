"""Megatron tensor parallelism and expert parallelism over a model group.

Port of ``pytorch_distributed_training_tpu/parallel/tensor.py``.  The JAX
package annotates each parameter with a ``PartitionSpec`` over the mesh
``model`` axis and lets the XLA partitioner insert the collectives; the port
writes them out over a ``torch.distributed`` process group, the model group
of :class:`.mesh.TPLayout` (``T`` consecutive ranks).

Roles, one rule by parameter name (:func:`param_role`, mirroring JAX
``_spec_for``; the port's ``Dense.weight`` is ``[out, in]``, flax's kernel
``[in, out]``):

  ==============================  ==========  =======================
  parameter                       role        shard of the full leaf
  ==============================  ==========  =======================
  ``attn.qkv`` weight / bias      column      rows / entries (dim 0)
  ``attn.proj`` weight            row         columns (dim 1)
  ``mlp.fc1`` weight / bias       column      rows / entries (dim 0)
  ``mlp.fc2`` weight              row         columns (dim 1)
  ``moe.wi/bi/wo/bo``             expert      experts (dim 0)
  everything else                 replicated  the whole leaf
  ==============================  ==========  =======================

Rank ``r`` of ``T`` holds slice ``r`` of ``T`` equal slices along that dim
(:func:`shard_param`); :func:`gather_param` puts the full leaf back
together on every rank of the group.

Megatron's two functions over the model group (:func:`copy_to_model`,
:func:`reduce_from_model`):

- *copy* is the identity forward and an all-reduce (sum) of the gradient in
  the backward; it sits before every column-parallel layer (qkv, fc1, the
  MoE dispatch) and on the MoE gates, where each rank's backward sees only
  its own part of the gradient;
- *reduce* all-reduces (sums) its input in the forward and passes the
  gradient through unchanged in the backward; it sits after every
  row-parallel product (proj, fc2) and after the MoE combine.

``torch.distributed.nn.functional.all_reduce`` is not *reduce*: its backward
all-reduces again, which would multiply the gradient of everything before it
by ``T``.  With the pair in place every activation outside the sharded
products is whole and equal on the ranks of a model group, so the gradients
of the replicated leaves are whole and equal too, and need no reduce over
the model group.

Both reduce in the tensor's own dtype (bf16 on the bf16 stream, as the
partitioner reduces a bf16 dot's partial sums); gloo takes bf16.

**ZeRO** (JAX ``zero_shard_moment``, ``:79-97``) splits a leaf over the
**data** group as well: :func:`zero_shard_dim` is the first dimension of
the leaf in flax's layout that the model axis has not taken and that the
data size divides (the port's ``[out, in]`` Dense weights are flax's ``[in,
out]`` kernels transposed, so the rule reads them flipped; a Dense weight
usually splits along the port's dim 1).  A leaf with no such dimension stays
whole on every data rank.  :class:`ZeroPlan` holds that rule for a list of
leaves and moves their data-rank slices as one flat bucket a call, laid out
by owner (row ``j`` holds rank ``j``'s elements of every leaf, each in its
slice's own order), through two exchanges of the data group: a
reduce-scatter (sum) of full leaves into this rank's slices and an
all-gather of the slices into full leaves.  They call the process group's
``_reduce_scatter_base`` and ``_allgather_base``, which gloo takes for CPU
and CUDA tensors alike (f32 and bf16; ``chip_smoke.py`` phase 1 probes the
card's gloo) and NCCL for CUDA ones, on a group from ``dist.new_group`` and
on a bare ``ProcessGroupGloo`` (the tests' thread ranks) alike.
:func:`zero_gather` is the gather as an autograd Function: forward the
all-gather (optionally in a narrower dtype: casting the slice first moves
half the bytes and gives the same bits), backward the reduce-scatter of the
full gradient, summed in f32, into the slice's gradient (an all-reduce there
would multiply the gradient by the data size).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["COLUMN", "EXPERT", "REPLICATED", "ROW", "TensorGroup", "ZeroPlan", "copy_to_model",
           "gather_param", "gather_state_dict", "param_role", "reduce_from_model",
           "shard_dim", "shard_param", "shard_state_dict", "zero_gather", "zero_shard_dim"]

COLUMN, ROW, EXPERT, REPLICATED = "column", "row", "expert", "replicated"
# role -> the dim of the port's leaf that the model group splits
_SHARD_DIM = {COLUMN: 0, ROW: 1, EXPERT: 0}


class TensorGroup:
    """The model group a tensor-parallel module splits its leaves over:
    ``group`` (a process group of ``size`` ranks; this rank's place in it
    is ``rank``).  The runner takes it from :attr:`.mesh.TPLayout.tensor_group`;
    ZeRO's data group is one too (:attr:`.mesh.TPLayout.zero_group`)."""

    def __init__(self, group, size: Optional[int] = None, rank: Optional[int] = None):
        self.group = group
        self.size = int(group.size() if size is None else size)
        self.rank = int(group.rank() if rank is None else rank)

    def __repr__(self) -> str:
        return f"TensorGroup(rank {self.rank} of {self.size})"


def param_role(name: str) -> str:
    """The role of the port's LM leaf ``name`` (a ``state_dict`` key), by
    JAX ``_spec_for``'s rule on the module path (module docstring)."""
    keys = name.split(".")
    leaf = keys[-1]
    if "attn" in keys:
        if "qkv" in keys:
            return COLUMN
        if "proj" in keys and leaf == "weight":
            return ROW
    if "mlp" in keys:
        if "fc1" in keys:
            return COLUMN
        if "fc2" in keys and leaf == "weight":
            return ROW
    if "moe" in keys and leaf in ("wi", "wo", "bi", "bo"):
        return EXPERT
    return REPLICATED


def shard_dim(name: str) -> Optional[int]:
    """The dim of leaf ``name`` that the model group splits; ``None`` for a
    replicated leaf."""
    return _SHARD_DIM.get(param_role(name))


def shard_param(full: torch.Tensor, dim: Optional[int], size: int, rank: int) -> torch.Tensor:
    """Slice ``rank`` of ``size`` equal slices of ``full`` along ``dim`` (a
    contiguous copy; ``full`` itself when ``dim`` is ``None``)."""
    if dim is None or size == 1:
        return full
    n = full.shape[dim]
    if n % size != 0:
        raise ValueError(f"a leaf of shape {tuple(full.shape)} does not split into {size} "
                         f"equal slices along dim {dim}")
    part = n // size
    return full.narrow(dim, rank * part, part).contiguous()


def gather_param(local: torch.Tensor, dim: Optional[int], tg: TensorGroup) -> torch.Tensor:
    """The full leaf from every rank's slice along ``dim``, on every rank of
    the group (``local`` itself when ``dim`` is ``None``)."""
    if dim is None or tg.size == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(tg.size)]
    dist.all_gather(parts, local.contiguous(), group=tg.group)
    return torch.cat(parts, dim)


def shard_state_dict(full: Mapping[str, torch.Tensor], tg: Optional[TensorGroup]
                     ) -> Dict[str, torch.Tensor]:
    """This rank's ``state_dict`` of a tensor-parallel LM from the full
    model's (:func:`param_role`'s rule)."""
    if tg is None:
        return dict(full)
    return {k: shard_param(v, shard_dim(k), tg.size, tg.rank) for k, v in full.items()}


def gather_state_dict(local: Mapping[str, torch.Tensor], tg: Optional[TensorGroup]
                      ) -> Dict[str, torch.Tensor]:
    """The full model's ``state_dict`` from this rank's, on every rank of
    the group (a collective: every rank calls it, with the same keys)."""
    if tg is None:
        return dict(local)
    return {k: gather_param(v, shard_dim(k), tg) for k, v in local.items()}


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (a fresh contiguous tensor, ``t`` kept)."""
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, tg: Optional[TensorGroup]) -> torch.Tensor:
    """Megatron's *copy* (module docstring); ``x`` itself off a group."""
    if tg is None or tg.size == 1:
        return x
    return _CopyToModel.apply(x, tg.group)


def reduce_from_model(x: torch.Tensor, tg: Optional[TensorGroup]) -> torch.Tensor:
    """Megatron's *reduce* (module docstring); ``x`` itself off a group."""
    if tg is None or tg.size == 1:
        return x
    return _ReduceFromModel.apply(x, tg.group)


# --------------------------------------------------------------------- ZeRO


def zero_shard_dim(name: str, shape: Sequence[int], n_data: int,
                   model_axis: bool = True) -> Optional[int]:
    """The dim of the port's leaf ``name`` (of ``shape``, whole or this model
    rank's slice: the dims the rule may take are the same in both) that ZeRO
    splits over ``n_data`` data ranks, by JAX ``zero_shard_moment``'s rule
    (module docstring); ``None``: the leaf stays whole, as it does at one data
    rank.  ``model_axis``: whether the leaf's spec carries the model axis
    (the GSPMD path's always does; a pipeline's blocks only under tensor
    parallelism, JAX ``pp_param_specs``, whose stacked layer axis the
    port's per-layer leaf does not have)."""
    if n_data <= 1:
        return None
    nd = len(shape)
    # a Dense weight [out, in] is flax's kernel [in, out] transposed
    flip = nd == 2 and name.rsplit(".", 1)[-1] == "weight"
    # taken by the model axis, at any degree (JAX keeps the spec)
    model = shard_dim(name) if model_axis else None
    for flax_dim in range(nd):
        d = nd - 1 - flax_dim if flip else flax_dim
        if d != model and shape[d] % n_data == 0:
            return d
    return None


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``out`` = this rank's ``1/n`` of ``inp`` summed over ``group``."""
    opts = dist.ReduceScatterOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    group._reduce_scatter_base(out, inp, opts).wait()


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``out`` = every rank's ``inp`` of ``group``, in rank order."""
    group._allgather_base(out, inp).wait()


class ZeroPlan:
    """ZeRO's layout of the leaves ``names`` (of ``shapes``, this model
    rank's) over the data group ``dg`` (a :class:`TensorGroup`): ``dims[i]``
    (:func:`zero_shard_dim`, under ``model_axis``), ``part_shapes[i]`` (this rank's slice),
    ``sharded`` (the indices that split) and the exchanges of the module
    docstring.  Every method that exchanges is a collective: every rank of
    the data group calls it, in the same order."""

    def __init__(self, names: Sequence[str], shapes: Sequence[Sequence[int]], dg: TensorGroup,
                 model_axis: bool = True):
        self.dg = dg
        self.names = list(names)
        shapes = [tuple(int(x) for x in s) for s in shapes]
        self.dims = [zero_shard_dim(n, s, dg.size, model_axis) for n, s in zip(self.names, shapes)]
        self.part_shapes = []
        for shape, d in zip(shapes, self.dims):
            part = list(shape)
            if d is not None:
                part[d] //= dg.size
            self.part_shapes.append(tuple(part))
        self.sharded = [i for i, d in enumerate(self.dims) if d is not None]
        self.index = {n: i for i, n in enumerate(self.names)}

    def slice(self, full: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of leaf ``i`` from the full leaf (a copy; the
        leaf itself where it stays whole)."""
        return shard_param(full, self.dims[i], self.dg.size, self.dg.rank)

    def _rows(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i`` ``[..., n * part, ...]`` as ``[n, ...part...]``: row
        ``j`` rank ``j``'s slice (a view)."""
        d, n = self.dims[i], self.dg.size
        return t.unflatten(d, (n, t.shape[d] // n)).movedim(d, 0)

    def scatter_sum(self, fulls: Sequence[torch.Tensor], idx: Sequence[int]) -> List[torch.Tensor]:
        """The reduce-scatter: the sharded leaves ``idx`` in full (``fulls``)
        summed in f32 over the data group, this rank's slice of each."""
        n = self.dg.size
        sizes = [math.prod(self.part_shapes[i]) for i in idx]
        total = sum(sizes)
        bucket = torch.empty((n, total), dtype=torch.float32, device=fulls[0].device)
        off = 0
        for t, i, k in zip(fulls, idx, sizes):
            bucket[:, off:off + k].view((n,) + self.part_shapes[i]).copy_(self._rows(t, i))
            off += k
        out = torch.empty(total, dtype=torch.float32, device=bucket.device)
        _reduce_scatter(out, bucket.view(-1), self.dg.group)
        return [v.view(self.part_shapes[i]) for v, i in zip(out.split(sizes), idx)]

    def _gathered(self, parts: Sequence[torch.Tensor], idx: Sequence[int], dtype):
        """The all-gather of the slices ``parts`` of the leaves ``idx`` (in
        ``dtype``): ``[n, total]`` and each leaf's column range."""
        n = self.dg.size
        local = torch.cat([p.reshape(-1).to(dtype) for p in parts])
        out = torch.empty((n, local.numel()), dtype=dtype, device=local.device)
        _all_gather(out.view(-1), local, self.dg.group)
        spans, off = [], 0
        for i in idx:
            k = math.prod(self.part_shapes[i])
            spans.append(out[:, off:off + k].view((n,) + self.part_shapes[i]))
            off += k
        return spans

    def gather(self, parts: Sequence[torch.Tensor], idx: Sequence[int],
               dtypes: Optional[Sequence] = None) -> List[torch.Tensor]:
        """The all-gather: the full leaves ``idx`` from this rank's slices
        ``parts`` (leaf ``i`` in ``dtypes[i]``, by default its slice's), as
        new tensors.  One exchange a dtype."""
        dtypes = [p.dtype for p in parts] if dtypes is None else list(dtypes)
        out: List[Optional[torch.Tensor]] = [None] * len(idx)
        for dtype in dict.fromkeys(dtypes):
            pick = [j for j, dt in enumerate(dtypes) if dt == dtype]
            spans = self._gathered([parts[j] for j in pick], [idx[j] for j in pick], dtype)
            for j, span in zip(pick, spans):
                d = self.dims[idx[j]]
                out[j] = span.movedim(0, d).flatten(d, d + 1)
        return out

    def gather_into(self, fulls: Sequence[torch.Tensor], parts: Sequence[torch.Tensor],
                    idx: Sequence[int]) -> None:
        """The all-gather written into the full leaves ``fulls`` in place."""
        for t, span, i in zip(fulls, self._gathered(parts, idx, fulls[0].dtype), idx):
            self._rows(t, i).copy_(span)

    def gather_all(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every leaf of the plan in full from this rank's (a sharded leaf's
        slice gathered, a whole leaf as it is)."""
        out = list(leaves)
        if self.sharded:
            for i, t in zip(self.sharded, self.gather([leaves[i] for i in self.sharded],
                                                     self.sharded)):
                out[i] = t
        return out


class _ZeroGather(torch.autograd.Function):
    """The all-gather forward, the reduce-scatter (f32 sum) backward."""

    @staticmethod
    def forward(ctx, plan, idx, dtypes, *parts):
        ctx.plan, ctx.idx = plan, idx
        return tuple(plan.gather(parts, idx, dtypes))

    @staticmethod
    def backward(ctx, *grads):
        parts = ctx.plan.scatter_sum([g.float() for g in grads], ctx.idx)
        return (None, None, None, *parts)


def zero_gather(plan: ZeroPlan, idx: Sequence[int], parts: Sequence[torch.Tensor],
                dtypes: Optional[Sequence] = None) -> List[torch.Tensor]:
    """ZeRO-3's gather at a use site (module docstring): the full leaves
    ``idx`` of ``plan`` from this rank's slices ``parts``; their gradients
    reduce-scatter back into the slices' (summed over the data group)."""
    if not idx:
        return []
    dtypes = tuple(p.dtype for p in parts) if dtypes is None else tuple(dtypes)
    return list(_ZeroGather.apply(plan, tuple(idx), dtypes, *parts))
