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
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

__all__ = ["COLUMN", "EXPERT", "REPLICATED", "ROW", "TensorGroup", "copy_to_model",
           "gather_param", "gather_state_dict", "param_role", "reduce_from_model",
           "shard_dim", "shard_param", "shard_state_dict"]

COLUMN, ROW, EXPERT, REPLICATED = "column", "row", "expert", "replicated"
# role -> the dim of the port's leaf that the model group splits
_SHARD_DIM = {COLUMN: 0, ROW: 1, EXPERT: 0}


class TensorGroup:
    """The model group a tensor-parallel module splits its leaves over:
    ``group`` (a process group of ``size`` ranks; this rank's place in it
    is ``rank``).  The runner takes it from :attr:`.mesh.TPLayout.tensor_group`."""

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
