"""The GSPMD-path LM step (port of ``engine/tp_steps.py:52-240``).

The JAX path (``engine/paths.py:140-181``) takes a ``TransformerLM`` with
``training.tensor_parallelism`` > 1, ``training.zero`` or MoE blocks and
lets the XLA partitioner distribute one straight-line program over a
``(data, model)`` mesh.  The port writes the distribution out: the ranks
form a :class:`..parallel.mesh.TPLayout`, the model is one rank's shard of
a Megatron tensor-parallel model over its model group (MoE blocks at expert
parallelism over the same group; :mod:`..parallel.tensor`), and every rank
of a model group takes the same tokens, as ``P(data, None)`` gives them.

``training.zero`` (JAX ``tp_steps.py:52-205``, ``parallel/tensor.py:79-191``)
shards the state over the **data** group by :func:`..parallel.tensor.zero_shard_dim`'s
rule (:class:`..parallel.tensor.ZeroPlan`); the stages add up, and the
update's math is the same in each:

- **1**: the optimizer moments live as this rank's slices.  After the last
  micro-batch the sharded leaves' gradients are reduce-scattered into this
  rank's slices (the whole leaves' all-reduced with the loss, as at stage
  0), the optimizer runs on the slices of the parameters and moments, and
  the fresh slices are all-gathered into the full parameters;
- **2**: the gradient buffers too: each micro-batch's gradients are
  reduce-scattered right after its backward and added into a slice
  accumulator, so no full gradient is carried across micro-batches;
- **3**: the parameters too (the model is built with ``zero_group``,
  :class:`..models.TransformerLM`): each use all-gathers them and the
  backward reduce-scatters their gradients into the slices, so the update
  runs on the slices with no gather at all.

At one data rank nothing changes (JAX ``n_data > 1``).  LARS and LAMB take
their trust ratios over whole leaves: the step hands them ``whole_norms``,
which sums a leaf's squares over the model group where tensor parallelism
splits it and over the data group where ZeRO does (JAX
``optimizers/__init__.py:231-282``, ``:392-460``).

The step is :class:`.sp_steps.LMTrainStep` (its micro-batch slicing, its
one all-reduce of the gradients and the loss, its optimizer update) with
the JAX objective (``tp_steps.py:104-122``): a micro-batch's mean CE
through the fused CE kernels **plus every MoE block's aux term**.  Its
``world_size`` and ``group`` are the **data** group's: the gradients and
the loss are all-reduced over the data ranks only, and the global token
count is the data ranks' (each token counted once, not once a model rank).
A sharded leaf's gradient is this rank's slice of the full gradient.  A
replicated leaf's gradient needs no reduce over the model group: the
copy/reduce pair makes every activation outside the sharded products whole
and equal on the ranks of a model group, so each of them already holds the
whole gradient.

Under ``grad_accum`` N each micro-batch routes and computes its aux on its
own, and the step averages the per-micro objectives and gradients
(``:126-171``).  At more than one data rank the aux terms use the
statistics of the whole micro-batch over the data ranks, as GSPMD computes
them: the blocks' top-1 counts and probability sums are summed over the
data group by one differentiable all-reduce
(``torch.distributed.nn.functional``) before the product, and each rank
adds ``1/W`` (W the data ranks) of the (equal) global term, so that the
gradients' all-reduce sums each rank's share of the aux gradient once.
The statistics are equal on the ranks of a model group (they route the
same tokens), so the model group needs no reduce of them.  The loss
returned is the global objective.

Validation is pure CE with top-1/top-5 (``:207-240``): the eval step of
:mod:`.sp_steps` serves both paths, reduced over the data group (routing
is per batch row, so it needs no collective).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ..parallel.tensor import TensorGroup, ZeroPlan, shard_dim
from .sp_steps import LMTrainStep, _all_reduce_sum_, _grad, _nbytes, lm_loss_local

__all__ = ["TPLMTrainStep", "build_tp_lm_train_step"]


class TPLMTrainStep(LMTrainStep):
    """``step(tokens, labels) -> loss`` with the MoE aux terms in the
    objective (see the module docstring); a dense model adds nothing.
    After a step, ``aux`` is its aux objective (the global terms averaged
    over the micro-batches, already in the loss), a device scalar.

    ``zero`` is the ZeRO stage over the data group (module docstring);
    ``zero_plan`` its layout of the parameters (``None`` at stage 0 or one
    data rank), which the optimizer state's slots follow from stage 1 on.
    After a step, ``grad_bytes`` is what the gradient buffers carried
    across its micro-batches held (:meth:`state_bytes`): the full gradients
    at stages 0 and 1, the slices (and the whole leaves') from stage 2 on."""

    aux = None
    zero_plan: Optional[ZeroPlan] = None

    def __init__(self, model, optimizer, lr_fn: Callable[[int], float], world_size: int = 1,
                 group=None, label_smoothing: float = 0.0, grad_accum: int = 1, zero: int = 0):
        if int(zero) not in (0, 1, 2, 3):
            raise ValueError(f"zero must be a stage in (0, 1, 2, 3), got {zero!r}")
        self.zero = int(zero) if int(world_size) > 1 else 0
        if (self.zero >= 3) != (getattr(model, "zero_plan", None) is not None):
            raise ValueError("ZeRO-3 takes a model built with zero_group (its leaves live "
                             "sharded), and only ZeRO-3 does")
        self._acc: Optional[List[torch.Tensor]] = None
        super().__init__(model, optimizer, lr_fn, world_size, group, label_smoothing, grad_accum)

    def init_opt_state(self):
        names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        if self.zero >= 3:
            self.zero_plan = self.model.zero_plan
            if self.zero_plan.names != names or self.zero_plan.dg.size != self.world_size:
                raise ValueError("the model's ZeRO-3 leaves are not this step's data group's")
        elif self.zero:
            self.zero_plan = ZeroPlan(names, [p.shape for p in self.params],
                                      TensorGroup(self.group, self.world_size))
        plan, tg = self.zero_plan, self.model.tensor_group
        self._data_split = [plan is not None and plan.dims[i] is not None
                            for i in range(len(names))]
        self._model_split = [tg is not None and tg.size > 1 and shard_dim(n) is not None
                             for n in names]
        held = self.params
        if self.zero in (1, 2):
            held = [p.new_empty(plan.part_shapes[i]) if plan.dims[i] is not None else p
                    for i, p in enumerate(self.params)]
        return self.optimizer.init(held)

    def __call__(self, tokens, labels, gnorm_ref=None):
        self.aux = torch.zeros((), device=tokens.device)
        self._acc = None
        return super().__call__(tokens, labels, gnorm_ref)

    def after_backward(self) -> None:
        """ZeRO-2: this micro-batch's sharded gradients reduce-scattered into
        the slice accumulator, their full buffers freed."""
        if self.zero != 2:
            return
        idx = self.zero_plan.sharded
        parts = self.zero_plan.scatter_sum([_grad(self.params[i]) for i in idx], idx)
        if self._acc is None:
            self._acc = parts
        else:
            torch._foreach_add_(self._acc, parts)
        for i in idx:
            self.params[i].grad = None

    def reduce_grads(self, loss):
        if not self.zero:
            return super().reduce_grads(loss)
        plan, n = self.zero_plan, len(self.params)
        whole = [i for i in range(n) if plan.dims[i] is None]
        grads: List[Optional[torch.Tensor]] = [None] * n
        for i in whole:
            grads[i] = _grad(self.params[i])
        idx = plan.sharded
        parts = (self._acc if self.zero == 2 and idx else
                 [_grad(self.params[i]) for i in idx])  # stage 1: full, stage 3: slices
        self.grad_bytes = _nbytes([grads[i] for i in whole] + list(parts))
        _all_reduce_sum_([grads[i] for i in whole] + [loss.reshape(1)], self.group)
        if self.zero == 1 and idx:
            parts = plan.scatter_sum(parts, idx)
        for i, g in zip(idx, parts):
            grads[i] = g
        self._acc = None
        return grads

    def update(self, grads, lr) -> None:
        kw = {}
        if getattr(self.optimizer, "per_leaf_norms", False) and (
                any(self._model_split) or any(self._data_split)):
            kw["whole_norms"] = self._whole_norms
        if self.zero in (0, 3):
            self.opt_state = self.optimizer.update(self.params, grads, self.opt_state, lr, **kw)
            return
        plan = self.zero_plan
        idx = plan.sharded
        held = list(self.params)
        with torch.no_grad():
            parts = [plan.slice(self.params[i], i).clone() for i in idx]
        for i, t in zip(idx, parts):
            held[i] = t
        self.opt_state = self.optimizer.update(held, grads, self.opt_state, lr, **kw)
        if idx:
            with torch.no_grad():
                plan.gather_into([self.params[i] for i in idx], parts, idx)

    def _whole_norms(self, norms, idx):
        """The whole leaves' norms from this rank's parts' (``[k,
        len(idx)]``): squares summed over the model group where tensor
        parallelism splits a leaf, then over the data group where ZeRO does."""
        tg = self.model.tensor_group
        for split, group in ((self._model_split, tg.group if tg is not None else None),
                             (self._data_split, self.group)):
            pick = [split[i] for i in idx]
            if not any(pick):
                continue
            mask = torch.tensor(pick, device=norms.device)
            sq = torch.where(mask, norms.square(), torch.zeros_like(norms))
            dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=group)
            norms = torch.where(mask, sq.sqrt(), norms)
        return norms


    def micro_loss(self, tokens, labels, global_tokens: int):
        logits, stats = self.model(tokens, moe_stats=True)
        part = lm_loss_local(logits, labels, global_tokens, self.label_smoothing)
        del logits
        if not stats:
            return part
        stats = torch.stack(stats)
        if self.world_size > 1:
            from torch.distributed.nn.functional import all_reduce

            stats = all_reduce(stats, group=self.group)
        micro_tokens = labels.numel() * self.world_size
        # this micro-batch's share of the step: its global tokens over the step's
        share = micro_tokens / global_tokens
        aux = self.model.moe_aux(stats, micro_tokens) * share
        self.aux += aux.detach()
        return part + aux / self.world_size


def build_tp_lm_train_step(model, optimizer, lr_fn: Callable[[int], float], world_size: int = 1,
                           group=None, label_smoothing: float = 0.0,
                           grad_accum: int = 1, zero: int = 0) -> TPLMTrainStep:
    """The GSPMD-path LM training step of one rank; ``world_size`` and
    ``group`` are its data group's, ``zero`` the ZeRO stage over it (see
    the module docstring)."""
    return TPLMTrainStep(model, optimizer, lr_fn, world_size, group, label_smoothing,
                         grad_accum, zero)
