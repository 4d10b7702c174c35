"""The GSPMD-path LM step (port of ``engine/tp_steps.py:52-240``).

The JAX path (``engine/paths.py:140-181``) takes a ``TransformerLM`` with
``training.tensor_parallelism`` > 1, ``training.zero`` or MoE blocks and
lets the XLA partitioner distribute one straight-line program over a
``(data, model)`` mesh.  The port writes the distribution out: the ranks
form a :class:`..parallel.mesh.TPLayout`, the model is one rank's shard of
a Megatron tensor-parallel model over its model group (MoE blocks at expert
parallelism over the same group; :mod:`..parallel.tensor`), and every rank
of a model group takes the same tokens, as ``P(data, None)`` gives them.
``training.zero`` still raises ``NotImplementedError`` naming ROADMAP item
P9.

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

from typing import Callable

import torch

from .sp_steps import LMTrainStep, lm_loss_local

__all__ = ["TPLMTrainStep", "build_tp_lm_train_step"]


class TPLMTrainStep(LMTrainStep):
    """``step(tokens, labels) -> loss`` with the MoE aux terms in the
    objective (see the module docstring); a dense model adds nothing.
    After a step, ``aux`` is its aux objective (the global terms averaged
    over the micro-batches, already in the loss), a device scalar."""

    aux = None

    def __call__(self, tokens, labels, gnorm_ref=None):
        self.aux = torch.zeros((), device=tokens.device)
        return super().__call__(tokens, labels, gnorm_ref)

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
                           grad_accum: int = 1) -> TPLMTrainStep:
    """The GSPMD-path LM training step of one rank; ``world_size`` and
    ``group`` are its data group's (see the module docstring)."""
    return TPLMTrainStep(model, optimizer, lr_fn, world_size, group, label_smoothing,
                         grad_accum)
