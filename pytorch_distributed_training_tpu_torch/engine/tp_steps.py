"""The GSPMD-path LM step at one rank of the model axis (port of
``engine/tp_steps.py:52-240``).

The JAX path (``engine/paths.py:140-181``) takes a ``TransformerLM`` with
``training.tensor_parallelism`` > 1, ``training.zero`` or MoE blocks and
lets the XLA partitioner distribute one straight-line program.  The port
runs it at tensor (= expert) parallelism 1 and no ZeRO, which is what a
MoE model on data parallelism needs; the runner still refuses
``training.tensor_parallelism`` > 1 and ``training.zero`` with a
``NotImplementedError`` naming ROADMAP item P9.

The step is :class:`.sp_steps.LMTrainStep` (its micro-batch slicing, its
one all-reduce of the gradients and the loss, its optimizer update) with
the JAX objective (``tp_steps.py:104-122``): a micro-batch's mean CE
through the fused CE kernels **plus every MoE block's aux term**.  Under
``grad_accum`` N each micro-batch routes and computes its aux on its own,
and the step averages the per-micro objectives and gradients
(``:126-171``).  At world size W > 1 the aux terms use the statistics of
the whole micro-batch over every rank, as GSPMD computes them: the
blocks' top-1 counts and probability sums are summed over the ranks by
one differentiable all-reduce (``torch.distributed.nn.functional``) before
the product, and each rank adds ``1/W`` of the (equal) global term, so
that the gradients' all-reduce sums each rank's share of the aux gradient
once.  The loss returned is the global objective.

Validation is pure CE with top-1/top-5 (``:207-240``): the eval step of
:mod:`.sp_steps` serves both paths (routing is per batch row, so it needs
no collective).
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
    """The GSPMD-path LM training step at one rank of the model axis (see
    the module docstring)."""
    return TPLMTrainStep(model, optimizer, lr_fn, world_size, group, label_smoothing,
                         grad_accum)
