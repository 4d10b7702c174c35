"""LM training and evaluation steps at plain data parallelism.

Port of ``engine/sp_steps.py`` at ``sequence_parallelism: 1``, the LM path
``engine/paths.py:184-205`` builds.  The JAX step is one compiled
``shard_map`` program whose objective is the ``psum`` of every shard's
partial loss; here each rank is one process on one card:

1. forward through the model (flash attention, the fused tails);
2. the local partial loss, ``mean CE x local tokens / global tokens``
   (:func:`lm_loss_local`), through the fused CE kernels;
3. backward, then one all-reduce (sum) of the flattened gradients over
   ``torch.distributed`` (NCCL on the card, gloo on the CPU) -- the sum of
   the partials' gradients is the gradient of the global mean, exactly what
   differentiating the JAX ``psum`` gives; world size 1 skips it;
4. the optimizer update in place, at ``lr_fn(step)``.

The loss returned is the global mean (the partials all-reduced), a device
scalar: reading it is the caller's only sync.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
``grad_accum > 1`` and the anomaly guard (P2b), ``comm.overlap`` and
``zero1`` (P9).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..metrics import accuracy
from ..ops.losses import cross_entropy_loss

__all__ = ["LMTrainStep", "build_lm_eval_step", "build_lm_train_step", "lm_loss_local"]


def lm_loss_local(logits, labels, global_tokens: int, label_smoothing: float = 0.0):
    """Local partial loss: mean per-token CE x local tokens / global tokens
    (f32), so the sum over ranks is the global mean (``sp_steps.py:48-60``)."""
    vocab = logits.shape[-1]
    local_mean = cross_entropy_loss(
        logits.reshape(-1, vocab), labels.reshape(-1), label_smoothing
    )
    return local_mean * (labels.numel() / global_tokens)


def _all_reduce_sum_(tensors, group=None) -> None:
    """Sum ``tensors`` across ranks in place, as one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


class LMTrainStep:
    """One training iteration: ``step(tokens, labels) -> loss``.

    ``tokens``/``labels`` are this rank's ``[B_local, S]`` integer batch
    (labels are the host-shifted next tokens).  The parameters of ``model``
    are updated in place; ``opt_state`` carries the optimizer's moments and
    its step count, which also indexes ``lr_fn``.
    """

    def __init__(self, model, optimizer, lr_fn: Callable[[int], float], world_size: int = 1,
                 group=None, label_smoothing: float = 0.0):
        self.model = model
        self.optimizer = optimizer
        self.lr_fn = lr_fn
        self.world_size = int(world_size)
        self.group = group
        self.label_smoothing = float(label_smoothing)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.opt_state = optimizer.init(self.params)

    def __call__(self, tokens, labels):
        b_local, s_len = tokens.shape
        global_tokens = b_local * s_len * self.world_size
        for p in self.params:
            p.grad = None
        logits = self.model(tokens)
        loss = lm_loss_local(logits, labels, global_tokens, self.label_smoothing)
        del logits
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        loss = loss.detach()
        if self.world_size > 1:
            _all_reduce_sum_(grads + [loss.reshape(1)], self.group)
        lr = self.lr_fn(self.opt_state.step)
        self.opt_state = self.optimizer.update(self.params, grads, self.opt_state, lr)
        for p in self.params:
            p.grad = None
        return loss


def build_lm_train_step(model, optimizer, lr_fn: Callable[[int], float], world_size: int = 1,
                        group=None, grad_accum: int = 1, label_smoothing: float = 0.0,
                        anomaly_factor: Optional[float] = None, comm=None,
                        zero1: bool = False) -> LMTrainStep:
    """The plain-DP LM training step (see the module docstring)."""
    if grad_accum != 1:
        raise NotImplementedError("training.grad_accumulation > 1 is ROADMAP port item P2b")
    if anomaly_factor is not None:
        raise NotImplementedError(
            "training.fault_tolerance.anomaly (the anomaly-step guard) is ROADMAP port item P2b"
        )
    if comm is not None and getattr(comm, "overlap", False):
        raise NotImplementedError("training.comm.overlap is ROADMAP port item P9")
    if zero1:
        raise NotImplementedError("ZeRO-1 weight-update sharding is ROADMAP port item P9")
    return LMTrainStep(model, optimizer, lr_fn, world_size, group, label_smoothing)


def build_lm_eval_step(model, world_size: int = 1, group=None):
    """``eval_step(tokens, labels) -> (loss, acc1, acc5)``: mean CE per
    token and next-token top-1/top-5 accuracy in percent, summed (loss) and
    averaged (accuracies) over ranks, as ``sp_steps.py:268-314``."""

    @torch.no_grad()
    def eval_step(tokens, labels):
        logits = model(tokens)
        vocab = logits.shape[-1]
        flat_logits, flat_labels = logits.reshape(-1, vocab), labels.reshape(-1)
        loss = lm_loss_local(logits, labels, flat_labels.numel() * world_size)
        acc1, acc5 = accuracy(flat_logits, flat_labels, topk=(1, 5))
        if world_size > 1:
            out = torch.stack([loss.float(), acc1, acc5])
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
            # equal local token counts: the sum over ranks / n is the mean
            return out[0], out[1] / world_size, out[2] / world_size
        return loss, acc1, acc5

    return eval_step
