"""Image training and evaluation steps at data parallelism.

Port of ``engine/steps.py`` (train ``:112-365``, eval ``:368-395``), the
image path ``engine/paths.py:255-287`` builds.  The JAX step is one
compiled ``shard_map`` program; here each rank is one process on one card:

1. the NHWC batch as ``[N, C, H, W]`` by ``permute(0, 3, 1, 2)`` (on the
   card a ``channels_last`` view, no copy), forward in train mode (the
   BatchNorms update their running statistics, over every rank with
   ``sync_bn``);
2. the local mean CE through the fused CE kernels (K1a/K1b), scaled by
   ``1 / world``, so that the sum over ranks is the global mean;
3. backward, then one flat all-reduce (sum) of the gradients and the loss,
   which is the gradient of the global mean, as differentiating the JAX
   ``pmean`` gives; without ``sync_bn`` the BatchNorm buffers ride in the
   same all-reduce pre-scaled by ``1 / world``: each rank's statistics
   diverge, and their average keeps the ranks equal (``steps.py:256-261``);
   world size 1 skips it;
4. the optimizer (SGD, LARS or AdamW) in place at ``lr_fn(step)``;
5. with ``ema_decay`` ``d`` (config ``training.ema.decay``), the weight
   EMA ``ema <- d * ema + (1 - d) * params`` (JAX ``_ema_outside``,
   ``steps.py:318-331``): ``1 - d`` taken in Python double and applied in
   f32, as the JAX package's weak-typed scalar is, and rounded as XLA
   rounds it (:meth:`ImageTrainStep.update_ema`).  The EMA starts as a
   copy of the f32 parameters (JAX ``engine/paths.py:269-275``).

A model without BatchNorm (the ViTs) has no buffers to average, copy
back or sync: those lists are empty and their passes are skipped.

``input_norm = (mean, std)`` takes a uint8 NHWC batch and normalises it
on the card before the permute, as ``x.float() * scale + bias`` with the
native host kernel's f32 ``scale = 1 / (255 std)`` and ``bias = -mean /
std`` (``steps.py:88-110``, ``training.device_normalize``); without it
the batch is already normalised float.

``grad_accum`` N > 1 (``steps.py:183-230``) runs the local batch as N
micro-batches in turn, each normalised on its own (a uint8 batch is never
converted whole), each one's loss and gradients divided by N; the
BatchNorm running statistics update once per micro-batch, as the JAX
scan threads them.  The one all-reduce comes after the last micro-batch
(DDP's ``no_sync``; the JAX step reduces each micro-batch, the same sum
reassociated).  A local batch that N does not divide raises the JAX
package's ``ValueError``.

``anomaly_factor`` arms the anomaly-step guard (``steps.py:263-300``,
:func:`.sp_steps.guard_verdict`): ``step(img, labels, gnorm_ref)``
returns ``(loss, gnorm, applied)``.  The BatchNorm buffers are copied
before the forward; the verdict is read once, after the all-reduce and
before the optimizer; a skipped step runs neither the optimizer nor the
EMA and copies the buffers back, so parameters, buffers, momentum, EMA and
``opt_state.step`` stay bitwise as they were.  A NaN batch on one rank
alone makes the reduced gradient NaN on every rank, so all ranks skip.

:func:`build_eval_step_exact` is ``validation.exact`` (``steps.py:397-430``):
per-sample sums under a validity mask, so wrap-padded samples count for
nothing.

Not ported yet, raising ``NotImplementedError`` with its ROADMAP item:
``comm.overlap`` (P9).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..metrics import accuracy
from ..ops.batch_norm import DistributedBatchNorm
from ..ops.fused_ce import fused_ce_forward
from ..ops.losses import cross_entropy_loss
from .sp_steps import _all_reduce_sum_, guard_verdict, micro_slices

__all__ = ["ImageTrainStep", "build_eval_step", "build_eval_step_exact", "build_train_step",
           "input_normalizer"]


def _nchw(img: torch.Tensor) -> torch.Tensor:
    """The ``[N, H, W, C]`` batch as ``[N, C, H, W]``, a view."""
    return img.permute(0, 3, 1, 2)


def input_normalizer(input_norm) -> Callable[[torch.Tensor], torch.Tensor]:
    """The identity for ``input_norm=None``; else ``(mean, std)`` per channel
    becomes ``img -> img.float() * scale + bias`` (f32), the constants moved
    to each device once."""
    if input_norm is None:
        return lambda img: img
    mean, std = (np.asarray(x, np.float32) for x in input_norm)
    scale = torch.from_numpy((1.0 / (255.0 * std)).astype(np.float32))
    bias = torch.from_numpy((-mean / std).astype(np.float32))
    on: Dict[torch.device, tuple] = {}

    def normalize(img: torch.Tensor) -> torch.Tensor:
        consts = on.get(img.device)
        if consts is None:
            consts = on[img.device] = (scale.to(img.device), bias.to(img.device))
        return img.float() * consts[0] + consts[1]

    return normalize


class ImageTrainStep:
    """One training iteration: ``step(img, labels) -> loss``, or with the
    guard armed ``step(img, labels, gnorm_ref) -> (loss, gnorm, applied)``.

    ``img`` is this rank's ``[B_local, H, W, 3]`` batch, float or (with
    ``input_norm``) uint8, and ``labels`` its ``[B_local]`` integer
    classes.  The parameters and the
    BatchNorm buffers of ``model`` are updated in place; ``opt_state``
    carries the optimizer's state and its step count, which also indexes
    ``lr_fn``; ``ema`` the weight EMA, one tensor a parameter (``None``
    without ``ema_decay``).
    """

    def __init__(self, model, optimizer, lr_fn: Callable[[int], float], world_size: int = 1,
                 group=None, sync_bn: bool = False, label_smoothing: float = 0.0,
                 input_norm=None, ema_decay: Optional[float] = None, grad_accum: int = 1,
                 anomaly_factor: Optional[float] = None):
        if int(grad_accum) < 1:
            raise ValueError(f"grad_accumulation must be >= 1, got {grad_accum}")
        self.model = model
        self.grad_accum = int(grad_accum)
        self.anomaly_factor = None if anomaly_factor is None else float(anomaly_factor)
        self.normalize = input_normalizer(input_norm)
        self.optimizer = optimizer
        self.lr_fn = lr_fn
        self.world_size = int(world_size)
        self.group = group
        self.sync_bn = bool(sync_bn)
        self.label_smoothing = float(label_smoothing)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.bn_buffers = [b for m in model.modules() if isinstance(m, DistributedBatchNorm)
                           for b in (m.running_mean, m.running_var)]
        self.opt_state = optimizer.init(self.params)
        self.ema_decay = None if ema_decay is None else float(ema_decay)
        self.ema = (None if ema_decay is None else
                    [p.detach().clone(memory_format=torch.preserve_format) for p in self.params])

    @torch.no_grad()
    def update_ema(self) -> None:
        """``ema <- d * ema + (1 - d) * params`` in two ``_foreach`` passes:
        ``(1 - d) * params`` rounded, then ``+ d * ema`` as one multiply-add
        (``add`` with ``alpha``), the rounding of XLA's fused
        ``fma(d, ema, (1 - d) * params)``."""
        new = torch._foreach_mul(self.params, 1.0 - self.ema_decay)
        torch._foreach_add_(new, self.ema, alpha=self.ema_decay)
        self.ema = new

    def forward_backward(self, img, labels):
        """Forward in train mode, this rank's share of the loss and its
        backward, one micro-batch after another: ``(loss, logits)``, the
        gradients summed in ``p.grad``."""
        for p in self.params:
            p.grad = None
        self.model.train()
        share = self.world_size * self.grad_accum
        loss, logits = None, []
        for sl in micro_slices(img.shape[0], self.grad_accum, "per-device"):
            out = self.model(_nchw(self.normalize(img[sl])))
            part = cross_entropy_loss(out, labels[sl], self.label_smoothing) / share
            part.backward()
            loss = part.detach() if loss is None else loss + part.detach()
            logits.append(out.detach())
        return loss, logits[0] if len(logits) == 1 else torch.cat(logits)

    def __call__(self, img, labels, gnorm_ref: Optional[float] = None):
        guard = self.anomaly_factor is not None
        if guard:
            # the forward updates the running statistics (and without
            # sync_bn the all-reduce rewrites them): a skip puts these back
            bn_before = [b.clone() for b in self.bn_buffers]
        loss, _ = self.forward_backward(img, labels)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.world_size > 1:
            shared = grads + [loss.reshape(1)]
            if not self.sync_bn and self.bn_buffers:
                torch._foreach_mul_(self.bn_buffers, 1.0 / self.world_size)
                shared += self.bn_buffers
            _all_reduce_sum_(shared, self.group)
        applied = True
        if guard:
            gnorm, applied = guard_verdict(loss, grads, self.anomaly_factor,
                                           0.0 if gnorm_ref is None else gnorm_ref)
        if applied:
            lr = self.lr_fn(self.opt_state.step)
            self.opt_state = self.optimizer.update(self.params, grads, self.opt_state, lr)
            if self.ema is not None:
                self.update_ema()
        elif self.bn_buffers:
            with torch.no_grad():
                torch._foreach_copy_(self.bn_buffers, bn_before)
        for p in self.params:
            p.grad = None
        if not guard:
            return loss
        return loss, gnorm, applied


def build_train_step(model, optimizer, lr_fn: Callable[[int], float], world_size: int = 1,
                     group=None, sync_bn: bool = False, grad_accum: int = 1,
                     label_smoothing: float = 0.0, anomaly_factor: Optional[float] = None,
                     comm=None, input_norm=None,
                     ema_decay: Optional[float] = None) -> ImageTrainStep:
    """The image DP training step (see the module docstring).  ``sync_bn``
    says whether the model's BatchNorms average their statistics over the
    ranks (the model is built so); without it the step averages the
    buffers.  ``input_norm``: ``(mean, std)`` for uint8 batches;
    ``ema_decay``: keep the weight EMA; ``grad_accum``: micro-batches a
    step; ``anomaly_factor``: arm the guard."""
    if comm is not None and getattr(comm, "overlap", False):
        raise NotImplementedError("training.comm.overlap is ROADMAP port item P9")
    return ImageTrainStep(model, optimizer, lr_fn, world_size, group, sync_bn,
                          label_smoothing, input_norm, ema_decay, grad_accum, anomaly_factor)


def _eval_logits(model, img):
    """The model's logits in eval mode (running statistics), its mode restored."""
    was_training = model.training
    model.eval()
    try:
        return model(_nchw(img))
    finally:
        model.train(was_training)


def build_eval_step(model, world_size: int = 1, group=None, input_norm=None):
    """``eval_step(img, labels) -> (loss, acc1, acc5)`` on the running
    statistics: mean CE (unsmoothed) and top-1/top-5 accuracy in percent,
    each summed over the ranks and divided by the world size
    (``steps.py:372-380``)."""
    normalize = input_normalizer(input_norm)

    @torch.no_grad()
    def eval_step(img, labels):
        logits = _eval_logits(model, normalize(img))
        loss = cross_entropy_loss(logits, labels)
        acc1, acc5 = accuracy(logits, labels, topk=(1, 5))
        if world_size > 1:
            out = torch.stack([loss.float(), acc1, acc5])
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
            out = out / world_size
            return out[0], out[1], out[2]
        return loss, acc1, acc5

    return eval_step


def build_eval_step_exact(model, world_size: int = 1, group=None, input_norm=None):
    """``eval_step(img, labels, mask) -> [ce_sum, top1_sum, top5_sum, n]``
    (f32), summed over the ranks (``steps.py:397-430``).

    Per sample: the f32 CE (``nll`` of the fused CE forward, K1a), top-1
    and top-5 hits with k clamped to the class count; each times
    ``mask`` (1 for a real sample, 0 for a wrap-padded one) before the
    sums, so ``sums / n`` over a validation is exact for any set size.
    """
    normalize = input_normalizer(input_norm)

    @torch.no_grad()
    def eval_step(img, labels, mask):
        logits = _eval_logits(model, normalize(img)).float()
        ce, _ = fused_ce_forward(logits, labels)
        topk = torch.topk(logits, min(5, logits.shape[-1]), dim=-1).indices
        hits = topk == labels.long()[:, None]
        m = mask.float()
        out = torch.stack([(ce * m).sum(), (hits[:, 0].float() * m).sum(),
                           (hits.any(-1).float() * m).sum(), m.sum()])
        if world_size > 1:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    return eval_step
