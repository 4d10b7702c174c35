"""LM training and evaluation steps, data and sequence parallel.

Port of ``engine/sp_steps.py``, the LM path ``engine/paths.py:184-205``
builds.  The JAX step is one compiled ``shard_map`` program over a (data,
sequence) mesh whose objective is the ``psum`` of every shard's partial
loss; here each rank is one process on one card, holding ``[B_local, S/n]``
tokens (n = ``sequence_parallelism``; the whole sequence at n = 1) and a
model whose attention runs over its sequence group (ring or Ulysses,
:mod:`..parallel.sequence`):

1. forward through the model (flash attention, the fused tails);
2. the local partial loss, ``mean CE x local tokens / global tokens``
   (:func:`lm_loss_local`; global tokens ``B_local x S/n x world size``),
   through the fused CE kernels;
3. backward (the ring's K/V cotangents travel back to their owners through
   the exchanges' backward), then one all-reduce (sum) of the flattened
   gradients over the whole world, data and sequence ranks alike
   (``torch.distributed``: NCCL on the card, gloo on the CPU) -- the sum of
   the partials' gradients is the gradient of the global mean, exactly what
   differentiating the JAX ``psum`` over (data, sequence) gives; world size
   1 skips it;
4. the optimizer update in place, at ``lr_fn(step)``.

The loss returned is the global mean (the partials all-reduced), a device
scalar: reading it is the caller's only sync.

``grad_accum`` N > 1 (``sp_steps.py:135-216``, config
``training.grad_accumulation``) runs the local batch as N micro-batches in
turn, each one's partial loss normalised by the whole step's global token
count, so the partials and their gradients sum (in ``p.grad``) to the
full batch's; the logits of a micro-batch are freed before its backward.
The one all-reduce comes after the last micro-batch, as DDP's ``no_sync``
does (the JAX step reduces every micro-batch: the same sum reassociated).
A local batch that N does not divide raises the JAX package's
``ValueError``.

``anomaly_factor`` arms the anomaly-step guard (:func:`guard_verdict`,
config ``training.fault_tolerance.anomaly``): the step takes the host's
trailing median ``gnorm_ref`` and returns ``(loss, gnorm, applied)``; a
skipped step leaves the parameters and the optimizer state (its step
count too) as they were.  Deciding costs one host read a step.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
``comm.overlap`` and ``zero1``, the ring path's ZeRO-1 beside it (P9;
``training.zero`` on the GSPMD path is :mod:`.tp_steps`).  The eval step
needs nothing for ZeRO-3: the model gathers its own leaves.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..metrics import accuracy
from ..ops.losses import cross_entropy_loss

__all__ = ["LMTrainStep", "build_lm_eval_step", "build_lm_train_step", "guard_verdict",
           "lm_loss_local"]


def lm_loss_local(logits, labels, global_tokens: int, label_smoothing: float = 0.0):
    """Local partial loss: mean per-token CE x local tokens / global tokens
    (f32), so the sum over ranks is the global mean (``sp_steps.py:48-60``)."""
    vocab = logits.shape[-1]
    local_mean = cross_entropy_loss(
        logits.reshape(-1, vocab), labels.reshape(-1), label_smoothing
    )
    return local_mean * (labels.numel() / global_tokens)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _grad(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient, zeros where no micro-batch reached it."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _all_reduce_sum_(tensors, group=None) -> None:
    """Sum ``tensors`` across ranks in place, as one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def micro_slices(batch: int, grad_accum: int, what: str):
    """The ``grad_accum`` equal slices of a local batch of ``batch``; a batch
    they do not divide raises the JAX package's ``ValueError``."""
    if batch % grad_accum != 0:
        raise ValueError(f"{what} batch {batch} not divisible by grad_accumulation {grad_accum}")
    micro = batch // grad_accum
    return [slice(i * micro, (i + 1) * micro) for i in range(grad_accum)]


def guard_verdict(loss, grads, factor: float, gnorm_ref: float):
    """The anomaly guard's decision on a reduced gradient (JAX
    ``steps.py:263-279``): ``gnorm``, the f32 norm of ``grads``, and whether
    to apply the step: ``loss`` and ``gnorm`` finite and, with ``factor``
    > 0 and ``gnorm_ref`` > 0, ``gnorm <= factor * gnorm_ref`` (in f32, as
    the JAX step computes it).  Both come to the host in one read, the
    step's one sync: ``(gnorm, applied)`` as a Python float and bool."""
    norms = torch._foreach_norm([g.float() if g.dtype != torch.float32 else g for g in grads])
    gnorm = torch.linalg.vector_norm(torch.stack(norms))
    ok = torch.isfinite(loss) & torch.isfinite(gnorm)
    ref = np.float32(gnorm_ref)
    if factor > 0 and ref > 0:
        ok = ok & (gnorm <= float(np.float32(factor) * ref))
    flag, norm = torch.stack([ok.float(), gnorm]).tolist()
    return norm, flag == 1.0


class LMTrainStep:
    """One training iteration: ``step(tokens, labels) -> loss``, or with
    the guard armed ``step(tokens, labels, gnorm_ref) -> (loss, gnorm,
    applied)``.

    ``tokens``/``labels`` are this rank's ``[B_local, S]`` integer batch
    (labels are the host-shifted next tokens).  The parameters of ``model``
    are updated in place; ``opt_state`` carries the optimizer's moments and
    its step count, which also indexes ``lr_fn``.
    """

    grad_bytes = 0

    def __init__(self, model, optimizer, lr_fn: Callable[[int], float], world_size: int = 1,
                 group=None, label_smoothing: float = 0.0, grad_accum: int = 1,
                 anomaly_factor: Optional[float] = None):
        if int(grad_accum) < 1:
            raise ValueError(f"grad_accumulation must be >= 1, got {grad_accum}")
        self.model = model
        self.optimizer = optimizer
        self.lr_fn = lr_fn
        self.world_size = int(world_size)
        self.group = group
        self.label_smoothing = float(label_smoothing)
        self.grad_accum = int(grad_accum)
        self.anomaly_factor = None if anomaly_factor is None else float(anomaly_factor)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.opt_state = self.init_opt_state()

    def init_opt_state(self):
        """The optimizer's state over the parameters (their moments and step)."""
        return self.optimizer.init(self.params)

    def micro_loss(self, tokens, labels, global_tokens: int):
        """One micro-batch's partial objective (:func:`lm_loss_local`); its
        logits are freed before the caller's backward."""
        logits = self.model(tokens)
        return lm_loss_local(logits, labels, global_tokens, self.label_smoothing)

    def after_backward(self) -> None:
        """Called after each micro-batch's backward (the GSPMD step's ZeRO-2
        reduce-scatters there); nothing here."""

    def reduce_grads(self, loss):
        """The step's gradients, summed over the ranks with ``loss`` (in
        place): one all-reduce of the flattened buffers."""
        grads = [_grad(p) for p in self.params]
        self.grad_bytes = _nbytes(grads)
        if self.world_size > 1:
            _all_reduce_sum_(grads + [loss.reshape(1)], self.group)
        return grads

    def update(self, grads, lr) -> None:
        """The optimizer's update of the parameters, in place."""
        self.opt_state = self.optimizer.update(self.params, grads, self.opt_state, lr)

    def state_bytes(self) -> dict:
        """Bytes this rank holds across steps: the parameters, the gradient
        buffers its last step carried over its micro-batches
        (``grad_bytes``) and the optimizer's moments."""
        moments = [t for f in self.opt_state._fields if f != "step"
                   for t in getattr(self.opt_state, f)]
        return dict(params=_nbytes(self.params), grads=self.grad_bytes, moments=_nbytes(moments))

    def __call__(self, tokens, labels, gnorm_ref: Optional[float] = None):
        b_local, s_len = tokens.shape
        global_tokens = b_local * s_len * self.world_size
        for p in self.params:
            p.grad = None
        loss = None
        for sl in micro_slices(b_local, self.grad_accum, "per-shard"):
            part = self.micro_loss(tokens[sl], labels[sl], global_tokens)
            part.backward()
            self.after_backward()
            loss = part.detach() if loss is None else loss + part.detach()
        grads = self.reduce_grads(loss)
        applied = True
        if self.anomaly_factor is not None:
            gnorm, applied = guard_verdict(loss, grads, self.anomaly_factor,
                                           0.0 if gnorm_ref is None else gnorm_ref)
        if applied:
            self.update(grads, self.lr_fn(self.opt_state.step))
        for p in self.params:
            p.grad = None
        if self.anomaly_factor is None:
            return loss
        return loss, gnorm, applied


def build_lm_train_step(model, optimizer, lr_fn: Callable[[int], float], world_size: int = 1,
                        group=None, grad_accum: int = 1, label_smoothing: float = 0.0,
                        anomaly_factor: Optional[float] = None, comm=None,
                        zero1: bool = False) -> LMTrainStep:
    """The LM training step, data and sequence parallel (see the module
    docstring)."""
    if comm is not None and getattr(comm, "overlap", False):
        raise NotImplementedError("training.comm.overlap is ROADMAP port item P9")
    if zero1:
        # the ring path's own ZeRO-1 (JAX sp_steps.py, beside comm.overlap);
        # training.zero on the GSPMD path is engine/tp_steps.py
        raise NotImplementedError("ZeRO-1 weight-update sharding on the ring path (beside "
                                  "training.comm.overlap) is ROADMAP port item P9")
    return LMTrainStep(model, optimizer, lr_fn, world_size, group, label_smoothing, grad_accum,
                       anomaly_factor)


def build_lm_eval_step(model, world_size: int = 1, group=None, micro_batches: int = 1):
    """``eval_step(tokens, labels) -> (loss, acc1, acc5)``: mean CE per
    token and next-token top-1/top-5 accuracy in percent, summed (loss) and
    averaged (accuracies) over the ``world_size`` ranks of ``group``, the
    (data, sequence) axes of ``sp_steps.py:268-314`` (on the GSPMD path the
    data group: a model group's ranks hold the same tokens).

    ``micro_batches`` N runs the local batch as N equal slices in turn (the
    runner passes ``training.grad_accumulation``), so validation's logits
    are a micro-batch's, as training's are: the mean of the slices' equal
    shares is the batch's mean, reassociated."""

    @torch.no_grad()
    def eval_step(tokens, labels):
        slices = micro_slices(tokens.shape[0], micro_batches, "per-shard")
        loss = acc1 = acc5 = 0.0
        for sl in slices:
            logits = model(tokens[sl])
            vocab = logits.shape[-1]
            flat_logits, flat_labels = logits.reshape(-1, vocab), labels[sl].reshape(-1)
            loss = loss + lm_loss_local(logits, labels[sl], labels.numel() * world_size)
            a1, a5 = accuracy(flat_logits, flat_labels, topk=(1, 5))
            acc1, acc5 = acc1 + a1 / len(slices), acc5 + a5 / len(slices)
            del logits, flat_logits
        if world_size > 1:
            out = torch.stack([loss.float(), acc1, acc5])
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
            # equal local token counts: the sum over ranks / n is the mean
            return out[0], out[1] / world_size, out[2] / world_size
        return loss, acc1, acc5

    return eval_step
