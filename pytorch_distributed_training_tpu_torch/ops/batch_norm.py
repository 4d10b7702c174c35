"""Distributed (synchronized) BatchNorm (port of ``ops/batch_norm.py``).

:class:`DistributedBatchNorm` normalizes over every axis but the channel
axis (axis 1: ``[N, C]`` or ``[N, C, H, W]``, in any memory format), with
the JAX package's semantics (``batch_norm.py:11-27``):

- statistics in float32 whatever the activation dtype (float64 for a
  float64 input, a reference for tests); the output in the input's dtype;
- normalization by the **biased** batch variance, ``eps`` 1e-5;
- ``running_var`` updated with the unbiased ``var * n / (n - 1)``, ``n``
  the **global** element count (every rank's);
- torch's momentum convention, ``r <- (1 - m) r + m stat``, ``m`` 0.1.

Two formulas, chosen by ``sync``, not by the world size (``:97-130``):

- ``sync``: raw moments ``E[x^2] - E[x]^2`` of ``(mean, mean_sq)``, which
  one all-reduce averages over the ranks (skipped at world size 1).  The
  all-reduce is differentiable: its backward all-reduces the cotangent, so
  each rank's gradient holds every rank's share of the statistics' use.
- local: the shifted one-pass form ``E[(x - c)^2] - (E[x] - c)^2`` with
  ``c`` the running mean, taken as a constant.

``stat_dtype=torch.bfloat16`` (JAX ``stat_dtype``, config
``model.bn_stat_dtype``; ``:85-147``) takes the moments and the
normalisation in bfloat16 while the running statistics stay float32.
Both forms then shift by ``c`` = the running mean: the sync form applies
it to the second moment only, ``E[(x - c)^2] - (E[x] - c)^2``, inside the
same one all-reduce, and ``var`` is clamped at 0 (bfloat16's 8 mantissa
bits can round it below).  float32 keeps the forms above bit for bit.

Plain torch ops: the JAX package's BatchNorm is XLA, not a Pallas kernel.
``torch.nn.SyncBatchNorm`` is not used: it refuses CPU tensors, so it
could not run over gloo on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["DistributedBatchNorm"]


def _world_size(group) -> int:
    """The ranks the statistics average over: an explicit group's size (a
    process group of its own, as threads over one store build), else the
    default group's, 1 without one."""
    if group is not None:
        return group.size()
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the cotangent the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def _all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group``, differentiable; ``x``
    itself at world size 1."""
    world = _world_size(group)
    if world == 1:
        return x
    return _AllReduceSum.apply(x, group) / world


class DistributedBatchNorm(nn.Module):
    """BatchNorm over axis 1 with optional cross-rank statistics.

    ``weight``/``bias`` are the JAX ``scale``/``bias``; ``running_mean``/
    ``running_var`` (float32 buffers) its ``batch_stats`` ``mean``/``var``.
    ``self.training`` selects batch statistics (and their running update)
    over the running ones, as the JAX ``use_running_average`` does.
    """

    def __init__(self, num_features: int, sync: bool = False, momentum: float = 0.1,
                 eps: float = 1e-5, group=None, stat_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if stat_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"stat_dtype must be float32 or bfloat16, got {stat_dtype}")
        self.low_stats = stat_dtype == torch.bfloat16
        self.num_features = int(num_features)
        self.sync = bool(sync)
        self.momentum = float(momentum)
        self.eps = float(eps)
        self.group = group
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def _shape(self, x) -> tuple:
        return (1, -1) + (1,) * (x.dim() - 2)

    def forward(self, x):
        if x.dim() < 2 or x.shape[1] != self.num_features:
            raise ValueError(f"DistributedBatchNorm({self.num_features}): got input of "
                             f"shape {tuple(x.shape)}")
        if self.low_stats:
            sd = torch.bfloat16
        else:
            sd = torch.float64 if x.dtype == torch.float64 else torch.float32
        xf = x.to(sd)
        shape = self._shape(x)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = (0,) + tuple(range(2, x.dim()))
            n = x.numel() // self.num_features
            mean = xf.mean(axes)
            c = self.running_mean.detach().to(sd)
            if self.sync:
                if self.low_stats:
                    mean_sq = (xf - c.view(shape)).square().mean(axes)
                else:
                    mean_sq = xf.square().mean(axes)  # raw moments: c = 0
                world = _world_size(self.group)
                if world > 1:
                    mean, mean_sq = _all_reduce_mean(torch.stack([mean, mean_sq]), self.group)
                n *= world
                var = mean_sq - ((mean - c) if self.low_stats else mean).square()
            else:
                var = (xf - c.view(shape)).square().mean(axes) - (mean - c).square()
            if self.low_stats:
                var = var.clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * unbiased)
        inv = torch.rsqrt(var.to(sd) + self.eps)
        y = (xf - mean.to(sd).view(shape)) * inv.view(shape) * self.weight.to(sd).view(shape) \
            + self.bias.to(sd).view(shape)
        return y.to(x.dtype)

    def extra_repr(self) -> str:
        return (f"{self.num_features}, sync={self.sync}, momentum={self.momentum}, eps={self.eps}"
                + (", stat_dtype=bfloat16" if self.low_stats else ""))
