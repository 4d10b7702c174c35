"""Flax's ``nn.Dense`` and ``nn.LayerNorm`` with their numerics, in torch.

Parameters follow torch's layout (``weight`` [out, in]) and flax's
initializers; the forward passes round where flax rounds:

- :class:`Dense` computes in its ``dtype``: input, weight and bias are cast
  to it first (flax ``promote_dtype``), so a bf16 Dense gives bf16 out and
  the f32 LM head gives f32 logits over a bf16 stream.
- :class:`LayerNorm` is flax's, not ``F.layer_norm``: ``epsilon`` 1e-6, the
  fast variance ``max(0, E[x^2] - E[x]^2)``, statistics in f32 and the
  result cast to ``dtype``.

With a ``tensor_group`` (:class:`..parallel.tensor.TensorGroup`) a Dense
takes Megatron's column or row form (``split``).  It draws the full leaves
first, as the one-rank layer does, and keeps this rank's slice
(:mod:`..parallel.tensor`), so a T-rank model starts from the one-rank
model's weights:

- ``"column"``: rows of ``weight`` and entries of ``bias``; the input
  passes *copy* first, and the output is this rank's columns;
- ``"row"``: columns of ``weight``, ``bias`` whole; the product of this
  rank's input columns is summed over the group by *reduce*, and the bias is
  added once, after the reduce, rounded to ``dtype`` as the plain layer
  rounds it (adding it on every rank would count it ``T`` times).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor import COLUMN, ROW, copy_to_model, reduce_from_model, shard_param

__all__ = ["Dense", "LayerNorm", "lecun_normal_", "layer_norm"]


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None,
                  fan_in: Optional[int] = None):
    """flax ``lecun_normal`` for a torch ``[out, in]`` weight (or a conv's
    ``[out, in, kh, kw]``, fan-in ``in * kh * kw``): a normal truncated at
    two standard deviations, scaled to variance ``1/fan_in``.  ``fan_in``
    overrides the count for other layouts.

    Rejection sampling (redraw what falls outside, about 4.6% a round) gives
    the same distribution as an inverse-CDF draw at a fraction of its cost
    at full model width.
    """
    if weight.is_meta:  # a template built on the meta device: nothing to draw
        return weight
    fan_in = weight[0].numel() if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        weight.normal_(0.0, 1.0, generator=generator)
        while True:
            bad = weight.abs() > 2.0
            n = int(bad.sum())
            if n == 0:
                break
            weight[bad] = torch.randn(
                n, generator=generator, dtype=weight.dtype, device=weight.device
            )
        weight.mul_(std)
    return weight


class Dense(nn.Module):
    """flax ``nn.Dense(out_features, dtype=dtype)``; with ``tensor_group``
    its ``split`` form, ``"column"`` or ``"row"`` (module docstring)."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32,
                 tensor_group=None, split: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.reset_parameters()
        self.tensor_group = tensor_group
        self.split = split if tensor_group is not None else None
        if self.split is not None:
            if self.split not in (COLUMN, ROW):
                raise ValueError(f"Dense split must be {COLUMN!r} or {ROW!r}, got {split!r}")
            n, r = tensor_group.size, tensor_group.rank
            with torch.no_grad():
                self.weight = nn.Parameter(shard_param(self.weight, 0 if split == COLUMN else 1,
                                                       n, r))
                if split == COLUMN:
                    self.bias = nn.Parameter(shard_param(self.bias, 0, n, r))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if getattr(self, "split", None) is not None:
            raise RuntimeError("a tensor-parallel Dense holds a slice: reset the full model "
                               "(TransformerLM.reset_parameters) instead")
        lecun_normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        d = self.dtype
        if self.split == ROW:
            partial = F.linear(x.to(d), self.weight.to(d))
            return reduce_from_model(partial, self.tensor_group) + self.bias.to(d)
        if self.split == COLUMN:
            x = copy_to_model(x, self.tensor_group)
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


def layer_norm(x, weight, bias, eps: float = 1e-6, dtype=None):
    """flax LayerNorm of ``x`` over its last axis (see module docstring)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (x32 - mu) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(x.dtype if dtype is None else dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)``: ``weight`` is flax's ``scale``."""

    def __init__(self, features: int, dtype=torch.float32, eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype)
