"""ResNet family, 18 to 152 (port of ``models/resnet.py``).

torchvision's topology (v1.5) and ``state_dict`` names, with the JAX
package's numerics:

- 7x7/2 stem, 3x3/2 max pool with padding 1; Bottleneck puts the stride
  on its 3x3 conv; a projection shortcut (``downsample.0`` conv 1x1,
  ``downsample.1`` BatchNorm) where the stride or the width changes;
  every conv without bias, padded ``k // 2``; global mean pool; ``fc``;
- every norm a :class:`..ops.batch_norm.DistributedBatchNorm`, so
  ``sync_bn`` is a constructor argument, as the JAX ``axis_name`` is;
- compute in ``dtype`` over float32 parameters (each conv and ``fc`` casts
  its weight to it, flax's ``promote_dtype``), BatchNorm statistics in
  float32, logits cast to float32 (``resnet.py:277``);
- init by the same distributions: kaiming-normal fan-out convs, torch
  ``nn.Linear``'s uniform for ``fc``, unit BatchNorm scales.

Input is ``[N, 3, H, W]``; the train step hands it the NHWC batch through
``permute(0, 3, 1, 2)``, on the card a ``channels_last`` view.

``space_to_depth`` (config ``model.space_to_depth``, JAX ``:225-238``) is
the MLPerf stem: a 2x2 space-to-depth pack of the input into 4C channels
in the JAX package's order ``(u * 2 + v) * C + c`` (row parity u, column
parity v), then a 4x4 stride-1 conv padded ((2, 1), (2, 1)), equal to the
7x7/2 stem through :func:`fold_stem_kernel`, which also makes its init (a
folded kaiming 7x7 draw, JAX ``_s2d_stem_init``).  BatchNorm statistics
in bfloat16 come from ``bn_stat_dtype``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batch_norm import DistributedBatchNorm
from ..ops.layers import Dense

__all__ = ["BasicBlock", "Bottleneck", "RESNET_CONFIGS", "ResNet", "fold_stem_kernel",
           "fold_stem_weight", "space_to_depth"]


def fold_stem_kernel(w7):
    """A 7x7/2 stem kernel ``[7, 7, C, O]`` (HWIO, the JAX layout) folded
    into the space-to-depth kernel ``[4, 4, 4C, O]`` (JAX
    ``models/resnet.py:48-89``): the 7x7/2 conv reads ``x[2i + a - 3]``;
    with the pack ``z[p, (u, c)] = x[2p + u]`` tap ``a`` lands at packed
    offset ``m - 2 = (a - 3 - u) // 2`` with parity ``u = (a - 3) % 2``,
    four packed taps an axis, the (m = 0, u = 0) slot left zero.  The zero
    slots also make the padding exact: the packed conv's ((2, 1), (2, 1))
    pad reaches one pixel past the 7x7 conv's pad of 3, but only through
    zero weights.  numpy in, numpy out, the JAX package's function value
    for value; a torch tensor in, a torch tensor out on its device (the
    init, on the meta device too)."""
    kh, kw, c, o = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"fold_stem_kernel: want a [7, 7, C, O] kernel, got {tuple(w7.shape)}")
    if isinstance(w7, torch.Tensor):
        out = w7.new_zeros(4, 4, 4 * c, o)
    else:
        w7 = np.asarray(w7)
        out = np.zeros((4, 4, 4 * c, o), dtype=w7.dtype)
    for a in range(7):
        u = (a - 3) % 2
        m = (a - 3 - u) // 2 + 2
        for b in range(7):
            v = (b - 3) % 2
            n = (b - 3 - v) // 2 + 2
            out[m, n, (u * 2 + v) * c:(u * 2 + v + 1) * c, :] = w7[a, b]
    return out


def fold_stem_weight(w7: torch.Tensor) -> torch.Tensor:
    """:func:`fold_stem_kernel` in torch's OIHW layout:
    ``[O, C, 7, 7] -> [O, 4C, 4, 4]``."""
    return fold_stem_kernel(w7.permute(2, 3, 1, 0)).permute(3, 2, 0, 1)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W] -> [N, 4C, H/2, W/2]``, channel ``(u * 2 + v) * C + c``
    for the pixel at row ``2p + u``, column ``2q + v``.  Packed in NHWC, as
    JAX ``resnet.py:232-233`` packs, so a ``channels_last`` input takes
    one copy and the result is ``channels_last`` again."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth requires even input dims, got {h}x{w}")
    y = x.permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
    return y.permute(0, 3, 1, 2)


class Conv2d(nn.Conv2d):
    """A bias-free conv padded ``k // 2`` that computes in its input's
    dtype (its float32 weight cast to it)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride, kernel // 2, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # torch kaiming_normal_(mode="fan_out", nonlinearity="relu")
        fan_out = self.out_channels * self.kernel_size[0] * self.kernel_size[1]
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)


class StemS2D(Conv2d):
    """The packed stem: 4x4 stride 1 over the space-to-depth input, padded
    ((2, 1), (2, 1)) by ``F.pad`` (``nn.Conv2d`` takes symmetric padding
    only), initialised by folding a kaiming 7x7 draw."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(4 * in_ch, out_ch, 4)
        self.padding = (0, 0)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # JAX _s2d_stem_init: the 7x7 stem's own distribution, folded
        w7 = self.weight.new_empty(self.out_channels, self.in_channels // 4, 7, 7)
        with torch.no_grad():
            w7.normal_(0.0, math.sqrt(2.0 / (self.out_channels * 49)), generator=generator)
            self.weight.copy_(fold_stem_weight(w7))

    def forward(self, x):
        return super().forward(F.pad(x, (2, 1, 2, 1)))


class Linear(Dense):
    """flax ``nn.Dense`` in ``dtype`` with torch ``nn.Linear``'s init,
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for weight and bias."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)


class BasicBlock(nn.Module):
    """Two 3x3 convs, the stride on the first (torchvision BasicBlock)."""

    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int, norm):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, stride)
        self.bn1 = norm(features)
        self.conv2 = Conv2d(features, features, 3)
        self.bn2 = norm(features)
        self.downsample = None
        if stride != 1 or in_ch != features:
            self.downsample = nn.Sequential(Conv2d(in_ch, features, 1, stride), norm(features))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 with the stride (v1.5), 1x1 expand by 4."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int, norm):
        super().__init__()
        out_ch = features * self.expansion
        self.conv1 = Conv2d(in_ch, features, 1)
        self.bn1 = norm(features)
        self.conv2 = Conv2d(features, features, 3, stride)
        self.bn2 = norm(features)
        self.conv3 = Conv2d(features, out_ch, 1)
        self.bn3 = norm(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(Conv2d(in_ch, out_ch, 1, stride), norm(out_ch))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """torchvision-topology ResNet; ``sync_bn`` makes every BatchNorm
    average its statistics over the ranks of ``group``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int,
                 sync_bn: bool = False, dtype=torch.float32, group=None,
                 space_to_depth: bool = False, bn_stat_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.space_to_depth = bool(space_to_depth)
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.num_classes = int(num_classes)
        self.dtype = dtype

        def norm(features):
            return DistributedBatchNorm(features, sync=sync_bn, group=group,
                                        stat_dtype=bn_stat_dtype)

        self.conv1 = StemS2D(3, 64) if self.space_to_depth else Conv2d(3, 64, 7, 2)
        self.bn1 = norm(64)
        in_ch, features = 64, 64
        for stage, n_blocks in enumerate(self.stage_sizes):
            blocks = []
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(block_cls(in_ch, features, stride, norm))
                in_ch = features * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            features *= 2
        self.fc = Linear(in_ch, self.num_classes, dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's initializers, drawn in module order from
        ``generator``."""
        for module in self.modules():
            if isinstance(module, (Conv2d, DistributedBatchNorm, Linear)):  # StemS2D too
                module.reset_parameters(generator)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.space_to_depth:
            x = space_to_depth(x)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{stage + 1}")(x)
        x = x.mean(dim=(2, 3))  # global average pool
        return self.fc(x).float()


# name -> (block, stage sizes), torchvision's families
RESNET_CONFIGS = {
    "ResNet18": (BasicBlock, (2, 2, 2, 2)),
    "ResNet34": (BasicBlock, (3, 4, 6, 3)),
    "ResNet50": (Bottleneck, (3, 4, 6, 3)),
    "ResNet101": (Bottleneck, (3, 4, 23, 3)),
    "ResNet152": (Bottleneck, (3, 8, 36, 3)),
}
