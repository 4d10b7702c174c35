"""The transformer MLP shared by ViT and the LM (port of ``models/vit.py``).

Only :class:`MLP` is ported so far; the ViT model itself is ROADMAP port
item P8.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_elementwise import FusedDenseGelu
from ..ops.layers import Dense

__all__ = ["MLP"]


class MLP(nn.Module):
    """``fc2(gelu(fc1(x)))`` with exact-erf GELU.

    ``fused_tails`` makes fc1's bias add and GELU one kernel
    (:class:`..ops.fused_elementwise.FusedDenseGelu`); the parameters are
    the same either way.
    """

    def __init__(self, dim: int, hidden: int, out: int, dtype=torch.float32,
                 fused_tails: bool = False):
        super().__init__()
        self.fused_tails = fused_tails
        self.fc1 = (FusedDenseGelu if fused_tails else Dense)(dim, hidden, dtype)
        self.fc2 = Dense(hidden, out, dtype)

    def forward(self, x):
        if self.fused_tails:
            return self.fc2(self.fc1(x))
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))
