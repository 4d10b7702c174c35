"""Host-side helpers of the port (``utils/__init__.py`` of the JAX package)."""
from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["make_deterministic"]


def make_deterministic(seed: int) -> None:
    """Seed Python's, numpy's and torch's RNGs (reference
    train_distributed.py:51-53, :141-142): the same seed on every rank gives
    every rank the same initial model, so no broadcast is needed."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
