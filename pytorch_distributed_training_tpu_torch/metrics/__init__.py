"""Classification metrics (port of ``metrics/__init__.py``).

- :func:`accuracy`: top-k accuracy in percent, one device scalar per ``k``
  (``metrics/__init__.py:24``), so callers can all-reduce them.
- :class:`AverageMeter`: an unweighted running mean over updates (each
  validation batch weighs the same, the reference's behaviour).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["AverageMeter", "accuracy"]


def accuracy(pred: torch.Tensor, label: torch.Tensor,
             topk: Sequence[int] = (1,)) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracy in percent of ``pred [batch, classes]`` (only the
    ranking matters) against integer ``label [batch]``."""
    maxk = max(topk)
    top_idx = torch.topk(pred, maxk, dim=-1, largest=True, sorted=True).indices
    correct = top_idx == label.long()[:, None]
    batch = label.shape[0]
    return tuple(correct[:, :k].sum().float() * (100.0 / batch) for k in topk)


class AverageMeter:
    """Unweighted running mean (reference train_distributed.py:305-321)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.sum = 0.0
        self.count = 0

    def update(self, x, n: int = 1) -> None:
        self.sum += float(x) * n
        self.count += n

    def value(self) -> float:
        return self.sum / self.count if self.count else 0.0
