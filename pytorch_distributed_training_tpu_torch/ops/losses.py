"""Loss functions (port of ``ops/losses.py``).

``torch.nn.CrossEntropyLoss`` semantics: integer class targets, mean over
the batch, computed in f32 whatever the logits dtype, optional label
smoothing with torch's convention (target ``(1 - s)`` on the true class plus
``s / C`` uniform).
"""
from __future__ import annotations

import torch

from .fused_ce import fused_cross_entropy

__all__ = ["cross_entropy_loss", "cross_entropy_loss_xla"]


def cross_entropy_loss_xla(logits, labels, label_smoothing: float = 0.0):
    """The plain formula (``losses.py:17-37``):
    ``mean(logz - (1 - s) * true_logit - s * mean_logit)``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, labels.long()[:, None])[:, 0]
    if label_smoothing:
        s = float(label_smoothing)
        return torch.mean(logz - (1.0 - s) * true_logit - s * logits.mean(-1))
    return torch.mean(logz - true_logit)


def cross_entropy_loss(logits, labels, label_smoothing: float = 0.0):
    """Mean softmax CE through the fused kernel pair (:mod:`.fused_ce`; its
    plain twin on CPU tensors).  With ``label_smoothing`` the uniform-target
    correction is added outside the kernel, from the logits directly, as
    ``losses.py:57-65`` does."""
    hard = fused_cross_entropy(logits, labels)
    if label_smoothing:
        s = float(label_smoothing)
        lg = logits.float()
        true_logit = lg.gather(-1, labels.long()[:, None])[:, 0]
        hard = hard + s * torch.mean(true_logit - lg.mean(-1))
    return hard
