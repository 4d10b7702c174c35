"""Per-iteration LR schedules (port of ``schedulers/__init__.py``).

``get_scheduler(optimizer, cfg)`` returns an :class:`IterationScheduler`:
``.step()`` once per iteration, ``.get_last_lr()`` a one-element list for
logging, and ``.lr_fn(step)`` the schedule the train step reads.  The JAX
package evaluates ``lr_fn`` on the device inside the compiled step; here
the step runs eagerly and reads it on the host from its own step counter
(a Python int, so no device sync).

Ported: ``multi_step`` (milestones and gamma, ``:55-78``), ``poly`` (the
LARS recipe's polynomial decay, ``:97-127``) and ``cosine``
(``:129-153``), each with detectron-style warmup (``warmup_iters``,
``warmup_mode`` linear or constant, ``warmup_factor``; ``:43-52``).  The
host arithmetic is float64, as the JAX package's host path
(``get_last_lr``); the train step rounds the value to float32.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence

__all__ = ["IterationScheduler", "cosine_lr", "get_scheduler", "multi_step_lr", "poly_lr"]


def _apply_warmup(lr: float, step: int, warmup_iters: int, warmup_mode: str,
                  warmup_factor: float) -> float:
    if not warmup_iters or warmup_iters <= 0 or step >= warmup_iters:
        return lr
    if warmup_mode == "linear":
        alpha = step / warmup_iters
        return lr * (warmup_factor * (1.0 - alpha) + alpha)
    if warmup_mode == "constant":
        return lr * warmup_factor
    raise ValueError(f"unknown warmup_mode: {warmup_mode!r}")


def multi_step_lr(base_lr: float, milestones: Sequence[int], gamma: float,
                  warmup_iters: int = 0, warmup_mode: str = "linear",
                  warmup_factor: float = 1.0 / 3) -> Callable:
    """``base_lr * gamma ** |{m in milestones : m <= step}|``, torch's
    ``MultiStepLR`` stepped every iteration, then warmup on top."""
    if warmup_mode not in ("linear", "constant"):
        raise ValueError(f"unknown warmup_mode: {warmup_mode!r}")
    ms_sorted = sorted(milestones)

    def lr_at(step: int) -> float:
        lr = base_lr * gamma ** sum(1 for m in ms_sorted if step >= m)
        return _apply_warmup(lr, step, warmup_iters, warmup_mode, warmup_factor)

    return lr_at


def poly_lr(base_lr: float, total_iters: int, power: float = 2.0, end_lr: float = 0.0,
            warmup_iters: int = 0, warmup_mode: str = "linear",
            warmup_factor: float = 1.0 / 3) -> Callable:
    """``end + (base - end) * (1 - s / decay_iters) ** power``, the decay
    horizon measured after the warmup (so the decay starts from
    ``base_lr`` when the warmup hands over), then warmup on top."""
    if warmup_mode not in ("linear", "constant"):
        raise ValueError(f"unknown warmup_mode: {warmup_mode!r}")
    decay_iters = max(total_iters - max(warmup_iters, 0), 1)

    def lr_at(step: int) -> float:
        s = min(max(step - max(warmup_iters, 0), 0), decay_iters)
        lr = end_lr + (base_lr - end_lr) * (1.0 - s / decay_iters) ** power
        return _apply_warmup(lr, step, warmup_iters, warmup_mode, warmup_factor)

    return lr_at


def cosine_lr(base_lr: float, total_iters: int, end_lr: float = 0.0, warmup_iters: int = 0,
              warmup_mode: str = "linear", warmup_factor: float = 1.0 / 3) -> Callable:
    """Cosine decay over the post-warmup iterations, then warmup on top."""
    if warmup_mode not in ("linear", "constant"):
        raise ValueError(f"unknown warmup_mode: {warmup_mode!r}")
    decay_iters = max(total_iters - max(warmup_iters, 0), 1)

    def lr_at(step: int) -> float:
        s = min(max(step - max(warmup_iters, 0), 0), decay_iters)
        cos = 0.5 * (1.0 + math.cos(math.pi * s / decay_iters))
        lr = end_lr + (base_lr - end_lr) * cos
        return _apply_warmup(lr, step, warmup_iters, warmup_mode, warmup_factor)

    return lr_at


class IterationScheduler:
    """``.step()`` per iteration, ``.get_last_lr()`` for the current one."""

    def __init__(self, lr_fn: Callable[[int], float], last_epoch: int = 0):
        self.lr_fn = lr_fn
        self.last_epoch = last_epoch

    def step(self) -> None:
        self.last_epoch += 1

    def get_last_lr(self) -> List[float]:
        return [float(self.lr_fn(self.last_epoch))]


def _make_multi_step(optimizer, cfg: Dict[str, Any]) -> IterationScheduler:
    return IterationScheduler(multi_step_lr(
        base_lr=optimizer.lr,
        milestones=cfg["milestones"],
        gamma=cfg["gamma"],
        warmup_iters=cfg.get("warmup_iters", 0),
        warmup_mode=cfg.get("warmup_mode", "linear"),
        warmup_factor=cfg.get("warmup_factor", 1.0 / 3),
    ))


def _make_poly(optimizer, cfg: Dict[str, Any]) -> IterationScheduler:
    return IterationScheduler(poly_lr(
        base_lr=optimizer.lr,
        total_iters=cfg["total_iters"],
        power=cfg.get("power", 2.0),
        end_lr=cfg.get("end_lr", 0.0),
        warmup_iters=cfg.get("warmup_iters", 0),
        warmup_mode=cfg.get("warmup_mode", "linear"),
        warmup_factor=cfg.get("warmup_factor", 1.0 / 3),
    ))


def _make_cosine(optimizer, cfg: Dict[str, Any]) -> IterationScheduler:
    return IterationScheduler(cosine_lr(
        base_lr=optimizer.lr,
        total_iters=cfg["total_iters"],
        end_lr=cfg.get("end_lr", 0.0),
        warmup_iters=cfg.get("warmup_iters", 0),
        warmup_mode=cfg.get("warmup_mode", "linear"),
        warmup_factor=cfg.get("warmup_factor", 1.0 / 3),
    ))


SCHEDULERS = {"multi_step": _make_multi_step, "poly": _make_poly, "cosine": _make_cosine}


def get_scheduler(optimizer, cfg: Dict[str, Any]) -> IterationScheduler:
    """Factory keyed by ``cfg['name']`` (reference: train_distributed.py:211)."""
    cfg = dict(cfg)
    name = cfg.pop("name")
    if name not in SCHEDULERS:
        raise KeyError(f"unknown scheduler '{name}' (have: {sorted(SCHEDULERS)})")
    return SCHEDULERS[name](optimizer, cfg)
