"""Bounded retry with exponential backoff and jitter (port of ``utils/retry.py``).

One policy object serves every retrying call site (the checkpoint's save
and restore, :mod:`..engine.checkpoint`):

- at most ``attempts`` calls;
- before retry ``i`` (0-based failed attempt) a sleep of
  ``min(backoff * 2**i, max_backoff) * (1 + jitter * u)``, ``u`` uniform
  in [0, 1), so hosts retrying one filesystem do not move in lockstep;
- only exceptions of ``retry_on`` are retried, and never those of
  ``non_retryable`` (``ValueError``/``TypeError`` by default: a bug does
  not heal by waiting);
- with ``total_timeout_s``, a retry whose sleep would end past the
  deadline is abandoned and the last failure raises
  (``retry_deadline_exceeded``);
- ``sleep``, ``rng`` and ``clock`` can be injected, so tests check the
  delays and the deadline without waiting.

Retried failures count ``retry_attempts``, exhaustions
``retry_exhausted``, on the process registry.
"""
from __future__ import annotations

import functools
import logging
import random
import time
from typing import Callable, Optional, Tuple, Type

from ..telemetry.registry import get_registry

__all__ = ["Retry"]


class Retry:
    """A callable retry policy: ``policy.call(fn, ...)`` or ``@policy``."""

    def __init__(self, attempts: int = 3, backoff: float = 0.25, max_backoff: float = 8.0,
                 jitter: float = 0.25,
                 retry_on: Tuple[Type[BaseException], ...] = (OSError,),
                 non_retryable: Tuple[Type[BaseException], ...] = (ValueError, TypeError),
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None,
                 logger: Optional[logging.Logger] = None,
                 total_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        if backoff < 0 or max_backoff < 0:
            raise ValueError(f"backoff/max_backoff must be >= 0, got {backoff}/{max_backoff}")
        if not (0.0 <= jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        if total_timeout_s is not None and total_timeout_s <= 0:
            raise ValueError(f"total_timeout_s must be > 0, got {total_timeout_s}")
        self.attempts = int(attempts)
        self.backoff = float(backoff)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)
        self.retry_on = tuple(retry_on)
        self.non_retryable = tuple(non_retryable)
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self._logger = logger
        self.total_timeout_s = float(total_timeout_s) if total_timeout_s is not None else None
        self._clock = clock

    def delay(self, attempt: int) -> float:
        """The sleep before retrying failed attempt ``attempt`` (0-based)."""
        base = min(self.backoff * (2.0 ** attempt), self.max_backoff)
        return base * (1.0 + self.jitter * self._rng.random())

    def call(self, fn: Callable, *args, on_retry: Optional[Callable] = None, **kwargs):
        """``fn(*args, **kwargs)``, its allowed failures retried.

        ``on_retry(attempt, exc, delay)`` runs before each sleep; the last
        failure raises the original exception."""
        deadline = (self._clock() + self.total_timeout_s
                    if self.total_timeout_s is not None else None)
        for attempt in range(self.attempts):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as exc:
                if isinstance(exc, self.non_retryable):
                    raise
                if attempt == self.attempts - 1:
                    self._count("retry_exhausted")
                    raise
                d = self.delay(attempt)
                name = getattr(fn, "__name__", "call")
                if deadline is not None and self._clock() + d > deadline:
                    self._count("retry_deadline_exceeded")
                    if self._logger is not None:
                        self._logger.warning(
                            "%s failed (attempt %d/%d): %s — next backoff %.2fs would exceed "
                            "the %.2fs total budget, abandoning retries", name, attempt + 1,
                            self.attempts, exc, d, self.total_timeout_s)
                    raise
                self._count("retry_attempts")
                if on_retry is not None:
                    on_retry(attempt, exc, d)
                if self._logger is not None:
                    self._logger.warning("%s failed (attempt %d/%d): %s — retrying in %.2fs",
                                         name, attempt + 1, self.attempts, exc, d)
                self._sleep(d)

    @staticmethod
    def _count(name: str) -> None:
        get_registry().counter(name).inc()

    def __call__(self, fn: Callable) -> Callable:
        """Decorator form: ``@Retry(...)`` wraps ``fn`` in :meth:`call`."""

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        return wrapped
