"""Hung-step watchdog: a monitor thread that flags a stuck training step
(port of ``engine/watchdog.py``).

A hung collective or a wedged copy is silent: the loop never returns from
the step.  The watchdog reads the host wall time of each step
(``step_started``/``step_finished`` bracket the loop body, the data fetch
included) and fires when the live step runs past ``max(min_seconds,
factor x trailing median step time)``.  It arms only after ``warmup``
completed steps, so the first steps (kernel builds, cuDNN autotuning)
cannot fire it.

On a fire it calls ``on_hang(step, elapsed, limit)`` (the runner logs the
step, the loader's queue and every thread's stack, and with
``checkpoint_and_exit`` sets the :class:`.preemption.PreemptionGuard` flag,
so the loop saves at the current iteration and returns).  The monitor
reads two timestamps under a lock and touches neither torch nor the card.
"""
from __future__ import annotations

import logging
import statistics
import threading
import time
from collections import deque
from typing import Callable, Optional

__all__ = ["StepWatchdog"]


class StepWatchdog:
    """A monitor thread flagging steps that exceed the trailing step time.

    ``on_hang(step, elapsed, limit)`` fires at most once per step index.
    A context manager; or call :meth:`close` to stop the thread.
    """

    def __init__(self, factor: float = 10.0, min_seconds: float = 60.0, window: int = 32,
                 warmup: int = 3, poll_seconds: Optional[float] = None,
                 on_hang: Optional[Callable[[int, float, float], None]] = None,
                 logger: Optional[logging.Logger] = None):
        if factor <= 1.0:
            raise ValueError(f"watchdog factor must be > 1, got {factor}")
        if min_seconds <= 0:
            raise ValueError(f"watchdog min_seconds must be > 0, got {min_seconds}")
        if warmup < 1:
            raise ValueError(f"watchdog warmup must be >= 1, got {warmup}")
        self.factor = float(factor)
        self.min_seconds = float(min_seconds)
        self.warmup = int(warmup)
        self.fires = 0  # guarded by: self._lock
        self.resets = 0  # guarded by: self._lock
        self._times: deque = deque(maxlen=int(window))  # guarded by: self._lock
        self._on_hang = on_hang
        self._logger = logger
        self._lock = threading.Lock()
        self._cur_step: Optional[int] = None  # guarded by: self._lock
        self._cur_start: float = 0.0  # guarded by: self._lock
        self._fired_for: Optional[int] = None  # guarded by: self._lock
        self._stop = threading.Event()
        self._poll = (float(poll_seconds) if poll_seconds is not None
                      else max(self.min_seconds / 4.0, 0.02))
        if self._poll <= 0:
            raise ValueError(f"watchdog poll_seconds must be > 0, got {self._poll}")
        self._thread = threading.Thread(target=self._run, name="step-watchdog", daemon=True)
        self._thread.start()

    def step_started(self, step: int) -> None:
        with self._lock:
            self._cur_step = int(step)
            self._cur_start = time.monotonic()

    def step_finished(self) -> None:
        with self._lock:
            if self._cur_step is None:
                return
            self._times.append(time.monotonic() - self._cur_start)
            self._cur_step = None

    def reset(self) -> None:
        """Forget the step times and enter the warm-up again: after a
        rollback the replayed steps start cold, and a median learned before
        the fault would read them as hangs.  ``resets`` counts the calls."""
        with self._lock:
            self._times.clear()
            self._cur_step = None
            self._fired_for = None
            self.resets += 1

    def trailing_median(self) -> Optional[float]:
        with self._lock:
            return statistics.median(self._times) if self._times else None

    def _limit(self) -> Optional[float]:  # guarded by: self._lock
        """The hang threshold; ``None`` while warming up."""
        if len(self._times) < self.warmup:
            return None
        return max(self.min_seconds, self.factor * statistics.median(self._times))

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            with self._lock:
                step, start = self._cur_step, self._cur_start
                if step is None or step == self._fired_for:
                    continue
                limit = self._limit()
            if limit is None:
                continue
            elapsed = time.monotonic() - start
            if elapsed <= limit:
                continue
            with self._lock:
                # the step may have finished, or another begun, meanwhile
                if self._cur_step != step or step == self._fired_for:
                    continue
                self._fired_for = step
                self.fires += 1
            if self._logger is not None:
                self._logger.error("watchdog: step %d running for %.2fs (limit %.2fs)",
                                   step, elapsed, limit)
            if self._on_hang is not None:
                try:
                    self._on_hang(step, elapsed, limit)
                except Exception:  # the monitor outlives its own dump
                    if self._logger is not None:
                        self._logger.exception("watchdog on_hang callback failed")

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "StepWatchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
