"""Checkpoint-and-exit on a termination signal (port of ``engine/preemption.py``).

Spot and preemptible capacity announces an eviction with a signal and a
grace window.  :class:`PreemptionGuard` latches the configured signals
into a flag that the training loop polls once an iteration (a Python
bool, nothing on the card); when it is set the loop saves a checkpoint at
the current iteration and returns, and the next launch resumes from it.

The runner arms it whenever ``training.checkpoint`` is configured, unless
``training.checkpoint.preemption: false``; ``preemption_signals`` names
the signals (default SIGTERM; :meth:`PreemptionGuard.parse_signals`).

Signal handlers can be installed from the main thread only.  Entered from
another thread, the guard logs a warning and installs nothing: the flag
stays, inert unless set by hand, and the run is not preemption-safe.
"""
from __future__ import annotations

import logging
import signal
import threading
from typing import Optional, Sequence

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Latches termination signals into :attr:`triggered`.  A context
    manager around the training loop; the previous handlers come back on
    exit, so runners one after another leave no handler behind."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,),
                 logger: Optional[logging.Logger] = None):
        self.signals = tuple(signals)
        self.logger = logger
        self.triggered = False
        self._prev: dict = {}
        self._installed = False

    @staticmethod
    def parse_signals(spec) -> tuple:
        """``training.checkpoint.preemption_signals`` as signal numbers: one
        name or number, or a list; names case-insensitive with the ``SIG``
        prefix optional (``sigterm``, ``TERM``, ``SIGUSR1``).  Returns a
        non-empty tuple of ``signal.Signals``."""
        if isinstance(spec, (str, int)):
            spec = [spec]
        out = []
        for s in spec:
            if isinstance(s, str):
                name = s.upper()
                if not name.startswith("SIG"):
                    name = "SIG" + name
                sig = getattr(signal.Signals, name, None)
                if sig is None:
                    raise ValueError(f"training.checkpoint.preemption_signals: unknown "
                                     f"signal name {s!r}")
            else:
                try:
                    sig = signal.Signals(int(s))
                except ValueError:
                    raise ValueError(f"training.checkpoint.preemption_signals: invalid "
                                     f"signal number {s!r}") from None
            out.append(sig)
        if not out:
            raise ValueError("training.checkpoint.preemption_signals must name at least "
                             "one signal")
        return tuple(out)

    def _handler(self, signum, frame):
        # only the flag: logging here could deadlock on the lock of a log
        # call the signal interrupted; the loop logs when it acts
        del signum, frame
        self.triggered = True

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            if self.logger:
                self.logger.warning("PreemptionGuard: not on the main thread, signal handlers "
                                    "unavailable — preemption checkpointing disabled")
            return self
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)
            self._installed = False
