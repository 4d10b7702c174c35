"""Host-phase trace spans (port of the JAX package's ``telemetry/spans.py``,
cut to what the serving scheduler and its supervisor use).

A span brackets one host-visible phase with a context manager::

    with span("decode_step", step=tick, active=n):
        ...

Each records its kind, step, monotonic and wall start, duration (ms) and
thread into a bounded in-memory ring: a hang report or a chip run reads
what the process was doing (``recent()``).  The module keeps one current
recorder that :func:`span` writes to, so deep call sites (the scheduler's
decode step, the supervisor's bisect and restart) emit spans without a
handle threaded through.  The JAX recorder's JSONL file is not ported.
Standard library only.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["SpanRecorder", "get_recorder", "set_recorder", "span"]


class SpanRecorder:
    """Thread-safe bounded ring of span records."""

    def __init__(self, ring: int = 256, host: int = 0):
        self.host = int(host)
        self._ring: deque = deque(maxlen=max(int(ring), 1))
        self._lock = threading.Lock()
        self.enabled = True

    @contextlib.contextmanager
    def span(self, kind: str, step: Optional[int] = None, **extra):
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        wall = time.time()
        try:
            yield
        finally:
            rec: Dict = {
                "kind": kind,
                "step": step,
                "host": self.host,
                "t": round(t0, 6),
                "wall": round(wall, 3),
                "ms": round((time.monotonic() - t0) * 1e3, 3),
                "thread": threading.current_thread().name,
            }
            rec.update(extra)
            with self._lock:
                self._ring.append(rec)

    def recent(self, n: Optional[int] = None) -> List[Dict]:
        """Last ``n`` spans, oldest first."""
        with self._lock:
            items = list(self._ring)
        return items if n is None else items[-int(n):]


_LOCK = threading.Lock()
_RECORDER: Optional[SpanRecorder] = None


def get_recorder() -> SpanRecorder:
    """The current recorder (a default ring until one is installed)."""
    global _RECORDER
    with _LOCK:
        if _RECORDER is None:
            _RECORDER = SpanRecorder()
        return _RECORDER


def set_recorder(recorder: Optional[SpanRecorder]) -> SpanRecorder:
    """Install ``recorder`` as the current one (None: a fresh default
    ring); returns the recorder now in effect."""
    global _RECORDER
    with _LOCK:
        _RECORDER = recorder if recorder is not None else SpanRecorder()
        return _RECORDER


def span(kind: str, step: Optional[int] = None, **extra):
    """Record a phase span on the current recorder (context manager)."""
    return get_recorder().span(kind, step=step, **extra)
