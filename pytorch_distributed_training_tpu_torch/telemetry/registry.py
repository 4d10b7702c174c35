"""Metrics registry: counters, gauges, bounded reservoir histograms.

Port of the JAX package's ``telemetry/registry.py``, cut to what
:class:`..serving.metrics.ServingMetrics`, the data pipeline and the fault
layer use (the process-wide registry of :func:`get_registry` holds the
loader's ``data_corrupt_samples``, ``worker_respawns`` and
``data_pool_outstanding``, and the recovery counters of
:mod:`..engine.fault`).  Standard library only.

Histograms keep an Algorithm-R reservoir (a uniform sample of everything
observed) plus EXACT count, sum, min and max, so percentiles stay stable
and means stay exact however long the process runs.  Each histogram's
sampler is seeded from a CRC of its name, so snapshots repeat from run to
run.
"""
from __future__ import annotations

import math
import random
import threading
import zlib
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
           "reset_registry"]


class Counter:
    """Monotonic integer counter (thread-safe)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += int(n)

    def _reset(self) -> None:
        with self._lock:
            self._value = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins float (thread-safe)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def _reset(self) -> None:
        self.set(0.0)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated percentile of an ascending list (numpy's
    default method)."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = (q / 100.0) * (n - 1)
    lo = int(math.floor(pos))
    frac = pos - lo
    hi = min(lo + 1, n - 1)
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class Histogram:
    """Bounded-reservoir histogram: exact count/sum/min/max, sampled tails."""

    __slots__ = (
        "name", "reservoir_size", "_sample", "_count", "_sum", "_min",
        "_max", "_rng", "_lock",
    )

    def __init__(self, name: str, reservoir_size: int = 1024):
        if int(reservoir_size) < 1:
            raise ValueError(
                f"histogram reservoir_size must be >= 1, got {reservoir_size}"
            )
        self.name = name
        self.reservoir_size = int(reservoir_size)
        self._sample: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._rng = random.Random(0x5EED ^ zlib.crc32(name.encode()))
        self._lock = threading.Lock()

    def _reset(self) -> None:
        with self._lock:
            self._sample, self._count, self._sum = [], 0, 0.0
            self._min = self._max = None
            self._rng = random.Random(0x5EED ^ zlib.crc32(self.name.encode()))

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if len(self._sample) < self.reservoir_size:
                self._sample.append(v)
            else:
                # Algorithm R: every observation has equal odds of being kept
                i = self._rng.randrange(self._count)
                if i < self.reservoir_size:
                    self._sample[i] = v

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if self._count == 0:
                return {"count": 0}
            s = sorted(self._sample)
            return {
                "count": self._count,
                "sum": self._sum,
                "mean": self._sum / self._count,
                "min": self._min,
                "max": self._max,
                "p50": _percentile(s, 50),
                "p95": _percentile(s, 95),
                "p99": _percentile(s, 99),
            }


class MetricsRegistry:
    """Named instrument store; instruments are created on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, reservoir_size: int = 1024) -> Histogram:
        return self._get(name, Histogram, reservoir_size)

    def _of(self, cls) -> list:
        with self._lock:
            return [i for i in self._instruments.values() if isinstance(i, cls)]

    def counters(self) -> Dict[str, int]:
        return {c.name: c.value for c in self._of(Counter)}

    def gauges(self) -> Dict[str, float]:
        return {g.name: g.value for g in self._of(Gauge)}

    def reset(self) -> None:
        """Zero every instrument, each kept registered (call sites hold
        ``registry.counter(name)``)."""
        with self._lock:
            insts = list(self._instruments.values())
        for inst in insts:
            inst._reset()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry (JAX ``telemetry/registry.py:271``)."""
    return _REGISTRY


def reset_registry() -> None:
    """Zero the process-wide registry (JAX ``telemetry/registry.py:281``)."""
    _REGISTRY.reset()
