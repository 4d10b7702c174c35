"""Serving metrics of the batcher path: latency, throughput, batch shape.

Port of the JAX package's ``serving/metrics.py`` for the whole-batch path
(the continuous scheduler's instruments come with ROADMAP port item P4).

Latency is recorded per REQUEST (enqueue -> result), so batching delay is
included: the number a client observes.  Throughput counts generated tokens
over the window from the first to the last flushed batch.  Prefill answers
for the real prompt tokens it consumed plus each request's first generated
token (it samples it); decode answers for the rest.

Storage is bounded: per-request latencies, batch sizes and generated
lengths land in reservoir histograms of a private
:class:`..telemetry.registry.MetricsRegistry`, one per engine.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..telemetry.registry import MetricsRegistry

__all__ = ["ServingMetrics"]

# big enough that p99 of a uniform sample is a tight estimate, small enough
# to cap memory at a few KB per engine
_RESERVOIR = 2048


class ServingMetrics:
    """Thread-safe accumulator; ``record_batch`` runs on the flush thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._registry = MetricsRegistry()
        self._latency_ms = self._registry.histogram("latency_ms", _RESERVOIR)
        self._batch_size = self._registry.histogram("batch_size", _RESERVOIR)
        self._gen_len = self._registry.histogram("gen_len", _RESERVOIR)
        self._items = 0  # guarded by: self._lock
        self._first_t: Optional[float] = None  # guarded by: self._lock
        self._last_t: Optional[float] = None  # guarded by: self._lock
        self._max_depth = 0  # guarded by: self._lock
        self._prefill_tokens = 0  # guarded by: self._lock
        self._decode_tokens = 0  # guarded by: self._lock
        self._prefill_s = 0.0  # guarded by: self._lock
        self._decode_s = 0.0  # guarded by: self._lock

    def incr(self, name: str, n: int = 1) -> None:
        """Bump a named degradation counter (``timeouts``, ``sheds``)."""
        self._registry.counter(name).inc(n)

    def set_gauge(self, name: str, value: float) -> None:
        self._registry.gauge(name).set(value)

    def record_batch(
        self,
        enqueued_ats: List[float],
        n_items: int,
        queue_depth: int = 0,
        gen_lens: Optional[List[int]] = None,
        prompt_tokens: int = 0,
        prefill_s: float = 0.0,
        decode_s: float = 0.0,
    ) -> None:
        """One flushed batch: per-request enqueue stamps, generated tokens
        (``n_items``), generated length per request, REAL prompt tokens
        (not the padded bucket area) and the two phases' wall times."""
        now = time.monotonic()
        for t0 in enqueued_ats:
            self._latency_ms.observe((now - t0) * 1000.0)
        self._batch_size.observe(len(enqueued_ats))
        for g in gen_lens or ():
            self._gen_len.observe(int(g))
        n_req = len(gen_lens) if gen_lens else 0
        with self._lock:
            self._items += n_items
            if self._first_t is None:
                self._first_t = now
            self._last_t = now
            self._max_depth = max(self._max_depth, queue_depth)
            self._prefill_s += float(prefill_s)
            self._decode_s += float(decode_s)
            self._prefill_tokens += int(prompt_tokens) + n_req
            if gen_lens:
                self._decode_tokens += int(sum(gen_lens)) - n_req

    def snapshot(self) -> Dict[str, float]:
        """p50/p99 latency, items/sec, batch occupancy, phase rates."""
        lat = self._latency_ms.snapshot()
        sizes = self._batch_size.snapshot()
        gen = self._gen_len.snapshot()
        with self._lock:
            span = (
                self._last_t - self._first_t
                if self._first_t is not None and self._last_t > self._first_t
                else 0.0
            )
            items = self._items
            depth = self._max_depth
            prefill_tokens, decode_tokens = self._prefill_tokens, self._decode_tokens
            prefill_s, decode_s = self._prefill_s, self._decode_s
        out = {
            "requests": int(lat["count"]),
            "batches": int(sizes["count"]),
            "items": int(items),
            "max_queue_depth": int(depth),
        }
        out.update({k: v for k, v in self._registry.counters().items() if v})
        if lat["count"]:
            out["latency_ms_p50"] = float(lat["p50"])
            out["latency_ms_p99"] = float(lat["p99"])
            out["latency_ms_mean"] = float(lat["mean"])
        if sizes["count"]:
            out["batch_size_mean"] = float(sizes["mean"])
        # a single flush has no time span: leave the rate out rather than
        # divide by zero
        if span > 0:
            out["items_per_sec"] = float(items / span)
        if gen["count"]:
            out["gen_tokens"] = int(gen["sum"])
            out["gen_len_mean"] = float(gen["mean"])
            out["gen_len_p50"] = float(gen["p50"])
        if prefill_s > 0 and prefill_tokens:
            out["prefill_tokens_per_sec"] = float(prefill_tokens / prefill_s)
        if decode_s > 0 and decode_tokens:
            out["decode_tokens_per_sec"] = float(decode_tokens / decode_s)
        out.update(self._registry.gauges())
        return out

    def log_summary(self, logger, prefix: str = "serving") -> Dict[str, float]:
        snap = self.snapshot()
        parts = ", ".join(
            f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(snap.items())
        )
        logger.info("%s metrics: %s", prefix, parts)
        return snap
