"""Serving metrics: latency, throughput, batch shape, scheduler state.

Port of the JAX package's ``serving/metrics.py``: the whole-batch path's
``record_batch`` and the continuous scheduler's instruments (JAX
``:188-290``): per retired request, prefill call and decode step, the
slot occupancy and block utilisation of each decode iteration, each tick's
host ms and the gap between back-to-back decode dispatches, queue depth,
the classification batcher's host ms a batch
the health snapshot (``health_*`` gauges), the KV blocks a replica
imported (``kv_transfer_*``) and a scaled-up replica's time to warm
(``scale_up_ready_ms``).  The scheduler mirrors its counters into the
process registry under :meth:`ServingMetrics.global_name`:
``serving_<name>``, or ``serving_r<id>_<name>`` for a fleet replica
(JAX ``:24-25``, ``:136-141``), so N replicas in one process do not share
a name.  :func:`aggregate_snapshots` folds the replicas' snapshots into
the fleet's (JAX ``:441``).

The decode modes (JAX ``:89-120``, ``:370-390``): a request retired under
a LoRA adapter also lands in that tenant's ``adapter_<name>_*``
instruments; speculative rounds count ``spec_rounds``, ``spec_proposed``
and ``spec_accepted``, and the snapshot derives ``spec_acceptance_rate``
from them.  Below ``spec_min_acceptance`` (``serving.speculative.
min_acceptance``; 0 disables it) the snapshot adds
``spec_acceptance_below_floor`` and logs a warning once.

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

import logging
import threading
import time
from typing import Dict, List, Optional

from ..telemetry.registry import MetricsRegistry

__all__ = ["ServingMetrics", "aggregate_snapshots"]

# big enough that p99 of a uniform sample is a tight estimate, small enough
# to cap memory at a few KB per engine
_RESERVOIR = 2048


class ServingMetrics:
    """Thread-safe accumulator; ``record_batch`` runs on the flush thread."""

    def __init__(self, replica_id: Optional[int] = None):
        self.replica_id = replica_id
        self._lock = threading.Lock()
        self._registry = MetricsRegistry()
        self._latency_ms = self._registry.histogram("latency_ms", _RESERVOIR)
        self._batch_size = self._registry.histogram("batch_size", _RESERVOIR)
        self._gen_len = self._registry.histogram("gen_len", _RESERVOIR)
        # the scheduler's: slot occupancy and block utilisation (fractions)
        # a decode iteration, host ms a tick, ms between decode dispatches
        self._slot_occ = self._registry.histogram("slot_occupancy", _RESERVOIR)
        self._block_util = self._registry.histogram("block_util", _RESERVOIR)
        self._tick_host_ms = self._registry.histogram("tick_host_ms", _RESERVOIR)
        self._dispatch_gap_ms = self._registry.histogram("decode_dispatch_gap_ms", _RESERVOIR)
        # the batcher path's host ms a batch (its wall time less the wait
        # on the device's results)
        self._batch_host_ms = self._registry.histogram("batch_host_ms", _RESERVOIR)
        # the host ms of each KV-block import a replica serviced
        self._kv_transfer_ms = self._registry.histogram("kv_transfer_ms", _RESERVOIR)
        self._items = 0  # guarded by: self._lock
        self._first_t: Optional[float] = None  # guarded by: self._lock
        self._last_t: Optional[float] = None  # guarded by: self._lock
        self._max_depth = 0  # guarded by: self._lock
        self._prefill_tokens = 0  # guarded by: self._lock
        self._decode_tokens = 0  # guarded by: self._lock
        self._prefill_s = 0.0  # guarded by: self._lock
        self._decode_s = 0.0  # guarded by: self._lock
        # per-adapter (latency, gen_len) histograms, made at first use
        self._adapter_hists: Dict[str, tuple] = {}  # guarded by: self._lock
        self.spec_min_acceptance = 0.0
        self._spec_floor_warned = False  # guarded by: self._lock

    @staticmethod
    def adapter_name(adapter: str, name: str) -> str:
        """Registry name of adapter-scoped instrument ``name``."""
        return f"adapter_{adapter}_{name}"

    def _adapter_instruments(self, adapter: str):
        with self._lock:
            pair = self._adapter_hists.get(adapter)
            if pair is None:
                pair = (self._registry.histogram(self.adapter_name(adapter, "latency_ms"),
                                                 _RESERVOIR),
                        self._registry.histogram(self.adapter_name(adapter, "gen_len"),
                                                 _RESERVOIR))
                self._adapter_hists[adapter] = pair
            return pair

    def incr(self, name: str, n: int = 1) -> None:
        """Bump a named degradation counter (``timeouts``, ``sheds``)."""
        self._registry.counter(name).inc(n)

    def global_name(self, name: str) -> str:
        """The process-registry name of instrument ``name``:
        ``serving_<name>`` without a replica id, ``serving_r<id>_<name>``
        with one."""
        if self.replica_id is None:
            return f"serving_{name}"
        return f"serving_r{self.replica_id}_{name}"

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
        host_ms: Optional[float] = None,
    ) -> None:
        """One flushed batch: per-request enqueue stamps, generated tokens
        (``n_items``; images on the classification path), generated length
        per request, REAL prompt tokens (not the padded bucket area), the
        two phases' wall times and the batch's host ms."""
        now = time.monotonic()
        if host_ms is not None:
            self._batch_host_ms.observe(float(host_ms))
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

    # the continuous scheduler's instruments: requests retire one by one,
    # device time accrues a prefill call or a decode step at a time

    def record_request(self, enqueued_at: float, gen_len: int,
                       adapter: Optional[str] = None) -> None:
        """One retired request: its latency from enqueue and its length,
        also in its LoRA ``adapter``'s own instruments when it has one."""
        now = time.monotonic()
        self._latency_ms.observe((now - enqueued_at) * 1000.0)
        self._gen_len.observe(int(gen_len))
        if adapter is not None:
            lat_h, gen_h = self._adapter_instruments(adapter)
            lat_h.observe((now - enqueued_at) * 1000.0)
            gen_h.observe(int(gen_len))
            self._registry.counter(self.adapter_name(adapter, "requests")).inc()
        with self._lock:
            self._items += int(gen_len)
            if self._first_t is None:
                self._first_t = now
            self._last_t = now

    def record_prefill(self, prompt_tokens: int, n_requests: int, prefill_s: float) -> None:
        """One prefill call: suffix tokens consumed and token 0 of each row."""
        with self._lock:
            self._prefill_tokens += int(prompt_tokens) + int(n_requests)
            self._prefill_s += float(prefill_s)

    def record_decode(self, n_tokens: int, decode_s: float) -> None:
        """One decode step (or drain): the tokens it delivered."""
        with self._lock:
            self._decode_tokens += int(n_tokens)
            self._decode_s += float(decode_s)

    def record_iteration(self, active_slots: int, total_slots: int, blocks_in_use: int,
                         total_blocks: int) -> None:
        """The scheduler's state at one decode iteration."""
        self._slot_occ.observe(active_slots / max(total_slots, 1))
        self._block_util.observe(blocks_in_use / max(total_blocks, 1))

    def record_tick(self, host_ms: float) -> None:
        """One tick's host ms: its wall time less the time it waited on the
        device's results."""
        self._tick_host_ms.observe(float(host_ms))

    def record_dispatch_gap(self, gap_ms: float) -> None:
        """Host ms between two decode dispatches of back-to-back ticks."""
        self._dispatch_gap_ms.observe(float(gap_ms))

    def record_scale_up_ready(self, ms: float) -> None:
        """Wall ms from a scaled-up replica's construction to warm (a gauge:
        the snapshot carries it)."""
        self._registry.gauge("scale_up_ready_ms").set(float(ms))

    def record_kv_transfer(self, *, nbytes: int, seconds: float, blocks: int) -> None:
        """One serviced KV-block import: the bytes and blocks that landed
        and its host time (a rejected payload is the scheduler's
        ``kv_transfer_rejects``)."""
        if nbytes:
            self._registry.counter("kv_transfer_bytes").inc(int(nbytes))
        if blocks:
            self._registry.counter("kv_transfer_blocks").inc(int(blocks))
        self._kv_transfer_ms.observe(float(seconds) * 1000.0)

    def observe_depth(self, depth: int) -> None:
        with self._lock:
            self._max_depth = max(self._max_depth, depth)

    def record_health(self, health: Dict[str, object]) -> None:
        """Mirror a health snapshot's numbers and flags into ``health_*``
        gauges (a ``None`` is left out)."""
        for key, val in health.items():
            if isinstance(val, bool):
                self._registry.gauge(f"health_{key}").set(1.0 if val else 0.0)
            elif isinstance(val, (int, float)):
                self._registry.gauge(f"health_{key}").set(float(val))

    def snapshot(self) -> Dict[str, float]:
        """p50/p99 latency, items/sec, batch occupancy, phase rates; on the
        scheduler's path also slot occupancy, block utilisation, tick and
        dispatch-gap ms and the prefix-hit rate."""
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
        occ, util = self._slot_occ.snapshot(), self._block_util.snapshot()
        if occ["count"]:
            out["slot_occupancy_mean"] = float(occ["mean"])
        if util["count"]:
            out["block_util_mean"] = float(util["mean"])
            out["block_util_max"] = float(util["max"])
        xfer = self._kv_transfer_ms.snapshot()
        if xfer["count"]:
            out["kv_transfer_ms_p50"] = float(xfer["p50"])
            out["kv_transfer_ms_p99"] = float(xfer["p99"])
        for name, hist in (("tick_host_ms", self._tick_host_ms),
                           ("decode_dispatch_gap_ms", self._dispatch_gap_ms),
                           ("batch_host_ms", self._batch_host_ms)):
            h = hist.snapshot()
            if h["count"]:
                out[f"{name}_p50"] = float(h["p50"])
                out[f"{name}_p99"] = float(h["p99"])
                out[f"{name}_mean"] = float(h["mean"])
        counters = self._registry.counters()
        hits = counters.get("prefix_hit_blocks", 0)
        misses = counters.get("prefix_miss_blocks", 0)
        if hits + misses:
            out["prefix_hit_rate"] = float(hits / (hits + misses))
        # the draft proposals the target kept (the bonus token is not counted)
        proposed = counters.get("spec_proposed", 0)
        if proposed:
            rate = float(counters.get("spec_accepted", 0) / proposed)
            out["spec_acceptance_rate"] = rate
            floor = float(self.spec_min_acceptance or 0.0)
            if floor > 0.0 and rate < floor:
                out["spec_acceptance_below_floor"] = 1.0
                with self._lock:
                    warn, self._spec_floor_warned = not self._spec_floor_warned, True
                if warn:
                    logging.getLogger(__name__).warning(
                        "speculative acceptance rate %.1f%% is below the configured "
                        "serving.speculative.min_acceptance floor %.1f%%: draft verification "
                        "costs decode latency instead of saving it; disable "
                        "serving.speculative or use a stronger draft", 100.0 * rate,
                        100.0 * floor)
        with self._lock:
            adapter_hists = dict(self._adapter_hists)
        for name, (lat_h, gen_h) in sorted(adapter_hists.items()):
            a_lat, a_gen = lat_h.snapshot(), gen_h.snapshot()
            if a_lat["count"]:
                pre = self.adapter_name(name, "latency_ms")
                out[f"{pre}_p50"] = float(a_lat["p50"])
                out[f"{pre}_p99"] = float(a_lat["p99"])
                out[f"{pre}_mean"] = float(a_lat["mean"])
            if a_gen["count"]:
                out[self.adapter_name(name, "gen_tokens")] = int(a_gen["sum"])
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


# --------------------------------------------------------------------- #
# the fleet's view

# additive fields (every counter not classified otherwise sums too)
_AGG_SUM = ("requests", "batches", "items", "gen_tokens")
# fields where the fleet takes its worst replica: a percentile of merged
# samples cannot be recovered from per-replica percentiles, the max bounds it
_AGG_MAX = (
    "latency_ms_p50", "latency_ms_p99", "max_queue_depth", "block_util_max",
    "kv_transfer_ms_p50", "kv_transfer_ms_p99", "tick_host_ms_p50", "tick_host_ms_p99",
    "decode_dispatch_gap_ms_p50", "decode_dispatch_gap_ms_p99", "scale_up_ready_ms",
)


def aggregate_snapshots(snapshots: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Fold per-replica :meth:`ServingMetrics.snapshot` dicts into one.

    Counts and token totals sum, and so do rates (the replicas serve at
    once); latency percentiles take the max over replicas (a bound); the
    prefix-hit rate is recomputed from the summed block counters; means,
    other rates and ``health_*`` gauges stay in the per-replica snapshots.
    """
    out: Dict[str, float] = {"replicas": len(snapshots)}
    sums: Dict[str, float] = {}
    maxes: Dict[str, float] = {}
    for snap in snapshots.values():
        for key, val in snap.items():
            if not isinstance(val, (int, float)) or isinstance(val, bool):
                continue
            if key in _AGG_MAX:
                maxes[key] = max(maxes.get(key, val), val)
            elif key.endswith("_per_sec") or key in _AGG_SUM or (
                not key.startswith("health_")
                and not key.endswith(("_mean", "_p50", "_p99", "_rate"))
            ):
                sums[key] = sums.get(key, 0) + val
    out.update(sums)
    out.update(maxes)
    hits = sums.get("prefix_hit_blocks", 0)
    misses = sums.get("prefix_miss_blocks", 0)
    if hits + misses:
        out["prefix_hit_rate"] = float(hits / (hits + misses))
    return out
