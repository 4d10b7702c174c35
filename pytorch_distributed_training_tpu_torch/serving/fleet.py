"""N serving replicas and one router: a fleet that survives replica loss.

Port of the JAX package's ``serving/fleet.py``.  :class:`ServingFleet`
owns the replicas' lifecycle, which the router does not: it builds N
:class:`.engine.InferenceEngine` replicas from one
:meth:`.engine.InferenceEngine.resolve_config` (the weights loaded or
drawn once, one model on the card that every replica serves, each with
its own scheduler and paged pool), stamps each with its identity
(``replica_id`` for its registry names, a heartbeat file for outside
liveness), fronts them with a :class:`.router.FleetRouter`, and gives the
fleet's verbs: concurrent ``drain``, SIGTERM through
``install_drain_handler``, ``health``/``snapshot`` over all replicas, and
the autoscaler's ``add_replica``/``remove_replica``.

Config (``serving.fleet``, JAX ``:91-163``; unknown keys raise)::

    serving:
      scheduler: {enabled: true, ...}   # the fleet needs the scheduler path
      fleet:
        replicas: 2                # engines in this process
        affinity: true             # prefix-sticky placement
        hedge_ms: null             # straggler re-dispatch (null: off)
        max_backlog: null          # fleet-level shed threshold (null: off)
        heartbeat_dir: null        # default: a fresh temporary directory
        heartbeat_interval_s: 0.25
        heartbeat_timeout_s: 2.0   # the router marks staler replicas down
        liveness_timeout_s: null   # the in-process stall clock of health()
        poll_interval_s: 0.05      # the router's monitor

One process, as the JAX package's: the fleet is N slot arrays and N pools
beside one model, on one card.  The replicas' loops share one Python
interpreter, so the host may set the pace (``PERF.md``).
"""
from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Sequence

from .engine import InferenceEngine, ResolvedModel
from .metrics import aggregate_snapshots
from .router import FleetRouter

__all__ = ["ServingFleet"]


class ServingFleet:
    """Replica lifecycle and fleet verbs over a :class:`FleetRouter`."""

    def __init__(
        self,
        replicas: Sequence[Any],
        router: FleetRouter,
        heartbeat_dir: Optional[str] = None,
        logger: Optional[logging.Logger] = None,
        replica_factory: Optional[Callable[[int], Any]] = None,
    ):
        if not replicas:
            raise ValueError("ServingFleet needs at least one replica")
        # the router's append-only list, index for index
        self._replicas = list(replicas)  # guarded by: self._close_lock
        self._removed: set = set()  # guarded by: self._close_lock
        self.router = router
        self.heartbeat_dir = heartbeat_dir
        self.logger = logger or logging.getLogger("pdt.serving.fleet")
        # builds one started replica for a replica id: the scale-up path,
        # over from_config's one resolution
        self.replica_factory = replica_factory
        # a DisaggFleet installs its FleetCacheDirectory here, so that
        # remove_replica evicts a retiree's entries before its drain
        self.cache_directory = None
        self._next_replica_id = len(self._replicas)  # guarded by: self._close_lock
        self._closed = False  # guarded by: self._close_lock
        self._close_lock = threading.Lock()

    @property
    def replicas(self):
        """Locked snapshot, index for index the router's."""
        with self._close_lock:
            return list(self._replicas)

    # ------------------------------------------------------------------ #

    @classmethod
    def from_config(cls, cfg: Dict[str, Any], device=None, logger=None,
                    state_dict=None) -> "ServingFleet":
        """N replicas from one resolution of a ``serve-*.yml`` config on
        ``device`` (default ``cuda``)."""
        logger = logger or logging.getLogger(__name__)
        serve = cfg["serving"]
        fleet_cfg = dict(serve.get("fleet") or {})
        n = int(fleet_cfg.pop("replicas", 2))
        if n < 1:
            raise ValueError(f"serving.fleet.replicas must be >= 1, got {n}")
        affinity = bool(fleet_cfg.pop("affinity", True))
        hedge_ms = fleet_cfg.pop("hedge_ms", None)
        max_backlog = fleet_cfg.pop("max_backlog", None)
        heartbeat_dir = fleet_cfg.pop("heartbeat_dir", None)
        hb_interval = float(fleet_cfg.pop("heartbeat_interval_s", 0.25))
        hb_timeout = fleet_cfg.pop("heartbeat_timeout_s", 2.0)
        liveness = fleet_cfg.pop("liveness_timeout_s", None)
        poll_s = float(fleet_cfg.pop("poll_interval_s", 0.05))
        if fleet_cfg:
            raise ValueError(f"unknown serving.fleet keys: {sorted(fleet_cfg)}")
        sched_cfg = serve.get("scheduler") or {}
        if cfg["model"].get("name", "").lower() != "transformerlm" or not sched_cfg.get(
                "enabled"):
            raise ValueError(
                "serving.fleet requires an LM with serving.scheduler.enabled (failover replays "
                "token streams through the continuous scheduler; the batcher path cannot "
                "continue a request)")
        model, kwargs = InferenceEngine.resolve_config(cfg, device=device, logger=logger,
                                                       state_dict=state_dict)
        assert isinstance(model, ResolvedModel)
        if heartbeat_dir is None:
            heartbeat_dir = tempfile.mkdtemp(prefix="pdt-fleet-hb-")
        os.makedirs(heartbeat_dir, exist_ok=True)

        def _make_replica(rid: int) -> InferenceEngine:
            # over the one resolution: a scaled-up replica serves the same
            # model as the first ones, with the next identity
            return InferenceEngine(
                model, **kwargs, replica_id=rid,
                heartbeat_path=os.path.join(heartbeat_dir, f"replica_{rid}.json"),
                heartbeat_interval_s=hb_interval, liveness_timeout_s=liveness)

        replicas = [_make_replica(i) for i in range(n)]
        router = FleetRouter(
            replicas, seed=int(serve.get("seed", 0)), affinity=affinity,
            max_backlog=int(max_backlog) if max_backlog is not None else None,
            hedge_ms=float(hedge_ms) if hedge_ms is not None else None,
            heartbeat_timeout_s=float(hb_timeout) if hb_timeout is not None else None,
            poll_interval_s=poll_s, logger=logger)
        logger.info("serving fleet up: %d replica(s), affinity=%s, hedge_ms=%s, heartbeats in %s",
                    n, affinity, hedge_ms, heartbeat_dir)
        return cls(replicas, router, heartbeat_dir=heartbeat_dir, logger=logger,
                   replica_factory=_make_replica)

    # ------------------------------------------------------------------ #
    # client verbs (the router's)

    def submit(self, prompt, deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None, key=None) -> Future:
        return self.router.submit(prompt, deadline_ms=deadline_ms,
                                  max_new_tokens=max_new_tokens, on_token=on_token, key=key)

    def depth(self) -> int:
        return self.router.depth()

    def health(self) -> Dict[str, Any]:
        return self.router.health()

    def snapshot(self) -> Dict[str, Any]:
        """Each replica's metrics snapshot and their aggregate
        (:func:`.metrics.aggregate_snapshots`)."""
        per = {f"r{i}": rep.metrics.snapshot() for i, rep in enumerate(self.replicas)
               if hasattr(rep, "metrics")}
        return {"fleet": aggregate_snapshots(per), "replicas": per}

    # ------------------------------------------------------------------ #
    # membership (the autoscaler's verbs)

    def live_replicas(self) -> int:
        """Replicas that placement may use: neither down nor retired."""
        return len(self.router.live_indices())

    def pick_retire_candidate(self) -> Optional[int]:
        """The replica a scale-down takes: the highest live index (the last
        added leaves first; the old ones keep their warm prefix caches).
        ``None`` with one live replica left."""
        live = self.router.live_indices()
        return max(live) if len(live) > 1 else None

    def add_replica(self) -> int:
        """One more replica from the stored factory, warmed before it joins
        placement (its first request pays no first-call costs); the time
        from construction to warm is its ``scale_up_ready_ms``.  Returns its
        index."""
        if self.replica_factory is None:
            raise RuntimeError("fleet has no replica_factory (build it with from_config, or "
                               "pass replica_factory=): cannot scale up")
        with self._close_lock:
            if self._closed:
                raise RuntimeError("fleet is closed")
            rid = self._next_replica_id
            self._next_replica_id = rid + 1
        t0 = time.monotonic()
        rep = self.replica_factory(rid)
        try:
            if hasattr(rep, "warmup"):
                rep.warmup()
            ready_ms = (time.monotonic() - t0) * 1000.0
            if hasattr(rep, "metrics"):
                rep.metrics.record_scale_up_ready(ready_ms)
            self.logger.info("replica %d warm in %.0f ms (construction + warmup)", rid, ready_ms)
            idx = self.router.add_replica(rep)
        except BaseException:
            rep.close()
            raise
        with self._close_lock:
            self._replicas.append(rep)
        if idx != rid:  # both lists are append-only: a drift is a bug
            self.logger.error("fleet/router replica index drift: router %d, fleet %d", idx, rid)
        return idx

    def remove_replica(self, idx: int, deadline_ms: Optional[float] = None) -> float:
        """Scale down through the one graceful path: retire ``idx`` from
        placement, drain its in-flight requests (bounded by
        ``deadline_ms``), close it.  Returns the drain's wall ms.  Its
        streams finish on it, as an unscaled run's."""
        self.router.retire_replica(idx)
        if self.cache_directory is not None:
            # before the drain: a directory hit must never name a replica
            # that can no longer export
            n = self.cache_directory.evict_replica(idx)
            if n:
                self.logger.info("evicted %d fleet-cache entries of retiring replica %d", n, idx)
        with self._close_lock:
            rep = self._replicas[idx]
            already = idx in self._removed
            self._removed.add(idx)
        if already:
            return 0.0
        t0 = time.monotonic()
        try:
            rep.drain(deadline_ms)
        finally:
            try:
                rep.close()
            except Exception:
                self.logger.exception("replica %d close failed after drain", idx)
        ms = (time.monotonic() - t0) * 1000.0
        self.logger.info("fleet scaled down: replica %d drained and closed in %.1f ms", idx, ms)
        return ms

    # ------------------------------------------------------------------ #
    # lifecycle

    def drain(self, deadline_ms: Optional[float] = None) -> float:
        """Graceful shutdown: the router refuses new submits, every replica
        drains at once (each bounded by ``deadline_ms``: drains in turn
        would add the deadlines up), then the monitor stops.  Returns wall
        ms.  Idempotent, from any thread."""
        t0 = time.monotonic()
        with self._close_lock:
            if self._closed:
                return 0.0
            self._closed = True
            live = [(i, rep) for i, rep in enumerate(self._replicas) if i not in self._removed]
        self.router.stop_submissions()
        threads = [threading.Thread(target=rep.drain, args=(deadline_ms,),
                                    name=f"fleet-drain-{i}", daemon=True) for i, rep in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.router.shutdown()
        ms = (time.monotonic() - t0) * 1000.0
        self.logger.info("fleet drained in %.1f ms", ms)
        return ms

    def install_drain_handler(self, signum=None) -> None:
        """Route SIGTERM (or ``signum``) to :meth:`drain`.  The handler only
        starts a daemon thread (a drain joins scheduler threads, which a
        signal handler must not do inline).  Call from the main thread."""
        import signal

        signum = signal.SIGTERM if signum is None else signum

        def _handler(sig, frame):
            self.logger.warning("signal %s received - draining serving fleet", sig)
            threading.Thread(target=self.drain, name="fleet-drain", daemon=True).start()

        signal.signal(signum, _handler)

    def close(self) -> None:
        """Hard stop: the router first (so nothing re-dispatches into a
        closing replica), then every replica."""
        with self._close_lock:
            if self._closed:
                live = []
            else:
                self._closed = True
                live = [rep for i, rep in enumerate(self._replicas) if i not in self._removed]
        self.router.shutdown()
        for rep in live:
            try:
                rep.close()
            except Exception:
                self.logger.exception("replica close failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
