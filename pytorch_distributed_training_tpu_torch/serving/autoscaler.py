"""SLO-driven fleet autoscaler: grow on pressure, shrink through drain.

Port of the JAX package's ``serving/autoscaler.py``.
:class:`FleetAutoscaler` grows and shrinks a :class:`.fleet.ServingFleet`
against its thresholds:

**A hand-driven control loop.**  The autoscaler owns no thread: its
driver calls :meth:`FleetAutoscaler.poll` on its own cadence with an
injected ``clock``, so a scaling schedule replays, cooldowns are tested
without sleeping, and the ``autoscale_hang`` fault lands at an exact poll.

**Scale-up through the one resolution.**  New replicas come from
:meth:`.fleet.ServingFleet.add_replica`, over the model that
``ServingFleet.from_config`` resolved once.

**Scale-down only through drain.**  :meth:`.fleet.ServingFleet.
remove_replica` retires the replica from placement and drains it: its
in-flight requests finish on it, token for token, and nothing is killed
or replayed.

Signals: the router's backlog, the busiest usable replica's slot
occupancy (a waiting queue counts as full), the ``serving_r<i>_block_util``
gauges and the fleet's latency p99 against ``target_p99_ms``; each poll
mirrors them into ``autoscale_*`` gauges.  ``serving.autoscale`` is read
with JAX's keys (``:62-88``); its ``workload`` section is carried for
:class:`.workload.TraceGenerator`.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional

from ..engine import fault
from ..telemetry.registry import get_registry

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """Replica-count controller over a :class:`.fleet.ServingFleet`.

    Single-threaded by contract: one driver calls :meth:`poll`; the
    fleet/router handle their own internal concurrency.  ``clock`` is
    any monotonic ``() -> float`` in seconds — trace time in a replay,
    a hand-advanced counter in tests, ``time.monotonic`` in production.
    """

    def __init__(
        self,
        fleet,
        autoscale: Optional[Dict[str, Any]] = None,
        clock: Optional[Callable[[], float]] = None,
        logger: Optional[logging.Logger] = None,
    ):
        asc = dict(autoscale or {})
        self.enabled = bool(asc.pop("enabled", True))
        self.min_replicas = int(asc.pop("min_replicas", 1))
        self.max_replicas = int(asc.pop("max_replicas", 4))
        target = asc.pop("target_p99_ms", None)
        self.target_p99_ms = float(target) if target is not None else None
        self.backlog_high = int(asc.pop("backlog_high", 8))
        self.backlog_low = int(asc.pop("backlog_low", 1))
        self.occupancy_high = float(asc.pop("occupancy_high", 0.85))
        self.occupancy_low = float(asc.pop("occupancy_low", 0.25))
        self.scale_up_cooldown_s = float(asc.pop("scale_up_cooldown_s", 2.0))
        self.scale_down_cooldown_s = float(
            asc.pop("scale_down_cooldown_s", 8.0))
        deadline = asc.pop("drain_deadline_ms", 60_000)
        self.drain_deadline_ms = (
            float(deadline) if deadline is not None else None
        )
        # the trace generator's section, carried opaque for the trace
        # driver (TraceGenerator parses + closes it)
        self.workload = asc.pop("workload", None)
        if asc:
            raise ValueError(
                f"unknown serving.autoscale keys: {sorted(asc)}"
            )
        if self.min_replicas < 1:
            raise ValueError(
                f"autoscale.min_replicas must be >= 1, got "
                f"{self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"autoscale.max_replicas ({self.max_replicas}) < "
                f"min_replicas ({self.min_replicas})"
            )
        if self.backlog_low >= self.backlog_high:
            raise ValueError(
                f"autoscale.backlog_low ({self.backlog_low}) must be < "
                f"backlog_high ({self.backlog_high}) — equal thresholds "
                "flap"
            )
        if self.occupancy_low >= self.occupancy_high:
            raise ValueError(
                f"autoscale.occupancy_low ({self.occupancy_low}) must be "
                f"< occupancy_high ({self.occupancy_high})"
            )
        self.fleet = fleet
        self.logger = logger or logging.getLogger("pdt.serving.autoscale")
        self._clock = clock or time.monotonic
        self._poll_no = 0
        self._last_up_t: Optional[float] = None
        self._last_down_t: Optional[float] = None
        # replica-minutes ledger: integral of live-replica count over the
        # injected clock, the number static peak provisioning is judged by
        self._rm_last_t = self._clock()
        self._replica_seconds = 0.0
        self.scale_ups = 0
        self.scale_downs = 0

    # ------------------------------------------------------------------ #
    # signals

    def signals(self) -> Dict[str, float]:
        """One coherent read of the decision inputs.

        ``backlog`` is the router-level outstanding count;
        ``occupancy`` is the worst usable replica's slot occupancy
        (queue pressure saturates it to 1.0 — a replica with a waiting
        queue is full no matter what its slots say); ``block_util`` is
        the max ``serving_r<i>_block_util`` gauge over live replicas;
        ``p99_ms`` the fleet latency bound (0.0 before any request).
        """
        health = self.fleet.health()
        backlog = float(health.get("outstanding", 0))
        occupancy = 0.0
        reg = get_registry()
        block_util = 0.0
        for snap in health.get("replicas", ()):
            if snap.get("routed_down") or snap.get("retired"):
                continue
            slots = max(float(snap.get("slots", 0) or 0), 1.0)
            occ = float(snap.get("active_slots", 0) or 0) / slots
            if snap.get("queue_depth", 0):
                occ = 1.0
            occupancy = max(occupancy, occ)
            rid = snap.get("replica")
            if rid is not None:
                block_util = max(
                    block_util,
                    reg.gauge(f"serving_r{rid}_block_util").value,
                )
        p99 = 0.0
        if self.target_p99_ms is not None:
            p99 = float(
                self.fleet.snapshot()["fleet"].get("latency_ms_p99", 0.0)
            )
        sig = {
            "backlog": backlog,
            "occupancy": occupancy,
            "block_util": block_util,
            "p99_ms": p99,
            "live_replicas": float(self.fleet.live_replicas()),
        }
        for name, val in sig.items():
            reg.gauge(f"autoscale_{name}").set(val)
        return sig

    # ------------------------------------------------------------------ #
    # control loop

    def poll(self) -> str:
        """One control-loop step: read signals, maybe scale.

        Returns the decision: ``"up"``, ``"down"``, ``"heal"`` (below
        ``min_replicas`` after replica loss), or ``"hold"``.  The
        ``autoscale_hang`` fault kind lands HERE, keyed by this poll's
        1-based index — the hang delays the decision, and the signals
        are read only after it so a stale pre-hang view can never drive
        a scale action (the recovery contract the fault
        checks).
        """
        self._poll_no += 1
        inj = fault.get_injector()
        if inj.active:
            sec = inj.take("autoscale_hang", self._poll_no)
            if sec is not None:
                fault.bump("injected_autoscale_hangs")
                self.logger.warning(
                    "fault injection: autoscale decision hang %.2fs at "
                    "poll %d", float(sec), self._poll_no,
                )
                time.sleep(float(sec))
        if not self.enabled:
            return "hold"
        now = self._clock()
        sig = self.signals()
        live = int(sig["live_replicas"])
        if live < self.min_replicas:
            # below floor (replica loss): heal immediately, no cooldown —
            # the floor IS the availability contract
            self._scale_up(now, "heal to min_replicas")
            return "heal"
        pressure = (
            sig["backlog"] >= self.backlog_high
            or sig["occupancy"] >= self.occupancy_high
            or (
                self.target_p99_ms is not None
                and sig["p99_ms"] > self.target_p99_ms
                and sig["backlog"] > 0
            )
        )
        idle = (
            sig["backlog"] <= self.backlog_low
            and sig["occupancy"] <= self.occupancy_low
            # a breached p99 vetoes shrinking even with an empty queue:
            # removing capacity while over SLO can only widen the breach
            and not (
                self.target_p99_ms is not None
                and sig["p99_ms"] > self.target_p99_ms
            )
        )
        if pressure and live < self.max_replicas:
            if self._cooled(self._last_up_t, self.scale_up_cooldown_s, now):
                self._scale_up(
                    now,
                    f"backlog={sig['backlog']:.0f} "
                    f"occupancy={sig['occupancy']:.2f} "
                    f"p99={sig['p99_ms']:.0f}ms",
                )
                return "up"
        elif idle and live > self.min_replicas and not pressure:
            # scale-down waits out BOTH cooldowns: shrinking right after
            # growing is how autoscalers flap through a flash crowd
            if self._cooled(
                self._last_down_t, self.scale_down_cooldown_s, now
            ) and self._cooled(
                self._last_up_t, self.scale_down_cooldown_s, now
            ):
                self._scale_down(now)
                return "down"
        return "hold"

    @staticmethod
    def _cooled(last: Optional[float], cooldown_s: float,
                now: float) -> bool:
        return last is None or (now - last) >= cooldown_s

    def _scale_up(self, now: float, why: str) -> None:
        self._account(now)
        idx = self.fleet.add_replica()
        self._last_up_t = now
        self.scale_ups += 1
        get_registry().counter("autoscale_ups").inc()
        get_registry().gauge("autoscale_replicas").set(
            float(self.fleet.live_replicas()))
        self.logger.warning(
            "autoscale UP -> replica %d (%d live): %s",
            idx, self.fleet.live_replicas(), why)

    def _scale_down(self, now: float) -> None:
        idx = self.fleet.pick_retire_candidate()
        if idx is None:
            return
        self._account(now)
        drain_ms = self.fleet.remove_replica(
            idx, deadline_ms=self.drain_deadline_ms)
        self._last_down_t = now
        self.scale_downs += 1
        get_registry().counter("autoscale_downs").inc()
        get_registry().gauge("autoscale_replicas").set(
            float(self.fleet.live_replicas()))
        self.logger.warning(
            "autoscale DOWN: replica %d drained in %.1f ms (%d live)",
            idx, drain_ms, self.fleet.live_replicas())

    # ------------------------------------------------------------------ #
    # replica-minutes ledger

    def _account(self, now: float) -> None:
        live = self.fleet.live_replicas()
        self._replica_seconds += max(0.0, now - self._rm_last_t) * live
        self._rm_last_t = now

    def replica_minutes(self) -> float:
        """Integral of live replicas over the injected clock, in
        replica-minutes — the cost axis of the autoscale A/B."""
        self._account(self._clock())
        return self._replica_seconds / 60.0
