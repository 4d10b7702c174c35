"""Fleet router: health-gated, prefix-affine placement and replica failover.

Port of the JAX package's ``serving/router.py``.  :class:`FleetRouter`
fronts N replicas (each an :class:`.engine.InferenceEngine`, or a bare
:class:`.scheduler.ContinuousScheduler` in tests: the router only calls
``submit``/``health``/``drain``/``close`` and, through ``scheduler``,
``hard_kill``/``inject_hang``) and adds what no single replica can:

**Placement.**  A prompt whose first full KV block is the same as an
earlier one's (the prefix cache's first chain link) goes to the same
replica through a bounded sticky map, so that replica's prefix cache hits;
anything else goes to the least-loaded healthy replica (queue depth plus
active slots, ties broken by its ``block_util`` gauge).

**Health gating.**  A replica is eligible while ``health()`` says ready
and its heartbeat file is fresh.  The scheduler thread itself writes the
heartbeat, so a stale file means no progress even when the process looks
alive from inside.

**Failover, token for token.**  The router records every delivered token
of a request.  When a replica dies (its futures fail with a replica-level
error, its heartbeat goes stale, or the ``replica_down``/``replica_hang``
faults fire), its requests go to a survivor with
``replay_tokens=<delivered>`` and the request's original sampling key,
fixed once at fleet submission: the survivor re-prefills the prompt,
re-derives the K/V of the delivered tokens through its own decode calls,
checking each (``replay_parity_mismatch``), and draws the rest with the
per-token seeds ``key + [i]`` the dead replica would have used.
``on_token`` never fires again for a replayed token, and the future
resolves to the stream an unkilled run gives.

**Hedging and backpressure.**  A request without progress for
``hedge_ms`` is dispatched again on another healthy replica; the first
writer of each token wins and a disagreement counts
``serving_fleet_parity_mismatch``.  Past ``max_backlog`` outstanding
requests the router sheds with :class:`.batcher.OverloadedError`.

**Membership.**  The replica list is append-only (an index names a
replica for the router's life) and ``_retired`` keeps drained replicas
out of placement, sweeps, failover and the live count, so the autoscaler
adds and retires replicas while the monitor sweeps and clients place.

One card: every replica shares the process's one CUDA context.  A sticky
CUDA error (an illegal address) poisons it for all of them: each
replica's supervisor spends its restarts and fails its requests with
:class:`.resilience.EngineRestartError`, the router marks each down, and
the requests end in :class:`FleetDownError` rather than hang.  Replica
death on one card is the ``replica_down`` fault or ``hard_kill``.

Lock discipline: ``self._lock`` guards all router state.  Never call
into a replica while holding it: a replica's done-callbacks can run under
its own condition and take ``self._lock``.  Client futures resolve
outside every lock; ``on_token`` runs under ``self._lock`` to keep token
order (keep it cheap, and never call back into the fleet from it).
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..engine import fault
from ..telemetry.registry import get_registry
from .batcher import OverloadedError
from .resilience import EngineRestartError

__all__ = ["FleetDownError", "FleetRouter", "ReplicaDownError"]


class ReplicaDownError(RuntimeError):
    """A whole replica is gone (hard-killed, heartbeat stale, restart
    budget spent): the router fails its requests over instead of passing
    this to clients."""


class FleetDownError(RuntimeError):
    """No healthy replica is left to fail over to."""


# errors that condemn the replica, not the request
_REPLICA_ERRORS = (ReplicaDownError, EngineRestartError)


class _Assignment:
    """One dispatch of a request onto one replica."""

    __slots__ = ("replica_idx", "next_idx", "removed")

    def __init__(self, replica_idx: int, next_idx: int):
        self.replica_idx = replica_idx
        # the index in the delivered stream of this dispatch's next token
        self.next_idx = next_idx  # guarded by: the router's _lock
        self.removed = False  # guarded by: the router's _lock


class _FleetRequest:
    """The router's state of one client request across failovers."""

    __slots__ = ("prompt", "max_new", "deadline_ms", "key", "on_token", "future", "delivered",
                 "assignments", "affinity_key", "last_progress", "done", "pending_failover",
                 "hedged")

    def __init__(self, prompt, max_new, deadline_ms, key, on_token, affinity_key):
        self.prompt = prompt  # 1-D np.int32
        self.max_new = max_new
        self.deadline_ms = deadline_ms
        self.key = key  # the one sampling key every dispatch reuses
        self.on_token = on_token
        self.future: Future = Future()
        self.delivered: List[int] = []  # guarded by: the router's _lock
        self.assignments: List[_Assignment] = []  # guarded by: the router's _lock
        self.affinity_key = affinity_key
        self.last_progress = time.monotonic()  # guarded by: the router's _lock
        self.done = False  # guarded by: the router's _lock
        self.pending_failover = False  # guarded by: the router's _lock
        self.hedged = False  # guarded by: the router's _lock


class FleetRouter:
    """Health-aware front end over N serving replicas.

    ``submit`` takes the replica's arguments (prompt, ``deadline_ms``,
    ``max_new_tokens``, ``on_token``, ``key``) and its future resolves to
    the same ``{"tokens", "gen_len"}``.  A request's key is ``key`` or
    ``base_key + (n,)`` for the router's n-th submission (``base_key``
    defaults to ``(seed,)``), the same on every dispatch of the request.
    """

    def __init__(
        self,
        replicas: Sequence[Any],
        base_key: Optional[Sequence[int]] = None,
        seed: int = 0,
        affinity: bool = True,
        affinity_capacity: int = 256,
        max_backlog: Optional[int] = None,
        hedge_ms: Optional[float] = None,
        heartbeat_timeout_s: Optional[float] = 2.0,
        poll_interval_s: float = 0.05,
        start_monitor: bool = True,
        logger: Optional[logging.Logger] = None,
    ):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        if max_backlog is not None and max_backlog < 1:
            raise ValueError(f"max_backlog must be >= 1, got {max_backlog}")
        if hedge_ms is not None and hedge_ms <= 0:
            raise ValueError(f"hedge_ms must be > 0, got {hedge_ms}")
        # append-only: an index names a replica for good
        self._replicas: List[Any] = list(replicas)  # guarded by: self._lock
        self._retired: set = set()  # guarded by: self._lock
        self.logger = logger or logging.getLogger("pdt.serving.fleet")
        self.affinity = bool(affinity)
        self.affinity_capacity = int(affinity_capacity)
        self.max_backlog = max_backlog
        self.hedge_ms = hedge_ms
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.poll_interval_s = float(poll_interval_s)
        self._base_key = tuple(int(k) for k in base_key) if base_key is not None else (int(seed),)
        self._lock = threading.Lock()
        self._seq_no = 0  # guarded by: self._lock
        self._outstanding: List[_FleetRequest] = []  # guarded by: self._lock
        self._down: set = set()  # guarded by: self._lock
        self._failover_q: deque = deque()  # guarded by: self._lock
        self._sticky: OrderedDict = OrderedDict()  # guarded by: self._lock
        self._closed = False  # guarded by: self._lock
        self._poll_no = 0  # confined: the monitor thread (or the test driving _poll_once)
        self._start_wall = time.time()
        self._stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        if start_monitor:
            self._monitor_thread = threading.Thread(target=self._monitor, name="fleet-monitor",
                                                    daemon=True)
            self._monitor_thread.start()

    # ------------------------------------------------------------------ #
    # membership

    @property
    def replicas(self) -> List[Any]:
        """Locked snapshot of the replica list (retired ones stay in place:
        renumbering would corrupt every in-flight assignment)."""
        with self._lock:
            return list(self._replicas)

    def add_replica(self, rep: Any) -> int:
        """Join a started, warmed replica to the fleet; returns its index."""
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet router is closed")
            self._replicas.append(rep)
            idx = len(self._replicas) - 1
        self._bump("replicas_added")
        self.logger.warning("replica %d joined the fleet", idx)
        return idx

    def retire_replica(self, idx: int) -> None:
        """Take replica ``idx`` out of placement (scale-down, step 1).  Its
        in-flight requests complete on it (the owner drains it after).
        Refuses the last live replica."""
        with self._lock:
            if not 0 <= idx < len(self._replicas):
                raise IndexError(f"no replica {idx} (fleet has {len(self._replicas)})")
            if idx in self._retired:
                return
            unusable = self._down | self._retired
            live = [i for i in range(len(self._replicas)) if i not in unusable]
            if live == [idx]:
                raise ValueError(f"refusing to retire replica {idx}: it is the last live replica")
            self._retired.add(idx)
            for key in [k for k, v in self._sticky.items() if v == idx]:
                del self._sticky[key]
        self._bump("replicas_retired")
        self.logger.warning("replica %d retired from placement", idx)

    def retired(self) -> set:
        with self._lock:
            return set(self._retired)

    def live_indices(self) -> List[int]:
        """Indices neither down nor retired: the fleet's size."""
        with self._lock:
            unusable = self._down | self._retired
            return [i for i in range(len(self._replicas)) if i not in unusable]

    # ------------------------------------------------------------------ #
    # client side

    def submit(
        self,
        prompt,
        deadline_ms: Optional[float] = None,
        max_new_tokens: Optional[int] = None,
        on_token: Optional[Callable[[int], None]] = None,
        key: Optional[Sequence[int]] = None,
    ) -> Future:
        """Route one prompt to a healthy replica; the future survives that
        replica's death."""
        prompt = np.asarray(prompt, np.int32)
        healthy = self._healthy()  # calls into replicas: before taking _lock
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet router is closed")
            if len(self._replicas) - len(self._down | self._retired) <= 0:
                raise FleetDownError("every replica is down")
            if self.max_backlog is not None and len(self._outstanding) >= self.max_backlog:
                self._bump("sheds")
                raise OverloadedError(f"fleet backlog full ({self.max_backlog} outstanding); "
                                      "request shed at the router")
            # the router's keys, not a replica's: a failover or a hedge
            # draws the same stream anywhere
            key = tuple(int(k) for k in key) if key is not None else self._base_key + (
                self._seq_no,)
            self._seq_no += 1
            affinity_key = self._affinity_key_locked(prompt)
            freq = _FleetRequest(prompt, max_new_tokens, deadline_ms, key, on_token,
                                 affinity_key)
            self._outstanding.append(freq)
            target = self._place_locked(affinity_key, healthy)
        self._bump("submitted")
        if target is None:
            self._fail(freq, OverloadedError("no healthy replica available for admission"))
            self._bump("sheds")
            return freq.future
        try:
            self._dispatch(freq, target)
        except OverloadedError:
            # a replica's shed ends the fleet request (clients retry sheds)
            with self._lock:
                freq.done = True
                self._discard_locked(freq)
            self._bump("sheds")
            raise
        return freq.future

    def peek_placement(self, prompt) -> Optional[int]:
        """The replica :meth:`submit` would route ``prompt`` to now (the
        sticky map updated, so the following submit lands there unless it
        dies first); ``None`` when none is healthy.  The disaggregation
        coordinator asks before it stages a transfer."""
        prompt = np.asarray(prompt, np.int32)
        healthy = self._healthy()
        with self._lock:
            if self._closed:
                return None
            return self._place_locked(self._affinity_key_locked(prompt), healthy)

    def depth(self) -> int:
        """Requests accepted and not yet resolved."""
        with self._lock:
            return len(self._outstanding)

    def health(self) -> Dict[str, Any]:
        """Each replica's snapshot and the fleet's gates."""
        snaps = []
        for idx, rep in enumerate(self.replicas):
            with self._lock:
                down, out = idx in self._down, idx in self._retired
            snap = {"replica": idx, "routed_down": down, "retired": out}
            try:
                snap.update(rep.health())
            except Exception as e:  # a dead replica must not hide the rest
                snap.update(ready=False, live=False, error=str(e))
            snap["heartbeat_stale"] = self._is_stale(rep)
            snaps.append(snap)
        usable = [s for s in snaps if s["ready"] and not s["routed_down"] and not s["retired"]
                  and not s["heartbeat_stale"]]
        with self._lock:
            outstanding, closed = len(self._outstanding), self._closed
        return {
            "ready": bool(usable) and not closed,
            "live": any(s["live"] and not s["routed_down"] for s in snaps),
            "healthy_replicas": len(usable),
            "replicas": snaps,
            "outstanding": outstanding,
        }

    def stop_submissions(self) -> None:
        """Refuse new submits (drain, step 1); in-flight work goes on."""
        with self._lock:
            self._closed = True

    def shutdown(self) -> None:
        """Stop the monitor.  The replicas are the fleet's to close."""
        with self._lock:
            self._closed = True
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join()
            self._monitor_thread = None

    # ------------------------------------------------------------------ #
    # placement

    def _affinity_key_locked(self, prompt: np.ndarray) -> Optional[Tuple[int, ...]]:
        """The prompt's first full KV block, when the pool would cache one
        (``(len - 1) // block_size >= 1``)."""
        if not self.affinity:
            return None
        sched = self._sched_of_locked(0)
        bs = getattr(sched, "_block_size", None) if sched is not None else None
        if bs is None or (int(prompt.size) - 1) // bs < 1:
            return None
        return tuple(int(t) for t in prompt[:bs])

    def _sched_of(self, idx: int):
        with self._lock:
            return self._sched_of_locked(idx)

    def _sched_of_locked(self, idx: int):
        """The replica's scheduler (an engine holds one; tests pass it
        bare).  Reads attributes only."""
        rep = self._replicas[idx]
        sched = getattr(rep, "scheduler", None)
        if sched is not None:
            return sched
        return rep if hasattr(rep, "hard_kill") else None

    def _healthy(self) -> List[Tuple[int, Dict[str, Any]]]:
        """(index, health snapshot) of every admissible replica.  Calls into
        replicas: never under ``self._lock``."""
        with self._lock:
            unusable = self._down | self._retired
            closed = self._closed
            reps = list(self._replicas)
        if closed:
            return []
        out = []
        for idx, rep in enumerate(reps):
            if idx in unusable:
                continue
            try:
                snap = rep.health()
            except Exception:
                continue
            if snap.get("ready") and not self._is_stale(rep):
                out.append((idx, snap))
        return out

    def _load_score(self, snap: Dict[str, Any], sched) -> Tuple[float, float]:
        depth = float(snap.get("queue_depth", 0) + snap.get("active_slots", 0))
        util = 0.0
        if sched is not None and hasattr(sched, "metrics"):
            util = get_registry().gauge(sched.metrics.global_name("block_util")).value
        return depth, util

    def _place_locked(self, key, healthy) -> Optional[int]:
        """Sticky by prefix first, else the least loaded."""
        if not healthy:
            return None
        healthy_idx = {idx for idx, _ in healthy}
        if key is not None:
            cached = self._sticky.get(key)
            if cached is not None and cached in healthy_idx:
                self._sticky.move_to_end(key)
                self._bump("affinity_hits")
                return cached
        target = min(healthy, key=lambda h: self._load_score(h[1], self._sched_of_locked(h[0])))[0]
        if key is not None:
            self._sticky[key] = target
            self._sticky.move_to_end(key)
            while len(self._sticky) > self.affinity_capacity:
                self._sticky.popitem(last=False)
        return target

    # ------------------------------------------------------------------ #
    # dispatch and delivery

    def _dispatch(self, freq: _FleetRequest, idx: int, replay: bool = False) -> None:
        """Submit ``freq`` to replica ``idx``; raises what its ``submit``
        raises, and the caller decides whether that is fatal."""
        with self._lock:
            a = _Assignment(idx, len(freq.delivered))
            freq.assignments.append(a)
            replay_tokens = list(freq.delivered) if replay else None
            rep = self._replicas[idx]
        try:
            fut = rep.submit(freq.prompt, deadline_ms=freq.deadline_ms,
                             max_new_tokens=freq.max_new,
                             on_token=lambda tok, f=freq, asn=a: self._deliver(f, asn, tok),
                             key=freq.key, replay_tokens=replay_tokens)
        except BaseException:
            with self._lock:
                a.removed = True
                if a in freq.assignments:
                    freq.assignments.remove(a)
            raise
        fut.add_done_callback(lambda f, fr=freq, asn=a: self._on_assignment_done(fr, asn, f))

    def _deliver(self, freq: _FleetRequest, a: _Assignment, tok: int) -> None:
        """A streamed token of one dispatch: the first writer of each index
        wins.  On the replica's scheduler thread."""
        with self._lock:
            idx = a.next_idx
            a.next_idx += 1
            if idx < len(freq.delivered):
                # a slower twin (a hedge, or a hung replica woken) repeating a
                # delivered token: dropped, but checked
                if freq.delivered[idx] != int(tok):
                    self._bump("parity_mismatch")
                    self.logger.error(
                        "fleet parity mismatch at token %d: replica %d says %d, delivered %d",
                        idx, a.replica_idx, int(tok), freq.delivered[idx])
                return
            freq.delivered.append(int(tok))
            freq.last_progress = time.monotonic()
            if freq.on_token is not None:
                try:
                    freq.on_token(int(tok))
                except Exception:
                    self.logger.exception("fleet on_token callback failed")

    def _on_assignment_done(self, freq: _FleetRequest, a: _Assignment, fut: Future) -> None:
        """One dispatch's end.  May run on a replica's thread under its
        condition: it classifies and queues, never calls into a replica."""
        exc = fut.exception()
        if exc is None:
            self._complete(freq, fut.result())
        elif isinstance(exc, _REPLICA_ERRORS):
            self._replica_failed(freq, a, exc)
        else:
            self._request_failed(freq, a, exc)

    def _complete(self, freq: _FleetRequest, result) -> None:
        with self._lock:
            if freq.done:
                return
            freq.done = True
            self._discard_locked(freq)
            toks = [int(t) for t in np.asarray(result["tokens"]).ravel()]
            if toks[: len(freq.delivered)] != freq.delivered[: len(toks)]:
                self._bump("parity_mismatch")
                self.logger.error("fleet parity mismatch: winner result %s != delivered %s",
                                  toks[:8], freq.delivered[:8])
            self._bump("completed")
        freq.future.set_result(result)

    def _fail(self, freq: _FleetRequest, exc: BaseException) -> None:
        with self._lock:
            if freq.done:
                return
            freq.done = True
            self._discard_locked(freq)
        freq.future.set_exception(exc)

    def _discard_locked(self, freq: _FleetRequest) -> None:
        try:
            self._outstanding.remove(freq)
        except ValueError:
            pass

    def _replica_failed(self, freq: _FleetRequest, a: _Assignment, exc: BaseException) -> None:
        """The replica died under this request: mark it down and queue the
        request for failover (the monitor dispatches it)."""
        with self._lock:
            newly_down = a.replica_idx not in self._down
            self._down.add(a.replica_idx)
            a.removed = True
            if a in freq.assignments:
                freq.assignments.remove(a)
            if not freq.done and not freq.assignments and not freq.pending_failover:
                freq.pending_failover = True
                self._failover_q.append(freq)
        if newly_down:
            self._bump("replicas_down")
            self.logger.error("replica %d marked down: %s", a.replica_idx, exc)

    def _request_failed(self, freq: _FleetRequest, a: _Assignment, exc: BaseException) -> None:
        """The request is at fault (poison, deadline, shed): its error goes
        to the client unless a twin still runs."""
        with self._lock:
            a.removed = True
            if a in freq.assignments:
                freq.assignments.remove(a)
            if freq.done or freq.assignments:
                return
        self._fail(freq, exc)

    # ------------------------------------------------------------------ #
    # the monitor: faults, health sweep, failover, hedges

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self._poll_once()
            except Exception:
                # the monitor is the fleet's recovery: it outlives its bugs
                self.logger.exception("fleet monitor poll failed")

    def _poll_once(self) -> None:
        self._poll_no += 1
        self._consult_injector()
        self._sweep_health()
        self._drain_failover_q()
        if self.hedge_ms is not None:
            self._sweep_hedges()

    def _consult_injector(self) -> None:
        """``replica_down@P[:R]`` and ``replica_hang@P[:SEC]``, at this
        monitor's 1-based poll index."""
        inj = fault.get_injector()
        if not inj.active:
            return
        arg = inj.take("replica_down", self._poll_no)
        if arg is not None:
            idx = int(arg)
            with self._lock:
                known = 0 <= idx < len(self._replicas)
            if known:
                fault.bump("injected_replica_downs")
                self.logger.warning("fault injection: replica_down -> replica %d at poll %d",
                                    idx, self._poll_no)
                sched = self._sched_of(idx)
                if sched is not None:
                    sched.hard_kill(ReplicaDownError(
                        f"injected replica_down at router poll {self._poll_no}"))
        sec = inj.take("replica_hang", self._poll_no)
        if sec is not None:
            fault.bump("injected_replica_hangs")
            self.logger.warning("fault injection: replica_hang %.2fs -> replica 0 at poll %d",
                                float(sec), self._poll_no)
            sched = self._sched_of(0)
            if sched is not None:
                sched.inject_hang(float(sec))

    def _is_stale(self, rep: Any) -> bool:
        """The replica's heartbeat file is older than the timeout (an
        unwritten file counts from the router's start)."""
        if self.heartbeat_timeout_s is None:
            return False
        path = getattr(rep, "heartbeat_path", None)
        if not path:
            return False
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            mtime = self._start_wall
        return (time.time() - mtime) > self.heartbeat_timeout_s

    def _sweep_health(self) -> None:
        """Mark down the replicas with a stale heartbeat or a failed
        liveness probe, and queue their requests for failover."""
        for idx, rep in enumerate(self.replicas):
            with self._lock:
                # a retired replica drains on its own clock
                if idx in self._down or idx in self._retired:
                    continue
            stale = self._is_stale(rep)
            dead = False
            if not stale:
                try:
                    dead = not rep.health()["live"]
                except Exception:
                    dead = True
            if stale or dead:
                self._mark_down(idx, "heartbeat stale" if stale else "liveness probe failed")

    def _mark_down(self, idx: int, reason: str) -> None:
        with self._lock:
            if idx in self._down or idx in self._retired:
                return
            self._down.add(idx)
            victims = []
            for freq in self._outstanding:
                mine = [a for a in freq.assignments if a.replica_idx == idx]
                for a in mine:
                    a.removed = True
                    freq.assignments.remove(a)
                if mine and not freq.done and not freq.assignments and not freq.pending_failover:
                    freq.pending_failover = True
                    victims.append(freq)
            self._failover_q.extend(victims)
        self._bump("replicas_down")
        self.logger.error("replica %d marked down: %s", idx, reason)
        sched = self._sched_of(idx)
        if sched is not None:
            # fail what it still holds if it ever wakes; the done-callbacks
            # find pending_failover set and stay quiet
            sched.hard_kill(ReplicaDownError(f"router: {reason}"))

    def _drain_failover_q(self) -> None:
        while True:
            with self._lock:
                if not self._failover_q:
                    return
                freq = self._failover_q.popleft()
                if freq.done:
                    freq.pending_failover = False
                    continue
            self._failover(freq)

    def _failover(self, freq: _FleetRequest) -> None:
        """Dispatch again on a survivor, replaying the delivered tokens."""
        dispatched = False
        for idx, _snap in sorted(self._healthy(),
                                 key=lambda h: self._load_score(h[1], self._sched_of(h[0]))):
            try:
                self._dispatch(freq, idx, replay=True)
                dispatched = True
                break
            except Exception as e:
                self.logger.warning("failover dispatch to replica %d refused: %s", idx, e)
        with self._lock:
            freq.pending_failover = False
            if dispatched:
                freq.last_progress = time.monotonic()
        if dispatched:
            self._bump("failovers")
            self.logger.warning("failed request over with %d delivered token(s) replayed",
                                len(freq.delivered))
        else:
            self._fail(freq, FleetDownError("no healthy replica left to fail over to"))

    def _sweep_hedges(self) -> None:
        now = time.monotonic()
        limit = self.hedge_ms / 1000.0
        with self._lock:
            stragglers = [f for f in self._outstanding
                          if not f.done and not f.hedged and not f.pending_failover
                          and len(f.assignments) == 1 and (now - f.last_progress) > limit]
            for f in stragglers:
                f.hedged = True
        for f in stragglers:
            self._hedge(f)

    def _hedge(self, freq: _FleetRequest) -> None:
        """Dispatch a straggler again on another healthy replica; both run
        and :meth:`_deliver` takes the first writer of each token."""
        with self._lock:
            busy = {a.replica_idx for a in freq.assignments}
        healthy = [(i, s) for i, s in self._healthy() if i not in busy]
        if not healthy:
            return
        idx = min(healthy, key=lambda h: self._load_score(h[1], self._sched_of(h[0])))[0]
        try:
            self._dispatch(freq, idx, replay=True)
        except Exception as e:
            self.logger.warning("hedge dispatch to replica %d refused: %s", idx, e)
            return
        self._bump("hedges")
        self.logger.warning("hedged straggler onto replica %d (%d token(s) replayed)", idx,
                            len(freq.delivered))

    # ------------------------------------------------------------------ #

    @staticmethod
    def _bump(name: str, n: int = 1) -> None:
        # the registry has its own lock and never calls out: safe under _lock
        get_registry().counter(f"serving_fleet_{name}").inc(n)
