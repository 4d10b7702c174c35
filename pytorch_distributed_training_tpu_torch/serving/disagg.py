"""Prefill/decode disaggregation with a fleet-shared KV cache tier.

Port of the JAX package's ``serving/disagg.py``.  Dedicated prefill
replicas take the prompt phase, and the replicas' prefix caches federate
into one fleet tier: a miss on the replica that will decode but a hit
elsewhere becomes a block transfer (:mod:`.kv_transfer`) instead of a
recompute.

The decode fleet is a plain :class:`.fleet.ServingFleet` (placement,
failover, the autoscaler's verbs unchanged).  The prefill replicas come
from the same ``replica_factory`` (so they serve the one shared model) but
are never registered with the router: they serve only
``max_new_tokens=1`` priming requests that fill their pools for export.
A :class:`FleetCacheDirectory` maps a prompt's first-block key (the
router's affinity key, seeded with the namespace as the pool's chain keys
are) to the decode replica holding that prefix;
``ServingFleet.remove_replica`` evicts a retiree's entries before its
drain.

Parity: the same prefill on the same weights writes the same K/V, so a
transferred block equals the block the decode replica would have
computed, and every rung of the ladder below gives the same tokens:

==========================  =========================================
transfer fault              recovery (counter)
==========================  =========================================
prefill replica dies        the export fails -> local recompute
mid-transfer                (``serving_disagg_transfer_recomputes``)
corrupt payload             CRC-32 reject at import, the chain dropped,
                            the suffix recomputed (``serving_disagg_
                            rejects`` and the importer's
                            ``kv_transfer_rejects``)
stalled transfer            the ``transfer_deadline_ms`` wait expires ->
                            colocated path (``serving_disagg_deadline_
                            degrades``)
decode replica dies         the router's failover replays the request;
mid-handoff                 the stranded entry goes at its next failed
                            export
==========================  =========================================

Staging is asynchronous: ``submit`` returns at once, a ``disagg-xfer``
worker stages the blocks onto the replica ``FleetRouter.peek_placement``
names, then chains the fleet's submit to the caller's future; any
exception on the way is a counter, never a client's error.  The host half
of an export (the copies to the host and the CRC) runs on a separate
``kv-staging`` executor: the source's scheduler thread only gathers the
rows at a tick boundary.

``serving.disagg`` is read with JAX's keys (``:196-206``): ``enabled``,
``prefill_replicas``, ``transfer_deadline_ms``, ``directory_capacity``,
``transfer_workers``, ``staging_workers``, ``staging_chunk_rows``.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..engine import fault
from ..telemetry.registry import get_registry
from . import kv_transfer
from .fleet import ServingFleet

__all__ = ["DisaggFleet", "FleetCacheDirectory"]


class FleetCacheDirectory:
    """Fleet-shared prefix-cache directory: content key -> holder replica.

    Keys are the router's affinity-key construction — the prompt's first
    full KV block, seeded with the tenant namespace exactly like
    kv_pool's chain keys, so cross-tenant (LoRA-namespaced) prompts can
    never alias an entry and therefore never transfer across
    namespaces.  Values are decode-replica router indices (the only
    exportable long-lived holders).  Bounded LRU; thread-safe (router
    worker threads, drain handlers, and the autoscaler all consult it).
    Counters mirror into the process registry as
    ``serving_fleet_cache_*`` so every reader of the registry reads
    one ledger.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"directory capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, int]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._rejects = 0
        self._evictions = 0

    @staticmethod
    def key_of(prompt, block_size: int, namespace=-1) -> Optional[tuple]:
        """The prompt's directory identity: ``(namespace, first block)``.

        ``None`` when the prompt cannot contribute a cached block at all
        (kv_pool caches ``(len - 1) // block_size`` full blocks — same
        cutoff as the router's affinity key).
        """
        prompt = np.asarray(prompt)
        if block_size < 1 or (int(prompt.size) - 1) // block_size < 1:
            return None
        return (namespace, tuple(int(t) for t in prompt[:block_size]))

    def _bump(self, name: str, n: int = 1) -> None:
        get_registry().counter(f"serving_fleet_cache_{name}").inc(n)

    def publish(self, key: tuple, holder: int) -> None:
        """Record ``holder`` as the replica owning ``key``'s prefix
        blocks (last writer wins — the freshest holder is the least
        likely to have LRU-evicted the blocks locally)."""
        with self._lock:
            self._entries[key] = int(holder)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evictions += 1

    def lookup(self, key: tuple) -> Optional[int]:
        """The holding replica, or ``None`` (counts the hit/miss)."""
        with self._lock:
            holder = self._entries.get(key)
            if holder is None:
                self._misses += 1
            else:
                self._entries.move_to_end(key)
                self._hits += 1
        self._bump("hits" if holder is not None else "misses")
        return holder

    def count_reject(self, n: int = 1) -> None:
        """A transferred payload failed its checksum at import."""
        with self._lock:
            self._rejects += n
        self._bump("rejects", n)

    def evict_replica(self, holder: int) -> int:
        """Drop every entry held by ``holder`` (retire/death coherence);
        returns how many were evicted."""
        with self._lock:
            doomed = [k for k, v in self._entries.items() if v == holder]
            for k in doomed:
                del self._entries[k]
            self._evictions += len(doomed)
        return len(doomed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self._hits,
                "misses": self._misses,
                "rejects": self._rejects,
                "evictions": self._evictions,
            }


class DisaggFleet:
    """Disaggregated serving: decode :class:`ServingFleet` + prefill
    replicas + the transfer coordinator.  Mirrors the fleet's client
    verbs, so a driver takes either."""

    def __init__(
        self,
        fleet: ServingFleet,
        disagg: Optional[Dict[str, Any]] = None,
        prefill_replicas: Optional[List[Any]] = None,
        logger: Optional[logging.Logger] = None,
    ):
        """``disagg`` is the raw ``serving.disagg`` config section;
        ``prefill_replicas`` overrides its ``prefill_replicas`` count
        with ready-built engines (tests inject hand-ticked ones)."""
        dcfg = dict(disagg or {})
        if not bool(dcfg.pop("enabled", True)):
            raise ValueError(
                "serving.disagg.enabled is false — build a ServingFleet "
                "instead of a DisaggFleet"
            )
        n_prefill = int(dcfg.pop("prefill_replicas", 1))
        deadline_ms = float(dcfg.pop("transfer_deadline_ms", 2000.0))
        capacity = int(dcfg.pop("directory_capacity", 4096))
        workers = int(dcfg.pop("transfer_workers", 2))
        staging_workers = int(dcfg.pop("staging_workers", 1))
        staging_chunk = dcfg.pop("staging_chunk_rows", None)
        if dcfg:
            raise ValueError(f"unknown serving.disagg keys: {sorted(dcfg)}")
        if deadline_ms <= 0:
            raise ValueError(
                f"transfer_deadline_ms must be > 0, got {deadline_ms}"
            )
        if workers < 1:
            raise ValueError(f"transfer_workers must be >= 1, got {workers}")
        if staging_workers < 1:
            raise ValueError(
                f"staging_workers must be >= 1, got {staging_workers}"
            )
        if staging_chunk is not None and int(staging_chunk) < 1:
            raise ValueError(
                f"staging_chunk_rows must be >= 1, got {staging_chunk}"
            )
        if n_prefill < 1:
            raise ValueError(
                f"serving.disagg.prefill_replicas must be >= 1, got {n_prefill}"
            )
        self.fleet = fleet
        self.router = fleet.router
        if prefill_replicas is None:
            # prefill identities start at 100: their serving_r<id>_*
            # telemetry namespace can never collide with decode replicas
            # the autoscaler adds later
            prefill_replicas = [
                fleet.replica_factory(100 + i) for i in range(n_prefill)
            ]
        self.prefill_replicas = list(prefill_replicas)
        self.directory = FleetCacheDirectory(capacity)
        # membership coherence: remove_replica evicts through this hook
        fleet.cache_directory = self.directory
        self.transfer_deadline_s = deadline_ms / 1000.0
        self.logger = logger or logging.getLogger("pdt.serving.disagg")
        self._exec = ThreadPoolExecutor(
            max_workers=workers,
            thread_name_prefix="disagg-xfer",
        )
        # host-staging executor: the device→host block copies + CRC seal
        # of an export run HERE, not on the source scheduler's loop
        # thread — the scheduler only dispatches lazy device slices
        # (kv_transfer.extract_block_refs) at a tick boundary, so a
        # transfer no longer steals decode-dispatch time from the
        # prefill replica it exports from.  Bounded separately from the
        # transfer coordinators so a burst of staging work queues rather
        # than fanning out across every core.
        self._staging_chunk = (
            int(staging_chunk) if staging_chunk is not None else None
        )
        self._stage_exec = ThreadPoolExecutor(
            max_workers=staging_workers,
            thread_name_prefix="kv-staging",
        )
        self._lock = threading.Lock()
        self._xfer_no = 0  # transfer ordinal (1-based) — the fault clock
        self._staging: set = set()  # keys with a transfer in flight
        self._dead_prefill: set = set()
        self._rr = 0  # prefill round-robin cursor
        self._closed = False

    # ------------------------------------------------------------------ #

    @classmethod
    def from_config(cls, cfg: Dict[str, Any], device=None, logger=None,
                    state_dict=None) -> "DisaggFleet":
        """The decode fleet from ``serving.fleet`` and the prefill side from
        ``serving.disagg``, over one resolution (the prefill replicas come
        from the fleet's stored factory)."""
        logger = logger or logging.getLogger(__name__)
        fleet = ServingFleet.from_config(cfg, device=device, logger=logger,
                                         state_dict=state_dict)
        try:
            out = cls(fleet, disagg=cfg["serving"].get("disagg"),
                      logger=logger)
        except BaseException:
            fleet.close()
            raise
        logger.info(
            "disaggregated fleet up: %d decode replica(s), %d prefill "
            "replica(s), transfer deadline %.0f ms",
            len(fleet.replicas), len(out.prefill_replicas),
            out.transfer_deadline_s * 1000.0,
        )
        return out

    # ------------------------------------------------------------------ #
    # client verbs

    def submit(
        self,
        prompt,
        deadline_ms: Optional[float] = None,
        max_new_tokens: Optional[int] = None,
        on_token: Optional[Callable[[int], None]] = None,
        key=None,
    ) -> Future:
        """Route one prompt; KV staging happens off-thread first.  ``key``
        is the request's sampling key (default: the router's).

        Prompts too short to own a cached block (or submitted after
        close began) skip staging entirely — the plain colocated path.
        The returned future resolves with the fleet result; staging
        failures are counters, never client errors.
        """
        prompt = np.asarray(prompt, np.int32)
        bs = self._block_size()
        dir_key = FleetCacheDirectory.key_of(prompt, bs) if bs is not None else None
        if dir_key is None:
            return self.fleet.submit(
                prompt, deadline_ms=deadline_ms,
                max_new_tokens=max_new_tokens, on_token=on_token, key=key,
            )
        outer: Future = Future()
        try:
            self._exec.submit(
                self._serve, prompt, dir_key, deadline_ms, max_new_tokens,
                on_token, key, outer,
            )
        except RuntimeError:  # executor shut down mid-close
            return self.fleet.submit(
                prompt, deadline_ms=deadline_ms,
                max_new_tokens=max_new_tokens, on_token=on_token, key=key,
            )
        return outer

    def depth(self) -> int:
        return self.fleet.depth()

    def health(self) -> Dict[str, Any]:
        return self.fleet.health()

    def live_replicas(self) -> int:
        return self.fleet.live_replicas()

    def snapshot(self) -> Dict[str, Any]:
        """Fleet snapshot + the disagg tier: directory state, transfer
        ordinal, and per-prefill-replica sub-snapshots."""
        snap = self.fleet.snapshot()
        with self._lock:
            transfers = self._xfer_no
        snap["disagg"] = {
            "directory": self.directory.snapshot(),
            "transfers": transfers,
            "prefill_replicas": len(self.prefill_replicas),
            "prefill": {
                f"p{i}": rep.metrics.snapshot()
                for i, rep in enumerate(self.prefill_replicas)
                if hasattr(rep, "metrics")
            },
        }
        return snap

    def drain(self, deadline_ms: Optional[float] = None) -> float:
        return self.fleet.drain(deadline_ms)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._exec.shutdown(wait=True)
        self._stage_exec.shutdown(wait=True)
        for i, rep in enumerate(self.prefill_replicas):
            try:
                rep.close()
            except Exception:
                self.logger.exception("prefill replica %d close failed", i)
        self.fleet.close()
        self._report_unfired_faults()

    def _report_unfired_faults(self) -> None:
        """Same contract as the scheduler's: an armed transfer fault the
        coordinator never reached must end the run accounted, not lost."""
        pending = fault.get_injector().pending()
        for kind, steps in pending.items():
            if not (
                kind.startswith("kv_transfer_") or kind == "prefill_replica_down"
            ):
                continue
            fault.bump(f"fault_unfired_{kind}", len(steps))
            self.logger.warning(
                "disagg coordinator closed with injected %s fault(s) still "
                "armed for transfer(s) %s — no transfer reached them",
                kind, steps,
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ #
    # staging pipeline (disagg-xfer worker threads)

    def _serve(self, prompt, dir_key, deadline_ms, max_new_tokens, on_token,
               key, outer: Future) -> None:
        try:
            self._stage(prompt, dir_key)
        except Exception:
            # the catch-all rung of the ladder: staging NEVER fails a
            # request — whatever happened, decode recomputes locally
            self._bump("transfer_recomputes")
            self.logger.exception(
                "disagg staging failed; degrading to colocated recompute"
            )
        try:
            inner = self.fleet.submit(
                prompt, deadline_ms=deadline_ms,
                max_new_tokens=max_new_tokens, on_token=on_token, key=key,
            )
        except Exception as exc:
            if not outer.done():
                outer.set_exception(exc)
            return

        def _chain(f: Future) -> None:
            if outer.done():
                return
            exc = f.exception()
            if exc is not None:
                outer.set_exception(exc)
            else:
                outer.set_result(f.result())

        inner.add_done_callback(_chain)

    def _stage(self, prompt, key) -> None:
        """Make ``key``'s prefix blocks local to the decode target."""
        with self._lock:
            if self._closed or key in self._staging:
                # single-flight per key: the second waiter follows the
                # sticky placement and hits whatever the first landed
                return
            self._staging.add(key)
        try:
            self._stage_inner(prompt, key)
        finally:
            with self._lock:
                self._staging.discard(key)

    def _stage_inner(self, prompt, key) -> None:
        target = self.router.peek_placement(prompt)
        if target is None:
            return  # nothing healthy: the fleet submit will shed/raise
        holder = self.directory.lookup(key)
        if holder == target:
            return  # fleet-cache hit, already local to the decode target
        source = None
        if holder is not None:
            source = self._sched_of_decode(holder)
            if source is None:
                # stranded entry (holder died outside the retire path)
                self.directory.evict_replica(holder)
                holder = None
        if holder is None:
            source = self._prefill_source(prompt)
            if source is None:
                return  # no prefill capacity left: plain colocated path
        self._transfer(prompt, key, source, holder, target)

    def _transfer(self, prompt, key, source, holder, target) -> None:
        """One ordinal on the transfer clock: export from ``source``,
        CRC-verify + import at ``target``, publish on success.  The
        injected ``kv_transfer_*``/``prefill_replica_down`` faults key
        on this ordinal."""
        with self._lock:
            self._xfer_no += 1
            ordinal = self._xfer_no
        stall_s = corrupt = None
        inj = fault.get_injector()
        if inj.active:
            down = inj.take("prefill_replica_down", ordinal)
            if down is not None:
                self._kill_prefill(int(down))
            stall_s = inj.take("kv_transfer_stall", ordinal)
            corrupt = inj.take("kv_transfer_corrupt", ordinal)
        tgt_sched = self._sched_of_decode(target)
        if tgt_sched is None:
            return
        self._bump("transfers")
        t0 = time.perf_counter()
        try:
            refs = source.export_kv_refs(
                prompt, namespace=-1, stall_s=stall_s,
            ).result(timeout=self.transfer_deadline_s)
            if not refs:
                # the source LRU-evicted the prefix between directory
                # lookup and export: recompute, and unpublish the holder
                if holder is not None:
                    self.directory.evict_replica(holder)
                self._bump("transfer_recomputes")
                return
            # host staging (device→host copies + CRC) on the bounded
            # kv-staging executor — the scheduler thread only paid the
            # device slice dispatch above
            payloads = self._stage_exec.submit(
                kv_transfer.materialize_payloads, refs, self._staging_chunk,
            ).result(timeout=self.transfer_deadline_s)
            if corrupt is not None:
                kv_transfer.corrupt_payload(payloads[0])
                self.logger.warning(
                    "fault injection: corrupted kv payload on transfer %d",
                    ordinal,
                )
            res = tgt_sched.import_kv_blocks(payloads).result(
                timeout=self.transfer_deadline_s
            )
        except (TimeoutError, FutureTimeoutError):
            self._bump("deadline_degrades")
            self.logger.warning(
                "kv transfer %d exceeded its %.0f ms deadline; degrading "
                "to the colocated path", ordinal,
                self.transfer_deadline_s * 1000.0,
            )
            return
        except Exception as exc:
            # source or target died mid-transfer (the headline fault):
            # the request recomputes/replays wherever it lands
            self._bump("transfer_recomputes")
            if holder is not None:
                self.directory.evict_replica(holder)
            self.logger.warning(
                "kv transfer %d failed (%s: %s); degrading to local "
                "recompute", ordinal, type(exc).__name__, exc,
            )
            return
        if res["rejected"]:
            self.directory.count_reject(res["rejected"])
            self._bump("rejects", res["rejected"])
        if res["accepted"] or not res["rejected"]:
            # the target now holds at least the verified prefix (an
            # all-skipped import means it already held everything)
            self.directory.publish(key, target)
        self.logger.debug(
            "kv transfer %d: %d block(s)/%d bytes to replica %d in %.1f ms",
            ordinal, res["accepted"], res["bytes"], target,
            (time.perf_counter() - t0) * 1000.0,
        )

    # ------------------------------------------------------------------ #
    # helpers

    def _bump(self, name: str, n: int = 1) -> None:
        get_registry().counter(f"serving_disagg_{name}").inc(n)

    @staticmethod
    def _sched_of(rep):
        # engines carry a .scheduler; tests hand in bare schedulers
        return getattr(rep, "scheduler", rep)

    def _block_size(self) -> Optional[int]:
        reps = self.fleet.replicas
        if not reps:
            return None
        return getattr(self._sched_of(reps[0]), "_block_size", None)

    def _sched_of_decode(self, idx: int):
        """The decode replica's scheduler iff it is still usable."""
        reps = self.fleet.replicas
        if not 0 <= idx < len(reps):
            return None
        sched = self._sched_of(reps[idx])
        if sched is None or sched._closed or sched._dead:
            return None
        return sched

    def _prefill_source(self, prompt):
        """Prime a prefill replica's pool with this prompt and return its
        scheduler as the export source (round-robin over survivors)."""
        n = len(self.prefill_replicas)
        for _ in range(n):
            with self._lock:
                idx = self._rr % n
                self._rr += 1
                if idx in self._dead_prefill:
                    continue
            rep = self.prefill_replicas[idx]
            try:
                # exactly one prefill program call: max_new_tokens=1
                # samples its token from the prefill logits and stops —
                # the token is discarded, the registered prefix is the
                # product
                rep.submit(prompt, max_new_tokens=1).result(timeout=600)
                return self._sched_of(rep)
            except Exception as exc:
                with self._lock:
                    self._dead_prefill.add(idx)
                self.logger.warning(
                    "prefill replica %d unusable (%s: %s); trying the next",
                    idx, type(exc).__name__, exc,
                )
        self._bump("prefill_unavailable")
        return None

    def _kill_prefill(self, idx: int) -> None:
        """The ``prefill_replica_down`` fault: hard-kill prefill replica
        ``idx`` so the in-flight export dies mid-transfer."""
        if not 0 <= idx < len(self.prefill_replicas):
            return
        self.logger.warning(
            "fault injection: prefill replica %d down mid-transfer", idx
        )
        self._bump("prefill_replicas_down")
        sched = self._sched_of(self.prefill_replicas[idx])
        if sched is not None:
            sched.hard_kill(
                fault.DeviceLostError(
                    f"injected prefill replica {idx} loss mid-transfer"
                )
            )
        with self._lock:
            self._dead_prefill.add(idx)
