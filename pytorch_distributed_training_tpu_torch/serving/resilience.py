"""Serving-side fault tolerance: classify, isolate, restart, never hang.

Port of the JAX package's ``serving/resilience.py``.  The supervisor sits
between a failed scheduler tick and failing every request, and walks a
ladder:

1. **Attributable errors: poison bisect.**  An exception raised from the
   decode dispatch while requests are active is re-driven against halves
   of the active set (``_decode_probe`` repeats the exact dispatch: the
   pool scatter is idempotent for identical inputs, and the per-request,
   per-token-index sampling seeds make the probe repeat).  The culprit is
   evicted with a diagnosed :class:`PoisonedRequestError`, its blocks
   free, every other slot resumes untouched.  A NaN-emitting request never
   raises: the paged calls return per-row finite flags and the scheduler
   evicts on them.
2. **Unattributable errors: hot restart with replay.**  A lost card
   (:class:`..engine.fault.DeviceLostError`, or a CUDA runtime error), a
   hung tick (:class:`HungTickError` from the tick watchdog), or a probe
   that does not reproduce, escalate to ``_rebuild_and_requeue``: a fresh
   zeroed pool and host pool, every in-flight request re-admitted, its
   prompt re-prefilled and its generated tokens fed again through the same
   decode call, so the continuation is token-identical.
3. **A bounded budget.**  Restarts draw from ``max_restarts``; past it the
   remaining futures fail with :class:`EngineRestartError` chaining the
   last cause.

A sticky CUDA error (an illegal address, say) poisons the process's CUDA
context: a restart in the same process cannot clear it, so each restart
fails again until the budget is spent and the futures fail with
:class:`EngineRestartError`.  That is the end this ladder reaches, and it
does not hang.

The supervisor holds policy and budget only; slot and pool mutation stays
on the scheduler thread (``handle_tick_failure`` runs inside ``tick``'s
except clause).  Only the counters that health probes read sit under its
lock.
"""
from __future__ import annotations

import logging
import threading
from typing import Optional

import torch

from ..engine import fault
from ..telemetry.spans import span

__all__ = [
    "EngineRestartError",
    "HungTickError",
    "PoisonedRequestError",
    "ServingSupervisor",
]


class PoisonedRequestError(RuntimeError):
    """One request poisoned the decode step; only ITS future gets this.

    Raised with a diagnosis (slot, tick, trigger) and chained to the
    underlying cause when there was a Python exception (``__cause__`` is
    None for the isfinite output-guard path — NaNs never raise).
    """


class HungTickError(RuntimeError):
    """The tick watchdog flagged a scheduler iteration as hung.

    Converted into a diagnosed hot-restart by the supervisor: a wedged
    decode dispatch cannot be attributed to one request, and the pool's
    state is suspect.
    """


class EngineRestartError(RuntimeError):
    """The restart budget is exhausted; remaining futures fail with this,
    ``__cause__`` chaining the error that burned the last restart."""


def _is_device_loss(exc: BaseException) -> bool:
    """Device-level failure: the error names the runtime, not a request
    (JAX ``:84-91`` names XLA's runtime errors; here CUDA's)."""
    if isinstance(exc, (fault.DeviceLostError, HungTickError)):
        return True
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(exc, accelerator_error):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith("CUDA error")


class ServingSupervisor:
    """Recovery policy + restart budget for one :class:`ContinuousScheduler`.

    ``handle_tick_failure`` MUST be called on the scheduler thread (it
    drives slot eviction and pool rebuild); ``restarts()`` / ``exhausted()``
    are safe from any thread and feed the health snapshot.
    """

    def __init__(
        self,
        scheduler,
        *,
        max_restarts: int = 2,
        poison_bisect: bool = True,
        logger: Optional[logging.Logger] = None,
    ):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self._sched = scheduler
        self.max_restarts = int(max_restarts)
        self.poison_bisect = bool(poison_bisect)
        self._logger = logger or logging.getLogger(__name__)
        self._lock = threading.Lock()
        self._restarts = 0  # guarded by: self._lock
        self._exhausted = False  # guarded by: self._lock

    def restarts(self) -> int:
        with self._lock:
            return self._restarts

    def exhausted(self) -> bool:
        with self._lock:
            return self._exhausted

    # ------------------------------------------------------------------ #

    def handle_tick_failure(self, exc: BaseException) -> bool:
        """Recover from a failed tick; returns True (work happened).

        Ladder: device-class errors restart; decode-phase errors bisect
        down to one request and evict it; anything unattributable (prefill
        phase, non-reproducible, bisect disabled with several suspects)
        escalates to restart.  Restart past the budget fails the world
        with the chained cause.
        """
        sched = self._sched
        # the scheduler flushed its async dispatch ring before handing
        # us the failure (scheduler.tick), so probe/replay state below
        # is sync-equivalent: host-known streams match the device, and
        # dispatch counters are rolled back to gen_idx.
        if not _is_device_loss(exc) and sched._tick_phase == "decode":
            # the span times the recovery: from its start to the first decode
            # tick after it
            with span("poison_bisect", step=sched._tick_no,
                      cause=type(exc).__name__):
                isolated = self._isolate(exc)
            if isolated:
                return True
            self._logger.warning(
                "decode failure not attributable to one request "
                "(%s: %s) — escalating to hot-restart",
                type(exc).__name__, exc,
            )
        return self._restart(exc)

    # ------------------------------------------------------------------ #

    def _probe_raises(self, reqs) -> bool:
        self._sched._bump("poison_probes")
        try:
            self._sched._decode_probe(reqs)
        except Exception:
            return True
        return False

    def _isolate(self, exc: BaseException) -> bool:
        """Bisect the active set down to the request that reproduces
        ``exc``'s dispatch failure and evict it; False = cannot attribute."""
        sched = self._sched
        active = [r for r in sched._slots if r is not None]
        if not active:
            return False
        if len(active) == 1:
            # nothing to bisect: the only active request owns the failure
            sched._evict_poisoned(active[0], cause=exc, trigger="decode raise")
            return True
        if not self.poison_bisect:
            return False
        if not self._probe_raises(active):
            return False  # not reproducible — transient, restart instead
        cands = active
        while len(cands) > 1:
            half = cands[: len(cands) // 2]
            cands = half if self._probe_raises(half) else cands[len(cands) // 2 :]
        if not self._probe_raises(cands):
            return False  # the fault needed company — not one request's
        sched._evict_poisoned(cands[0], cause=exc, trigger="decode raise")
        return True

    def _restart(self, cause: BaseException) -> bool:
        sched = self._sched
        with self._lock:
            if self._restarts >= self.max_restarts:
                self._exhausted = True
                n = self._restarts
            else:
                self._restarts += 1
                n = -1
        if n >= 0:
            sched._bump("restart_budget_exhausted")
            err = EngineRestartError(
                f"serving engine restart budget exhausted ({n}/"
                f"{self.max_restarts} restarts used); failing in-flight "
                "requests"
            )
            err.__cause__ = cause
            self._logger.error("%s", err)
            sched._fail_inflight(err)
            return True
        sched._bump("engine_restarts")
        self._logger.error(
            "hot-restarting serving engine after %s: %s (restart %d/%d)",
            type(cause).__name__, cause, self.restarts(), self.max_restarts,
        )
        with span("serving_restart", step=sched._tick_no,
                  cause=type(cause).__name__):
            sched._rebuild_and_requeue()
        return True
