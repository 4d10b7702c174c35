"""Deterministic fault injection and the recovery counters (port of ``engine/fault.py``).

Every recovery path of the fault-tolerance layer (the anomaly guard and
its rollback, retried checkpoint I/O, the loader pool's respawn, the
hung-step watchdog) is proved by injecting its failure deterministically.
The injector is process-global, parsed from the ``PDT_FAULT_SPEC``
environment variable or from ``training.fault_tolerance.fault_spec`` (the
variable wins, so a chaos wrapper overrides any config).

The grammar is the JAX package's (``:11-131``): entries ``kind@step[:arg]``
separated by ``;`` or ``,``, the whole list validated at parse time (a
malformed entry, an unknown kind or a duplicate ``kind@step`` rejects the
spec).  Every kind parses; the runner refuses at install, with
:func:`check_ported`, each kind whose recovery path the port does not
have yet, so no fault is accepted and then never fired.  Ported:

    nan_batch@K        the float batch of step K becomes NaN (the anomaly
                       guard must skip the step)
    kill_worker@K[:W]  SIGKILL loader pool worker W (default 0) at step K
                       (the pool must respawn it, no batch lost)
    stall_step@K[:SEC] sleep SEC (default 1.0) in step K's host window
                       (the watchdog must fire)
    ckpt_fail@A[:N]    fail checkpoint-save attempts A..A+N-1 (0-based
                       ordinal across the process; the retry policy must
                       absorb them)
    restore_fail@A[:N] the same for checkpoint-restore attempts

Serving kinds (the step is the continuous scheduler's tick, 1-based;
:mod:`..serving.scheduler` consults the injector once a tick, JAX
``:59-80``):

    serve_nan@T[:S]    NaN the key-pool row of the request in slot S
                       (default 0) at tick T: the finite guard must evict
                       exactly that request
    serve_raise@T[:S]  the request in slot S raises from the decode
                       dispatch at tick T: the poison bisect must isolate it
    serve_device_lost@T
                       raise :class:`DeviceLostError` at tick T: the
                       supervisor must restart and replay every request
    serve_hang@T[:SEC] sleep SEC (default 1.0) inside tick T: the tick
                       watchdog must fire and turn it into a restart

Fleet kinds (JAX ``:89-130``): the step is the fleet router's monitor poll
(:mod:`..serving.router`), the autoscaler's poll
(:mod:`..serving.autoscaler`) or the disaggregation coordinator's transfer
ordinal (:mod:`..serving.disagg`), each 1-based:

    replica_down@P[:R] hard-kill replica R (default 0) at router poll P:
                       the router must fail its requests over to a
                       survivor, token for token
    replica_hang@P[:SEC]
                       wedge replica 0's scheduler thread for SEC (default
                       1.0) at poll P: only its heartbeat's age shows it
    autoscale_hang@P[:SEC]
                       sleep SEC (default 1.0) in the autoscaler's poll P,
                       before it reads its signals
    kv_transfer_stall@N[:SEC]
                       sleep SEC (default 1.0) in transfer N's export: the
                       coordinator's deadline must degrade it to a recompute
    kv_transfer_corrupt@N
                       flip a byte of transfer N's first payload after its
                       CRC: the importer must reject it
    prefill_replica_down@N[:R]
                       hard-kill prefill replica R (default 0) as transfer
                       N begins: the decode side recomputes

The step-keyed kinds are one-shot: consumed when they fire, so a rollback
that replays step K does not trip them again.  The recovery counters
(``skipped_steps``, ``rollbacks``, ``ckpt_retries``, ``worker_respawns``,
``watchdog_fires``, ...) live in the process registry of
:mod:`..telemetry.registry`; :func:`bump`, :func:`counters` and
:func:`reset_counters` are views of it.  Standard library only (numpy in
:func:`poison_batches`).
"""
from __future__ import annotations

import os
import re
import threading
from collections import Counter
from typing import Dict, List, Optional, Tuple

from ..telemetry.registry import get_registry, reset_registry

__all__ = [
    "ENV_VAR",
    "DeviceLostError",
    "FaultInjectionError",
    "FaultInjector",
    "UNPORTED_FAULT_KINDS",
    "bump",
    "check_ported",
    "counters",
    "get_injector",
    "install",
    "poison_batches",
    "reset_counters",
]

ENV_VAR = "PDT_FAULT_SPEC"

_STEP_KINDS = (
    "nan_batch", "kill_worker", "stall_step", "kill_peer",
    "sdc_flip", "ckpt_corrupt",
    "serve_nan", "serve_raise", "serve_device_lost", "serve_hang",
    "replica_down", "replica_hang", "autoscale_hang",
    "kv_transfer_stall", "kv_transfer_corrupt", "prefill_replica_down",
)
_POINT_KINDS = {
    "ckpt_fail": "ckpt_save",
    "restore_fail": "ckpt_restore",
    "ckpt_async_fail": "ckpt_async_write",
}
_P10 = "ROADMAP port item P10 (reliability)"
# kind -> why its recovery path is not in the port yet
UNPORTED_FAULT_KINDS = {
    "kill_peer": f"peer-death detection (engine/elastic.py) is {_P10}",
    "sdc_flip": f"the integrity sentinel (engine/integrity.py) is {_P10}",
    "ckpt_corrupt": f"the checkpoint integrity manifest is {_P10}",
    "ckpt_async_fail": f"asynchronous checkpoint writes are {_P10}",
}


class FaultInjectionError(OSError):
    """An injected I/O failure: an ``OSError``, so it lands in the default
    retry allowlist (:class:`..utils.retry.Retry`) as the transient
    filesystem errors it stands for do."""


class DeviceLostError(FaultInjectionError):
    """Injected stand-in for losing the card mid-dispatch: the serving
    supervisor takes it (and CUDA's runtime errors) as no one request's
    fault, so it restarts and replays instead of bisecting."""


class FaultInjector:
    """A parsed fault spec, queried by the instrumented call sites."""

    def __init__(self, spec: str = ""):
        self.spec = (spec or "").strip()
        # kind -> {step: arg}; one-shot entries popped when taken
        self._step_faults: Dict[str, Dict[int, float]] = {k: {} for k in _STEP_KINDS}
        # fail point -> [(first_attempt, n_failures)]
        self._fail_windows: Dict[str, List[Tuple[int, int]]] = {}
        self._attempts: Counter = Counter()
        # kind or fail point -> faults that fired
        self._fired: Counter = Counter()
        self._lock = threading.Lock()
        for raw in re.split(r"[;,]", self.spec):
            entry = raw.strip()
            if entry:
                self._parse_entry(entry)

    def _parse_entry(self, entry: str) -> None:
        try:
            kind, rest = entry.split("@", 1)
            parts = rest.split(":", 1)
            step = int(parts[0])
            arg = parts[1] if len(parts) > 1 else None
        except ValueError:
            raise ValueError(f"bad {ENV_VAR} entry {entry!r}: want kind@step[:arg]") from None
        kind = kind.strip()
        if step < 0:
            raise ValueError(f"bad {ENV_VAR} entry {entry!r}: step must be >= 0")
        if kind in _POINT_KINDS:
            n = int(arg) if arg is not None else 1
            if n < 1:
                raise ValueError(f"bad {ENV_VAR} entry {entry!r}: failure count must be >= 1")
            self._fail_windows.setdefault(_POINT_KINDS[kind], []).append((step, n))
        elif kind in _STEP_KINDS:
            if kind in ("kill_worker", "serve_nan", "serve_raise", "sdc_flip",
                        "replica_down", "prefill_replica_down"):
                # a worker, slot or replica index (default 0)
                val = float(int(arg)) if arg is not None else 0.0
            elif kind == "kill_peer":
                # a process index; -1 = whichever rank parses it
                val = float(int(arg)) if arg is not None else -1.0
            elif kind in ("stall_step", "serve_hang", "replica_hang", "autoscale_hang",
                          "kv_transfer_stall"):
                val = float(arg) if arg is not None else 1.0
            else:
                if arg is not None:
                    raise ValueError(f"bad {ENV_VAR} entry {entry!r}: {kind} takes no arg")
                val = 1.0
            if step in self._step_faults[kind]:
                raise ValueError(
                    f"bad {ENV_VAR} entry {entry!r}: duplicate {kind}@{step} "
                    f"(each kind@step pair may appear once per spec)")
            self._step_faults[kind][step] = val
        else:
            raise ValueError(
                f"bad {ENV_VAR} entry {entry!r}: unknown kind {kind!r} "
                f"(want one of {sorted(_STEP_KINDS) + sorted(_POINT_KINDS)})")

    @property
    def active(self) -> bool:
        return bool(self.spec)

    def kinds(self) -> List[str]:
        """The kinds this spec arms (fail points by their kind's name)."""
        points = {p: k for k, p in _POINT_KINDS.items()}
        return sorted([k for k, steps in self._step_faults.items() if steps]
                      + [points[p] for p in self._fail_windows])

    def take(self, kind: str, step: int) -> Optional[float]:
        """Consume the one-shot fault ``kind@step`` and return its arg (the
        worker index, the stall seconds, 1.0 for the kinds without one);
        ``None`` when there is none."""
        with self._lock:
            val = self._step_faults[kind].pop(int(step), None)
            if val is not None:
                self._fired[kind] += 1
        if val is not None:
            bump(f"fault_fired_{kind}")
        return val

    def check_fail_point(self, point: str) -> None:
        """Raise :class:`FaultInjectionError` when this attempt of ``point``
        (``ckpt_save``, ``ckpt_restore``) falls in an injected window."""
        with self._lock:
            ordinal = self._attempts[point]
            self._attempts[point] += 1
            windows = self._fail_windows.get(point, ())
        for first, n in windows:
            if first <= ordinal < first + n:
                with self._lock:
                    self._fired[point] += 1
                bump(f"injected_{point}_failures")
                raise FaultInjectionError(
                    f"injected {point} failure (attempt ordinal {ordinal}, window {first}+{n})")

    def pending(self) -> Dict[str, List[int]]:
        """Armed faults that have not fired, ``kind -> sorted steps`` (fail
        points: the attempt ordinals not reached yet)."""
        with self._lock:
            out: Dict[str, List[int]] = {kind: sorted(steps)
                                         for kind, steps in self._step_faults.items() if steps}
            for point, windows in self._fail_windows.items():
                seen = self._attempts[point]
                left = sorted(o for first, n in windows for o in range(first, first + n)
                              if o >= seen)
                if left:
                    out[point] = left
        return out

    def fired(self) -> Dict[str, int]:
        """Faults that fired, by kind or fail point."""
        with self._lock:
            return dict(self._fired)


def check_ported(injector: FaultInjector) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for the first
    kind of ``injector``'s spec whose recovery path is not ported."""
    for kind in injector.kinds():
        if kind in UNPORTED_FAULT_KINDS:
            raise NotImplementedError(
                f"fault kind {kind!r} in {injector.spec!r}: {UNPORTED_FAULT_KINDS[kind]}")


_INJECTOR: Optional[FaultInjector] = None


def get_injector() -> FaultInjector:
    """The process injector, parsed from ``PDT_FAULT_SPEC`` at first use
    (inert when the variable is unset)."""
    global _INJECTOR
    if _INJECTOR is None:
        _INJECTOR = FaultInjector(os.environ.get(ENV_VAR, ""))
    return _INJECTOR


def install(spec: Optional[str]) -> FaultInjector:
    """Replace the process injector with one parsed from ``spec``;
    ``install(None)`` makes it inert."""
    global _INJECTOR
    _INJECTOR = FaultInjector(spec or "")
    return _INJECTOR


def bump(name: str, n: int = 1) -> None:
    """Add ``n`` to a process-wide recovery counter."""
    get_registry().counter(name).inc(n)


def counters() -> Dict[str, int]:
    """The non-zero process counters."""
    return {k: v for k, v in get_registry().counters().items() if v}


def reset_counters() -> None:
    reset_registry()


def poison_batches(host_iter, injector: FaultInjector, start_iter: int = 0, logger=None):
    """``host_iter`` with the ``nan_batch`` faults applied: at an injected
    step the input half of a float batch becomes NaN; an integer batch (the
    LM's tokens) cannot carry NaN and is passed on with a warning.  Steps
    count from ``start_iter`` (a rebuilt stream passes its own)."""
    import numpy as np

    step = start_iter
    for img, label in host_iter:
        if injector.take("nan_batch", step) is not None:
            img = np.asarray(img)
            if np.issubdtype(img.dtype, np.floating):
                img = np.full(img.shape, np.nan, dtype=img.dtype)
                bump("injected_nan_batches")
                if logger is not None:
                    logger.warning("fault injection: NaN batch at step %d", step)
            elif logger is not None:
                logger.warning("fault injection: nan_batch@%d skipped — batch dtype %s "
                               "cannot carry NaN (float pipelines only)", step, img.dtype)
        step += 1
        yield img, label
