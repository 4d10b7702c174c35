"""Trace-driven workload generator: seeded diurnal and flash-crowd traffic.

The port's own copy of the JAX package's ``serving/workload.py`` (standard
library only; the port imports nothing of the JAX package).
:class:`TraceGenerator` compresses bursty, diurnal traffic into a request
trace that an autoscaler driver replays against a
:class:`.fleet.ServingFleet`:

**Diurnal cycle.**  The arrival rate follows one sinusoidal "day"
(``diurnal_period_s`` of trace time per cycle, amplitude as a fraction of
``base_rps``), with its trough at t = 0.

**Flash crowds.**  Seeded burst windows multiply the rate by
``flash_multiplier`` for ``flash_duration_s``; their starts are drawn
first, a fixed number of draws, so the trace is prefix-stable.

**Heavy-tailed mixes.**  Prompt and generation lengths are Pareto-tailed
and clamped to their bounds, and a seeded share of requests falls into
prefix groups (one prompt seed a group), so affinity placement matters.

The whole trace is a pure function of its seed: every draw comes from one
``random.Random(seed)``, no wall clock, no module state.
:meth:`TraceGenerator.trace_json` is byte-identical to the JAX package's
for the same seed and keys, and ``generate(k) == generate()[:k]``.  The
driver makes each prompt's token ids itself from ``prompt_seed``.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass
from random import Random
from typing import Any, Dict, List, Optional

__all__ = ["TraceGenerator", "TraceRequest"]


@dataclass(frozen=True)
class TraceRequest:
    """One arrival in the trace (times are trace seconds, not wall)."""

    index: int
    t: float            # arrival offset from trace start
    prompt_len: int     # heavy-tailed, clamped to [prompt_min, prompt_max]
    gen_len: int        # heavy-tailed, clamped to [gen_min, gen_max]
    group: Optional[int]  # shared-prefix group (None = i.i.d. prompt)
    prompt_seed: int    # seeds the prompt's token ids deterministically

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


class TraceGenerator:
    """Deterministic request traces from one explicit seed.

    ``workload`` carries the ``serving.autoscale.workload`` config keys
    (copy-pop-raise idiom so a typo'd key fails at build time, and the
    config-schema pass extracts the accepted surface from this body).
    """

    def __init__(self, seed: int = 0, workload: Optional[Dict] = None):
        wl = dict(workload or {})
        self.seed = int(seed)
        self.duration_s = float(wl.pop("duration_s", 60.0))
        self.base_rps = float(wl.pop("base_rps", 6.0))
        self.diurnal_period_s = float(wl.pop("diurnal_period_s", 40.0))
        self.diurnal_amplitude = float(wl.pop("diurnal_amplitude", 0.6))
        self.flash_crowds = int(wl.pop("flash_crowds", 2))
        self.flash_duration_s = float(wl.pop("flash_duration_s", 4.0))
        self.flash_multiplier = float(wl.pop("flash_multiplier", 4.0))
        self.prompt_min = int(wl.pop("prompt_min", 4))
        self.prompt_max = int(wl.pop("prompt_max", 16))
        self.gen_min = int(wl.pop("gen_min", 2))
        self.gen_max = int(wl.pop("gen_max", 8))
        self.tail_alpha = float(wl.pop("tail_alpha", 1.8))
        self.prefix_groups = int(wl.pop("prefix_groups", 4))
        self.prefix_fraction = float(wl.pop("prefix_fraction", 0.5))
        if wl:
            raise ValueError(
                f"unknown serving.autoscale.workload keys: {sorted(wl)}"
            )
        if self.duration_s <= 0:
            raise ValueError(
                f"workload.duration_s must be > 0, got {self.duration_s}"
            )
        if self.base_rps <= 0:
            raise ValueError(
                f"workload.base_rps must be > 0, got {self.base_rps}"
            )
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError(
                "workload.diurnal_amplitude must be in [0, 1), got "
                f"{self.diurnal_amplitude}"
            )
        if self.prompt_min < 1 or self.prompt_max < self.prompt_min:
            raise ValueError(
                f"bad prompt length bounds [{self.prompt_min}, "
                f"{self.prompt_max}]"
            )
        if self.gen_min < 1 or self.gen_max < self.gen_min:
            raise ValueError(
                f"bad gen length bounds [{self.gen_min}, {self.gen_max}]"
            )
        if self.tail_alpha <= 1.0:
            # alpha <= 1 has infinite mean: a single request could eat the
            # whole trace budget, which is noise, not a heavy tail
            raise ValueError(
                f"workload.tail_alpha must be > 1.0, got {self.tail_alpha}"
            )

    # ------------------------------------------------------------- rate model

    def _flash_windows(self, rng: Random) -> List[float]:
        """Burst-start offsets — a FIXED number of draws per trace so the
        arrival stream after them is prefix-stable under truncation."""
        if self.flash_crowds < 1:
            return []
        # one burst per equal slice of the trace, jittered inside it and
        # kept clear of the very end (a burst the trace cannot finish
        # proves nothing about scale-up)
        span = self.duration_s / self.flash_crowds
        usable = max(0.0, span - self.flash_duration_s)
        return [
            i * span + rng.uniform(0.1 * span, max(0.1 * span, usable))
            for i in range(self.flash_crowds)
        ]

    def rate_at(self, t: float, flash_starts: Optional[List[float]] = None
                ) -> float:
        """Instantaneous arrival rate (req/s) at trace offset ``t``.

        Deterministic given the flash windows; the trough of the diurnal
        sine is placed at t=0 so every trace opens in scale-down
        territory and earns its way up.
        """
        if flash_starts is None:
            flash_starts = self._flash_windows(Random(self.seed))
        phase = 2.0 * math.pi * t / self.diurnal_period_s
        rate = self.base_rps * (
            1.0 - self.diurnal_amplitude * math.cos(phase)
        )
        for start in flash_starts:
            if start <= t < start + self.flash_duration_s:
                rate *= self.flash_multiplier
                break
        return rate

    # ------------------------------------------------------------ generation

    def _tail_len(self, rng: Random, lo: int, hi: int) -> int:
        """Pareto-tailed integer length in [lo, hi]."""
        return min(hi, max(lo, int(lo * rng.paretovariate(self.tail_alpha))))

    def generate(self, limit: Optional[int] = None) -> List[TraceRequest]:
        """Materialize the trace (all arrivals inside ``duration_s``, or
        the first ``limit`` of them).

        A fresh ``Random(seed)`` per call, flash windows drawn first with
        a trace-length-independent number of draws, then one request at a
        time — so ``generate(k) == generate()[:k]``: growing a trace
        never reshuffles the prefix already replayed.
        """
        rng = Random(self.seed)
        flash_starts = self._flash_windows(rng)
        out: List[TraceRequest] = []
        t = 0.0
        while limit is None or len(out) < limit:
            # non-homogeneous Poisson via the instantaneous-rate
            # exponential: deterministic, sequential, prefix-stable
            t += rng.expovariate(self.rate_at(t, flash_starts))
            if t >= self.duration_s:
                break
            grouped = (
                self.prefix_groups > 0
                and rng.random() < self.prefix_fraction
            )
            group = rng.randrange(self.prefix_groups) if grouped else None
            prompt_len = self._tail_len(rng, self.prompt_min, self.prompt_max)
            gen_len = self._tail_len(rng, self.gen_min, self.gen_max)
            # grouped requests share their group's prompt seed so they
            # actually share a prefix; i.i.d. requests get a per-index
            # stream.  Both are pure functions of (seed, index/group).
            prompt_seed = (
                self.seed * 1_000_003 + (
                    group if group is not None else 7919 + len(out)
                )
            )
            out.append(TraceRequest(
                index=len(out),
                t=round(t, 6),
                prompt_len=prompt_len,
                gen_len=gen_len,
                group=group,
                prompt_seed=prompt_seed,
            ))
        return out

    def trace_json(self, limit: Optional[int] = None) -> str:
        """Byte-stable trace dump: same seed ⇒ identical string."""
        return json.dumps(
            [r.to_dict() for r in self.generate(limit)],
            sort_keys=True, separators=(",", ":"),
        )

    def peak_rate(self) -> float:
        """Max of the rate model over the trace (flash peaks included) —
        what static peak provisioning sizes for."""
        flash_starts = self._flash_windows(Random(self.seed))
        step = self.diurnal_period_s / 64.0
        peak, t = 0.0, 0.0
        while t < self.duration_s:
            peak = max(peak, self.rate_at(t, flash_starts))
            t += step
        for start in flash_starts:
            mid = min(start + self.flash_duration_s / 2.0, self.duration_s)
            peak = max(peak, self.rate_at(mid, flash_starts))
        return peak
