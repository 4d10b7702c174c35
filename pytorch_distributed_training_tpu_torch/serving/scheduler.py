"""Iteration-level (continuous) batching over the paged KV pool.

Port of the core of the JAX package's ``serving/scheduler.py``
(``ContinuousScheduler``, ``:132``).  The batcher path
(:class:`.batcher.DynamicBatcher`) holds the card for a whole batch until
its longest generation ends.  Here the decode loop is a host-driven step
loop over a fixed-width slot array (Orca, Yu et al. OSDI'22) over a paged
cache (:mod:`.kv_pool`): between single-token steps finished rows retire
and their slots refill from the queue with freshly prefilled requests.

Every device call has a fixed shape: a prefill pads (rows, suffix tokens)
up to the (batch, seq) bucket grid, and the decode step is one ``[slots,
1]`` call, inactive slots riding along at position -1 (their scatter goes
to the pool's sink row and their token is ignored).

Degradation: a request still queued past its ``deadline_ms`` fails with
``TimeoutError`` (admitted requests run to completion), and past
``max_backlog`` a submit is shed with :class:`.batcher.OverloadedError`,
after the expired entries are swept out of the count.  Counters go to
:class:`.metrics.ServingMetrics` and are mirrored into the process
registry as ``serving_*``.

Fault tolerance (:mod:`.resilience`): a failed tick goes to the
:class:`.resilience.ServingSupervisor`, which evicts the one poisoned
request (poison bisect over ``_decode_probe``, or the finite flags for a
NaN emitter) or hot-restarts: a fresh zeroed pool and a fresh
:class:`.kv_pool.PagedKVPool`, every in-flight request replayed
token-identically (``_replay``).  Nothing is compiled, so a restart costs
the pool's allocation and the replay.  ``drain()`` bounds a SIGTERM
shutdown and ``health()`` is the readiness/liveness snapshot; a tick
watchdog (:class:`..engine.watchdog.StepWatchdog`) turns a hung tick into a
diagnosed restart.  The ``serve_*`` kinds of :mod:`..engine.fault` drive
all of it.

The async decode pipeline (``async_depth > 0``): the sync loop reads each
step's tokens back before it dispatches the next, so the card idles
through the host's bookkeeping.  With a depth the sampled-token carry
stays on the card (``decode_step_fed`` feeds its own output back) and up
to ``async_depth`` dispatched steps stay undrained; per-request
``dispatched`` counters keep the host state exact, and the drained stream
is bitwise the sync path's.

Sampling keys: a request's key is ``(seed, seq_no)`` by default, as JAX's
``fold_in(base_rng, seq_no)``; ``submit(key=...)`` takes it explicitly
(the counterpart of JAX's ``rng=``).  Generated token ``i`` is drawn with
``SeedSequence(key + [i])`` (:mod:`.decode`), whatever the batch.

The decode modes (JAX ``:141-330``, ``:1713-1870``), each off by default:

- ``quant``: the decode steps read int8 weights
  (:func:`..ops.quant.quantize_tree`); prefill and verify keep the plain
  ones.  ``True`` quantizes the model's weights as they stand; an engine
  that serves in bf16 passes the mapping it made from the f32 master
  weights before the cast, so ``q`` and ``s`` are the JAX package's.
- ``lora``: a :class:`.lora.LoraRegistry` over a model grafted with its
  factors; ``submit(adapter=name)`` routes a request through that
  adapter, batched with every other tenant's rows.  The adapter id
  (``-1``: the base model) namespaces the prefix cache: the same prompt
  under two adapters has different K/V.
- ``speculative``: a :class:`.speculative.SpeculativeSpec`.  Each tick's
  decode becomes one round: ``k + 1`` greedy single-token steps of the
  draft over its own pool (prefix cache off; the last step writes the
  last proposal's K/V), the boundary block copied into the request's
  private spare block (``extra_blocks``), one ``verify`` of the target
  over the ``k + 1`` columns on the forked table, :func:`.speculative.
  greedy_accept`, and the commit by swapping the spare in.  Greedy only,
  and not with ``async_depth``.  The argmax and the finite check of the
  verify logits run on the card before the one host copy.

The fleet hooks (JAX ``:167-219``, ``:430-493``, ``:592-730``,
``:882-938``), for :mod:`.router`, :mod:`.fleet` and :mod:`.disagg`:

- ``replica_id`` names the replica's process-registry counters
  (``serving_r<id>_*``, :meth:`.metrics.ServingMetrics.global_name`);
- ``heartbeat_path``: the scheduler thread itself rewrites this file at
  most every ``heartbeat_interval_s`` (at each phase of a tick, before
  each block of a forward, after each kv-transfer verb, and while idle),
  never a side thread, so a wedged scheduler goes stale to an outside
  reader while a slow tick that makes progress does not;
- ``liveness_timeout_s``: ``health()`` reports ``stalled`` (and not
  ``live``) when the thread has had work and made no progress that long;
- ``submit(replay_tokens=..., key=...)`` admits a request with its
  stream so far: the hot restart's replay re-derives its K/V through the
  same calls, checks every token (``replay_parity_mismatch``) and never
  fires ``on_token`` for them; it needs the original ``key``;
- ``export_kv_prefix``, ``export_kv_refs`` and ``import_kv_blocks``
  (:mod:`.kv_transfer`) queue work that the scheduler thread runs at its
  next tick boundary (the tick's ``kv_transfer`` phase), resolving a
  future, so pool reads and writes stay on one thread;
- ``hard_kill`` and ``inject_hang`` (the ``replica_down`` and
  ``replica_hang`` faults) take effect at the next tick boundary.

For tests: ``start=False`` and :meth:`tick` by hand (one tick = admit +
prefill + one decode step), so a scripted trace repeats exactly.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..engine import fault
from ..engine.watchdog import StepWatchdog
from ..ops.quant import quantize_tree
from ..telemetry.registry import get_registry
from ..telemetry.spans import span
from . import kv_transfer
from .batcher import OverloadedError
from .decode import build_paged_fns
from .kv_pool import PagedKVPool
from .metrics import ServingMetrics
from .resilience import HungTickError, PoisonedRequestError, ServingSupervisor
from .speculative import greedy_accept

__all__ = ["ContinuousScheduler"]

# the ticking scheduler's beat, for the hook below: one forward of a
# one-process fleet's replica under load can outlast the staleness limit,
# so a healthy replica beats between the model's blocks too
_ticking = threading.local()


def _beat_between_blocks(module, args) -> None:
    beat = getattr(_ticking, "beat", None)
    if beat is not None:
        beat()


def _hook_block_beats(model) -> None:
    """Once a model (replicas share one): every block's forward first
    beats the heartbeat of the scheduler ticking on the calling thread."""
    if getattr(model, "_block_beats_hooked", False):
        return
    for block in getattr(model, "blocks", ()):
        block.register_forward_pre_hook(_beat_between_blocks)
    model._block_beats_hooked = True


class _PagedRequest:
    """One request's slot-side state: prompt, reservation, token stream."""

    __slots__ = (
        "prompt", "max_new", "future", "enqueued_at", "deadline", "on_token", "key",
        "admission", "slot", "tokens", "poison", "dispatched", "adapter", "adapter_name",
        "draft_admission",
    )

    def __init__(self, prompt, max_new, deadline, on_token, key):
        self.prompt = prompt  # 1-D np.int32
        self.max_new = max_new
        self.future: Future = Future()
        self.enqueued_at = time.monotonic()
        self.deadline = deadline  # absolute monotonic, None = forever
        self.on_token = on_token
        self.key = key  # the sampling key, a tuple of ints
        self.admission = None  # set when a slot admits us
        self.slot = -1
        self.tokens: List[int] = []
        self.poison = None  # fault-injection marker ("raise")
        self.adapter = -1  # LoRA adapter id; -1 = the base model
        self.adapter_name: Optional[str] = None
        self.draft_admission = None  # speculative mode: the draft pool's blocks
        # async pipeline: generated tokens determined so far, drained into
        # ``tokens`` or still in flight; the host derives every dispatch
        # input (position, sampling index) from it.  dispatched >=
        # len(tokens), equal in sync mode and whenever nothing of this row
        # is in flight
        self.dispatched = 0

    @property
    def gen_idx(self) -> int:
        """Generated-token count so far == index of the NEXT token."""
        return len(self.tokens)


class ContinuousScheduler:
    """Slot array + block pool + host step loop.

    ``model`` is a :class:`..models.transformer_lm.TransformerLM` already
    on its device (its weights cast, in eval mode); the pool lives beside
    it.  ``submit(prompt)`` returns a future resolved with the batcher's
    result shape ``{"tokens": int32 [gen_len], "gen_len": int}``;
    ``on_token`` streams each token as the host sees it (on the scheduler
    thread: keep it cheap).
    """

    def __init__(
        self,
        model,
        *,
        slots: int = 8,
        block_size: int = 16,
        num_blocks: int = 64,
        prefix_cache: bool = True,
        batch_buckets: Sequence[int],
        seq_buckets: Sequence[int],
        max_new_tokens: int,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        deadline_ms: Optional[float] = None,
        max_backlog: Optional[int] = None,
        metrics: Optional[ServingMetrics] = None,
        seed: int = 0,
        resilience: Optional[Dict[str, Any]] = None,
        async_depth: int = 0,
        logger: Optional[logging.Logger] = None,
        start: bool = True,
        quant: Union[bool, Dict[str, Any]] = False,
        lora=None,
        speculative=None,
        replica_id: Optional[int] = None,
        heartbeat_path: Optional[str] = None,
        heartbeat_interval_s: float = 0.5,
        liveness_timeout_s: Optional[float] = None,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if max_backlog is not None and max_backlog < 1:
            raise ValueError(f"max_backlog must be >= 1, got {max_backlog}")
        self.slots_n = int(slots)
        self.batch_buckets = sorted({int(b) for b in batch_buckets})
        self.seq_buckets = sorted({int(s) for s in seq_buckets})
        if not self.batch_buckets or not self.seq_buckets:
            raise ValueError("scheduler needs batch_buckets and seq_buckets")
        self.max_new_tokens = int(max_new_tokens)
        worst = self.seq_buckets[-1] + self.max_new_tokens
        if worst > model.max_len:
            raise ValueError(
                f"largest seq bucket {self.seq_buckets[-1]} + max_new_tokens "
                f"{self.max_new_tokens} = {worst} exceeds model max_len {model.max_len}"
            )
        self.eos_id = eos_id
        self.deadline_ms = deadline_ms
        self.max_backlog = max_backlog
        self.logger = logger or logging.getLogger(__name__)
        self.metrics = metrics or ServingMetrics(replica_id)
        self.replica_id = replica_id
        self.heartbeat_path = heartbeat_path
        if heartbeat_interval_s <= 0:
            raise ValueError(f"heartbeat_interval_s must be > 0, got {heartbeat_interval_s}")
        self._hb_interval = float(heartbeat_interval_s)
        if liveness_timeout_s is not None and liveness_timeout_s <= 0:
            raise ValueError(f"liveness_timeout_s must be > 0, got {liveness_timeout_s}")
        self._liveness_timeout_s = (float(liveness_timeout_s)
                                    if liveness_timeout_s is not None else None)
        self._last_beat = 0.0  # confined: _loop (and the constructor)
        self.vocab_size = model.vocab_size
        self._async_depth = int(async_depth)
        if self._async_depth < 0:
            raise ValueError(f"async_depth must be >= 0, got {async_depth}")
        self._lora = lora
        self._spec = speculative
        if lora is not None and getattr(model, "lora_adapters", 0) < 1:
            raise ValueError("a LoRA registry was given but the model has no stacked factors: "
                             "pass the registry's grafted model")
        if speculative is not None and float(temperature) != 0.0:
            raise ValueError(
                "speculative decoding requires temperature 0.0: the greedy accept rule is "
                "exact only against the argmax stream (the sampled rule is "
                "serving/speculative.py's sampled_accept, not wired to the scheduler)")
        if speculative is not None and self._async_depth:
            raise ValueError(
                "async_depth and speculative decoding are mutually exclusive: a round's "
                "accept/reject must see every verify result before the next round is "
                "proposed, so there is nothing to pipeline")
        # a speculative request reserves one private spare block beyond its
        # footprint: the copy-on-write target of each round's boundary block
        self._extra_blocks = 1 if speculative is not None else 0

        # kept for the hot restart, which rebuilds the pool and the host pool
        self._block_size = int(block_size)
        self._num_blocks = int(num_blocks)
        self._prefix_cache = bool(prefix_cache)
        self._kv = PagedKVPool(num_blocks, block_size, prefix_cache)
        # every block table is padded to the worst-case footprint, so the
        # decode call's shape never depends on a request's length
        self.table_blocks = self._kv.blocks_needed(self.seq_buckets[-1], self.max_new_tokens)
        if self.table_blocks + self._extra_blocks > self._kv.num_blocks:
            raise ValueError(
                f"worst-case request needs {self.table_blocks + self._extra_blocks} blocks but "
                f"num_blocks is {self._kv.num_blocks}; grow the pool or shrink "
                "seq_buckets/max_new_tokens"
            )
        if quant is True:
            quant = quantize_tree(model.state_dict())
        self._quant = quant or None  # the int8 state_dict the decode steps read
        self._fns = build_paged_fns(model, block_size, num_blocks, temperature=temperature,
                                    quant=self._quant)
        self._temperature = float(temperature)
        self._pool = self._fns.init_pool()
        self._draft_fns = self._draft_pool = self._dkv = None
        if speculative is not None:
            # no draft model: the target drafts for itself (acceptance 1.0)
            draft = speculative.draft_model if speculative.draft_model is not None else model
            self._draft_lora = getattr(draft, "lora_adapters", 0) > 0
            # the draft is greedy whatever the engine's temperature
            self._draft_fns = build_paged_fns(draft, block_size, num_blocks, temperature=0.0)
            self._build_draft()
        self._seed = int(seed)
        self._seq_no = 0  # guarded by: self._cond

        # the scheduler thread's working set: only _admit, _fail_inflight
        # and drain touch it across threads, under the condition
        self._slots: List[Optional[_PagedRequest]] = [None] * self.slots_n  # confined: _loop
        self._queue: "deque[_PagedRequest]" = deque()  # guarded by: self._cond
        # the kv-transfer verbs' queue: (verb, argument, future), run on the
        # scheduler thread at its next tick boundary
        self._xfer_q: deque = deque()  # guarded by: self._cond
        self._cond = threading.Condition()
        self._closed = False  # guarded by: self._cond
        self._draining = False  # guarded by: self._cond
        self._drain_deadline: Optional[float] = None  # guarded by: self._cond
        self._last_tick: Optional[float] = None  # guarded by: self._cond
        self._hang_info = None  # guarded by: self._cond
        self._die_exc: Optional[BaseException] = None  # guarded by: self._cond
        self._dead = False  # guarded by: self._cond
        self._hang_sec: Optional[float] = None  # guarded by: self._cond
        self._tick_started_at: Optional[float] = None  # guarded by: self._cond
        # prefix-cache block tallies for the registry gauges
        self._hit_blocks = 0
        self._miss_blocks = 0
        self._tick_no = 0  # confined: _loop
        self._tick_phase = ""  # confined: _loop
        # async pipeline: (out_dev, rows) per dispatched, undrained step;
        # _carry_tok is the last dispatch's token row on the device
        self._inflight: deque = deque()  # confined: _loop
        self._carry_tok = None  # confined: _loop
        self._last_dispatch: Optional[tuple] = None  # confined: _loop
        self._tick_block_s = 0.0  # confined: _loop

        res = dict(resilience or {})
        wd = dict(res.pop("watchdog", None) or {})
        self.drain_deadline_ms = res.pop("drain_deadline_ms", None)
        if self.drain_deadline_ms is not None:
            self.drain_deadline_ms = float(self.drain_deadline_ms)
            if self.drain_deadline_ms <= 0:
                raise ValueError(f"drain_deadline_ms must be > 0, got {self.drain_deadline_ms}")
        self._supervisor = ServingSupervisor(
            self,
            max_restarts=int(res.pop("max_restarts", 2)),
            poison_bisect=bool(res.pop("poison_bisect", True)),
            logger=self.logger,
        )
        if res:
            raise ValueError(f"unknown serving.resilience keys: {sorted(res)}")
        wd_enabled = bool(wd.pop("enabled", False))
        wd_kwargs = dict(factor=float(wd.pop("factor", 10.0)),
                         min_seconds=float(wd.pop("min_seconds", 60.0)),
                         warmup=int(wd.pop("warmup", 3)),
                         poll_seconds=wd.pop("poll_seconds", None))
        if wd:
            raise ValueError(f"unknown serving.resilience.watchdog keys: {sorted(wd)}")
        self._watchdog: Optional[StepWatchdog] = None
        if wd_enabled:
            self._watchdog = StepWatchdog(on_hang=self._on_tick_hang, logger=self.logger,
                                          **wd_kwargs)

        self._beat(force=True)  # the file exists from birth: no start-up grace race
        if heartbeat_path is not None:
            _hook_block_beats(model)
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="serving-scheduler", daemon=True
            )
            self._thread.start()

    # ------------------------------------------------------------------ #
    # client side

    def submit(
        self,
        prompt,
        deadline_ms: Optional[float] = None,
        max_new_tokens: Optional[int] = None,
        on_token: Optional[Callable[[int], None]] = None,
        key: Optional[Sequence[int]] = None,
        replay_tokens: Optional[Sequence[int]] = None,
        adapter: Optional[str] = None,
    ) -> Future:
        """Enqueue one prompt; the future resolves at retirement.

        ``max_new_tokens`` caps this request below the scheduler-wide
        budget (its slot retires at the cap); ``key`` (non-negative ints)
        sets the request's sampling key, default ``(seed, seq_no)``;
        ``adapter`` names a registered LoRA adapter (``None``: the base
        model).  ``replay_tokens``: the tokens the client already holds;
        admission replays them (:meth:`_replay`), checks each one and does
        not stream them again, and decoding goes on from there.  It needs
        the original ``key``: another key would draw another stream.
        """
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(
                f"prompt must be a non-empty 1-D token sequence, got shape {prompt.shape}"
            )
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(f"prompt must hold integer tokens, got {prompt.dtype}")
        if prompt.size > self.seq_buckets[-1]:
            raise ValueError(
                f"prompt length {prompt.size} exceeds largest seq bucket {self.seq_buckets[-1]}"
            )
        # an out-of-range id would index past the embedding table on the card
        if prompt.min() < 0 or prompt.max() >= self.vocab_size:
            raise ValueError(f"prompt tokens must lie in [0, {self.vocab_size})")
        prompt = prompt.astype(np.int32)
        mnt = self.max_new_tokens if max_new_tokens is None else int(max_new_tokens)
        if not 1 <= mnt <= self.max_new_tokens:
            raise ValueError(f"max_new_tokens must be in [1, {self.max_new_tokens}], got {mnt}")
        dl = deadline_ms if deadline_ms is not None else self.deadline_ms
        if dl is not None and dl <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {dl}")
        if key is not None:
            key = tuple(int(k) for k in key)
            if not key or min(key) < 0:
                raise ValueError(f"key must be non-negative ints, got {key}")
        aid = -1
        if adapter is not None:
            if self._lora is None:
                raise ValueError("adapter= requires serving.lora.enabled (no adapter registry "
                                 "on this engine)")
            aid = self._lora.id_of(adapter)
        replay = [int(t) for t in replay_tokens] if replay_tokens else []
        if replay:
            if key is None:
                raise ValueError(
                    "replay_tokens needs the original submission's key: another key draws "
                    "another stream, and every replayed token would count as "
                    "replay_parity_mismatch")
            if len(replay) >= mnt:
                raise ValueError(
                    f"replay_tokens ({len(replay)}) must be shorter than max_new_tokens "
                    f"({mnt}): a finished request has nothing left to decode")
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self._draining:
                raise RuntimeError("scheduler is draining; not accepting new requests")
            # sweep expired entries first, so live requests are never shed
            # to protect doomed ones
            self._sweep_expired_locked()
            if self.max_backlog is not None and len(self._queue) >= self.max_backlog:
                self._bump("sheds")
                raise OverloadedError(
                    f"serving backlog full ({self.max_backlog} waiting); request shed"
                )
            if key is None:
                key = (self._seed, self._seq_no)
                self._seq_no += 1
            req = _PagedRequest(
                prompt, mnt, deadline=(time.monotonic() + dl / 1000.0) if dl else None,
                on_token=on_token, key=key,
            )
            req.adapter, req.adapter_name = aid, adapter
            if replay:
                req.tokens = replay
                req.dispatched = len(replay)
            self._queue.append(req)
            self.metrics.observe_depth(len(self._queue))
            self._cond.notify_all()
        return req.future

    def depth(self) -> int:
        """Requests queued but not yet admitted to a slot."""
        with self._cond:
            return len(self._queue)

    def active(self) -> int:
        """Slots currently decoding."""
        with self._cond:
            return sum(1 for s in self._slots if s is not None)

    def calls(self) -> Dict[str, int]:
        """Paged calls so far, by kind (prefill, decode_step,
        decode_step_fed, verify: each runs every block of the target once;
        copy_rows), and the draft's as ``draft_<kind>``."""
        out = dict(self._fns.calls)
        if self._draft_fns is not None:
            out.update({f"draft_{k}": v for k, v in self._draft_fns.calls.items()})
        return out

    def drain(self, deadline_ms: Optional[float] = None) -> float:
        """Graceful shutdown: stop admitting, finish the queued and
        in-flight work, close.  Returns wall ms.  Past ``deadline_ms``
        (default ``resilience.drain_deadline_ms``; None: unbounded) the
        next tick fails what remains with ``TimeoutError``.  Safe from any
        thread; idempotent."""
        t0 = time.monotonic()
        dl = deadline_ms if deadline_ms is not None else self.drain_deadline_ms
        with self._cond:
            if self._closed:
                return 0.0
            self._draining = True
            if dl is not None:
                self._drain_deadline = t0 + dl / 1000.0
            self._cond.notify_all()
        if self._thread is None:
            while self.tick():
                pass
        else:
            with self._cond:
                while not self._closed and (
                    self._queue or any(s is not None for s in self._slots)
                ):
                    # the loop thread does the work and enforces the deadline
                    self._cond.wait(timeout=0.01)
        self.close()
        return (time.monotonic() - t0) * 1000.0

    def health(self) -> Dict[str, Any]:
        """Readiness/liveness snapshot for orchestration probes: ``ready``
        means accepting submissions, ``live`` worth keeping (False once the
        restart budget is spent, the scheduler was killed or, with
        ``liveness_timeout_s``, the thread has had work and made no progress
        for that long: ``stalled``; an idle scheduler never stalls).
        Mirrored into the metrics' ``health_*`` gauges."""
        now = time.monotonic()
        with self._cond:
            depth = len(self._queue)
            active = sum(1 for s in self._slots if s is not None)
            closed, draining = self._closed, self._draining
            last, dead = self._last_tick, self._dead
            started = self._tick_started_at
        exhausted = self._supervisor.exhausted()
        stalled = False
        if self._liveness_timeout_s is not None:
            # a tick in progress is busy from its start (a hung call never
            # updates _last_tick); otherwise only pending work makes an old
            # tick suspicious
            busy = started is not None or depth > 0 or active > 0
            ref = started if started is not None else last
            if busy and ref is not None:
                stalled = (now - ref) > self._liveness_timeout_s
        snap = {
            "ready": not (closed or draining or exhausted or dead or stalled),
            "live": not (exhausted or dead or stalled),
            "stalled": stalled,
            "queue_depth": depth,
            "active_slots": active,
            "slots": self.slots_n,
            "engine_restarts": self._supervisor.restarts(),
            "restart_budget": self._supervisor.max_restarts,
            "last_tick_age_s": (now - last) if last is not None else None,
            "draining": draining,
            "closed": closed,
        }
        self.metrics.record_health(snap)
        return snap

    def hard_kill(self, exc: BaseException) -> None:
        """Fail every queued and in-flight request with ``exc`` and close,
        at the scheduler thread's next tick boundary.  Safe from any
        thread; idempotent."""
        with self._cond:
            if self._closed or self._die_exc is not None:
                return
            self._die_exc = exc
            self._cond.notify_all()

    def inject_hang(self, seconds: float) -> None:
        """Wedge the scheduler thread for ``seconds`` at its next tick
        boundary (the ``replica_hang`` fault): no progress and no
        heartbeat, which only an outside reader of the heartbeat's age (or
        ``health()``'s liveness clock) can see."""
        with self._cond:
            if self._closed:
                return
            self._hang_sec = float(seconds)
            self._cond.notify_all()

    def _queue_xfer(self, verb: str, arg) -> Future:
        fut: Future = Future()
        with self._cond:
            if self._closed or self._dead:
                raise RuntimeError(f"cannot {verb.split('_')[0]} KV blocks: scheduler is closed")
            self._xfer_q.append((verb, arg, fut))
            self._cond.notify_all()
        return fut

    def export_kv_prefix(self, prompt: Sequence[int], namespace=None,
                         stall_s: Optional[float] = None) -> Future:
        """The cached prefix blocks of ``prompt`` as CRC-sealed
        payloads (:class:`.kv_transfer.BlockPayload`, possibly none), gathered and
        copied to the host on the scheduler thread at its next tick
        boundary.  ``stall_s`` (the ``kv_transfer_stall`` fault) sleeps
        there before resolving."""
        arr = np.asarray(prompt, dtype=np.int32).reshape(-1)
        return self._queue_xfer("export", (arr, namespace, stall_s))

    def export_kv_refs(self, prompt: Sequence[int], namespace=None,
                       stall_s: Optional[float] = None) -> Future:
        """The same blocks as refs (:class:`.kv_transfer.BlockRef`): only the
        gather runs on the scheduler thread; the caller copies them to the
        host (:func:`.kv_transfer.materialize_payloads`) on its own."""
        arr = np.asarray(prompt, dtype=np.int32).reshape(-1)
        return self._queue_xfer("export_refs", (arr, namespace, stall_s))

    def import_kv_blocks(self, payloads) -> Future:
        """Adopt transferred blocks into the prefix cache; resolves to
        ``{"accepted", "rejected", "bytes"}``.  In chain order: a checksum
        mismatch rejects the block and stops the chain, a key already
        cached is skipped (a local prefill beat the transfer), a full pool
        stops the chain.  A bad payload never raises: the request
        recomputes what did not land."""
        return self._queue_xfer("import", list(payloads))

    def close(self) -> None:
        """Drain queue and in-flight slots, then stop the loop."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
        else:
            # start=False: drain here
            while self.tick():
                pass
        if self._watchdog is not None:
            self._watchdog.close()
        self._report_unfired_faults()

    def _report_unfired_faults(self) -> None:
        """Count and log each injected serve fault still armed at close, so
        every injected fault ends as fired or reported unfired."""
        for kind, steps in fault.get_injector().pending().items():
            if not kind.startswith(("serve_", "replica_")):
                continue
            fault.bump(f"fault_unfired_{kind}", len(steps))
            self.logger.warning(
                "scheduler closed with injected %s fault(s) still armed for tick(s) %s "
                "- the engine never reached them", kind, steps,
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ #
    # scheduler side: everything below runs on one thread (the loop, or a
    # test driving tick() by hand), which is what lets kv_pool go lock-free

    def tick(self) -> bool:
        """One iteration: admit + prefill, then one decode step.  Returns
        True if any work happened.  A failing tick goes to the
        supervisor, which evicts the poisoned request or hot-restarts."""
        with self._cond:
            self._tick_started_at = time.monotonic()
            die = self._die_exc
            hang, self._hang_sec = self._hang_sec, None
        if hang is not None:
            # the simulated wedge sleeps before the heartbeat, so the file
            # goes stale as it would under a stuck device call
            self.logger.warning("fault injection: replica scheduler wedged for %.2fs", hang)
            time.sleep(hang)
        if die is not None:
            try:
                self._die(die)
            finally:
                with self._cond:
                    self._tick_started_at = None
            return True
        self._beat()
        self._tick_no += 1
        self._tick_phase = "setup"
        if self._watchdog is not None:
            self._watchdog.step_started(self._tick_no)
        try:
            try:
                _ticking.beat = self._beat
                # host ms of a tick: its wall time less the time it waited
                # on device readbacks (the decode paths add those waits)
                self._tick_block_s = 0.0
                t_tick0 = time.perf_counter()
                did = self._tick_inner()
                if did:
                    self.metrics.record_tick(max(
                        time.perf_counter() - t_tick0 - self._tick_block_s, 0.0) * 1000.0)
            finally:
                if self._watchdog is not None:
                    self._watchdog.step_finished()
                _ticking.beat = None
                with self._cond:
                    self._last_tick = time.monotonic()
                    self._tick_started_at = None
            with self._cond:
                hang, self._hang_info = self._hang_info, None
            if hang is not None and hang[0] == self._tick_no:
                raise HungTickError(
                    f"scheduler tick {hang[0]} ran {hang[1]:.2f}s "
                    f"(watchdog limit {hang[2]:.2f}s)"
                )
            return did
        except Exception as exc:
            self.logger.exception(
                "scheduler tick %d failed in phase %r; invoking supervisor",
                self._tick_no, self._tick_phase,
            )
            # settle the async ring first: probes and replays assume the
            # sync path's host state (a no-op in sync mode)
            self.flush_async()
            return self._supervisor.handle_tick_failure(exc)

    def _tick_inner(self) -> bool:
        with self._cond:
            expired = (
                self._draining
                and self._drain_deadline is not None
                and time.monotonic() >= self._drain_deadline
                and (bool(self._queue) or any(s is not None for s in self._slots))
            )
        if expired:
            self._bump("drain_expired")
            self._fail_inflight(
                TimeoutError("graceful drain exceeded its deadline; failing the remaining "
                             "requests")
            )
            return True
        self._enter_phase("kv_transfer")
        did_xfer = self._service_kv_transfers()
        self._enter_phase("admit")
        newly = self._admit()
        self._enter_phase("prefill")
        if newly:
            self._prefill(newly)
        self._enter_phase("inject")
        self._consult_injector()
        n_active = self.active()
        if n_active:
            self._enter_phase("decode")
            if self._spec is not None:
                self._spec_decode_step()
            elif self._async_depth:
                self._decode_step_async()
            else:
                self._decode_step()
        self._publish_pool_gauges()
        return bool(newly) or n_active > 0 or did_xfer

    def _bump(self, name: str, n: int = 1) -> None:
        """Engine-local and process-wide: the snapshot shows this engine's
        counts, the telemetry registry ``serving_<name>`` (a fleet
        replica's ``serving_r<id>_<name>``)."""
        self.metrics.incr(name, n)
        get_registry().counter(self.metrics.global_name(name)).inc(n)

    def _enter_phase(self, phase: str) -> None:
        """Name the tick's phase and beat: progress through a tick keeps the
        heartbeat fresh (a one-process fleet's ticks slow down together
        under host load, each phase far less than the whole tick)."""
        self._tick_phase = phase
        self._beat()

    def _beat(self, force: bool = False) -> None:
        """Rewrite the heartbeat file, at most every ``heartbeat_interval_s``
        (a temporary file and ``os.replace``; the mtime is the clock).  A
        failed write is logged and the replica looks stale, the safe side."""
        if self.heartbeat_path is None:
            return
        now = time.monotonic()
        if not force and now - self._last_beat < self._hb_interval:
            return
        self._last_beat = now
        tmp = self.heartbeat_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"replica_id": self.replica_id, "pid": os.getpid(),
                           "tick": self._tick_no}, f)
            os.replace(tmp, self.heartbeat_path)
        except OSError:
            self.logger.exception("heartbeat write failed; continuing")

    def _publish_pool_gauges(self) -> None:
        """Block utilisation and prefix-hit rate in the process registry
        (the router's placement reads the former)."""
        reg = get_registry()
        util = self._kv.blocks_in_use / max(self._kv.num_blocks, 1)
        reg.gauge(self.metrics.global_name("block_util")).set(util)
        total = self._hit_blocks + self._miss_blocks
        if total:
            reg.gauge(self.metrics.global_name("prefix_hit_rate")).set(self._hit_blocks / total)

    # ------------------------------------------------------------------ #
    # the kv-transfer verbs, on the scheduler thread

    def _service_kv_transfers(self) -> bool:
        did = False
        while True:
            with self._cond:
                if not self._xfer_q:
                    return did
                verb, arg, fut = self._xfer_q.popleft()
            did = True
            try:
                if verb == "export":
                    res = self._export_kv(*arg, materialize=True)
                elif verb == "export_refs":
                    res = self._export_kv(*arg, materialize=False)
                else:
                    res = self._import_kv(arg)
            except Exception as exc:
                # the verb failed, not the engine: an export only reads the
                # pool, a failed import gives back the blocks it adopted
                if not fut.done():
                    fut.set_exception(exc)
            else:
                if not fut.done():
                    fut.set_result(res)
            self._beat()

    def _export_kv(self, prompt, namespace, stall_s, materialize: bool):
        refs = kv_transfer.extract_block_refs(self._kv, self._pool, prompt, namespace=namespace)
        out = kv_transfer.materialize_payloads(refs) if materialize else refs
        if refs:
            self._bump("kv_transfer_exported_blocks", len(refs))
        if stall_s is not None:
            self.logger.warning("fault injection: kv transfer export stalled %.2fs", stall_s)
            time.sleep(float(stall_s))
        return out

    def _import_kv(self, payloads):
        t0 = time.perf_counter()
        n_rows = self._kv.num_blocks * self._kv.block_size
        accepted, rejected, nbytes = [], 0, 0
        for p in payloads:
            why = ("checksum" if not kv_transfer.verify_payload(p)
                   else kv_transfer.payload_mismatch(p, self._pool, self._kv.block_size))
            if why is not None:
                rejected += 1
                self._bump("kv_transfer_rejects")
                self.logger.warning(
                    "kv transfer: reject of block %d (%s); dropping the rest of the chain, "
                    "the request recomputes it", p.index, why)
                break
            if self._kv.is_cached(p.key):
                continue
            blk = self._kv.adopt_block(p.key)
            if blk is None:
                break  # the pool is full even after eviction: a partial import
            accepted.append((blk, p))
            nbytes += p.nbytes
        if accepted:
            try:
                kv_transfer.scatter_payloads(self._pool, n_rows, accepted)
            except BaseException:
                # a key must never name a block that was not written
                for _, p in accepted:
                    self._kv.unadopt_block(p.key)
                raise
        if accepted or rejected:
            self.metrics.record_kv_transfer(nbytes=nbytes, seconds=time.perf_counter() - t0,
                                            blocks=len(accepted))
            reg = get_registry()
            if nbytes:
                reg.counter(self.metrics.global_name("kv_transfer_bytes")).inc(nbytes)
            if accepted:
                reg.counter(self.metrics.global_name("kv_transfer_blocks")).inc(len(accepted))
        return {"accepted": len(accepted), "rejected": rejected, "bytes": nbytes}

    def _expire(self, req: _PagedRequest, now: float) -> bool:
        if req.deadline is None or now < req.deadline:
            return False
        self._bump("timeouts")
        if not req.future.done():
            req.future.set_exception(TimeoutError(
                f"serving request exceeded its deadline after {now - req.enqueued_at:.3f}s "
                "in queue"))
        return True

    def _sweep_expired_locked(self) -> None:
        now = time.monotonic()
        if any(r.deadline is not None and now >= r.deadline for r in self._queue):
            self._queue = deque(r for r in self._queue if not self._expire(r, now))

    def _admit(self) -> List[_PagedRequest]:
        """Fill free slots from the queue head (first come, first served: a
        head request the pool cannot cover blocks those behind it, counted
        as ``admission_waits``)."""
        newly: List[_PagedRequest] = []
        with self._cond:
            self._sweep_expired_locked()
            free = [i for i, s in enumerate(self._slots) if s is None]
            # one prefill call a tick: at most the largest batch bucket
            max_admit = min(len(free), self.batch_buckets[-1])
            while self._queue and len(newly) < max_admit:
                req = self._queue[0]
                # the adapter id namespaces the prefix cache: the same prompt
                # under two adapters has different K/V
                adm = self._kv.admit(req.prompt.tolist(), req.max_new, namespace=req.adapter,
                                     extra_blocks=self._extra_blocks)
                if adm is None:
                    self._bump("admission_waits")
                    break
                if self._spec is not None:
                    # all or nothing across both pools: holding the target's
                    # blocks while waiting on the draft's could deadlock two
                    # half-admitted requests
                    dadm = self._dkv.admit(req.prompt.tolist(), req.max_new)
                    if dadm is None:
                        self._kv.release(adm)
                        self._bump("admission_waits")
                        break
                    req.draft_admission = dadm
                self._queue.popleft()
                req.admission = adm
                req.slot = free[len(newly)]
                self._slots[req.slot] = req
                newly.append(req)
                self._bump("admitted")
                cacheable = (req.prompt.size - 1) // self._kv.block_size
                self._hit_blocks += adm.n_shared
                self._miss_blocks += cacheable - adm.n_shared
                if adm.n_shared:
                    self._bump("prefix_hit_blocks", adm.n_shared)
                if cacheable - adm.n_shared:
                    self._bump("prefix_miss_blocks", cacheable - adm.n_shared)
        return newly

    def _bucket_for(self, n: int, buckets: Sequence[int], kind: str) -> int:
        for b in buckets:
            if n <= b:
                return b
        raise ValueError(f"{kind} {n} exceeds largest bucket {buckets[-1]}")

    def _table_ids(self, req: _PagedRequest) -> List[int]:
        """The request's logical block table: its footprint blocks in
        order.  In speculative mode the admission ends in the private spare
        block, which is never in the table: verify reaches it through the
        forked table and the commit swaps it in (inside ``block_ids``, so
        release and refcounts stay exact)."""
        ids = req.admission.block_ids
        return ids[: len(ids) - self._extra_blocks] if self._extra_blocks else ids

    def _prefill(self, newly: List[_PagedRequest]) -> None:
        """Fresh admissions go through one bucketed prefill; requests
        re-admitted by a hot restart carry their stream and replay.  In
        speculative mode the draft's pool gets every prompt too."""
        fresh = [r for r in newly if not r.tokens]
        replay = [r for r in newly if r.tokens]
        if fresh:
            self._prefill_fresh(fresh)
        if replay:
            self._replay(replay)
        if self._spec is not None:
            # requests the prefill's finite guard evicted released both pools
            live = [r for r in newly if r.admission is not None]
            if live:
                self._draft_prefill(live)

    def _prefill_call(self, reqs: List[_PagedRequest], kind: str):
        """One bucketed prefill of ``reqs``' suffixes past their cached
        prefix (positions ``cached_len .. prompt_len - 1``); returns the
        host copy ``[2, bb]`` (tokens, finite) and the suffix lengths."""
        suffix = [r.prompt.size - r.admission.cached_len for r in reqs]
        bb = self._bucket_for(len(reqs), self.batch_buckets, f"{kind} rows")
        sb = self._bucket_for(max(suffix), self.seq_buckets, f"{kind} suffix")
        tokens = np.zeros((bb, sb), np.int64)
        positions = np.full((bb, sb), -1, np.int64)
        tables = np.zeros((bb, self.table_blocks), np.int64)
        last_col = np.zeros((bb,), np.int64)
        aids = np.full((bb,), -1, np.int64)
        keys: List[Optional[tuple]] = [None] * bb
        for i, req in enumerate(reqs):
            cl = req.admission.cached_len
            tokens[i, : suffix[i]] = req.prompt[cl:]
            positions[i, : suffix[i]] = np.arange(cl, req.prompt.size)
            ids = self._table_ids(req)
            tables[i, : len(ids)] = ids
            last_col[i] = suffix[i] - 1
            aids[i] = req.adapter
            keys[i] = req.key
        out = self._fns.prefill(self._pool, tokens, positions, tables, last_col, keys,
                                np.zeros((bb,), np.int64), aids)
        rb0 = time.perf_counter()
        res = out.cpu().numpy()
        self._tick_block_s += time.perf_counter() - rb0
        return res, suffix

    def _prefill_fresh(self, newly: List[_PagedRequest]) -> None:
        """One bucketed prefill over this tick's fresh admissions; a prefix
        hit feeds only the suffix past ``cached_len``."""
        t0 = time.perf_counter()
        res, suffix = self._prefill_call(newly, "admitted")
        t1 = time.perf_counter()
        for i, req in enumerate(newly):
            if not res[1, i]:
                # this prompt gave non-finite logits: evict it, and keep its
                # blocks out of the prefix cache
                self._evict_poisoned(req, cause=None, trigger="non-finite prefill logits")
                continue
            # the blocks are filled: publish them before the request can
            # retire and release them
            self._kv.register_prefix(req.prompt.tolist(), req.admission, namespace=req.adapter)
            self._push_token(req, int(res[0, i]))
        self.metrics.record_prefill(prompt_tokens=int(sum(suffix)), n_requests=len(newly),
                                    prefill_s=t1 - t0)

    def _draft_prefill(self, reqs: List[_PagedRequest]) -> None:
        """Each admitted request's whole prompt into the draft's pool (no
        prefix cache there, so the target's hits cannot shorten it).  Its
        token is not read: rounds start from the committed stream.  A
        replayed request's generated tokens are not written to the draft's
        pool: those rows read as zeros, which can lower the acceptance rate
        but never change the committed stream."""
        bb = self._bucket_for(len(reqs), self.batch_buckets, "draft rows")
        sb = self._bucket_for(max(r.prompt.size for r in reqs), self.seq_buckets, "draft prompt")
        tokens = np.zeros((bb, sb), np.int64)
        positions = np.full((bb, sb), -1, np.int64)
        tables = np.zeros((bb, self.table_blocks), np.int64)
        last_col = np.zeros((bb,), np.int64)
        aids = np.full((bb,), -1, np.int64)
        for i, req in enumerate(reqs):
            n = req.prompt.size
            tokens[i, :n] = req.prompt
            positions[i, :n] = np.arange(n)
            dids = req.draft_admission.block_ids
            tables[i, : len(dids)] = dids
            last_col[i] = n - 1
            if self._draft_lora:
                aids[i] = req.adapter
        self._draft_fns.prefill(self._draft_pool, tokens, positions, tables, last_col,
                                [None] * bb, np.zeros((bb,), np.int64), aids)

    def _replay(self, reqs: List[_PagedRequest]) -> None:
        """Rebuild restarted requests' KV state: the prompt through the
        bucketed prefill, then the delivered tokens fed again through the
        same decode call that produced them.  Every resampled token is
        checked against the delivered stream and never delivered again
        (``on_token`` does not refire)."""
        res, _ = self._prefill_call(reqs, "replayed")
        live: List[_PagedRequest] = []
        for i, req in enumerate(reqs):
            if not res[1, i]:
                self._evict_poisoned(req, cause=None, trigger="non-finite replay prefill logits")
                continue
            self._kv.register_prefix(req.prompt.tolist(), req.admission, namespace=req.adapter)
            self._verify_replay(req, 0, int(res[0, i]))
            live.append(req)
        # feed generated tokens 0..K-2 back, checking tokens 1..K-1
        max_gen = max((r.gen_idx for r in live), default=0)
        for k in range(1, max_gen):
            step_reqs = [r for r in live if r.gen_idx > k]
            if not step_reqs:
                break
            W = self.slots_n
            prev = np.zeros((W,), np.int64)
            pos = np.full((W,), -1, np.int64)
            tables = np.zeros((W, self.table_blocks), np.int64)
            gi = np.zeros((W,), np.int64)
            aids = np.full((W,), -1, np.int64)
            keys: List[Optional[tuple]] = [None] * W
            for req in step_reqs:
                i = req.slot
                prev[i] = req.tokens[k - 1]
                pos[i] = req.prompt.size + k - 1
                ids = self._table_ids(req)
                tables[i, : len(ids)] = ids
                gi[i] = k
                aids[i] = req.adapter
                keys[i] = req.key
            res = self._fns.decode_step(self._pool, prev, pos, tables, keys, gi,
                                        aids).cpu().numpy()
            for req in step_reqs:
                if not res[1, req.slot]:
                    self._evict_poisoned(req, cause=None,
                                         trigger="non-finite replay decode logits")
                    live.remove(req)
                    continue
                self._verify_replay(req, k, int(res[0, req.slot]))
        for req in live:
            self._bump("replayed_tokens", req.gen_idx)

    def _verify_replay(self, req: _PagedRequest, idx: int, tok: int) -> None:
        """The resample must equal what the client already holds; a
        mismatch is counted and logged, the delivered stream kept."""
        if tok != req.tokens[idx]:
            self._bump("replay_parity_mismatch")
            self.logger.error(
                "replay divergence: slot %d generated token %d resampled as %d but %d was "
                "delivered (keeping the delivered stream)", req.slot, idx, tok, req.tokens[idx],
            )

    # ------------------------------------------------------------------ #
    # fault injection (the serve_* kinds), consulted once a tick after
    # admission, so the slot targets exist

    def _consult_injector(self) -> None:
        inj = fault.get_injector()
        if not inj.active:
            return
        t = self._tick_no
        sec = inj.take("serve_hang", t)
        if sec is not None:
            fault.bump("injected_serve_hangs")
            self.logger.warning("fault injection: hanging tick %d for %.2fs", t, sec)
            time.sleep(sec)
        slot = inj.take("serve_raise", t)
        if slot is not None:
            req = self._slot_target(int(slot), "serve_raise")
            if req is not None:
                fault.bump("injected_serve_raises")
                req.poison = "raise"
        slot = inj.take("serve_nan", t)
        if slot is not None:
            req = self._slot_target(int(slot), "serve_nan")
            if req is not None:
                fault.bump("injected_serve_nans")
                self._corrupt_pool_rows(req)
        if inj.take("serve_device_lost", t) is not None:
            fault.bump("injected_serve_device_lost")
            raise fault.DeviceLostError(f"injected device loss at serving tick {t}")

    def _slot_target(self, slot: int, kind: str) -> Optional[_PagedRequest]:
        req = self._slots[slot] if 0 <= slot < self.slots_n else None
        if req is None:
            self.logger.warning("fault injection: %s@%d targets empty slot %d; dropped",
                                kind, self._tick_no, slot)
        return req

    @torch.inference_mode()
    def _corrupt_pool_rows(self, req: _PagedRequest) -> None:
        """NaN the key-pool row of ``req``'s last written position, in
        every layer.  Its block lies past the prefix-cache registration cap,
        so it is the request's own.  Only keys: a NaN key makes the owner's
        scores NaN (the position is live for it) while any other reader,
        a later request on the recycled block included, masks it to -inf."""
        bs = self._kv.block_size
        p = req.prompt.size + max(req.gen_idx, 1) - 2
        row = req.admission.block_ids[p // bs] * bs + p % bs
        for k in self._pool.keys:
            k[row] = float("nan")

    # ------------------------------------------------------------------ #
    # decode

    def _decode_arrays(self, reqs: List[_PagedRequest]):
        """Fixed-width decode inputs with ``reqs`` live and every other slot
        riding along at position -1."""
        W = self.slots_n
        prev = np.zeros((W,), np.int64)
        pos = np.full((W,), -1, np.int64)
        tables = np.zeros((W, self.table_blocks), np.int64)
        gen_idx = np.zeros((W,), np.int64)
        aids = np.full((W,), -1, np.int64)
        keys: List[Optional[tuple]] = [None] * W
        for req in reqs:
            i = req.slot
            prev[i] = req.tokens[-1]
            # prev = generated token gen_idx-1 at position prompt_len +
            # gen_idx - 1; feeding it samples token gen_idx
            pos[i] = req.prompt.size + req.gen_idx - 1
            ids = self._table_ids(req)
            tables[i, : len(ids)] = ids
            gen_idx[i] = req.gen_idx
            aids[i] = req.adapter
            keys[i] = req.key
        return prev, pos, tables, keys, gen_idx, aids

    def _poison_shim(self, reqs: List[_PagedRequest]) -> None:
        """The injected per-request dispatch failure (``serve_raise``); the
        message names no slot: attribution is the bisect's job."""
        for req in reqs:
            if req.poison == "raise":
                raise fault.FaultInjectionError(
                    f"injected decode-dispatch failure (tick {self._tick_no})")

    def _decode_step(self) -> None:
        """One single-token step for every occupied slot."""
        t0 = time.perf_counter()
        active = [req for req in self._slots if req is not None]
        self._poison_shim(active)
        args = self._decode_arrays(active)
        self._note_dispatch_gap()
        # the span marks the tick as productive serving work
        with span("decode_step", step=self._tick_no, active=len(active)):
            out = self._fns.decode_step(self._pool, *args)
        rb0 = time.perf_counter()
        res = out.cpu().numpy()
        t1 = time.perf_counter()
        self._tick_block_s += t1 - rb0
        for req in active:
            if not res[1, req.slot]:
                # the finite guard: evict the NaN emitter; the other rows'
                # logits are untouched (disjoint block tables)
                self._evict_poisoned(req, cause=None, trigger="non-finite decode logits")
                continue
            self._push_token(req, int(res[0, req.slot]))
        self.metrics.record_decode(n_tokens=len(active), decode_s=t1 - t0)
        self.metrics.record_iteration(
            active_slots=len(active), total_slots=self.slots_n,
            blocks_in_use=self._kv.blocks_in_use, total_blocks=self._kv.num_blocks,
        )

    def _decode_probe(self, reqs: List[_PagedRequest]) -> None:
        """Repeat the decode dispatch for a subset of the active slots (the
        bisect's primitive).  The inputs are the failed step's, so the
        scatter writes the same rows again and the draws repeat."""
        self._poison_shim(reqs)
        out = self._fns.decode_step(self._pool, *self._decode_arrays(reqs))
        out.cpu()  # surface an asynchronous launch error inside the probe

    # ------------------------------------------------------------------ #
    # async decode pipeline (serving.scheduler.async_depth > 0)

    def _note_dispatch_gap(self) -> None:
        """Host ms between decode dispatches of back-to-back ticks (an idle
        queue between two dispatches is not host overhead)."""
        now = time.perf_counter()
        if self._last_dispatch is not None and self._tick_no - self._last_dispatch[0] <= 1:
            self.metrics.record_dispatch_gap((now - self._last_dispatch[1]) * 1000.0)
        self._last_dispatch = (self._tick_no, now)

    def _decode_step_async(self) -> None:
        """Dispatch step k without waiting for step k-1's readback.

        The token carry stays on the card (``decode_step_fed``), rows the
        host just (re)filled spliced in with ``fresh_mask``; at most
        ``async_depth`` steps stay undrained.  ``dispatched`` gives every
        position and sampling index, so the drained stream is bitwise the
        sync path's.  Lag, bounded by the depth: retirement and the finite
        guard see tokens late, so a row may run past EOS (never past
        ``max_new``, which is host-exact); those writes land inside its
        own footprint and their tokens are dropped at drain.
        """
        active = [req for req in self._slots if req is not None]
        self._poison_shim(active)
        disp = [r for r in active if r.dispatched < r.max_new]
        if disp:
            W = self.slots_n
            fresh_mask = np.zeros((W,), np.int64)
            fresh_tok = np.zeros((W,), np.int64)
            pos = np.full((W,), -1, np.int64)
            tables = np.zeros((W, self.table_blocks), np.int64)
            gen_idx = np.zeros((W,), np.int64)
            aids = np.full((W,), -1, np.int64)
            keys: List[Optional[tuple]] = [None] * W
            rows = []
            for req in disp:
                i = req.slot
                d = req.dispatched
                if d == req.gen_idx:
                    # nothing of this row is in flight: its last token is
                    # host-known and overrides the stale carry
                    fresh_mask[i] = 1
                    fresh_tok[i] = req.tokens[-1]
                pos[i] = req.prompt.size + d - 1
                ids = self._table_ids(req)
                tables[i, : len(ids)] = ids
                gen_idx[i] = d
                aids[i] = req.adapter
                keys[i] = req.key
                rows.append((req, i, d))
            prev = self._carry_tok if self._carry_tok is not None else self._zero_carry()
            self._note_dispatch_gap()
            with span("decode_step", step=self._tick_no, active=len(disp)):
                out = self._fns.decode_step_fed(self._pool, prev, fresh_mask, fresh_tok, pos,
                                                tables, keys, gen_idx, aids)
            for req in disp:
                req.dispatched += 1
            self._carry_tok = out[0]
            self._inflight.append((out, rows))
            self.metrics.record_iteration(
                active_slots=len(disp), total_slots=self.slots_n,
                blocks_in_use=self._kv.blocks_in_use, total_blocks=self._kv.num_blocks,
            )
        # drain one tick behind dispatch; with nothing left to dispatch,
        # drain everything
        target = self._async_depth if disp else 0
        pushed = 0
        t0 = time.perf_counter()
        while len(self._inflight) > target:
            pushed += self._drain_entry(self._inflight.popleft())
        t1 = time.perf_counter()
        self._tick_block_s += t1 - t0
        if pushed:
            self.metrics.record_decode(n_tokens=pushed, decode_s=t1 - t0)

    def _zero_carry(self):
        """The first dispatch's carry: every dispatched row is fresh, so
        these zeros are never sampled from."""
        return torch.zeros((self.slots_n,), dtype=torch.int64, device=self._fns.device)

    def _drain_entry(self, entry) -> int:
        """Read one ring entry back and apply it.  Rows whose request left
        its slot or whose stream was rolled back since dispatch are
        dropped.  Returns the tokens pushed."""
        out, rows = entry
        res = out.cpu().numpy()
        pushed = 0
        for req, slot, idx in rows:
            if req.admission is None or idx != req.gen_idx:
                continue
            if not res[1, slot]:
                self._evict_poisoned(req, cause=None, trigger="non-finite decode logits")
                continue
            self._push_token(req, int(res[0, slot]))
            pushed += 1
        return pushed

    def flush_async(self) -> None:
        """Drain what the ring can still deliver, drop the rest, and roll
        every live row's dispatch counter back to its host-known stream.
        ``tick`` calls it before the supervisor; a no-op in sync mode."""
        while self._inflight:
            entry = self._inflight.popleft()
            try:
                self._drain_entry(entry)
            except Exception:
                # the device state behind the remaining entries is part of
                # the same failure: drop them; the rollback makes
                # re-dispatch exact
                self.logger.warning("async ring drain failed mid-recovery; discarding %d "
                                    "remaining in-flight step(s)", len(self._inflight))
                self._inflight.clear()
                break
        self._carry_tok = None
        self._last_dispatch = None
        for req in self._slots:
            if req is not None:
                req.dispatched = req.gen_idx

    # ------------------------------------------------------------------ #
    # speculative decoding (serving.speculative)

    @torch.inference_mode()
    def _spec_decode_step(self) -> None:
        """One speculative round for every occupied slot, in place of the
        single-token step (JAX ``:1713-1870``): ``k + 1`` greedy draft steps
        on the draft's pool (the last only writes the last proposal's K/V),
        one ``verify`` on forked block tables, the accept rule on the host,
        then the commit by swap.  Emits 1 to ``k + 1`` tokens a request, each
        the target's argmax, so the stream is plain greedy decode's.

        The fork: the round's verify writes positions ``P .. P + ke`` (``P``
        the last committed token's).  Blocks past ``bi = P // block_size``
        hold nothing committed yet; block ``bi`` holds committed rows ``[bi
        * bs, P)``, so those are copied into the request's spare block and
        verify runs with ``table[bi] := spare``.  The commit swaps the spare
        in; the old block becomes the next round's spare, untouched until
        then.  Rows a rejected proposal wrote past the commit point do no
        harm: every verify scatters its columns before it gathers, and
        positions past a row's coverage are masked.
        """
        t0 = time.perf_counter()
        active = [req for req in self._slots if req is not None]
        self._poison_shim(active)
        W, k, bs = self.slots_n, self._spec.k, self._kv.block_size
        # no proposal past a request's budget: no write past its footprint
        k_eff = {r.slot: min(k, r.max_new - r.gen_idx) for r in active}
        with span("decode_step", step=self._tick_no, active=len(active)):
            draft_tok = np.zeros((W, k), np.int64)
            for j in range(k + 1):
                # step j feeds the committed tail (j = 0) or proposal j - 1
                # at position P + j and proposes token j
                prev = np.zeros((W,), np.int64)
                pos = np.full((W,), -1, np.int64)
                dtables = np.zeros((W, self.table_blocks), np.int64)
                gi = np.zeros((W,), np.int64)
                aids = np.full((W,), -1, np.int64)
                rows = [r for r in active if j <= k_eff[r.slot]]
                if not rows:
                    break
                for req in rows:
                    i = req.slot
                    prev[i] = req.tokens[-1] if j == 0 else draft_tok[i, j - 1]
                    pos[i] = req.prompt.size + req.gen_idx - 1 + j
                    dids = req.draft_admission.block_ids
                    dtables[i, : len(dids)] = dids
                    gi[i] = req.gen_idx + j
                    if self._draft_lora:
                        aids[i] = req.adapter
                out = self._draft_fns.decode_step(self._draft_pool, prev, pos, dtables,
                                                  [None] * W, gi, aids)
                if j < k:
                    rb0 = time.perf_counter()
                    draft_tok[:, j] = out[0].cpu().numpy()
                    self._tick_block_s += time.perf_counter() - rb0

            # the fork, and one target call over [committed tail, proposals]
            sink = self._kv.num_blocks * bs  # out of range: copy_rows skips it
            src = np.full((W, bs), sink, np.int64)
            dst = np.full((W, bs), sink, np.int64)
            ver_tok = np.zeros((W, k + 1), np.int64)
            ver_pos = np.full((W, k + 1), -1, np.int64)
            vtables = np.zeros((W, self.table_blocks), np.int64)
            aids = np.full((W,), -1, np.int64)
            offs = np.arange(bs)
            for req in active:
                i, ke = req.slot, k_eff[req.slot]
                p = req.prompt.size + req.gen_idx - 1
                bi, off = divmod(p, bs)
                ids = self._table_ids(req)
                spare = req.admission.block_ids[-1]
                src[i, :off] = ids[bi] * bs + offs[:off]
                dst[i, :off] = spare * bs + offs[:off]
                ver_tok[i, 0] = req.tokens[-1]
                ver_tok[i, 1:1 + ke] = draft_tok[i, :ke]
                ver_pos[i, : ke + 1] = np.arange(p, p + ke + 1)
                vtables[i, : len(ids)] = ids
                vtables[i, bi] = spare
                aids[i] = req.adapter
            self._fns.copy_rows(self._pool, src.reshape(-1), dst.reshape(-1))
            # verify takes the plain weights, quant mode too: the target's
            # scores are the accuracy anchor
            logits = self._fns.verify(self._pool, ver_tok, ver_pos, vtables, aids)
            picked = torch.stack([logits.argmax(dim=-1),
                                  torch.isfinite(logits).all(dim=-1).long()])
            rb0 = time.perf_counter()
            picked = picked.cpu().numpy()  # [2, W, k + 1]: argmax, finite
            self._tick_block_s += time.perf_counter() - rb0

        t1 = time.perf_counter()
        emitted = proposed = accepted = 0
        for req in active:
            i, ke = req.slot, k_eff[req.slot]
            if not picked[1, i, : ke + 1].all():
                self._evict_poisoned(req, cause=None, trigger="non-finite verify logits")
                continue
            n_acc, emit = greedy_accept(draft_tok[i, :ke], picked[0, i, : ke + 1])
            if n_acc == ke and req.gen_idx + len(emit) > req.max_new:
                emit = emit[:-1]  # no room for the bonus under the cap
            proposed += ke
            accepted += n_acc
            # commit by swap: the forked block becomes real, the displaced
            # one the next round's spare
            bi = (req.prompt.size + req.gen_idx - 1) // bs
            ids = req.admission.block_ids
            ids[bi], ids[-1] = ids[-1], ids[bi]
            for tok in emit:
                self._push_token(req, int(tok))
                emitted += 1
                if req.admission is None:
                    break  # retired mid-round (EOS or its cap)
        self._bump("spec_rounds")
        if proposed:
            self._bump("spec_proposed", proposed)
        if accepted:
            self._bump("spec_accepted", accepted)
        self.metrics.record_decode(n_tokens=emitted, decode_s=t1 - t0)
        self.metrics.record_iteration(
            active_slots=len(active), total_slots=self.slots_n,
            blocks_in_use=self._kv.blocks_in_use, total_blocks=self._kv.num_blocks,
        )

    def _build_draft(self) -> None:
        """(Re)build the draft's side: a zeroed pool of its own and a host
        pool with the prefix cache off (draft blocks are private to their
        request)."""
        self._draft_pool = None  # free the old pool before the new one is allocated
        self._dkv = PagedKVPool(self._num_blocks, self._block_size, prefix_cache=False)
        self._draft_pool = self._draft_fns.init_pool()

    def _release_draft(self, req: _PagedRequest) -> None:
        if req.draft_admission is not None:
            self._dkv.release(req.draft_admission)
            req.draft_admission = None

    # ------------------------------------------------------------------ #
    # retirement and recovery

    def _push_token(self, req: _PagedRequest, tok: int) -> None:
        req.tokens.append(tok)
        if req.dispatched < len(req.tokens):
            req.dispatched = len(req.tokens)
        if req.on_token is not None:
            try:
                req.on_token(tok)
            except Exception:  # a client callback must not kill the loop
                self.logger.exception("on_token callback raised; ignoring")
        if (self.eos_id is not None and tok == self.eos_id) or req.gen_idx >= req.max_new:
            self._retire(req)

    def _retire(self, req: _PagedRequest) -> None:
        self._slots[req.slot] = None
        self._kv.release(req.admission)
        req.admission = None
        self._release_draft(req)
        # count first: a client woken by its future reads a snapshot that
        # already holds its own request
        self._bump("retired")
        self.metrics.record_request(req.enqueued_at, gen_len=len(req.tokens),
                                    adapter=req.adapter_name)
        if self._kv.prefix_evictions:
            # move the pool's eviction tally into the counters
            self._bump("prefix_evictions", self._kv.prefix_evictions)
            self._kv.prefix_evictions = 0
        if not req.future.done():
            req.future.set_result({"tokens": np.asarray(req.tokens, np.int32),
                                   "gen_len": len(req.tokens)})

    def _evict_poisoned(self, req: _PagedRequest, *, cause: Optional[BaseException],
                        trigger: str) -> None:
        """Fail one request with a diagnosed :class:`PoisonedRequestError`
        and free its reservation; every other slot keeps decoding."""
        err = PoisonedRequestError(
            f"request in slot {req.slot} poisoned the engine at tick {self._tick_no} "
            f"({trigger}) after {req.gen_idx} generated tokens"
        )
        err.__cause__ = cause
        self._slots[req.slot] = None
        self._kv.release(req.admission)
        req.admission = None
        self._release_draft(req)
        self._bump("requests_poisoned")
        self.logger.error("%s", err)
        if not req.future.done():
            req.future.set_exception(err)

    def _die(self, exc: BaseException) -> None:
        """A :meth:`hard_kill` on the scheduler thread: fail every queued and
        in-flight request with ``exc`` and close."""
        self.logger.error("scheduler hard-killed: %s", exc)
        self._bump("replica_down")
        # flags first: once _dead shows, the transfer verbs refuse new work,
        # so none lands in a queue that nobody services
        with self._cond:
            self._die_exc = None
            self._dead = True
            self._closed = True
            self._cond.notify_all()
        self._fail_inflight(exc)

    def _fail_inflight(self, exc: BaseException) -> None:
        """Fail every in-flight request (their pool state is unknown) and
        every queued one rather than retry them into the same error."""
        self._inflight.clear()
        self._carry_tok = None
        with self._cond:
            doomed = [s for s in self._slots if s is not None]
            doomed.extend(self._queue)
            self._queue.clear()
            self._slots = [None] * self.slots_n
            doomed_xfer = list(self._xfer_q)
            self._xfer_q.clear()
        # pending transfers die with the state they index; the disagg
        # coordinator takes the failure and recomputes
        for _verb, _arg, xfut in doomed_xfer:
            if not xfut.done():
                xfut.set_exception(exc)
        if doomed:
            self._bump("failed_inflight", len(doomed))
        for req in doomed:
            if req.admission is not None:
                self._kv.release(req.admission)
                req.admission = None
            self._release_draft(req)
            if not req.future.done():
                req.future.set_exception(exc)

    def _rebuild_and_requeue(self) -> None:
        """Hot restart: a fresh zeroed pool and host pool, every in-flight
        request pushed back onto the queue head (order kept) to be
        replayed; queued requests ride along.  Nothing is compiled."""
        self._inflight.clear()
        self._carry_tok = None
        self._last_dispatch = None
        with self._cond:
            inflight = [s for s in self._slots if s is not None]
            self._slots = [None] * self.slots_n
            for req in reversed(inflight):
                # the reservation indexes the dead pool: drop it without a
                # release; allocator and prefix cache are rebuilt below
                req.admission = None
                req.draft_admission = None
                req.slot = -1
                req.dispatched = req.gen_idx
                self._queue.appendleft(req)
        self._pool = None  # free the old pool before the new one is allocated
        self._kv = PagedKVPool(self._num_blocks, self._block_size, self._prefix_cache)
        self._pool = self._fns.init_pool()
        if self._spec is not None:
            # the draft restarts with the target: requests prefill both again
            self._build_draft()
        if self._watchdog is not None:
            # the replayed ticks start cold: re-enter the warm-up
            self._watchdog.reset()

    def _on_tick_hang(self, step: int, elapsed: float, limit: float) -> None:
        # on the watchdog's thread: record the diagnosis; the scheduler
        # thread raises HungTickError when the tick returns
        with self._cond:
            self._hang_info = (int(step), float(elapsed), float(limit))
        self._bump("serve_watchdog_fires")

    # ------------------------------------------------------------------ #

    def _next_wakeup_locked(self) -> float:
        """Sleep bound while head-of-line blocked: until the nearest queued
        (or drain) deadline, at most 50 ms."""
        now = time.monotonic()
        deadlines = [r.deadline for r in self._queue if r.deadline is not None]
        if self._draining and self._drain_deadline is not None:
            deadlines.append(self._drain_deadline)
        if not deadlines:
            return 0.05
        return min(0.05, max(min(deadlines) - now, 0.001))

    def _idle_locked(self) -> bool:
        return not (self._closed or self._die_exc is not None
                    or self._hang_sec is not None or self._queue or self._xfer_q
                    or any(s is not None for s in self._slots))

    def _loop(self) -> None:
        while True:
            with self._cond:
                idle = self._idle_locked()
                if idle and self.heartbeat_path is None:
                    while self._idle_locked():
                        self._cond.wait()
                    idle = False
                elif idle:
                    # a bounded wait, so an idle healthy replica keeps
                    # beating: stale must mean wedged, not quiet
                    self._cond.wait(timeout=max(self._hb_interval / 2.0, 0.01))
                    idle = self._idle_locked()
                if (not idle and self._closed and not self._queue and not self._xfer_q
                        and all(s is None for s in self._slots)):
                    return
            if idle:
                # the heartbeat's file write runs outside the lock, so a
                # slow disk never stalls submit, health() or the verbs
                self._beat()
                continue
            try:
                did = self.tick()
            except BaseException as exc:  # the supervisor itself failed
                self.logger.exception("scheduler tick failed beyond recovery")
                self._fail_inflight(exc)
                did = True
            with self._cond:
                self._cond.notify_all()  # drain()/close() watchers
                if not did and not self._closed and self._queue:
                    # head-of-line blocked on admission with nothing
                    # decoding: sleep until a deadline can expire or the
                    # state changes (so a waiting request expires at its
                    # deadline, not at the next submit)
                    self._cond.wait(timeout=self._next_wakeup_locked())
