"""Dynamic micro-batching: the serving-side analog of large-batch training.
Host code, carried over unchanged from the JAX package's ``serving/batcher.py``.

Requests land on a queue and a single flush thread groups them into
batches, releasing a batch when either (a) ``max_batch_size`` requests are
waiting — the accelerator-saturation bound — or (b) the OLDEST waiting
request has been queued for ``max_delay_ms`` — the latency bound.  Each
``submit`` returns a ``concurrent.futures.Future`` resolved with that
request's slice of the batch result (or its exception), so callers block
only on their own request.

The batcher is shape-agnostic: it hands the runner a list of
``(payload, meta)`` pairs and the runner (``InferenceEngine._run_batch``)
does the bucketing/padding, so the set of batch shapes the device sees stays
bounded by the engine's bucket grid, not by client batch arithmetic.

Graceful degradation under overload (both off by default):

  - per-request deadlines (``deadline_ms``): a request still queued past
    its deadline resolves with ``TimeoutError`` at collection time instead
    of occupying a flush slot — under backlog, work nobody is waiting for
    anymore stops displacing work somebody is;
  - bounded-queue load shedding (``max_backlog``): beyond the configured
    backlog, ``submit`` fails fast with :class:`OverloadedError` rather
    than growing an unbounded queue of doomed requests.

Both are counted (``timeouts``/``sheds``) and surfaced through optional
callbacks so ``ServingMetrics`` can aggregate them.

The backlog is a ``deque`` under a ``Condition`` rather than a
``queue.Queue``: the backlog-depth check must count LIVE requests only,
which means ``submit`` has to sweep already-expired entries out of the
queue before comparing against ``max_backlog`` — an opaque ``Queue``
cannot be swept, so under sustained overload it would shed live requests
to protect doomed ones.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence, Tuple

__all__ = ["DynamicBatcher", "OverloadedError", "Request"]


class OverloadedError(RuntimeError):
    """Rejected by load shedding: the batcher's backlog is full."""


class Request:
    """One queued payload plus its result future and enqueue timestamp."""

    __slots__ = ("payload", "meta", "future", "enqueued_at", "deadline")

    def __init__(self, payload, meta, deadline: Optional[float] = None):
        self.payload = payload
        self.meta = dict(meta)
        self.future: Future = Future()
        self.enqueued_at = time.monotonic()
        # absolute time.monotonic() deadline; None = wait forever
        self.deadline = deadline


class DynamicBatcher:
    """Queue + flush thread grouping requests into bounded batches.

    ``run_batch(requests)`` is called on the flush thread with 1..max_batch
    requests and must return one result per request (same order); it may
    instead set futures itself and return None.  Exceptions it raises are
    propagated to every future in the batch.
    """

    def __init__(
        self,
        run_batch: Callable[[Sequence[Request]], Optional[List[Any]]],
        max_batch_size: int,
        max_delay_ms: float,
        deadline_ms: Optional[float] = None,
        max_backlog: Optional[int] = None,
        on_timeout: Optional[Callable[[], None]] = None,
        on_shed: Optional[Callable[[], None]] = None,
    ):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
        if max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0, got {max_delay_ms}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if max_backlog is not None and max_backlog < 1:
            raise ValueError(f"max_backlog must be >= 1, got {max_backlog}")
        self._run_batch = run_batch
        self.max_batch_size = int(max_batch_size)
        self.max_delay = max_delay_ms / 1000.0
        self.deadline_ms = deadline_ms
        self.max_backlog = max_backlog
        self.timeouts = 0  # guarded by: self._cond
        self.sheds = 0  # guarded by: self._cond
        self._on_timeout = on_timeout
        self._on_shed = on_shed
        self._queue: "deque[Request]" = deque()  # guarded by: self._cond
        self._closed = False  # guarded by: self._cond
        self._cond = threading.Condition()
        self._thread = threading.Thread(
            target=self._loop, name="serving-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, payload, deadline_ms: Optional[float] = None, **meta) -> Future:
        """Enqueue one request; the future resolves with its result.

        ``deadline_ms`` overrides the batcher-level default; a request
        still queued when its deadline passes resolves with
        ``TimeoutError``.  Raises ``RuntimeError`` once closed and
        :class:`OverloadedError` when the backlog bound rejects the
        request.
        """
        dl = deadline_ms if deadline_ms is not None else self.deadline_ms
        if dl is not None and dl <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {dl}")
        with self._cond:
            # under the same lock close() takes: a submit that wins the
            # race lands before close flips the flag and is drained; one
            # that loses raises — a Future can never be enqueued behind a
            # dead loop to hang forever
            if self._closed:
                raise RuntimeError("batcher is closed")
            # expired entries are dead weight, not backlog: resolve and
            # drop them FIRST so the depth check below counts only live
            # requests (otherwise doomed requests shed live ones)
            self._sweep_expired_locked()
            if (
                self.max_backlog is not None
                and len(self._queue) >= self.max_backlog
            ):
                self.sheds += 1
                if self._on_shed is not None:
                    self._on_shed()
                raise OverloadedError(
                    f"serving backlog full ({self.max_backlog} waiting); "
                    "request shed"
                )
            req = Request(
                payload, meta,
                deadline=(time.monotonic() + dl / 1000.0) if dl else None,
            )
            self._queue.append(req)
            self._cond.notify_all()
        return req.future

    def depth(self) -> int:
        """Requests currently waiting (approximate, by nature)."""
        with self._cond:
            return len(self._queue)

    def close(self) -> None:
        """Drain remaining requests, then stop the flush thread."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()  # wake a blocked collect
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ #

    def _expired(self, req: Request) -> bool:  # guarded by: self._cond
        """Resolve an over-deadline request with ``TimeoutError``; True if
        it expired (the caller must not batch it)."""
        if req.deadline is None or time.monotonic() < req.deadline:
            return False
        self.timeouts += 1
        if self._on_timeout is not None:
            self._on_timeout()
        if not req.future.done():
            req.future.set_exception(
                TimeoutError(
                    "serving request exceeded its deadline after "
                    f"{time.monotonic() - req.enqueued_at:.3f}s in queue"
                )
            )
        return True

    def _sweep_expired_locked(self) -> None:
        """Resolve + remove every over-deadline request (cond held)."""
        now = time.monotonic()
        if any(r.deadline is not None and now >= r.deadline for r in self._queue):
            self._queue = deque(r for r in self._queue if not self._expired(r))

    def _collect(self) -> Tuple[List[Request], bool]:
        """Block for the first request, then gather until a flush trigger.

        Returns ``(batch, stop)``; stop means close() was seen and the
        queue is drained (any gathered batch is still flushed first —
        close() drains).  Requests past their deadline are expired here
        instead of batched.
        """
        with self._cond:
            while True:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue:
                    return [], True  # closed and fully drained
                first = self._queue.popleft()
                if not self._expired(first):
                    break
            batch = [first]
            # a backlog that built while the previous batch ran must flush
            # at full width immediately — grab whatever already waits
            # before ever consulting the delay deadline (which the oldest
            # request may well have passed by now; timing out to a
            # singleton batch here would serialize the whole backlog one
            # request at a time)
            while len(batch) < self.max_batch_size and self._queue:
                req = self._queue.popleft()
                if not self._expired(req):
                    batch.append(req)
            deadline = first.enqueued_at + self.max_delay
            while len(batch) < self.max_batch_size and not self._closed:
                if self._queue:
                    req = self._queue.popleft()
                    if not self._expired(req):
                        batch.append(req)
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(timeout=remaining):
                    break
            return batch, False

    def _flush(self, batch: List[Request]) -> None:
        try:
            results = self._run_batch(batch)
        except BaseException as exc:  # propagate, don't kill the thread
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(exc)
            return
        if results is None:
            return  # runner resolved the futures itself
        if len(results) != len(batch):
            exc = RuntimeError(
                f"run_batch returned {len(results)} results for "
                f"{len(batch)} requests"
            )
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(exc)
            return
        for req, res in zip(batch, results):
            if not req.future.done():
                req.future.set_result(res)

    def _loop(self) -> None:
        # drain-on-close falls out of _collect: once closed it keeps
        # returning batches (without the timed fill) until the queue is
        # empty, and only then reports stop
        while True:
            batch, stop = self._collect()
            if batch:
                self._flush(batch)
            if stop:
                return
