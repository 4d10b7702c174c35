"""Process decode workers with a shared-memory batch handoff (port of
``data/worker_pool.py``).

The generic way to scale a Python-side dataset (the PIL path, a custom
``__getitem__``) over cores, as the reference's DataLoader worker
processes do:

- ``spawn`` workers.  They import this package, and so torch, but never
  touch CUDA; they fetch samples with :func:`.datasets.fetch_sample`.
- One shared-memory slab of ``n_slots`` batch slots plus an int64 label
  slab (a label a sample, or an array of ``label_shape``: the LM's next
  tokens): a worker writes its batch straight into the slot it was given,
  and the queues carry only ``(gen, seq, slot, ...)`` tuples, never
  pixels.
- A reorder buffer keyed by sequence number keeps batch order; the
  per-sample augmentation streams make a batch's bytes independent of the
  worker that built it.
- A generation counter: a new epoch drains the tasks an abandoned
  iterator left in flight, so they cannot write into its slots.
- One pair of queues a worker.  A worker killed inside a queue operation
  can leave that queue's lock held, so a dead worker's queues are
  abandoned whole; the pool keeps a ledger of what each worker owes
  (submitted, not yet collected), resubmits it to the respawned worker
  and goes on without dropping or duplicating a batch.  Each respawn
  counts ``worker_respawns`` on the process registry.

Every wait has a timeout: result waits of 10 ms between sweeps of all
the result queues, a dead-worker check every ``_poll_seconds``, a stall
limit, and bounded joins at :meth:`ProcessLoaderPool.close`.
"""
from __future__ import annotations

import atexit
import multiprocessing as mp
import queue
import time
import traceback
from collections import deque
from multiprocessing import shared_memory
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..telemetry.registry import get_registry
from .datasets import fetch_sample

__all__ = ["ProcessLoaderPool"]

_WAIT_SLICE_S = 0.01  # one blocking wait on a result queue between sweeps


def _pool_worker_main(dataset, seed: int, shm_name: str, lshm_name: str, n_slots: int,
                      batch_size: int, sample_shape: tuple, sample_dtype: str,
                      label_shape: tuple, task_q, result_q):
    """Worker loop: fetch each task's samples into its shared-memory slot."""
    shm = shared_memory.SharedMemory(name=shm_name)
    lshm = shared_memory.SharedMemory(name=lshm_name)
    try:
        slots = np.ndarray((n_slots, batch_size) + sample_shape, dtype=np.dtype(sample_dtype),
                           buffer=shm.buf)
        labels = np.ndarray((n_slots, batch_size) + label_shape, dtype=np.int64,
                            buffer=lshm.buf)
        while True:
            task = task_q.get()
            if task is None:
                return
            gen, seq, slot, epoch, indices = task
            try:
                for row, idx in enumerate(indices):
                    img, lab = fetch_sample(dataset, int(idx), seed, epoch)
                    slots[slot, row] = img
                    labels[slot, row] = lab
                result_q.put((gen, seq, slot, None))
            except Exception:
                result_q.put((gen, seq, slot, traceback.format_exc()))
    finally:
        shm.close()
        lshm.close()


class ProcessLoaderPool:
    """Persistent pool of decode worker processes and its shared-memory slots."""

    def __init__(self, dataset, batch_size: int, sample_shape: Sequence[int],
                 sample_dtype: np.dtype, num_workers: int, seed: int,
                 n_slots: Optional[int] = None, max_respawns: int = 8,
                 stall_timeout: float = 60.0, label_shape: Sequence[int] = ()):
        if num_workers < 1:
            raise ValueError("ProcessLoaderPool requires num_workers >= 1")
        if stall_timeout <= 0:
            raise ValueError(f"stall_timeout must be > 0, got {stall_timeout}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.sample_shape = tuple(int(s) for s in sample_shape)
        self.sample_dtype = np.dtype(sample_dtype)
        self.label_shape = tuple(int(s) for s in label_shape)
        self.num_workers = int(num_workers)
        # every worker busy while finished batches wait in the reorder buffer
        self.n_slots = int(n_slots) if n_slots else self.num_workers + 2
        self.seed = int(seed)
        self._gen = 0
        # submitted and not yet collected, counted on the pool (not in an
        # epoch generator's finally, which an abandoned iterator never runs)
        self._outstanding = 0
        self._gauge = get_registry().gauge("data_pool_outstanding")
        self._closed = False
        # (gen, seq) -> (wid, task), every task not yet collected: the ledger
        self._inflight = {}
        self.max_respawns = int(max_respawns)
        self.respawns = 0
        self._poll_seconds = 1.0
        self._stall_timeout = float(stall_timeout)

        slot_bytes = (self.batch_size * int(np.prod(self.sample_shape))
                      * self.sample_dtype.itemsize)
        self._shm = shared_memory.SharedMemory(create=True,
                                               size=max(1, self.n_slots * slot_bytes))
        self._lshm = shared_memory.SharedMemory(
            create=True, size=self.n_slots * self.batch_size * int(np.prod(self.label_shape)) * 8)
        self._slots = np.ndarray((self.n_slots, self.batch_size) + self.sample_shape,
                                 dtype=self.sample_dtype, buffer=self._shm.buf)
        self._labels = np.ndarray((self.n_slots, self.batch_size) + self.label_shape,
                                  dtype=np.int64, buffer=self._lshm.buf)
        self._ctx = mp.get_context("spawn")
        self._task_qs = [self._ctx.Queue() for _ in range(self.num_workers)]
        self._result_qs = [self._ctx.Queue() for _ in range(self.num_workers)]
        self._procs = [self._spawn_worker(i) for i in range(self.num_workers)]
        atexit.register(self.close)

    def _spawn_worker(self, wid: int):
        p = self._ctx.Process(
            target=_pool_worker_main,
            args=(self.dataset, self.seed, self._shm.name, self._lshm.name, self.n_slots,
                  self.batch_size, self.sample_shape, self.sample_dtype.str,
                  self.label_shape, self._task_qs[wid], self._result_qs[wid]),
            daemon=True,
        )
        p.start()
        return p

    # ------------------------------------------------------------------ epoch
    def run_epoch(self, batches: List[np.ndarray], epoch: int,
                  postprocess) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Stream ``batches`` (index arrays) through the pool, in order.

        ``postprocess(slot_view, label_view) -> (imgs, labels)`` turns a
        filled slot into arrays the caller owns; the slot is reused as soon
        as it returns.
        """
        # one epoch is live at a time: whatever is still uncollected belongs
        # to an abandoned one and may be writing into a slot
        while self._outstanding > 0:
            self._collect_one()
        self._gen += 1
        gen = self._gen
        pending = deque(enumerate(batches))
        free = list(range(self.n_slots))
        done = {}  # seq -> slot
        next_yield = 0
        while next_yield < len(batches):
            while free and pending:
                seq, idxs = pending.popleft()
                slot = free.pop()
                # batch seq always goes to worker seq % num_workers, and a
                # respawned worker takes its predecessor's place
                wid = seq % self.num_workers
                task = (gen, seq, slot, int(epoch), np.asarray(idxs))
                self._inflight[(gen, seq)] = (wid, task)
                self._task_qs[wid].put(task)
                self._outstanding += 1
                self._gauge.set(self._outstanding)
            if next_yield in done:
                slot = done.pop(next_yield)
                out = postprocess(self._slots[slot], self._labels[slot])
                free.append(slot)
                next_yield += 1
                yield out
                continue
            r = self._collect_one(prefer=next_yield % self.num_workers)
            if r[0] != gen:  # a result of an abandoned epoch
                continue
            _, seq, slot, err = r
            if err is not None:
                raise RuntimeError(f"decode worker failed:\n{err}")
            done[seq] = slot

    def _collect_one(self, prefer: int = 0):
        """The next result of any worker.  Every result queue is swept
        without waiting, then the queue of worker ``prefer`` (the one owing
        the batch due next) waits a slice; each ``_poll_seconds`` without a
        result, dead workers are respawned, and past the stall limit the
        pool raises.  (The JAX pool waits poll/n on each queue in turn, so
        a ready result could sit behind empty queues for up to that long.)"""
        waited = 0.0
        last = time.monotonic()
        while True:
            r = None
            for result_q in self._result_qs:
                try:
                    r = result_q.get_nowait()
                    break
                except queue.Empty:
                    continue
            if r is None:
                try:
                    r = self._result_qs[prefer].get(timeout=_WAIT_SLICE_S)
                except queue.Empty:
                    pass
            if r is None:
                now = time.monotonic()
                if now - last < self._poll_seconds:
                    continue
                waited += now - last
                last = now
                if self._reap_and_respawn():
                    waited = 0.0
                elif waited >= self._stall_timeout:
                    raise RuntimeError(
                        f"loader pool stalled: no result for {waited:.0f}s with "
                        f"{self._outstanding} task(s) outstanding and all "
                        f"{self.num_workers} worker(s) alive") from None
                continue
            self._outstanding -= 1
            self._gauge.set(self._outstanding)
            self._inflight.pop((r[0], r[1]), None)
            return r

    def _reap_and_respawn(self) -> bool:
        """Respawn dead workers with fresh queues, resubmitting every task
        each still owed (a result it flushed before dying and nobody
        collected is done again: the same bytes).  True if one was
        respawned."""
        respawned = False
        for wid, p in enumerate(self._procs):
            if p.is_alive():
                continue
            if self.respawns >= self.max_respawns:
                raise RuntimeError(
                    f"decode worker {wid} (pid {p.pid}) died with exitcode {p.exitcode} and "
                    f"the respawn budget ({self.max_respawns}) is exhausted")
            for old_q in (self._task_qs[wid], self._result_qs[wid]):
                old_q.cancel_join_thread()
                old_q.close()
            self._task_qs[wid] = self._ctx.Queue()
            self._result_qs[wid] = self._ctx.Queue()
            for owner, task in self._inflight.values():
                if owner == wid:
                    self._task_qs[wid].put(task)
            self.respawns += 1
            self._procs[wid] = self._spawn_worker(wid)
            respawned = True
            get_registry().counter("worker_respawns").inc()
        return respawned

    # ------------------------------------------------------------------ close
    def close(self) -> None:
        """Stop the workers (sentinel, then terminate, then kill, each join
        bounded) and unlink the shared memory."""
        if self._closed:
            return
        self._closed = True
        try:
            for q in self._task_qs:
                try:
                    q.put(None)
                except (OSError, ValueError):  # a queue already closed
                    pass
            for p in self._procs:
                p.join(timeout=2.0)
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
            for p in self._procs:
                if p.is_alive():
                    p.join(timeout=1.0)
            for p in self._procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=1.0)
            for q in self._task_qs + self._result_qs:
                q.cancel_join_thread()
                q.close()
        finally:
            del self._slots, self._labels
            for shm in (self._shm, self._lshm):
                shm.close()
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass
            atexit.unregister(self.close)
