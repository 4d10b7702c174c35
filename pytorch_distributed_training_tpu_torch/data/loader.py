"""The host batch loader and the iteration-based stream over it (port of
``data/loader.py``).

:class:`DataLoader` cuts the sampler's local indices into batches and
assembles them through one of three backends (``worker_mode``):

- ``"native"``: crop boxes and flips are sampled on the host from the
  per-sample streams, then one call into the native decoder
  (:mod:`..native`) decodes, crops, resizes, flips and normalises the
  whole batch on ``num_workers`` C++ threads, the GIL released.  A row
  libjpeg refuses (not a JPEG, CMYK, corrupt) is redone in PIL with the
  params it was given, as the JAX loader does;
- ``"thread"``: samples fetched in a pool of ``num_workers`` threads (none
  at 0), for datasets whose work releases the GIL;
- ``"process"``: ``num_workers`` spawned processes fill shared-memory slots
  (:mod:`.worker_pool`), for pure-Python datasets.

``"auto"`` picks ``native`` for a dataset with ``crop_task`` (ImageFolder)
and ``thread`` otherwise.  Unlike the JAX loader's ``auto``, which drops
to ``thread`` when the native library is missing, the port's builds the
library at construction and raises if it does not build.

``native`` and ``thread`` assemble in a producer thread ahead of the
consumer, through a bounded queue of ``prefetch_batches``.
``output_dtype`` ``"float32"`` yields normalised batches;
``"uint8"`` yields raw pixels for the card to normalise
(``engine.steps`` ``input_norm``), a quarter of the bytes.  With
``drop_last`` only full batches are yielded; without it the last partial
batch wraps around to full size (JAX ``data/loader.py:132-144``).

:meth:`DataLoader.skip_next` drops the first batches of the next epoch
at the index level (nothing is decoded or dispatched to a worker), which
checkpoint resume needs (JAX ``data/loader.py:108-124``).
:func:`make_iter_dataloader` turns the epoch loader into the endless
per-iteration stream the trainer draws from, advancing the sampler's
epoch between passes and starting at a resume position
(``utils/__init__.py:92-165``).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .datasets import fetch_sample, sample_rng

__all__ = ["DataLoader", "make_iter_dataloader"]

_MODES = ("auto", "native", "thread", "process")


class DataLoader:
    def __init__(self, dataset, batch_size: int, sampler, drop_last: bool = False, *,
                 num_workers: int = 0, prefetch_batches: int = 2, worker_mode: str = "auto",
                 dct_denom: int = 1, output_dtype: str = "float32"):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if worker_mode not in _MODES:
            raise ValueError(f"worker_mode must be one of {_MODES}, got {worker_mode!r}")
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be 'float32' or 'uint8', got {output_dtype!r}")
        if output_dtype == "uint8" and getattr(dataset, "norm_mean", None) is None:
            raise ValueError("output_dtype='uint8' requires a dataset with uint8 samples and "
                             "norm_mean/norm_std (device-side normalization constants)")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.sampler = sampler
        self.drop_last = bool(drop_last)
        self.num_workers = int(num_workers)
        self.prefetch_batches = max(1, int(prefetch_batches))
        self.dct_denom = int(dct_denom)
        self.output_dtype = output_dtype
        self.seed = int(getattr(sampler, "seed", 0))
        self._pool = None  # the ProcessLoaderPool, made at the first process epoch
        self._skip_next = 0  # batches the next epoch drops (skip_next)
        if worker_mode == "auto":
            worker_mode = "native" if hasattr(dataset, "crop_task") else "thread"
        if worker_mode == "native":
            if not hasattr(dataset, "crop_task"):
                raise ValueError("worker_mode='native' needs a dataset with crop_task "
                                 "(ImageFolder)")
            from .. import native

            native.library()  # raises with the compiler's output if it does not build
        self.worker_mode = worker_mode

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def skip_next(self, n_batches: int) -> None:
        """Drop the first ``n_batches`` of the next epoch only, by index.  A
        negative count raises here; a count past the epoch's end is
        clamped, so that epoch yields nothing (a resume saved at an epoch
        boundary)."""
        n = int(n_batches)
        if n < 0:
            raise ValueError(f"skip_next: n_batches must be >= 0, got {n}")
        self._skip_next = n

    def close(self) -> None:
        """Stop the worker processes (a no-op for the other modes)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def _batch_indices(self) -> List[np.ndarray]:
        idx = self.sampler.local_indices()
        batches = []
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start : start + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    break
                # wrap-pad the tail, tiling if the shard is smaller than a batch
                chunk = np.resize(np.concatenate([chunk, idx]), self.batch_size)
            batches.append(chunk)
        return batches

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    # ----------------------------------------------------- batch assembly
    def _normalize_u8(self, imgs: np.ndarray) -> np.ndarray:
        from ..native import normalize_batch

        mean = getattr(self.dataset, "norm_mean", None)
        std = getattr(self.dataset, "norm_std", None)
        if mean is not None and std is not None:
            return normalize_batch(imgs, mean, std)
        return imgs.astype(np.float32) / 255.0

    def _assemble(self, indices: np.ndarray, epoch: int, pool: Optional[ThreadPoolExecutor]):
        """Thread path: fetch each sample, then stack (and normalise uint8)."""
        def fetch(i):
            return fetch_sample(self.dataset, int(i), self.seed, epoch)

        if pool is not None:
            samples = list(pool.map(fetch, indices))
        else:
            samples = [fetch(i) for i in indices]
        imgs = np.stack([s[0] for s in samples])
        if imgs.dtype == np.uint8 and self.output_dtype == "float32":
            imgs = self._normalize_u8(imgs)
        labels = np.asarray([s[1] for s in samples], dtype=np.int64)
        return imgs, labels

    def _assemble_native(self, indices: np.ndarray, epoch: int):
        """Native path: params sampled on the host, the batch decoded in C++."""
        from ..native import decode_jpeg_batch, normalize_batch

        ds = self.dataset
        tasks = [ds.crop_task(int(i), sample_rng(self.seed, epoch, int(i))) for i in indices]
        labels = np.asarray([t[1] for t in tasks], dtype=np.int64)
        boxes = np.asarray([t[2][:4] for t in tasks], dtype=np.float64)
        flips = np.asarray([t[2][4] for t in tasks], dtype=np.uint8)
        raw_u8 = self.output_dtype == "uint8"
        out, status = decode_jpeg_batch(
            [t[0] for t in tasks], boxes, flips, ds.image_size,
            None if raw_u8 else ds.norm_mean, None if raw_u8 else ds.norm_std,
            dct_denom=self.dct_denom, n_threads=max(1, self.num_workers))
        # rows libjpeg refused: PIL with the same params, so the bytes do not
        # depend on which decoder took the row
        for r in np.nonzero(status)[0]:
            arr = ds.decode_with_params(int(indices[r]), tasks[r][2])
            out[r] = arr if raw_u8 else normalize_batch(arr[None], ds.norm_mean,
                                                        ds.norm_std)[0]
        return out, labels

    # ------------------------------------------------------------ iteration
    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        batches = self._batch_indices()
        if self._skip_next:
            batches = batches[min(self._skip_next, len(batches)):]
            self._skip_next = 0
        if not batches:
            return iter(())
        epoch = int(getattr(self.sampler, "epoch", 0))
        if self.worker_mode == "process":
            return self._iter_process(batches, epoch)
        return self._iter_queued(batches, epoch)

    def _iter_process(self, batches, epoch: int):
        if self._pool is None:
            from .worker_pool import ProcessLoaderPool

            probe_img, probe_label = fetch_sample(self.dataset, int(batches[0][0]), self.seed,
                                                  epoch)
            self._pool = ProcessLoaderPool(
                self.dataset, batch_size=self.batch_size, sample_shape=probe_img.shape,
                sample_dtype=probe_img.dtype, num_workers=max(1, self.num_workers),
                seed=self.seed, label_shape=np.shape(probe_label))

        def postprocess(slot_view: np.ndarray, label_view: np.ndarray):
            if slot_view.dtype == np.uint8 and self.output_dtype == "float32":
                imgs = self._normalize_u8(slot_view)  # a fresh array
            else:
                imgs = np.array(slot_view)  # a copy: the slot is reused next
            return imgs, np.array(label_view)

        return self._pool.run_epoch(batches, epoch, postprocess)

    def _iter_queued(self, batches, epoch: int):
        """A producer thread assembles batches ahead through a bounded queue."""
        use_threads = self.worker_mode == "thread" and self.num_workers > 0
        pool = ThreadPoolExecutor(self.num_workers) if use_threads else None
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    item = (self._assemble_native(b, epoch) if self.worker_mode == "native"
                            else self._assemble(b, epoch, pool))
                    if not put(item):
                        return
                put(None)
            except BaseException as e:  # handed to the consumer, which raises it
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()  # the producer's puts give up within 0.1 s
            t.join(timeout=5.0)
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)


def make_iter_dataloader(loader: DataLoader, start_iter: int = 0,
                         start_epoch: Optional[int] = None,
                         skip_batches: Optional[int] = None
                         ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless batches, epoch after epoch, from a resume position: epoch
    ``start_iter // len(loader)`` less its first ``start_iter % len(loader)``
    batches, or the explicit ``(start_epoch, skip_batches)`` of a
    checkpoint's sidecar (both or neither), which win.  Checked here, at
    the call, not at the first ``next()``."""
    if len(loader) == 0:
        raise ValueError(
            "loader yields no batches (dataset shard smaller than batch size "
            "with drop_last?) — the iteration-based loop would spin forever"
        )
    if (start_epoch is None) != (skip_batches is None):
        raise ValueError("start_epoch and skip_batches must be given together "
                         f"(got start_epoch={start_epoch}, skip_batches={skip_batches})")
    if start_epoch is not None:
        epoch, skip = int(start_epoch), int(skip_batches)
        if epoch < 0 or skip < 0:
            raise ValueError(f"start_epoch/skip_batches must be >= 0, got "
                             f"{start_epoch}/{skip_batches}")
    else:
        epoch, skip = divmod(int(start_iter), len(loader))
    if skip:
        loader.skip_next(skip)

    def stream(epoch):
        while True:
            loader.set_epoch(epoch)
            yield from loader
            epoch += 1

    return stream(epoch)
