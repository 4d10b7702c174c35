"""Device-side input double-buffering (port of ``data/prefetch.py``).

:func:`device_prefetch` keeps ``depth`` batches' host-to-device copies
issued ahead of the consumer, the JAX contract (``prefetch.py:19-45``).

:class:`PinnedStager` is the runner's ``put`` on the card, in place of a
``.pin_memory()`` a batch: it copies each host batch into a ring of
``depth + 1`` page-locked buffers, reused (a buffer is written again only
once the event of its last copy has passed), issues the host-to-device
copy on a side stream and records an event there.  :meth:`PinnedStager.take`
makes the consuming stream wait on that event and marks the batch's
tensors as used on it (``record_stream``), so the caching allocator does
not hand their memory to the side stream while the step still reads it.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterator, Tuple

import numpy as np

__all__ = ["PinnedStager", "device_prefetch"]


def device_prefetch(host_iter: Iterator[Tuple], put: Callable[..., Tuple],
                    depth: int = 2) -> Iterator[Tuple]:
    """Yield ``put(*batch)`` for each host batch, with ``depth`` puts issued
    ahead of the one yielded (2: double buffering).  ``put`` must not wait
    for its copy to end."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    buf: deque = deque()
    try:
        while len(buf) < depth:
            buf.append(put(*next(host_iter)))
    except StopIteration:
        pass
    while buf:
        try:
            buf.append(put(*next(host_iter)))
        except StopIteration:
            pass
        yield buf.popleft()


class PinnedStager:
    """``put(*arrays) -> staged`` and ``take(staged) -> tensors`` on one card."""

    def __init__(self, device, depth: int = 2):
        import torch

        self.device = torch.device(device)
        self._stream = torch.cuda.Stream(self.device)
        # per slot: (pinned host tensors, event of their last copy) or None
        self._ring = [None] * (depth + 1)
        self._next = 0

    def put(self, *arrays: np.ndarray):
        import torch

        i = self._next
        self._next = (i + 1) % len(self._ring)
        pinned, done = self._ring[i] or ((), None)
        if done is not None:
            done.synchronize()  # the last copy out of this buffer has ended
        if [(p.numpy().shape, p.numpy().dtype) for p in pinned] != [
                (a.shape, a.dtype) for a in arrays]:
            pinned = tuple(torch.from_numpy(np.empty(a.shape, a.dtype)).pin_memory()
                           for a in arrays)
        for p, a in zip(pinned, arrays):
            np.copyto(p.numpy(), a, casting="no")
        with torch.cuda.stream(self._stream):
            tensors = tuple(p.to(self.device, non_blocking=True) for p in pinned)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._ring[i] = (pinned, event)
        return tensors, event

    def take(self, staged) -> Tuple:
        import torch

        tensors, event = staged
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in tensors:
            t.record_stream(stream)
        return tensors
