"""Multiprocess log aggregation.

Re-provides ``dl_lib.logger.MultiProcessLoggerListener`` (reference import at
train_distributed.py:28; contract pinned by :56-62, :72, :86, :127, :158):
a listener owning a queue that worker processes write ``logging`` records to
via ``QueueHandler``; the listener drains the queue into the real handlers
(file + console built by a ``logger_constructor``).

Port of the JAX package's ``logger/__init__.py``, unchanged: the serving
CLI is one process, so the listener is an in-process ``QueueListener``
thread; the queue is a ``multiprocessing`` queue so that helper processes
can log through the same funnel.
"""
from __future__ import annotations

import logging
import logging.handlers
import multiprocessing as mp
from typing import Callable

__all__ = ["MultiProcessLoggerListener"]


class MultiProcessLoggerListener:
    """Serializes log records from all workers into one sink.

    Args:
      logger_constructor: zero-arg callable returning the sink ``Logger``
        (the reference passes ``partial(get_train_logger, logdir, filename)``,
        train_distributed.py:56-61).
      start_method: multiprocessing start method for the queue's context
        (reference uses ``"spawn"``, :35).
    """

    def __init__(self, logger_constructor: Callable[[], logging.Logger], start_method: str = "spawn"):
        ctx = mp.get_context(start_method)
        self.queue = ctx.Queue(-1)
        self._logger = logger_constructor()
        self._listener = logging.handlers.QueueListener(
            self.queue, *self._logger.handlers, respect_handler_level=True
        )
        self._listener.start()
        self._stopped = False

    def get_logger(self) -> logging.Logger:
        return self._logger

    def stop(self) -> None:
        """Drain and stop (reference: the ``finally`` at train_distributed.py:84-86)."""
        if not self._stopped:
            self._stopped = True
            self._listener.stop()
            self.queue.close()
            self.queue.join_thread()
