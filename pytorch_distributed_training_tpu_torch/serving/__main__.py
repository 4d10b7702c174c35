"""Synthetic open-loop serving demo / smoke entry point.

    python -m pytorch_distributed_training_tpu_torch.serving \
        --config pytorch_distributed_training_tpu_torch/configs/serve-lm-1024.yml \
        [--requests 32] [--device cuda|cpu] [--log-dir DIR]

Builds an :class:`.engine.InferenceEngine` from the config on ``--device``
(default ``cuda``; with no card it fails rather than run on the CPU): the
batcher, or the continuous scheduler over the paged KV pool with
``serving.scheduler.enabled``
(``configs/serve-lm-1024-sched.yml``), from ``serving.checkpoint`` when it
is set.  SIGTERM drains the engine (JAX ``__main__.py:59-63``).  Fires
``--requests`` random prompts of lengths within the seq buckets at it (a
classifier, e.g. ``config/serve-resnet50.yml``: random uint8 images of
``dataset.image_size``, float32 with ``serving.normalize: false``; JAX
``__main__.py:36-39``), waits on every future, and logs p50/p99 latency,
queue depth and tokens/s (images/s).
The final line is one JSON object, ``{"serving": snapshot}``, whose
snapshot carries each hand-written kernel's launch count.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
from functools import partial

import numpy as np

from ..config_parsing import get_serve_cfg, get_train_logger
from ..logger import MultiProcessLoggerListener
from .engine import InferenceEngine


def _synthetic_payloads(engine: InferenceEngine, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if engine.is_lm:
        for _ in range(n):
            ln = int(rng.integers(1, engine.seq_buckets[-1] + 1))
            yield rng.integers(0, engine.vocab_size, ln).astype(np.int32)
        return
    size = engine.image_size
    for _ in range(n):
        img = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
        yield img if engine._input_dtype == np.uint8 else img.astype(np.float32) / 255.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_training_tpu_torch.serving",
        description="serve a TransformerLM or a classifier against a synthetic request stream",
    )
    parser.add_argument("--config", required=True, help="serve-*.yml path")
    parser.add_argument("--requests", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument(
        "--log-dir", default=os.path.join(tempfile.gettempdir(), "pdt-serve-torch")
    )
    args = parser.parse_args(argv)

    cfg = get_serve_cfg(args.config)
    listener = MultiProcessLoggerListener(
        partial(get_train_logger, args.log_dir, "serve"), "spawn"
    )
    logger = listener.get_logger()
    previous = signal.getsignal(signal.SIGTERM)
    try:
        with InferenceEngine.from_config(cfg, device=args.device, logger=logger) as engine:
            # SIGTERM -> a graceful drain; signal handlers install from the
            # main thread, so here
            engine.install_drain_handler()
            logger.info(
                "engine up on %s: task=%s batch_buckets=%s seq_buckets=%s path=%s modes=%s",
                engine.device, "lm" if engine.is_lm else "image", engine.batch_buckets,
                engine.seq_buckets if engine.is_lm else "-",
                "scheduler" if engine.scheduler is not None else "batcher",
                ",".join(m for m, on in engine.serving_modes.items() if on) or "plain",
            )
            futures = [engine.submit(p)
                       for p in _synthetic_payloads(engine, args.requests, args.seed)]
            for fut in futures:
                fut.result(timeout=300)
            engine.metrics.log_summary(logger)
            snap = engine.snapshot()
        logger.info("served %d requests on %s", args.requests, engine.device)
        print(json.dumps({"serving": snap}))
        return 0
    finally:
        signal.signal(signal.SIGTERM, previous)
        listener.stop()


if __name__ == "__main__":
    sys.exit(main())
