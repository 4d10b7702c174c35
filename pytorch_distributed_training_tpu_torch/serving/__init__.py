"""LM serving on the card: the batcher and continuous-scheduler paths of
the JAX package's serving/.

  - :mod:`.engine`     — :class:`InferenceEngine`: weights on the device
    (random, or from the port's training checkpoint), bucketed calls,
    phase-timed prefill/decode; the batcher or the scheduler behind it.
  - :mod:`.batcher`    — :class:`DynamicBatcher`: request queue with
    max-batch-size / max-delay flush and per-request futures.
  - :mod:`.scheduler`  — :class:`ContinuousScheduler`: iteration-level
    batching over the paged KV pool, the async decode pipeline, replay.
  - :mod:`.kv_pool`    — :class:`PagedKVPool`: block allocator, prefix
    cache, admission control (host bookkeeping).
  - :mod:`.resilience` — :class:`ServingSupervisor`: poison bisect, hot
    restart, the restart budget.
  - :mod:`.decode`     — generation over the contiguous cache and the paged
    calls, and the sampling rule both share.
  - :mod:`.lora`       — :class:`LoraRegistry`: multi-LoRA adapters grafted
    onto one base model.
  - :mod:`.speculative` — :class:`SpeculativeSpec` and the accept rules.
  - :mod:`.metrics`    — p50/p99 latency, queue depth, throughput, the
    scheduler's occupancy, utilisation and tick times.

``python -m pytorch_distributed_training_tpu_torch.serving --config
pytorch_distributed_training_tpu_torch/configs/serve-lm-1024.yml`` (or
``serve-lm-1024-sched.yml``, the scheduler) serves a synthetic open-loop
stream (``__main__``).
"""
from .batcher import DynamicBatcher, OverloadedError, Request
from .decode import build_generate_fn, build_paged_fns
from .engine import InferenceEngine
from .kv_pool import PagedKVPool
from .lora import LoraRegistry
from .metrics import ServingMetrics
from .resilience import EngineRestartError, HungTickError, PoisonedRequestError, ServingSupervisor
from .scheduler import ContinuousScheduler
from .speculative import SpeculativeSpec

__all__ = [
    "ContinuousScheduler",
    "DynamicBatcher",
    "EngineRestartError",
    "HungTickError",
    "InferenceEngine",
    "LoraRegistry",
    "OverloadedError",
    "PagedKVPool",
    "PoisonedRequestError",
    "Request",
    "ServingMetrics",
    "ServingSupervisor",
    "SpeculativeSpec",
    "build_generate_fn",
    "build_paged_fns",
]
