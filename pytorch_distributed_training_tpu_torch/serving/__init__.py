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
    scheduler's occupancy, utilisation and tick times; per-replica names
    and the fleet's aggregate.
  - :mod:`.router`     — :class:`FleetRouter`: health-gated, prefix-affine
    placement over N replicas, failover with token-identical replay,
    hedging, fleet backpressure, elastic membership.
  - :mod:`.fleet`      — :class:`ServingFleet`: N replicas over one
    resolved model, concurrent drain, SIGTERM, aggregate health and
    metrics, add/remove of replicas.
  - :mod:`.workload`   — :class:`TraceGenerator`: seeded diurnal and
    flash-crowd request traces.
  - :mod:`.autoscaler` — :class:`FleetAutoscaler`: replica scaling on
    backlog, occupancy and p99; grows from the one resolution, shrinks
    only through drain.
  - :mod:`.kv_transfer` — content-addressed, CRC-32-sealed paged-KV
    blocks between replicas (host-staged).
  - :mod:`.disagg`     — :class:`DisaggFleet`: prefill/decode
    disaggregation over a :class:`FleetCacheDirectory`, with a
    degrade-to-recompute ladder.

``python -m pytorch_distributed_training_tpu_torch.serving --config
pytorch_distributed_training_tpu_torch/configs/serve-lm-1024.yml`` (or
``serve-lm-1024-sched.yml``, the scheduler) serves a synthetic open-loop
stream (``__main__``).
"""
from .autoscaler import FleetAutoscaler
from .batcher import DynamicBatcher, OverloadedError, Request
from .decode import build_generate_fn, build_paged_fns
from .disagg import DisaggFleet, FleetCacheDirectory
from .engine import InferenceEngine, ResolvedModel
from .fleet import ServingFleet
from .kv_pool import BlockAllocator, PagedKVPool
from .kv_transfer import BlockPayload, payload_checksum, verify_payload
from .lora import LoraRegistry
from .metrics import ServingMetrics, aggregate_snapshots
from .resilience import EngineRestartError, HungTickError, PoisonedRequestError, ServingSupervisor
from .router import FleetDownError, FleetRouter, ReplicaDownError
from .scheduler import ContinuousScheduler
from .speculative import SpeculativeSpec
from .workload import TraceGenerator, TraceRequest

__all__ = [
    "BlockAllocator",
    "BlockPayload",
    "ContinuousScheduler",
    "DisaggFleet",
    "DynamicBatcher",
    "EngineRestartError",
    "FleetAutoscaler",
    "FleetCacheDirectory",
    "FleetDownError",
    "FleetRouter",
    "HungTickError",
    "InferenceEngine",
    "LoraRegistry",
    "OverloadedError",
    "PagedKVPool",
    "PoisonedRequestError",
    "ReplicaDownError",
    "Request",
    "ResolvedModel",
    "ServingFleet",
    "ServingMetrics",
    "ServingSupervisor",
    "SpeculativeSpec",
    "TraceGenerator",
    "TraceRequest",
    "aggregate_snapshots",
    "build_generate_fn",
    "build_paged_fns",
    "payload_checksum",
    "verify_payload",
]
