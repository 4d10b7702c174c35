"""LM serving on the card: the batcher path of the JAX package's serving/.

  - :mod:`.engine`   — :class:`InferenceEngine`: weights on the device,
    bucketed batches, phase-timed prefill/decode.
  - :mod:`.batcher`  — :class:`DynamicBatcher`: request queue with
    max-batch-size / max-delay flush and per-request futures.
  - :mod:`.decode`   — autoregressive generation over the KV cache of
    :class:`..models.transformer_lm.TransformerLM`.
  - :mod:`.metrics`  — p50/p99 latency, queue depth, throughput.

``python -m pytorch_distributed_training_tpu_torch.serving --config
pytorch_distributed_training_tpu_torch/configs/serve-lm-1024.yml`` serves a
synthetic open-loop stream (``__main__``).
"""
from .batcher import DynamicBatcher, OverloadedError, Request
from .decode import build_generate_fn
from .engine import InferenceEngine
from .metrics import ServingMetrics

__all__ = [
    "DynamicBatcher",
    "InferenceEngine",
    "OverloadedError",
    "Request",
    "ServingMetrics",
    "build_generate_fn",
]
