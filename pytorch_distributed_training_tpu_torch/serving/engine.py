"""InferenceEngine: a TransformerLM served through a dynamic batcher.

Port of the JAX package's ``serving/engine.py``, LM batcher path: build the
model from a ``serve-*.yml`` config's ``model:`` section, put its weights
on the device once, and serve requests through :class:`.batcher.DynamicBatcher`.
Every batch is padded UP to a (batch bucket, seq bucket) pair, so the set
of shapes the device sees is the bucket grid whatever the traffic.

Compute runs in ``serving.dtype`` (bf16 by default) with f32 logits.  The
Dense weights are rounded to the compute dtype once at build
(:meth:`..models.transformer_lm.TransformerLM.cast_matmul_weights_`), the
rounding every call would otherwise repeat.

There is no compile count: nothing is compiled per shape.  The snapshot
reports instead how often each hand-written kernel launched
(``launches_<kernel>``).

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: ``serving.checkpoint`` (P7), ``scheduler`` and ``resilience`` (P4),
``quant``, ``lora`` and ``speculative`` (P5), classification models (P8).
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models import get_model
from ..ops import fused_elementwise
from .batcher import DynamicBatcher, Request
from .decode import build_generate_fn
from .metrics import ServingMetrics

__all__ = ["InferenceEngine"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

_NOT_YET = {
    "checkpoint": "restoring a checkpoint is ROADMAP port item P7",
    "scheduler": "the continuous scheduler is ROADMAP port item P4",
    "resilience": "serving resilience (a scheduler feature) is ROADMAP port item P4",
    "quant": "int8 decode is ROADMAP port item P5",
    "lora": "multi-LoRA serving is ROADMAP port item P5",
    "speculative": "speculative decoding is ROADMAP port item P5",
}


def _reject_unported(serve: Dict[str, Any]) -> None:
    """Raise for a ``serving`` key that asks for an unported feature.  As in
    the JAX engine, a mode block counts only with ``enabled: true``; a
    checkpoint path or a resilience block always asks."""
    for key, why in _NOT_YET.items():
        val = serve.get(key)
        if key in ("checkpoint", "resilience"):
            wanted = bool(val)
        else:
            wanted = bool((val or {}).get("enabled", False))
        if wanted:
            raise NotImplementedError(f"serving.{key}: {why}")


class InferenceEngine:
    """Serve a :class:`..models.transformer_lm.TransformerLM` through a
    dynamic batcher.

    ``submit(prompt)`` takes a 1-D int token prompt and returns a future
    resolving to ``{"tokens": int32 [gen_len], "gen_len": int}``.

    ``state_dict`` (optional) is loaded strictly into ``model`` before it
    moves to ``device``; without it the model's own parameters serve.
    """

    def __init__(
        self,
        model,
        *,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        device=None,
        batch_buckets: Sequence[int],
        seq_buckets: Sequence[int],
        max_batch_size: int,
        max_delay_ms: float,
        deadline_ms: Optional[float] = None,
        max_backlog: Optional[int] = None,
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        seed: int = 0,
        logger: Optional[logging.Logger] = None,
    ):
        self.device = resolve_device(device)
        self.logger = logger or logging.getLogger(__name__)
        self.max_new_tokens = int(max_new_tokens)
        self.vocab_size = model.vocab_size
        self.batch_buckets = sorted({int(b) for b in batch_buckets})
        self.seq_buckets = sorted({int(s) for s in seq_buckets})
        if not self.seq_buckets:
            raise ValueError("LM serving needs at least one seq bucket")
        if not self.batch_buckets or self.batch_buckets[-1] < max_batch_size:
            raise ValueError(
                f"largest batch bucket {self.batch_buckets} must hold "
                f"max_batch_size {max_batch_size}"
            )
        worst = self.seq_buckets[-1] + self.max_new_tokens
        if worst > model.max_len:
            raise ValueError(
                f"largest seq bucket {self.seq_buckets[-1]} + max_new_tokens "
                f"{self.max_new_tokens} = {worst} exceeds model max_len {model.max_len}"
            )
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).cast_matmul_weights_().eval()
        self._generate = build_generate_fn(
            self.model, self.max_new_tokens, temperature=temperature, eos_id=eos_id
        )
        self.seed = int(seed)
        self._batch_counter = 0  # flush thread only
        self.metrics = ServingMetrics()
        self.batcher = DynamicBatcher(
            self._run_batch, max_batch_size, max_delay_ms,
            deadline_ms=deadline_ms, max_backlog=max_backlog,
            on_timeout=lambda: self.metrics.incr("timeouts"),
            on_shed=lambda: self.metrics.incr("sheds"),
        )

    # ------------------------------------------------------------------ #

    @classmethod
    def from_config(cls, cfg: Dict[str, Any], device=None, logger=None,
                    state_dict=None) -> "InferenceEngine":
        """Build from a ``serve-*.yml`` config on ``device`` (default
        ``cuda``; raises ``RuntimeError`` when no card is present).

        Without ``state_dict`` (and without ``serving.checkpoint``, which is
        not ported yet) the weights are random, drawn with flax's
        initializers' distributions from ``torch.Generator`` seeded with
        ``serving.seed``.
        """
        device = resolve_device(device)
        logger = logger or logging.getLogger(__name__)
        serve = cfg["serving"]
        _reject_unported(serve)
        dtype_name = serve.get("dtype", "bfloat16")
        if dtype_name not in _DTYPES:
            raise ValueError(
                f"serving.dtype must be one of {sorted(_DTYPES)}, got {dtype_name!r}"
            )
        model_cfg = dict(cfg["model"])
        model_name = model_cfg.pop("name")
        if model_name.lower() != "transformerlm":
            raise NotImplementedError(
                f"serving {model_name!r}: classification serving is ROADMAP port item P8"
            )
        seed = int(serve.get("seed", 0))
        model = get_model(
            model_name, num_classes=cfg["dataset"]["n_classes"],
            dtype=_DTYPES[dtype_name], **model_cfg,
        )
        if state_dict is None:
            logger.warning(
                "serving.checkpoint not set: serving RANDOM-INIT %s weights "
                "(smoke/bench mode only)", model_name,
            )
            model.reset_parameters(torch.Generator().manual_seed(seed))
        max_batch = int(serve.get("max_batch_size", 8))
        return cls(
            model,
            state_dict=state_dict,
            device=device,
            batch_buckets=serve.get("batch_buckets", [max_batch]),
            seq_buckets=serve.get("seq_buckets", [16]),
            max_batch_size=max_batch,
            max_delay_ms=float(serve.get("max_delay_ms", 5.0)),
            deadline_ms=(
                float(serve["deadline_ms"]) if serve.get("deadline_ms") is not None else None
            ),
            max_backlog=(
                int(serve["max_backlog"]) if serve.get("max_backlog") is not None else None
            ),
            max_new_tokens=int(serve.get("max_new_tokens", 16)),
            temperature=float(serve.get("temperature", 0.0)),
            eos_id=serve.get("eos_id"),
            seed=seed,
            logger=logger,
        )

    # ------------------------------------------------------------------ #

    def submit(self, payload, deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None):
        """Validate + enqueue one prompt; returns its result future.

        ``max_new_tokens`` caps this request below ``serving.max_new_tokens``
        (the result is truncated host-side; the batch still pays the full
        decode).
        """
        prompt = np.asarray(payload)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(
                f"LM payload must be a non-empty 1-D token sequence, got shape {prompt.shape}"
            )
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(f"LM payload must hold integer tokens, got {prompt.dtype}")
        if prompt.size > self.seq_buckets[-1]:
            raise ValueError(
                f"prompt length {prompt.size} exceeds largest seq bucket {self.seq_buckets[-1]}"
            )
        # an out-of-range id would index past the embedding table on the card
        if prompt.min() < 0 or prompt.max() >= self.vocab_size:
            raise ValueError(f"prompt tokens must lie in [0, {self.vocab_size})")
        if max_new_tokens is not None and not 1 <= int(max_new_tokens) <= self.max_new_tokens:
            raise ValueError(
                f"max_new_tokens must be in [1, {self.max_new_tokens}], got {max_new_tokens}"
            )
        return self.batcher.submit(
            prompt.astype(np.int32), deadline_ms=deadline_ms,
            max_new=(int(max_new_tokens) if max_new_tokens else None),
        )

    def depth(self) -> int:
        return self.batcher.depth()

    def health(self) -> Dict[str, Any]:
        """Readiness/liveness snapshot for orchestration probes."""
        return {"ready": True, "live": True, "queue_depth": self.batcher.depth()}

    def kernel_launches(self) -> Dict[str, int]:
        """Launches of each hand-written kernel in this process so far."""
        return fused_elementwise.launch_counts()

    def snapshot(self) -> Dict[str, Any]:
        """The metrics snapshot plus ``launches_<kernel>`` counts."""
        snap = self.metrics.snapshot()
        for name, n in self.kernel_launches().items():
            snap[f"launches_{name}"] = n
        return snap

    def warmup(self) -> Dict[str, float]:
        """Run one prefill + decode through every (batch, seq) bucket pair.

        Nothing is compiled per shape here, but the first calls still pay
        one-time costs (the kernels' build and load, the CUDA libraries'
        handles and workspaces) that would otherwise land in the first
        requests' latency.  Returns ``{"warmup_ms", "pairs"}``.
        """
        t0 = time.perf_counter()
        pairs = 0
        for bb in self.batch_buckets:
            for sb in self.seq_buckets:
                self._generate(
                    np.zeros((bb, sb), np.int32), np.ones((bb,), np.int32), seed=0
                )
                pairs += 1
        ms = (time.perf_counter() - t0) * 1000.0
        self.metrics.set_gauge("warmup_ms", ms)
        self.logger.info("engine warmup: %d bucket pair(s) in %.0f ms", pairs, ms)
        return {"warmup_ms": ms, "pairs": float(pairs)}

    def drain(self) -> float:
        """Stop admitting, finish what is queued, close.  Returns wall ms.
        The batcher path has no admission gate beyond ``close()``'s
        synchronous flush, so drain is close, timed."""
        t0 = time.monotonic()
        self.batcher.close()
        return (time.monotonic() - t0) * 1000.0

    def close(self) -> None:
        self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ #

    def _bucket_for(self, n: int, buckets: Sequence[int], kind: str) -> int:
        for b in buckets:
            if n <= b:
                return b
        raise ValueError(f"{kind} {n} exceeds largest bucket {buckets[-1]}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_batch(self, requests: List[Request]) -> List[Any]:
        depth = self.batcher.depth()
        lens = [req.payload.size for req in requests]
        bb = self._bucket_for(len(requests), self.batch_buckets, "batch size")
        sb = self._bucket_for(max(lens), self.seq_buckets, "prompt length")
        tokens = np.zeros((bb, sb), np.int32)
        prompt_len = np.ones((bb,), np.int32)  # pad rows: 1-token dummy
        for i, req in enumerate(requests):
            tokens[i, : lens[i]] = req.payload
            prompt_len[i] = lens[i]
        self._batch_counter += 1
        # phase-timed: the host clock around work that ends in a sync
        t0 = time.perf_counter()
        carry = self._generate.prefill(
            tokens, prompt_len, seed=(self.seed, self._batch_counter)
        )
        self._sync()
        t1 = time.perf_counter()
        out, gen_len = self._generate.decode(prompt_len, carry)  # host copy = sync
        t2 = time.perf_counter()
        results = []
        for i, req in enumerate(requests):
            g = int(gen_len[i])
            cap = req.meta.get("max_new")
            if cap:
                g = min(g, int(cap))
            results.append({"tokens": out[i, :g], "gen_len": g})
        self.metrics.record_batch(
            [r.enqueued_at for r in requests],
            sum(r["gen_len"] for r in results), depth,
            gen_lens=[r["gen_len"] for r in results],
            prompt_tokens=int(sum(lens)), prefill_s=t1 - t0, decode_s=t2 - t1,
        )
        return results
