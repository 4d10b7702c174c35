"""InferenceEngine: a TransformerLM served by a batcher or a continuous
scheduler, or a ResNet or ViT classifier served by the batcher.

Port of the JAX package's ``serving/engine.py``: build the
model from a ``serve-*.yml`` config's ``model:`` section, its weights from
``serving.checkpoint`` (the port's own training checkpoint,
:func:`..engine.checkpoint.load_serving_state`; EMA weights when the run
kept them) or random from ``serving.seed``, put them on the device once,
and serve requests through :class:`.batcher.DynamicBatcher` or, with
``serving.scheduler.enabled``, through
:class:`.scheduler.ContinuousScheduler` over the paged KV pool (JAX
``:141``, ``:213-266``).  Every device call is padded UP to a (batch
bucket, seq bucket) pair, so the set of shapes the device sees is the
bucket grid whatever the traffic.

``serving.scheduler``: ``enabled``, ``slots``, ``block_size``,
``num_blocks``, ``prefix_cache``, ``async_depth``.  ``serving.resilience``
(the scheduler's supervisor; it requires the scheduler, JAX
``:268-274``): ``max_restarts``, ``poison_bisect``, ``drain_deadline_ms``,
``watchdog``.  Unknown keys raise.

The decode modes (JAX ``:86-260``), each counted only with ``enabled:
true``:

- ``serving.quant`` (``enabled``): the decode steps read int8 weights
  (:mod:`..ops.quant`), quantized from the f32 master weights before the
  cast; on the batcher path too;
- ``serving.lora`` (``enabled``, ``rank``, ``adapters``: names or
  ``{name, seed}``): a :class:`.lora.LoraRegistry` grafted onto the
  model; ``submit(..., adapter=name)``;
- ``serving.speculative`` (``enabled``, ``k``, ``draft``, ``draft_seed``,
  ``min_acceptance``): draft-model speculative decoding.  ``draft``
  overrides fields of the base model (before any LoRA graft) for the
  draft, drawn from a ``torch.Generator`` seeded with ``draft_seed``;
  without it the target drafts for itself.  ``min_acceptance`` is the
  snapshot's warning floor.

LoRA and speculative decoding need the scheduler, as in the JAX package.

Compute runs in ``serving.dtype`` (bf16 by default) with f32 logits.  The
Dense weights are rounded to the compute dtype once at build
(:meth:`..models.transformer_lm.TransformerLM.cast_matmul_weights_`), the
rounding every call would otherwise repeat.

There is no compile count (JAX ``compile_count``, ``:458``): nothing is
compiled per shape (the kernels are built once a process).  The snapshot
reports instead how often each hand-written kernel launched
(``launches_<kernel>``).

N replicas from one resolution (JAX ``:295``, ``:90-106``):
:meth:`InferenceEngine.resolve_config` loads or draws the weights once and,
for an LM, puts one :class:`ResolvedModel` on the device (grafted, int8
state taken, matmul weights cast, the speculative draft built); every
engine built from it serves that one model, so replicas share the weights.
Nothing mutates the model after that.  ``replica_id``, ``heartbeat_path``,
``heartbeat_interval_s`` and ``liveness_timeout_s`` are the fleet's
stamps, passed to the scheduler (:mod:`.fleet`); ``submit(replay_tokens=)``
is the router's fail-over.

Classification (JAX ``:179-190``, ``:315-345``, ``:633-643``,
``:757-772``): a ResNet or a ViT (``model.name`` other than
``TransformerLM``) on the :class:`.batcher.DynamicBatcher` path only;
``quant``, ``lora``, ``speculative`` and ``scheduler`` are LM-only and
raise ``ValueError``.  ``submit(image)`` takes one ``[image_size,
image_size, 3]`` image (``dataset.image_size``, 224 by default): uint8,
normalised on the device with the ImageNet constants
(:func:`..engine.steps.input_normalizer`), or with ``serving.normalize:
false`` float32 as it is.  A batch is padded up to its bucket with zero
images, runs once in eval mode (a ResNet on its running statistics, in
``channels_last`` on the card) and resolves each future to ``{"label":
int, "logits": float32 [n_classes]}``.  ``snapshot()`` adds the host ms a
batch (``batch_host_ms_*``).

Not ported yet, raising ``NotImplementedError`` with its ROADMAP item:
orbax checkpoints of the JAX package (P7b).
"""
from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data.datasets import IMAGENET_MEAN, IMAGENET_STD
from ..engine.checkpoint import load_serving_state
from ..engine.steps import input_normalizer
from ..models import TransformerLM, get_model, is_resnet
from ..ops import fused_elementwise
from ..ops.quant import is_quantized_leaf, quantize_tree
from .batcher import DynamicBatcher, Request
from .decode import build_generate_fn
from .lora import LoraRegistry
from .metrics import ServingMetrics
from .scheduler import ContinuousScheduler
from .speculative import SpeculativeSpec

__all__ = ["InferenceEngine", "ResolvedModel"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

_SCHEDULER_KEYS = ("enabled", "slots", "block_size", "num_blocks", "prefix_cache",
                   "async_depth")


class ResolvedModel(NamedTuple):
    """An LM prepared for serving once, for every engine built from it: on
    its device, LoRA-grafted under ``serving.lora``, its matmul weights
    cast, in eval mode; the int8 state of the f32 master weights under
    ``serving.quant``; the speculative draft under ``serving.speculative``
    with a ``draft``."""

    model: torch.nn.Module
    quant_state: Optional[Dict[str, Any]]
    lora_registry: Optional[LoraRegistry]
    draft: Optional[torch.nn.Module]


def _decode_modes(quant, lora, speculative) -> Dict[str, Any]:
    """The three decode-mode blocks, each key checked as JAX does."""
    quant_cfg = dict(quant or {})
    out = {"quant": bool(quant_cfg.pop("enabled", False))}
    if quant_cfg:
        raise ValueError(f"unknown serving.quant keys: {sorted(quant_cfg)}")
    lora_cfg = dict(lora or {})
    out.update(lora=bool(lora_cfg.pop("enabled", False)),
               lora_rank=int(lora_cfg.pop("rank", 8)),
               lora_adapters=lora_cfg.pop("adapters", None))
    if lora_cfg:
        raise ValueError(f"unknown serving.lora keys: {sorted(lora_cfg)}")
    spec_cfg = dict(speculative or {})
    out.update(speculative=bool(spec_cfg.pop("enabled", False)),
               spec_k=int(spec_cfg.pop("k", 4)),
               spec_draft=spec_cfg.pop("draft", None),
               spec_draft_seed=int(spec_cfg.pop("draft_seed", 0)),
               spec_min_acceptance=float(spec_cfg.pop("min_acceptance", 0.0)))
    if spec_cfg:
        raise ValueError(f"unknown serving.speculative keys: {sorted(spec_cfg)}")
    if not 0.0 <= out["spec_min_acceptance"] <= 1.0:
        raise ValueError("serving.speculative.min_acceptance must be in [0, 1], "
                         f"got {out['spec_min_acceptance']}")
    return out


def _resolve_lm(model, device, modes: Dict[str, Any], use_sched: bool, logger) -> ResolvedModel:
    """The LM's one preparation for serving (see :class:`ResolvedModel`)."""
    base_model = model
    registry = None
    if modes["lora"]:
        registry = LoraRegistry(modes["lora_rank"], modes["lora_adapters"])
        model = registry.graft(model)
        logger.info("multi-LoRA serving: rank %d, adapters %s", registry.rank, registry.names)
    model = model.to(device)
    # int8 decode: quantized from the f32 master weights, before the cast
    # rounds them (the JAX package quantizes its f32 params)
    quant_state = None
    if modes["quant"]:
        quant_state = {n: v for n, v in quantize_tree(model.state_dict()).items()
                       if is_quantized_leaf(v)}
    model = model.cast_matmul_weights_().eval()
    draft = None
    if use_sched and modes["speculative"] and modes["spec_draft"] is not None:
        # the base model (never the LoRA graft: a draft's miss costs only
        # acceptance) with the config's overrides, random from draft_seed;
        # a trained draft waits for one
        with torch.device("meta"):
            draft = base_model.clone(**dict(modes["spec_draft"]))
        draft = draft.to_empty(device="cpu")
        draft.reset_parameters(torch.Generator().manual_seed(modes["spec_draft_seed"]))
        draft = draft.to(device).cast_matmul_weights_().eval()
    return ResolvedModel(model, quant_state, registry, draft)


class InferenceEngine:
    """Serve a :class:`..models.transformer_lm.TransformerLM` through a
    dynamic batcher, or a continuous scheduler (``scheduler``); or a
    classifier through the batcher.

    ``submit(prompt)`` takes a 1-D int token prompt and returns a future
    resolving to ``{"tokens": int32 [gen_len], "gen_len": int}``; for a
    classifier ``submit(image)`` resolves to ``{"label", "logits"}``
    (``image_size`` its side, ``input_norm`` the ``(mean, std)`` that
    uint8 images are normalised with, ``None`` for float32 input).

    ``state_dict`` (optional) is loaded strictly into ``model`` before it
    moves to ``device``; without it the model's own parameters serve.
    ``model`` may be a :class:`ResolvedModel` (from :meth:`resolve_config`),
    served as it is by every engine given it.
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
        scheduler: Optional[Dict[str, Any]] = None,
        resilience: Optional[Dict[str, Any]] = None,
        quant: Optional[Dict[str, Any]] = None,
        lora: Optional[Dict[str, Any]] = None,
        speculative: Optional[Dict[str, Any]] = None,
        image_size: int = 224,
        input_norm=None,
        logger: Optional[logging.Logger] = None,
        replica_id: Optional[int] = None,
        heartbeat_path: Optional[str] = None,
        heartbeat_interval_s: float = 0.5,
        liveness_timeout_s: Optional[float] = None,
    ):
        self.device = resolve_device(device)
        self.logger = logger or logging.getLogger(__name__)
        resolved = model if isinstance(model, ResolvedModel) else None
        if resolved is not None:
            if state_dict is not None:
                raise ValueError("a ResolvedModel carries its weights: pass no state_dict")
            model = resolved.model
            if model.tok_embedding.device.type != self.device.type:
                raise ValueError(f"the ResolvedModel lies on {model.tok_embedding.device}, "
                                 f"not on {self.device}")
        # the fleet's stamps: the replica's registry names and heartbeat
        self.replica_id = replica_id
        self.heartbeat_path = heartbeat_path
        self.is_lm = isinstance(model, TransformerLM)
        self.max_new_tokens = int(max_new_tokens)
        self.vocab_size = model.vocab_size if self.is_lm else None
        self.image_size = int(image_size)
        self.batch_buckets = sorted({int(b) for b in batch_buckets})
        self.seq_buckets = sorted({int(s) for s in seq_buckets})
        if not self.batch_buckets or self.batch_buckets[-1] < max_batch_size:
            raise ValueError(
                f"largest batch bucket {self.batch_buckets} must hold "
                f"max_batch_size {max_batch_size}"
            )
        if self.is_lm:
            if not self.seq_buckets:
                raise ValueError("LM serving needs at least one seq bucket")
            worst = self.seq_buckets[-1] + self.max_new_tokens
            if worst > model.max_len:
                raise ValueError(
                    f"largest seq bucket {self.seq_buckets[-1]} + max_new_tokens "
                    f"{self.max_new_tokens} = {worst} exceeds model max_len {model.max_len}"
                )
        sched_cfg = dict(scheduler or {})
        unknown = sorted(set(sched_cfg) - set(_SCHEDULER_KEYS))
        if unknown:
            raise ValueError(f"unknown serving.scheduler keys: {unknown}")
        use_sched = bool(sched_cfg.get("enabled", False))
        if resilience is not None and not use_sched:
            raise ValueError(
                "serving.resilience requires serving.scheduler.enabled: the batcher path "
                "has no supervisor (poison bisect, hot restart and replay all live in the "
                "continuous scheduler)"
            )
        modes = _decode_modes(quant, lora, speculative)
        use_quant, use_lora, use_spec = modes["quant"], modes["lora"], modes["speculative"]
        if not self.is_lm:
            if use_quant or use_lora or use_spec:
                raise ValueError("serving.quant/lora/speculative are LM-only")
            if use_sched:
                raise ValueError("serving.scheduler is LM-only: a classifier is served by "
                                 "the dynamic batcher")
        if (use_lora or use_spec) and not use_sched:
            raise ValueError(
                "serving.lora and serving.speculative require serving.scheduler.enabled: "
                "adapter multiplexing and draft verification live in the continuous "
                "scheduler's paged calls")
        self.serving_modes = {"quant": use_quant, "lora": use_lora, "speculative": use_spec}
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.seed = int(seed)
        self.metrics = ServingMetrics(replica_id)
        self.scheduler: Optional[ContinuousScheduler] = None
        if not self.is_lm:
            layout = (torch.channels_last if self.device.type == "cuda"
                      else torch.contiguous_format)
            self.model = model.to(self.device, memory_format=layout).eval()
            self._normalize = input_normalizer(input_norm)
            self._input_dtype = np.uint8 if input_norm is not None else np.float32
            self.batcher = DynamicBatcher(
                self._run_batch, max_batch_size, max_delay_ms,
                deadline_ms=deadline_ms, max_backlog=max_backlog,
                on_timeout=lambda: self.metrics.incr("timeouts"),
                on_shed=lambda: self.metrics.incr("sheds"),
            )
            return
        if resolved is None:
            resolved = _resolve_lm(model, self.device, modes, use_sched, self.logger)
        elif ((resolved.lora_registry is not None) != use_lora
              or (resolved.quant_state is not None) != use_quant
              or (resolved.draft is not None) != (
                  use_sched and use_spec and modes["spec_draft"] is not None)):
            raise ValueError("the ResolvedModel was prepared for other serving.lora/quant/"
                             "speculative settings")
        self.lora_registry = resolved.lora_registry
        self.quant_state = resolved.quant_state
        self.model = resolved.model
        self._batch_counter = 0  # flush thread only
        self.metrics.spec_min_acceptance = modes["spec_min_acceptance"]
        self.batcher: Optional[DynamicBatcher] = None
        if use_sched:
            spec = None
            if use_spec:
                spec = SpeculativeSpec(modes["spec_k"], resolved.draft)
            self.scheduler = ContinuousScheduler(
                self.model,
                slots=int(sched_cfg.get("slots", 8)),
                block_size=int(sched_cfg.get("block_size", 16)),
                num_blocks=int(sched_cfg.get("num_blocks", 64)),
                prefix_cache=bool(sched_cfg.get("prefix_cache", True)),
                batch_buckets=self.batch_buckets,
                seq_buckets=self.seq_buckets,
                max_new_tokens=self.max_new_tokens,
                temperature=temperature,
                eos_id=eos_id,
                deadline_ms=deadline_ms,
                max_backlog=max_backlog,
                metrics=self.metrics,
                seed=self.seed,
                resilience=resilience,
                async_depth=int(sched_cfg.get("async_depth", 0)),
                logger=self.logger,
                quant=self.quant_state if use_quant else False,
                lora=self.lora_registry,
                speculative=spec,
                replica_id=replica_id,
                heartbeat_path=heartbeat_path,
                heartbeat_interval_s=heartbeat_interval_s,
                liveness_timeout_s=liveness_timeout_s,
            )
        else:
            self._generate = build_generate_fn(
                self.model, self.max_new_tokens, temperature=temperature, eos_id=eos_id,
                quant=self.quant_state,
            )
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
        ``cuda``; raises ``RuntimeError`` when no card is present): one
        :meth:`resolve_config` and one engine."""
        model, kwargs = cls.resolve_config(cfg, device=device, logger=logger,
                                           state_dict=state_dict)
        return cls(model, **kwargs)

    @classmethod
    def resolve_config(cls, cfg: Dict[str, Any], device=None, logger=None,
                       state_dict=None) -> Tuple[Any, Dict[str, Any]]:
        """A ``serve-*.yml`` config resolved into ``(model, kwargs)`` for
        the constructor, so that several engines (a fleet's replicas) pay
        for the weights once: an LM comes as a :class:`ResolvedModel` on
        ``device``, a classifier as its module with its weights loaded.

        The weights: ``state_dict`` when given, else ``serving.checkpoint``
        (the newest step of a port training checkpoint, its EMA weights
        when it kept them, a ResNet's running statistics with them), else
        random, drawn with the initializers' distributions from
        ``torch.Generator`` seeded with ``serving.seed`` (a ResNet's
        running statistics reset to mean 0, variance 1).  A classifier
        takes ``dataset.image_size`` (224) and ``serving.normalize``
        (true: uint8 images, normalised with the ImageNet constants).
        """
        device = resolve_device(device)
        logger = logger or logging.getLogger(__name__)
        serve = cfg["serving"]
        dtype_name = serve.get("dtype", "bfloat16")
        if dtype_name not in _DTYPES:
            raise ValueError(
                f"serving.dtype must be one of {sorted(_DTYPES)}, got {dtype_name!r}"
            )
        model_cfg = dict(cfg["model"])
        model_name = model_cfg.pop("name")
        is_lm = model_name.lower() == "transformerlm"
        image_size = int(cfg["dataset"].get("image_size", 224))
        if not is_lm and not is_resnet(model_name):
            model_cfg.setdefault("image_size", image_size)  # a ViT's position table
        seed = int(serve.get("seed", 0))
        # allocated uninitialised: every parameter is drawn or loaded below,
        # so the constructors' own init would be thrown away
        with torch.device("meta"):
            model = get_model(
                model_name, num_classes=cfg["dataset"]["n_classes"],
                dtype=_DTYPES[dtype_name], **model_cfg,
            )
        model = model.to_empty(device="cpu")
        ckpt_dir = serve.get("checkpoint")
        if state_dict is None and ckpt_dir:
            state_dict, step = load_serving_state(ckpt_dir, logger)
            logger.info("Serving %s from checkpoint iter %d", model_name, step)
        elif state_dict is None:
            logger.warning(
                "serving.checkpoint not set: serving RANDOM-INIT %s weights "
                "(smoke/bench mode only)", model_name,
            )
            model.reset_parameters(torch.Generator().manual_seed(seed))
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        if is_lm:
            sched = serve.get("scheduler") or {}
            model = _resolve_lm(
                model, device, _decode_modes(serve.get("quant"), serve.get("lora"),
                                             serve.get("speculative")),
                bool(sched.get("enabled", False)), logger)
        max_batch = int(serve.get("max_batch_size", 8))
        input_norm = None
        if not is_lm and serve.get("normalize", True):
            input_norm = (IMAGENET_MEAN, IMAGENET_STD)
        return model, dict(
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
            scheduler=serve.get("scheduler"),
            resilience=serve.get("resilience"),
            quant=serve.get("quant"),
            lora=serve.get("lora"),
            speculative=serve.get("speculative"),
            image_size=image_size,
            input_norm=input_norm,
            logger=logger,
        )

    # ------------------------------------------------------------------ #

    def submit(self, payload, deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None, on_token=None, key=None,
               adapter: Optional[str] = None, replay_tokens=None):
        """Validate + enqueue one prompt; returns its result future.

        ``max_new_tokens`` caps this request below ``serving.max_new_tokens``
        (on the batcher path the result is truncated host-side and the
        batch still pays the full decode; the scheduler retires the slot at
        the cap).  ``on_token`` (stream each token), ``key`` (the request's
        sampling key), ``adapter`` (a ``serving.lora`` adapter's name) and
        ``replay_tokens`` (the stream a failed-over request already
        delivered, with its original ``key``) need the scheduler.  A
        classifier takes one image and none of these.
        """
        if not self.is_lm:
            if (max_new_tokens is not None or on_token is not None or key is not None
                    or adapter is not None or replay_tokens):
                raise ValueError("max_new_tokens/on_token/key/adapter/replay_tokens are LM-only")
            img = np.asarray(payload)
            want = (self.image_size, self.image_size, 3)
            if img.shape != want:
                raise ValueError(f"image payload must have shape {want}, got {img.shape}")
            if self._input_dtype == np.uint8 and img.dtype != np.uint8:
                raise ValueError(f"image payload must be uint8 (serving.normalize: true), got "
                                 f"{img.dtype}")
            return self.batcher.submit(img.astype(self._input_dtype, copy=False),
                                       deadline_ms=deadline_ms)
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
        if self.scheduler is not None:
            return self.scheduler.submit(prompt, deadline_ms=deadline_ms,
                                         max_new_tokens=max_new_tokens, on_token=on_token,
                                         key=key, adapter=adapter, replay_tokens=replay_tokens)
        if on_token is not None or key is not None or adapter is not None or replay_tokens:
            raise ValueError(
                "on_token / per-request key / adapter / replay_tokens require "
                "serving.scheduler.enabled (the batcher path samples whole batches and "
                "resolves futures only at the end)"
            )
        return self.batcher.submit(
            prompt.astype(np.int32), deadline_ms=deadline_ms,
            max_new=(int(max_new_tokens) if max_new_tokens else None),
        )

    def depth(self) -> int:
        if self.scheduler is not None:
            return self.scheduler.depth()
        return self.batcher.depth()

    def health(self) -> Dict[str, Any]:
        """Readiness/liveness snapshot for orchestration probes."""
        if self.scheduler is not None:
            return self.scheduler.health()
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
        """Run one prefill through every (batch, seq) bucket pair and the
        decode calls.

        Nothing is compiled per shape here, but the first calls still pay
        one-time costs (the kernels' build and load, the CUDA libraries'
        handles and workspaces) that would otherwise land in the first
        requests' latency.  A classifier runs one zero batch a batch
        bucket (its "pairs").  On the scheduler's path every position is -1,
        so every write goes to the pool's sink row and the live pool is
        untouched.  Returns ``{"warmup_ms", "pairs"}``.
        """
        t0 = time.perf_counter()
        pairs = 0
        if not self.is_lm:
            # one zero batch a batch bucket (JAX _warmup_classify)
            for bb in self.batch_buckets:
                self._logits(np.zeros((bb, self.image_size, self.image_size, 3),
                                      self._input_dtype)).cpu()
                pairs += 1
        else:
            for bb in self.batch_buckets:
                for sb in self.seq_buckets:
                    if self.scheduler is not None:
                        self._warmup_prefill(bb, sb)
                    else:
                        self._generate(
                            np.zeros((bb, sb), np.int32), np.ones((bb,), np.int32), seed=0
                        )
                    pairs += 1
            if self.scheduler is not None:
                self._warmup_decode()
        ms = (time.perf_counter() - t0) * 1000.0
        self.metrics.set_gauge("warmup_ms", ms)
        self.logger.info("engine warmup: %d bucket pair(s) in %.0f ms", pairs, ms)
        return {"warmup_ms": ms, "pairs": float(pairs)}

    def _warmup_prefill(self, bb: int, sb: int) -> None:
        sched = self.scheduler
        out = sched._fns.prefill(
            sched._pool, np.zeros((bb, sb), np.int64), np.full((bb, sb), -1, np.int64),
            np.zeros((bb, sched.table_blocks), np.int64), np.zeros((bb,), np.int64),
            [None] * bb, np.zeros((bb,), np.int64))
        out.cpu()

    def _warmup_decode(self) -> None:
        sched = self.scheduler
        w, t = sched.slots_n, sched.table_blocks
        args = (np.full((w,), -1, np.int64), np.zeros((w, t), np.int64), [None] * w,
                np.zeros((w,), np.int64))
        sched._fns.decode_step(sched._pool, np.zeros((w,), np.int64), *args).cpu()
        if sched._async_depth:
            sched._fns.decode_step_fed(sched._pool, sched._zero_carry(),
                                       np.zeros((w,), np.int64), np.zeros((w,), np.int64),
                                       *args).cpu()
        if sched._spec is not None:
            self._warmup_speculative()

    def _warmup_speculative(self) -> None:
        """The speculative round's other calls: the target's ``verify`` and
        ``copy_rows`` (every row out of range: the sink row), and the
        draft's prefill at every bucket pair and its decode step."""
        sched = self.scheduler
        w, t, k = sched.slots_n, sched.table_blocks, sched._spec.k
        aids = np.full((w,), -1, np.int64)
        sched._fns.verify(sched._pool, np.zeros((w, k + 1), np.int64),
                          np.full((w, k + 1), -1, np.int64), np.zeros((w, t), np.int64),
                          aids).cpu()
        oob = np.full((w * sched._block_size,), sched._pool.pool_rows, np.int64)
        sched._fns.copy_rows(sched._pool, oob, oob)
        for bb in self.batch_buckets:
            for sb in self.seq_buckets:
                sched._draft_fns.prefill(
                    sched._draft_pool, np.zeros((bb, sb), np.int64),
                    np.full((bb, sb), -1, np.int64), np.zeros((bb, t), np.int64),
                    np.zeros((bb,), np.int64), [None] * bb, np.zeros((bb,), np.int64),
                    np.full((bb,), -1, np.int64)).cpu()
        sched._draft_fns.decode_step(sched._draft_pool, np.zeros((w,), np.int64),
                                     np.full((w,), -1, np.int64), np.zeros((w, t), np.int64),
                                     [None] * w, np.zeros((w,), np.int64), aids).cpu()

    def drain(self, deadline_ms: Optional[float] = None) -> float:
        """Stop admitting, finish what is queued and in flight, close.
        Returns wall ms.  On the scheduler path the drain is bounded by
        ``deadline_ms`` (default ``serving.resilience.drain_deadline_ms``);
        the batcher path has no admission gate beyond ``close()``'s
        synchronous flush, so there drain is close, timed."""
        if self.scheduler is not None:
            return self.scheduler.drain(deadline_ms)
        t0 = time.monotonic()
        self.batcher.close()
        return (time.monotonic() - t0) * 1000.0

    def install_drain_handler(self, signum=None) -> None:
        """Route SIGTERM (or ``signum``) to a graceful :meth:`drain` (JAX
        ``:645``).  The handler only starts a daemon thread: a drain joins
        the scheduler thread, which a signal handler must not do inline.
        Call from the main thread, as ``signal.signal`` requires."""
        signum = signal.SIGTERM if signum is None else signum

        def _handler(sig, frame):
            self.logger.warning("signal %s received - draining serving engine", sig)
            threading.Thread(target=self.drain, name="serving-drain", daemon=True).start()

        signal.signal(signum, _handler)

    def close(self) -> None:
        if self.scheduler is not None:
            self.scheduler.close()
        else:
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

    @torch.no_grad()
    def _logits(self, img: np.ndarray) -> torch.Tensor:
        """f32 logits on the device of an ``[N, H, W, 3]`` host batch: up in
        one copy, normalised on the device, the model in eval mode."""
        x = torch.from_numpy(img).to(self.device)
        return self.model(self._normalize(x).permute(0, 3, 1, 2)).float()

    def _run_images(self, requests: List[Request]) -> List[Any]:
        """One padded classification batch (JAX ``_run_images``)."""
        depth = self.batcher.depth()
        t0 = time.perf_counter()
        bb = self._bucket_for(len(requests), self.batch_buckets, "batch size")
        img = np.zeros((bb, self.image_size, self.image_size, 3), self._input_dtype)
        for i, req in enumerate(requests):
            img[i] = req.payload
        on_device = self._logits(img)
        t_wait = time.perf_counter()
        logits = on_device.cpu().numpy()  # the one wait on the device
        t_done = time.perf_counter()
        results = [{"label": int(logits[i].argmax()), "logits": logits[i]}
                   for i in range(len(requests))]
        t_end = time.perf_counter()
        # the host's own ms: the batch's wall time less its wait for the
        # logits (the input's copy up is counted as host time)
        host_ms = ((t_wait - t0) + (t_end - t_done)) * 1e3
        self.metrics.record_batch([r.enqueued_at for r in requests], len(results), depth,
                                  host_ms=host_ms)
        return results

    def _run_batch(self, requests: List[Request]) -> List[Any]:
        if not self.is_lm:
            return self._run_images(requests)
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
