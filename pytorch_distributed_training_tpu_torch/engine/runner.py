"""The training runner: LM and image data parallelism (port of ``engine/runner.py``).

``Runner(...)()`` builds everything from a training config and runs the
reference's iteration loop.  The model family picks the path, as the JAX
package's ``engine/paths.py`` does: ``TransformerLM`` trains on the LM
path, every other name (the ResNets and the ViTs) on the image path (JAX
``engine/topology.py:67``).

- datasets (``dataset.*``), the sampler (shuffled, ``drop_last`` for
  training; in order and wrap-padded for validation; sharded by rank when
  the world has more than one rank) and the batch loader: on the image
  path with ``training.worker_mode`` (``auto``: native JPEG decode for
  ImageFolder, threads otherwise), ``max(1, num_workers // cards on the
  node)`` workers a process (one process a card, where the JAX runner
  gives ``num_workers`` to each host's one controller), uint8 batches
  with ``training.device_normalize`` (normalised on the card) and
  ``training.dct_denom`` for the training loader (``runner.py:219-310``);
  the LM path's loaders take the same ``num_workers`` share and
  ``worker_mode`` (``thread`` or ``process``).  Batches reach the card
  through :func:`..data.device_prefetch` with a :class:`..data.PinnedStager`
  (two copies in flight);
- the model from ``model.*`` in ``training.dtype`` with f32 master
  parameters, on the card (``device``, default ``cuda``):
  - LM: flash on; ``training.remat`` is the JAX package's alias of
    ``model.remat``/``model.remat_policy`` (:func:`apply_remat_alias`);
  - image: a ResNet whose BatchNorms average their statistics over the
    ranks when ``training.sync_bn`` is set and the world has more than one
    rank (JAX ``engine/topology.py:81``: at world size 1 the statistics
    are local), or a ViT (no BatchNorm; its position table sized from
    ``dataset.image_size``), in ``channels_last`` on the card; a ResNet
    also takes ``space_to_depth`` (the packed stem) and ``bn_stat_dtype``
    (``bfloat16`` statistics);
  - the ``model:`` keys are parsed by :func:`.topology.parse_model` (JAX
    ``topology.py:55-90``); the keys left reach the constructor, so an
    unknown one raises;
  - ``model.pretrained``: a torch ``state_dict`` (a torchvision ResNet or
    ``VisionTransformer``, or the LM twin, :mod:`..models.torch_port`)
    loaded over the initial weights, strictly, before the train step
    copies them into the EMA (JAX ``runner.py:536-610``,
    ``paths.py:265-269``);
- the optimizer and LR schedule from ``training.optimizer`` /
  ``training.lr_schedule``;
- the train and eval steps of :mod:`.sp_steps` (LM) or :mod:`.steps`
  (image); a MoE LM (``model.moe_experts`` > 0) takes the GSPMD path's
  step, :mod:`.tp_steps` (JAX ``engine/paths.py:290-310``: CE plus every
  MoE block's aux term, validation pure CE), at tensor (= expert)
  parallelism 1, after the JAX package's MoE layout checks and its
  refusal of the anomaly guard and ``comm.overlap`` on that path
  (:func:`.topology.check_moe`, :func:`.topology.check_gspmd_path`); the
  CPU tests are ``tests/test_torch_moe.py``, the card's run
  ``python3 chip_smoke.py --moe``; on the image path with the weight EMA of ``training.ema.decay``
  (in (0, 1); the LM path refuses it, as JAX ``engine/topology.py:347-352``
  does), validation then running on the EMA weights with the raw
  BatchNorm running statistics (JAX ``runner.py:1257-1262``);
- with ``training.checkpoint`` (:mod:`.checkpoint`, both paths): resume
  from the newest step (the state, ``self.iter``, the scheduler and the
  input pipeline's position from the step's sidecar, else
  ``divmod(iter, batches an epoch)``), a save every ``interval`` and after
  the last iteration, and the :class:`.preemption.PreemptionGuard`: a
  latched signal saves at the current iteration and returns; with more
  than one rank the ranks agree on it every ``preemption_sync_interval``
  steps through one all-reduce (JAX ``runner.py:340-356``, ``:443-485``,
  ``:612-680``);
- ``training.grad_accumulation`` N: each step runs its local batch as N
  micro-batches (:mod:`.sp_steps`, :mod:`.steps`); a per-card batch that
  N does not divide raises at start-up (JAX ``topology.py:328-375``);
- ``training.fault_tolerance`` (:func:`.topology.parse_fault_tolerance`,
  JAX ``runner.py:206-217``, ``:486-497``, ``:668-730``, ``:852-903``,
  ``:1183-1212``):
  - ``anomaly``: the steps' guard against the trailing median of the
    applied steps' gradient norms (``window`` of them); ``max_consecutive``
    skipped steps in a row roll back (:meth:`Runner._rollback`): the newest
    checkpoint restored, its parameters checked finite, ``iter``, the
    scheduler and the input position set from it, the history cleared,
    the watchdog back in its warm-up and the stream rebuilt; with no
    ``training.checkpoint`` a rollback raises ``RuntimeError``;
  - ``watchdog``: :class:`.watchdog.StepWatchdog` around each iteration;
    on a fire it logs the step, the loader's queue and every thread's
    stack, and with ``checkpoint_and_exit`` sets the preemption flag;
  - ``fault_spec`` (or ``PDT_FAULT_SPEC``, which wins): the injector of
    :mod:`.fault`; ``nan_batch`` poisons the stream, ``kill_worker``
    SIGKILLs a worker of the process pool (without one it logs a
    warning), ``stall_step`` sleeps in the step's host window, and
    ``ckpt_fail``/``restore_fail`` fail the checkpoint's attempts; any
    other kind raises ``NotImplementedError`` naming its ROADMAP item;
- the loop: one step per iteration, the
  ``Iter [i/T] Lr: [...] Loss: x (tok/s or img/s)`` line every
  ``print_interval`` (``runner.py:1216-1245``), the scheduler stepped
  every iteration (``:1254``), and ``Start valuation`` / ``Acc@1 ... Acc@5
  ... Loss`` at ``val_interval`` and after the last iteration
  (``:1110-1114``, ``:1265-1291``); with ``validation.exact`` the image
  path counts every real validation sample once (``:1293-1334``), by
  default it keeps the reference's per-batch meter over the wrap-padded
  tail.

A run of more than one rank is one process per rank; ``torch.distributed``
gets its address, world size and rank from the caller (NCCL on the card,
gloo on the CPU).  With ``multiprocessing`` the runner spawns one process
per local card (or one on the CPU) per node, as the reference does.

``training.sequence_parallelism`` n > 1 on the LM (JAX ``engine/paths.py``
``_build_ring_sp``, ``topology.py:221-266``): the ranks form a ``(data,
sequence)`` layout of process groups (:class:`..parallel.mesh.SPLayout`,
sequence groups of n consecutive ranks), the samplers are keyed by the
data rank so a sequence group's ranks see one sample set, each rank
stages its ``[B, S/n]`` columns of the host-shifted batch, the model's
attention runs ``model.seq_impl`` (``ring``, the default, or ``ulysses``)
over the sequence group, and the step sums the gradients over the whole
world (:mod:`.sp_steps`); the global batch is ``batch_size`` x data ranks,
and the throughput counts each token once.  The CPU tests are
``tests/test_torch_sp_step.py``; on the card ``python3 chip_smoke.py
--sp`` holds the ring on virtual ranks.

``training.tensor_parallelism`` T > 1 on the LM (JAX ``_build_gspmd``,
``paths.py:140-181``, ``topology.py:149-154``, ``:221-245``): the GSPMD
path, after its checks (:func:`.topology.check_tensor_parallel`, with the
JAX messages); the ranks form a ``(data, model)`` layout
(:class:`..parallel.mesh.TPLayout`, model groups of T consecutive ranks),
the model is this rank's Megatron shard over its model group (a MoE
model's experts split over the same group: T is the expert-parallel
degree), the samplers are keyed by the data rank so a model group's ranks
see one batch, and the step and the validation reduce over the data group
(:mod:`.tp_steps`); the global batch is ``batch_size`` x data ranks.  A
checkpoint holds full leaves (:mod:`.checkpoint`).  LARS and LAMB take
their norms over whole leaves (the step sums a sharded leaf's squares over
the ranks that hold it).
``Runner(num_nodes=W, rank=r, multiprocessing=False, device="cuda",
dist_backend="gloo")`` puts W ranks on ``cuda:0``, the caller's choice
(NCCL takes one rank a card).  The CPU tests are
``tests/test_torch_tensor_parallel.py``; on the card ``python3
chip_smoke.py --tp``.  ``training.expert_parallelism`` is no key of the
JAX package (the expert-parallel degree is ``tensor_parallelism``): the
runner leaves it unread, as the JAX runner does.

``training.zero`` (0-3, ``True`` = 1; :func:`.topology.parse_zero` with the
JAX messages) on the LM takes the GSPMD path too (JAX ``paths.py:290-306``),
alone, beside tensor parallelism or beside MoE: the ranks form the ``(data,
model)`` layout (at ``tensor_parallelism`` 1 the data group is the whole
world) and the step shards the optimizer's moments (1), the gradient
buffers (2) and the parameters (3) over the data group (:mod:`.tp_steps`;
at stage 3 the model is built with the data group and gathers its leaves
at each use); checkpoints still hold full leaves.  The CPU tests are
``tests/test_torch_zero.py``; on the card ``python3 chip_smoke.py --zero``.

``training.pipeline_parallelism`` S > 1 on the LM (JAX ``_build_pipeline``,
``paths.py:84-138``, the first row of its table; ``topology.py:102-158``,
``:336-338``, ``:377-381``): the pipeline path, after its checks with the
JAX messages (:func:`.topology.parse_pipeline`,
:func:`.topology.check_pipeline`, :func:`.topology.check_pipeline_batch`):
the ranks form a ``(data, stage)`` layout (:class:`..parallel.mesh.PPLayout`,
pipelines of S consecutive ranks), grown by a model axis at
``tensor_parallelism`` T > 1 or a sequence axis at ``sequence_parallelism``
> 1 (innermost: ``rank = (data_idx * S + stage_idx) * T + model_idx``), the
model is this rank's stage (its blocks, Megatron-split over the model group
or running their attention over the sequence group, and the shared leaves;
unfused tails, as JAX's stage blocks), every stage of a pipeline reads its
data rank's batch (a sequence rank its columns of it), and the step runs
``training.pp_schedule`` (``gpipe`` or ``1f1b``) over
``training.microbatches`` with ``training.zero`` 1 or 2 over the data group
(:mod:`.pp_steps`); the logged loss is the one summed over the stages,
sequence and data ranks.  A checkpoint holds the per-layer full leaves
(:mod:`.checkpoint`).  The CPU tests are ``tests/test_torch_pipeline.py``
and ``tests/test_torch_pipeline_compose.py``; on the card ``python3
chip_smoke.py --pp``.

Not ported yet: every config key asking for one raises
``NotImplementedError`` naming its ROADMAP item (:data:`UNPORTED_TRAINING_KEYS`):
sequence parallelism beside tensor parallelism, ZeRO or MoE, and ``comm``
(with ZeRO-1 beside ``comm.overlap`` on a dense LM at ``tensor_parallelism``
1, JAX's ``ring-sp-zero1`` path) (P9), telemetry, integrity, elastic
recovery and the checkpoint keys of
:data:`.checkpoint.UNPORTED_CHECKPOINT_KEYS` (P10).
TensorBoard is absent (P10): the log file and the console carry the
metrics.
"""
from __future__ import annotations

import contextlib
import logging
import math
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from logging.handlers import QueueHandler
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..data import (
    DataLoader,
    DistributedShardSampler,
    PinnedStager,
    device_prefetch,
    get_dataset,
    make_iter_dataloader,
)
from ..metrics import AverageMeter
from ..models import get_model, is_resnet
from ..optimizers import get_optimizer
from ..parallel import SEQUENCE_AXIS, PPLayout, SPLayout, TPLayout
from ..schedulers import get_scheduler
from ..utils import make_deterministic
from . import fault
from .checkpoint import Checkpointer, capture_training_state, restore_training_state
from .pp_steps import build_pp_lm_eval_step, build_pp_lm_train_step
from .preemption import PreemptionGuard
from .sp_steps import build_lm_eval_step, build_lm_train_step
from .steps import build_eval_step, build_eval_step_exact, build_train_step
from .topology import (
    check_gspmd_path,
    check_pipeline,
    check_pipeline_batch,
    check_sequence_parallel,
    check_tensor_parallel,
    gspmd_path,
    parse_fault_tolerance,
    parse_model,
    parse_parallelism,
    pipeline_path,
    ring_path,
)
from .tp_steps import build_tp_lm_train_step
from .watchdog import StepWatchdog

__all__ = ["Runner", "UNPORTED_TRAINING_KEYS", "apply_remat_alias"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# training.<key> -> why it raises; a key counts when it is set and truthy
# (a parallelism degree counts above 1)
UNPORTED_TRAINING_KEYS = {
    "sequence_parallelism": ("sequence parallelism beside tensor parallelism, ZeRO or MoE "
                             "is ROADMAP port item P9"),
    "comm": "training.comm (bucketed overlap, ZeRO-1 beside it) is ROADMAP port item P9",
    "telemetry": "the telemetry layer is ROADMAP port item P10",
    "integrity": "the integrity sentinel is ROADMAP port item P10",
    "elastic": "elastic recovery is ROADMAP port item P10",
}
# batches staged on the card ahead of the step (data/prefetch.py)
PREFETCH_DEPTH = 2


def _reject_unported(train_cfg: Dict[str, Any], gspmd: bool = False,
                     ring: bool = False, pipeline: bool = False) -> None:
    for key, why in UNPORTED_TRAINING_KEYS.items():
        val = train_cfg.get(key)
        if key == "comm" and gspmd:
            continue  # the GSPMD path refuses comm.overlap with the JAX message
        if key == "sequence_parallelism" and (ring or pipeline):
            continue  # ported: ring and Ulysses attention over the sequence group
        if key.endswith("parallelism"):
            wanted = val is not None and int(val) > 1
        elif key == "comm":
            wanted = bool((val or {}).get("overlap", False))
        else:
            wanted = bool(val) and val != "none"
        if wanted:
            raise NotImplementedError(f"training.{key}: {why}")


# training.remat -> (model.remat, model.remat_policy) (topology.py:206-211)
_REMAT_ALIAS = {
    "none": (False, "nothing"),
    "block": (True, "nothing"),
    "dots": (True, "dots"),
    "dots_saveable": (True, "dots_saveable"),
}


def apply_remat_alias(train_cfg: Dict[str, Any], model_cfg: Dict[str, Any],
                      model_name: str) -> None:
    """Port of the ``training.remat`` alias (``engine/topology.py:189-212``):
    ``none`` | ``block`` | ``dots`` | ``dots_saveable`` set ``model.remat``
    and ``model.remat_policy`` in ``model_cfg``; setting both sections is a
    ``ValueError``, as is the alias on a model other than the LM."""
    remat = train_cfg.get("remat")
    if remat is None:
        return
    if model_name.lower() != "transformerlm":
        raise ValueError("training.remat is only wired for the LM task "
                         "(model.name: TransformerLM)")
    if "remat" in model_cfg or "remat_policy" in model_cfg:
        raise ValueError("set either training.remat or model.remat/model.remat_policy, "
                         "not both")
    if remat not in _REMAT_ALIAS:
        raise ValueError(f"training.remat must be one of {sorted(_REMAT_ALIAS)}, "
                         f"got {remat!r}")
    model_cfg["remat"], model_cfg["remat_policy"] = _REMAT_ALIAS[remat]


class Runner:
    """Counterpart of the reference Runner (train_distributed.py:89) for the
    LM and image data-parallel paths.

    ``num_nodes``/``rank`` follow the reference CLI: with
    ``multiprocessing`` they count nodes and each node spawns one process
    per local card; without it they are the world size and this process's
    rank (``num_nodes`` <= 1: a single process).  ``on_iter(runner)``, if
    given, is called after every training iteration (after its log line).
    """

    def __init__(self, num_nodes: int, rank: int, seed: Optional[int], dist_url: str,
                 multiprocessing: bool, logger_queue, global_cfg: dict,
                 device: Optional[str] = None, dist_backend: Optional[str] = None,
                 on_iter: Optional[Callable[["Runner"], None]] = None):
        self.num_nodes = num_nodes
        self.rank = rank
        self.seed = seed
        self.dist_url = dist_url
        self.multiprocessing = multiprocessing
        self.logger_queue = logger_queue
        self.global_cfg = global_cfg
        self.device_name = device
        self.dist_backend = dist_backend
        self.on_iter = on_iter
        self.iter = 0
        # seconds each rollback took (restore and stream rebuilt)
        self.rollback_seconds: List[float] = []
        # what the run printed, for callers that drive the runner in-process
        self.train_log: List[Dict[str, float]] = []
        self.val_log: List[Dict[str, float]] = []

    def __call__(self):
        if self.multiprocessing:
            n_local = self._local_procs()
            if n_local > 1:
                torch.multiprocessing.spawn(_spawned_worker, args=(self,), nprocs=n_local)
                return
        self.worker(0)

    def _local_procs(self) -> int:
        if resolve_device(self.device_name).type == "cuda":
            return torch.cuda.device_count()
        return 1

    # ------------------------------------------------------------------ setup
    def worker(self, local_id: int):
        if self.seed is not None:
            make_deterministic(self.seed)
        nodes = max(self.num_nodes or 1, 1)
        if self.multiprocessing:
            n_local = self._local_procs()
            self.world_size = nodes * n_local
            self.current_rank = max(self.rank, 0) * n_local + local_id
        else:
            self.world_size = nodes
            self.current_rank = max(self.rank, 0) if nodes > 1 else 0
        self.device = resolve_device(self.device_name)
        if self.device.type == "cuda":
            self.device = torch.device("cuda", local_id)
            torch.cuda.set_device(self.device)
        self.distributed = self.world_size > 1
        if self.distributed:
            backend = self.dist_backend or ("nccl" if self.device.type == "cuda" else "gloo")
            dist.init_process_group(backend, init_method=self.dist_url,
                                    world_size=self.world_size, rank=self.current_rank)
        self._watchdog = None
        try:
            self._run()
        finally:
            if self._watchdog is not None:
                self._watchdog.close()
            for loader in (getattr(self, "train_loader", None),
                           getattr(self, "val_loader", None)):
                if loader is not None:
                    loader.close()
            if self.distributed:
                dist.destroy_process_group()

    def _setup_logger(self) -> None:
        self.logger = logging.getLogger(f"worker_rank_{self.current_rank}")
        self.logger.propagate = False
        self.logger.handlers.clear()
        if self.logger_queue is not None:
            self.logger.addHandler(QueueHandler(self.logger_queue))
        self.logger.setLevel(logging.INFO)

    def _run(self) -> None:
        self._setup_logger()
        where = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                 else "cpu")
        self.logger.info("Use %d process(es), current rank: %d, device %s (%s)",
                         self.world_size, self.current_rank, self.device, where)
        cfg = self.global_cfg
        train_cfg = cfg["training"]
        model_cfg = parse_model(self, cfg)
        model_name = self.model_name
        parse_parallelism(self, train_cfg)
        ring = ring_path(self, train_cfg)
        # JAX engine/paths.py:290-310: the pipeline first, then a MoE,
        # tensor-parallel or ZeRO LM takes the GSPMD path (sequence
        # parallelism beside them stays P9)
        pipeline = pipeline_path(self)
        gspmd = gspmd_path(self, train_cfg)
        _reject_unported(train_cfg, gspmd=gspmd, ring=ring, pipeline=pipeline)
        parse_fault_tolerance(self, train_cfg)
        self.grad_accum = int(train_cfg.get("grad_accumulation", 1))
        if self.grad_accum < 1:
            raise ValueError(f"grad_accumulation must be >= 1, got {self.grad_accum}")
        if int(train_cfg["batch_size"]) % self.grad_accum != 0:
            raise ValueError(f"per-shard batch ({train_cfg['batch_size']}) not divisible by "
                             f"training.grad_accumulation ({self.grad_accum})")
        check_pipeline_batch(self, int(train_cfg["batch_size"]), self.grad_accum)
        self._setup_faults()
        self.checkpointer = Checkpointer.from_config(
            train_cfg, rank=self.current_rank, world_size=self.world_size)
        self.compute_dtype = _DTYPES[train_cfg.get("dtype", "float32")]
        self.label_smoothing = float(train_cfg.get("label_smoothing", 0.0))
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError(f"label_smoothing must be in [0, 1), got {self.label_smoothing}")

        self.path = ("pipeline" if pipeline else "gspmd" if gspmd else
                     "ring-sp" if self.is_lm else "image-dp")
        if self.path == "gspmd":
            check_gspmd_path(self, train_cfg)
        if self.path == "pipeline":
            check_pipeline(self, train_cfg, model_cfg, get_optimizer(train_cfg["optimizer"]))
        apply_remat_alias(train_cfg, model_cfg, model_name)
        # JAX engine/topology.py:347-352
        ema_cfg = train_cfg.get("ema")
        self.ema_decay = float(ema_cfg["decay"]) if ema_cfg else None
        if self.ema_decay is not None and not 0.0 < self.ema_decay < 1.0:
            raise ValueError(f"ema.decay must be in (0, 1), got {self.ema_decay}")
        if self.ema_decay is not None and self.is_lm:
            raise ValueError("training.ema is only wired for the image task")
        ds_kwargs = dict(n_classes=cfg["dataset"]["n_classes"],
                         n_samples=cfg["dataset"].get("n_samples"),
                         seq_len=cfg["dataset"].get("seq_len"),
                         image_size=cfg["dataset"].get("image_size", 224))
        train_dataset = get_dataset(cfg["dataset"]["name"], cfg["dataset"].get("root", ""),
                                    split="train", **ds_kwargs)
        val_dataset = get_dataset(cfg["dataset"]["name"], cfg["dataset"].get("root", ""),
                                  split="val", **ds_kwargs)
        self._build_layout(train_dataset)
        if self.is_lm:
            self._build_lm_model(model_name, model_cfg, train_dataset)
        else:
            self._build_image_model(model_name, model_cfg, ds_kwargs["image_size"])

        # reference parity (train_distributed.py:194): batch_size is per
        # process, one process per card; a sequence group's ranks share
        # their batch, each holding its columns
        self.host_batch = int(train_cfg["batch_size"])
        self.global_batch = self.host_batch * self.data_size
        optimizer_params = dict(train_cfg["optimizer"])
        optimizer_cls = get_optimizer(optimizer_params)
        optimizer_params.pop("name")
        self.optimizer = optimizer_cls(**optimizer_params)
        self.logger.info("Loaded optimizer: %s(%s)", optimizer_cls.__name__, optimizer_params)
        self.scheduler = get_scheduler(self.optimizer, train_cfg["lr_schedule"])

        seed = self.seed if self.seed is not None else 0
        # keyed by the data rank: the ranks of a sequence group see one sample set
        train_sampler = DistributedShardSampler(
            len(train_dataset), self.data_size, self.data_rank, shuffle=True,
            drop_last=True, seed=seed)
        val_sampler = DistributedShardSampler(
            len(val_dataset), self.data_size, self.data_rank, shuffle=False, seed=seed)
        # JAX runner.py:264-274: uint8 batches, normalised on the card
        self.device_normalize = bool(train_cfg.get("device_normalize", False))
        if self.device_normalize and (self.is_lm
                                      or getattr(train_dataset, "norm_mean", None) is None):
            raise ValueError("training.device_normalize requires an image dataset with "
                             "norm_mean/norm_std (e.g. imagenet)")
        input_norm = ((train_dataset.norm_mean, train_dataset.norm_std)
                      if self.device_normalize else None)
        self._build_loaders(train_cfg, train_dataset, val_dataset, train_sampler, val_sampler)
        self.logger.info(
            "Load dataset done\nTraining: %d samples, %d batches\nEval: %d samples, %d batches",
            len(train_dataset), len(self.train_loader), len(val_dataset), len(self.val_loader))
        self._val_len = len(val_dataset)
        self._stager = (PinnedStager(self.device, PREFETCH_DEPTH)
                        if self.device.type == "cuda" else None)
        self.exact_eval = bool(cfg.get("validation", {}).get("exact", False))
        anomaly_factor = self.anomaly_factor if self.anomaly_enabled else None
        if self.is_lm and self.exact_eval:
            self.logger.warning("validation.exact applies to the image eval path; LM "
                                "validation keeps the per-batch meter semantics")
        if self.is_lm:
            # the step's reduce: the data group under tensor parallelism and
            # the pipeline, else the whole world (data and sequence ranks)
            grid = isinstance(self.layout, (TPLayout, PPLayout))
            world, group = ((self.data_size, self.layout.data_group) if grid
                            else (self.world_size, None))
            if self.path == "pipeline":
                self.train_step = build_pp_lm_train_step(
                    self.model, self.optimizer, self.scheduler.lr_fn,
                    self.layout.stage_exchange, self.microbatches, self.pp_schedule,
                    world_size=world, group=group, label_smoothing=self.label_smoothing,
                    zero=self.zero)
            elif self.path == "gspmd":
                self.train_step = build_tp_lm_train_step(
                    self.model, self.optimizer, self.scheduler.lr_fn,
                    world_size=world, group=group, grad_accum=self.grad_accum,
                    label_smoothing=self.label_smoothing, zero=self.zero)
            else:
                self.train_step = build_lm_train_step(
                    self.model, self.optimizer, self.scheduler.lr_fn,
                    world_size=world, grad_accum=self.grad_accum,
                    label_smoothing=self.label_smoothing, anomaly_factor=anomaly_factor)
            self.eval_step = (
                build_pp_lm_eval_step(self.model, self.layout.stage_exchange, self.microbatches,
                                      world_size=world, group=group, logger=self.logger)
                if self.path == "pipeline" else
                build_lm_eval_step(self.model, world_size=world, group=group,
                                   micro_batches=self.grad_accum))
        else:
            self.train_step = build_train_step(
                self.model, self.optimizer, self.scheduler.lr_fn, world_size=self.world_size,
                sync_bn=self.sync_bn, grad_accum=self.grad_accum,
                label_smoothing=self.label_smoothing, anomaly_factor=anomaly_factor,
                input_norm=input_norm, ema_decay=self.ema_decay)
            self.eval_step = build_eval_step(self.model, world_size=self.world_size,
                                             input_norm=input_norm)
            self.eval_step_exact = build_eval_step_exact(
                self.model, world_size=self.world_size, input_norm=input_norm)
        self._setup_checkpoint(train_cfg)
        if self.watchdog_exit and self._preempt is None:
            raise ValueError("fault_tolerance.watchdog.checkpoint_and_exit needs the preemption "
                             "path: configure training.checkpoint.dir and leave "
                             "checkpoint.preemption enabled")
        if self.watchdog_enabled:
            self._watchdog = StepWatchdog(
                factor=self.watchdog_factor, min_seconds=self.watchdog_min_seconds,
                window=self.watchdog_window, warmup=self.watchdog_warmup,
                poll_seconds=self.watchdog_poll, on_hang=self._on_hang, logger=self.logger)
        with self._preempt if self._preempt is not None else contextlib.nullcontext():
            self._train_loop(train_cfg)

    # ------------------------------------------------------- fault tolerance
    def _setup_faults(self) -> None:
        """The injector (``PDT_FAULT_SPEC`` if set, else the config's spec),
        refused when it arms a kind the port cannot recover from, and the
        guard's host state: the norms of the applied steps only, so a spike
        never becomes its own reference (JAX ``runner.py:206-217``).  Each
        runner installs its own injector, so a runner never inherits the
        faults of one that ran before it in the process."""
        spec = os.environ.get(fault.ENV_VAR) or self.fault_spec
        fault.check_ported(fault.FaultInjector(spec))
        self._injector = fault.install(spec)
        if self._injector.active:
            self.logger.warning("fault injection ACTIVE: %s", self._injector.spec)
        self._gnorm_hist: deque = deque(maxlen=self.anomaly_window)
        self._consec_anomalies = 0

    def _make_stream(self):
        """The training stream from the current position: the epoch
        iterator (resumed at ``_epoch``/``_batch_in_epoch``), the
        ``nan_batch`` faults, then the batches staged on the device
        (JAX ``runner.py:668-686``).  Returns (host stream, device batches)."""
        host = make_iter_dataloader(self.train_loader, start_iter=self.iter,
                                    start_epoch=self._epoch, skip_batches=self._batch_in_epoch)
        fed = host
        if self._injector.active:
            fed = fault.poison_batches(host, self._injector, start_iter=self.iter,
                                       logger=self.logger)
        return host, self._device_batches(fed)

    def _apply_step_faults(self) -> None:
        """The host-side faults keyed to this iteration (JAX
        ``runner.py:688-730``); ``nan_batch`` lives in the stream."""
        inj = self._injector
        if not inj.active:
            return
        w = inj.take("kill_worker", self.iter)
        if w is not None:
            pool = getattr(self.train_loader, "_pool", None)
            if pool is None:
                self.logger.warning("fault injection: kill_worker@%d ignored — the loader has "
                                    "no process pool (worker_mode)", self.iter)
            else:
                wid = int(w) % pool.num_workers
                pid = pool._procs[wid].pid
                self.logger.warning("fault injection: SIGKILL loader worker %d (pid %d) at "
                                    "step %d", wid, pid, self.iter)
                os.kill(pid, signal.SIGKILL)
        s = inj.take("stall_step", self.iter)
        if s is not None:
            self.logger.warning("fault injection: stalling step %d for %.2fs", self.iter, s)
            time.sleep(float(s))

    def _on_hang(self, step: int, elapsed: float, limit: float) -> None:
        """The watchdog's report (its monitor thread): the step, the loader
        pool's outstanding tasks and every thread's stack; with
        ``checkpoint_and_exit`` the preemption flag (JAX ``runner.py:741-790``)."""
        fault.bump("watchdog_fires")
        pool = getattr(self.train_loader, "_pool", None)
        median = self._watchdog.trailing_median()
        self.logger.error("watchdog: rank %d stuck in step %d for %.1fs (limit %.1fs, trailing "
                          "median %.3fs); loader pool tasks outstanding: %s", self.current_rank,
                          step, elapsed, limit, -1.0 if median is None else median,
                          getattr(pool, "_outstanding", "n/a"))
        names = {t.ident: t.name for t in threading.enumerate()}
        dump = [f"Thread {names.get(tid, '?')} (id {tid}):\n" + "".join(traceback.format_stack(f))
                for tid, f in sys._current_frames().items()]
        self.logger.error("watchdog stack dump:\n%s", "\n".join(dump))
        if self.watchdog_exit and self._preempt is not None:
            self.logger.error("watchdog: requesting checkpoint-and-exit via the preemption flag")
            self._preempt.triggered = True

    def _rollback(self) -> None:
        """``max_consecutive`` anomalous steps: restore the newest
        checkpoint and resume from it (JAX ``runner.py:852-903``); the
        one-shot faults stay consumed, so the replay runs clean."""
        fault.bump("rollbacks")
        if self.checkpointer is None:
            raise RuntimeError(f"{self._consec_anomalies} consecutive anomalous steps at iter "
                               f"{self.iter} and no training.checkpoint configured to roll back "
                               "to")
        self.logger.error("anomaly guard: %d consecutive anomalous steps at iter %d — rolling "
                          "back to the last checkpoint", self._consec_anomalies, self.iter)
        t0 = time.perf_counter()
        start_iter = self.checkpointer.restore_latest(
            lambda payload: restore_training_state(payload, self.model, self.train_step),
            self.device, self.logger)
        # a restore handing back non-finite parameters would trip the guard
        # again and loop rollback -> restore for ever
        if not all(bool(torch.isfinite(p).all()) for p in self.train_step.params):
            raise RuntimeError(f"rollback restore of step {start_iter} returned non-finite "
                               "parameters — checkpoint or restore path is corrupt")
        self.iter = start_iter
        self.scheduler.last_epoch = start_iter
        self._init_pipeline_position()
        self._consec_anomalies = 0
        self._gnorm_hist.clear()
        if self._watchdog is not None:
            self._watchdog.reset()
        self.rollback_seconds.append(time.perf_counter() - t0)

    def _build_loaders(self, train_cfg, train_dataset, val_dataset, train_sampler,
                       val_sampler) -> None:
        """The loaders of both paths (JAX ``runner.py:219-310``): the backend
        of ``training.worker_mode``, ``num_workers`` shared among the cards
        of the node (one process each), and on the image path uint8
        batches with ``device_normalize`` and ``dct_denom`` for training
        only (validation decodes at full fidelity).  The validation loader
        reuses the training batch size (reference :235-241)."""
        cards = torch.cuda.device_count() if self.device.type == "cuda" else 1
        workers = max(1, int(train_cfg.get("num_workers", 0)) // cards)
        dct_denom = int(train_cfg.get("dct_denom", 1))
        if dct_denom not in (0, 1, 2, 4, 8):
            raise ValueError(f"training.dct_denom must be 0 (auto), 1, 2, 4, or 8; "
                             f"got {dct_denom}")
        common = dict(num_workers=workers, worker_mode=train_cfg.get("worker_mode", "auto"),
                      output_dtype="uint8" if self.device_normalize else "float32")
        self.train_loader = DataLoader(train_dataset, self.host_batch, train_sampler,
                                       drop_last=True, dct_denom=dct_denom, **common)
        self.val_loader = DataLoader(val_dataset, self.host_batch, val_sampler,
                                     drop_last=False, **common)
        self.logger.info("Loader: %s mode, %d worker(s) a process (num_workers %s over %d "
                         "card(s))%s", self.train_loader.worker_mode, workers,
                         train_cfg.get("num_workers", 0), cards,
                         "" if self.is_lm else f", {common['output_dtype']} batches")

    # ------------------------------------------------------------ checkpoint
    def _setup_checkpoint(self, train_cfg) -> None:
        """``training.checkpoint`` (JAX ``runner.py:340-363``, ``:443-485``):
        restore the newest step, or refuse a populated directory with
        ``resume: false``; the pipeline position; the preemption guard."""
        self._preempt = None
        self._preempt_sync = 10
        if self.checkpointer is not None:
            ck = train_cfg["checkpoint"]
            if ck.get("resume", True):
                self.iter = self.checkpointer.restore_latest(
                    lambda payload: restore_training_state(payload, self.model, self.train_step),
                    self.device, self.logger)
                self.scheduler.last_epoch = self.iter
                if self.iter:
                    self.logger.info("Resumed from checkpoint step %d at %s", self.iter - 1,
                                     self.checkpointer.directory)
            elif self.checkpointer.latest() is not None:
                raise ValueError(
                    f"checkpoint dir {self.checkpointer.directory} already has step "
                    f"{self.checkpointer.latest()} but resume is False — clear the directory "
                    "or point checkpoint.dir elsewhere")
            if ck.get("preemption", True):
                self._preempt = PreemptionGuard(
                    PreemptionGuard.parse_signals(ck.get("preemption_signals", ("SIGTERM",))),
                    logger=self.logger)
                self._preempt_sync = int(ck.get("preemption_sync_interval", 10))
                if self._preempt_sync < 1:
                    raise ValueError(f"checkpoint.preemption_sync_interval must be >= 1, got "
                                     f"{self._preempt_sync}")
        self._init_pipeline_position()

    def _init_pipeline_position(self) -> None:
        """(``_epoch``, ``_batch_in_epoch``) of the next batch: the resumed
        step's sidecar, else ``divmod(iter, batches an epoch)`` (JAX
        ``runner.py:611-643``)."""
        self._batches_per_epoch = len(self.train_loader)
        self._epoch, self._batch_in_epoch = divmod(self.iter, self._batches_per_epoch)
        if self.checkpointer is None or self.iter == 0:
            return
        extras = self.checkpointer.read_extras(self.iter - 1)
        if extras is None:
            return
        saved_bpe = int(extras.get("batches_per_epoch", self._batches_per_epoch))
        if saved_bpe != self._batches_per_epoch:
            self.logger.warning(
                "pipeline sidecar was written with %d batches/epoch but this run yields %d — "
                "resuming at its recorded position, but the batches may differ from an "
                "uninterrupted run's", saved_bpe, self._batches_per_epoch)
        self._epoch = int(extras["epoch"])
        self._batch_in_epoch = int(extras["batch_in_epoch"])
        self.logger.info("pipeline position restored from sidecar: epoch %d, %d/%d batches "
                         "consumed", self._epoch, self._batch_in_epoch, self._batches_per_epoch)

    def _pipeline_extras(self) -> dict:
        """The sidecar of a save (JSON)."""
        return {"epoch": int(self._epoch), "batch_in_epoch": int(self._batch_in_epoch),
                "seed": int(self.seed) if self.seed is not None else 0,
                "world_processes": int(self.world_size),
                "batches_per_epoch": int(self._batches_per_epoch)}

    def _advance_pipeline(self) -> None:
        """One training batch consumed."""
        self._batch_in_epoch += 1
        if self._batch_in_epoch >= self._batches_per_epoch:
            self._epoch += 1
            self._batch_in_epoch = 0

    def _save_checkpoint(self) -> None:
        """Save the state after the current iteration (every rank calls it)."""
        self.checkpointer.save(
            self.iter, capture_training_state(self.model, self.train_step, self.iter),
            extras=self._pipeline_extras())

    def _globally_preempted(self) -> bool:
        """Whether to act on a latched signal at this iteration: at one rank
        the flag itself; with more, every ``preemption_sync_interval``
        iterations all ranks sum their flags in one all-reduce (the same
        iterations on every rank, so the collectives match) and act on the
        OR (JAX ``runner.py:1141-1158``)."""
        if self.world_size == 1:
            return self._preempt.triggered
        if (self.iter + 1) % self._preempt_sync != 0:
            return False
        flag = torch.tensor([float(self._preempt.triggered)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.SUM)
        return bool(flag.item() > 0)

    def _build_layout(self, train_dataset) -> None:
        """The ``(data, sequence)`` layout of the ranks (:mod:`..parallel.mesh`)
        on the ring path, after JAX's checks (:func:`.topology.check_sequence_parallel`),
        or the ``(data, model)`` layout under tensor parallelism
        (:func:`.topology.check_tensor_parallel`) or ZeRO at more than one
        rank; else one data rank a process.  A rank's columns of each LM
        batch are ``self._columns``; labels are shifted on the host before
        the slice, since the shift crosses shard boundaries (JAX
        ``sp_steps.py:21-23``)."""
        self.layout, self._columns = None, None
        self.data_rank, self.data_size = self.current_rank, self.world_size
        if self.path == "pipeline":
            if self.world_size % self.pipe_par != 0:
                raise ValueError(f"training.pipeline_parallelism ({self.pipe_par}) must divide "
                                 f"the number of ranks ({self.world_size})")
            seq_len = int(train_dataset[0][0].shape[0])
            if self.tensor_par > 1:
                check_tensor_parallel(self, self.global_cfg["model"], self.world_size)
            if self.seq_par > 1:
                check_sequence_parallel(self, seq_len, self.world_size)
            self.layout = lay = PPLayout(self.world_size, self.current_rank, self.pipe_par,
                                         self.tensor_par, self.seq_par)
            self.data_rank, self.data_size = lay.data_idx, lay.n_data
            if lay.n_seq > 1:
                s_local = seq_len // lay.n_seq
                self._columns = slice(lay.seq_idx * s_local, (lay.seq_idx + 1) * s_local)
            axis = ("model" if lay.n_model > 1 else "sequence") if lay.n_inner > 1 else ""
            self.logger.info(
                "Pipeline parallelism: data x stage%s = %d x %d%s, rank %d at (%d, %d%s), %s "
                "schedule over %d microbatches of %d rows%s%s", f" x {axis}" if axis else "",
                lay.n_data, lay.n_stage, f" x {lay.n_inner}" if axis else "", self.current_rank,
                lay.data_idx, lay.stage_idx, f", {lay.inner_idx}" if axis else "",
                self.pp_schedule, self.microbatches,
                int(self.global_cfg["training"]["batch_size"]) // self.microbatches,
                f", ZeRO-{self.zero} over the data group" if self.zero else "",
                ", hops staged through pinned host memory"
                if lay.stage_exchange.host_staged and self.device.type == "cuda" else "")
            return
        if self.tensor_par > 1 or (self.zero and self.world_size > 1):
            check_tensor_parallel(self, self.global_cfg["model"], self.world_size)
            self.layout = lay = TPLayout(self.world_size, self.current_rank, self.tensor_par)
            self.data_rank, self.data_size = lay.data_idx, lay.n_data
            self.logger.info("Tensor parallelism: data x model = %d x %d, rank %d at (%d, %d)%s%s",
                             lay.n_data, lay.n_model, self.current_rank, lay.data_idx,
                             lay.model_idx, ", experts split over the model group"
                             if self.is_moe and lay.n_model > 1 else "",
                             f", ZeRO-{self.zero} over the data group" if self.zero else "")
            return
        if self.seq_par <= 1:
            return
        seq_len = int(train_dataset[0][0].shape[0])
        check_sequence_parallel(self, seq_len, self.world_size)
        self.layout = SPLayout(self.world_size, self.current_rank, self.seq_par)
        lay = self.layout
        self.data_rank, self.data_size = lay.data_idx, lay.n_data
        s_local = seq_len // lay.n_seq
        self._columns = slice(lay.seq_idx * s_local, (lay.seq_idx + 1) * s_local)
        self.logger.info("Sequence parallelism: data x sequence = %d x %d, rank %d at (%d, %d), "
                         "%d of %d tokens a sample", lay.n_data, lay.n_seq, self.current_rank,
                         lay.data_idx, lay.seq_idx, s_local, seq_len)

    def _build_lm_model(self, model_name: str, model_cfg: dict, train_dataset) -> None:
        self.seq_len = int(train_dataset[0][0].shape[0])
        self.unit, self.items_per_sample = "tok", self.seq_len
        model_cfg.setdefault("max_len", self.seq_len)
        if isinstance(self.layout, PPLayout):
            model_cfg["stage_group"] = self.layout.stage
            # JAX _stage_applies builds the stage's blocks without fused tails
            model_cfg["fused_tails"] = False
            if self.layout.tensor_group is not None:
                model_cfg["tensor_group"] = self.layout.tensor_group
            if self.layout.seq_exchange is not None:
                if model_cfg.get("seq_axis", SEQUENCE_AXIS) != SEQUENCE_AXIS:
                    raise ValueError(f"model.seq_axis must be {SEQUENCE_AXIS!r}, got "
                                     f"{model_cfg['seq_axis']!r}")
                model_cfg["seq_axis"] = self.layout.seq_exchange
        elif isinstance(self.layout, TPLayout):
            model_cfg["tensor_group"] = self.layout.tensor_group
            if self.zero >= 3 and self.layout.n_data > 1:
                model_cfg["zero_group"] = self.layout.zero_group
        elif self.layout is not None:
            # JAX topology.py:256-266 names the mesh axis; here it is the group
            if model_cfg.get("seq_axis", SEQUENCE_AXIS) != SEQUENCE_AXIS:
                raise ValueError(f"model.seq_axis must be {SEQUENCE_AXIS!r}, got "
                                 f"{model_cfg['seq_axis']!r}")
            model_cfg["seq_axis"] = self.layout.seq_exchange
        self.model = get_model(model_name, num_classes=self.global_cfg["dataset"]["n_classes"],
                               dtype=self.compute_dtype, flash=True, **model_cfg)
        if self.pretrained:
            self._apply_pretrained_lm()
        self.model.to(self.device).train()
        m = self.model
        moe = (f", MoE in {sum(b.is_moe for b in m.blocks)} of {m.depth} blocks "
               f"({m.moe_experts} experts, {self.path} path)" if self.is_moe else "")
        sp = (f", {m.seq_impl} attention over the sequence group"
              if m.seq_axis is not None else
              f", tensor parallel over {self.tensor_par} ranks" if self.tensor_par > 1 else "")
        if m.zero_plan is not None:
            sp += f", ZeRO-3: this rank's slices of the leaves ({self.data_size} data ranks)"
        if m.stage_group is not None:
            sp += (f", pipeline stage {m.stage_group.rank} of {m.stage_group.size} (blocks "
                   f"{m.block_ids.start}-{m.block_ids.stop - 1}, unfused tails)")
        self.logger.info("Model %s: %.1f M parameters, compute %s, flash attention on%s%s%s",
                         model_name, sum(p.numel() for p in m.parameters()) / 1e6,
                         str(self.compute_dtype).replace("torch.", ""),
                         f", remat ({m.remat_policy})" if m.remat else "", moe, sp)

    def _build_image_model(self, model_name: str, model_cfg: dict, image_size: int) -> None:
        from ..models import ViT

        self.unit, self.items_per_sample = "img", 1
        # JAX engine/topology.py:81: synchronized statistics only across ranks
        self.sync_bn = bool(self.global_cfg["training"]["sync_bn"]) and self.distributed
        kwargs = dict(model_cfg)
        if not is_resnet(model_name):
            # a ViT: flax sizes its position table from the init batch's images
            kwargs.setdefault("image_size", image_size)
        self.model = get_model(model_name, num_classes=self.global_cfg["dataset"]["n_classes"],
                               dtype=self.compute_dtype, sync_bn=self.sync_bn, **kwargs)
        if self.pretrained:
            self._apply_pretrained_image()
        layout = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        self.model.to(self.device, memory_format=layout).train()
        self.logger.info("Model %s: %.1f M parameters, compute %s, %s", model_name,
                         sum(p.numel() for p in self.model.parameters()) / 1e6,
                         str(self.compute_dtype).replace("torch.", ""),
                         "no BatchNorm" if isinstance(self.model, ViT) else
                         "BatchNorm statistics " + ("synchronized over the ranks" if self.sync_bn
                                                    else "local"))

    # ------------------------------------------------- pretrained ingestion
    def _load_torch_state_dict(self) -> dict:
        """``model.pretrained`` read as a torch ``state_dict`` mapping (JAX
        ``runner.py:536-555``)."""
        path = self.pretrained
        if not os.path.exists(path):
            raise FileNotFoundError(f"model.pretrained: checkpoint '{path}' does not exist")
        state_dict = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(state_dict, dict) and "state_dict" in state_dict:
            state_dict = state_dict["state_dict"]  # harness checkpoints nest it
        if not isinstance(state_dict, dict):
            raise ValueError(f"model.pretrained: '{path}' does not contain a state_dict "
                             f"mapping (got {type(state_dict).__name__})")
        return state_dict

    def _apply_pretrained_image(self) -> None:
        """The model's parameters (and a ResNet's running statistics) from
        a torchvision checkpoint (JAX ``runner.py:557-597``)."""
        from ..models import ResNet, ViT
        from ..models.torch_port import (import_torch_resnet_state_dict,
                                         import_torch_vit_state_dict)

        if not isinstance(self.model, (ResNet, ViT)):
            # the family check before the (possibly multi-GB) torch.load
            raise ValueError(f"model.pretrained: only the ResNet and ViT families have a "
                             f"torchvision state_dict layout (got model.name: {self.model_name})")
        state_dict = self._load_torch_state_dict()
        template = self.model.state_dict()
        if isinstance(self.model, ResNet):
            loaded = import_torch_resnet_state_dict(template, state_dict)
        else:
            loaded = import_torch_vit_state_dict(template, state_dict,
                                                 num_heads=self.model.num_heads)
        self.model.load_state_dict(loaded, strict=True)
        self.logger.info("Initialized %s from pretrained torch checkpoint %s", self.model_name,
                         self.pretrained)

    def _apply_pretrained_lm(self) -> None:
        """The LM's parameters from a torch-twin checkpoint (JAX
        ``runner.py:599-610``)."""
        from ..models.torch_port import import_torch_lm_state_dict

        with torch.device("meta"):  # the full model's names and shapes
            template = self.model.clone(tensor_group=None, zero_group=None).state_dict()
        self.model.load_full_state_dict(
            import_torch_lm_state_dict(template, self._load_torch_state_dict()))
        self.logger.info("Initialized %s from pretrained torch checkpoint %s", self.model_name,
                         self.pretrained)

    # ------------------------------------------------------------- hot loop
    def _stage(self, inp: np.ndarray, label: np.ndarray):
        """Start one host batch's way to the device: tokens (int64), NHWC
        images (uint8 as they come, else float32) and int64 labels."""
        label = np.asarray(label, dtype=np.int64)
        if self.is_lm:
            inp = np.asarray(inp, dtype=np.int64)
            if self._columns is not None:
                inp = np.ascontiguousarray(inp[:, self._columns])
                label = np.ascontiguousarray(label[:, self._columns])
        elif np.asarray(inp).dtype != np.uint8:
            inp = np.asarray(inp, dtype=np.float32)
        if self._stager is not None:
            return self._stager.put(inp, label)
        return torch.from_numpy(inp), torch.from_numpy(label)

    def _take(self, staged):
        return self._stager.take(staged) if self._stager is not None else staged

    def _to_device(self, inp: np.ndarray, label: np.ndarray):
        """One host batch on the device, ready for the current stream."""
        return self._take(self._stage(inp, label))

    def _device_batches(self, host_iter):
        """``host_iter``'s batches on the device, ``PREFETCH_DEPTH`` staged ahead."""
        for staged in device_prefetch(host_iter, self._stage, PREFETCH_DEPTH):
            yield self._take(staged)

    def _train_loop(self, train_cfg) -> None:
        self._tput_t0 = time.monotonic()
        self._tput_iters = 0
        host, batches = self._make_stream()
        try:
            while self.iter < train_cfg["train_iters"]:
                if self._watchdog is not None:
                    self._watchdog.step_started(self.iter)
                self._apply_step_faults()
                self.train_iter(*next(batches))
                self._advance_pipeline()
                if self._watchdog is not None:
                    self._watchdog.step_finished()
                if self.anomaly_enabled and self._consec_anomalies >= self.anomaly_max_consec:
                    batches.close()
                    host.close()
                    self._rollback()
                    host, batches = self._make_stream()
                    continue
                if self.on_iter is not None:
                    self.on_iter(self)
                if self._preempt is not None and self._globally_preempted():
                    self.logger.warning("Preemption signal received: saving checkpoint at "
                                        "iter %d and exiting", self.iter)
                    self._save_checkpoint()
                    return
                p1 = self.iter != 0
                p2 = (self.iter + 1) % train_cfg["val_interval"] == 0
                p3 = self.iter == train_cfg["train_iters"] - 1
                if (p1 and p2) or p3:
                    self.validate()
                if self.checkpointer is not None and self.checkpointer.should_save(
                        self.iter, train_cfg["train_iters"]):
                    self._save_checkpoint()
                self.iter += 1
        finally:
            batches.close()
            host.close()  # stops the loader's producer

    def train_iter(self, inputs, labels) -> None:
        train_cfg = self.global_cfg["training"]
        if self.anomaly_enabled:
            # the guard's verdict is one host read a step (JAX runner.py:1183-1212)
            ref = float(np.median(self._gnorm_hist)) if self._gnorm_hist else 0.0
            loss, gnorm, applied = self.train_step(inputs, labels, ref)
            if applied:
                self._gnorm_hist.append(gnorm)
                self._consec_anomalies = 0
            else:
                self._consec_anomalies += 1
                fault.bump("skipped_steps")
                self.logger.warning("anomaly guard: step %d SKIPPED (loss=%g grad_norm=%g, "
                                    "trailing median %g) — %d consecutive", self.iter,
                                    float(loss), gnorm, ref, self._consec_anomalies)
        else:
            loss = self.train_step(inputs, labels)
        self.last_loss = loss  # a device scalar: reading it syncs
        self._tput_iters += 1
        if self.iter % train_cfg["print_interval"] == 0:
            loss_val = float(loss)  # the loop's only host<->device sync
            last_lr_group = self.scheduler.get_last_lr()
            now = time.monotonic()
            # the first window holds the one-time set-up costs: no rate
            rate = (None if self.iter == 0 else
                    self.global_batch * self.items_per_sample * self._tput_iters
                    / max(now - self._tput_t0, 1e-9))
            self._tput_t0, self._tput_iters = now, 0
            unit = self.unit
            self.train_log.append({"iter": self.iter, "loss": loss_val, "lr": last_lr_group[0],
                                   f"{unit}_per_s": rate})
            if not math.isfinite(loss_val):
                self.logger.warning("Iter %d: loss is %s", self.iter, loss_val)
            if self.current_rank == 0:
                tput = ("" if rate is None else
                        f" ({rate:.1f} {unit}/s, {rate / self.world_size:.1f} {unit}/s/card)")
                self.logger.info("Iter [%d/%d] Lr: %s Loss: %.4f%s", self.iter,
                                 train_cfg["train_iters"], last_lr_group, loss_val, tput)
        self.scheduler.step()  # every iteration (:299)

    # ------------------------------------------------------------ validation
    def validate(self) -> None:
        if self.current_rank == 0:
            self.logger.info("Start valuation")
        self.model.eval()
        try:
            with self._eval_weights():
                if self.exact_eval and not self.is_lm:
                    record = self._validate_exact()
                else:
                    record = self._validate_parity()
        finally:
            self.model.train()
        self.val_log.append(dict(iter=self.iter, **record))
        if self.current_rank == 0:
            self.logger.info("Acc@1: %.4f, Acc@5: %.4f, Loss: %.5f",
                             record["acc1"], record["acc5"], record["loss"])

    @contextlib.contextmanager
    def _eval_weights(self):
        """With the weight EMA, its values in the parameters for the
        validation (the BatchNorm running statistics stay the model's, as
        JAX ``state.replace(params=state.ema)`` keeps them), the trained
        values copied back afterwards, bit for bit."""
        ema = getattr(self.train_step, "ema", None)
        if ema is None:
            yield
            return
        params = self.train_step.params
        with torch.no_grad():
            trained = [p.detach().clone(memory_format=torch.preserve_format) for p in params]
            torch._foreach_copy_(params, ema)
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(params, trained)

    def _validate_parity(self) -> dict:
        """The reference's per-batch meter: every batch weighs the same, the
        wrap-padded tail counted again."""
        loss_meter, top_1, top_5 = AverageMeter(), AverageMeter(), AverageMeter()
        for img, label in self._device_batches(iter(self.val_loader)):
            loss, acc1, acc5 = self.eval_step(img, label)
            loss_meter.update(float(loss))
            top_1.update(float(acc1))
            top_5.update(float(acc5))
        return dict(loss=loss_meter.value(), acc1=top_1.value(), acc5=top_5.value())

    def _validate_exact(self) -> dict:
        """``validation.exact`` (JAX ``runner.py:1293-1334``): per-sample sums
        under a position mask, one read at the end.  Local position p is
        the sampler's global slot ``rank + world * p``; the slots past the
        dataset's length, and the loader's wrap-pad of its last batch, are
        the positions from ``n_real`` on."""
        n_real = max(0, -(-(self._val_len - self.current_rank) // self.world_size))
        totals = torch.zeros(4, dtype=torch.float64, device=self.device)
        seen = 0
        for img, label in self._device_batches(iter(self.val_loader)):
            b = label.shape[0]
            mask = torch.arange(seen, seen + b, device=self.device) < n_real
            seen += b
            totals += self.eval_step_exact(img, label, mask).double()
        ce, top1, top5, n = totals.tolist()
        n_div = max(n, 1.0)
        return dict(loss=ce / n_div, acc1=100.0 * top1 / n_div, acc5=100.0 * top5 / n_div,
                    n=int(n))


def _spawned_worker(local_id: int, runner: Runner) -> None:
    runner.worker(local_id)
