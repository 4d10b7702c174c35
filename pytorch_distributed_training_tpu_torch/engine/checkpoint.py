"""Checkpoint and resume of the training runner, in the port's own format.

The JAX package checkpoints through orbax (``engine/checkpoint.py``),
which the port cannot read without JAX (ROADMAP P7b).  The port writes its
own: under ``training.checkpoint.dir``

- ``<step>/state.pt``: one ``torch.save`` payload, the state after
  iteration ``step`` (:func:`capture_training_state`): the model's
  ``state_dict`` (f32 parameters and BatchNorm buffers), the optimizer's
  slots by parameter name (never by position) and its step count, the
  weight EMA by name, and the iteration;
- ``pipeline_<step>.json``: the input pipeline's position, ``epoch``,
  ``batch_in_epoch``, ``seed``, ``world_processes`` and
  ``batches_per_epoch`` (JAX ``:515-575``), so a resume starts on the
  next unseen batch.

A save writes the payload into ``<step>.tmp-<pid>`` and commits it with
one ``os.rename``; only all-digit directories are steps, so a save cut
short leaves a directory that :meth:`Checkpointer.restore_latest` never
sees.  The sidecar is written after the commit, then ``max_to_keep``
prunes the oldest steps with their sidecars.  The state is replicated
under data parallelism: rank 0 writes, every rank waits at a barrier,
and every rank restores, with ``weights_only=True`` onto its device.  A
newest step that does not load falls back to the one before it, with a
warning; only when every step fails does the newest step's error raise
(JAX ``:793-839``).

A tensor-parallel or ZeRO run (a model with a ``tensor_group``, a step
with a ``zero_plan``) saves **full leaves**, parameters and optimizer slots
alike, gathered over the data group (ZeRO's slices), then over the model
group on every rank, and written once by rank 0, and restores by slicing
the other way (:mod:`..parallel.tensor`): the payload is the one-rank
run's, as JAX's global arrays carry no layout, so it resumes at any tensor
parallelism and ZeRO stage, restores at 1 and serves on one card.  A
pipeline stage (a model with a ``stage_group``) gathers its blocks'
parameters and slots over the stage group the same way (the shared leaves
are equal on every stage), rank 0 writes the per-layer leaves, and each
stage restores its own blocks; JAX writes the stacked tree, and a restore
at another stage count is the layout-converting restore (P10).

Config keys (JAX ``:275-306``): ``dir`` (required to enable), ``interval``
(1000), ``max_to_keep`` (3), ``resume`` (True), ``retry`` (``attempts``
3, ``backoff`` 0.25, ``max_backoff`` 8.0, ``jitter`` 0.25,
``total_timeout_s``; JAX ``:205-301``): each save's write and each step's
load run under a :class:`..utils.retry.Retry`, behind the fault points
``ckpt_save`` and ``ckpt_restore`` of :mod:`.fault`; a retried attempt
counts ``ckpt_retries`` and :attr:`Checkpointer.retries`.
``preemption``, ``preemption_signals`` and ``preemption_sync_interval``
belong to :mod:`.preemption` and the runner.  Not ported, raising
``NotImplementedError`` naming ROADMAP item P10: ``async`` and
``max_inflight`` (background writes) and ``emergency_drain_timeout_s``
(emergency saves).  The integrity manifest and the layout-converting
restore, which take no key, are P10 as well.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..parallel.tensor import gather_param, shard_dim, shard_param
from ..utils.retry import Retry
from . import fault

__all__ = ["Checkpointer", "UNPORTED_CHECKPOINT_KEYS", "capture_training_state",
           "load_serving_state", "restore_training_state"]

# key -> (the value that asks for nothing unported, why it raises)
UNPORTED_CHECKPOINT_KEYS = {
    "async": (False, "asynchronous checkpoint writes are ROADMAP port item P10"),
    "max_inflight": (1, "asynchronous checkpoint writes (max_inflight) are ROADMAP port "
                        "item P10"),
    "emergency_drain_timeout_s": (5.0, "emergency checkpoints are ROADMAP port item P10"),
}
_STATE_FILE = "state.pt"


def _param_names(model) -> List[str]:
    """The names of the parameters a train step updates, in its order."""
    return [n for n, p in model.named_parameters() if p.requires_grad]


def capture_training_state(model, train_step, iteration: int) -> Dict[str, Any]:
    """The payload of one step: the model's ``state_dict``, the optimizer
    state of ``train_step`` (``opt_state``: lists aligned with its params,
    and ``step``) keyed by parameter name, its EMA (or ``None``) and the
    iteration."""
    names = _param_names(model)
    opt = train_step.opt_state
    tg = getattr(model, "tensor_group", None)
    plan = getattr(train_step, "zero_plan", None)  # the slots' ZeRO layout
    staged = getattr(model, "stage_group", None) is not None

    def full(leaves):
        if plan is not None:
            leaves = plan.gather_all(leaves)
        if staged:
            return model.gather_full(dict(zip(names, leaves)))
        if tg is None:
            return dict(zip(names, leaves))
        return {n: gather_param(t, shard_dim(n), tg) for n, t in zip(names, leaves)}

    slots = {field: full(getattr(opt, field)) for field in opt._fields if field != "step"}
    ema = getattr(train_step, "ema", None)
    sharded = tg is not None or getattr(model, "zero_plan", None) is not None or staged
    state = model.full_state_dict() if sharded else model.state_dict()
    return {"iter": int(iteration), "model": state,
            "optimizer": {"type": type(opt).__name__, "step": int(opt.step), "slots": slots},
            "ema": None if ema is None else full(ema)}


def restore_training_state(payload: Dict[str, Any], model, train_step) -> int:
    """Copy ``payload`` into ``model`` and ``train_step`` in place (their
    devices and memory formats kept); returns the saved iteration.  A
    payload of another model, optimizer or EMA setting raises
    ``ValueError``.  A tensor-parallel or ZeRO model and step take their
    slices of the full leaves, a pipeline stage its blocks."""
    tg = getattr(model, "tensor_group", None)
    plan = getattr(train_step, "zero_plan", None)
    staged = getattr(model, "stage_group", None) is not None
    if tg is None and getattr(model, "zero_plan", None) is None and not staged:
        model.load_state_dict(payload["model"], strict=True)
    else:
        model.load_full_state_dict(payload["model"])
    names = _param_names(model)
    full_names = model.full_keys() if staged else names
    opt = train_step.opt_state
    saved = payload["optimizer"]
    if saved["type"] != type(opt).__name__:
        raise ValueError(f"checkpoint optimizer state is {saved['type']}, this run's is "
                         f"{type(opt).__name__}")
    fields = [f for f in opt._fields if f != "step"]
    if sorted(saved["slots"]) != sorted(fields):
        raise ValueError(f"checkpoint optimizer slots {sorted(saved['slots'])}, want {fields}")
    ema = getattr(train_step, "ema", None)
    if (payload["ema"] is None) != (ema is None):
        raise ValueError("checkpoint and run disagree on training.ema: "
                         f"saved {'with' if payload['ema'] is not None else 'without'} an EMA")
    pairs = [(getattr(opt, f), saved["slots"][f]) for f in fields]
    if ema is not None:
        pairs.append((ema, payload["ema"]))
    with torch.no_grad():
        for tensors, by_name in pairs:
            if sorted(by_name) != sorted(full_names):
                raise ValueError("checkpoint parameter names differ from the model's")
            for i, (t, name) in enumerate(zip(tensors, names)):
                saved_t = by_name[name]
                if tg is not None:
                    saved_t = shard_param(saved_t, shard_dim(name), tg.size, tg.rank)
                if plan is not None:
                    saved_t = plan.slice(saved_t, i)
                t.copy_(saved_t)
    train_step.opt_state = opt._replace(step=int(saved["step"]))
    return int(payload["iter"])


def load_serving_state(directory: str, logger: Optional[logging.Logger] = None):
    """The newest step's inference weights: ``(state_dict, step)`` (JAX
    ``:1183``).

    Serving has no optimizer: only the model's ``state_dict`` is kept,
    read with ``map_location="cpu"`` (for a ResNet with its BatchNorm
    running statistics, JAX ``:1183-1243``'s ``batch_stats``), and when
    the run kept a weight EMA (``payload["ema"]``) its tensors replace the
    raw parameters, the running statistics staying the model's: the
    weights the runner validates with.  A step directory without the
    port's ``state.pt`` is an orbax checkpoint of the JAX package, which
    the port cannot read (``NotImplementedError``, ROADMAP port item P7b).
    """
    directory = os.path.abspath(os.path.expanduser(directory))
    steps = Checkpointer(directory).all_steps()
    if not steps:
        raise FileNotFoundError(
            f"no checkpoint found under {directory} — train with training.checkpoint.dir "
            "pointing there first, or serve with serving.checkpoint unset (random-init "
            "smoke mode)")
    step = steps[-1]
    path = os.path.join(directory, str(step), _STATE_FILE)
    if not os.path.exists(path):
        raise NotImplementedError(
            f"checkpoint step {step} under {directory} has no {_STATE_FILE}: an orbax "
            "checkpoint of the JAX package; restoring one is ROADMAP port item P7b")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state = dict(payload["model"])
    if payload.get("ema"):
        unknown = sorted(set(payload["ema"]) - set(state))
        if unknown:
            raise ValueError(f"checkpoint EMA names parameters the model lacks: {unknown[:4]}")
        state.update(payload["ema"])
        if logger:
            logger.info("Serving the EMA params from %s (iter %d)", directory, step)
    if logger:
        logger.info("Restored serving params from %s (iter %d)", directory, step)
    return state, int(step)


class Checkpointer:
    """Saves and restores steps under ``directory`` (see the module
    docstring).  ``rank``/``world_size``: this process's place in the
    data-parallel world (the default process group); rank 0 writes.  ``retry``:
    the policy of each write and load (default :class:`..utils.retry.Retry`'s).
    ``last_save`` and ``last_restore`` hold the step, the seconds and (a
    save) the bytes of the latest of each; ``retries`` counts retried
    attempts."""

    def __init__(self, directory: str, interval: int = 1000, max_to_keep: int = 3,
                 rank: int = 0, world_size: int = 1, retry: Optional[Retry] = None):
        if int(interval) < 1:
            raise ValueError(f"checkpoint.interval must be >= 1, got {interval}")
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.interval = int(interval)
        self.max_to_keep = int(max_to_keep) if max_to_keep else 0
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.retry = retry if retry is not None else Retry(logger=logging.getLogger(__name__))
        self.retries = 0
        self.last_save: Optional[dict] = None
        self.last_restore: Optional[dict] = None

    @classmethod
    def from_config(cls, train_cfg: dict, rank: int = 0,
                    world_size: int = 1) -> Optional["Checkpointer"]:
        """``None`` unless ``training.checkpoint.dir`` is set; a key asking
        for what is not ported raises ``NotImplementedError``."""
        ck = train_cfg.get("checkpoint")
        if not ck or not ck.get("dir"):
            return None
        for key, (default, why) in UNPORTED_CHECKPOINT_KEYS.items():
            if key in ck and ck[key] != default:
                raise NotImplementedError(f"training.checkpoint.{key}: {why}")
        rc = ck.get("retry") or {}
        unknown = set(rc) - {"attempts", "backoff", "max_backoff", "jitter", "total_timeout_s"}
        if unknown:
            raise ValueError(f"checkpoint.retry: unknown key(s) {sorted(unknown)} "
                             "(want attempts/backoff/max_backoff/jitter/total_timeout_s)")
        tts = rc.get("total_timeout_s")
        retry = Retry(attempts=int(rc.get("attempts", 3)), backoff=float(rc.get("backoff", 0.25)),
                      max_backoff=float(rc.get("max_backoff", 8.0)),
                      jitter=float(rc.get("jitter", 0.25)),
                      total_timeout_s=float(tts) if tts is not None else None,
                      logger=logging.getLogger(__name__))
        return cls(ck["dir"], interval=ck.get("interval", 1000),
                   max_to_keep=ck.get("max_to_keep", 3), rank=rank, world_size=world_size,
                   retry=retry)

    # ----------------------------------------------------------- the steps
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _extras_path(self, step: int) -> str:
        return os.path.join(self.directory, f"pipeline_{int(step)}.json")

    def all_steps(self) -> List[int]:
        """The committed steps, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isdir(os.path.join(self.directory, name)))

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, it: int, train_iters: int) -> bool:
        return (it + 1) % self.interval == 0 or it == train_iters - 1

    def _count_retry(self, attempt, exc, delay) -> None:
        del attempt, exc, delay
        self.retries += 1
        fault.bump("ckpt_retries")

    # ----------------------------------------------------------------- save
    def save(self, it: int, payload: Dict[str, Any], extras: Optional[dict] = None) -> None:
        """Commit step ``it``: rank 0 writes ``payload`` under the retry
        policy (and the sidecar ``extras``), then every rank waits for it
        at a barrier."""
        if self.rank == 0:
            t0 = time.perf_counter()
            final = self._step_dir(it)
            if os.path.exists(final):
                raise FileExistsError(f"checkpoint step {it} already exists at {final}")
            os.makedirs(self.directory, exist_ok=True)
            tmp = f"{final}.tmp-{os.getpid()}"

            def _save() -> int:
                fault.get_injector().check_fail_point("ckpt_save")
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                path = os.path.join(tmp, _STATE_FILE)
                torch.save(payload, path)
                nbytes = os.path.getsize(path)
                os.rename(tmp, final)  # the commit
                return nbytes

            nbytes = self.retry.call(_save, on_retry=self._count_retry)
            if extras is not None:
                self._write_extras(it, extras)
            self._prune()
            self.last_save = dict(step=int(it), seconds=time.perf_counter() - t0, bytes=nbytes)
        if self.world_size > 1:
            dist.barrier()

    def _write_extras(self, step: int, extras: dict) -> None:
        """The sidecar, written to a temporary name and renamed; the step
        rides along flat, as JAX ``_write_extras`` writes it."""
        tmp = f"{self._extras_path(step)}.tmp{os.getpid()}"
        with open(tmp, "w") as fp:
            json.dump({**extras, "step": int(step)}, fp)
        os.replace(tmp, self._extras_path(step))

    def _prune(self) -> None:
        steps = self.all_steps()
        if not self.max_to_keep or len(steps) <= self.max_to_keep:
            return
        for step in steps[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            try:
                os.remove(self._extras_path(step))
            except FileNotFoundError:
                pass

    # -------------------------------------------------------------- restore
    def read_extras(self, step: int) -> Optional[dict]:
        """The sidecar of ``step`` without its ``step`` key, or ``None`` when
        it is missing or unreadable (the caller derives the position)."""
        try:
            with open(self._extras_path(step)) as fp:
                payload = json.load(fp)
        except (OSError, ValueError):
            return None
        if not isinstance(payload, dict):
            return None
        payload.pop("step", None)
        return payload

    def restore_latest(self, apply: Callable[[Dict[str, Any]], Any], map_location,
                       logger: Optional[logging.Logger] = None) -> int:
        """Load the newest committed step onto ``map_location`` and hand its
        payload to ``apply``; returns the next iteration (0 when there is
        no step).  Each load runs under the retry policy; a step that still
        fails to load, or to apply, falls back to the one before it with a
        warning (``ckpt_fallbacks``); if every step fails, the newest step's
        error raises."""
        steps = self.all_steps()
        first_err: Optional[BaseException] = None
        for step in reversed(steps):
            t0 = time.perf_counter()
            path = os.path.join(self._step_dir(step), _STATE_FILE)

            def _load():
                fault.get_injector().check_fail_point("ckpt_restore")
                return torch.load(path, map_location=map_location, weights_only=True)

            try:
                payload = self.retry.call(_load, on_retry=self._count_retry)
                if payload.get("iter") != step:
                    raise ValueError(f"checkpoint step {step} holds iteration "
                                     f"{payload.get('iter')}")
                apply(payload)
            except Exception as e:  # a truncated or foreign step: try the one before
                if first_err is None:
                    first_err = e
                if step != steps[0]:
                    fault.bump("ckpt_fallbacks")
                    (logger or logging.getLogger(__name__)).warning(
                        "checkpoint step %d at %s is unreadable (%s: %s) — falling back to "
                        "the previous step", step, self.directory, type(e).__name__, e)
                continue
            self.last_restore = dict(step=int(step), seconds=time.perf_counter() - t0)
            return step + 1
        if first_err is not None:
            raise first_err
        return 0
