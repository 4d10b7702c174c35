"""The ``model:`` section and ``training.fault_tolerance`` parsed onto the
runner (port of ``parse_topology``'s model keys, JAX
``engine/topology.py:55-90``, its MoE checks, ``:142-153`` and
``:273-282``, its sequence- and tensor-parallel checks, ``:100-120`` and
``:221-266``, its ``training.zero`` key, ``:160-179`` and ``:213-220``, its
pipeline keys, ``:102-158``, ``:336-338`` and ``:377-381``, and of
``parse_fault_tolerance``, ``:436-544``), the route of an LM run (JAX
``engine/paths.py:290-306``) and the checks and refusals of the pipeline
path and of the GSPMD path that tensor-parallel, ZeRO and MoE runs take
(``paths.py:48-138``, ``:156-164``)."""
from __future__ import annotations

import inspect

import torch

from ..models import TransformerLM, is_resnet
from ..optimizers import LARS
from .fault import FaultInjector

__all__ = ["check_gspmd_path", "check_moe", "check_pipeline", "check_pipeline_batch",
           "check_sequence_parallel", "check_tensor_parallel", "gspmd_path",
           "parse_fault_tolerance", "parse_model", "parse_parallelism", "parse_pipeline",
           "pipeline_path", "ring_path", "ring_zero1_path"]

_LM_DEFAULTS = {k: v.default for k, v in inspect.signature(TransformerLM).parameters.items()}


def check_moe(cfg: dict) -> bool:
    """Whether the config asks for a MoE LM, after the JAX package's checks
    of its layout, with its messages: no pipeline, experts that
    ``training.tensor_parallelism`` divides, and ``model.moe_every`` in
    ``[1, depth]`` (the constructor's defaults where a key is unset)."""
    model_cfg, train_cfg = cfg["model"], cfg.get("training") or {}
    experts = int(model_cfg.get("moe_experts", 0) or 0)
    if model_cfg["name"].lower() != "transformerlm" or experts <= 0:
        return False
    if int(train_cfg.get("pipeline_parallelism", 1)) > 1:
        raise ValueError("model.moe_experts does not compose with pipeline_parallelism")
    tensor_par = int(train_cfg.get("tensor_parallelism", 1))
    if experts % tensor_par != 0:
        raise ValueError(f"model.moe_experts ({experts}) must be divisible by "
                         f"training.tensor_parallelism ({tensor_par}) for an even expert split")
    every = int(model_cfg.get("moe_every", _LM_DEFAULTS["moe_every"]))
    depth = int(model_cfg.get("depth", _LM_DEFAULTS["depth"]))
    if not 1 <= every <= depth:
        raise ValueError(f"model.moe_every ({every}) must be in [1, depth={depth}] "
                         "(moe_every > depth would make no block MoE)")
    return True


def _reject_guard_and_overlap(r, train_cfg: dict, path: str) -> None:
    """JAX ``_reject_anomaly`` and ``_reject_comm`` (``paths.py:48-73``) for
    the ``path`` execution path, with their messages."""
    if getattr(r, "anomaly_enabled", False):
        raise ValueError(f"training.fault_tolerance.anomaly is not wired for the {path} "
                         "execution path (supported: image-dp, ring-sp)")
    if bool((train_cfg.get("comm") or {}).get("overlap", False)):
        raise ValueError(f"training.comm.overlap is not wired for the {path} execution path "
                         "(supported: image-dp, ring-sp, and ring-sp with zero stage 1) — the "
                         "GSPMD partitioner schedules its own communication overlap there")


def check_gspmd_path(r, train_cfg: dict) -> None:
    """What the GSPMD path refuses (JAX ``paths.py:156-157``), with the JAX
    messages: the anomaly guard and ``training.comm.overlap``."""
    _reject_guard_and_overlap(r, train_cfg, "gspmd")


def check_pipeline(r, train_cfg: dict, model_cfg: dict, optimizer_cls) -> None:
    """What the pipeline path refuses (JAX ``_build_pipeline``,
    ``paths.py:84-115``), with the JAX messages: the anomaly guard,
    ``training.comm.overlap``, a ``model.depth`` that the stage count does
    not divide, LARS, and heads that ``training.tensor_parallelism`` does
    not divide."""
    _reject_guard_and_overlap(r, train_cfg, "pipeline")
    depth = int(model_cfg.get("depth", _LM_DEFAULTS["depth"]))
    if depth % r.pipe_par != 0:
        raise ValueError(f"model.depth ({depth}) must be divisible by "
                         f"training.pipeline_parallelism ({r.pipe_par})")
    if issubclass(optimizer_cls, LARS):
        # per-parameter trust ratios would span a stage's stacked layers
        raise ValueError("optimizer LARS is not supported with pipeline_parallelism "
                         "(per-parameter trust ratios do not survive the stacked-layer param "
                         "layout)")
    num_heads = int(model_cfg.get("num_heads", _LM_DEFAULTS["num_heads"]))
    if r.tensor_par > 1 and num_heads % r.tensor_par:
        raise ValueError(f"model.num_heads ({num_heads}) must be divisible by "
                         f"training.tensor_parallelism ({r.tensor_par})")


def parse_parallelism(r, train_cfg: dict) -> None:
    """Set ``r.seq_par``, ``r.tensor_par``, the pipeline's keys
    (:func:`parse_pipeline`) and ``r.zero`` from
    ``training.sequence_parallelism`` and ``training.tensor_parallelism``
    (default 1), refused off the LM with the JAX message (``topology.py:100-119``),
    and ``training.zero`` (:func:`parse_zero`).  Run after
    :func:`parse_model`."""
    r.seq_par = int(train_cfg.get("sequence_parallelism", 1) or 1)
    r.tensor_par = int(train_cfg.get("tensor_parallelism", 1) or 1)
    parse_pipeline(r, train_cfg)
    parse_zero(r, train_cfg)


def parse_pipeline(r, train_cfg: dict) -> None:
    """``r.pipe_par``, ``r.microbatches`` and ``r.pp_schedule`` from
    ``training.pipeline_parallelism`` (default 1), ``training.microbatches``
    (default the stage count) and ``training.pp_schedule`` (default
    ``gpipe``), with the JAX checks and messages in JAX's order
    (``topology.py:102-158``): ``microbatches`` and ``pp_schedule`` need a
    pipeline, the parallel keys the LM, no three-way PP x SP x TP, a known
    schedule, no MoE, and at least as many microbatches as stages."""
    r.pipe_par = int(train_cfg.get("pipeline_parallelism", 1) or 1)
    r.microbatches = int(train_cfg.get("microbatches", r.pipe_par))
    if "microbatches" in train_cfg and r.pipe_par <= 1:
        raise ValueError("training.microbatches requires pipeline_parallelism > 1 (use "
                         "training.grad_accumulation for non-pipelined micro-batching)")
    if (r.seq_par > 1 or r.tensor_par > 1 or r.pipe_par > 1) and not r.is_lm:
        raise ValueError("training.sequence_parallelism / tensor_parallelism / "
                         "pipeline_parallelism require model.name: TransformerLM")
    if r.pipe_par > 1 and r.seq_par > 1 and r.tensor_par > 1:
        raise ValueError("pipeline_parallelism x sequence_parallelism x tensor_parallelism "
                         "(three-way) is not wired; pick PP x SP or PP x TP")
    r.pp_schedule = str(train_cfg.get("pp_schedule", "gpipe"))
    if r.pp_schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"training.pp_schedule must be 'gpipe' or '1f1b', "
                         f"got {r.pp_schedule!r}")
    if "pp_schedule" in train_cfg and r.pipe_par <= 1:
        raise ValueError("training.pp_schedule requires pipeline_parallelism > 1")
    if r.pipe_par > 1 and r.is_moe:
        raise ValueError("model.moe_experts does not compose with pipeline_parallelism")
    if r.microbatches < max(r.pipe_par, 1):
        raise ValueError(f"training.microbatches ({r.microbatches}) must be >= "
                         f"pipeline_parallelism ({r.pipe_par})")


def check_pipeline_batch(r, batch: int, grad_accum: int) -> None:
    """JAX ``topology.py:336-338`` and ``:377-381`` under the pipeline:
    ``grad_accumulation`` is redundant, and the per-shard batch (a rank's
    ``batch_size``) must divide by ``training.microbatches``."""
    if r.pipe_par <= 1:
        return
    if grad_accum > 1:
        raise ValueError("grad_accumulation is redundant under pipeline_parallelism — raise "
                         "training.microbatches instead (same memory effect, and it also "
                         "shrinks the pipeline bubble)")
    if batch % r.microbatches != 0:
        raise ValueError(f"per-shard batch ({batch}) not divisible by training.microbatches "
                         f"({r.microbatches})")


def parse_zero(r, train_cfg: dict) -> None:
    """``r.zero``, the ZeRO stage of ``training.zero`` (JAX
    ``topology.py:160-179``, ``:213-220``), with the JAX messages: a bool
    (``True`` is stage 1) or a stage in 0-3; only on the LM; stage 3 not
    beside the pipeline (:func:`parse_pipeline` first)."""
    zero = train_cfg.get("zero", False)
    if isinstance(zero, bool):
        r.zero = 1 if zero else 0
    elif isinstance(zero, int) and zero in (0, 1, 2, 3):
        r.zero = zero
    else:
        raise ValueError(f"training.zero must be a bool or a stage in (0, 1, 2, 3), "
                         f"got {zero!r}")
    if r.zero and not r.is_lm:
        raise ValueError("training.zero is only wired for the LM task (GSPMD path)")
    if r.zero >= 3 and r.pipe_par > 1:
        raise ValueError(f"training.zero: {r.zero} does not compose with "
                         "pipeline_parallelism — use zero: 1 or 2 under the pipeline")


def pipeline_path(r) -> bool:
    """JAX ``paths.py:291``, the first row of its table: an LM at
    ``pipeline_parallelism`` > 1 runs on the pipeline path."""
    return r.is_lm and r.pipe_par > 1


def ring_path(r, train_cfg: dict) -> bool:
    """Whether the run shards the sequence over a ring of ranks: JAX
    ``topology.py:256-266`` sets ``seq_axis`` for ``sequence_parallelism``
    > 1 with no tensor or pipeline parallelism, no ZeRO and no MoE (beside
    the pipeline it runs on the pipeline path; beside the others it stays
    ROADMAP port item P9)."""
    return (r.seq_par > 1 and r.tensor_par == 1 and r.pipe_par == 1 and not r.zero
            and not r.is_moe)


def ring_zero1_path(r, train_cfg: dict) -> bool:
    """JAX ``paths.py:293-301``: ``comm.overlap`` beside ZeRO-1 on a dense
    LM at ``tensor_parallelism`` 1 takes the manual reduce-scatter path
    (``training.comm``, ROADMAP port item P9), not the GSPMD one."""
    return (r.is_lm and bool((train_cfg.get("comm") or {}).get("overlap", False))
            and r.zero == 1 and r.tensor_par == 1 and not r.is_moe)


def gspmd_path(r, train_cfg: dict) -> bool:
    """JAX ``paths.py:302-306``: an LM with tensor parallelism, ZeRO or MoE
    blocks runs on the GSPMD path (:func:`pipeline_path` and
    :func:`ring_zero1_path` taken first)."""
    return (r.is_lm and (r.tensor_par > 1 or bool(r.zero) or r.is_moe)
            and not pipeline_path(r) and not ring_zero1_path(r, train_cfg))


def check_tensor_parallel(r, model_cfg: dict, world_size: int) -> None:
    """JAX ``topology.py:221-245`` and ``paths.py:159-164`` for the GSPMD
    path at ``T = training.tensor_parallelism`` > 1: ``T`` divides the ranks
    (one a card; JAX: the local device count) and the heads, so the column
    split lands on whole heads.  The experts are checked by
    :func:`check_moe`."""
    t = r.tensor_par
    num_heads = int(model_cfg.get("num_heads", _LM_DEFAULTS["num_heads"]))
    if t < 1 or world_size % t != 0:
        raise ValueError(f"training.tensor_parallelism ({t}) must divide the number of "
                         f"ranks ({world_size})")
    if num_heads % t != 0:
        raise ValueError(f"model.num_heads ({num_heads}) must be divisible by "
                         f"training.tensor_parallelism ({t})")


def check_sequence_parallel(r, seq_len: int, world_size: int) -> None:
    """JAX ``topology.py:221-252`` for the ring path: ``n`` divides the ranks
    (one a card; JAX: the local device count) and the dataset's sequence."""
    n = r.seq_par
    if n < 1 or world_size % n != 0:
        raise ValueError(f"training.sequence_parallelism ({n}) must divide the number of "
                         f"ranks ({world_size})")
    if seq_len % n != 0:
        raise ValueError(f"dataset.seq_len ({seq_len}) must be divisible by "
                         f"training.sequence_parallelism ({n})")


_BN_STAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_model(r, cfg: dict) -> dict:
    """Set ``model_name``, ``pretrained``, ``is_lm`` and ``is_moe`` (by
    :func:`check_moe`, with its checks) on ``r`` from ``cfg["model"]`` and
    return the keys left for the constructor.

    As JAX ``topology.py:55-90``: the LM path is ``model.name:
    TransformerLM`` and nothing else; ``pretrained`` is popped (a path to a
    torch ``state_dict``, refused with MoE); the ResNet-only keys
    ``space_to_depth`` and ``bn_stat_dtype`` are validated before the
    LM/image split, with the JAX package's messages, and handed on (the
    statistics' dtype as a torch dtype) only when set.  Where the JAX image
    path ignores every other key, the port passes them to ``get_model`` on
    both paths, so an unknown key raises instead of being dropped."""
    model_cfg = dict(cfg["model"])
    model_name = model_cfg.pop("name")
    r.model_name = model_name
    r.pretrained = model_cfg.pop("pretrained", None)
    r.is_lm = model_name.lower() == "transformerlm"
    r.is_moe = check_moe(cfg)
    if r.pretrained and r.is_moe:
        # the torch-twin LM layout has no expert tensors
        raise ValueError("model.pretrained does not support MoE models "
                         "(no torch-twin layout for expert weights)")
    s2d = bool(model_cfg.pop("space_to_depth", False))
    bn_stat = model_cfg.pop("bn_stat_dtype", None)
    if bn_stat is not None and bn_stat not in _BN_STAT_DTYPES:
        raise ValueError(f"model.bn_stat_dtype must be 'float32' or 'bfloat16', got {bn_stat!r}")
    if (s2d or bn_stat) and not is_resnet(model_name):
        raise ValueError(f"model.space_to_depth / bn_stat_dtype are only wired for the ResNet "
                         f"family (got model.name: {model_name})")
    if s2d:
        model_cfg["space_to_depth"] = True
    if bn_stat:
        model_cfg["bn_stat_dtype"] = _BN_STAT_DTYPES[bn_stat]
    return model_cfg


def parse_fault_tolerance(r, train_cfg: dict) -> None:
    """Set the anomaly guard's, the watchdog's and the fault spec's
    attributes on ``r`` from ``training.fault_tolerance`` (every part off
    by default):

    .. code-block:: yaml

        training:
            fault_tolerance:
                anomaly:               # the anomaly-step guard
                    enabled: true      # implied by a non-empty section
                    grad_norm_factor: 10.0   # 0 = non-finite only
                    window: 64         # trailing-median history length
                    max_consecutive: 5 # then roll back to the last checkpoint
                watchdog:              # the hung-step watchdog
                    enabled: true
                    factor: 10.0       # x trailing-median step time
                    min_seconds: 60.0  # floor
                    poll_seconds: null # default min_seconds / 4
                    window: 32
                    warmup: 3
                    checkpoint_and_exit: false  # fire the PreemptionGuard
                fault_spec: null       # injection script (PDT_FAULT_SPEC wins)

    Unknown keys and out-of-range values raise the JAX package's
    ``ValueError``s; the spec is parsed here, so a malformed one fails at
    start-up."""
    ft = train_cfg.get("fault_tolerance") or {}
    unknown = set(ft) - {"anomaly", "watchdog", "fault_spec"}
    if unknown:
        raise ValueError(f"training.fault_tolerance: unknown key(s) {sorted(unknown)} "
                         "(want anomaly/watchdog/fault_spec)")

    an = ft.get("anomaly") or {}
    unknown = set(an) - {"enabled", "grad_norm_factor", "window", "max_consecutive"}
    if unknown:
        raise ValueError(f"training.fault_tolerance.anomaly: unknown key(s) {sorted(unknown)} "
                         "(want enabled/grad_norm_factor/window/max_consecutive)")
    r.anomaly_enabled = bool(an) and bool(an.get("enabled", True))
    r.anomaly_factor = float(an.get("grad_norm_factor", 10.0))
    r.anomaly_window = int(an.get("window", 64))
    r.anomaly_max_consec = int(an.get("max_consecutive", 5))
    if r.anomaly_factor < 0:
        raise ValueError("fault_tolerance.anomaly.grad_norm_factor must be >= 0 "
                         f"(0 = non-finite-only), got {r.anomaly_factor}")
    if r.anomaly_window < 1:
        raise ValueError(f"fault_tolerance.anomaly.window must be >= 1, got {r.anomaly_window}")
    if r.anomaly_max_consec < 1:
        raise ValueError("fault_tolerance.anomaly.max_consecutive must be >= 1, got "
                         f"{r.anomaly_max_consec}")

    wd = ft.get("watchdog") or {}
    unknown = set(wd) - {"enabled", "factor", "min_seconds", "poll_seconds", "window",
                         "warmup", "checkpoint_and_exit"}
    if unknown:
        raise ValueError(f"training.fault_tolerance.watchdog: unknown key(s) {sorted(unknown)} "
                         "(want enabled/factor/min_seconds/poll_seconds/window/warmup/"
                         "checkpoint_and_exit)")
    r.watchdog_enabled = bool(wd) and bool(wd.get("enabled", True))
    r.watchdog_factor = float(wd.get("factor", 10.0))
    r.watchdog_min_seconds = float(wd.get("min_seconds", 60.0))
    r.watchdog_poll = float(wd["poll_seconds"]) if wd.get("poll_seconds") is not None else None
    r.watchdog_window = int(wd.get("window", 32))
    r.watchdog_warmup = int(wd.get("warmup", 3))
    r.watchdog_exit = bool(wd.get("checkpoint_and_exit", False))
    if r.watchdog_enabled:
        if r.watchdog_factor <= 1.0:
            raise ValueError(f"fault_tolerance.watchdog.factor must be > 1, got "
                             f"{r.watchdog_factor}")
        if r.watchdog_min_seconds <= 0:
            raise ValueError(f"fault_tolerance.watchdog.min_seconds must be > 0, got "
                             f"{r.watchdog_min_seconds}")
        if r.watchdog_poll is not None and r.watchdog_poll <= 0:
            raise ValueError(f"fault_tolerance.watchdog.poll_seconds must be > 0, got "
                             f"{r.watchdog_poll}")
        if r.watchdog_warmup < 1:
            raise ValueError(f"fault_tolerance.watchdog.warmup must be >= 1, got "
                             f"{r.watchdog_warmup}")

    spec = ft.get("fault_spec")
    r.fault_spec = str(spec) if spec else None
    if r.fault_spec:
        FaultInjector(r.fault_spec)
