"""The port's pipeline parallelism (``training.pipeline_parallelism``:
``parallel/pipeline.py``, ``PPLayout``, the stage view of
``models/transformer_lm.py``, ``engine/pp_steps.py``) against the JAX
package's pipeline step on the CPU.

Small on purpose: 4 blocks, d 64, 4 heads, vocab 128, S 16, batch 8.  The
JAX weights are drawn with numpy over ``jax.eval_shape``'s tree and stacked
by JAX ``pp_stack_params``; the JAX legs run compiled once a case at XLA's
lowest optimisation on ``make_pp_mesh(S)`` over ``n_data * S`` CPU devices;
the port's ranks are gloo thread ranks over one ``HashStore`` (``r =
data_idx * S + stage_idx``; a stage group and a data group each), every
stage on the plain twins, its weights from ``lm_state_dict_from_jax_pp``.

- the port's GPipe and 1F1B tables against JAX ``_schedule`` and
  ``_sim_1f1b`` over a grid of (M, S), and the receive tables' pairing;
- the train step at (data 1, stage 4) and (data 2, stage 2), GPipe and
  1F1B, 3 SGD steps: losses within rtol 1e-5 of JAX's and the parameters
  after within atol 1e-5 (gathered over the stages), and against the port's
  one-rank full-batch step (losses rtol 1e-6, parameters 1e-6 of their
  largest magnitude); the shared leaves equal on every stage;
- AdamW losses, AdamW with ``exclude_norm_bias`` and LAMB against JAX under
  the pipeline (the stacked-leaf rules), their per-layer readings rejected;
- the eval step with a ragged tail batch against JAX
  ``build_pp_lm_eval_step``;
- the JAX checks of the pipeline with the JAX messages, and the pipeline
  beside tensor or sequence parallelism or ZeRO-1/2 reaching the ranks
  check (their steps: tests/test_torch_pipeline_compose.py);
- the runner on ``config/TransformerLM-pp.yml`` at a tiny width as four
  gloo processes: 1F1B and GPipe train and validate, a checkpoint of
  per-layer leaves resumes bit for bit, and the losses follow the one-rank
  runner's.
"""
import json
import logging
import math
import os
import socket
import subprocess
import sys
import threading
from datetime import timedelta
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from pytorch_distributed_training_tpu import optimizers as jopt
from pytorch_distributed_training_tpu.engine import TrainState
from pytorch_distributed_training_tpu.engine import paths as jpaths
from pytorch_distributed_training_tpu.engine import pp_steps as jpp
from pytorch_distributed_training_tpu.engine import topology as jtopo
from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.parallel import (
    make_pp_mesh,
    pp_stack_params,
    pp_state_shardings,
)
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch.engine import Runner
from pytorch_distributed_training_tpu_torch.engine.pp_steps import (
    build_pp_lm_eval_step,
    build_pp_lm_train_step,
    receive_tables,
    schedule,
    sim_1f1b,
)
from pytorch_distributed_training_tpu_torch.engine.sp_steps import build_lm_train_step
from pytorch_distributed_training_tpu_torch.engine.topology import (
    check_pipeline,
    check_pipeline_batch,
    parse_model,
    parse_parallelism,
)
from pytorch_distributed_training_tpu_torch.models import (
    TransformerLM,
    lm_state_dict_from_jax,
    lm_state_dict_from_jax_pp,
)
from pytorch_distributed_training_tpu_torch.parallel import StageExchange, TensorGroup
from pytorch_distributed_training_tpu_torch.parallel.pipeline import pp_stack, pp_unstack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, D, HEADS, DEPTH, BATCH = 128, 16, 64, 4, 4, 8
KW = dict(max_len=SEQ, embed_dim=D, depth=DEPTH, num_heads=HEADS)
SGD_KW = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)
OPT_KW = {"sgd": SGD_KW, "adamw": dict(lr=1e-3, weight_decay=0.1),
          # a decay that moves the blocks' LayerNorm scales 5% a step: the
          # stacked-layout rule (decayed) and the per-layer one (not) part.
          # eps 1e-6 keeps gradients that are 0 up to rounding (the k part of
          # the qkv bias) from lr-sized steps of the sign of f32 noise
          "adamw-exclude": dict(lr=1e-3, eps=1e-6, weight_decay=50.0, exclude_norm_bias=True),
          "lamb": dict(lr=2e-2, weight_decay=0.01)}
# the limits of tests/test_torch_zero.py: port n ranks against the port's one
# rank (f32 sums reassociated), and the JAX step's
PORT_RTOL, JAX_RTOL, JAX_ATOL = 1e-6, 1e-5, 1e-5
# LAMB's and AdamW's parameters against JAX's: their Adam-type direction
# amplifies f32 noise in gradients that are 0 up to rounding (the k part of
# the qkv bias), as tests/test_torch_zero.py measured for LAMB
ADAM_ATOL = 1e-4
FAST_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
            "xla_cpu_parallel_codegen_split_count": 1, "xla_cpu_multi_thread_eigen": False}
TIMEOUT = timedelta(seconds=60)  # a hop that no rank pairs fails instead of hanging


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    """A flax params tree drawn with numpy: kernels at lecun scale, small
    random biases, scales near 1, embeddings at 0.5."""
    shapes = jax.eval_shape(JaxLM(vocab_size=VOCAB, **KW).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.default_rng(70)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            arr = rng.normal(0.0, 1.0 / np.sqrt(sd.shape[-2]), sd.shape)
        elif name == "scale":
            arr = 1.0 + 0.1 * rng.normal(size=sd.shape)
        elif "embedding" in name:
            arr = 0.5 * rng.normal(size=sd.shape)
        else:
            arr = 0.05 * rng.normal(size=sd.shape)
        return arr.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batches(seed: int, n: int = 3, batch: int = BATCH):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, VOCAB, (batch, SEQ + 1)).astype(np.int32)
        out.append((toks[:, :-1], toks[:, 1:]))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).long()


def _jax_opt(opt: str):
    kw = OPT_KW[opt]
    return {"sgd": jopt.SGD, "adamw": jopt.AdamW, "adamw-exclude": jopt.AdamW,
            "lamb": jopt.LAMB}[opt](**kw)


def _port_opt(opt: str):
    kw = OPT_KW[opt]
    return {"sgd": topt.SGD, "adamw": topt.AdamW, "adamw-exclude": topt.AdamW,
            "lamb": topt.LAMB}[opt](**kw)


def _jax_state(params, layout, opt):
    n_data, n_stage = layout
    mesh = make_pp_mesh(n_stage, devices=jax.devices()[:n_data * n_stage])
    pp = pp_stack_params(jax.tree_util.tree_map(jnp.asarray, params), DEPTH)
    jo = _jax_opt(opt)
    state = TrainState(params=pp, batch_stats={}, opt_state=jo.init(pp))
    return mesh, jo, jax.device_put(state, pp_state_shardings(state, mesh))


_JAX_RUNS = {}


def _jax_run(params, layout, sched, micro, opt, batches):
    """JAX ``build_pp_lm_train_step`` on ``make_pp_mesh(S)`` over ``n_data *
    S`` CPU devices, compiled once a case: the losses and the parameters
    after (the port's per-layer names, by ``lm_state_dict_from_jax_pp``)."""
    key = (layout, sched, micro, opt)
    if key not in _JAX_RUNS:
        mesh, jo, state = _jax_state(params, layout, opt)
        lr = OPT_KW[opt]["lr"]
        inp, tgt = (jnp.asarray(a) for a in batches[0])
        step = jpp.build_pp_lm_train_step(
            JaxLM(vocab_size=VOCAB, **KW), jo, lambda _: jnp.float32(lr), mesh, micro,
            donate=False, schedule=sched)(state).lower(state, inp, tgt).compile(
            compiler_options=FAST_XLA)
        losses = []
        for inp, tgt in batches:
            state, loss = step(state, jnp.asarray(inp), jnp.asarray(tgt))
            losses.append(float(loss))
        _JAX_RUNS[key] = losses, lm_state_dict_from_jax_pp(
            jax.tree_util.tree_map(np.asarray, state.params))
    return _JAX_RUNS[key]


def _thread_ranks(world: int, fn):
    """``fn(r)`` on ``world`` threads; the results by rank (errors re-raised)."""
    outs, errors = {}, []

    def run(r):
        try:
            outs[r] = fn(r)
        except BaseException as err:  # re-raised below, in the test's thread
            errors.append(err)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads), "a rank did not finish"
    assert not errors and len(outs) == world, errors
    return outs


def _stage_rank(store, r, layout, pp_np):
    """Rank ``r``'s groups, its stage's model (weights from the JAX
    pipeline layout) and its exchange."""
    n_data, n_stage = layout
    d, s = divmod(r, n_stage)
    sg = dist.ProcessGroupGloo(dist.PrefixStore(f"stage{d}", store), s, n_stage, TIMEOUT)
    dg = (dist.ProcessGroupGloo(dist.PrefixStore(f"data{s}", store), d, n_data, TIMEOUT)
          if n_data > 1 else None)
    stage = TensorGroup(sg, n_stage, s)
    with torch.device("meta"):
        model = TransformerLM(VOCAB, stage_group=stage, **KW)
    model.to_empty(device="cpu")
    model.load_state_dict(lm_state_dict_from_jax_pp(pp_np, stage), strict=True)
    return d, s, model, StageExchange(sg), dg


def _port_run(params, layout, sched, micro, opt, batches, wrong=None):
    """The port's pipeline step on ``n_data x S`` gloo thread ranks, each
    holding its data rows of every batch: per rank the losses, the full
    ``state_dict`` after (gathered over the stages) and its own shared
    leaves.  ``wrong``: ``"per-layer"`` reads the optimizer's rules on the
    per-layer leaves (a wrong variant)."""
    n_data, n_stage = layout
    pp_np = jax.tree_util.tree_map(np.asarray, pp_stack_params(params, DEPTH))
    store = dist.HashStore()

    def rank(r):
        d, s, model, ex, dg = _stage_rank(store, r, layout, pp_np)
        lr = OPT_KW[opt]["lr"]
        step = build_pp_lm_train_step(model, _port_opt(opt), lambda i: lr, ex, micro, sched,
                                      world_size=n_data, group=dg)
        if wrong == "per-layer":
            step._excluded = [p.dim() <= 1 for p in step.params]
            step._stack = [-1] * len(step.params)
        rows = BATCH // n_data
        sl = slice(d * rows, (d + 1) * rows)
        losses = [float(step(_t(inp[sl]), _t(tgt[sl]))) for inp, tgt in batches]
        shared = {k: v.clone() for k, v in model.state_dict().items() if not k.startswith("block")}
        return dict(loss=losses, state=model.full_state_dict(), shared=shared,
                    blocks=list(model.block_ids))

    return _thread_ranks(n_data * n_stage, rank)


def _one_rank(params, batches, opt="sgd"):
    """The port's one-rank full-batch LM step from the same weights."""
    model = TransformerLM(VOCAB, **KW)
    model.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    lr = OPT_KW[opt]["lr"]
    step = build_lm_train_step(model, _port_opt(opt), lambda i: lr)
    losses = [float(step(_t(inp), _t(tgt))) for inp, tgt in batches]
    return dict(loss=losses, state=model.state_dict())


def _close(got, want, what: str, tol: float) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"{what}: max |got - want| / max |want| = {err}"
    return err


# --------------------------------------------------------------------- #
# the tables and the layout


@pytest.mark.parametrize("micro,stages", [(1, 1), (2, 2), (4, 2), (5, 2), (3, 3), (6, 3),
                                          (4, 4), (8, 4), (9, 4)],
                         ids=lambda x: str(x))
def test_schedule_tables_match_jax(micro, stages):
    for got, want in zip(schedule(micro, stages), jpp._schedule(micro, stages)):
        np.testing.assert_array_equal(got, np.asarray(want))
    got, want = sim_1f1b(micro, stages), jpp._sim_1f1b(micro, stages)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    f_mb, f_on, b_mb, b_on, _ = got
    fr_mb, fr_on, br_mb, br_on = receive_tables(f_mb, f_on, b_mb, b_on)
    # every receive is its neighbour's slot of the same tick, and every live
    # send but the last stage's activations and stage 0's cotangents is received
    for t, s in zip(*np.nonzero(fr_on)):
        assert s > 0 and f_on[t, s - 1] and f_mb[t, s - 1] == fr_mb[t, s]
    for t, s in zip(*np.nonzero(br_on)):
        assert s < stages - 1 and b_on[t, s + 1] and b_mb[t, s + 1] == br_mb[t, s]
    assert fr_on.sum() == f_on[:, :-1].sum() and br_on.sum() == b_on[:, 1:].sum()
    # every stage runs every microbatch once each way
    assert (f_on.sum(0) == micro).all() and (b_on.sum(0) == micro).all()


def test_stack_and_weights_from_the_jax_layout(jax_params):
    """``pp_stack``/``pp_unstack`` invert each other, the JAX pipeline layout
    maps to the per-layer ``state_dict`` and each stage keeps its blocks."""
    full = lm_state_dict_from_jax(jax_params)
    pp = pp_stack(full)
    assert pp["blocks"]["attn.qkv.weight"].shape == (DEPTH, 3 * D, D)
    back = pp_unstack(pp)
    assert sorted(back) == sorted(full) and all(torch.equal(back[k], full[k]) for k in full)
    pp_np = jax.tree_util.tree_map(np.asarray, pp_stack_params(jax_params, DEPTH))
    got = lm_state_dict_from_jax_pp(pp_np)
    assert sorted(got) == sorted(full) and all(torch.equal(got[k], full[k]) for k in full)
    stage = lm_state_dict_from_jax_pp(pp_np, TensorGroup(None, 2, 1))
    assert sorted({k.split(".")[0] for k in stage if k.startswith("block")}) == ["block2",
                                                                                 "block3"]
    with pytest.raises(ValueError, match=r"model.depth \(4\) must be divisible by "
                                         r"training.pipeline_parallelism \(3\)"):
        TransformerLM(VOCAB, stage_group=TensorGroup(None, 3, 0), **KW)


# --------------------------------------------------------------------- #
# the step against JAX and the one-rank step

CASES = {"1x4-gpipe": ((1, 4), "gpipe", 4), "1x4-1f1b": ((1, 4), "1f1b", 8),
         "2x2-gpipe": ((2, 2), "gpipe", 2), "2x2-1f1b": ((2, 2), "1f1b", 4)}


@pytest.mark.parametrize("case", list(CASES))
def test_pp_step_matches_jax_and_one_rank(jax_params, case):
    layout, sched, micro = CASES[case]
    batches = _batches(71)
    outs = _port_run(jax_params, layout, sched, micro, "sgd", batches)
    jlosses, jafter = _jax_run(jax_params, layout, sched, micro, "sgd", batches)
    one = _one_rank(jax_params, batches)
    for r, got in outs.items():
        np.testing.assert_allclose(got["loss"], jlosses, rtol=JAX_RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=PORT_RTOL)
        assert sorted(got["state"]) == sorted(jafter)
        for name, want in jafter.items():
            np.testing.assert_allclose(got["state"][name].numpy(), want.numpy(), atol=JAX_ATOL,
                                       err_msg=f"jax {name}")
            _close(got["state"][name], one["state"][name], f"after {name}", PORT_RTOL)
        # the stage's own blocks, and the shared leaves equal on every rank
        assert got["blocks"] == list(range(r % layout[1] * DEPTH // layout[1],
                                           (r % layout[1] + 1) * DEPTH // layout[1]))
        for name, t in got["shared"].items():
            assert torch.equal(t, outs[0]["shared"][name]), (r, name)


@pytest.mark.parametrize("opt", ["adamw", "adamw-exclude", "lamb"])
def test_pp_optimizers_match_jax(jax_params, opt):
    """AdamW, AdamW with ``exclude_norm_bias`` and LAMB under the pipeline,
    3 steps at (data 1, stage 4), 1F1B: losses within rtol 1e-5 of JAX's;
    with the stacked-layout rules (block LayerNorms and biases decayed, LAMB's
    trust ratios over each stage's stack) the parameters within ``ADAM_ATOL``
    of JAX's, and with the per-layer rules outside it."""
    layout, sched, micro = CASES["1x4-1f1b"]
    batches = _batches(72)
    jlosses, jafter = _jax_run(jax_params, layout, sched, micro, opt, batches)
    outs = _port_run(jax_params, layout, sched, micro, opt, batches)
    for r, got in outs.items():
        np.testing.assert_allclose(got["loss"], jlosses, rtol=JAX_RTOL, err_msg=f"rank {r}")
    if opt == "adamw":
        return
    for name, want in jafter.items():
        np.testing.assert_allclose(outs[0]["state"][name].numpy(), want.numpy(),
                                   atol=ADAM_ATOL, err_msg=name)
    wrong = _port_run(jax_params, layout, sched, micro, opt, batches, "per-layer")[0]["state"]
    worst = max(float((wrong[n] - jafter[n]).abs().max()) for n in jafter)
    assert worst > 5 * ADAM_ATOL, worst


def test_pp_eval_matches_jax_with_a_ragged_tail(jax_params, caplog):
    """The eval step at (data 1, stage 4) with microbatches 4 over a batch of
    6 (JAX falls back to gcd(4, 6) = 2 microbatches, with a warning) and
    over a full batch of 8, against JAX ``build_pp_lm_eval_step``."""
    layout, micro = (1, 4), 4
    mesh, _, state = _jax_state(jax_params, layout, "sgd")
    jeval = jpp.build_pp_lm_eval_step(JaxLM(vocab_size=VOCAB, **KW), mesh, micro)(state)
    pp_np = jax.tree_util.tree_map(np.asarray, pp_stack_params(jax_params, DEPTH))
    batches = [_batches(73, 1, 6)[0], _batches(74, 1, BATCH)[0]]
    want = [[float(x) for x in jeval(state, jnp.asarray(i), jnp.asarray(t))]
            for i, t in batches]
    store = dist.HashStore()
    logger = logging.getLogger("test_torch_pipeline.eval")

    def rank(r):
        _, _, model, ex, _ = _stage_rank(store, r, layout, pp_np)
        step = build_pp_lm_eval_step(model, ex, micro, logger=logger)
        return [[float(x) for x in step(_t(i), _t(t))] for i, t in batches]

    with caplog.at_level(logging.WARNING, logger=logger.name):
        outs = _thread_ranks(4, rank)
    for r, got in outs.items():
        np.testing.assert_allclose(got, want, rtol=JAX_RTOL, err_msg=f"rank {r}")
    warned = [r for r in caplog.records if r.name == logger.name]
    assert len(warned) == 4 and all("falling back to M=2" in r.getMessage() for r in warned)


# --------------------------------------------------------------------- #
# checks and refusals


def _cfg(model=None, training=None):
    m = dict(name="TransformerLM", embed_dim=D, depth=DEPTH, num_heads=HEADS, max_len=SEQ)
    m.update(model or {})
    return {"model": m, "training": dict(training or {}),
            "dataset": {"name": "synthetic_text", "n_classes": VOCAB, "seq_len": SEQ}}


def _jax_error(cfg) -> str:
    with pytest.raises(ValueError) as err:
        jtopo.parse_topology(SimpleNamespace(distributed=False), cfg,
                             {"sync_bn": False, **cfg["training"]},
                             [(np.zeros(SEQ, np.int32), None)])
    return str(err.value)


@pytest.mark.parametrize("cfg", [
    _cfg(training={"microbatches": 4}),
    _cfg(training={"pp_schedule": "1f1b"}),
    _cfg(training={"pipeline_parallelism": 2, "pp_schedule": "zero-bubble"}),
    _cfg(training={"pipeline_parallelism": 2, "sequence_parallelism": 2,
                   "tensor_parallelism": 2}),
    _cfg(training={"pipeline_parallelism": 4, "microbatches": 2}),
    _cfg(model={"moe_experts": 2}, training={"pipeline_parallelism": 2}),
    {"model": {"name": "ResNet18"}, "training": {"pipeline_parallelism": 2},
     "dataset": {"name": "synthetic", "n_classes": 10}},
], ids=["microbatches-alone", "schedule-alone", "unknown-schedule", "three-way",
        "too-few-microbatches", "moe", "image"])
def test_pipeline_checks_raise_the_jax_messages(cfg):
    want = _jax_error(cfg)
    r = SimpleNamespace()
    with pytest.raises(ValueError) as got:
        parse_model(r, cfg)
        parse_parallelism(r, cfg["training"])
    assert str(got.value) == want


@pytest.mark.parametrize("train", [{"grad_accumulation": 2, "batch_size": 8},
                                   {"microbatches": 4, "batch_size": 6}],
                         ids=["grad-accum", "batch"])
def test_pipeline_batch_checks_raise_the_jax_messages(train):
    micro = train.get("microbatches", 4)
    jr = SimpleNamespace(seq_par=1, tensor_par=1, pipe_par=4, microbatches=micro, is_lm=True,
                         world_size=1, distributed=False)
    with pytest.raises(ValueError) as want:
        jtopo.parse_batch(jr, train)
    with pytest.raises(ValueError) as got:
        check_pipeline_batch(SimpleNamespace(pipe_par=4, microbatches=micro),
                             train["batch_size"], train.get("grad_accumulation", 1))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("what", ["anomaly", "comm", "depth", "lars", "heads"])
def test_pipeline_path_refusals_raise_the_jax_messages(what):
    """JAX ``_build_pipeline``'s refusals, each with its message."""
    depth, heads, tp = (6 if what == "depth" else DEPTH), (6 if what == "heads" else 8), 4
    jr = SimpleNamespace(anomaly_enabled=what == "anomaly", pipe_par=4,
                         comm=SimpleNamespace(overlap=what == "comm"),
                         model=SimpleNamespace(depth=depth, num_heads=heads),
                         optimizer=(jopt.LARS(lr=0.1) if what == "lars" else jopt.SGD(lr=0.1)),
                         tensor_par=tp if what == "heads" else 1)
    with pytest.raises(ValueError) as want:
        jpaths._build_pipeline(jr, 0, None)
    r = SimpleNamespace(anomaly_enabled=jr.anomaly_enabled, pipe_par=4, tensor_par=jr.tensor_par)
    with pytest.raises(ValueError) as got:
        check_pipeline(r, {"comm": {"overlap": what == "comm"}},
                       {"depth": depth, "num_heads": heads},
                       topt.LARS if what == "lars" else topt.SGD)
    assert str(got.value) == str(want.value)


_RANKS_CHECK = r"training.pipeline_parallelism \(4\) must divide the number of ranks \(1\)"


@pytest.mark.parametrize("training,model,match", [
    ({"tensor_parallelism": 2}, None, _RANKS_CHECK),
    ({"sequence_parallelism": 2}, None, _RANKS_CHECK),
    ({"zero": 1}, None, _RANKS_CHECK),
    ({"zero": 2}, None, _RANKS_CHECK),
    ({"zero": 3}, None, r"^training.zero: 3 does not compose with pipeline_parallelism — use "
                        r"zero: 1 or 2 under the pipeline$"),
    ({"tensor_parallelism": 2, "sequence_parallelism": 2}, None,
     r"^pipeline_parallelism x sequence_parallelism x tensor_parallelism \(three-way\) is not "
     r"wired; pick PP x SP or PP x TP$"),
    ({}, {"moe_experts": 2}, r"^model.moe_experts does not compose with pipeline_parallelism$"),
], ids=["tp", "sp", "zero1", "zero2", "zero3", "tp-sp", "moe"])
def test_pipeline_beside_other_families_names_p9(tmp_path, training, model, match):
    """The pipeline beside tensor or sequence parallelism or ZeRO-1/2 names P9
    no more: the runner at one rank passes every refusal and meets the ranks
    check (the compositions run in tests/test_torch_pipeline_compose.py);
    ZeRO-3 beside it, the three-way PP x SP x TP and a MoE LM under it raise
    the JAX messages."""
    cfg = _pp_cfg(tmp_path, **training)
    cfg["model"].update(model or {})
    with pytest.raises(ValueError, match=match):
        Runner(1, 0, 0, "", False, None, cfg, device="cpu")()


# --------------------------------------------------------------------- #
# the runner


def _pp_cfg(tmp_path, **training):
    """``config/TransformerLM-pp.yml`` at a tiny width: 4 blocks of d 128 and
    2 heads (head dim 64: the runner builds with flash on, and S 32 takes the
    einsum), vocab 128, batch 8 as its 8 microbatches."""
    with open(os.path.join(REPO, "config", "TransformerLM-pp.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"].update(root=str(tmp_path), n_classes=VOCAB, seq_len=32, n_samples=16)
    cfg["training"].update({**dict(train_iters=4, print_interval=1, val_interval=100,
                                   batch_size=8, num_workers=0, dtype="float32"),
                            **training})
    cfg["validation"].update(batch_size=8, num_workers=0)
    cfg["model"].update(embed_dim=128, depth=DEPTH, num_heads=2, max_len=32)
    return cfg


_RANK = """
import json, sys
import torch
from pytorch_distributed_training_tpu_torch.engine import Runner
torch.set_num_threads(1)
rank, world, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
for i, name in enumerate(json.load(open(path + "/runs.json"))):
    cfg = json.load(open(path + f"/{name}.json"))
    port = json.load(open(path + "/ports.json"))[i]
    r = Runner(world, rank, 0, f"tcp://127.0.0.1:{port}", False, None, cfg, device="cpu")
    r()
    json.dump({"loss": [x["loss"] for x in r.train_log], "val": r.val_log, "path": r.path,
               "blocks": list(r.model.block_ids),
               "restored": (r.checkpointer.last_restore or {}).get("step")
               if r.checkpointer is not None else None},
              open(path + f"/{name}.rank{rank}.json", "w"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_runner_trains_the_pp_config(tmp_path):
    """Four gloo processes run ``config/TransformerLM-pp.yml``'s training
    block (4 stages, 1F1B over 8 microbatches) for 4 steps; the same for 2
    steps with a checkpoint, then resumed to 4; and GPipe for 4.  The resumed
    run repeats the straight one bit for bit, GPipe and the one-rank runner
    follow it, and the checkpoint holds the one-rank model's leaves."""
    world, ck = 4, tmp_path / "ck"
    runs = {"straight": _pp_cfg(tmp_path),
            "first": _pp_cfg(tmp_path, train_iters=2,
                             checkpoint=dict(dir=str(ck), interval=2, max_to_keep=5)),
            "resumed": _pp_cfg(tmp_path, checkpoint=dict(dir=str(ck), interval=100,
                                                         max_to_keep=5)),
            "gpipe": _pp_cfg(tmp_path, pp_schedule="gpipe")}
    assert runs["straight"]["training"]["pp_schedule"] == "1f1b"
    for name, cfg in runs.items():
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump(cfg, f)
    with open(tmp_path / "runs.json", "w") as f:
        json.dump(list(runs), f)
    with open(tmp_path / "ports.json", "w") as f:
        json.dump([_free_port() for _ in runs], f)
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(world), str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env) for r in range(world)]
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = {name: [json.load(open(tmp_path / f"{name}.rank{r}.json")) for r in range(world)]
           for name in runs}
    for name, ranks in got.items():
        for r, out in enumerate(ranks):
            assert out["path"] == "pipeline" and out["blocks"] == [r]
            assert out["loss"] == ranks[0]["loss"] and np.isfinite(out["loss"]).all()
            assert out["val"] == ranks[0]["val"]  # the reduced metrics on every stage
        assert len(ranks[0]["val"]) == 1 and np.isfinite(ranks[0]["val"][0]["loss"])
    straight = got["straight"][0]["loss"]
    assert got["resumed"][0]["restored"] == 1
    assert got["resumed"][0]["loss"] == straight[2:]  # bit for bit
    assert got["resumed"][0]["val"] == got["straight"][0]["val"]
    np.testing.assert_allclose(got["gpipe"][0]["loss"], straight, rtol=1e-5)
    # every stage of the data group took the one-rank runner's batches
    cfg = _pp_cfg(tmp_path)
    for key in ("microbatches", "pp_schedule", "pipeline_parallelism"):
        cfg["training"].pop(key)
    one = Runner(1, 0, 0, "", False, None, cfg, device="cpu")
    one()
    np.testing.assert_allclose([x["loss"] for x in one.train_log], straight, rtol=1e-5)
    # per-layer leaves of the one-rank model, rank 0's parameters and moments
    payload = torch.load(ck / "1" / "state.pt", weights_only=True)
    with torch.device("meta"):
        template = TransformerLM(VOCAB, **{k: v for k, v in runs["first"]["model"].items()
                                           if k != "name"}).state_dict()
    assert {k: tuple(v.shape) for k, v in payload["model"].items()} == {
        k: tuple(v.shape) for k, v in template.items()}
    for slot in payload["optimizer"]["slots"].values():
        assert sorted(slot) == sorted(template)
    assert not math.isnan(float(payload["model"]["block3.ln2.weight"].sum()))
