"""The port's ZeRO-1/2/3 (``training.zero``: ``parallel/tensor.py``'s
``zero_shard_dim`` and ``ZeroPlan``, the ZeRO-3 gathers of
``models/transformer_lm.py``, ``engine/tp_steps.py`` over the data group)
against the JAX package's GSPMD step with ``zero`` and the port's one-rank
step on the CPU.

Small on purpose, as ``tests/test_torch_tensor_parallel.py``: 2 blocks, d 64,
4 heads, vocab 128, S 64 (the einsum attention), batch 4; the MoE LM has 4
experts, top 2, in block 1.  The JAX weights are drawn with numpy over
``jax.eval_shape``'s tree (the router x4), the JAX legs run compiled at XLA's
lowest optimisation on ``make_3d_mesh(1, T)`` over ``n_data * T`` CPU devices,
and the port's ranks are gloo thread ranks over one ``HashStore`` (rank ``r =
data_idx * T + model_idx``; a data group and a model group each).

- the leaf rule against JAX ``zero_shard_moment`` leaf by leaf (dense and
  MoE; 2, 3 and 4 data ranks, T 1 and 2);
- zero 1, 2 and 3 at data 2 x T 1 (dense), zero 2 with ``grad_accumulation``
  2, zero 3 at data 2 x T 2 (dense and MoE at EP 2) and 2 x 1 (MoE at EP 1),
  2 SGD steps: the losses within
  rtol 1e-5 of JAX's and the parameters after within atol 1e-5, each rank's
  momentum slices within atol 1e-5 of the JAX device's addressable shard of
  the same elements; against the port's one-rank step the losses within
  rtol 1e-6, every gathered gradient and momentum buffer (a sum of
  gradients) within 1e-5 and every gathered parameter within 1e-6 of its
  largest magnitude (the TP file's limits); each rank's state bytes equal
  the rule's;
- 2 AdamW steps at zero 1 (2 x 1) and zero 3 (2 x 2): losses against JAX;
- LAMB beside T 2 and beside zero 1, 3 steps: losses within rtol 1e-5 and
  parameters within atol 1e-4 of JAX's (whole leaves' trust ratios; see
  ``LAMB_ATOL``), and the trust ratios taken over a rank's parts alone
  rejected;
- the JAX ``ValueError``s of ``training.zero``, the refusals that still name
  P9 (``comm.overlap`` beside ZeRO-1, SP beside ZeRO) and ``comm.overlap``
  beside ZeRO-2 refused with the GSPMD path's JAX message;
- the runner on ``configs/train-lm-fsdp.yml`` at a tiny width and depth
  (two gloo processes, ZeRO-3): the checkpoint (full leaves) resumes at
  ZeRO-3 bit for bit, restores at zero 0 on one rank, where it continues bit
  for bit like a zero-0 step given the same state, and serves through
  ``load_serving_state``.
"""
import json
import os
import shutil
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
from pytorch_distributed_training_tpu.engine import topology as jtopo
from pytorch_distributed_training_tpu.engine.tp_steps import build_tp_lm_train_step as jax_tp_step
from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.parallel import make_3d_mesh
from pytorch_distributed_training_tpu.parallel.tensor import (
    lm_tp_shardings,
    tp_state_shardings,
    zero_shard_moment,
)
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch.engine import Runner
from pytorch_distributed_training_tpu_torch.engine.checkpoint import (
    load_serving_state,
    restore_training_state,
)
from pytorch_distributed_training_tpu_torch.engine.topology import (
    check_gspmd_path,
    gspmd_path,
    parse_model,
    parse_parallelism,
)
from pytorch_distributed_training_tpu_torch.engine.tp_steps import build_tp_lm_train_step
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.parallel import TensorGroup
from pytorch_distributed_training_tpu_torch.parallel.tensor import shard_dim, zero_shard_dim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, D, HEADS, DEPTH, BATCH, E = 128, 64, 64, 4, 2, 4, 4
SGD_KW = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)
ADAMW_KW = dict(lr=1e-3, weight_decay=0.1)
LAMB_KW = dict(lr=2e-2, weight_decay=0.01)
KINDS = {
    "dense": dict(max_len=SEQ, embed_dim=D, depth=DEPTH, num_heads=HEADS),
    "moe": dict(max_len=SEQ, embed_dim=D, depth=DEPTH, num_heads=HEADS, moe_experts=E,
                moe_top_k=2, moe_capacity_factor=1.25, moe_aux_weight=0.01, moe_every=2),
}
# the TP file's limits: port n ranks against the port's one rank (f32 sums
# reassociated by the reduces), and the JAX step's
PORT_RTOL, GRAD_TOL, JAX_RTOL, JAX_ATOL = 1e-6, 1e-5, 1e-5, 1e-5
# LAMB's parameters against JAX's after 3 steps at lr 2e-2: its Adam-type
# direction amplifies f32 noise in near-zero gradients (the k part of the qkv
# bias, whose gradient is 0 up to rounding), as AdamW does in the TP file.
# Measured: 1.1e-5-1.5e-5 (rank >= 2 leaves) and 7.4e-5 (that bias) with
# whole-leaf norms; 6.8e-4-1.5e-3 with the trust ratios over a rank's parts
LAMB_ATOL = 1e-4
FAST_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
            "xla_cpu_parallel_codegen_split_count": 1, "xla_cpu_multi_thread_eigen": False}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(shapes, seed: int):
    """Weights for a flax tree: kernels and stacked experts at lecun scale
    (the router x4), small random biases, scales near 1, embeddings at 0.5."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        where = "/".join(str(getattr(k, "key", k)) for k in path)
        if name in ("kernel", "wi", "wo"):
            scale = (4.0 if "router" in where else 1.0) / np.sqrt(sd.shape[-2])
            arr = rng.normal(0.0, scale, sd.shape)
        elif name == "scale":
            arr = 1.0 + 0.1 * rng.normal(size=sd.shape)
        elif "embedding" in name:
            arr = 0.5 * rng.normal(size=sd.shape)
        else:
            arr = 0.05 * rng.normal(size=sd.shape)
        return arr.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batches(seed: int, n: int = 2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
        out.append((toks[:, :-1], toks[:, 1:]))
    return out


def _port_name(path) -> tuple:
    """The port's ``state_dict`` key of a flax leaf path, and whether the
    leaf is a kernel (transposed in the port)."""
    keys = [str(getattr(k, "key", k)) for k in path]
    leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
    return ".".join(keys[:-1] + [leaf]), keys[-1] == "kernel"


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for i, (kind, kw) in enumerate(KINDS.items()):
        shapes = jax.eval_shape(JaxLM(vocab_size=VOCAB, **kw).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, SEQ), jnp.int32))
        out[kind] = _draw(shapes["params"], 40 + i)
    return out


def _jax_opt(opt: str):
    return {"sgd": lambda: jopt.SGD(**SGD_KW), "adamw": lambda: jopt.AdamW(**ADAMW_KW),
            "lamb": lambda: jopt.LAMB(**LAMB_KW)}[opt]()


def _lr(opt: str) -> float:
    return {"sgd": SGD_KW, "adamw": ADAMW_KW, "lamb": LAMB_KW}[opt]["lr"]


_JAX_RUNS = {}


def _jax_run(params, kind, layout, opt, batches, accum=1, zero=0):
    """JAX ``build_tp_lm_train_step(zero=zero)`` on ``make_3d_mesh(1, T)``
    over ``n_data * T`` CPU devices, compiled once a case: the losses, the
    parameters after (port names) and, after SGD, each device's addressable
    shard of every momentum leaf (flax layout), by ``(data_idx, model_idx)``."""
    key = (kind, layout, opt, accum, zero)
    if key not in _JAX_RUNS:
        n_data, t = layout
        jm, jo = JaxLM(vocab_size=VOCAB, **KINDS[kind]), _jax_opt(opt)
        mesh = make_3d_mesh(1, t, devices=jax.devices()[:n_data * t])
        zeros = jax.tree_util.tree_map(lambda sd: np.zeros(sd.shape, sd.dtype),
                                       jax.eval_shape(jo.init, params))
        state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params), batch_stats={},
                           opt_state=zeros)
        state = jax.device_put(state, tp_state_shardings(state, mesh, zero=zero))
        inp, tgt = (jnp.asarray(a) for a in batches[0])
        step = jax_tp_step(jm, jo, lambda _: jnp.float32(_lr(opt)), mesh, donate=False,
                           zero=zero, grad_accum=accum)(state).lower(state, inp, tgt).compile(
            compiler_options=FAST_XLA)
        losses = []
        for inp, tgt in batches:
            state, loss = step(state, jnp.asarray(inp), jnp.asarray(tgt))
            losses.append(float(loss))
        shards = {}
        if opt == "sgd":
            where = {dev: (d, m) for (d, _, m), dev in np.ndenumerate(mesh.devices)}
            for path, leaf in jax.tree_util.tree_flatten_with_path(state.opt_state.momentum)[0]:
                name, _ = _port_name(path)
                for sh in leaf.addressable_shards:
                    shards[(name,) + where[sh.device]] = np.asarray(sh.data)
        _JAX_RUNS[key] = losses, lm_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params)), shards
    return _JAX_RUNS[key]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).long()


def _port_opt(opt: str):
    return {"sgd": lambda: topt.SGD(**SGD_KW), "adamw": lambda: topt.AdamW(**ADAMW_KW),
            "lamb": lambda: topt.LAMB(**LAMB_KW)}[opt]()


def _port_run(full, batches, layout, kw, opt="sgd", accum=1, zero=0, local_norms=False):
    """The port's GSPMD-path step at ZeRO stage ``zero`` on ``n_data x T``
    gloo thread ranks, each holding its data rows of every batch.  Per rank:
    the losses, the first step's gradients as the optimizer takes them (by
    name), the full ``state_dict`` after (gathered), the momentum slices by
    name (SGD) and the step's state bytes.  ``local_norms``: LAMB's trust
    ratios over this rank's parts alone (a wrong variant)."""
    n_data, t = layout
    world = n_data * t
    store, outs, errors = dist.HashStore(), {}, []

    def rank(r):
        try:
            d, m = divmod(r, t)
            timeout = timedelta(seconds=60)
            tg = (TensorGroup(dist.ProcessGroupGloo(dist.PrefixStore(f"model{d}", store), m, t,
                                                    timeout)) if t > 1 else None)
            data = (dist.ProcessGroupGloo(dist.PrefixStore(f"data{m}", store), d, n_data, timeout)
                    if n_data > 1 else None)
            zg = TensorGroup(data, n_data, d) if zero >= 3 and n_data > 1 else None
            model = TransformerLM(VOCAB, fused_tails=True, tensor_group=tg, zero_group=zg, **kw)
            model.load_full_state_dict(full)
            step = build_tp_lm_train_step(model, _port_opt(opt), lambda i: _lr(opt),
                                          world_size=n_data, group=data, grad_accum=accum,
                                          zero=zero)
            if local_norms:
                step._whole_norms = lambda norms, idx: norms
            names = [n for n, _ in model.named_parameters()]
            out = {"loss": []}
            update = step.optimizer.update

            def record(params, grads, state, lr, **kw):
                if "grads" not in out:
                    out["grads"] = {n: g.detach().clone() for n, g in zip(names, grads)}
                return update(params, grads, state, lr, **kw)

            step.optimizer.update = record
            rows = BATCH // n_data
            for inp, tgt in batches:
                sl = slice(d * rows, (d + 1) * rows)
                out["loss"].append(float(step(_t(inp[sl]), _t(tgt[sl]))))
            out["state"] = {k: v.detach().clone() for k, v in model.full_state_dict().items()}
            if opt == "sgd":
                out["momentum"] = {n: v.clone() for n, v in zip(names, step.opt_state.momentum)}
            out["bytes"] = step.state_bytes()
            out["shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
            outs[r] = out
        except BaseException as err:  # re-raised below, in the test's thread
            errors.append(err)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not errors and len(outs) == world, errors
    return outs


def _local_shapes(kw, t):
    """The leaves' shapes on a model rank of ``t`` (the tensor split only)."""
    with torch.device("meta"):
        tg = TensorGroup(None, t, 0) if t > 1 else None
        return {n: tuple(p.shape) for n, p in TransformerLM(VOCAB, tensor_group=tg,
                                                             **kw).named_parameters()}


def _assemble(outs, layout, key, kw, zero_layout: bool):
    """The full leaves of ``outs[r][key]`` (by name): each data group's
    slices put together along the rule's dim (``zero_layout``), then each
    model group's along the tensor split's."""
    n_data, t = layout
    local = _local_shapes(kw, t)
    by_model = []
    for m in range(t):
        parts = [outs[d * t + m][key] for d in range(n_data)]
        joined = {}
        for name in parts[0]:
            zd = zero_shard_dim(name, local[name], n_data) if zero_layout else None
            joined[name] = (parts[0][name] if zd is None
                            else torch.cat([p[name] for p in parts], zd))
        by_model.append(joined)
    return {n: (by_model[0][n] if shard_dim(n) is None or t == 1
                else torch.cat([p[n] for p in by_model], shard_dim(n))) for n in by_model[0]}


def _close(got, want, what: str, tol: float) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"{what}: max |got - want| / max |want| = {err}"
    return err


def _rule_bytes(kw, layout, zero: int, moments: int) -> dict:
    """Each rank's bytes of f32 parameters, gradients and moments at stage
    ``zero`` by the rule: a leaf's slice where the stage shards it and the
    rule splits it, else the leaf."""
    n_data, t = layout
    out = dict(params=0, grads=0, moments=0)
    for name, shape in _local_shapes(kw, t).items():
        whole = int(np.prod(shape)) * 4
        split = zero_shard_dim(name, shape, n_data) is not None
        part = whole // n_data if split else whole
        out["params"] += part if zero >= 3 else whole
        out["grads"] += part if zero >= 2 else whole
        out["moments"] += moments * (part if zero >= 1 else whole)
    return out


# --------------------------------------------------------------------- #
# the rule


@pytest.mark.parametrize("layout", [(2, 1), (3, 1), (4, 1), (2, 2), (4, 2)],
                         ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("kind", list(KINDS))
def test_zero_rule_matches_jax_zero_shard_moment(jax_params, kind, layout):
    """Every leaf's ZeRO dim in the port's layout is the one JAX's
    ``zero_shard_moment`` gives it, the kernels transposed."""
    n_data, t = layout
    params = jax_params[kind]
    mesh = make_3d_mesh(1, t, devices=jax.devices()[:n_data * t])
    specs = jax.tree.map(lambda sh, leaf: zero_shard_moment(sh, leaf, mesh),
                         lm_tp_shardings(params, mesh), params)
    full = lm_state_dict_from_jax(params)
    split = 0
    for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
        name, kernel = _port_name(path)
        spec = list(sh.spec)
        jax_dim = next((i for i, a in enumerate(spec) if a == "data"), None)
        if jax_dim is not None and kernel:
            jax_dim = 1 - jax_dim
        assert zero_shard_dim(name, tuple(full[name].shape), n_data) == jax_dim, name
        split += jax_dim is not None
    assert split > 0 if n_data != 3 else split < len(full)


# --------------------------------------------------------------------- #
# the step against JAX and the one-rank step

CASES = {
    "z1-2x1": ("dense", (2, 1), 1, 1),
    "z2-2x1": ("dense", (2, 1), 2, 1),
    "z3-2x1": ("dense", (2, 1), 3, 1),
    "z2-2x1-accum2": ("dense", (2, 1), 2, 2),
    "z3-2x2": ("dense", (2, 2), 3, 1),
    "z3-2x2-moe": ("moe", (2, 2), 3, 1),
    "z3-2x1-moe": ("moe", (2, 1), 3, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_zero_step_matches_jax_and_one_rank(jax_params, case):
    kind, layout, zero, accum = CASES[case]
    n_data, t = layout
    kw, params = KINDS[kind], jax_params[kind]
    full = lm_state_dict_from_jax(params)
    batches = _batches(60)
    outs = _port_run(full, batches, layout, kw, accum=accum, zero=zero)
    one = _port_run(full, batches, (1, 1), kw, accum=accum)[0]
    jlosses, jafter, jshards = _jax_run(params, kind, layout, "sgd", batches, accum, zero)
    for r, got in outs.items():
        np.testing.assert_allclose(got["loss"], jlosses, rtol=JAX_RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=PORT_RTOL)
        # the state each rank holds is the rule's
        assert got["bytes"] == _rule_bytes(kw, layout, zero, moments=1), (r, got["bytes"])
        # each rank's momentum slice is the JAX device's shard of the same elements
        d, m = divmod(r, t)
        for name, mom in got["momentum"].items():
            mom = mom.numpy()
            want = jshards[(name, d, m)]
            np.testing.assert_allclose(mom.T if mom.ndim == 2 and name.endswith(".weight")
                                       else mom, want, atol=JAX_ATOL, err_msg=f"{name} rank {r}")
        # the state after is whole and equal on every rank
        for name, want in jafter.items():
            np.testing.assert_allclose(got["state"][name].numpy(), want.numpy(), atol=JAX_ATOL,
                                       err_msg=f"jax {name}")
            _close(got["state"][name], one["state"][name], f"after {name}", PORT_RTOL)
    grads = _assemble(outs, layout, "grads", kw, zero_layout=True)
    moms = _assemble(outs, layout, "momentum", kw, zero_layout=True)
    for name in one["grads"]:
        _close(grads[name], one["grads"][name], f"grad {name}", GRAD_TOL)
        # the momentum buffer is a sum of the two steps' gradients: their limit
        _close(moms[name], one["momentum"][name], f"momentum {name}", GRAD_TOL)
    # ZeRO-3 holds slices: a rank's leaves are the rule's
    if zero >= 3:
        local = _local_shapes(kw, t)
        for name, shape in outs[0]["shapes"].items():
            zd = zero_shard_dim(name, local[name], n_data)
            want = list(local[name])
            if zd is not None:
                want[zd] //= n_data
            assert shape == tuple(want), name


@pytest.mark.parametrize("case", ["z1-2x1", "z3-2x2"])
def test_zero_adamw_losses_match_jax(jax_params, case):
    kind, layout, zero, accum = CASES[case]
    params = jax_params[kind]
    full = lm_state_dict_from_jax(params)
    batches = _batches(61)
    outs = _port_run(full, batches, layout, KINDS[kind], opt="adamw", zero=zero)
    jlosses, _, _ = _jax_run(params, kind, layout, "adamw", batches, zero=zero)
    for r, got in outs.items():
        np.testing.assert_allclose(got["loss"], jlosses, rtol=JAX_RTOL, err_msg=f"rank {r}")
        assert got["bytes"] == _rule_bytes(KINDS[kind], layout, zero, moments=2)


@pytest.mark.parametrize("layout,zero", [((1, 2), 0), ((2, 1), 1)], ids=["T2", "zero1"])
def test_lamb_takes_whole_leaf_norms(jax_params, layout, zero):
    """LAMB's trust ratios over whole leaves beside tensor parallelism and
    beside ZeRO-1: 3 steps against JAX's; the ratios over a rank's parts
    alone move the parameters past the limit."""
    params = jax_params["dense"]
    full = lm_state_dict_from_jax(params)
    batches = _batches(62, 3)
    jlosses, jafter, _ = _jax_run(params, "dense", layout, "lamb", batches, zero=zero)
    outs = _port_run(full, batches, layout, KINDS["dense"], opt="lamb", zero=zero)
    for r, got in outs.items():
        np.testing.assert_allclose(got["loss"], jlosses, rtol=JAX_RTOL, err_msg=f"rank {r}")
        for name, want in jafter.items():
            np.testing.assert_allclose(got["state"][name].numpy(), want.numpy(), atol=LAMB_ATOL,
                                       err_msg=name)
    wrong = _port_run(full, batches, layout, KINDS["dense"], opt="lamb", zero=zero,
                      local_norms=True)[0]["state"]
    worst = max(float((wrong[n] - jafter[n]).abs().max()) for n in jafter)
    assert worst > 5 * LAMB_ATOL, worst


def test_flash_fold_of_a_one_row_micro_batch_is_contiguous():
    """A ZeRO-2 rank's micro-batch can be one row (the fsdp config's 8 rows
    as 8 micro-batches): the kernels take the folded q/k/v only contiguous,
    and at B = 1 the fold of a qkv column would be a strided view."""
    from pytorch_distributed_training_tpu_torch.ops.flash_attention import _fold

    for b in (1, 2):
        qkv = torch.randn(b, 128, 4, 3, 64)
        folded = _fold(qkv[:, :, :, 0])
        assert folded.is_contiguous() and torch.equal(
            folded, qkv[:, :, :, 0].permute(0, 2, 1, 3).reshape(b * 4, 128, 64))


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
    _cfg(training={"zero": 5}),
    _cfg(training={"zero": "3"}),
    _cfg(training={"zero": 1.0}),
    {"model": {"name": "ResNet18"}, "training": {"zero": 1},
     "dataset": {"name": "synthetic", "n_classes": 10}},
    _cfg(training={"zero": 3, "pipeline_parallelism": 2, "microbatches": 2}),
], ids=["stage-5", "string", "float", "image", "zero3-pipeline"])
def test_zero_checks_raise_the_jax_messages(cfg):
    want = _jax_error(cfg)
    r = SimpleNamespace()
    with pytest.raises(ValueError) as got:
        parse_model(r, cfg)
        parse_parallelism(r, cfg["training"])
    assert str(got.value) == want


def test_zero_values_and_routes():
    for value, stage in ((True, 1), (False, 0), (0, 0), (2, 2), (3, 3)):
        r = SimpleNamespace()
        parse_model(r, _cfg(training={"zero": value}))
        parse_parallelism(r, {"zero": value})
        assert r.zero == stage and gspmd_path(r, {"zero": value}) == bool(stage)
    # comm.overlap beside zero 2 routes to the GSPMD path, whose JAX refusal it meets;
    # beside zero 1 it is JAX's ring-sp-zero1 path (P9, test_zero_refusals_name_p9)
    for stage, gspmd in ((2, True), (1, False)):
        train = {"zero": stage, "comm": {"overlap": True}}
        r = SimpleNamespace(anomaly_enabled=False)
        parse_model(r, _cfg(training=train))
        parse_parallelism(r, train)
        assert gspmd_path(r, train) == gspmd
    with pytest.raises(ValueError) as want:
        jpaths._reject_comm(SimpleNamespace(comm=SimpleNamespace(overlap=True)), "gspmd")
    with pytest.raises(ValueError) as got:
        check_gspmd_path(SimpleNamespace(anomaly_enabled=False), {"comm": {"overlap": True}})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("training", [
    {"zero": 1, "comm": {"overlap": True}},
    {"zero": True, "comm": {"overlap": True}},
    {"zero": 1, "sequence_parallelism": 2},
    {"zero": 1, "pipeline_parallelism": 2},
], ids=["comm-zero1", "comm-zero-true", "sp", "pipeline"])
def test_zero_refusals_name_p9(tmp_path, training):
    with pytest.raises(NotImplementedError, match="P9"):
        Runner(1, 0, 0, "", False, None, _fsdp_cfg(tmp_path, **training), device="cpu")()


# --------------------------------------------------------------------- #
# the runner


def _fsdp_cfg(tmp_path, **training):
    with open(os.path.join(REPO, "pytorch_distributed_training_tpu_torch", "configs",
                           "train-lm-fsdp.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"].update(root=str(tmp_path), n_classes=VOCAB, seq_len=SEQ, n_samples=16)
    cfg["training"].pop("checkpoint")  # the tests choose their own
    cfg["training"].update({**dict(train_iters=4, print_interval=1, val_interval=100,
                                   batch_size=4, num_workers=0, grad_accumulation=2),
                            **training})
    cfg["validation"].update(batch_size=4, num_workers=0)
    # the runner builds with flash on: head dim 64 (S 64 takes the einsum)
    cfg["model"].update(embed_dim=256, depth=DEPTH, num_heads=HEADS, max_len=SEQ)
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
    json.dump({"loss": [x["loss"] for x in r.train_log], "val": r.val_log,
               "path": r.path, "zero": r.train_step.zero,
               "bytes": r.train_step.state_bytes(),
               "params": sum(p.numel() for p in r.model.parameters())},
              open(path + f"/{name}.rank{rank}.json", "w"))
"""


class _Recording(Runner):
    """A runner that keeps every training batch it takes."""

    def train_iter(self, inputs, labels) -> None:
        self.__dict__.setdefault("batches", []).append((inputs.clone(), labels.clone()))
        super().train_iter(inputs, labels)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_runner_takes_the_fsdp_config(tmp_path):
    """Two gloo processes run ``configs/train-lm-fsdp.yml``'s training block
    (ZeRO-3 over 2 data ranks) for 4 steps with a checkpoint every 2, then
    the same resumed from the step-1 checkpoint alone; the step-1
    checkpoint restores at zero 0 on one rank and serves."""
    world = 2
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    ck = dict(dir=str(straight), interval=2, max_to_keep=5)
    runs = {"straight": _fsdp_cfg(tmp_path, checkpoint=ck),
            "resumed": _fsdp_cfg(tmp_path, checkpoint={**ck, "dir": str(resumed)})}
    assert all(c["training"]["zero"] == 3 for c in runs.values())
    for name, cfg in runs.items():
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump(cfg, f)
    env = {**os.environ, "PYTHONPATH": REPO}

    def launch(names):
        with open(tmp_path / "runs.json", "w") as f:
            json.dump(names, f)
        with open(tmp_path / "ports.json", "w") as f:
            json.dump([_free_port() for _ in names], f)
        procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(world),
                                   str(tmp_path)], cwd=REPO, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, env=env) for r in range(world)]
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
        assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    launch(["straight"])
    os.makedirs(resumed)
    shutil.copytree(straight / "1", resumed / "1")
    shutil.copy(straight / "pipeline_1.json", resumed / "pipeline_1.json")
    launch(["resumed"])
    got = {name: [json.load(open(tmp_path / f"{name}.rank{r}.json")) for r in range(world)]
           for name in runs}
    one = TransformerLM(VOCAB, **{k: v for k, v in runs["straight"]["model"].items()
                                  if k != "name"})
    n_full = sum(p.numel() for p in one.parameters())
    for ranks in got.values():
        for r in ranks:
            assert r["path"] == "gspmd" and r["zero"] == 3 and np.isfinite(r["loss"]).all()
            assert r["loss"] == ranks[0]["loss"]  # the global loss on every rank
            assert r["params"] < n_full  # this rank's slices
        assert len(ranks[0]["val"]) == 1 and np.isfinite(ranks[0]["val"][0]["loss"])
    # the resumed run repeats steps 2-3 bit for bit
    assert got["resumed"][0]["loss"] == got["straight"][0]["loss"][2:]

    # the step-1 checkpoint (full leaves) restores at zero 0 on one rank and
    # continues as a zero-0 step given the same state does, bit for bit
    at_zero0 = tmp_path / "at_zero0"
    os.makedirs(at_zero0)
    shutil.copytree(straight / "1", at_zero0 / "1")
    shutil.copy(straight / "pipeline_1.json", at_zero0 / "pipeline_1.json")
    cfg = _fsdp_cfg(tmp_path, zero=0, checkpoint=dict(dir=str(at_zero0), interval=100))
    zero0 = _Recording(1, 0, 0, "", False, None, cfg, device="cpu")
    zero0()
    assert zero0.checkpointer.last_restore["step"] == 1 and len(zero0.batches) == 2
    twin = Runner(1, 0, 0, "", False, None, _fsdp_cfg(tmp_path, zero=0, train_iters=0),
                  device="cpu")
    twin()  # the same model and step, no step taken
    payload = torch.load(straight / "1" / "state.pt", weights_only=True)
    assert restore_training_state(payload, twin.model, twin.train_step) == 1
    for k, v in payload["model"].items():
        assert torch.equal(twin.model.state_dict()[k], v), k
    losses = [float(twin.train_step(*batch)) for batch in zero0.batches]
    assert losses == [x["loss"] for x in zero0.train_log]
    for k, v in twin.model.state_dict().items():
        assert torch.equal(zero0.model.state_dict()[k], v), k

    # the ZeRO-3 checkpoint serves on one card: full leaves of the one-rank shapes
    state, step_no = load_serving_state(str(straight))
    assert step_no == 3
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in one.state_dict().items()}
    one.load_state_dict(state, strict=True)
    with torch.no_grad():
        assert torch.isfinite(one(torch.zeros(1, 8, dtype=torch.long))).all()
