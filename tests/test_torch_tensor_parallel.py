"""The port's Megatron tensor parallelism and expert parallelism
(``parallel/tensor.py``, the column/row ``Dense``, attention over ``H / T``
heads, ``MoEMLP`` over ``E / T`` experts, ``engine/tp_steps.py`` on the data
group) against the JAX package's GSPMD step and the port's one-rank step on
the CPU.

Small on purpose: 2 blocks, d 64, 4 heads, vocab 128, S 64 (the einsum
attention), batch 4; the MoE LM has 4 experts, top 2, in block 1.  The JAX
weights are drawn with numpy over ``jax.eval_shape``'s tree (the router x4,
so no token's 2nd and 3rd router logits lie within 1e-3), the JAX legs run
compiled at XLA's lowest optimisation, and the port's ranks are gloo ranks
as threads, a process group of their own each over one ``HashStore`` (rank
``r = data_idx * T + model_idx``).

- the leaf roles against JAX ``lm_tp_param_specs`` over the same tree
  (dense and MoE); ``shard_param``/``gather_state_dict`` bit for bit; a T-rank
  model built from a seed holds the one-rank model's slices, and so does
  ``lm_state_dict_from_jax`` with a tensor group;
- T = 2, T = 4 and 2 data x 2 model, dense and MoE (EP = T), 2 SGD steps:
  the losses within rtol 1e-5 of JAX ``build_tp_lm_train_step`` on
  ``make_3d_mesh(1, T)`` from the same weights and the parameters after
  within atol 1e-5 (the repo's other LM step tests' limits); against the
  port's one-rank step the losses within rtol 1e-6, every gathered gradient
  of the first step within 1e-5 and every gathered parameter after within
  1e-6 of its largest magnitude (measured: 2.2e-6 and 1.1e-7 at most, f32
  sums reassociated by the reduces); MoE: the chosen experts and the kept assignments of
  every rank equal the one-rank layer's and the aux objective within rtol
  1e-6; the eval step over the data group within 1e-6;
- 2 AdamW steps at T = 4: losses against JAX (rtol 1e-5; AdamW amplifies
  f32 noise in exactly-zero gradients, so parameters are compared after SGD);
- ``grad_accumulation`` 2 under EP = 2 against JAX and the one-rank step;
- the flash path (head dim 64, S 128, the kernels' CPU twins) at T = 2
  against the one-rank step;
- the runner (four gloo processes) on ``config/TransformerLM-tp.yml``'s and
  ``config/TransformerLM-moe.yml``'s ``training:`` blocks at a tiny width
  and depth, ``tensor_parallelism: 4`` kept: a model group draws one
  sample set; the TP run's checkpoint resumes at T = 4 bit for bit,
  restores at T = 1 and serves through ``load_serving_state``;
- the topology checks with the JAX messages, ``training.expert_parallelism``
  left unread, and the refusals that still name P9 (ZeRO and LARS/LAMB
  beside tensor parallelism are ported: ``tests/test_torch_zero.py``).
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
from jax.sharding import PartitionSpec as P

from pytorch_distributed_training_tpu import optimizers as jopt
from pytorch_distributed_training_tpu.engine import TrainState
from pytorch_distributed_training_tpu.engine import topology as jtopo
from pytorch_distributed_training_tpu.engine.tp_steps import build_tp_lm_train_step as jax_tp_step
from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.parallel import make_3d_mesh
from pytorch_distributed_training_tpu.parallel.tensor import lm_tp_param_specs, tp_state_shardings
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch.engine import Runner, build_lm_eval_step
from pytorch_distributed_training_tpu_torch.engine import runner as trunner
from pytorch_distributed_training_tpu_torch.engine.checkpoint import load_serving_state
from pytorch_distributed_training_tpu_torch.engine.topology import (
    check_moe,
    check_tensor_parallel,
    parse_parallelism,
)
from pytorch_distributed_training_tpu_torch.engine.tp_steps import build_tp_lm_train_step
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.parallel import TensorGroup, gather_state_dict
from pytorch_distributed_training_tpu_torch.parallel.tensor import shard_dim, shard_param

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, D, HEADS, DEPTH, BATCH, E = 128, 64, 64, 4, 2, 4, 4
LR = 0.05
SGD_KW = dict(lr=LR, momentum=0.9, weight_decay=1e-4)
ADAMW_KW = dict(lr=1e-3, weight_decay=0.1)
KINDS = {
    "dense": dict(max_len=SEQ, embed_dim=D, depth=DEPTH, num_heads=HEADS),
    "moe": dict(max_len=SEQ, embed_dim=D, depth=DEPTH, num_heads=HEADS, moe_experts=E,
                moe_top_k=2, moe_capacity_factor=1.25, moe_aux_weight=0.01, moe_every=2),
}
# the least gap between a token's 2nd and 3rd router logit in the data
MIN_GAP = 1e-3
# port T ranks against the port's one rank: f32 sums reassociated (the
# row-parallel partial sums, the copies' gradient sums).  Measured over the
# cases below: losses equal to 1e-7, parameters after two steps 1.1e-7 of
# their largest magnitude, gradients 2.2e-6 (a MoE block's ln2 scale)
PORT_RTOL = 1e-6
GRAD_TOL = 1e-5
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


def _batches(seed: int, n: int = 2, seq: int = SEQ):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, VOCAB, (BATCH, seq + 1)).astype(np.int32)
        out.append((toks[:, :-1], toks[:, 1:]))
    return out


@pytest.fixture(scope="module")
def jax_params():
    """The JAX trees of both kinds, drawn over their shapes."""
    out = {}
    for i, (kind, kw) in enumerate(KINDS.items()):
        shapes = jax.eval_shape(JaxLM(vocab_size=VOCAB, **kw).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, SEQ), jnp.int32))
        out[kind] = _draw(shapes["params"], 40 + i)
    return out


_JAX_RUNS = {}


def _jax_run(params, kind, layout, opt: str, batches, accum: int = 1):
    """JAX ``build_tp_lm_train_step`` on ``make_3d_mesh(1, T)`` over
    ``n_data * T`` CPU devices, compiled once a case: the losses and the
    parameters after."""
    key = (kind, layout, opt, accum)
    if key not in _JAX_RUNS:
        n_data, t = layout
        jm = JaxLM(vocab_size=VOCAB, **KINDS[kind])
        jo = jopt.SGD(**SGD_KW) if opt == "sgd" else jopt.AdamW(**ADAMW_KW)
        lr = SGD_KW["lr"] if opt == "sgd" else ADAMW_KW["lr"]
        mesh = make_3d_mesh(1, t, devices=jax.devices()[:n_data * t])
        assert mesh.shape == {"data": n_data, "sequence": 1, "model": t}
        zeros = jax.tree_util.tree_map(lambda sd: np.zeros(sd.shape, sd.dtype),
                                       jax.eval_shape(jo.init, params))
        state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params), batch_stats={},
                           opt_state=zeros)
        state = jax.device_put(state, tp_state_shardings(state, mesh, zero=0))
        inp, tgt = (jnp.asarray(a) for a in batches[0])
        step = jax_tp_step(jm, jo, lambda _: jnp.float32(lr), mesh, donate=False,
                           grad_accum=accum)(state).lower(state, inp, tgt).compile(
            compiler_options=FAST_XLA)
        losses = []
        for inp, tgt in batches:
            state, loss = step(state, jnp.asarray(inp), jnp.asarray(tgt))
            losses.append(float(loss))
        _JAX_RUNS[key] = losses, lm_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params))
    return _JAX_RUNS[key]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).long()


def _opt(opt: str):
    return topt.SGD(**SGD_KW) if opt == "sgd" else topt.AdamW(**ADAMW_KW)


def _lr(opt: str):
    lr = SGD_KW["lr"] if opt == "sgd" else ADAMW_KW["lr"]
    return lambda step: lr


def _port_run(full, batches, layout, kw, opt="sgd", accum=1, eval_batch=None):
    """The port's GSPMD-path step on ``n_data x T`` gloo thread ranks (one
    rank: the plain one-rank step), each rank holding its data rows of every
    batch and its slices of ``full``.  Per rank: the losses, the aux
    objectives, the first step's gradients and the ``state_dict`` after,
    both by parameter name, the MoE block's chosen experts and kept
    assignments at the first forward, and the eval step's ``(loss, acc1,
    acc5)`` on ``eval_batch``."""
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
            model = TransformerLM(VOCAB, fused_tails=True, tensor_group=tg, **kw)
            model.load_full_state_dict(full)
            step = build_tp_lm_train_step(model, _opt(opt), _lr(opt), world_size=n_data,
                                          group=data, grad_accum=accum)
            names = [n for n, _ in model.named_parameters()]
            out = {"loss": [], "aux": [], "routes": []}
            update = step.optimizer.update

            def record(params, grads, state, lr):
                if "grads" not in out:
                    out["grads"] = {n: g.detach().clone() for n, g in zip(names, grads)}
                return update(params, grads, state, lr)

            step.optimizer.update = record
            hooks = []
            for block in model.blocks:
                if block.is_moe:
                    def route(mod, args, out=out):
                        with torch.no_grad():
                            _, _, expert, _, keep = mod.route(args[0])
                        out["routes"].append((expert.clone(), keep.clone()))
                    hooks.append(block.moe.register_forward_pre_hook(route))
            rows = BATCH // n_data
            for inp, tgt in batches:
                sl = slice(d * rows, (d + 1) * rows)
                out["loss"].append(float(step(_t(inp[sl]), _t(tgt[sl]))))
                out["aux"].append(float(step.aux))
            for h in hooks:
                h.remove()
            out["state"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
            if eval_batch is not None:
                ev = build_lm_eval_step(model.eval(), world_size=n_data, group=data,
                                        micro_batches=2)
                rows_e = eval_batch[0].shape[0] // n_data
                sl = slice(d * rows_e, (d + 1) * rows_e)
                out["eval"] = [float(x) for x in ev(_t(eval_batch[0][sl]),
                                                    _t(eval_batch[1][sl]))]
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


def _assemble(parts):
    """The full leaves from model ranks 0..T-1's slices (by name)."""
    return {k: (parts[0][k] if shard_dim(k) is None
                else torch.cat([p[k] for p in parts], shard_dim(k))) for k in parts[0]}


def _close(got, want, what: str, tol: float) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"{what}: max |got - want| / max |want| = {err}"
    return err


def _one_rank(full, batches, kw, opt="sgd", accum=1, eval_batch=None):
    return _port_run(full, batches, (1, 1), kw, opt, accum, eval_batch)[0]


# --------------------------------------------------------------------- #
# roles, slices and init


@pytest.mark.parametrize("kind", list(KINDS))
def test_leaf_roles_match_jax_specs(jax_params, kind):
    """Every leaf's split dim in the port's layout is the one JAX's spec
    names, the kernels transposed ([in, out] -> [out, in])."""
    specs = lm_tp_param_specs(jax_params[kind])
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    sharded = 0
    for path, spec in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
        name = ".".join(keys[:-1] + [leaf])
        jax_dim = next((i for i, a in enumerate(spec) if a == "model"), None)
        if jax_dim is not None and keys[-1] == "kernel":
            jax_dim = 1 - jax_dim
        assert shard_dim(name) == jax_dim, name
        sharded += jax_dim is not None
    # a dense block: 6 split leaves; a MoE block: its attention 3, its experts 4
    assert sharded == (12 if kind == "dense" else 6 + 3 + 4)


@pytest.mark.parametrize("kind", list(KINDS))
def test_shards_gather_and_seeded_init(jax_params, kind):
    """A T-rank model built from a seed (or reset from a generator) holds
    the one-rank model's slices; ``lm_state_dict_from_jax`` with a tensor
    group gives them too; the slices gather back bit for bit."""
    kw, t = KINDS[kind], 4
    torch.manual_seed(7)
    one = TransformerLM(VOCAB, **kw).state_dict()
    one_reset = TransformerLM(VOCAB, **kw)
    one_reset.reset_parameters(torch.Generator().manual_seed(8))
    full_jax = lm_state_dict_from_jax(jax_params[kind])
    parts, resets = [], []
    for r in range(t):
        tg = TensorGroup(None, t, r)
        torch.manual_seed(7)
        model = TransformerLM(VOCAB, tensor_group=tg, **kw)
        parts.append({k: v.clone() for k, v in model.state_dict().items()})
        model.reset_parameters(torch.Generator().manual_seed(8))
        resets.append(model.state_dict())
        sliced = lm_state_dict_from_jax(jax_params[kind], tg)
        for k, v in sliced.items():
            assert torch.equal(v, shard_param(full_jax[k], shard_dim(k), t, r)), k
            assert v.shape == parts[-1][k].shape, k
    for got, want in ((_assemble(parts), one), (_assemble(resets), one_reset.state_dict())):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    # gather_state_dict over four gloo thread ranks: bit for bit
    store, outs = dist.HashStore(), {}

    def rank(r):
        tg = TensorGroup(dist.ProcessGroupGloo(store, r, t, timedelta(seconds=60)))
        outs[r] = gather_state_dict(parts[r], tg)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(t)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert len(outs) == t
    for got in outs.values():
        for k in one:
            assert torch.equal(got[k], one[k]), k


# --------------------------------------------------------------------- #
# the step against JAX and the one-rank step


LAYOUTS = {"T2": (1, 2), "T4": (1, 4), "2x2": (2, 2)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_tp_step_matches_jax_and_one_rank(jax_params, kind, layout):
    n_data, t = LAYOUTS[layout]
    kw, params = KINDS[kind], jax_params[kind]
    full = lm_state_dict_from_jax(params)
    batches = _batches(50)
    eval_batch = _batches(51, 1)[0] if layout == "2x2" else None
    outs = _port_run(full, batches, (n_data, t), kw, eval_batch=eval_batch)
    one = _one_rank(full, batches, kw, eval_batch=eval_batch)
    jlosses, jafter = _jax_run(params, kind, (n_data, t), "sgd", batches)
    for d in range(n_data):
        ranks = [outs[d * t + m] for m in range(t)]
        for m, got in enumerate(ranks):
            np.testing.assert_allclose(got["loss"], jlosses, rtol=1e-5, err_msg=f"rank {m} jax")
            np.testing.assert_allclose(got["loss"], one["loss"], rtol=PORT_RTOL)
            np.testing.assert_allclose(got["aux"], one["aux"], rtol=PORT_RTOL, atol=1e-12)
            # every rank routes as the one-rank layer does, its rows of the batch
            rows = BATCH // n_data
            for (e, k), (e1, k1) in zip(got["routes"], one["routes"]):
                assert torch.equal(e, e1[d * rows:(d + 1) * rows])
                assert torch.equal(k, k1[d * rows:(d + 1) * rows])
            if got["routes"]:
                assert not all(bool(k.all()) for _, k in got["routes"])  # tokens dropped
        grads = _assemble([r["grads"] for r in ranks])
        after = _assemble([r["state"] for r in ranks])
        for name in one["grads"]:
            _close(grads[name], one["grads"][name], f"grad {name}", GRAD_TOL)
        for name, want in one["state"].items():
            _close(after[name], want, f"after {name}", PORT_RTOL)
            np.testing.assert_allclose(after[name].numpy(), jafter[name].numpy(), atol=1e-5,
                                       err_msg=f"jax {name}")
        if eval_batch is not None:
            for r in ranks:
                np.testing.assert_allclose(r["eval"], one["eval"], rtol=PORT_RTOL)
    if kind == "moe":
        assert len(one["routes"]) == len(batches)


@pytest.mark.parametrize("kind", list(KINDS))
def test_tp_adamw_losses_match_jax(jax_params, kind):
    params = jax_params[kind]
    full = lm_state_dict_from_jax(params)
    batches = _batches(52)
    outs = _port_run(full, batches, (1, 4), KINDS[kind], opt="adamw")
    jlosses, _ = _jax_run(params, kind, (1, 4), "adamw", batches)
    one = _one_rank(full, batches, KINDS[kind], opt="adamw")
    for got in outs.values():
        np.testing.assert_allclose(got["loss"], jlosses, rtol=1e-5)
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=PORT_RTOL)


def test_ep_with_accumulation_matches_jax(jax_params):
    params = jax_params["moe"]
    full = lm_state_dict_from_jax(params)
    batches = _batches(53)
    outs = _port_run(full, batches, (1, 2), KINDS["moe"], accum=2)
    one = _one_rank(full, batches, KINDS["moe"], accum=2)
    jlosses, jafter = _jax_run(params, "moe", (1, 2), "sgd", batches, accum=2)
    after = _assemble([outs[m]["state"] for m in range(2)])
    for got in outs.values():
        np.testing.assert_allclose(got["loss"], jlosses, rtol=1e-5)
        np.testing.assert_allclose(got["aux"], one["aux"], rtol=PORT_RTOL)
        assert len(got["routes"]) == 2 * len(batches)  # a routing a micro-batch
    for name, want in jafter.items():
        np.testing.assert_allclose(after[name].numpy(), want.numpy(), atol=1e-5, err_msg=name)
        _close(after[name], one["state"][name], name, PORT_RTOL)


def test_flash_tp_step_matches_one_rank():
    """Head dim 64, S 128: the flash kernels' CPU twins at [B, S, H / T, 64]
    and K4's twin on fc1's column slice."""
    kw = dict(max_len=128, embed_dim=256, depth=DEPTH, num_heads=4, flash=True)
    torch.manual_seed(9)
    full = TransformerLM(VOCAB, **kw).state_dict()
    batches = _batches(54, 1, seq=128)
    outs = _port_run(full, batches, (1, 2), kw)
    one = _one_rank(full, batches, kw)
    after = _assemble([outs[m]["state"] for m in range(2)])
    for got in outs.values():
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=PORT_RTOL)
    for name, want in one["state"].items():
        _close(after[name], want, name, PORT_RTOL)


# --------------------------------------------------------------------- #
# the runner


def _tp_cfg(tmp_path, kind: str, **training):
    src = {"dense": "TransformerLM-tp.yml", "moe": "TransformerLM-moe.yml"}[kind]
    with open(os.path.join(REPO, "config", src)) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"].update(root=str(tmp_path), n_classes=VOCAB, seq_len=SEQ, n_samples=16)
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
               "samples": list(r.train_loader.sampler), "global_batch": r.global_batch,
               "state": {k: v.tolist() for k, v in r.model.state_dict().items()}
               if name == "resumed" else None},
              open(path + f"/{name}.rank{rank}.json", "w"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_runner_takes_the_tp_configs(tmp_path):
    """Four gloo processes run, in turn: ``config/TransformerLM-tp.yml``'s
    training block (T = 4) for 4 steps with a checkpoint every 2; the same
    resumed from the step-1 checkpoint alone; ``config/TransformerLM-moe.yml``'s
    (EP = 4) for 2 steps."""
    world = 4
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    ck = dict(dir=str(straight), interval=2, max_to_keep=5)
    runs = {"straight": _tp_cfg(tmp_path, "dense", checkpoint=ck),
            "resumed": _tp_cfg(tmp_path, "dense", checkpoint={**ck, "dir": str(resumed)}),
            "moe": _tp_cfg(tmp_path, "moe", train_iters=2)}
    assert all(c["training"]["tensor_parallelism"] == 4 for c in runs.values())
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

    launch(["straight", "moe"])
    # the resumed run starts from the straight run's step 1 alone
    os.makedirs(resumed)
    shutil.copytree(straight / "1", resumed / "1")
    shutil.copy(straight / "pipeline_1.json", resumed / "pipeline_1.json")
    launch(["resumed"])
    got = {name: [json.load(open(tmp_path / f"{name}.rank{r}.json")) for r in range(world)]
           for name in runs}
    for name, ranks in got.items():
        # a model group draws one sample set and reports one loss
        for r in ranks:
            assert r["samples"] == ranks[0]["samples"] and r["loss"] == ranks[0]["loss"]
            assert r["global_batch"] == 4 and np.isfinite(r["loss"]).all()
        assert len(ranks[0]["val"]) == 1 and np.isfinite(ranks[0]["val"][0]["loss"])
    one = Runner(1, 0, 0, "", False, None, _tp_cfg(tmp_path, "dense", tensor_parallelism=1),
                 device="cpu")
    one()
    assert got["straight"][0]["samples"] == list(one.train_loader.sampler)
    # bf16 compute: the reduces' roundings against the one rank's
    np.testing.assert_allclose(got["straight"][0]["loss"], [x["loss"] for x in one.train_log],
                               atol=2e-2, rtol=0)
    # the resumed run repeats steps 2-3 bit for bit
    assert got["resumed"][0]["loss"] == got["straight"][0]["loss"][2:]
    # the T = 4 checkpoint (full leaves) restores at T = 1 and serves
    state, step = load_serving_state(str(straight))
    assert step == 3
    want = TransformerLM(VOCAB, **{k: v for k, v in _tp_cfg(tmp_path, "dense")["model"].items()
                                   if k != "name"}).state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    resumed_state = _assemble([{k: torch.tensor(v) for k, v in r["state"].items()}
                               for r in got["resumed"]])
    for k, v in state.items():
        assert torch.equal(resumed_state[k].to(v.dtype), v), k
    cfg = _tp_cfg(tmp_path, "dense", tensor_parallelism=1, train_iters=5,
                  checkpoint=dict(dir=str(straight), interval=100))
    at_one = Runner(1, 0, 0, "", False, None, cfg, device="cpu")
    at_one()
    assert at_one.checkpointer.last_restore["step"] == 3
    assert len(at_one.train_log) == 1 and np.isfinite(at_one.train_log[0]["loss"])


# --------------------------------------------------------------------- #
# checks and refusals


def _cfg(model=None, training=None):
    m = dict(name="TransformerLM", embed_dim=D, depth=DEPTH, num_heads=HEADS, max_len=SEQ)
    m.update(model or {})
    return {"model": m, "training": dict(training or {}),
            "dataset": {"name": "synthetic_text", "n_classes": VOCAB, "seq_len": SEQ}}


def test_tp_checks_raise_the_jax_messages(tmp_path):
    # the experts against the degree: JAX parse_topology's message
    cfg = _cfg({"moe_experts": 6}, {"tensor_parallelism": 4})
    with pytest.raises(ValueError) as want:
        jtopo.parse_topology(SimpleNamespace(distributed=False), cfg,
                             {"sync_bn": False, **cfg["training"]},
                             [(np.zeros(SEQ, np.int32), None)])
    with pytest.raises(ValueError) as got:
        check_moe(cfg)
    assert str(got.value) == str(want.value)
    # the heads (JAX paths.py:159-164) and the ranks (as the SP path words it)
    r = SimpleNamespace(tensor_par=4)
    with pytest.raises(ValueError) as got:
        check_tensor_parallel(r, {"num_heads": 6}, 4)
    assert str(got.value) == ("model.num_heads (6) must be divisible by "
                              "training.tensor_parallelism (4)")
    with pytest.raises(ValueError) as got:
        check_tensor_parallel(r, {"num_heads": 8}, 2)
    assert str(got.value) == "training.tensor_parallelism (4) must divide the number of ranks (2)"
    # the runner at one rank reaches the ranks check
    with pytest.raises(ValueError, match=r"must divide the number of ranks \(1\)"):
        Runner(1, 0, 0, "", False, None, _tp_cfg(tmp_path, "dense"), device="cpu")()


def test_refusals_and_expert_parallelism_key(tmp_path):
    # training.expert_parallelism is no JAX key: unread, as the JAX runner leaves it
    trunner._reject_unported({"expert_parallelism": 4}, gspmd=True)
    trunner._reject_unported({"expert_parallelism": 4, "tensor_parallelism": 4}, gspmd=True)
    cfg = _tp_cfg(tmp_path, "moe", tensor_parallelism=1, expert_parallelism=4, train_iters=1)
    Runner(1, 0, 0, "", False, None, cfg, device="cpu")()
    # ZeRO beside tensor parallelism is ported (tests/test_torch_zero.py), and
    # the pipeline beside it (tests/test_torch_pipeline_compose.py); the
    # three-way PP x SP x TP raises JAX's message; comm still names P9
    trunner._reject_unported({"zero": 1, "tensor_parallelism": 4}, gspmd=True)
    trunner._reject_unported({"pipeline_parallelism": 2, "tensor_parallelism": 4},
                             pipeline=True)
    with pytest.raises(ValueError, match=r"^pipeline_parallelism x sequence_parallelism x "
                                         r"tensor_parallelism \(three-way\) is not wired"):
        parse_parallelism(SimpleNamespace(is_lm=True), {
            "pipeline_parallelism": 2, "tensor_parallelism": 4, "sequence_parallelism": 2})
    with pytest.raises(NotImplementedError, match="P9"):
        trunner._reject_unported({"comm": {"overlap": True}})
    # sequence parallelism beside tensor parallelism (LAMB/LARS beside it are
    # ported: tests/test_torch_zero.py)
    with pytest.raises(NotImplementedError, match="P9"):
        Runner(1, 0, 0, "", False, None, _tp_cfg(tmp_path, "dense", sequence_parallelism=2),
               device="cpu")()
    # serving refuses a tensor-parallel model
    model = TransformerLM(VOCAB, tensor_group=TensorGroup(None, 2, 0), **KINDS["dense"])
    with pytest.raises(ValueError, match="single-shard"):
        model.new_cache(1)
