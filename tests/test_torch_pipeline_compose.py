"""The port's pipeline beside ZeRO-1/2, tensor parallelism and sequence
parallelism (``PPLayout`` with an inner model or sequence axis, the stage
view of ``models/transformer_lm.py`` under ``tensor_group``/``seq_axis``,
``engine/pp_steps.py`` with ``zero``) against the JAX package's pipeline
step on the CPU.

The tiny model and limits of ``tests/test_torch_pipeline.py`` (4 blocks, d
64, 4 heads, vocab 128, S 16, batch 8).  The JAX legs run compiled once a
case at XLA's lowest optimisation on ``make_pp_mesh(S, T, n)`` over 8 CPU
devices with JAX ``pp_state_shardings(zero=...)``; the port's ranks are gloo
thread ranks over one ``HashStore`` (``r = (data_idx * S + stage_idx) * I +
inner_idx``; a stage, a data and an inner group each), every stage on the
plain twins, its weights from ``lm_state_dict_from_jax_pp``.

- PP x ZeRO-1 and PP x ZeRO-2 at (data 4, stage 2), PP x TP at (2, 2, model
  2), PP x TP x ZeRO-1 at (2, 2, 2) and PP x SP at (2, 2, sequence 2), ring
  and Ulysses, GPipe and 1F1B: 3 SGD steps, losses within rtol 1e-5 of
  JAX's and the parameters after within atol 1e-5 (gathered over the model
  and stage groups), and against the port's one-rank full-batch step
  (losses rtol 1e-6, parameters 1e-6 of their largest magnitude); each ZeRO
  rank's momentum slices against the JAX device's addressable shard of the
  same elements, and its moment bytes against that shard's;
- AdamW with ``exclude_norm_bias`` and LAMB under PP x TP and PP x ZeRO-1
  (LAMB's trust ratio over the whole stacked leaf);
- the PP x TP and PP x SP eval steps (a ragged tail too) against JAX
  ``build_pp_lm_eval_step``;
- ``GroupExchange`` under gloo leaves CPU tensors as they are;
- the runner on ``config/TransformerLM-pp.yml`` at a tiny width as four
  gloo processes, (stage 2, model 2), (data 2, stage 2, ``zero: 1``) and
  (stage 2, sequence 2) in one spawn: each trains and validates and follows
  the one-rank runner; under PP x TP and PP x ZeRO-1 a checkpoint resumes
  bit for bit and holds the one-rank model's leaves.
"""
import json
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pytorch_distributed_training_tpu.engine import TrainState
from pytorch_distributed_training_tpu.engine import pp_steps as jpp
from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.parallel import (
    make_pp_mesh,
    pp_stack_params,
    pp_state_shardings,
)
from pytorch_distributed_training_tpu_torch.engine import Runner
from pytorch_distributed_training_tpu_torch.engine.pp_steps import (
    build_pp_lm_eval_step,
    build_pp_lm_train_step,
)
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax_pp
from pytorch_distributed_training_tpu_torch.parallel import (
    GroupExchange,
    StageExchange,
    TensorGroup,
)
from test_torch_pipeline import (  # noqa: F401  (jax_params: the module's fixture)
    ADAM_ATOL,
    BATCH,
    DEPTH,
    FAST_XLA,
    JAX_ATOL,
    JAX_RTOL,
    KW,
    OPT_KW,
    PORT_RTOL,
    REPO,
    SEQ,
    TIMEOUT,
    VOCAB,
    _RANK,
    _batches,
    _close,
    _free_port,
    _jax_opt,
    _one_rank,
    _port_opt,
    _pp_cfg,
    _t,
    _thread_ranks,
    jax_params,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# case -> ((data, stage, model, sequence) ranks, schedule, microbatches, zero, seq_impl)
CASES = {
    "zero1-gpipe": ((4, 2, 1, 1), "gpipe", 2, 1, "ring"),
    "zero1-1f1b": ((4, 2, 1, 1), "1f1b", 2, 1, "ring"),
    "zero2-gpipe": ((4, 2, 1, 1), "gpipe", 2, 2, "ring"),
    "zero2-1f1b": ((4, 2, 1, 1), "1f1b", 2, 2, "ring"),
    "tp-gpipe": ((2, 2, 2, 1), "gpipe", 2, 0, "ring"),
    "tp-1f1b": ((2, 2, 2, 1), "1f1b", 4, 0, "ring"),
    "tp-zero1-1f1b": ((2, 2, 2, 1), "1f1b", 4, 1, "ring"),
    "sp-ring-gpipe": ((2, 2, 1, 2), "gpipe", 2, 0, "ring"),
    "sp-ring-1f1b": ((2, 2, 1, 2), "1f1b", 4, 0, "ring"),
    "sp-ulysses-1f1b": ((2, 2, 1, 2), "1f1b", 4, 0, "ulysses"),
}


def _mesh(layout):
    n_data, n_stage, n_model, n_seq = layout
    return make_pp_mesh(n_stage, n_model, n_seq,
                        devices=jax.devices()[:n_data * n_stage * n_model * n_seq])


def _jax_state(params, layout, opt, zero):
    mesh = _mesh(layout)
    pp = pp_stack_params(jax.tree_util.tree_map(jnp.asarray, params), DEPTH)
    jo = _jax_opt(opt)
    state = TrainState(params=pp, batch_stats={}, opt_state=jo.init(pp))
    return mesh, jo, jax.device_put(state, pp_state_shardings(state, mesh, zero=bool(zero)))


def _flax_key(path) -> tuple:
    """``(port leaf name, is a kernel)`` of a flax path under ``blocks`` or
    ``shared`` (the port's per-layer name without its ``block{i}.``)."""
    keys = [str(getattr(k, "key", k)) for k in path][1:]
    leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
    return ".".join(keys[:-1] + [leaf]), keys[-1] == "kernel"


_JAX_RUNS = {}


def _jax_run(params, case, opt, batches):
    """JAX ``build_pp_lm_train_step`` of ``case``, compiled once: the losses,
    the parameters after (the port's per-layer names) and, after SGD, each
    device's addressable shard of every momentum leaf, by ``(data_idx,
    stage_idx, inner_idx)``: ``{port name: (first layer, shard)}``."""
    key = (case, opt)
    if key not in _JAX_RUNS:
        layout, sched, micro, zero, impl = CASES[case]
        mesh, jo, state = _jax_state(params, layout, opt, zero)
        lr = OPT_KW[opt]["lr"]
        inp, tgt = (jnp.asarray(a) for a in batches[0])
        step = jpp.build_pp_lm_train_step(
            JaxLM(vocab_size=VOCAB, seq_impl=impl, **KW), jo, lambda _: jnp.float32(lr), mesh,
            micro, donate=False, schedule=sched,
            seq_axis="sequence" if layout[3] > 1 else None, zero=zero)(state).lower(
            state, inp, tgt).compile(compiler_options=FAST_XLA)
        losses = []
        for inp, tgt in batches:
            state, loss = step(state, jnp.asarray(inp), jnp.asarray(tgt))
            losses.append(float(loss))
        shards = {}
        if opt == "sgd":
            where = {dev: (idx + (0,))[:3] for idx, dev in np.ndenumerate(mesh.devices)}
            for path, leaf in jax.tree_util.tree_flatten_with_path(state.opt_state.momentum)[0]:
                name, kernel = _flax_key(path)
                stacked = str(getattr(path[0], "key", path[0])) == "blocks"
                for sh in leaf.addressable_shards:
                    data = np.asarray(sh.data)
                    first = (sh.index[0].start or 0) if stacked else None
                    shards.setdefault(where[sh.device], {})[name] = (first, data, kernel)
        _JAX_RUNS[key] = losses, lm_state_dict_from_jax_pp(
            jax.tree_util.tree_map(np.asarray, state.params)), shards
    return _JAX_RUNS[key]


def _groups(store, r, layout):
    """Rank ``r``'s place and groups: ``(d, s, i)``, the stage group as a
    :class:`TensorGroup`, the data group (``None`` at 1), the model group's
    :class:`TensorGroup` and the sequence group's exchange (``None`` off)."""
    n_data, n_stage, n_model, n_seq = layout
    inner = n_model * n_seq
    d, rest = divmod(r, n_stage * inner)
    s, i = divmod(rest, inner)
    gloo = lambda name, rank, size: dist.ProcessGroupGloo(  # noqa: E731
        dist.PrefixStore(name, store), rank, size, TIMEOUT)
    sg = gloo(f"stage{d}.{i}", s, n_stage)
    dg = gloo(f"data{s}.{i}", d, n_data) if n_data > 1 else None
    ig = gloo(f"inner{d}.{s}", i, inner) if inner > 1 else None
    tg = TensorGroup(ig, n_model, i) if n_model > 1 else None
    seq = GroupExchange(ig) if n_seq > 1 else None
    return (d, s, i), TensorGroup(sg, n_stage, s), dg, tg, seq


def _stage_model(pp_np, stage, tg, seq, impl):
    with torch.device("meta"):
        model = TransformerLM(VOCAB, stage_group=stage, tensor_group=tg, seq_axis=seq,
                              seq_impl=impl, **KW)
    model.to_empty(device="cpu")
    model.load_state_dict(lm_state_dict_from_jax_pp(pp_np, stage, tg), strict=True)
    return model


def _rows_cols(where, layout, batch=BATCH):
    (d, _, i), (n_data, _, _, n_seq) = where, layout
    rows, cols, j = batch // n_data, SEQ // n_seq, i if n_seq > 1 else 0
    return slice(d * rows, (d + 1) * rows), slice(j * cols, (j + 1) * cols)


def _port_run(params, case, opt, batches):
    """The port's step of ``case`` on gloo thread ranks, each holding its
    rows (and columns) of every batch: per rank the losses, the full
    ``state_dict`` after, its momentum slices by name and its moment bytes."""
    layout, sched, micro, zero, impl = CASES[case]
    n_data, n_stage, n_model, n_seq = layout
    pp_np = jax.tree_util.tree_map(np.asarray, pp_stack_params(params, DEPTH))
    store = dist.HashStore()

    def rank(r):
        where, stage, dg, tg, seq = _groups(store, r, layout)
        model = _stage_model(pp_np, stage, tg, seq, impl)
        lr = OPT_KW[opt]["lr"]
        step = build_pp_lm_train_step(model, _port_opt(opt), lambda i: lr,
                                      StageExchange(stage.group), micro, sched,
                                      world_size=n_data, group=dg, zero=zero)
        sl = _rows_cols(where, layout)
        losses = [float(step(_t(inp[sl]), _t(tgt[sl]))) for inp, tgt in batches]
        names = [n for n, _ in model.named_parameters()]
        momentum = (dict(zip(names, (t.clone() for t in step.opt_state.momentum)))
                    if opt == "sgd" else {})
        return dict(loss=losses, state=model.full_state_dict(), momentum=momentum,
                    moment_bytes=step.state_bytes()["moments"], where=where)

    return _thread_ranks(n_data * n_stage * n_model * n_seq, rank)


def _check_moments(got, shards):
    """Each momentum slice of a rank equals the JAX device's shard of the
    same elements, and its bytes the shard's."""
    mine = shards[got["where"]]
    for name, t in got["momentum"].items():
        layer = None if not name.startswith("block") else int(name.split(".")[0][5:])
        first, data, kernel = mine[name.split(".", 1)[1] if layer is not None else name]
        want = data[layer - first] if layer is not None else data
        want = want.T if kernel else want
        assert tuple(t.shape) == want.shape, (name, tuple(t.shape), want.shape)
        np.testing.assert_allclose(t.numpy(), want, atol=JAX_ATOL, err_msg=name)
    assert got["moment_bytes"] == sum(data.nbytes for _, data, _ in mine.values())


# --------------------------------------------------------------------- #
# the step against JAX and the one-rank step


@pytest.mark.parametrize("case", list(CASES))
def test_pp_composition_matches_jax_and_one_rank(jax_params, case):
    batches = _batches(81)
    outs = _port_run(jax_params, case, "sgd", batches)
    jlosses, jafter, shards = _jax_run(jax_params, case, "sgd", batches)
    one = _one_rank(jax_params, batches)
    for r, got in outs.items():
        np.testing.assert_allclose(got["loss"], jlosses, rtol=JAX_RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=PORT_RTOL)
        assert sorted(got["state"]) == sorted(jafter)
        for name, want in jafter.items():
            np.testing.assert_allclose(got["state"][name].numpy(), want.numpy(), atol=JAX_ATOL,
                                       err_msg=f"rank {r} jax {name}")
            _close(got["state"][name], one["state"][name], f"after {name}", PORT_RTOL)
        if CASES[case][3]:
            _check_moments(got, shards)


@pytest.mark.parametrize("case", ["tp-1f1b", "zero1-1f1b"])
@pytest.mark.parametrize("opt", ["adamw-exclude", "lamb"])
def test_pp_composition_optimizers_match_jax(jax_params, case, opt):
    """AdamW with ``exclude_norm_bias`` and LAMB, 3 steps: losses within
    rtol 1e-5 and parameters within ``ADAM_ATOL`` of JAX's (the stacked-layout
    rules; LAMB's trust ratio over the stage's stack and its model slices
    under PP x TP, over the whole stacked leaf under ZeRO, whose update JAX
    runs outside the ``shard_map``)."""
    batches = _batches(82)
    jlosses, jafter, _ = _jax_run(jax_params, case, opt, batches)
    outs = _port_run(jax_params, case, opt, batches)
    for r, got in outs.items():
        np.testing.assert_allclose(got["loss"], jlosses, rtol=JAX_RTOL, err_msg=f"rank {r}")
    for name, want in jafter.items():
        np.testing.assert_allclose(outs[0]["state"][name].numpy(), want.numpy(),
                                   atol=ADAM_ATOL, err_msg=name)


@pytest.mark.parametrize("case", ["tp-1f1b", "sp-ring-1f1b"])
def test_pp_composition_eval_matches_jax(jax_params, case, caplog):
    """The eval step over a full batch and a ragged tail of 6 (3 rows a data
    rank: JAX falls back to one microbatch, with a warning) against JAX
    ``build_pp_lm_eval_step``."""
    layout, _, micro, _, impl = CASES[case]
    mesh, _, state = _jax_state(jax_params, layout, "sgd", 0)
    jeval = jpp.build_pp_lm_eval_step(JaxLM(vocab_size=VOCAB, seq_impl=impl, **KW), mesh, micro,
                                      seq_axis="sequence" if layout[3] > 1 else None)(state)
    pp_np = jax.tree_util.tree_map(np.asarray, pp_stack_params(jax_params, DEPTH))
    batches = [_batches(83, 1, BATCH)[0], _batches(84, 1, 6)[0]]
    want = [[float(x) for x in jeval(state, jnp.asarray(i), jnp.asarray(t))]
            for i, t in batches]
    store = dist.HashStore()
    logger = logging.getLogger(f"test_torch_pipeline_compose.{case}")

    def rank(r):
        where, stage, dg, tg, seq = _groups(store, r, layout)
        model = _stage_model(pp_np, stage, tg, seq, impl)
        step = build_pp_lm_eval_step(model, StageExchange(stage.group), micro,
                                     world_size=layout[0], group=dg, logger=logger)
        out = []
        for inp, tgt in batches:
            sl = _rows_cols(where, layout, inp.shape[0])
            out.append([float(x) for x in step(_t(inp[sl]), _t(tgt[sl]))])
        return out

    with caplog.at_level(logging.WARNING, logger=logger.name):
        outs = _thread_ranks(8, rank)
    for r, got in outs.items():
        np.testing.assert_allclose(got, want, rtol=JAX_RTOL, err_msg=f"rank {r}")
    assert any("falling back to M=1" in rec.getMessage() for rec in caplog.records
               if rec.name == logger.name)


def test_group_exchange_under_gloo_leaves_cpu_tensors():
    """``GroupExchange`` with the gloo backend stages only CUDA tensors: a
    CPU tensor is its own stand-in, and a rotation and an all-to-all of CPU
    f32 and bf16 tensors over two gloo thread ranks give what the unstaged
    exchange gives."""
    store = dist.HashStore()

    def rank(r):
        pg = dist.ProcessGroupGloo(store, r, 2, TIMEOUT)
        staged, plain = GroupExchange(pg, backend="gloo"), GroupExchange(pg)
        assert staged.host_staged and not plain.host_staged
        out = []
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.arange(64.0).reshape(2, 4, 8) + 100 * r).to(dtype)
            assert staged._host(x) is x
            for ex in (staged, plain):
                carry, got = ex.shift(torch.zeros(()), x)
                (a2a,) = ex.all_to_all([x], 2, 1)
                out.append((got, a2a))
        return out

    outs = _thread_ranks(2, rank)
    for r, got in outs.items():
        for (s_rot, s_a2a), (p_rot, p_a2a) in zip(got[::2], got[1::2]):
            assert torch.equal(s_rot, p_rot) and torch.equal(s_a2a, p_a2a)
            x_next = (torch.arange(64.0).reshape(2, 4, 8) + 100 * (1 - r)).to(s_rot.dtype)
            assert torch.equal(s_rot, x_next)


# --------------------------------------------------------------------- #
# the runner

# run -> (the training keys beside the config's, one-rank batch)
RUNS = {
    "tp": dict(pipeline_parallelism=2, tensor_parallelism=2),
    "zero": dict(pipeline_parallelism=2, zero=1),
    "sp": dict(pipeline_parallelism=2, sequence_parallelism=2),
}


def test_runner_trains_the_compositions(tmp_path):
    """Four gloo processes run ``config/TransformerLM-pp.yml``'s training
    block at (stage 2, model 2), (data 2, stage 2, zero 1) and (stage 2,
    sequence 2), 1F1B over 2 microbatches, 4 steps each; PP x TP and PP x
    ZeRO-1 also for 2 steps with a checkpoint, then resumed to 4.  Every rank
    agrees, the resumed runs repeat the straight ones bit for bit, each
    follows the one-rank runner over the same samples, and the checkpoints
    hold the one-rank model's leaves."""
    world = 4
    runs = {}
    for name, keys in RUNS.items():
        keys = dict(keys, microbatches=2)
        runs[name] = _pp_cfg(tmp_path, **keys)
        if name != "sp":
            ck = dict(dir=str(tmp_path / f"ck-{name}"), max_to_keep=5)
            runs[f"{name}-first"] = _pp_cfg(tmp_path, train_iters=2,
                                            checkpoint=dict(ck, interval=2), **keys)
            runs[f"{name}-resumed"] = _pp_cfg(tmp_path, checkpoint=dict(ck, interval=100),
                                              **keys)
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
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = {name: [json.load(open(tmp_path / f"{name}.rank{r}.json")) for r in range(world)]
           for name in runs}
    for name, ranks in got.items():
        for r, out in enumerate(ranks):
            assert out["path"] == "pipeline"
            assert out["loss"] == ranks[0]["loss"] and np.isfinite(out["loss"]).all()
            assert out["val"] == ranks[0]["val"]
        # (stage 2, inner 2): stage = r // 2; (data 2, stage 2): stage = r % 2
        stage = [r % 2 for r in range(world)] if name.startswith("zero") else [r // 2 for r in
                                                                             range(world)]
        assert [out["blocks"] for out in ranks] == [[2 * s, 2 * s + 1] for s in stage]
    for name in ("tp", "zero"):
        assert got[f"{name}-resumed"][0]["restored"] == 1
        assert got[f"{name}-resumed"][0]["loss"] == got[name][0]["loss"][2:]  # bit for bit
        assert got[f"{name}-resumed"][0]["val"] == got[name][0]["val"]
        payload = torch.load(tmp_path / f"ck-{name}" / "1" / "state.pt", weights_only=True)
        with torch.device("meta"):
            template = TransformerLM(VOCAB, **{k: v for k, v in runs[name]["model"].items()
                                               if k != "name"}).state_dict()
        assert {k: tuple(v.shape) for k, v in payload["model"].items()} == {
            k: tuple(v.shape) for k, v in template.items()}
        for slot in payload["optimizer"]["slots"].values():
            assert {k: tuple(v.shape) for k, v in slot.items()} == {
                k: tuple(v.shape) for k, v in template.items()}
    # the one-rank runner over the same samples: the data ranks' batches at
    # (data 2, stage 2) are one batch of 16
    one = {}
    for batch in (8, 16):
        cfg = _pp_cfg(tmp_path, batch_size=batch)
        for key in ("microbatches", "pp_schedule", "pipeline_parallelism"):
            cfg["training"].pop(key)
        runner = Runner(1, 0, 0, "", False, None, cfg, device="cpu")
        runner()
        one[batch] = [x["loss"] for x in runner.train_log]
    for name in RUNS:
        np.testing.assert_allclose(got[name][0]["loss"], one[16 if name == "zero" else 8],
                                   rtol=1e-5, err_msg=name)
