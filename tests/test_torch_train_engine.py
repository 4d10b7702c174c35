"""The port's training engine against the JAX package's: optimizers,
schedule, data, the train and eval steps, the runner and the CLI.

Inputs come from numpy seeds; the JAX side runs on the CPU test mesh (8
virtual devices, so batches are multiples of 8).  Tolerances: optimizer
updates within atol 1e-6 (one f32 rounding per operation, taken in another
order by the multi-tensor passes); losses of the first 3 trainer steps
within rtol 1e-4 (``tests/test_trajectory_parity.py``'s bar); parameters
after 3 steps within atol 1e-4 (AdamW's first steps move each parameter by
about lr = 1e-3 whatever the gradient's size, so an f32 difference in a
small gradient shows at up to ~1e-5 of it); eval loss rtol 1e-5 and the
accuracies exactly (the same argmax on both sides).
"""
import json
import subprocess
import sys
import threading
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from pytorch_distributed_training_tpu import optimizers as jopt
from pytorch_distributed_training_tpu import schedulers as jsched
from pytorch_distributed_training_tpu.data import datasets as jdatasets
from pytorch_distributed_training_tpu.data import sampler as jsampler
from pytorch_distributed_training_tpu.data.loader import DataLoader as JaxLoader
from pytorch_distributed_training_tpu.engine import TrainState
from pytorch_distributed_training_tpu.engine import build_lm_train_step as jax_train_step
from pytorch_distributed_training_tpu.engine.sp_steps import build_lm_eval_step as jax_eval_step
from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.parallel import make_sp_mesh, replicated_sharding
from pytorch_distributed_training_tpu_torch import data as tdata
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch import schedulers as tsched
from pytorch_distributed_training_tpu_torch.engine import (
    Runner,
    build_lm_eval_step,
    build_lm_train_step,
)
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.train_distributed import main as cli_main

VOCAB, SEQ, EMBED, DEPTH, HEADS = 64, 128, 128, 2, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------- #
# optimizers and schedule


def _tree(rng):
    return {"w": rng.normal(size=(8, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "k": rng.normal(size=(3, 3, 2)).astype(np.float32)}


@pytest.mark.parametrize(
    "name,kwargs",
    [("AdamW", dict(lr=1e-3, weight_decay=0.1)),
     ("AdamW", dict(lr=3e-3, weight_decay=0.1, exclude_norm_bias=True, betas=(0.8, 0.95))),
     ("SGD", dict(lr=0.05, momentum=0.9, weight_decay=1e-4)),
     ("SGD", dict(lr=0.05, momentum=0.9, nesterov=True)),
     ("SGD", dict(lr=0.1))],
    ids=["adamw", "adamw-exclude", "sgd-momentum-wd", "sgd-nesterov", "sgd-plain"],
)
def test_optimizer_updates_match_jax(name, kwargs):
    rng = np.random.default_rng(len(name) + len(kwargs))
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jo = jopt.get_optimizer({"name": name})(**kwargs)
    to = topt.get_optimizer({"name": name})(**kwargs)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init(jp)
    keys = sorted(params)
    tp = [torch.from_numpy(params[k].copy()) for k in keys]
    ts = to.init(tp)
    for i, g in enumerate(grads):
        lr = 0.5 ** i * kwargs["lr"]  # a schedule's value, f32 on the device in JAX
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, jnp.float32(lr))
        ts = to.update(tp, [torch.from_numpy(g[k]) for k in keys], ts, lr)
    assert ts.step == 3
    for k, t in zip(keys, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0, err_msg=k)


def test_cosine_schedule_matches_jax():
    cfg = dict(name="cosine", total_iters=50, end_lr=3e-5, warmup_iters=8,
               warmup_mode="linear", warmup_factor=0.01)
    jfn = jsched.get_scheduler(jopt.AdamW(lr=3e-4), cfg).lr_fn
    sched = tsched.get_scheduler(topt.AdamW(lr=3e-4), cfg)
    for step in range(0, 60):
        assert sched.get_last_lr() == [jfn(step)]  # the same host arithmetic
        np.testing.assert_allclose(sched.lr_fn(step), float(jfn(jnp.int32(step))), rtol=1e-6)
        sched.step()
    const = tsched.cosine_lr(1.0, 10, warmup_iters=4, warmup_mode="constant", warmup_factor=0.5)
    assert const(0) == 0.5 and const(4) == 1.0


@pytest.mark.parametrize(
    "fn,arg,exc,item",
    # ported (P3b-2, P2b): LARS, poly and LAMB resolve (``item`` checks the result)
    [(topt.get_optimizer, {"name": "LARS"}, None, lambda cls: cls is topt.LARS),
     (topt.get_optimizer, {"name": "LAMB"}, None, lambda cls: cls is topt.LAMB),
     (lambda c: tsched.get_scheduler(topt.SGD(lr=0.1), c),
      {"name": "poly", "total_iters": 10}, None,
      lambda sched: sched.lr_fn(0) == 0.1 and sched.lr_fn(5) == 0.1 * 0.5 ** 2),
     # ported (P2b): a missing token file raises as in the JAX package
     (lambda n: tdata.get_dataset(n, "/nonexistent/tokens", "train"), "tokens",
      FileNotFoundError, "token file not found"),
     # ported (P3b-1): a missing ImageFolder root raises as in the JAX package
     (lambda n: tdata.get_dataset(n, "/nonexistent/imagenet", "train"), "imagenet",
      FileNotFoundError, "split dir not found")],
    ids=["lars", "lamb", "poly", "tokens", "imagenet"],
)
def test_unported_pieces_raise_with_their_item(fn, arg, exc, item):
    if exc is None:
        assert item(fn(arg))
        return
    with pytest.raises(exc, match=item):
        fn(arg)


# --------------------------------------------------------------------- #
# data


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_text_arrays_identical(split):
    j = jdatasets.get_dataset("synthetic_text", "", split, n_classes=97, n_samples=40, seq_len=33)
    t = tdata.get_dataset("synthetic_text", "", split, n_classes=97, n_samples=40, seq_len=33)
    assert len(j) == len(t) == 40
    np.testing.assert_array_equal(j._successors, t._successors)
    for idx in (0, 1, 17, 39):
        for a, b in zip(j[idx], t[idx]):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("replicas,rank,shuffle,drop_last",
                         [(1, 0, True, False), (3, 2, True, True), (4, 1, False, False)])
def test_sampler_and_loader_order_identical(replicas, rank, shuffle, drop_last):
    args = dict(num_replicas=replicas, rank=rank, shuffle=shuffle, drop_last=drop_last, seed=5)
    js = jsampler.DistributedShardSampler(23, **args)
    ts = tdata.DistributedShardSampler(23, **args)
    ds = tdata.get_dataset("synthetic_text", "", "train", n_classes=50, n_samples=23, seq_len=8)
    for epoch in range(3):
        js.set_epoch(epoch)
        loader = tdata.DataLoader(ds, 4, ts, drop_last=drop_last)
        loader.set_epoch(epoch)
        np.testing.assert_array_equal(js.local_indices(), ts.local_indices())
        jl = JaxLoader(ds, 4, js, num_workers=0, drop_last=drop_last, worker_mode="thread")
        want = jl._batch_indices()
        got = list(loader)
        assert len(got) == len(want) == len(loader)
        for chunk, (inp, tgt) in zip(want, got):
            np.testing.assert_array_equal(inp, np.stack([ds[int(i)][0] for i in chunk]))
            np.testing.assert_array_equal(tgt, np.stack([ds[int(i)][1] for i in chunk]))


def test_iter_dataloader_advances_epochs():
    ds = tdata.get_dataset("synthetic_text", "", "train", n_classes=50, n_samples=8, seq_len=4)
    sampler = tdata.DistributedShardSampler(8, 1, 0, shuffle=True, seed=1)
    stream = tdata.make_iter_dataloader(tdata.DataLoader(ds, 4, sampler, drop_last=True))
    first = [next(stream)[0] for _ in range(4)]
    assert sampler.epoch == 1
    assert not np.array_equal(np.concatenate(first[:2]), np.concatenate(first[2:]))
    with pytest.raises(ValueError, match="no batches"):
        tdata.make_iter_dataloader(tdata.DataLoader(ds, 16, sampler, drop_last=True))


# --------------------------------------------------------------------- #
# the train and eval steps against the JAX step on the CPU mesh


@pytest.fixture(scope="module")
def lm_setup():
    ds = tdata.get_dataset("synthetic_text", "", "train", n_classes=VOCAB, n_samples=64,
                           seq_len=SEQ)
    batches = []
    for s in range(3):
        items = [ds[i] for i in range(8 * s, 8 * s + 8)]
        batches.append((np.stack([a for a, _ in items]), np.stack([b for _, b in items])))
    # the JAX step runs its model unfused: its fused tails' custom_vjp does not
    # type-check under shard_map in interpret mode; fused and unfused agree
    # to 1e-5 in the JAX package's own tests, and the port below runs fused
    jm = JaxLM(vocab_size=VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, SEQ), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, batches


def _port_model(params, remat=False):
    model = TransformerLM(VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
                          fused_tails=True, flash=True, remat=remat)
    model.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return model


_SCHED = dict(name="cosine", total_iters=10, end_lr=1e-4, warmup_iters=2,
              warmup_mode="linear", warmup_factor=0.1)


@pytest.mark.parametrize("opt_name,kwargs,remat", [
    pytest.param("AdamW", dict(lr=1e-3, weight_decay=0.1), False, id="AdamW-kwargs0"),
    pytest.param("SGD", dict(lr=0.05, momentum=0.9, weight_decay=1e-4), False,
                 id="SGD-kwargs1"),
    pytest.param("SGD", dict(lr=0.05, momentum=0.9, weight_decay=1e-4), True, id="SGD-remat"),
])
def test_three_trainer_steps_match_jax(lm_setup, opt_name, kwargs, remat):
    """Losses of 3 steps within rtol 1e-4 for both optimizers; parameters
    after them within atol 1e-5 for SGD.  Not for AdamW: it divides each
    gradient element by its own magnitude, and the key part of the qkv bias
    has a true gradient of exactly 0 (softmax ignores a per-query constant),
    so on each side f32 noise of ~1e-10 becomes a step of ~lr in a random
    direction; its losses still agree.  ``remat``: block remat on both
    sides (flax ``nn.remat``, ``torch.utils.checkpoint``)."""
    jm, params, batches = lm_setup
    if remat:
        jm = JaxLM(vocab_size=VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH,
                   num_heads=HEADS, remat=True)
    jo = jopt.get_optimizer({"name": opt_name})(**kwargs)
    mesh = make_sp_mesh(1)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params), batch_stats={},
                       opt_state=jo.init(params))
    state = jax.device_put(state, replicated_sharding(mesh))
    jstep = jax_train_step(jm, jo, jsched.get_scheduler(jo, _SCHED).lr_fn, mesh, donate=False)
    model = _port_model(params, remat)
    to = topt.get_optimizer({"name": opt_name})(**kwargs)
    tstep = build_lm_train_step(model, to, tsched.get_scheduler(to, _SCHED).lr_fn)
    for inp, tgt in batches:
        state, jloss = jstep(state, jnp.asarray(inp), jnp.asarray(tgt))
        tloss = tstep(torch.from_numpy(inp).long(), torch.from_numpy(tgt).long())
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert tstep.opt_state.step == 3
    if opt_name == "SGD":
        want = lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                       err_msg=name)


def test_eval_step_matches_jax(lm_setup):
    jm, params, batches = lm_setup
    inp, tgt = batches[0]
    mesh = make_sp_mesh(1)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params), batch_stats={},
                       opt_state=None)
    jl, ja1, ja5 = jax_eval_step(jm, mesh)(state, jnp.asarray(inp), jnp.asarray(tgt))
    tl, ta1, ta5 = build_lm_eval_step(_port_model(params))(
        torch.from_numpy(inp).long(), torch.from_numpy(tgt).long())
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(ta1) == pytest.approx(float(ja1), abs=1e-4)
    assert float(ta5) == pytest.approx(float(ja5), abs=1e-4)
    assert 0.0 <= float(ta1) <= float(ta5) <= 100.0


def test_unported_step_options_raise(lm_setup):
    _, params, _ = lm_setup
    model, opt = _port_model(params), topt.SGD(lr=0.1)

    class _Comm:
        overlap = True

    # ported (P2b): grad accumulation and the guard build
    step = build_lm_train_step(model, opt, lambda s: 0.1, grad_accum=2, anomaly_factor=4.0)
    assert step.grad_accum == 2 and step.anomaly_factor == 4.0
    for kwargs, item in ((dict(comm=_Comm()), "P9"), (dict(zero1=True), "P9")):
        with pytest.raises(NotImplementedError, match=item):
            build_lm_train_step(model, opt, lambda s: 0.1, **kwargs)


# --------------------------------------------------------------------- #
# two gloo ranks against one rank on the full batch


def _rank(rank: int, world: int, store, spec, state, opt_kwargs, batches) -> dict:
    """One rank of a gloo world (a thread, its process group over
    ``store``), the port only, SGD with momentum so that the parameters
    compare linearly in the gradients: its losses and final state."""
    group = dist.ProcessGroupGloo(store, rank, world, timedelta(seconds=60))
    model = TransformerLM(**spec)
    model.load_state_dict(state)
    opt = topt.SGD(**opt_kwargs)
    step = build_lm_train_step(model, opt, tsched.get_scheduler(opt, _SCHED).lr_fn,
                               world_size=world, group=group)
    losses = []
    for tokens, labels in batches:
        half = tokens.shape[0] // world
        losses.append(float(step(tokens[rank * half:(rank + 1) * half],
                                 labels[rank * half:(rank + 1) * half])))
    return {"losses": losses, "state": model.state_dict()}


def test_two_gloo_ranks_equal_one_rank_full_batch(lm_setup):
    _, params, batches = lm_setup
    spec = dict(vocab_size=VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
                fused_tails=True, flash=True)
    opt_kwargs = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)
    tb = [(torch.from_numpy(i).long(), torch.from_numpy(t).long()) for i, t in batches[:2]]
    state = lm_state_dict_from_jax(params)
    store, outs, errors = dist.HashStore(), {}, []

    def run(rank):
        try:
            outs[rank] = _rank(rank, 2, store, spec, state, opt_kwargs, tb)
        except BaseException as err:  # re-raised below, in the test's thread
            errors.append(err)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(outs) == 2, errors
    got = outs[0]
    model = TransformerLM(**spec)
    model.load_state_dict(lm_state_dict_from_jax(params))
    opt = topt.SGD(**opt_kwargs)
    step = build_lm_train_step(model, opt, tsched.get_scheduler(opt, _SCHED).lr_fn)
    want = [float(step(i, t)) for i, t in tb]
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(got["state"][name].numpy(), p.numpy(), atol=1e-5,
                                   err_msg=name)


# --------------------------------------------------------------------- #
# runner and CLI


def _tiny_cfg(**training):
    cfg = {
        "dataset": {"name": "synthetic_text", "root": "none", "n_classes": VOCAB,
                    "seq_len": SEQ, "n_samples": 16},
        "training": {"optimizer": {"name": "AdamW", "lr": 1e-3, "weight_decay": 0.1},
                     "lr_schedule": dict(_SCHED), "train_iters": 3, "print_interval": 1,
                     "val_interval": 2, "batch_size": 4, "num_workers": 0, "sync_bn": False,
                     "dtype": "float32"},
        "validation": {"batch_size": 4, "num_workers": 0},
        "model": {"name": "TransformerLM", "embed_dim": EMBED, "depth": DEPTH,
                  "num_heads": HEADS, "max_len": SEQ, "fused_tails": True},
    }
    cfg["training"].update(training)
    return cfg


def test_runner_trains_and_validates_on_cpu():
    seen = []
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=_tiny_cfg(), device="cpu",
                    on_iter=lambda r: seen.append(r.iter))
    runner()
    assert seen == [0, 1, 2]
    assert [r["iter"] for r in runner.train_log] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in runner.train_log)
    assert runner.train_log[0]["tok_per_s"] is None and runner.train_log[1]["tok_per_s"] > 0
    # validation after iter 1 ((1 + 1) % 2 == 0) and after the last
    assert [v["iter"] for v in runner.val_log] == [1, 2]
    assert runner.scheduler.last_epoch == 3
    assert all(p.device.type == "cpu" for p in runner.model.parameters())


@pytest.mark.parametrize(
    "key,value,exc,match",
    [pytest.param("checkpoint", {"dir": "run/x", "async": True}, NotImplementedError, "P10",
                  id="checkpoint-value0-P2b"),
     # ported (P2b): remat dots and grad accumulation train; the anomaly
     # section's ``factor`` is no key of it (``grad_norm_factor`` is), which
     # the JAX package refuses as unknown; a fault kind whose recovery is
     # not ported raises its item
     pytest.param("remat", "dots", None, "dots", id="remat-dots-P2b"),
     pytest.param("grad_accumulation", 2, None, "grad_accumulation",
                  id="grad_accumulation-2-P2b"),
     pytest.param("fault_tolerance", {"anomaly": {"factor": 4}}, ValueError,
                  r"anomaly: unknown key\(s\) \['factor'\]", id="fault_tolerance-value3-P2b"),
     pytest.param("fault_tolerance", {"fault_spec": "sdc_flip@1"}, NotImplementedError, "P10",
                  id="fault_tolerance-sdc_flip-P10"),
     # ported (P9, ring and Ulysses): at one rank a ring of 2 cannot form,
     # refused as the JAX package refuses it
     pytest.param("sequence_parallelism", 2, ValueError,
                  r"training.sequence_parallelism \(2\) must divide the number of ranks \(1\)",
                  id="sequence_parallelism-2-P9"),
     # ported (P9, ZeRO): at one rank the GSPMD step shards nothing
     pytest.param("zero", 1, None, "zero", id="zero-1-P9"),
     pytest.param("comm", {"overlap": True}, NotImplementedError, "P9", id="comm-value6-P9"),
     pytest.param("telemetry", {"dir": "run/t"}, NotImplementedError, "P10",
                  id="telemetry-value7-P10")],
)
def test_runner_rejects_unported_keys(key, value, exc, match):
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=_tiny_cfg(**{key: value}), device="cpu")
    if exc is None:
        runner()
        assert [r["iter"] for r in runner.train_log] == [0, 1, 2]
        assert all(np.isfinite(r["loss"]) for r in runner.train_log)
        if match == "dots":
            assert runner.model.remat and runner.model.remat_policy == "dots"
        elif match == "zero":
            assert runner.path == "gspmd" and runner.zero == 1 and runner.train_step.zero == 0
        else:
            assert runner.train_step.grad_accum == 2
        return
    with pytest.raises(exc, match=match):
        runner()


def test_runner_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal on machines without one")
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=_tiny_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner()


def _write_cfg(tmp_path: Path) -> str:
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(_tiny_cfg()))
    return str(path)


def test_cli_on_the_cpu_prints_iter_and_accuracy_lines(tmp_path):
    rc = cli_main(["--cfg-filepath", _write_cfg(tmp_path), "--log-dir", str(tmp_path / "log"),
                   "--file-name-cfg", "tiny", "--seed", "0", "--device", "cpu"])
    assert rc == 0
    log = (tmp_path / "log" / "tiny.log").read_text()
    assert "Iter [0/3] Lr: [" in log and "Iter [2/3]" in log and "tok/s" in log
    assert log.count("Start valuation") == 2 and log.count("Acc@1: ") == 2
    assert "CRITICAL" not in log


def test_cli_default_device_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal on machines without one")
    rc = cli_main(["--cfg-filepath", _write_cfg(tmp_path), "--log-dir", str(tmp_path / "log"),
                   "--file-name-cfg", "tiny"])
    assert rc == 1
    log = (tmp_path / "log" / "tiny.log").read_text()
    assert "CRITICAL" in log and "CUDA is not available" in log


def test_train_config_is_the_fsdp_model_block():
    """The slice's config carries config/TransformerLM-fsdp.yml's model block
    verbatim plus fused_tails, and its optimizer and schedule."""
    repo = Path(__file__).resolve().parent.parent
    ours = yaml.safe_load((repo / "pytorch_distributed_training_tpu_torch" / "configs" /
                           "train-lm-1024.yml").read_text())
    ref = yaml.safe_load((repo / "config" / "TransformerLM-fsdp.yml").read_text())
    assert ours["model"] == dict(ref["model"], fused_tails=True)
    for key in ("optimizer", "lr_schedule", "dtype"):
        assert ours["training"][key] == ref["training"][key]
    assert ours["dataset"]["name"] == "synthetic_text"
    assert ours["dataset"]["n_classes"] == 32768 and ours["dataset"]["seq_len"] == 2048
    assert ours["training"]["batch_size"] == 8 and "zero" not in ours["training"]
    assert json.dumps(ours)  # plain YAML, no tags


def test_training_cli_imports_no_jax():
    """The isolation guard's fresh-interpreter check, for the training CLI."""
    code = ("import json, sys\n"
            "import pytorch_distributed_training_tpu_torch.train_distributed\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "pytorch_distributed_training_tpu_torch.engine.runner" in loaded
    banned = ("jax", "jaxlib", "flax", "pytorch_distributed_training_tpu")
    assert not [m for m in loaded if any(m == b or m.startswith(b + ".") for b in banned)]
