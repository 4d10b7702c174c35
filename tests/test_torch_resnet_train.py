"""The port's image DP training path against the JAX package's on the CPU:
the train and eval steps, two gloo ranks against one, the runner and the
CLI.

The net is a ResNet of one Bottleneck a stage (``(1, 1, 1, 1)``, every
kind of layer the ResNet-50 has) at 32x32, 10 classes, batch 8, weights
from the JAX init through ``resnet_state_dict_from_jax``; the JAX steps
run on a 1-device mesh, so local BatchNorm statistics cover the same 8
images on both sides.  Tolerances:
- the first step's loss within rtol 1e-5 (f32, one logsumexp);
- every gradient within 1e-4 of its own largest magnitude (f32 through
  BatchNorms over 8 values a channel in the last stage, which magnify
  summation-order differences; ``test_gradients_match_float64`` holds the
  port's f32 gradients to its float64 ones at batch 8 and 16, and
  ``test_float64_gradients_match_jax_float64`` the float64 gradients of
  both packages to each other within 1e-6 at batch 16, where the JAX
  package's f32 gradients on the CPU drift from them by far more);
- parameters and BatchNorm buffers after 3 SGD steps (momentum 0.9, wd
  1e-4, lr 0.001 dropping at step 2, the JAX package's own test rate)
  within atol 1e-4, losses within rtol 1e-4;
- the eval step's loss within rtol 1e-5 and its accuracies within 1e-4
  (the same argmax);
- two gloo ranks against one rank on the full batch: losses rtol 1e-5,
  parameters and buffers atol 1e-5 (the all-reduce sums in another
  order).
"""
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
from pytorch_distributed_training_tpu.engine import TrainState
from pytorch_distributed_training_tpu.engine import build_eval_step as jax_eval_step
from pytorch_distributed_training_tpu.engine import build_train_step as jax_train_step
from pytorch_distributed_training_tpu.models.resnet import Bottleneck as JBottle
from pytorch_distributed_training_tpu.models.resnet import ResNet as JResNet
from pytorch_distributed_training_tpu.ops import cross_entropy_loss as jax_ce
from pytorch_distributed_training_tpu.parallel import DATA_AXIS, make_mesh, replicated_sharding
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch import schedulers as tsched
from pytorch_distributed_training_tpu_torch.engine import (
    Runner,
    build_eval_step,
    build_train_step,
)
from pytorch_distributed_training_tpu_torch.models import (
    Bottleneck,
    ResNet,
    resnet_state_dict_from_jax,
)
from pytorch_distributed_training_tpu_torch.train_distributed import main as cli_main

STAGES, CLASSES, BATCH, SIZE = (1, 1, 1, 1), 10, 8, 32
SGD_KW = dict(lr=0.001, momentum=0.9, weight_decay=1e-4)
SCHED = dict(name="multi_step", milestones=[2], gamma=0.1)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def one_thread():
    """One intra-op thread for the port-only tests: the suite runs several
    workers on few cores.  The tests against JAX keep torch's default: the
    convolutions' CPU reductions sum in another order on one thread, and
    three SGD steps' BatchNorm running variances then lie 1.6e-4 from
    JAX's, past this file's limit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jm = JResNet(stage_sizes=STAGES, block_cls=JBottle, num_classes=CLASSES)
    v = jm.init(jax.random.PRNGKey(4), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(3):
        labels = rng.integers(0, CLASSES, BATCH).astype(np.int64)
        img = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
        batches.append((img + 0.3 * labels[:, None, None, None] / CLASSES, labels))
    return v, batches


def _port_model(v, sync_bn=False):
    model = ResNet(STAGES, Bottleneck, CLASSES, sync_bn=sync_bn)
    model.load_state_dict(resnet_state_dict_from_jax(v), strict=True)
    return model


def _port_step(v, sync_bn):
    model = _port_model(v, sync_bn)
    opt = topt.SGD(**SGD_KW)
    return model, build_train_step(model, opt, tsched.get_scheduler(opt, SCHED).lr_fn,
                                   sync_bn=sync_bn)


def _jax_grads(v, sync_bn, img, labels):
    """Loss and gradients of the JAX model's training objective; with
    ``sync_bn`` its BatchNorms pmean over a size-1 vmapped data axis."""
    jm = JResNet(stage_sizes=STAGES, block_cls=JBottle, num_classes=CLASSES,
                 axis_name=DATA_AXIS if sync_bn else None)

    def loss_fn(p, x, y):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, x, train=True,
                          mutable=["batch_stats"])
        return jax_ce(out, y)

    fn = jax.value_and_grad(loss_fn)
    if not sync_bn:
        return jax.jit(fn)(v["params"], jnp.asarray(img), jnp.asarray(labels))
    loss, grads = jax.jit(jax.vmap(fn, in_axes=(None, 0, 0), axis_name=DATA_AXIS))(
        v["params"], jnp.asarray(img)[None], jnp.asarray(labels)[None])
    return loss[0], jax.tree_util.tree_map(lambda a: a[0], grads)


@pytest.mark.parametrize("sync_bn", [True, False], ids=["sync", "local"])
def test_loss_and_gradients_match_jax(setup, sync_bn):
    v, batches = setup
    img, labels = batches[0]
    jloss, jgrads = _jax_grads(v, sync_bn, img, labels)
    model, step = _port_step(v, sync_bn)
    loss, logits = step.forward_backward(torch.from_numpy(img), torch.from_numpy(labels))
    assert logits.shape == (BATCH, CLASSES) and logits.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = resnet_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                       "batch_stats": v["batch_stats"]})
    named = dict(model.named_parameters())
    assert len(named) == len(jax.tree_util.tree_leaves(jgrads))
    for name, p in named.items():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("batch", [8, 16])
def test_gradients_match_float64(setup, batch):
    """The port's f32 gradients within 1e-4 (of each one's largest
    magnitude) of the same step run in float64, port only.  (At batch 4
    the last stage normalizes 4 values a channel, where f32 alone lies
    beyond that limit.)"""
    v, _ = setup
    rng = np.random.default_rng(batch)
    img = torch.from_numpy(rng.standard_normal((batch, SIZE, SIZE, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, CLASSES, batch))
    grads = []
    for dtype in (torch.float32, torch.float64):
        model = _port_model(v).to(dtype)
        model.dtype = model.fc.dtype = dtype
        opt = topt.SGD(**SGD_KW)
        step = build_train_step(model, opt, tsched.get_scheduler(opt, SCHED).lr_fn)
        step.forward_backward(img.to(dtype), labels)
        grads.append({n: p.grad.double() for n, p in model.named_parameters()})
    for name, g64 in grads[1].items():
        err = ((grads[0][name] - g64).abs().max() / g64.abs().max()).item()
        assert err <= 1e-4, (name, err)


def test_float64_gradients_match_jax_float64(setup):
    """At batch 16 in float64 (the JAX model with float64 compute and
    statistics, the port's model in float64; logits and CE in f32 on both
    sides) the two gradients agree within 1e-6 of each one's largest
    magnitude: the reference for the f32 comparisons above."""
    v, _ = setup
    rng = np.random.default_rng(16)
    img = rng.standard_normal((16, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, 16)
    model = _port_model(v).to(torch.float64)
    model.dtype = model.fc.dtype = torch.float64
    opt = topt.SGD(**SGD_KW)
    build_train_step(model, opt, tsched.get_scheduler(opt, SCHED).lr_fn).forward_backward(
        torch.from_numpy(img).double(), torch.from_numpy(labels))
    with jax.enable_x64(True):
        jm = JResNet(stage_sizes=STAGES, block_cls=JBottle, num_classes=CLASSES,
                     dtype=jnp.float64, bn_stat_dtype=jnp.float64)

        def loss_fn(p):
            out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                              jnp.asarray(img, jnp.float64), train=True,
                              mutable=["batch_stats"])
            return jax_ce(out, jnp.asarray(labels))

        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v["params"])
        jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(params))
    want = resnet_state_dict_from_jax(
        {"params": jax.tree_util.tree_map(lambda a: a.astype(np.float32), jgrads),
         "batch_stats": v["batch_stats"]})
    assert len(jax.tree_util.tree_leaves(jgrads)) == len(dict(model.named_parameters()))
    for name, p in model.named_parameters():
        w = want[name].double()
        err = ((p.grad - w).abs().max() / w.abs().max()).item()
        assert err <= 1e-6, (name, err)


@pytest.mark.parametrize("sync_bn", [True, False], ids=["sync", "local"])
def test_three_sgd_steps_match_jax(setup, sync_bn):
    v, batches = setup
    jm = JResNet(stage_sizes=STAGES, block_cls=JBottle, num_classes=CLASSES,
                 axis_name=DATA_AXIS if sync_bn else None)
    jo = jopt.SGD(**SGD_KW)
    mesh = make_mesh(jax.devices()[:1])
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
                       opt_state=jo.init(v["params"]))
    state = jax.device_put(state, replicated_sharding(mesh))
    jstep = jax_train_step(jm, jo, jsched.get_scheduler(jo, SCHED).lr_fn, mesh,
                           sync_bn=sync_bn, donate=False)
    model, step = _port_step(v, sync_bn)
    for img, labels in batches:
        state, jloss = jstep(state, jnp.asarray(img), jnp.asarray(labels.astype(np.int32)))
        loss = step(torch.from_numpy(img), torch.from_numpy(labels))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert step.opt_state.step == 3
    want = resnet_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    for name, val in model.state_dict().items():
        np.testing.assert_allclose(val.numpy(), want[name].numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_eval_step_matches_jax(setup):
    v, batches = setup
    rng = np.random.default_rng(2)
    v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])}
    jm = JResNet(stage_sizes=STAGES, block_cls=JBottle, num_classes=CLASSES)
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"], opt_state=None)
    img, labels = batches[1]
    jl, ja1, ja5 = jax_eval_step(jm, make_mesh(jax.devices()[:1]))(
        state, jnp.asarray(img), jnp.asarray(labels.astype(np.int32)))
    model = _port_model(v).train()
    tl, ta1, ta5 = build_eval_step(model)(torch.from_numpy(img), torch.from_numpy(labels))
    assert model.training  # the step restores the mode it found
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(ta1) == pytest.approx(float(ja1), abs=1e-4)
    assert float(ta5) == pytest.approx(float(ja5), abs=1e-4)
    for key, val in _port_model(v).state_dict().items():  # eval leaves the buffers alone
        torch.testing.assert_close(model.state_dict()[key], val, atol=0, rtol=0)


def test_unported_step_options_raise(setup):
    v, _ = setup
    model, opt = _port_model(v), topt.SGD(lr=0.1)

    class _Comm:
        overlap = True

    # ported (P2b): grad accumulation and the guard build
    step = build_train_step(model, opt, lambda s: 0.1, grad_accum=2, anomaly_factor=4.0)
    assert step.grad_accum == 2 and step.anomaly_factor == 4.0
    with pytest.raises(NotImplementedError, match="P9"):
        build_train_step(model, opt, lambda s: 0.1, comm=_Comm())


# --------------------------------------------------------------------- #
# two gloo ranks against one rank on the full batch


def _rank(rank: int, world: int, store, state, batches) -> dict:
    """One rank of a gloo world (a thread, its process group over
    ``store``): both BatchNorm modes, each from the same weights; its
    losses and its state after every step."""
    group = dist.ProcessGroupGloo(store, rank, world, timedelta(seconds=60))
    out = {}
    for sync in (True, False):
        model = ResNet((1, 1, 1, 1), Bottleneck, 10, sync_bn=sync, group=group)
        model.load_state_dict(state)
        opt = topt.SGD(**SGD_KW)
        step = build_train_step(model, opt, tsched.get_scheduler(opt, SCHED).lr_fn,
                                world_size=world, group=group, sync_bn=sync)
        losses, states = [], []
        for img, labels in batches:
            half = img.shape[0] // world
            losses.append(float(step(img[rank * half:(rank + 1) * half],
                                     labels[rank * half:(rank + 1) * half])))
            states.append({k: v.clone() for k, v in model.state_dict().items()})
        out[sync] = {"losses": losses, "states": states}
    return out


def test_two_gloo_ranks_equal_one_rank_full_batch(setup, one_thread):
    """With ``sync_bn`` two ranks on half batches equal one rank on the
    full batch; without it each rank normalizes by its own half and the
    step averages the BatchNorm buffers: both ranks hold the mean of what
    each half alone would give.  The two ranks are threads, each with its
    own process group over one store."""
    v, batches = setup
    state = resnet_state_dict_from_jax(v)
    tb = [(torch.from_numpy(i), torch.from_numpy(t)) for i, t in batches[:2]]
    store, outs, errors = dist.HashStore(), {}, []

    def run(rank):
        try:
            outs[rank] = _rank(rank, 2, store, state, tb)
        except BaseException as err:  # re-raised below, in the test's thread
            errors.append(err)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(outs) == 2, errors
    ranks = [outs[0], outs[1]]

    # sync: one rank on the full batch (raw moments there too)
    model, step = _port_step(v, sync_bn=True)
    want = [float(step(i, t)) for i, t in tb]
    np.testing.assert_allclose(ranks[0][True]["losses"], want, rtol=1e-5)
    for name, val in model.state_dict().items():
        for r in ranks:
            np.testing.assert_allclose(r[True]["states"][-1][name].numpy(), val.numpy(),
                                       atol=1e-5, rtol=0, err_msg=name)

    # local: the ranks agree, and after the first step their buffers are
    # the mean of the two halves' own updates from the same start
    for name, val in ranks[0][False]["states"][-1].items():
        torch.testing.assert_close(ranks[1][False]["states"][-1][name], val, atol=0, rtol=0)
    img, labels = tb[0]
    halves, half = [], BATCH // 2
    for r in range(2):
        m = _port_model(v).train()
        with torch.no_grad():
            m(img[r * half:(r + 1) * half].permute(0, 3, 1, 2))
        halves.append(m.state_dict())
    first = ranks[0][False]["states"][0]
    buffers = [k for k in first if "running" in k]
    assert buffers
    for name in buffers:
        np.testing.assert_allclose(first[name].numpy(),
                                   ((halves[0][name] + halves[1][name]) / 2).numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


# --------------------------------------------------------------------- #
# runner and CLI


def _tiny_cfg(**training):
    """``config/test-sync.yml`` as it is, cut in memory to a CPU run."""
    cfg = yaml.safe_load((REPO / "config" / "test-sync.yml").read_text())
    cfg["dataset"].update(n_classes=CLASSES, image_size=SIZE, n_samples=8)
    cfg["training"].update(train_iters=3, print_interval=1, val_interval=2, batch_size=4)
    cfg["training"].update(training)
    cfg["model"]["name"] = "ResNet18"
    return cfg


def test_runner_trains_and_validates_on_cpu(one_thread):
    seen = []
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=_tiny_cfg(), device="cpu",
                    on_iter=lambda r: seen.append((r.iter, float(r.last_loss))))
    runner()
    assert [i for i, _ in seen] == [0, 1, 2]
    assert [r["iter"] for r in runner.train_log] == [0, 1, 2]
    assert [r["loss"] for r in runner.train_log] == [x for _, x in seen]
    assert all(np.isfinite(r["loss"]) for r in runner.train_log)
    assert runner.train_log[0]["img_per_s"] is None and runner.train_log[1]["img_per_s"] > 0
    assert [v["iter"] for v in runner.val_log] == [1, 2]
    assert all(0.0 <= v["acc1"] <= v["acc5"] <= 100.0 for v in runner.val_log)
    assert runner.scheduler.get_last_lr() == [0.1]  # multi_step, milestones far away
    # one rank: local statistics, as the JAX runner (engine/topology.py:81)
    assert runner.sync_bn is False
    assert all(p.device.type == "cpu" for p in runner.model.parameters())


@pytest.mark.parametrize(
    "section,key,value,raises,match",
    [pytest.param("training", "ema", {"decay": 0.999}, None, "ema",
                  id="training-ema-value0-P3b"),
     # ported (P3b-1): the JAX runner's refusal of uint8 batches from a
     # dataset without normalisation constants (the synthetic one)
     pytest.param("training", "device_normalize", True, ValueError, "norm_mean",
                  id="training-device_normalize-True-P3b"),
     # ported (P3b-2): the space-to-depth stem, bf16 statistics and the
     # EMA run; ``match`` names what the case checks
     pytest.param("model", "space_to_depth", True, None, "space_to_depth",
                  id="model-space_to_depth-True-P3b"),
     pytest.param("model", "bn_stat_dtype", "bfloat16", None, "bn_stat_dtype",
                  id="model-bn_stat_dtype-bfloat16-P3b"),
     # ported (P3b-1): it runs, and counts each of 7 validation samples once
     # over two batches of 4 (the second wrap-padded)
     pytest.param("validation", "exact", True, None, "exact", id="validation-exact-True-P3b"),
     # ported (P2b): two micro-batches of 2 a step
     pytest.param("training", "grad_accumulation", 2, None, "grad_accumulation",
                  id="training-grad_accumulation-2-P2b")],
)
def test_runner_rejects_unported_image_keys(section, key, value, raises, match, one_thread):
    cfg = _tiny_cfg()
    cfg[section][key] = value
    if raises is None:
        cfg["dataset"]["n_samples"] = 7
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=cfg, device="cpu")
    if raises is None:
        runner()
        assert all(np.isfinite(r["loss"]) for r in runner.train_log)
        assert all(0.0 <= v["acc1"] <= v["acc5"] <= 100.0 for v in runner.val_log)
        if match == "exact":
            assert [v["n"] for v in runner.val_log] == [7, 7]
        elif match == "space_to_depth":
            assert tuple(runner.model.conv1.weight.shape) == (64, 12, 4, 4)
        elif match == "grad_accumulation":
            assert runner.train_step.grad_accum == 2 and runner.train_step.opt_state.step == 3
        elif match == "bn_stat_dtype":
            assert all(m.low_stats and m.running_var.dtype == torch.float32
                       for m in runner.model.modules() if hasattr(m, "low_stats"))
        else:  # the EMA, after 3 steps at d = 0.999 still near the initial weights
            step = runner.train_step
            assert step.ema_decay == 0.999 and len(step.ema) == len(step.params)
            assert any(not torch.equal(e, p) for e, p in zip(step.ema, step.params))
        return
    with pytest.raises(raises, match=match):
        runner()


def test_runner_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal on machines without one")
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=_tiny_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner()


def _cli(tmp_path: Path, cfg_path: str, *extra) -> str:
    rc = cli_main(["--cfg-filepath", cfg_path, "--log-dir", str(tmp_path / "log"),
                   "--file-name-cfg", "tiny", "--seed", "0", *extra])
    log = (tmp_path / "log" / "tiny.log").read_text()
    return rc, log


def test_cli_on_the_cpu_prints_iter_and_accuracy_lines(tmp_path, one_thread):
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(_tiny_cfg()))
    rc, log = _cli(tmp_path, str(path), "--device", "cpu")
    assert rc == 0, log
    assert "Iter [0/3] Lr: [0.1]" in log and "Iter [2/3]" in log and "img/s" in log
    assert log.count("Start valuation") == 2 and log.count("Acc@1: ") == 2
    assert "CRITICAL" not in log


@pytest.mark.parametrize("cfg,match", [
    ("test-sync.yml", "CUDA is not available"),
    # ported (P3b-1): ResNet50.yml's ImageFolder root is not on this machine
    pytest.param("ResNet50.yml", "dataset split dir not found", id="ResNet50.yml-P3b")])
def test_cli_on_the_repo_configs_without_a_card(tmp_path, cfg, match):
    """The reference configs as they are: test-sync.yml needs the card by
    default, ResNet50.yml's ImageFolder root (``~/datasets/ILSVRC2012``)
    must exist (on the CPU too; ``tests/test_torch_resnet_data.py`` trains
    it over a written tree)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusals on machines without one")
    rc, log = _cli(tmp_path, str(REPO / "config" / cfg),
                   *(("--device", "cpu") if cfg == "ResNet50.yml" else ()))
    assert rc == 1
    assert "CRITICAL" in log and match in log
