"""The large-batch recipe of ``config/ResNet50-lars8k.yml`` in the port
against the JAX package on the CPU: the ``poly`` schedule, LARS, and the
runner on the config itself over an ImageFolder written here.

Tolerances:
- ``poly_lr``'s host value (float64) equals JAX's at every step, bit for
  bit: the same arithmetic in the same order; JAX's traced f32 value lies
  within rtol 1e-5 + atol 1e-6 x base lr of it (an f32 rounding an
  operation, and near the end ``1 - s / decay_iters`` cancels, so the
  relative error of the small tail values grows while the absolute one
  stays below 1e-6 of the base);
- LARS: parameters after 5 steps within atol 1e-6 + rtol 1e-5.  The two
  sides take the norms in other summation orders (``torch._foreach_norm``
  against XLA's ``sqrt(sum(x * x))``), a few f32 ulps apart, and each
  step scales ``g + wd p`` by their ratio, so the parameters carry a few
  ulps of relative error a step;
- the runner: every loss finite and each step's lr the schedule's.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pytorch_distributed_training_tpu import optimizers as jopt
from pytorch_distributed_training_tpu import schedulers as jsched
from pytorch_distributed_training_tpu.models.resnet import BasicBlock as JBasic
from pytorch_distributed_training_tpu.models.resnet import ResNet as JResNet
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch import schedulers as tsched
from pytorch_distributed_training_tpu_torch.engine import Runner
from pytorch_distributed_training_tpu_torch.tools.image_folder import write_image_folder

REPO = Path(__file__).resolve().parent.parent
LARS8K = REPO / "config" / "ResNet50-lars8k.yml"


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread a test: beside the other test workers on the
    same cores, torch's default thread pool oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lars8k():
    return yaml.safe_load(LARS8K.read_text())


# --------------------------------------------------------------------- #
# poly


@pytest.mark.parametrize(
    "cfg",
    [_lars8k()["training"]["lr_schedule"],
     dict(name="poly", total_iters=40, power=1.5, end_lr=0.01, warmup_iters=7,
          warmup_mode="constant", warmup_factor=0.2),
     dict(name="poly", total_iters=30)],
    ids=["lars8k", "constant-warmup-end-lr", "defaults"],
)
def test_poly_schedule_matches_jax_at_every_step(cfg):
    base = 10.0
    jfn = jsched.get_scheduler(jopt.LARS(lr=base), cfg).lr_fn
    sched = tsched.get_scheduler(topt.LARS(lr=base), cfg)
    total = cfg["total_iters"]
    steps = list(range(total + 100))
    traced_fn = jax.jit(jfn)
    for step in steps:
        want = jfn(step)
        assert sched.lr_fn(step) == want, step  # the same float64 host arithmetic
        assert sched.get_last_lr() == [want]
        traced = float(traced_fn(jnp.int32(step)))
        # XLA's compiled pow(0, 1.5) is nan: JAX's traced value at the end
        # of a non-integer power's decay (its host value is end_lr)
        if np.isfinite(traced) or float(cfg.get("power", 2.0)).is_integer():
            np.testing.assert_allclose(sched.lr_fn(step), traced, rtol=1e-5, atol=1e-6 * base)
        sched.step()
    warm = cfg.get("warmup_iters", 0)
    # the boundaries: warmup's first value, the hand-over at base_lr, the end
    assert sched.lr_fn(warm) == base
    assert sched.lr_fn(total) == cfg.get("end_lr", 0.0) == sched.lr_fn(total + 50)
    if warm:
        factor = cfg["warmup_factor"]
        assert sched.lr_fn(0) == pytest.approx(base * factor, rel=1e-12)


# --------------------------------------------------------------------- #
# LARS


def _resnet_tree():
    jm = JResNet(stage_sizes=(1, 1, 1, 1), block_cls=JBasic, num_classes=10)
    v = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)), train=False)
    flat = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in flat}


def _layernorm_tree():
    rng = np.random.default_rng(5)
    return {"ln1.scale": np.ones(16, np.float32) + 0.1 * rng.standard_normal(16, np.float32),
            "ln1.bias": 0.1 * rng.standard_normal(16, np.float32),
            "dense.kernel": rng.standard_normal((16, 32), np.float32) * 0.2,
            "dense.bias": np.zeros(32, np.float32),
            "head.kernel": rng.standard_normal((32, 4), np.float32),
            "zero_param": np.zeros((8, 8), np.float32)}


@pytest.mark.parametrize("tree", ["resnet", "layernorm"])
def test_lars_matches_jax_over_five_steps(tree):
    params = _resnet_tree() if tree == "resnet" else _layernorm_tree()
    keys = sorted(params)
    rng = np.random.default_rng(7)
    kwargs = {k: v for k, v in _lars8k()["training"]["optimizer"].items() if k != "name"}
    jo, to = jopt.LARS(**kwargs), topt.LARS(**kwargs)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in keys]
    ts = to.init(tp)
    # the g = 0 case: one rank-2 parameter never gets a gradient
    no_grad = "head.kernel" if tree == "layernorm" else keys[0]
    for i in range(5):
        grads = {k: (np.zeros_like(v) if k == no_grad else
                     rng.standard_normal(v.shape).astype(np.float32) * 0.05)
                 for k, v in params.items()}
        lr = 10.0 * 0.5 ** i
        jp, js = jo.update({k: jnp.asarray(g) for k, g in grads.items()}, js, jp,
                           jnp.float32(lr))
        ts = to.update(tp, [torch.from_numpy(grads[k]) for k in keys], ts, lr)
    assert ts.step == 5
    for k, t in zip(keys, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(ts.momentum[keys.index(k)].numpy(),
                                   np.asarray(js.momentum[k]), atol=1e-6, rtol=1e-5,
                                   err_msg=k)
    if tree == "layernorm":
        # p = 0 keeps trust 1, so the zero parameter moved by lr * g alone
        assert np.abs(tp[keys.index("zero_param")].numpy()).max() > 0


def test_lars_excludes_by_rank_not_by_name():
    """A rank-1 parameter takes plain momentum SGD with no decay: one step
    from a zero buffer moves it by exactly ``lr * g``; a rank-2 one by the
    trust ratio."""
    p = [torch.full((4,), 2.0), torch.full((2, 2), 2.0)]
    g = [torch.full((4,), 0.5), torch.full((2, 2), 0.5)]
    opt = topt.LARS(lr=1.0, momentum=0.9, weight_decay=0.1, eta=0.01)
    opt.update(p, g, opt.init(p), 1.0)
    torch.testing.assert_close(p[0], torch.full((4,), 1.5), atol=0, rtol=0)
    trust = 0.01 * 4.0 / (1.0 + 0.1 * 4.0 + 1e-9)  # norms 4 and 1
    torch.testing.assert_close(p[1], torch.full((2, 2), 2.0 - trust * (0.5 + 0.2)))


# --------------------------------------------------------------------- #
# the runner on config/ResNet50-lars8k.yml


@pytest.fixture(scope="module")
def imagenet_root(tmp_path_factory):
    return write_image_folder(str(tmp_path_factory.mktemp("imagenet")), classes=4, train=3,
                              val=2, width=80, height=60, seed=2)


def test_runner_trains_lars8k_yml_over_an_image_folder(imagenet_root):
    """``config/ResNet50-lars8k.yml`` as it is (LARS lr 10, poly with
    warmup, bf16, sync_bn, 32 workers), cut in memory: ResNet-18 at 32x32,
    batch 4, 3 steps, the dataset root pointed at a written ImageFolder."""
    cfg = _lars8k()
    cfg["dataset"].update(root=imagenet_root, image_size=32)
    cfg["training"].update(train_iters=3, batch_size=4, print_interval=1)
    cfg["model"]["name"] = "ResNet18"
    seen = []
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=cfg, device="cpu",
                    on_iter=lambda r: seen.append(float(r.last_loss)))
    runner()
    assert type(runner.optimizer).__name__ == "LARS"
    assert runner.train_loader.worker_mode == "native" and runner.train_loader.num_workers == 32
    assert runner.compute_dtype == torch.bfloat16
    assert len(seen) == 3 and all(np.isfinite(seen))
    want = jsched.get_scheduler(jopt.LARS(lr=10.0), cfg["training"]["lr_schedule"]).lr_fn
    assert [r["lr"] for r in runner.train_log] == [want(i) for i in range(3)]
    assert [v["iter"] for v in runner.val_log] == [2]
    assert all(0.0 <= v["acc1"] <= v["acc5"] <= 100.0 for v in runner.val_log)
