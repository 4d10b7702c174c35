"""The port's ViT against the JAX package's, and on the image DP step.

A small ViT (patch 8, image 32, width 64, depth 2, 4 heads, 10 classes):
its weights are drawn with numpy from a seed into the JAX model's
variable tree (``jax.eval_shape``: kernels at lecun scale, biases, class
token and position table non-zero, LayerNorm scales around 1) and carried
into the port through ``vit_state_dict_from_jax``; the same seeded numpy
batches go through both:

- eval logits: f32 within 1e-5 abs; bf16 within 5e-2 abs, about three
  bf16 ulps of the largest logit (~2.8): both sides round the residual
  stream to bf16 after every block, in another operation order;
- the loss and every gradient of the image step against ``jax.grad`` in
  f32, each gradient within 1e-4 of its largest magnitude;
- losses of 3 AdamW steps under a cosine schedule with linear warmup
  (the ViT-B16 recipe's optimizer and schedule) against the JAX image
  step, rtol 1e-4 (AdamW turns f32 noise in near-zero gradients into
  lr-sized steps, so parameters are not compared after AdamW);
- ``vit_state_dict_from_jax``'s strictness, and the parameter counts of
  ViT-Ti16/S16/B16 at full width against ``jax.eval_shape``;
- on the runner: the EMA, the guard and ``validation.exact`` on a ViT
  (no BatchNorm buffers), and a 2-step run resumed for a third step
  equal to 3 straight steps bit for bit.  The runner builds its model by
  zoo name, so the zoo's ViT-Ti16 entry is cut to the small ViT there.
"""
import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pytorch_distributed_training_tpu import optimizers as jopt
from pytorch_distributed_training_tpu import schedulers as jsched
from pytorch_distributed_training_tpu.engine import TrainState
from pytorch_distributed_training_tpu.engine import build_train_step as jax_train_step
from pytorch_distributed_training_tpu.models import get_model as jax_get_model
from pytorch_distributed_training_tpu.models.vit import ViT as JViT
from pytorch_distributed_training_tpu.ops import cross_entropy_loss as jax_ce
from pytorch_distributed_training_tpu.parallel import make_mesh, replicated_sharding
from pytorch_distributed_training_tpu_torch import models as tmodels
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch import schedulers as tsched
from pytorch_distributed_training_tpu_torch.engine import Runner, build_train_step
from pytorch_distributed_training_tpu_torch.models import ViT, get_model, vit_state_dict_from_jax

PATCH, SIZE, DIM, DEPTH, HEADS, CLASSES, BATCH = 8, 32, 64, 2, 4, 10, 8
VIT = dict(patch_size=PATCH, embed_dim=DIM, depth=DEPTH, num_heads=HEADS)
ADAMW = dict(lr=1e-3, weight_decay=0.05)
SCHED = dict(name="cosine", total_iters=6, end_lr=1e-5, warmup_iters=2, warmup_mode="linear",
             warmup_factor=0.001)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    where torch's default pool in each of them over-subscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_params(module, sample, seed):
    """The flax params of ``module`` drawn with numpy (see the docstring)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), sample, train=False))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel":
            return x / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        return 1.0 + 0.1 * x if leaf == "scale" else 0.02 * x

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


@pytest.fixture(scope="module")
def setup():
    params = numpy_params(JViT(num_classes=CLASSES, **VIT), jnp.zeros((1, SIZE, SIZE, 3)), 7)
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(3):
        labels = rng.integers(0, CLASSES, BATCH).astype(np.int64)
        img = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
        batches.append((img + 0.3 * labels[:, None, None, None] / CLASSES, labels))
    return params, batches


def _port_model(params, dtype=torch.float32):
    model = ViT(CLASSES, image_size=SIZE, dtype=dtype, **VIT)
    model.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    return model


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_eval_logits_match_jax(setup, dtype, atol):
    params, batches = setup
    img = batches[0][0]
    jm = JViT(num_classes=CLASSES, dtype=getattr(jnp, dtype), **VIT)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(img), train=False))
    model = _port_model(params, getattr(torch, dtype)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and got.shape == (BATCH, CLASSES)  # the f32 head
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_loss_and_gradients_match_jax(setup):
    params, batches = setup
    img, labels = batches[0]
    jm = JViT(num_classes=CLASSES, **VIT)

    def loss_fn(p):
        return jax_ce(jm.apply({"params": p}, jnp.asarray(img), train=True), jnp.asarray(labels))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = _port_model(params)
    opt = topt.AdamW(**ADAMW)
    step = build_train_step(model, opt, tsched.get_scheduler(opt, SCHED).lr_fn)
    assert step.bn_buffers == []
    loss, _ = step.forward_backward(torch.from_numpy(img), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = vit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        w = want[name]
        err = ((p.grad - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        assert err <= 1e-4, (name, err)


def test_three_adamw_cosine_steps_match_jax(setup):
    params, batches = setup
    jm = JViT(num_classes=CLASSES, **VIT)
    jo = jopt.AdamW(**ADAMW)
    mesh = make_mesh(jax.devices()[:1])
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params), batch_stats={},
                       opt_state=jo.init(params))
    state = jax.device_put(state, replicated_sharding(mesh))
    jstep = jax_train_step(jm, jo, jsched.get_scheduler(jo, SCHED).lr_fn, mesh, sync_bn=False,
                           donate=False)
    model = _port_model(params)
    opt = topt.AdamW(**ADAMW)
    step = build_train_step(model, opt, tsched.get_scheduler(opt, SCHED).lr_fn)
    for img, labels in batches:
        state, jloss = jstep(state, jnp.asarray(img), jnp.asarray(labels.astype(np.int32)))
        loss = step(torch.from_numpy(img), torch.from_numpy(labels))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert step.opt_state.step == 3


def test_step_without_buffers_reduced_and_skipped(setup):
    """A ViT has no BatchNorm buffers: at a world size above 1 the step's
    all-reduce carries no statistics, and a skipped step copies none back
    (``torch._foreach_*`` refuses an empty list).  One gloo rank stands
    for the world of 2 the step is told about."""
    params, batches = setup
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        opt = topt.AdamW(**ADAMW)
        step = build_train_step(_port_model(params), opt, tsched.get_scheduler(opt, SCHED).lr_fn,
                                world_size=2, anomaly_factor=10.0)
        img, labels = batches[0]
        _, gnorm, applied = step(torch.from_numpy(img), torch.from_numpy(labels), 0.0)
        assert applied and step.bn_buffers == []
        before = [p.clone() for p in step.params]
        img = img.copy()
        img[0, 0, 0, 0] = np.nan
        _, _, applied = step(torch.from_numpy(img), torch.from_numpy(labels), gnorm)
        assert not applied and step.opt_state.step == 1
        assert all(torch.equal(a, b) for a, b in zip(before, step.params))
    finally:
        dist.destroy_process_group()


def test_state_dict_from_jax_is_strict(setup):
    params, _ = setup
    assert sorted(vit_state_dict_from_jax(params)) == sorted(_port_model(params).state_dict())
    missing = {k: v for k, v in params.items() if k != "ln"}
    with pytest.raises(ValueError, match="missing"):
        vit_state_dict_from_jax(missing)
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="left over"):
        vit_state_dict_from_jax(extra)
    wrong = json.loads(json.dumps(jax.tree_util.tree_map(lambda a: a.tolist(), params)))
    wrong = jax.tree_util.tree_map(np.asarray, wrong, is_leaf=lambda x: isinstance(x, list))
    wrong["block1"]["attn"]["proj"]["bias"] = np.zeros(DIM + 1, np.float32)
    with pytest.raises(ValueError, match="block1/attn/proj/bias"):
        vit_state_dict_from_jax(wrong)


@pytest.mark.parametrize("name", ["ViT-Ti16", "ViT-S16", "ViT-B16"])
def test_full_width_parameter_counts(name):
    jm = jax_get_model(name, num_classes=1000)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 224, 224, 3)), train=False))
    leaves = jax.tree_util.tree_leaves(shapes["params"])
    with torch.device("meta"):
        model = get_model(name.lower(), num_classes=1000)
    params = list(model.parameters())
    assert len(params) == len(leaves)
    assert sum(p.numel() for p in params) == sum(int(np.prod(x.shape)) for x in leaves)
    assert model.pos_embedding.shape == (1, 197, model.embed_dim)


def test_image_side_must_divide_by_patch():
    with pytest.raises(ValueError, match="not divisible by patch size 8"):
        ViT(CLASSES, image_size=36, **VIT)
    model = ViT(CLASSES, image_size=SIZE, **VIT)
    with pytest.raises(ValueError, match="image 36x36 not divisible by patch size 8"):
        model(torch.zeros(1, 3, 36, 36))


def test_init_follows_flax_distributions():
    model = ViT(1000, patch_size=16, embed_dim=192, depth=1, num_heads=3)
    w = model.patch_embed.weight
    assert abs(w.std().item() - (3 * 16 * 16) ** -0.5) < 0.05 * (3 * 16 * 16) ** -0.5
    assert w.abs().max().item() <= 2.0 * (3 * 16 * 16) ** -0.5 / 0.87962566103423978 + 1e-6
    assert abs(model.block0.mlp.fc1.weight.std().item() - 192 ** -0.5) < 0.02 * 192 ** -0.5
    assert abs(model.pos_embedding.std().item() - 0.02) < 0.002
    assert not model.cls_token.any() and not model.head.bias.any()
    assert not model.patch_embed.bias.any() and bool((model.ln.weight == 1).all())


# --------------------------------------------------------------------- #
# the runner on a ViT: EMA, guard, exact validation, resume


def _runner_cfg(iters, ckpt_dir=None):
    cfg = {
        "dataset": {"name": "synthetic", "root": "none", "n_classes": CLASSES,
                    "image_size": SIZE, "n_samples": 2 * BATCH - 3},
        "training": {"optimizer": {"name": "AdamW", **ADAMW}, "lr_schedule": dict(SCHED),
                     "train_iters": iters, "print_interval": 1, "val_interval": 3,
                     "batch_size": BATCH, "num_workers": 1, "sync_bn": True,
                     "ema": {"decay": 0.9},
                     "fault_tolerance": {"anomaly": {"grad_norm_factor": 10.0}}},
        "validation": {"batch_size": BATCH, "num_workers": 1, "exact": True},
        "model": {"name": "ViT-Ti16"},
    }
    if ckpt_dir is not None:
        cfg["training"]["checkpoint"] = {"dir": str(ckpt_dir), "interval": 10}
    return cfg


def _run(cfg):
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=json.loads(json.dumps(cfg)), device="cpu")
    runner()
    return runner


def test_runner_ema_guard_exact_and_resume(tmp_path, monkeypatch):
    monkeypatch.setitem(tmodels.VIT_CONFIGS, "ViT-Ti16", (PATCH, DIM, DEPTH, HEADS))
    straight = _run(_runner_cfg(3))
    step = straight.train_step
    assert not straight.is_lm and isinstance(straight.model, ViT)
    assert step.bn_buffers == [] and step.ema is not None and step.anomaly_factor == 10.0
    assert straight.model.image_size == SIZE
    assert [r["iter"] for r in straight.train_log] == [0, 1, 2]
    assert straight.val_log[-1]["n"] == 2 * BATCH - 3  # validation.exact: each sample once
    # the EMA moved off the parameters, and validation put them back
    assert any(not torch.equal(e, p) for e, p in zip(step.ema, step.params))
    _run(_runner_cfg(2, tmp_path / "resumed"))
    resumed = _run(_runner_cfg(3, tmp_path / "resumed"))
    assert [r["iter"] for r in resumed.train_log] == [2]
    assert resumed.train_log[0]["loss"] == straight.train_log[2]["loss"]
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    other = resumed.train_step
    for a, b in zip([*step.ema, *step.opt_state.mu, *step.opt_state.nu],
                    [*other.ema, *other.opt_state.mu, *other.opt_state.nu]):
        assert torch.equal(a, b)
