"""The weight EMA of the image path (``training.ema.decay``) against the
JAX package's on the CPU.

- The update: JAX's compiled train step with ``ema_decay`` (its
  ``_ema_outside``) runs 5 SGD steps; after each, the port's
  ``ImageTrainStep.update_ema`` on the same previous EMA and the same new
  parameters must give JAX's EMA bit for bit (f32, the same rounding:
  XLA fuses ``d * e + (1 - d) * p`` into ``fma(d, e, (1 - d) * p)``).
- The port's own step keeps the EMA of its own parameters, from a copy of
  the initial ones.
- Validation on the EMA: the runner's validation after training equals
  JAX's evaluation of ``state.replace(params=ema)`` with the same
  BatchNorm running statistics, batch by batch over the same validation
  loader: loss within rtol 1e-5, accuracies within 1e-4 (the same
  argmax); the trained parameters come back bit for bit afterwards.
- ``ema.decay`` outside (0, 1) and the EMA on the LM path raise the JAX
  package's ``ValueError``s.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pytorch_distributed_training_tpu import optimizers as jopt
from pytorch_distributed_training_tpu.engine import TrainState
from pytorch_distributed_training_tpu.engine import build_eval_step as jax_eval_step
from pytorch_distributed_training_tpu.engine import build_train_step as jax_train_step
from pytorch_distributed_training_tpu.models import get_model as jax_get_model
from pytorch_distributed_training_tpu.models.resnet import Bottleneck as JBottle
from pytorch_distributed_training_tpu.models.resnet import ResNet as JResNet
from pytorch_distributed_training_tpu.models.torch_port import import_torch_resnet_state_dict
from pytorch_distributed_training_tpu.parallel import make_mesh, replicated_sharding
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch.engine import Runner, build_train_step
from pytorch_distributed_training_tpu_torch.models import (
    Bottleneck,
    ResNet,
    resnet_state_dict_from_jax,
)

STAGES, CLASSES, BATCH, SIZE, DECAY = (1, 1, 1, 1), 10, 8, 32, 0.9
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread a test: beside the other test workers on the
    same cores, torch's default thread pool oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jm = JResNet(stage_sizes=STAGES, block_cls=JBottle, num_classes=CLASSES)
    v = jm.init(jax.random.PRNGKey(9), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(21)
    batches = [(rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32),
                rng.integers(0, CLASSES, BATCH).astype(np.int64)) for _ in range(5)]
    return jm, v, batches


def test_ema_update_is_jax_bitwise(setup):
    jm, v, batches = setup
    jo = jopt.SGD(lr=0.05, momentum=0.9, weight_decay=1e-4)
    mesh = make_mesh(jax.devices()[:1])
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
                       opt_state=jo.init(v["params"]),
                       ema=jax.tree_util.tree_map(jnp.asarray, v["params"]))
    state = jax.device_put(state, replicated_sharding(mesh))
    jstep = jax_train_step(jm, jo, lambda s: 0.05, mesh, sync_bn=False, donate=False,
                           ema_decay=DECAY)
    model = ResNet(STAGES, Bottleneck, CLASSES)
    model.load_state_dict(resnet_state_dict_from_jax(v), strict=True)
    step = build_train_step(model, topt.SGD(lr=0.05), lambda s: 0.05, ema_decay=DECAY)
    names = [n for n, _ in model.named_parameters()]

    def as_port(params):
        sd = resnet_state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, {"params": params, "batch_stats": v["batch_stats"]}))
        return [sd[n] for n in names]

    for img, labels in batches:
        before = as_port(state.ema)
        state, _ = jstep(state, jnp.asarray(img), jnp.asarray(labels.astype(np.int32)))
        with torch.no_grad():
            for p, new in zip(step.params, as_port(state.params)):
                p.copy_(new)
        step.ema = before
        step.update_ema()
        for name, got, want in zip(names, step.ema, as_port(state.ema)):
            torch.testing.assert_close(got, want, atol=0, rtol=0, msg=name)


def test_port_step_keeps_the_ema_of_its_parameters(setup):
    _, v, batches = setup
    model = ResNet(STAGES, Bottleneck, CLASSES)
    model.load_state_dict(resnet_state_dict_from_jax(v), strict=True)
    step = build_train_step(model, topt.SGD(lr=0.05, momentum=0.9), lambda s: 0.05,
                            ema_decay=DECAY)
    want = [p.detach().clone() for p in step.params]
    for p, e in zip(step.params, step.ema):
        assert torch.equal(p, e) and p.data_ptr() != e.data_ptr()
    for img, labels in batches:
        step(torch.from_numpy(img), torch.from_numpy(labels))
        with torch.no_grad():
            for i, p in enumerate(step.params):
                new = (1.0 - DECAY) * p
                want[i] = new.add_(want[i], alpha=DECAY)
    for got, w in zip(step.ema, want):
        torch.testing.assert_close(got, w, atol=0, rtol=0)
    assert any(not torch.equal(e, p) for e, p in zip(step.ema, step.params))


def _image_cfg(**training):
    cfg = yaml.safe_load((REPO / "config" / "test-sync.yml").read_text())
    cfg["dataset"].update(n_classes=CLASSES, image_size=SIZE, n_samples=12)
    cfg["training"].update(train_iters=3, print_interval=1, val_interval=100, batch_size=4,
                           num_workers=2, **training)
    cfg["model"]["name"] = "ResNet18"
    return cfg


def test_validation_runs_on_the_ema_as_jax_does():
    cfg = _image_cfg(ema={"decay": DECAY})
    seen = {}

    def on_iter(runner):
        if runner.iter == 2:  # before the last iteration's validation
            seen["params"] = [p.detach().clone() for p in runner.train_step.params]
            seen["ema"] = [e.clone() for e in runner.train_step.ema]
            seen["state"] = {k: t.clone() for k, t in runner.model.state_dict().items()}

    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=cfg, device="cpu", on_iter=on_iter)
    runner()
    assert [v["iter"] for v in runner.val_log] == [2]
    for p, q in zip(runner.train_step.params, seen["params"]):  # swapped back bit for bit
        assert torch.equal(p, q)

    # JAX: state.replace(params=ema) over the same validation batches
    names = [n for n, _ in runner.model.named_parameters()]
    ema_sd = dict(seen["state"])
    ema_sd.update(dict(zip(names, seen["ema"])))
    jm = jax_get_model("ResNet18", num_classes=CLASSES)
    template = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    jv = import_torch_resnet_state_dict(template, {k: t.numpy() for k, t in ema_sd.items()})
    jstate = TrainState(params=jv["params"], batch_stats=jv["batch_stats"], opt_state=None)
    jeval = jax_eval_step(jm, make_mesh(jax.devices()[:1]))
    rows = [[float(x) for x in jeval(jstate, jnp.asarray(img),
                                     jnp.asarray(lab.astype(np.int32)))]
            for img, lab in runner.val_loader]
    want = np.mean(np.asarray(rows), axis=0)
    got = runner.val_log[0]
    np.testing.assert_allclose(got["loss"], want[0], rtol=1e-5)
    assert got["acc1"] == pytest.approx(want[1], abs=1e-4)
    assert got["acc5"] == pytest.approx(want[2], abs=1e-4)


@pytest.mark.parametrize("decay", [0.0, 1.0, -0.5, 1.5])
def test_decay_outside_the_open_interval_raises(decay):
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=_image_cfg(ema={"decay": decay}),
                    device="cpu")
    with pytest.raises(ValueError, match=r"ema.decay must be in \(0, 1\)"):
        runner()


def test_ema_on_the_lm_path_raises():
    cfg = {
        "dataset": {"name": "synthetic_text", "root": "none", "n_classes": 64, "seq_len": 128,
                    "n_samples": 16},
        "training": {"optimizer": {"name": "AdamW", "lr": 1e-3},
                     "lr_schedule": {"name": "cosine", "total_iters": 3}, "train_iters": 3,
                     "print_interval": 1, "val_interval": 2, "batch_size": 4,
                     "num_workers": 0, "sync_bn": False, "ema": {"decay": 0.999}},
        "validation": {"batch_size": 4, "num_workers": 0},
        "model": {"name": "TransformerLM", "embed_dim": 64, "depth": 1, "num_heads": 1},
    }
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="training.ema is only wired for the image task"):
        runner()
