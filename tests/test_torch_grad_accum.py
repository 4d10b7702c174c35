"""Gradient accumulation (``training.grad_accumulation``) in the port's LM
and image steps, against the JAX package's steps on the CPU.

- the LM step with N = 2 and 4 against the JAX step with the same N on a
  one-device mesh, 2 SGD steps over batches of 8 (the tiny LM of
  ``tests/test_torch_train_engine.py``, fused tails and flash in the port,
  unfused in JAX): losses within rtol 1e-5, parameters within atol 1e-5;
- the LM step with N against the port's own full-batch step (N = 1): the
  loss and the parameters after one SGD step within 1e-6 (the same sum
  taken in N parts; f32);
- the image step (ResNet of one Bottleneck a stage at 32x32, ``sync_bn``
  at one rank, batch 32) with N = 2 and 4 against the JAX step with the
  same N, one SGD step at lr 0.001: losses within rtol 1e-5, parameters
  and BatchNorm buffers within atol 1e-4 (``tests/test_torch_resnet_train.py``'s
  limits: BatchNorm over a few values a channel magnifies summation
  order);
- the BatchNorm running statistics updated once per micro-batch: bitwise
  those of N train-mode forwards over the micro-batches in turn;
- a batch that N does not divide raises the JAX package's ``ValueError``
  (same text), on both steps and at the runner's start-up.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu import optimizers as jopt
from pytorch_distributed_training_tpu.engine import TrainState
from pytorch_distributed_training_tpu.engine import build_lm_train_step as jax_lm_step
from pytorch_distributed_training_tpu.engine import build_train_step as jax_image_step
from pytorch_distributed_training_tpu.models.resnet import Bottleneck as JBottle
from pytorch_distributed_training_tpu.models.resnet import ResNet as JResNet
from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.parallel import (
    DATA_AXIS,
    make_mesh,
    make_sp_mesh,
    replicated_sharding,
)
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch.engine import build_lm_train_step, build_train_step
from pytorch_distributed_training_tpu_torch.models import (
    Bottleneck,
    ResNet,
    TransformerLM,
    lm_state_dict_from_jax,
    resnet_state_dict_from_jax,
)

VOCAB, SEQ, EMBED, DEPTH, HEADS, BATCH = 64, 128, 128, 2, 2, 8
STAGES, CLASSES, SIZE = (1, 1, 1, 1), 10, 32
SGD_KW = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)
# the image step at tests/test_torch_resnet_train.py's rate (the JAX package's own)
IMAGE_SGD = dict(lr=0.001, momentum=0.9, weight_decay=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(vocab_size=VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(3), jnp.zeros((1, SEQ), jnp.int32))["params"])
    rng = np.random.default_rng(21)
    batches = []
    for _ in range(2):
        toks = rng.integers(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
        batches.append((toks[:, :-1], toks[:, 1:]))
    return jm, params, batches


def _port_lm_step(params, grad_accum, **kw):
    model = TransformerLM(VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
                          fused_tails=True, flash=True)
    model.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return model, build_lm_train_step(model, topt.SGD(**SGD_KW), lambda s: SGD_KW["lr"],
                                      grad_accum=grad_accum, **kw)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("n", [2, 4])
def test_lm_step_matches_jax_with_the_same_n(lm, n):
    jm, params, batches = lm
    jo = jopt.SGD(**SGD_KW)
    mesh = make_sp_mesh(1, devices=jax.devices()[:1])
    state = jax.device_put(TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                                      batch_stats={}, opt_state=jo.init(params)),
                           replicated_sharding(mesh))
    jstep = jax_lm_step(jm, jo, lambda s: SGD_KW["lr"], mesh, donate=False, grad_accum=n)
    model, step = _port_lm_step(params, n)
    for inp, tgt in batches:
        state, jloss = jstep(state, jnp.asarray(inp), jnp.asarray(tgt))
        loss = step(_t(inp), _t(tgt))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert step.opt_state.step == int(state.opt_state.step) == 2
    want = lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_lm_step_equals_the_full_batch_step(lm, n):
    _, params, batches = lm
    inp, tgt = batches[0]
    full_model, full = _port_lm_step(params, 1)
    acc_model, acc = _port_lm_step(params, n)
    lf, la = full(_t(inp), _t(tgt)), acc(_t(inp), _t(tgt))
    np.testing.assert_allclose(float(la), float(lf), rtol=1e-6)
    for (name, a), (_, b) in zip(acc_model.named_parameters(), full_model.named_parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6, msg=name)


# --------------------------------------------------------------------- #
# the image step


@pytest.fixture(scope="module")
def resnet():
    jm = JResNet(stage_sizes=STAGES, block_cls=JBottle, num_classes=CLASSES)
    v = jm.init(jax.random.PRNGKey(4), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(22)
    # batch 32: micro-batches of at least 8 (at 4 images the last stage's
    # BatchNorm normalises 4 values a channel, where f32 alone is past 1e-4)
    labels = rng.integers(0, CLASSES, 32).astype(np.int64)
    img = rng.standard_normal((32, SIZE, SIZE, 3)).astype(np.float32)
    return jm, v, (img + 0.3 * labels[:, None, None, None] / CLASSES, labels)


def _port_resnet(v, sync_bn=False):
    model = ResNet(STAGES, Bottleneck, CLASSES, sync_bn=sync_bn)
    model.load_state_dict(resnet_state_dict_from_jax(v), strict=True)
    return model


@pytest.mark.parametrize("n", [2, 4])
def test_image_step_matches_jax_with_the_same_n(resnet, n):
    """With ``sync_bn`` (the BatchNorms' statistics pmean'd over the
    one-device data axis, the port's all-reduce at world size 1): the JAX
    step's scan cannot carry local statistics through ``shard_map`` in
    this JAX version (a varying carry against a replicated initial one)."""
    _, v, (img, labels) = resnet
    jm = JResNet(stage_sizes=STAGES, block_cls=JBottle, num_classes=CLASSES,
                 axis_name=DATA_AXIS)
    jo = jopt.SGD(**IMAGE_SGD)
    mesh = make_mesh(jax.devices()[:1])
    state = jax.device_put(TrainState(params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
                                      batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                         v["batch_stats"]),
                                      opt_state=jo.init(v["params"])),
                           replicated_sharding(mesh))
    jstep = jax_image_step(jm, jo, lambda s: IMAGE_SGD["lr"], mesh, sync_bn=True, donate=False,
                           grad_accum=n)
    state, jloss = jstep(state, jnp.asarray(img), jnp.asarray(labels.astype(np.int32)))
    model = _port_resnet(v, sync_bn=True)
    step = build_train_step(model, topt.SGD(**IMAGE_SGD), lambda s: IMAGE_SGD["lr"], sync_bn=True,
                            grad_accum=n)
    loss = step(torch.from_numpy(img), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert step.opt_state.step == 1
    want = resnet_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    for name, val in model.state_dict().items():
        np.testing.assert_allclose(val.numpy(), want[name].numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_batchnorm_statistics_update_once_per_micro_batch(resnet, n):
    _, v, (img, labels) = resnet
    model = _port_resnet(v)
    step = build_train_step(model, topt.SGD(**SGD_KW), lambda s: SGD_KW["lr"], grad_accum=n)
    step(torch.from_numpy(img), torch.from_numpy(labels))
    ref = _port_resnet(v).train()
    with torch.no_grad():
        for part in np.split(img, n):
            ref(torch.from_numpy(part).permute(0, 3, 1, 2))
    buffers = {k: b for k, b in ref.state_dict().items() if "running" in k}
    assert buffers
    for name, b in buffers.items():
        torch.testing.assert_close(model.state_dict()[name], b, atol=0, rtol=0, msg=name)


def test_indivisible_batch_raises_as_jax(resnet, lm):
    jm, v, (img, labels) = resnet
    jo = jopt.SGD(**SGD_KW)
    mesh = make_mesh(jax.devices()[:1])
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=jo.init(v["params"]))
    with pytest.raises(ValueError) as want:
        jax_image_step(jm, jo, lambda s: 0.1, mesh, sync_bn=False, donate=False,
                       grad_accum=3)(state, jnp.asarray(img), jnp.asarray(labels, jnp.int32))
    step = build_train_step(_port_resnet(v), topt.SGD(**SGD_KW), lambda s: 0.1, grad_accum=3)
    with pytest.raises(ValueError) as got:
        step(torch.from_numpy(img), torch.from_numpy(labels))
    assert str(got.value) == str(want.value)

    ljm, params, batches = lm
    inp, tgt = batches[0]
    mesh = make_sp_mesh(1, devices=jax.devices()[:1])
    lstate = TrainState(params=params, batch_stats={}, opt_state=jo.init(params))
    with pytest.raises(ValueError) as want:
        jax_lm_step(ljm, jo, lambda s: 0.1, mesh, donate=False, grad_accum=3)(
            lstate, jnp.asarray(inp), jnp.asarray(tgt))
    _, lstep = _port_lm_step(params, 3)
    with pytest.raises(ValueError) as got:
        lstep(_t(inp), _t(tgt))
    assert str(got.value) == str(want.value)


def test_runner_refuses_an_indivisible_batch_at_start_up():
    from pytorch_distributed_training_tpu_torch.engine import Runner

    cfg = {"dataset": {"name": "synthetic_text", "root": "", "n_classes": VOCAB, "seq_len": SEQ,
                       "n_samples": 16},
           "training": {"optimizer": {"name": "SGD", "lr": 0.1},
                        "lr_schedule": {"name": "multi_step", "milestones": [9], "gamma": 0.1},
                        "train_iters": 1, "print_interval": 1, "val_interval": 9,
                        "batch_size": 6, "num_workers": 0, "sync_bn": False,
                        "grad_accumulation": 4},
           "model": {"name": "TransformerLM", "embed_dim": 64, "depth": 1, "num_heads": 1}}
    runner = Runner(1, 0, 0, "", False, None, cfg, device="cpu")
    with pytest.raises(ValueError, match=r"per-shard batch \(6\) not divisible by "
                                         r"training.grad_accumulation \(4\)"):
        runner()
