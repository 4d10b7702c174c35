"""The anomaly-step guard (``training.fault_tolerance.anomaly``) of the
port's LM and image steps, against the JAX package's on the CPU.

- a NaN step: the image step (a ResNet of one Bottleneck a stage at 32x32,
  SGD with momentum, the weight EMA) given a NaN batch, and the LM step
  (the tiny LM, AdamW) given a NaN gradient, each after one clean step:
  the step is not applied, and parameters, BatchNorm buffers, momentum
  (AdamW's moments), EMA and ``opt_state.step`` are bitwise what they were;
  the next clean step applies;
- the spike gate: with ``grad_norm_factor`` 2 the port's steps and the
  JAX steps (one-device mesh, the same weights and batch) given the same
  ``gnorm_ref`` (0: unarmed; the norm / 1000: a spike; the norm x 1000)
  agree on ``applied``, and their gradient norms agree within rtol 1e-5;
  ``grad_norm_factor`` 0 checks finiteness only;
- two gloo ranks, a NaN batch on rank 1 only: both ranks skip, and both
  keep their parameters, buffers and momentum bitwise.
"""
import math
import socket
import subprocess
import sys
from pathlib import Path

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
from pytorch_distributed_training_tpu.parallel import make_mesh, make_sp_mesh, replicated_sharding
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch.engine import build_lm_train_step, build_train_step
from pytorch_distributed_training_tpu_torch.models import (
    Bottleneck,
    ResNet,
    TransformerLM,
    lm_state_dict_from_jax,
    resnet_state_dict_from_jax,
)

REPO = Path(__file__).resolve().parent.parent
STAGES, CLASSES, SIZE, BATCH = (1, 1, 1, 1), 10, 32, 8
VOCAB, SEQ, EMBED, DEPTH, HEADS = 64, 128, 128, 2, 2
SGD_KW = dict(lr=0.01, momentum=0.9, weight_decay=1e-4)


@pytest.fixture(scope="module")
def resnet():
    v = JResNet(stage_sizes=STAGES, block_cls=JBottle, num_classes=CLASSES).init(
        jax.random.PRNGKey(4), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(31)
    labels = rng.integers(0, CLASSES, BATCH).astype(np.int64)
    img = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    return v, img, labels


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(vocab_size=VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(3), jnp.zeros((1, SEQ), jnp.int32))["params"])
    toks = np.random.default_rng(32).integers(0, VOCAB, (8, SEQ + 1)).astype(np.int32)
    return jm, params, toks[:, :-1], toks[:, 1:]


def _image_step(v, factor, **kw):
    model = ResNet(STAGES, Bottleneck, CLASSES)
    model.load_state_dict(resnet_state_dict_from_jax(v), strict=True)
    return model, build_train_step(model, topt.SGD(**SGD_KW), lambda s: SGD_KW["lr"],
                                   anomaly_factor=factor, **kw)


def _lm_step(params, factor, opt):
    model = TransformerLM(VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
                          fused_tails=True, flash=True)
    model.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return model, build_lm_train_step(model, opt, lambda s: 1e-3, anomaly_factor=factor)


def _snapshot(model, step):
    opt = step.opt_state
    slots = [t.clone() for f in opt._fields if f != "step" for t in getattr(opt, f)]
    ema = [t.clone() for t in (getattr(step, "ema", None) or [])]
    return ({k: v.clone() for k, v in model.state_dict().items()}, slots, ema, opt.step)


def _assert_bitwise(a, b):
    assert a[0].keys() == b[0].keys()
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert len(a[1]) == len(b[1]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert len(a[2]) == len(b[2]) and all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    assert a[3] == b[3]


def test_nan_image_step_leaves_the_state_bitwise(resnet):
    v, img, labels = resnet
    model, step = _image_step(v, 0.0, ema_decay=0.99)
    img_t, lab_t = torch.from_numpy(img), torch.from_numpy(labels)
    loss, gnorm, applied = step(img_t, lab_t, 0.0)
    assert applied and bool(torch.isfinite(loss)) and gnorm > 0 and isinstance(gnorm, float)
    before = _snapshot(model, step)
    assert before[3] == 1 and before[1] and before[2]
    loss, gnorm, applied = step(torch.full_like(img_t, float("nan")), lab_t, float(gnorm))
    assert applied is False and not bool(torch.isfinite(loss))
    _assert_bitwise(_snapshot(model, step), before)
    assert all(p.grad is None for p in step.params)
    _, _, applied = step(img_t, lab_t, 0.0)
    assert applied and step.opt_state.step == 2


def test_nan_lm_step_leaves_the_state_bitwise(lm, monkeypatch):
    """The LM's tokens cannot carry NaN (``poison_batches`` passes them on):
    a NaN gradient stands for the anomaly."""
    _, params, inp, tgt = lm
    model, step = _lm_step(params, 0.0, topt.AdamW(lr=1e-3, weight_decay=0.1))
    inp_t, tgt_t = torch.from_numpy(inp).long(), torch.from_numpy(tgt).long()
    _, _, applied = step(inp_t, tgt_t, 0.0)
    assert applied
    before = _snapshot(model, step)
    hook = model.head.weight.register_hook(lambda g: torch.full_like(g, float("nan")))
    loss, gnorm, applied = step(inp_t, tgt_t, 0.0)
    hook.remove()
    assert applied is False and bool(torch.isfinite(loss)) and not math.isfinite(gnorm)
    _assert_bitwise(_snapshot(model, step), before)
    _, _, applied = step(inp_t, tgt_t, 0.0)
    assert applied and step.opt_state.step == 2


def _gate(port_step, jax_call):
    """(applied, gnorm) of both sides for refs 0, g/1000, g*1000."""
    out = []
    _, g_port, a_port = port_step(0.0)
    _, g_jax, a_jax = jax_call(0.0)
    out.append(((a_port, float(g_port)), (bool(a_jax), float(g_jax))))
    g = float(g_jax)
    for ref in (g / 1000.0, g * 1000.0):
        _, gp, ap = port_step(ref)
        _, gj, aj = jax_call(ref)
        out.append(((ap, float(gp)), (bool(aj), float(gj))))
    return out


def test_spike_gate_image_step_as_jax(resnet):
    v, img, labels = resnet
    jm = JResNet(stage_sizes=STAGES, block_cls=JBottle, num_classes=CLASSES)
    jo = jopt.SGD(**SGD_KW)
    mesh = make_mesh(jax.devices()[:1])
    jstep = jax_image_step(jm, jo, lambda s: SGD_KW["lr"], mesh, sync_bn=False, donate=False,
                           anomaly_factor=2.0)
    state = jax.device_put(
        TrainState(params=v["params"], batch_stats=v["batch_stats"],
                   opt_state=jo.init(v["params"])), replicated_sharding(mesh))

    def jax_call(ref):
        _, loss, gnorm, applied = jstep(state, jnp.asarray(img), jnp.asarray(labels, jnp.int32),
                                        ref)
        return loss, gnorm, float(applied) == 1.0

    def port_call(ref):
        _, step = _image_step(v, 2.0)
        return step(torch.from_numpy(img), torch.from_numpy(labels), ref)

    got = _gate(port_call, jax_call)
    assert [p[0] for p, _ in got] == [j[0] for _, j in got] == [True, False, True]
    for (_, gp), (_, gj) in got:
        np.testing.assert_allclose(gp, gj, rtol=1e-5)


def test_spike_gate_lm_step_as_jax(lm):
    jm, params, inp, tgt = lm
    jo = jopt.SGD(lr=0.05)
    mesh = make_sp_mesh(1, devices=jax.devices()[:1])
    jstep = jax_lm_step(jm, jo, lambda s: 0.05, mesh, donate=False, anomaly_factor=2.0)
    state = jax.device_put(TrainState(params=params, batch_stats={}, opt_state=jo.init(params)),
                           replicated_sharding(mesh))

    def jax_call(ref):
        _, loss, gnorm, applied = jstep(state, jnp.asarray(inp), jnp.asarray(tgt), ref)
        return loss, gnorm, float(applied) == 1.0

    def port_call(ref):
        _, step = _lm_step(params, 2.0, topt.SGD(lr=0.05))
        return step(torch.from_numpy(inp).long(), torch.from_numpy(tgt).long(), ref)

    got = _gate(port_call, jax_call)
    assert [p[0] for p, _ in got] == [j[0] for _, j in got] == [True, False, True]
    for (_, gp), (_, gj) in got:
        np.testing.assert_allclose(gp, gj, rtol=1e-5)


def test_factor_zero_checks_finiteness_only(resnet):
    v, img, labels = resnet
    _, step = _image_step(v, 0.0)
    _, gnorm, applied = step(torch.from_numpy(img), torch.from_numpy(labels), 1e-12)
    assert applied and float(gnorm) > 1e-12


# --------------------------------------------------------------------- #
# two gloo ranks, a NaN batch on one


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_RANK = """
import sys, torch, torch.distributed as dist
from pytorch_distributed_training_tpu_torch import optimizers
from pytorch_distributed_training_tpu_torch.engine import build_train_step
from pytorch_distributed_training_tpu_torch.models import Bottleneck, ResNet
rank, world, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
inp = torch.load(path + "/in.pt")
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port, world_size=world,
                        rank=rank)
model = ResNet((1, 1, 1, 1), Bottleneck, 10)
model.load_state_dict(inp["state"])
step = build_train_step(model, optimizers.SGD(lr=0.01, momentum=0.9), lambda s: 0.01,
                        world_size=world, anomaly_factor=0.0)
img, labels = inp["img"][rank * 4:(rank + 1) * 4], inp["labels"][rank * 4:(rank + 1) * 4]
out = {"applied": []}
out["applied"].append(step(img, labels, 0.0)[2])
snap = lambda: ({k: v.clone() for k, v in model.state_dict().items()},
                [m.clone() for m in step.opt_state.momentum], step.opt_state.step)
out["before"] = snap()
bad = torch.full_like(img, float("nan")) if rank == 1 else img
out["applied"].append(step(bad, labels, 0.0)[2])
out["after"] = snap()
torch.save(out, path + f"/rank{rank}.pt")
dist.destroy_process_group()
"""


def test_nan_on_one_rank_skips_on_both(resnet, tmp_path):
    v, img, labels = resnet
    torch.save({"state": resnet_state_dict_from_jax(v), "img": torch.from_numpy(img),
                "labels": torch.from_numpy(labels)}, tmp_path / "in.pt")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), "2", port, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["applied"] == [True, False], r
        before, after = got["before"], got["after"]
        for k in before[0]:
            assert torch.equal(before[0][k], after[0][k]), (r, k)
        assert all(torch.equal(x, y) for x, y in zip(before[1], after[1]))
        assert before[2] == after[2] == 1
