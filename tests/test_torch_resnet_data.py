"""The image path's data pieces against the JAX package's, on the CPU: the
train and eval steps on uint8 batches normalised in the step
(``training.device_normalize``), exact validation (``validation.exact``)
over two gloo ranks, and the runner and CLI on ``config/ResNet50.yml``
over an ImageFolder written here.

Tolerances, those of ``tests/test_torch_resnet_train.py``: losses rtol
1e-5, every gradient within 1e-4 of its own largest magnitude (a ResNet
of one Bottleneck a stage at 32x32, batch 8, 10 classes, JAX init
weights).  The step's normalisation takes the native host kernel's f32
``x * scale + bias``, so its input equals the host-normalised batch bit
for bit and XLA's within one f32 rounding (atol 1e-6 at |x| <= 2.7).
Exact validation: the masked sums count each real sample once, so the
CE mean lies within rtol 1e-5 of the unsharded full-set computation and
the accuracies equal it (the same argmax; both counts are integers).
"""
import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pytorch_distributed_training_tpu.data import sampler as jsampler
from pytorch_distributed_training_tpu.engine import TrainState
from pytorch_distributed_training_tpu.engine import build_eval_step_exact as jax_exact_step
from pytorch_distributed_training_tpu.engine.steps import _input_normalizer
from pytorch_distributed_training_tpu.models import get_model as jax_get_model
from pytorch_distributed_training_tpu.models.resnet import Bottleneck as JBottle
from pytorch_distributed_training_tpu.models.resnet import ResNet as JResNet
from pytorch_distributed_training_tpu.models.torch_port import import_torch_resnet_state_dict
from pytorch_distributed_training_tpu.ops import cross_entropy_loss as jax_ce
from pytorch_distributed_training_tpu.parallel import make_mesh
from pytorch_distributed_training_tpu_torch import data as tdata
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch import schedulers as tsched
from pytorch_distributed_training_tpu_torch.engine import (
    Runner,
    build_eval_step,
    build_eval_step_exact,
    build_train_step,
)
from pytorch_distributed_training_tpu_torch.engine.steps import input_normalizer
from pytorch_distributed_training_tpu_torch.models import (
    Bottleneck,
    ResNet,
    get_model,
    resnet_state_dict_from_jax,
)
from pytorch_distributed_training_tpu_torch.native import normalize_batch
from pytorch_distributed_training_tpu_torch.tools.image_folder import write_image_folder
from pytorch_distributed_training_tpu_torch.train_distributed import main as cli_main

STAGES, CLASSES, BATCH, SIZE = (1, 1, 1, 1), 10, 8, 32
NORM = (tdata.IMAGENET_MEAN, tdata.IMAGENET_STD)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def setup():
    jm = JResNet(stage_sizes=STAGES, block_cls=JBottle, num_classes=CLASSES)
    v = jm.init(jax.random.PRNGKey(4), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, BATCH).astype(np.int64)
    return v, img, labels


def _port_step(v, input_norm):
    model = ResNet(STAGES, Bottleneck, CLASSES)
    model.load_state_dict(resnet_state_dict_from_jax(v), strict=True)
    opt = topt.SGD(lr=0.001, momentum=0.9, weight_decay=1e-4)
    sched = tsched.get_scheduler(opt, dict(name="multi_step", milestones=[2], gamma=0.1))
    return model, build_train_step(model, opt, sched.lr_fn, input_norm=input_norm)


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_normalizer_matches_host_kernel_and_jax(setup):
    _, img, _ = setup
    got = input_normalizer(NORM)(torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got.numpy(), normalize_batch(img, *NORM))
    want = np.asarray(_input_normalizer(NORM)(jnp.asarray(img)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    x = torch.ones(2, 3)
    assert input_normalizer(None)(x) is x


def test_uint8_step_matches_host_normalised_step_and_jax(setup):
    v, img, labels = setup
    model_u8, step_u8 = _port_step(v, NORM)
    loss_u8, _ = step_u8.forward_backward(torch.from_numpy(img), torch.from_numpy(labels))
    model_f32, step_f32 = _port_step(v, None)
    loss_f32, _ = step_f32.forward_backward(torch.from_numpy(normalize_batch(img, *NORM)),
                                            torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss_u8), float(loss_f32), rtol=1e-5)
    g_u8, g_f32 = _grads(model_u8), _grads(model_f32)
    for name, g in g_f32.items():
        err = ((g_u8[name] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
        assert err <= 1e-4, (name, err)

    # the JAX model on its own in-graph normalisation of the same batch
    jm = JResNet(stage_sizes=STAGES, block_cls=JBottle, num_classes=CLASSES)
    normalize = _input_normalizer(NORM)

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                          normalize(jnp.asarray(img)), train=True, mutable=["batch_stats"])
        return jax_ce(out, jnp.asarray(labels))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    np.testing.assert_allclose(float(loss_u8), float(jloss), rtol=1e-5)
    want = resnet_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                       "batch_stats": v["batch_stats"]})
    assert len(g_u8) == len(jax.tree_util.tree_leaves(jgrads))
    for name, g in g_u8.items():
        w = want[name]
        err = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        assert err <= 1e-4, (name, err)


def test_uint8_eval_steps_match_host_normalised(setup):
    v, img, labels = setup
    model, _ = _port_step(v, None)
    t_img, t_lab = torch.from_numpy(img), torch.from_numpy(labels)
    host = torch.from_numpy(normalize_batch(img, *NORM))
    for a, b in zip(build_eval_step(model, input_norm=NORM)(t_img, t_lab),
                    build_eval_step(model)(host, t_lab)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    mask = torch.tensor([1, 1, 1, 1, 1, 0, 0, 1], dtype=torch.bool)
    got = build_eval_step_exact(model, input_norm=NORM)(t_img, t_lab, mask)
    want = build_eval_step_exact(model)(host, t_lab, mask)
    assert got.shape == (4,) and got.dtype == torch.float32 and float(got[3]) == 6.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


# --------------------------------------------------------------------- #
# exact validation: two gloo ranks through the runner, against the JAX step
# and the unsharded sums

N_VAL, EXACT_CLASSES = 13, 10


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# one rank of a gloo world: the runner on the cut config, one training step
# then the exact validation; rank 0 saves the weights it validates with
_RANK = """
import json, sys, torch
from pytorch_distributed_training_tpu_torch.engine import Runner
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)  # two ranks beside the test workers: no oversubscription
with open(path + "/cfg.json") as fp:
    cfg = json.load(fp)

def save(runner):
    if rank == 0:
        torch.save(runner.model.state_dict(), path + "/state.pt")

runner = Runner(num_nodes=2, rank=rank, seed=0, dist_url="tcp://127.0.0.1:" + port,
                multiprocessing=False, logger_queue=None, global_cfg=cfg, device="cpu",
                on_iter=save)
runner()
with open(path + f"/val{rank}.json", "w") as fp:
    json.dump(runner.val_log, fp)
"""


def _sums(logits: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """``(ce_sum, top1_sum, top5_sum, n)`` of the whole set at once, in float64."""
    x = logits.astype(np.float64)
    logp = x - x.max(-1, keepdims=True)
    logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
    top5 = np.argsort(-logits, axis=-1, kind="stable")[:, :5]
    return np.array([-logp[np.arange(len(labels)), labels].sum(), (top5[:, 0] == labels).sum(),
                     (top5 == labels[:, None]).any(-1).sum(), len(labels)])


def test_exact_validation_two_gloo_ranks_match_jax_and_unsharded(tmp_path):
    cfg = yaml.safe_load((REPO / "config" / "test-sync.yml").read_text())
    cfg["dataset"].update(n_classes=EXACT_CLASSES, image_size=SIZE, n_samples=N_VAL)
    cfg["training"].update(train_iters=1, print_interval=1, val_interval=1, batch_size=4,
                           num_workers=2)
    cfg["validation"]["exact"] = True
    cfg["model"]["name"] = "ResNet18"
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    logs = [json.loads((tmp_path / f"val{r}.json").read_text()) for r in range(2)]
    assert logs[0] == logs[1] and len(logs[0]) == 1 and logs[0][0]["n"] == N_VAL
    got = logs[0][0]

    # the unsharded reference: all 13 samples at once, with the weights the
    # ranks validated with
    state = torch.load(tmp_path / "state.pt")
    model = get_model("ResNet18", num_classes=EXACT_CLASSES)
    model.load_state_dict(state, strict=True)
    val = tdata.get_dataset("synthetic", "", "val", n_classes=EXACT_CLASSES, image_size=SIZE,
                            n_samples=N_VAL)
    imgs = np.stack([val[i][0] for i in range(N_VAL)])
    labels = np.asarray([val[i][1] for i in range(N_VAL)])
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(imgs).permute(0, 3, 1, 2)).numpy()
    ref = _sums(logits, labels)
    np.testing.assert_allclose(got["loss"], ref[0] / N_VAL, rtol=1e-5)
    assert got["acc1"] == pytest.approx(100.0 * ref[1] / N_VAL, abs=1e-9)
    assert got["acc5"] == pytest.approx(100.0 * ref[2] / N_VAL, abs=1e-9)

    # the JAX exact step on the same shards, and the port's step batch by batch
    jm = jax_get_model("ResNet18", num_classes=EXACT_CLASSES)
    template = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    jv = import_torch_resnet_state_dict(template, {k: t.numpy() for k, t in state.items()})
    jstate = TrainState(params=jv["params"], batch_stats=jv["batch_stats"], opt_state=None)
    jstep = jax_exact_step(jm, make_mesh(jax.devices()[:1]))
    tstep = build_eval_step_exact(model)
    jtotal, ttotal = np.zeros(4), np.zeros(4)
    for rank in range(2):
        sampler = jsampler.DistributedShardSampler(N_VAL, 2, rank, shuffle=False)
        n_real = -(-(N_VAL - rank) // 2)
        loader = tdata.DataLoader(val, 4, tdata.DistributedShardSampler(N_VAL, 2, rank,
                                                                         shuffle=False))
        np.testing.assert_array_equal(np.concatenate(loader._batch_indices())[:n_real],
                                      sampler.local_indices()[:n_real])
        for pos, (img, lab) in zip(range(0, 8, 4), loader):
            mask = (np.arange(pos, pos + 4) < n_real).astype(np.int32)
            j = np.asarray([float(x) for x in jstep(jstate, jnp.asarray(img),
                                                    jnp.asarray(lab.astype(np.int32)),
                                                    jnp.asarray(mask))])
            t = tstep(torch.from_numpy(img), torch.from_numpy(lab),
                      torch.from_numpy(mask)).numpy()
            np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
            np.testing.assert_array_equal(t[1:], j[1:])
            jtotal += j
            ttotal += t
    np.testing.assert_allclose(jtotal[0], ref[0], rtol=1e-5)
    np.testing.assert_array_equal(jtotal[1:], ref[1:])
    np.testing.assert_array_equal(ttotal[1:], ref[1:])


# --------------------------------------------------------------------- #
# config/ResNet50.yml over an ImageFolder, on the CPU


@pytest.fixture(scope="module")
def imagenet_root(tmp_path_factory):
    return write_image_folder(str(tmp_path_factory.mktemp("imagenet")), classes=4, train=3,
                              val=2, width=80, height=60, seed=1)


def _resnet50_cfg(root, **training):
    """``config/ResNet50.yml`` as it is, cut in memory: ResNet-18, 32x32
    images, batch 4, 3 steps, the dataset root pointed at ``root``."""
    cfg = yaml.safe_load((REPO / "config" / "ResNet50.yml").read_text())
    cfg["dataset"].update(root=root, image_size=SIZE)
    cfg["training"].update(train_iters=3, batch_size=4, **training)
    cfg["model"]["name"] = "ResNet18"
    return cfg


def _run(cfg):
    seen = []
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=cfg, device="cpu",
                    on_iter=lambda r: seen.append(float(r.last_loss)))
    runner()
    return runner, seen


@pytest.mark.parametrize("form", ["float32", "device_normalize"])
def test_runner_trains_resnet50_yml_over_an_image_folder(imagenet_root, form):
    extra = dict(device_normalize=True) if form == "device_normalize" else {}
    runner, seen = _run(_resnet50_cfg(imagenet_root, **extra))
    assert runner.train_loader.worker_mode == runner.val_loader.worker_mode == "native"
    assert runner.train_loader.num_workers == 16  # num_workers over one CPU process
    assert runner.train_loader.output_dtype == ("uint8" if extra else "float32")
    assert len(seen) == 3 and all(np.isfinite(seen))
    assert [v["iter"] for v in runner.val_log] == [2]  # val_interval 2000: the last only
    assert all(0.0 <= v["acc1"] <= v["acc5"] <= 100.0 for v in runner.val_log)


def test_device_normalize_equals_host_normalisation(imagenet_root):
    """In ``thread`` mode both forms normalise the same uint8 pixels (PIL's),
    one on the host, one in the step, to the same bits: the same losses.
    The native decoder's float32 batch skips the uint8 rounding, so it lies
    within one uint8 level (divided by min(std)) of the normalised uint8
    batch, the bound of JAX ``tests/test_imagefolder.py:143``."""
    runs = [_run(_resnet50_cfg(imagenet_root, worker_mode="thread", **extra))
            for extra in ({}, dict(device_normalize=True))]
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-5)
    for key in ("loss", "acc1", "acc5"):
        np.testing.assert_allclose(runs[1][0].val_log[0][key], runs[0][0].val_log[0][key],
                                   rtol=1e-5)
    first = []
    for dtype in ("float32", "uint8"):
        ds = tdata.get_dataset("imagenet", imagenet_root, "train", image_size=SIZE)
        loader = tdata.DataLoader(ds, 4, tdata.DistributedShardSampler(len(ds), 1, 0),
                                  num_workers=2, output_dtype=dtype)
        first.append(next(iter(loader))[0])
    on_card = input_normalizer(NORM)(torch.from_numpy(first[1])).numpy()
    level = 1.0 / 255.0 / float(tdata.IMAGENET_STD.min()) + 1e-4
    assert float(np.abs(on_card - first[0]).max()) <= level


@pytest.mark.parametrize("form", ["float32", "device_normalize"])
def test_cli_trains_resnet50_yml_over_an_image_folder(imagenet_root, tmp_path, form):
    extra = dict(device_normalize=True) if form == "device_normalize" else {}
    cfg = _resnet50_cfg(imagenet_root, **extra)
    cfg["validation"]["exact"] = True
    path = tmp_path / "resnet50.yml"
    path.write_text(yaml.safe_dump(cfg))
    rc = cli_main(["--cfg-filepath", str(path), "--log-dir", str(tmp_path / "log"),
                   "--file-name-cfg", "r50", "--seed", "0", "--device", "cpu"])
    log = (tmp_path / "log" / "r50.log").read_text()
    assert rc == 0, log
    assert "Loader: native mode, 16 worker(s) a process" in log
    assert ("uint8 batches" if extra else "float32 batches") in log
    assert "Iter [0/3] Lr: [0.1]" in log
    assert log.count("Start valuation") == 1 and log.count("Acc@1: ") == 1
    assert "CRITICAL" not in log
