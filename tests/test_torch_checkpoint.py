"""Checkpoint and resume of the port's runner (``training.checkpoint``),
its loader's resume position and the preemption guard, on the CPU.

- Resume: 6 straight steps against 3 steps, a kill, and a new ``Runner``
  that resumes and runs to 6, on the image path (synthetic data with the
  weight EMA; ImageFolder in ``thread`` and ``process`` mode) and on a
  tiny LM (AdamW).  Parameters, BatchNorm buffers, optimizer state, EMA,
  the losses of steps 3-5 and the validations must be equal bit for bit:
  the same arithmetic on the same batches in the same order.
- The pipeline position: a mid-epoch resume lands on the next unseen
  batch, and the sidecar's position wins over ``divmod``.
- ``DataLoader.skip_next`` and ``make_iter_dataloader`` against the JAX
  package's index sequences, with the negative skip, the clamp past an
  epoch's end and the empty loader; in process mode a skipped batch is
  never dispatched to a worker.
- Refusals and restore: ``resume: false`` on a populated directory,
  ``max_to_keep`` pruning with the sidecars, a truncated newest step
  falling back to the previous one, a leftover temporary directory
  invisible, every unported key raising P10.
- Two gloo ranks: rank 0 writes, both restore.
- Preemption: SIGTERM in the main thread saves at the current iteration
  and exits cleanly, and the relaunch ends where a straight run ends; in
  another thread the guard only warns.
Every wait on another process has its own timeout.
"""
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from pytorch_distributed_training_tpu.data import loader as jloader
from pytorch_distributed_training_tpu.data import sampler as jsampler
from pytorch_distributed_training_tpu.utils import make_iter_dataloader as jax_iter
from pytorch_distributed_training_tpu_torch import data as tdata
from pytorch_distributed_training_tpu_torch.data.worker_pool import ProcessLoaderPool
from pytorch_distributed_training_tpu_torch.engine import Runner
from pytorch_distributed_training_tpu_torch.engine.checkpoint import Checkpointer
from pytorch_distributed_training_tpu_torch.engine.preemption import PreemptionGuard
from pytorch_distributed_training_tpu_torch.tools.image_folder import write_image_folder

REPO = Path(__file__).resolve().parent.parent
SIZE = 32
TIMEOUT = 120  # seconds, each wait on a child process


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread a test: beside the other test workers on the
    same cores, torch's default thread pool oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Kill(Exception):
    """Stands for the process dying right after an iteration."""


class Recording(Runner):
    """A runner that keeps the labels of every batch it trains on."""

    def train_iter(self, inputs, labels):
        self.seen_labels = getattr(self, "seen_labels", []) + [labels.clone()]
        super().train_iter(inputs, labels)


def _image_cfg(root=None, **training):
    cfg = yaml.safe_load((REPO / "config" / "test-sync.yml").read_text())
    cfg["dataset"].update(n_classes=10, image_size=SIZE, n_samples=20)
    if root is not None:
        cfg["dataset"].update(name="imagenet", root=root)
    cfg["training"].update({**dict(train_iters=6, print_interval=1, val_interval=4,
                                   batch_size=4, num_workers=1), **training})
    cfg["model"]["name"] = "ResNet18"
    return cfg


def _lm_cfg(**training):
    cfg = {
        "dataset": {"name": "synthetic_text", "root": "none", "n_classes": 64, "seq_len": 128,
                    "n_samples": 16},
        "training": {"optimizer": {"name": "AdamW", "lr": 1e-3, "weight_decay": 0.1},
                     "lr_schedule": {"name": "cosine", "total_iters": 6, "warmup_iters": 2},
                     "train_iters": 6, "print_interval": 1, "val_interval": 4, "batch_size": 4,
                     "num_workers": 1, "sync_bn": False, "dtype": "float32"},
        "validation": {"batch_size": 4, "num_workers": 1},
        "model": {"name": "TransformerLM", "embed_dim": 64, "depth": 1, "num_heads": 1,
                  "max_len": 128},
    }
    cfg["training"].update(training)
    return cfg


def _run(cfg, ckpt_dir=None, kill_at=None, **ck):
    cfg = json.loads(json.dumps(cfg))
    if ckpt_dir is not None:
        cfg["training"]["checkpoint"] = {"dir": str(ckpt_dir), "interval": 3, **ck}
    losses = {}

    def on_iter(runner):
        if runner.iter == kill_at:
            raise Kill
        losses[runner.iter] = float(runner.last_loss)

    runner = Recording(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                       logger_queue=None, global_cfg=cfg, device="cpu", on_iter=on_iter)
    if kill_at is None:
        runner()
    else:
        with pytest.raises(Kill):
            runner()
    return runner, losses


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.train_step.opt_state, b.train_step.opt_state
    assert oa.step == ob.step == a.iter
    for field in oa._fields:
        if field != "step":
            for x, y in zip(getattr(oa, field), getattr(ob, field)):
                assert torch.equal(x, y), field
    ea, eb = getattr(a.train_step, "ema", None), getattr(b.train_step, "ema", None)
    assert (ea is None) == (eb is None)
    for x, y in zip(ea or (), eb or ()):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    return write_image_folder(str(tmp_path_factory.mktemp("imagenet")), classes=4, train=3,
                              val=2, width=48, height=40, seed=3)


@pytest.mark.parametrize("form", ["synthetic-ema", "imagefolder-thread", "imagefolder-process",
                                  "lm"])
def test_resume_equals_a_straight_run_bitwise(form, image_root, tmp_path):
    if form == "lm":
        cfg = _lm_cfg(worker_mode="thread")
    elif form == "synthetic-ema":
        cfg = _image_cfg(ema={"decay": 0.9})
    else:
        cfg = _image_cfg(image_root, worker_mode=form.split("-")[1])
    straight, want = _run(cfg, tmp_path / "a")
    _, first = _run(cfg, tmp_path / "b", kill_at=3)
    assert sorted(os.listdir(tmp_path / "b")) == ["2", "pipeline_2.json"]
    resumed, rest = _run(cfg, tmp_path / "b")
    assert sorted(rest) == [3, 4, 5] and {**first, **rest} == want
    assert resumed.scheduler.last_epoch == straight.scheduler.last_epoch == 6
    _assert_same_state(straight, resumed)
    assert resumed.val_log == [v for v in straight.val_log if v["iter"] >= 3]
    for x, y in zip(resumed.seen_labels, straight.seen_labels[3:]):
        assert torch.equal(x, y)
    assert sorted(os.listdir(tmp_path / "b")) == sorted(os.listdir(tmp_path / "a")) == [
        "2", "5", "pipeline_2.json", "pipeline_5.json"]


def test_mid_epoch_resume_lands_on_the_next_unseen_batch(tmp_path):
    """20 samples, batch 4: 5 batches an epoch.  The save at iteration 2
    records (epoch 0, 3 consumed); the resume's first batch is the straight
    run's fourth.  A sidecar that says otherwise wins over divmod."""
    cfg = _image_cfg()
    straight, _ = _run(cfg)
    for sub in ("a", "b"):
        _run(cfg, tmp_path / sub, kill_at=3)
    side = json.loads((tmp_path / "a" / "pipeline_2.json").read_text())
    assert side == {"epoch": 0, "batch_in_epoch": 3, "seed": 0, "world_processes": 1,
                    "batches_per_epoch": 5, "step": 2}
    cfg["training"]["train_iters"] = 4
    resumed, _ = _run(cfg, tmp_path / "a")
    assert torch.equal(resumed.seen_labels[0], straight.seen_labels[3])
    # the recorded position wins: say iteration 2 ended the epoch
    side.update(epoch=1, batch_in_epoch=0)
    (tmp_path / "b" / "pipeline_2.json").write_text(json.dumps(side))
    resumed, _ = _run(cfg, tmp_path / "b")
    assert torch.equal(resumed.seen_labels[0], straight.seen_labels[5])  # epoch 1, batch 0


# --------------------------------------------------------------------- #
# the loader's resume position against the JAX package's


class _Indexed:
    """Sample i is (i as an image, i as its label); indices in ``poison``
    raise, to show they were never fetched."""

    def __init__(self, n, poison=()):
        self.n, self.poison = n, set(poison)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if int(i) in self.poison:
            raise RuntimeError(f"sample {i} was fetched")
        return np.full((2,), i, np.float32), np.int64(i)


def _pair(n=22, batch=4, workers=0, mode="thread", poison=()):
    ds = _Indexed(n, poison)
    port = tdata.DataLoader(ds, batch, tdata.DistributedShardSampler(n, 1, 0, seed=5),
                            drop_last=True, num_workers=workers, worker_mode=mode)
    jax = jloader.DataLoader(ds, batch, jsampler.DistributedShardSampler(n, 1, 0, seed=5),
                             drop_last=True, num_workers=workers, worker_mode=mode)
    return port, jax


def _labels(stream, k):
    return [next(stream)[1].tolist() for _ in range(k)]


@pytest.mark.parametrize("position", [dict(start_iter=0), dict(start_iter=7),
                                      dict(start_iter=10), dict(start_epoch=1, skip_batches=2),
                                      dict(start_epoch=0, skip_batches=9),
                                      dict(start_epoch=2, skip_batches=0)],
                         ids=["start", "iter-mid-epoch", "iter-epoch-boundary", "sidecar",
                              "clamped", "sidecar-boundary"])
def test_make_iter_dataloader_matches_jax_indices(position):
    port, jax = _pair()
    got = _labels(tdata.make_iter_dataloader(port, **position), 12)
    want = _labels(jax_iter(jax, **position), 12)
    assert got == want
    assert len(port) == 5


def test_skip_next_is_one_epoch_only_and_refuses_negative():
    port, jax = _pair()
    for loader in (port, jax):
        loader.skip_next(3)
    assert [b[1].tolist() for b in port] == [b[1].tolist() for b in jax]
    assert len(list(port)) == 5  # the next epoch is whole again
    for loader in (port, jax):
        with pytest.raises(ValueError, match="n_batches must be >= 0"):
            loader.skip_next(-1)
    port.skip_next(50)  # clamped: the epoch yields nothing
    assert list(port) == []


@pytest.mark.parametrize("bad,match", [
    (dict(start_epoch=1), "must be given together"),
    (dict(skip_batches=1), "must be given together"),
    (dict(start_epoch=-1, skip_batches=0), ">= 0"),
    (dict(start_epoch=0, skip_batches=-2), ">= 0")])
def test_make_iter_dataloader_validates_at_the_call(bad, match):
    port, jax = _pair()
    for fn, loader in ((tdata.make_iter_dataloader, port), (jax_iter, jax)):
        with pytest.raises(ValueError, match=match):
            fn(loader, **bad)


def test_empty_loader_raises_at_the_call():
    port, jax = _pair(n=3)
    for fn, loader in ((tdata.make_iter_dataloader, port), (jax_iter, jax)):
        with pytest.raises(ValueError, match="loader yields no batches"):
            fn(loader)


def test_process_mode_never_dispatches_a_skipped_batch(monkeypatch):
    """The pool is handed the epoch's batches after the skip, and no
    other: a skipped batch never reaches a worker."""
    handed = []
    run_epoch = ProcessLoaderPool.run_epoch

    def spy(self, batches, epoch, postprocess):
        handed.append([b.tolist() for b in batches])
        return run_epoch(self, batches, epoch, postprocess)

    monkeypatch.setattr(ProcessLoaderPool, "run_epoch", spy)
    ds = tdata.SyntheticDataset(n_samples=22, n_classes=1000, image_size=4)  # label = index
    sampler = tdata.DistributedShardSampler(22, 1, 0, seed=5)
    port = tdata.DataLoader(ds, 4, sampler, drop_last=True, num_workers=1,
                            worker_mode="process")
    try:
        got = _labels(tdata.make_iter_dataloader(port, start_epoch=0, skip_batches=2), 3)
    finally:
        port.close()
    order = sampler.local_indices()
    want = [order[8 + 4 * i:12 + 4 * i].tolist() for i in range(3)]
    assert got == want and handed == [want]


# --------------------------------------------------------------------- #
# refusals and restore


def test_resume_false_on_a_populated_directory_raises(tmp_path):
    cfg = _image_cfg(train_iters=3)
    _run(cfg, tmp_path)
    with pytest.raises(ValueError, match="already has step 2 but resume is False"):
        _run(cfg, tmp_path, resume=False)


def test_max_to_keep_prunes_steps_with_their_sidecars(tmp_path):
    _run(_image_cfg(train_iters=6), tmp_path, interval=1, max_to_keep=2)
    assert sorted(os.listdir(tmp_path)) == ["4", "5", "pipeline_4.json", "pipeline_5.json"]


def test_truncated_newest_step_falls_back_and_tmp_dirs_are_invisible(tmp_path):
    cfg = _image_cfg(train_iters=6)
    straight, _ = _run(cfg, tmp_path / "a")
    _run(cfg, tmp_path / "b", kill_at=4, interval=1)  # steps 1..3 kept (max_to_keep 3)
    (tmp_path / "b" / "4.tmp-999").mkdir()  # a save cut short
    (tmp_path / "b" / "4.tmp-999" / "state.pt").write_bytes(b"partial")
    newest = tmp_path / "b" / "3" / "state.pt"
    newest.write_bytes(newest.read_bytes()[:1000])  # truncated
    assert Checkpointer(str(tmp_path / "b")).all_steps() == [1, 2, 3]
    resumed, _ = _run(cfg, tmp_path / "b", interval=100)
    assert resumed.checkpointer.last_restore["step"] == 2
    assert len(resumed.seen_labels) == 3  # resumed at 3, ran 3..5
    _assert_same_state(straight, resumed)


def test_every_step_unreadable_raises_the_newest_error(tmp_path):
    ck = Checkpointer(str(tmp_path))
    for step in (0, 1):
        ck.save(step, {"iter": -1})  # loads, but is not the step it claims
    with pytest.raises(ValueError, match="checkpoint step 1 holds iteration -1"):
        ck.restore_latest(lambda payload: None, "cpu")
    assert Checkpointer(str(tmp_path / "none")).restore_latest(lambda p: None, "cpu") == 0


@pytest.mark.parametrize("key,value", [("async", True), ("max_inflight", 2),
                                       # ported (P2b): retried saves and loads
                                       ("retry", {"attempts": 3}),
                                       ("emergency_drain_timeout_s", 10.0)])
def test_unported_checkpoint_keys_raise_p10(key, value, tmp_path):
    cfg = _image_cfg()
    cfg["training"]["checkpoint"] = {"dir": str(tmp_path), key: value}
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=cfg, device="cpu")
    if key == "retry":
        runner()
        assert runner.checkpointer.retry.attempts == 3 and runner.checkpointer.retries == 0
        assert runner.checkpointer.all_steps()
        return
    with pytest.raises(NotImplementedError, match=f"training.checkpoint.{key}: .*P10"):
        runner()
    assert not os.listdir(tmp_path)


# --------------------------------------------------------------------- #
# two gloo ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# one rank: 3 steps saving at 2, then a new runner that resumes and runs a 4th
_RANK = """
import json, sys, torch
from pytorch_distributed_training_tpu_torch.engine import Runner
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
cfg = json.load(open(path + "/cfg.json"))
out = {}
for iters in (3, 4):
    cfg["training"]["train_iters"] = iters
    r = Runner(num_nodes=2, rank=rank, seed=0, dist_url="tcp://127.0.0.1:" + port,
               multiprocessing=False, logger_queue=None, global_cfg=cfg, device="cpu")
    r()
    out[iters] = dict(iter=r.iter, restored=r.checkpointer.last_restore,
                      saved=r.checkpointer.last_save is not None,
                      fc=r.model.state_dict()["fc.weight"].sum().item())
json.dump(out, open(path + f"/rank{rank}.json", "w"))
"""


def test_two_gloo_ranks_rank0_writes_both_restore(tmp_path):
    cfg = _image_cfg()
    cfg["training"]["checkpoint"] = {"dir": str(tmp_path / "ck"), "interval": 3}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    got = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert [g["3"]["saved"] for g in got] == [True, False]  # rank 0 writes
    assert [g["4"]["restored"]["step"] for g in got] == [2, 2]  # both restore
    assert got[0]["4"]["fc"] == got[1]["4"]["fc"]
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3", "pipeline_2.json",
                                                   "pipeline_3.json"]
    side = json.loads((tmp_path / "ck" / "pipeline_2.json").read_text())
    assert side["world_processes"] == 2 and side["batches_per_epoch"] == 2


# --------------------------------------------------------------------- #
# preemption

_PREEMPT = """
import json, os, signal, sys, torch
from pytorch_distributed_training_tpu_torch.engine import Runner
path = sys.argv[1]
torch.set_num_threads(1)  # beside the test workers: no oversubscription
cfg = json.load(open(path + "/cfg.json"))

def run(ckpt, kill):
    c = json.loads(json.dumps(cfg))
    c["training"]["checkpoint"] = {"dir": path + "/" + ckpt, "interval": 100}
    def on_iter(r):
        if kill is not None and r.iter == kill:
            os.kill(os.getpid(), signal.SIGTERM)
    r = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
               logger_queue=None, global_cfg=c, device="cpu", on_iter=on_iter)
    r()
    return r

straight = run("a", None)
pre = run("b", 4)
out = dict(pre_iter=pre.iter, pre_steps=sorted(os.listdir(path + "/b")),
           handler_restored=signal.getsignal(signal.SIGTERM) == signal.SIG_DFL)
again = run("b", None)
out["resumed_at"] = again.checkpointer.last_restore["step"] + 1
sa, sb = straight.model.state_dict(), again.model.state_dict()
out["equal"] = all(torch.equal(sa[k], sb[k]) for k in sa) and all(
    torch.equal(x, y) for x, y in zip(straight.train_step.ema, again.train_step.ema))
json.dump(out, open(path + "/out.json", "w"))
"""


def test_sigterm_saves_at_the_current_iteration_and_exits_cleanly(tmp_path):
    (tmp_path / "cfg.json").write_text(json.dumps(_image_cfg(ema={"decay": 0.9})))
    proc = subprocess.run([sys.executable, "-c", _PREEMPT, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["pre_iter"] == 4 and out["pre_steps"] == ["4", "pipeline_4.json"]
    assert out["handler_restored"]
    assert out["resumed_at"] == 5 and out["equal"]


def test_guard_off_the_main_thread_only_warns():
    logger = logging.getLogger("test_guard_thread")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger.addHandler(handler)
    before = signal.getsignal(signal.SIGTERM)
    seen = {}

    def body():
        with PreemptionGuard((signal.SIGTERM,), logger=logger) as guard:
            seen["installed"] = guard._installed
            seen["handler"] = signal.getsignal(signal.SIGTERM)

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=10)
    logger.removeHandler(handler)
    assert not t.is_alive()
    assert seen == {"installed": False, "handler": before}
    assert any("not on the main thread" in r.getMessage() for r in records)


@pytest.mark.parametrize("spec,want", [("SIGTERM", (signal.SIGTERM,)),
                                       (["term", "usr1"], (signal.SIGTERM, signal.SIGUSR1)),
                                       (int(signal.SIGUSR2), (signal.SIGUSR2,))])
def test_parse_signals(spec, want):
    assert PreemptionGuard.parse_signals(spec) == want
    with pytest.raises(ValueError):
        PreemptionGuard.parse_signals(["NOPE"])
