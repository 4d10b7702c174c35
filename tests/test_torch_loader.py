"""The port's DataLoader, process pool and device prefetch against the JAX
package's, on the CPU.

The ImageFolder tree is written here (3 classes of 5 train and 3 val
JPEGs at 96x72, plus a PNG that libjpeg refuses); the synthetic dataset
serves the pool's fault cases.  Every backend of both packages builds a
batch from the same per-sample streams and the same ``native/*.cpp``, so
batches and labels must be equal bit for bit, mode by mode, over two
epochs.  The process tests run at most 2 workers, and each test bounds its
own wait: the work runs in a thread joined with a timeout, so a hang
fails the test instead of stalling the run.
"""
import multiprocessing as mp
import os
import signal
import threading
from multiprocessing import shared_memory

import numpy as np
import pytest
from PIL import Image

from pytorch_distributed_training_tpu.data import datasets as jds
from pytorch_distributed_training_tpu.data import sampler as jsampler
from pytorch_distributed_training_tpu.data.loader import DataLoader as JaxLoader
from pytorch_distributed_training_tpu_torch import data as tdata
from pytorch_distributed_training_tpu_torch import native as tnative
from pytorch_distributed_training_tpu_torch.data import datasets as tds
from pytorch_distributed_training_tpu_torch.telemetry.registry import get_registry
from pytorch_distributed_training_tpu_torch.tools.image_folder import write_image_folder

SIZE, BATCH, WAIT_S = 32, 4, 120


def within(fn, seconds: float = WAIT_S):
    """``fn()`` run in a thread; fails the test if it is not done in ``seconds``."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed back to the test below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"no result within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("imagefolder"))
    write_image_folder(root, classes=3, train=5, val=3, width=96, height=72, seed=5)
    rng = np.random.default_rng(9)
    base = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    Image.fromarray(base).resize((56, 48)).save(os.path.join(root, "train", "n00000002",
                                                             "zz.png"))
    return root


def _loaders(root, split, mode, dtype, drop_last, shuffle=True):
    t_ds = tds.get_dataset("imagenet", root, split, image_size=SIZE)
    j_ds = jds.get_dataset("imagenet", root, split, image_size=SIZE)
    args = dict(num_replicas=1, rank=0, shuffle=shuffle, drop_last=drop_last, seed=3)
    t = tdata.DataLoader(t_ds, BATCH, tdata.DistributedShardSampler(len(t_ds), **args),
                         drop_last=drop_last, num_workers=2, worker_mode=mode,
                         output_dtype=dtype)
    j = JaxLoader(j_ds, BATCH, jsampler.DistributedShardSampler(len(j_ds), **args),
                  num_workers=2, drop_last=drop_last, worker_mode=mode, output_dtype=dtype)
    return t, j


def _epochs(loader, n=2):
    out = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("mode", ["native", "thread", "process"])
def test_batches_equal_jax_loader(tree, mode, dtype):
    t, j = _loaders(tree, "train", mode, dtype, drop_last=True)
    try:
        assert t.worker_mode == j.worker_mode == mode
        got, want = within(lambda: (_epochs(t), _epochs(j)))
    finally:
        t.close()
        j.close()
    assert [len(e) for e in got] == [len(e) for e in want] == [len(t)] * 2 == [4, 4]
    assert not all(np.array_equal(a[1], b[1]) for a, b in zip(*got))  # reshuffled
    for t_epoch, j_epoch in zip(got, want):
        for (ti, tl), (ji, jl) in zip(t_epoch, j_epoch):
            assert ti.dtype == np.dtype(dtype) and ti.shape == (BATCH, SIZE, SIZE, 3)
            assert tl.dtype == np.int64
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_array_equal(ti, ji)


def test_val_loader_wrap_pads_the_tail(tree):
    t, j = _loaders(tree, "val", "native", "float32", drop_last=False, shuffle=False)
    assert len(t) == len(j) == 3  # ceil(9 / 4)
    assert [b.tolist() for b in t._batch_indices()] == [b.tolist() for b in j._batch_indices()]
    assert t._batch_indices()[-1].tolist() == [8, 0, 1, 2]
    got, want = within(lambda: (list(t), list(j)))
    assert all(img.shape[0] == BATCH for img, _ in got)
    for (ti, tl), (ji, jl) in zip(got, want):
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(got[-1][0][1:], got[0][0][:3])  # the wrapped samples


def test_auto_mode_is_strict(tree, monkeypatch):
    image = tds.get_dataset("imagenet", tree, "train", image_size=SIZE)
    synth = tds.get_dataset("synthetic", "", "train", n_classes=4, image_size=8, n_samples=8)
    sampler = tdata.DistributedShardSampler(8, 1, 0)
    assert tdata.DataLoader(image, BATCH, sampler).worker_mode == "native"
    assert tdata.DataLoader(synth, BATCH, sampler).worker_mode == "thread"
    # the JAX loader drops to threads without its library; the port's raises
    # with the compiler's output, whatever the mode asks for the library
    def broken():
        raise RuntimeError("building the native library failed (exit 1): jpeglib.h")

    monkeypatch.setattr(tnative, "library", broken)
    for mode in ("auto", "native"):
        with pytest.raises(RuntimeError, match="jpeglib.h"):
            tdata.DataLoader(image, BATCH, sampler, worker_mode=mode)
    assert tdata.DataLoader(image, BATCH, sampler, worker_mode="thread",
                            output_dtype="uint8").worker_mode == "thread"
    with pytest.raises(ValueError, match="crop_task"):
        tdata.DataLoader(synth, BATCH, sampler, worker_mode="native")
    with pytest.raises(ValueError, match="worker_mode"):
        tdata.DataLoader(synth, BATCH, sampler, worker_mode="fork")
    with pytest.raises(ValueError, match="norm_mean"):
        tdata.DataLoader(synth, BATCH, sampler, output_dtype="uint8")


def _synthetic_loader(n_samples=64, workers=1, seed=11):
    ds = tds.get_dataset("synthetic", "", "train", n_classes=4, image_size=8,
                         n_samples=n_samples)
    return tdata.DataLoader(ds, BATCH, tdata.DistributedShardSampler(len(ds), 1, 0, seed=seed),
                            drop_last=True, num_workers=workers, worker_mode="process")


def test_process_pool_reuse_and_abandonment(tree):
    """An epoch abandoned mid-flight, closed or not, leaves the next epoch
    untorn: the pool drains the old tasks before reusing their slots."""
    ds = tds.get_dataset("imagenet", tree, "train", image_size=SIZE)
    dl = tdata.DataLoader(ds, BATCH, tdata.DistributedShardSampler(len(ds), 1, 0, seed=5),
                          drop_last=True, num_workers=2, worker_mode="process")

    def run():
        it0 = iter(dl)
        next(it0)
        it0.close()  # abandoned and closed
        dl.set_epoch(1)
        e1 = list(dl)
        it1 = iter(dl)
        next(it1)  # abandoned, never closed: its finally has not run
        dl.set_epoch(1)
        e1b = list(dl)
        del it1
        return e1, e1b

    try:
        e1, e1b = within(run)
        pool = dl._pool
        assert pool._outstanding == 0 and not pool._inflight
    finally:
        dl.close()
    assert len(e1) == len(e1b) == 4
    for (a, la), (b, lb) in zip(e1, e1b):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(a, b)


@pytest.mark.chaos
def test_respawn_after_sigkill_gives_the_same_epoch():
    ref_dl = _synthetic_loader()
    try:
        ref = within(lambda: list(ref_dl))
    finally:
        ref_dl.close()
    assert len(ref) == 16
    respawns = get_registry().counter("worker_respawns")
    before = respawns.value
    dl = _synthetic_loader()

    def run():
        it = iter(dl)
        got = [next(it), next(it)]
        pool = dl._pool
        pool._poll_seconds = 0.05  # find the dead worker fast
        os.kill(pool._procs[0].pid, signal.SIGKILL)
        got.extend(it)
        return got, pool.respawns

    try:
        got, pool_respawns = within(run)
    finally:
        dl.close()
    assert pool_respawns >= 1 and respawns.value >= before + 1
    assert len(got) == len(ref)
    for (gi, gl), (ri, rl) in zip(got, ref):
        np.testing.assert_array_equal(gl, rl)
        np.testing.assert_array_equal(gi, ri)


@pytest.mark.chaos
def test_respawn_budget_exhausted_raises():
    dl = _synthetic_loader(n_samples=32)

    def run():
        it = iter(dl)
        next(it)
        pool = dl._pool
        pool._poll_seconds = 0.05
        pool.max_respawns = 0
        os.kill(pool._procs[0].pid, signal.SIGKILL)
        with pytest.raises(RuntimeError, match="respawn budget"):
            list(it)

    try:
        within(run)
    finally:
        dl.close()


def test_close_leaves_no_process_and_no_shared_memory():
    dl = _synthetic_loader(n_samples=32, workers=2)
    within(lambda: next(iter(dl)))
    pool = dl._pool
    procs, names = list(pool._procs), [pool._shm.name, pool._lshm.name]
    assert all(p.is_alive() for p in procs)
    within(dl.close, 30)
    assert dl._pool is None
    assert not any(p.is_alive() for p in procs)
    assert not {p.pid for p in procs} & {c.pid for c in mp.active_children()}
    for name in names:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)
    dl.close()  # a second close is a no-op


# --------------------------------------------------------------------- #
# device_prefetch (JAX tests/test_prefetch.py)


def test_prefetch_order_preserved_and_all_yielded():
    calls = []

    def put(x):
        calls.append(x)
        return ("dev", x)

    out = list(tdata.device_prefetch(iter([(i,) for i in range(7)]), put, depth=2))
    assert out == [("dev", i) for i in range(7)]
    assert calls == list(range(7))


def test_prefetch_puts_run_ahead_by_depth():
    staged = []
    gen = tdata.device_prefetch(iter([(i,) for i in range(5)]),
                                lambda x: staged.append(x) or x, depth=3)
    assert next(gen) == 0
    assert staged == [0, 1, 2, 3]  # 3 before the first yield, one more for it


def test_prefetch_short_stream_empty_and_bad_depth():
    assert list(tdata.device_prefetch(iter([(1,), (2,)]), lambda x: x, depth=4)) == [1, 2]
    assert list(tdata.device_prefetch(iter([]), lambda x: x, depth=2)) == []
    with pytest.raises(ValueError, match="depth"):
        list(tdata.device_prefetch(iter([]), lambda x: x, depth=0))

