"""The LM path's loaders with workers (``training.num_workers``,
``training.worker_mode``), on the CPU.

The batches of ``num_workers`` 2 in ``thread`` and ``process`` mode must
equal, bit for bit, those of the one producer thread the LM path used
before (``num_workers`` 0), over two epochs: the same samples in the same
order, tokens int32 and next-token labels int64.  The runner hands the LM
loaders its per-card share of ``num_workers`` and the mode, and trains to
the same losses in both modes.
"""
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu_torch import data as tdata
from pytorch_distributed_training_tpu_torch.engine import Runner


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread a test: beside the other test workers on the
    same cores, torch's default thread pool oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _epochs(loader, n=2):
    out = []
    try:
        for epoch in range(n):
            loader.set_epoch(epoch)
            out += list(loader)
    finally:
        loader.close()
    return out


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_lm_batches_with_workers_equal_the_one_thread_producer(mode):
    ds = tdata.get_dataset("synthetic_text", "", "train", n_classes=97, n_samples=26,
                           seq_len=32)

    def loader(**kw):
        return tdata.DataLoader(ds, 4, tdata.DistributedShardSampler(len(ds), 1, 0, seed=3),
                                drop_last=True, **kw)

    want = _epochs(loader())
    got = _epochs(loader(num_workers=2, worker_mode=mode))
    assert len(got) == len(want) == 12
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype == np.int32 and gl.dtype == wl.dtype == np.int64
        assert gi.shape == (4, 32) and gl.shape == (4, 32)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_lm_runner_takes_num_workers_and_worker_mode():
    def run(mode):
        cfg = {
            "dataset": {"name": "synthetic_text", "root": "none", "n_classes": 64,
                        "seq_len": 128, "n_samples": 12},
            "training": {"optimizer": {"name": "SGD", "lr": 0.1},
                         "lr_schedule": {"name": "cosine", "total_iters": 3},
                         "train_iters": 3, "print_interval": 1, "val_interval": 10,
                         "batch_size": 4, "num_workers": 2, "worker_mode": mode,
                         "sync_bn": False},
            "validation": {"batch_size": 4, "num_workers": 2},
            "model": {"name": "TransformerLM", "embed_dim": 64, "depth": 1, "num_heads": 1,
                      "max_len": 128},
        }
        runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                        logger_queue=None, global_cfg=cfg, device="cpu")
        runner()
        assert runner.train_loader.worker_mode == runner.val_loader.worker_mode == mode
        assert runner.train_loader.num_workers == 2  # one CPU process: all of them
        return [r["loss"] for r in runner.train_log], runner.val_log

    assert run("thread") == run("process")
