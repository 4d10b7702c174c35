"""The port's token-file dataset (``tokens``/``tokenbin``) against the JAX
package's, on the CPU.

- the windows: every ``(inputs, targets)`` pair of both splits equal to the
  JAX dataset's, for ``uint16`` (the default, no ``dtype`` in
  ``meta.json``) and ``uint32`` files, and a dataset pickled to a process
  worker maps the file there instead of carrying its tokens;
- the errors: a missing file, a file shorter than one ``seq_len + 1``
  window and a ``meta.json`` ``vocab_size`` above ``n_classes`` raise as
  in the JAX package (same class, same text);
- the runner: two SGD steps of a one-block LM over a written token file,
  the port's runner against the JAX runner from the same initial weights
  (the JAX runner on a one-device mesh): the same batches, every
  parameter within atol 2e-5 / rtol 1e-4 (f32, summation order only), and
  the optimizer's step count equal.
"""
import json
import pickle

import jax
import numpy as np
import pytest

from pytorch_distributed_training_tpu.data import datasets as jdata
from pytorch_distributed_training_tpu_torch import data as tdata
from pytorch_distributed_training_tpu_torch.engine import Runner
from pytorch_distributed_training_tpu_torch.models import lm_state_dict_from_jax

VOCAB, SEQ = 64, 128


def _write(root, n_windows=(40, 8), dtype="uint16", meta=True, vocab=VOCAB, seed=0):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for split, n in zip(("train", "val"), n_windows):
        rng.integers(0, VOCAB, n * SEQ + 1).astype(dtype).tofile(root / f"{split}.bin")
    if meta:
        body = {"vocab_size": vocab}
        if dtype != "uint16":
            body["dtype"] = dtype
        (root / "meta.json").write_text(json.dumps(body))
    return str(root)


@pytest.mark.parametrize("dtype,meta", [("uint16", False), ("uint16", True), ("uint32", True)])
def test_windows_match_jax(tmp_path, dtype, meta):
    root = _write(tmp_path, dtype=dtype, meta=meta)
    for split in ("train", "val"):
        got = tdata.get_dataset("tokens", root, split, n_classes=VOCAB, seq_len=SEQ)
        want = jdata.get_dataset("tokens", root, split, n_classes=VOCAB, seq_len=SEQ)
        assert isinstance(got, tdata.TokenFileDataset)
        assert len(got) == len(want) == (40 if split == "train" else 8)
        assert got.vocab_size == want.vocab_size and got.dtype == np.dtype(dtype)
        for i in range(len(got)):
            for a, b in zip(got[i], want[i]):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
    ds = tdata.get_dataset("tokenbin", root, "train", seq_len=SEQ)
    ds[0]
    clone = pickle.loads(pickle.dumps(ds))
    assert clone._tokens is None and len(pickle.dumps(ds)) < 1000
    np.testing.assert_array_equal(clone[3][0], ds[3][0])


@pytest.mark.parametrize("case", ["missing", "short", "vocab"])
def test_errors_match_jax(tmp_path, case):
    if case == "missing":
        root, kw = str(tmp_path / "none"), dict(n_classes=VOCAB)
    elif case == "short":
        root = _write(tmp_path, meta=False)
        np.zeros(SEQ, np.uint16).tofile(tmp_path / "train.bin")  # 128 tokens < 129
        kw = dict(n_classes=VOCAB)
    else:
        root, kw = _write(tmp_path, vocab=VOCAB + 1), dict(n_classes=VOCAB)
    with pytest.raises(Exception) as want:
        jdata.get_dataset("tokens", root, "train", seq_len=SEQ, **kw)
    with pytest.raises(type(want.value)) as got:
        tdata.get_dataset("tokens", root, "train", seq_len=SEQ, **kw)
    assert str(got.value) == str(want.value)


def _cfg(root):
    return {"dataset": {"name": "tokens", "root": root, "n_classes": VOCAB, "seq_len": SEQ},
            "training": {"optimizer": {"name": "SGD", "lr": 0.1, "momentum": 0.9},
                         "lr_schedule": {"name": "multi_step", "milestones": [100], "gamma": 0.1},
                         "train_iters": 2, "print_interval": 1, "val_interval": 100,
                         "batch_size": 8, "num_workers": 0, "sync_bn": False,
                         "dtype": "float32"},
            "validation": {"batch_size": 8, "num_workers": 0},
            "model": {"name": "TransformerLM", "embed_dim": 128, "depth": 1, "num_heads": 2,
                      "max_len": SEQ}}


def test_two_runner_steps_over_a_token_file_match_jax(tmp_path, monkeypatch):
    from pytorch_distributed_training_tpu.engine import Runner as JaxRunner
    from pytorch_distributed_training_tpu.engine import paths
    from pytorch_distributed_training_tpu.parallel import make_sp_mesh

    monkeypatch.setattr(paths, "make_sp_mesh",
                        lambda sp, *a, **k: make_sp_mesh(sp, devices=jax.devices()[:1]))
    root = _write(tmp_path / "tokens")
    batches = {}

    class _Jax(JaxRunner):
        def _train_loop(self, iter_generator, train_cfg):
            self.init = jax.tree_util.tree_map(np.asarray, self.state.params)
            super()._train_loop(iter_generator, train_cfg)

    jr = _Jax(num_nodes=1, rank=0, seed=3, dist_url="tcp://127.0.0.1:9901", dist_backend="tpu",
              multiprocessing=False, logger_queue=None, global_cfg=_cfg(root),
              tb_writer_constructor=lambda: None)
    jr()

    class _Port(Runner):
        def _build_lm_model(self, *args):
            super()._build_lm_model(*args)
            self.model.load_state_dict(lm_state_dict_from_jax(jr.init), strict=True)

        def train_iter(self, inputs, labels):
            batches[self.iter] = inputs.clone()
            super().train_iter(inputs, labels)

    pr = _Port(num_nodes=1, rank=0, seed=3, dist_url="", multiprocessing=False,
               logger_queue=None, global_cfg=_cfg(root), device="cpu")
    pr()
    assert pr.iter == 2 and pr.train_step.opt_state.step == int(jr.state.opt_state.step) == 2
    # the port's stream is the JAX package's: the same shuffled windows
    sampler = tdata.DistributedShardSampler(40, 1, 0, shuffle=True, drop_last=True, seed=3)
    order = list(iter(sampler))
    ds = tdata.get_dataset("tokens", root, "train", n_classes=VOCAB, seq_len=SEQ)
    for it in (0, 1):
        want = np.stack([ds[i][0] for i in order[it * 8:(it + 1) * 8]])
        np.testing.assert_array_equal(batches[it].numpy(), want)
    want = lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jr.state.params))
    for name, p in pr.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=name)
    assert all(np.isfinite(r["loss"]) for r in pr.train_log)
