"""The long-context slice's config and runner: the ``training.remat``
alias against the JAX package's, the slice's config against
``config/TransformerLM-sp.yml``, and a tiny config of the same shape
(``sequence_parallelism: 1``, ``model.remat: True``, SGD, cosine) trained
and validated by the runner on the CPU.
"""
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import yaml

from pytorch_distributed_training_tpu.engine import topology as jtopology
from pytorch_distributed_training_tpu_torch.engine import Runner
from pytorch_distributed_training_tpu_torch.engine.runner import apply_remat_alias
from pytorch_distributed_training_tpu_torch.ops import flash_attention as tfa

REPO = Path(__file__).resolve().parent.parent
VOCAB, SEQ, EMBED, DEPTH, HEADS = 64, 256, 128, 2, 2


@pytest.mark.parametrize("alias,want", [("none", (False, "nothing")), ("block", (True, "nothing")),
                                        ("dots", (True, "dots")),
                                        ("dots_saveable", (True, "dots_saveable"))])
def test_remat_alias_maps_as_jax(alias, want):
    model_cfg = {"embed_dim": EMBED}
    apply_remat_alias({"remat": alias}, model_cfg, "TransformerLM")
    assert (model_cfg["remat"], model_cfg["remat_policy"]) == want
    # the JAX package's table (engine/topology.py) has the same entry
    assert f'"{alias}": {want!r}'.replace("'", '"') in inspect.getsource(
        jtopology.parse_topology)


@pytest.mark.parametrize(
    "train_cfg,model_cfg,name,match",
    [({"remat": "block"}, {"remat": True}, "TransformerLM", "not both"),
     ({"remat": "block"}, {"remat_policy": "nothing"}, "TransformerLM", "not both"),
     ({"remat": "everything"}, {}, "TransformerLM", "must be one of"),
     ({"remat": "block"}, {}, "ResNet50", "only wired for the LM task")],
    ids=["model-remat", "model-policy", "unknown", "not-lm"],
)
def test_remat_alias_raises_as_jax(train_cfg, model_cfg, name, match):
    with pytest.raises(ValueError, match=match):
        apply_remat_alias(train_cfg, dict(model_cfg), name)


def test_remat_alias_absent_leaves_the_model_block():
    model_cfg = {"remat": True}
    apply_remat_alias({}, model_cfg, "TransformerLM")
    assert model_cfg == {"remat": True}


def _sp_cfg(**training):
    """config/TransformerLM-sp.yml's shape at tiny widths and ring size 1."""
    cfg = {
        "dataset": {"name": "synthetic_text", "root": "none", "n_classes": VOCAB,
                    "seq_len": SEQ, "n_samples": 4},
        "training": {"optimizer": {"name": "SGD", "lr": 0.05, "weight_decay": 1e-4,
                                   "momentum": 0.9},
                     "lr_schedule": {"name": "cosine", "total_iters": 100, "end_lr": 0.0,
                                     "warmup_iters": 10, "warmup_mode": "linear",
                                     "warmup_factor": 0.01},
                     "train_iters": 3, "print_interval": 1, "val_interval": 3,
                     "batch_size": 2, "num_workers": 0, "sync_bn": False,
                     "sequence_parallelism": 1, "dtype": "float32"},
        "validation": {"batch_size": 2, "num_workers": 0},
        "model": {"name": "TransformerLM", "embed_dim": EMBED, "depth": DEPTH,
                  "num_heads": HEADS, "max_len": SEQ, "remat": True},
    }
    cfg["training"].update(training)
    return cfg


def test_runner_trains_and_validates_the_sp_shape_on_cpu(monkeypatch):
    calls = []
    real = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain", lambda *a: (calls.append(1), real(*a))[1])
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=_sp_cfg(), device="cpu")
    runner()
    assert runner.model.remat
    assert [r["iter"] for r in runner.train_log] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in runner.train_log)
    assert [v["iter"] for v in runner.val_log] == [2]
    assert np.isfinite(runner.val_log[0]["loss"])
    # 3 steps x 2 blocks x 2 (remat runs each forward again), then 2
    # validation batches x 2 blocks
    assert len(calls) == 3 * DEPTH * 2 + 2 * DEPTH


def test_runner_takes_the_training_remat_alias():
    cfg = _sp_cfg(remat="block", train_iters=1, val_interval=1)
    del cfg["model"]["remat"]
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=cfg, device="cpu")
    runner()
    assert runner.model.remat and len(runner.train_log) == 1
    with pytest.raises(ValueError, match="not both"):
        Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
               logger_queue=None, global_cfg=_sp_cfg(remat="block"), device="cpu")()


def test_longctx_config_is_the_sp_model_block():
    """The slice's config carries config/TransformerLM-sp.yml's model block,
    optimizer and schedule verbatim, at ring size 1 and 2 sequences a card."""
    ours = yaml.safe_load((REPO / "pytorch_distributed_training_tpu_torch" / "configs" /
                           "train-lm-longctx.yml").read_text())
    ref = yaml.safe_load((REPO / "config" / "TransformerLM-sp.yml").read_text())
    assert ours["model"] == ref["model"]
    for key in ("optimizer", "lr_schedule", "dtype"):
        assert ours["training"][key] == ref["training"][key]
    assert ours["dataset"] == dict(ref["dataset"], root=ours["dataset"]["root"])
    assert ours["training"]["sequence_parallelism"] == 1
    assert ref["training"]["sequence_parallelism"] == 4
    assert ours["training"]["batch_size"] == 2 and "checkpoint" not in ours["training"]
    assert "remat" not in ours["training"]  # the model block sets it
    assert json.dumps(ours)  # plain YAML, no tags
