"""Serving from the port's own training checkpoint (``serving.checkpoint``).

The training runner writes a checkpoint of a small LM (2 steps, AdamW);
an engine built from ``serving.checkpoint`` must give the same greedy
tokens as one built in memory from the runner's weights, on the batcher
path and through the scheduler.  A payload that carries a weight EMA is
served with the EMA weights in place of the raw ones (JAX
``load_serving_state``, ``engine/checkpoint.py:1183``).  The port's
runner, like the JAX package's (``engine/topology.py:351``), keeps an EMA
on the image task only, so the EMA payload here is written with
``Checkpointer.save`` beside the runner's.
"""
import json
import os

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu_torch.engine.checkpoint import (
    Checkpointer,
    load_serving_state,
)
from pytorch_distributed_training_tpu_torch.engine.runner import Runner
from pytorch_distributed_training_tpu_torch.serving import InferenceEngine

VOCAB = 64
MODEL = {"name": "TransformerLM", "embed_dim": 64, "depth": 1, "num_heads": 1, "max_len": 128}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-step LM run checkpointed at every step."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    cfg = {
        "dataset": {"name": "synthetic_text", "root": "none", "n_classes": VOCAB,
                    "seq_len": 128, "n_samples": 16},
        "training": {"optimizer": {"name": "AdamW", "lr": 1e-2, "weight_decay": 0.1},
                     "lr_schedule": {"name": "cosine", "total_iters": 2, "warmup_iters": 0},
                     "train_iters": 2, "print_interval": 1, "val_interval": 100,
                     "batch_size": 4, "num_workers": 1, "sync_bn": False, "dtype": "float32",
                     "checkpoint": {"dir": str(ckpt), "interval": 1}},
        "validation": {"batch_size": 4, "num_workers": 1},
        "model": dict(MODEL),
    }
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=json.loads(json.dumps(cfg)), device="cpu")
    runner()
    return str(ckpt), {k: v.detach().clone() for k, v in runner.model.state_dict().items()}


def _serve_cfg(scheduler, checkpoint=None):
    serve = {"dtype": "float32", "max_batch_size": 4, "batch_buckets": [4],
             "seq_buckets": [16], "max_new_tokens": 5, "temperature": 0.0, "seed": 3}
    if scheduler:
        serve["scheduler"] = {"enabled": True, "slots": 4, "block_size": 4, "num_blocks": 32}
    if checkpoint:
        serve["checkpoint"] = checkpoint
    return {"dataset": {"name": "synthetic_text", "n_classes": VOCAB}, "model": dict(MODEL),
            "serving": serve}


def _greedy(cfg, state_dict=None):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, int(n)).astype(np.int32) for n in (3, 9, 16, 1)]
    with InferenceEngine.from_config(cfg, device="cpu", state_dict=state_dict) as engine:
        return [f.result(timeout=60)["tokens"].tolist()
                for f in [engine.submit(p) for p in prompts]]


@pytest.mark.parametrize("scheduler", [False, True], ids=["batcher", "scheduler"])
def test_restore_serves_the_trained_weights(trained, scheduler):
    ckpt, weights = trained
    state, step = load_serving_state(ckpt)
    assert step == 1  # the newest of steps 0 and 1
    assert state.keys() == weights.keys()
    for k in state:
        assert torch.equal(state[k], weights[k]), k
    got = _greedy(_serve_cfg(scheduler, ckpt))
    assert got == _greedy(_serve_cfg(scheduler), state_dict=weights)
    # and not the random init the seed would give
    assert got != _greedy(_serve_cfg(scheduler))


def test_ema_weights_replace_the_raw_ones(trained, tmp_path):
    _, weights = trained
    ema = {k: v * 0.5 for k, v in weights.items() if k != "pos_embedding"}
    Checkpointer(str(tmp_path)).save(
        4, {"iter": 4, "model": weights, "optimizer": None, "ema": ema})
    state, step = load_serving_state(str(tmp_path))
    assert step == 4
    for k in weights:
        assert torch.equal(state[k], ema.get(k, weights[k])), k
    want = _greedy(_serve_cfg(True), state_dict={**weights, **ema})
    assert _greedy(_serve_cfg(True, str(tmp_path))) == want
    Checkpointer(str(tmp_path)).save(
        5, {"iter": 5, "model": weights, "optimizer": None, "ema": {"nope": weights["ln.bias"]}})
    with pytest.raises(ValueError, match="EMA names parameters"):
        load_serving_state(str(tmp_path))


def test_no_checkpoint_and_orbax_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="serving.checkpoint unset"):
        load_serving_state(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="train with training.checkpoint.dir"):
        InferenceEngine.from_config(_serve_cfg(False, str(tmp_path)), device="cpu")
    # an orbax step directory (the JAX package's format): P7b
    os.makedirs(tmp_path / "orbax" / "3" / "default")
    (tmp_path / "orbax" / "3" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="P7b"):
        load_serving_state(str(tmp_path / "orbax"))
    # ported (P8): a classifier reaches the checkpoint too, and the empty
    # directory raises as for the LM
    cfg = _serve_cfg(False, str(tmp_path))
    cfg["model"] = {"name": "ResNet18"}
    with pytest.raises(FileNotFoundError, match="train with training.checkpoint.dir"):
        InferenceEngine.from_config(cfg, device="cpu")
