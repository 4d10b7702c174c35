"""Classification serving: the port's engine against the JAX package's.

ResNet-18 at 32 px (random running statistics, so eval mode matters) and
a small ViT (patch 8, width 64, depth 2, 4 heads) share weights drawn with
numpy from a seed into the JAX variable trees (``jax.eval_shape``; convs
at He scale, Dense kernels at lecun scale) through ``from_jax``; the same seeded uint8 requests go to both
engines (f32, ImageNet normalisation on the device, bucket 4): the labels
are equal and the logits within 1e-4 of the largest one (f32 sums in
another order).  Also: a short batch padded up to its bucket gives each
request the logits it gets alone (within 1e-5 of its largest); a random-init ResNet has no buffer left
on the meta device; the engine restored from the port's own checkpoint
of a run with an EMA gives the runner's eval of the EMA weights; the
refusals; the CLI on a tiny image config (the zoo's ViT-Ti16 entry cut
to the small ViT).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.data.datasets import IMAGENET_MEAN, IMAGENET_STD
from pytorch_distributed_training_tpu.models import get_model as jax_get_model
from pytorch_distributed_training_tpu.models.vit import ViT as JViT
from pytorch_distributed_training_tpu.parallel import make_mesh
from pytorch_distributed_training_tpu.serving import InferenceEngine as JaxEngine
from pytorch_distributed_training_tpu_torch import models as tmodels
from pytorch_distributed_training_tpu_torch.engine import Runner
from pytorch_distributed_training_tpu_torch.engine.steps import input_normalizer
from pytorch_distributed_training_tpu_torch.models import (
    ViT,
    get_model,
    resnet_state_dict_from_jax,
    vit_state_dict_from_jax,
)
from pytorch_distributed_training_tpu_torch.serving import InferenceEngine
from pytorch_distributed_training_tpu_torch.serving.__main__ import main as serve_main

SIZE, CLASSES, BUCKET = 32, 10, 4
VIT = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4)
ENGINE = dict(batch_buckets=[BUCKET], seq_buckets=[16], max_batch_size=BUCKET, max_delay_ms=20.0,
              image_size=SIZE, input_norm=(IMAGENET_MEAN, IMAGENET_STD))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    where torch's default pool in each of them over-subscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _requests(n, seed=3):
    return list(np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8))


_JAX = {}


def _jax_and_port(family):
    """The JAX model and its weights (drawn once a family), and a port
    model with the same weights as a ``state_dict``."""
    if family not in _JAX:
        _JAX[family] = _jax_init(family)
    jm, params, stats = _JAX[family]
    if family == "resnet":
        state = resnet_state_dict_from_jax({"params": params, "batch_stats": stats})
        return jm, params, stats, get_model("ResNet18", num_classes=CLASSES), state
    return jm, params, stats, ViT(CLASSES, image_size=SIZE, **VIT), vit_state_dict_from_jax(params)


def _jax_init(family):
    jm = (jax_get_model("ResNet18", num_classes=CLASSES) if family == "resnet"
          else JViT(num_classes=CLASSES, **VIT))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(2)

    def draw(path, s):
        leaf = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel":
            gain = 2.0 if len(s.shape) == 4 and family == "resnet" else 1.0
            return x * np.float32(np.sqrt(gain / np.prod(s.shape[:-1])))
        if leaf == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return 1.0 + 0.1 * x if leaf == "scale" else 0.05 * x

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return jm, v["params"], v.get("batch_stats", {})


@pytest.mark.parametrize("family", ["resnet", "vit"])
def test_classify_matches_jax_engine(family):
    jm, params, stats, model, state = _jax_and_port(family)
    reqs = _requests(7)
    jax_engine = JaxEngine(jm, params, stats, make_mesh(jax.devices()[:1]), is_lm=False,
                           **ENGINE)
    with jax_engine:
        want = [f.result(timeout=120) for f in [jax_engine.submit(r) for r in reqs]]
    with InferenceEngine(model, state_dict=state, device="cpu", **ENGINE) as engine:
        assert not engine.is_lm and engine.scheduler is None
        got = [f.result(timeout=120) for f in [engine.submit(r) for r in reqs]]
    top = max(np.abs(w["logits"]).max() for w in want)
    for g, w in zip(got, want):
        assert g["label"] == w["label"]
        assert g["logits"].dtype == np.float32 and g["logits"].shape == (CLASSES,)
        assert np.abs(g["logits"] - w["logits"]).max() <= 1e-4 * top


def test_bucket_padding_and_metrics():
    _, _, _, model, state = _jax_and_port("resnet")
    model.load_state_dict(state)
    seen = []
    with InferenceEngine(model, device="cpu", **{**ENGINE, "max_delay_ms": 200.0}) as engine:
        logits = engine._logits
        engine._logits = lambda img: seen.append(img.shape) or logits(img)
        reqs = _requests(3, seed=4)
        got = [f.result(timeout=120) for f in [engine.submit(r) for r in reqs]]
        snap = engine.snapshot()
    assert seen == [(BUCKET, SIZE, SIZE, 3)]  # three requests padded to the bucket
    assert snap["requests"] == 3 and snap["batches"] == 1 and snap["batch_size_mean"] == 3.0
    assert snap["batch_host_ms_p50"] > 0
    norm = input_normalizer((IMAGENET_MEAN, IMAGENET_STD))
    with torch.no_grad():
        for g, img in zip(got, reqs):
            alone = model.eval()(norm(torch.from_numpy(img[None])).permute(0, 3, 1, 2))[0]
            # f32 convolutions of another batch size sum in another order
            assert np.abs(g["logits"] - alone.numpy()).max() <= 1e-5 * alone.abs().max()


def test_random_init_materialises_every_buffer():
    cfg = {"dataset": {"name": "imagenet", "n_classes": CLASSES, "image_size": SIZE},
           "model": {"name": "ResNet18"},
           "serving": {"dtype": "bfloat16", "max_batch_size": 2, "batch_buckets": [2],
                       "seed": 0}}
    with InferenceEngine.from_config(cfg, device="cpu") as engine:
        assert engine.warmup()["pairs"] == 1.0
        named = list(engine.model.named_parameters()) + list(engine.model.named_buffers())
        assert not [n for n, t in named if t.is_meta or not torch.isfinite(t).all()]
        buffers = dict(engine.model.named_buffers())
        assert len(buffers) == 2 * 20  # running mean and var of every BatchNorm
        for name, b in buffers.items():
            assert torch.equal(b, torch.zeros_like(b) if name.endswith("mean")
                               else torch.ones_like(b)), name
        out = engine.submit(_requests(1)[0]).result(timeout=120)
        assert np.isfinite(out["logits"]).all() and 0 <= out["label"] < CLASSES


def test_serving_a_checkpoint_with_an_ema(tmp_path):
    cfg = {
        "dataset": {"name": "synthetic", "root": "none", "n_classes": CLASSES,
                    "image_size": SIZE, "n_samples": 16},
        "training": {"optimizer": {"name": "SGD", "lr": 0.05, "momentum": 0.9},
                     "lr_schedule": {"name": "multi_step", "milestones": [4], "gamma": 0.1},
                     "train_iters": 2, "print_interval": 1, "val_interval": 100,
                     "batch_size": 8, "num_workers": 1, "sync_bn": False,
                     "ema": {"decay": 0.5}, "checkpoint": {"dir": str(tmp_path), "interval": 10}},
        "validation": {"batch_size": 8, "num_workers": 1},
        "model": {"name": "ResNet18"},
    }
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=cfg, device="cpu")
    runner()
    reqs = _requests(4, seed=5)
    norm = input_normalizer((IMAGENET_MEAN, IMAGENET_STD))
    with runner._eval_weights(), torch.no_grad():
        want = runner.model.eval()(norm(torch.from_numpy(np.stack(reqs))).permute(0, 3, 1, 2))
        raw = [p.clone() for p in runner.model.parameters()]
    assert any(not torch.equal(a, b) for a, b in zip(raw, runner.model.parameters()))
    serve = {"dataset": {"name": "imagenet", "n_classes": CLASSES, "image_size": SIZE},
             "model": {"name": "ResNet18"},
             "serving": {"dtype": "float32", "max_batch_size": BUCKET, "batch_buckets": [BUCKET],
                         "max_delay_ms": 50.0, "checkpoint": str(tmp_path)}}
    with InferenceEngine.from_config(serve, device="cpu") as engine:
        got = [f.result(timeout=120) for f in [engine.submit(r) for r in reqs]]
    np.testing.assert_allclose(np.stack([g["logits"] for g in got]), want.numpy(), atol=1e-5,
                               rtol=0)


def test_refusals():
    _, _, _, model, state = _jax_and_port("vit")
    for key, block in (("quant", {"enabled": True}), ("lora", {"enabled": True}),
                       ("speculative", {"enabled": True})):
        with pytest.raises(ValueError, match="serving.quant/lora/speculative are LM-only"):
            InferenceEngine(model, device="cpu", **ENGINE, **{key: block})
    with pytest.raises(ValueError, match="serving.scheduler is LM-only"):
        InferenceEngine(model, device="cpu", scheduler={"enabled": True}, **ENGINE)
    with InferenceEngine(model, state_dict=state, device="cpu", **ENGINE) as engine:
        with pytest.raises(ValueError, match="must have shape"):
            engine.submit(np.zeros((SIZE, SIZE + 1, 3), np.uint8))
        with pytest.raises(ValueError, match="must be uint8"):
            engine.submit(np.zeros((SIZE, SIZE, 3), np.float32))
        with pytest.raises(ValueError, match="LM-only"):
            engine.submit(_requests(1)[0], max_new_tokens=2)


def test_cli_serves_a_tiny_classifier(tmp_path, capsys, monkeypatch):
    # the CLI builds by zoo name: the zoo's ViT-Ti16 entry cut to the small ViT
    monkeypatch.setitem(tmodels.VIT_CONFIGS, "ViT-Ti16", tuple(VIT.values()))
    cfg = tmp_path / "serve-vit.yml"
    cfg.write_text(json.dumps({
        "dataset": {"name": "imagenet", "n_classes": CLASSES, "image_size": SIZE},
        "model": {"name": "ViT-Ti16"},
        "serving": {"dtype": "bfloat16", "max_batch_size": BUCKET, "batch_buckets": [BUCKET],
                    "max_delay_ms": 5, "normalize": True, "seed": 0}}))
    assert serve_main(["--config", str(cfg), "--device", "cpu", "--requests", "6",
                       "--log-dir", str(tmp_path / "log")]) == 0
    snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["serving"]
    assert snap["requests"] == 6 and snap["items"] == 6
    log = (tmp_path / "log" / "serve.log").read_text()
    assert "task=image" in log and "path=batcher" in log
