"""``model.pretrained`` in the port's runner, and the model keys' parsing.

The torchvision-layout twins of the JAX package's own tests
(``test_torch_port.py``'s ResNet, ``test_torch_port_vit.py``'s ViT,
``test_torch_port_lm.py``'s decoder LM) write a ``state_dict``; a runner
built from a config naming it (stopped before its loop) must hold, for
ResNet-18 at 32 px, ViT-Ti16 at 32 px and a small LM:

- the twin's eval logits (within 1e-4, as the JAX tests hold theirs);
- parameters (and a ResNet's running statistics) equal bit for bit to the
  JAX package's ``import_torch_*_state_dict`` of the same file, carried
  into the port's names by ``from_jax``.

The JAX side's templates come from ``jax.eval_shape`` (zeros of each
leaf's shape; the import reads shapes and dtypes only).  The runner
builds its ViT by zoo name, so the zoo's ViT-Ti16 entry is cut to patch
8, width 64, depth 2, 4 heads for that test.  The error cases mirror JAX
``tests/test_pretrained_config.py``: a missing file, a file without a
``state_dict``, a wrong topology, wrong classes, a non-ViT dict under a
ViT name, and MoE.  The repairs: ``is_lm`` is JAX's
rule (``config/ViT-B16.yml`` builds an image runner), the ResNet-only
keys keep JAX's messages, and no model key is dropped without a word.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port import TorchBasicBlock, TorchResNet, _randomize_running_stats
from test_torch_port_lm import TorchDecoderLM
from test_torch_port_vit import TorchEncoderLayer

from pytorch_distributed_training_tpu.models import get_model as jax_get_model
from pytorch_distributed_training_tpu.models.torch_port import (
    import_torch_lm_state_dict as jax_import_lm,
    import_torch_resnet_state_dict as jax_import_resnet,
    import_torch_vit_state_dict as jax_import_vit,
)
from pytorch_distributed_training_tpu.models.vit import ViT as JViT
from pytorch_distributed_training_tpu_torch import models as tmodels
from pytorch_distributed_training_tpu_torch.engine import ImageTrainStep, Runner
from pytorch_distributed_training_tpu_torch.engine.topology import parse_model
from pytorch_distributed_training_tpu_torch.models import (
    ViT,
    lm_state_dict_from_jax,
    resnet_state_dict_from_jax,
    vit_state_dict_from_jax,
)

REPO = Path(__file__).resolve().parent.parent
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    where torch's default pool in each of them over-subscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class TorchViT(torch.nn.Module):
    """``test_torch_port_vit.TorchViT`` (torchvision's ``VisionTransformer``
    layout) with the image side as an argument."""

    def __init__(self, num_classes, dim, heads, depth, patch, image):
        super().__init__()
        self.conv_proj = torch.nn.Conv2d(3, dim, patch, patch)
        self.class_token = torch.nn.Parameter(torch.zeros(1, 1, dim).normal_(std=0.02))
        encoder = torch.nn.Module()
        encoder.pos_embedding = torch.nn.Parameter(
            torch.empty(1, (image // patch) ** 2 + 1, dim).normal_(std=0.02))
        encoder.layers = torch.nn.ModuleDict(
            {f"encoder_layer_{i}": TorchEncoderLayer(dim, heads) for i in range(depth)})
        encoder.ln = torch.nn.LayerNorm(dim, eps=1e-6)
        self.encoder = encoder
        self.heads = torch.nn.ModuleDict({"head": torch.nn.Linear(dim, num_classes)})

    def forward(self, x):
        p = self.conv_proj(x)
        x = torch.cat([self.class_token.expand(x.shape[0], -1, -1),
                       p.flatten(2).transpose(1, 2)], 1) + self.encoder.pos_embedding
        for layer in self.encoder.layers.values():
            x = layer(x)
        return self.heads["head"](self.encoder.ln(x)[:, 0])


class _SetupOnly(Runner):
    """Stops where the loop would start: the model as the run begins."""

    def _train_loop(self, train_cfg):
        pass


def _image_cfg(ckpt, name="ResNet18", n_classes=10, **model_extra):
    return {
        "dataset": {"name": "synthetic", "root": "none", "n_classes": n_classes,
                    "image_size": SIZE, "n_samples": 16},
        "training": {"optimizer": {"name": "SGD", "lr": 0.05, "momentum": 0.9},
                     "lr_schedule": {"name": "multi_step", "milestones": [4], "gamma": 0.1},
                     "train_iters": 2, "print_interval": 1, "val_interval": 2,
                     "batch_size": 8, "num_workers": 1, "sync_bn": False},
        "validation": {"batch_size": 8, "num_workers": 1},
        "model": {"name": name, "pretrained": str(ckpt), **model_extra},
    }


def _setup(cfg):
    runner = _SetupOnly(num_nodes=1, rank=0, seed=3, dist_url="", multiprocessing=False,
                        logger_queue=None, global_cfg=json.loads(json.dumps(cfg)), device="cpu")
    runner()
    return runner


def _template(module, sample, **kwargs):
    """The flax variables' structure as zeros, from ``jax.eval_shape``."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), sample, **kwargs))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert torch.equal(t, want[name]), name


def _eval_logits(model, img):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(img).permute(0, 3, 1, 2)).numpy()


def test_resnet_pretrained(tmp_path):
    torch.manual_seed(0)
    twin = TorchResNet(TorchBasicBlock, [2, 2, 2, 2], num_classes=10)
    _randomize_running_stats(twin, seed=1)
    twin.eval()
    torch.save(twin.state_dict(), tmp_path / "r18.pt")
    runner = _setup(_image_cfg(tmp_path / "r18.pt"))
    assert runner.pretrained == str(tmp_path / "r18.pt") and not runner.is_lm
    v = _template(jax_get_model("ResNet18", num_classes=10), jnp.zeros((1, SIZE, SIZE, 3)),
                  train=False)
    want = resnet_state_dict_from_jax(jax_import_resnet(v, twin.state_dict()))
    _assert_state_equal(runner.model.state_dict(), want)
    img = np.random.default_rng(5).standard_normal((4, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        ref = twin(torch.from_numpy(img).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(_eval_logits(runner.model, img), ref, atol=1e-4, rtol=1e-4)


def test_vit_pretrained_before_the_ema(tmp_path, monkeypatch):
    patch, dim, depth, heads = 8, 64, 2, 4
    monkeypatch.setitem(tmodels.VIT_CONFIGS, "ViT-Ti16", (patch, dim, depth, heads))
    torch.manual_seed(1)
    twin = TorchViT(4, dim=dim, heads=heads, depth=depth, patch=patch, image=SIZE).eval()
    torch.save({"state_dict": twin.state_dict()}, tmp_path / "vit.pt")  # nested, as harnesses do
    cfg = _image_cfg(tmp_path / "vit.pt", name="ViT-Ti16", n_classes=4)
    cfg["training"]["ema"] = {"decay": 0.99}
    runner = _setup(cfg)
    assert isinstance(runner.model, ViT) and isinstance(runner.train_step, ImageTrainStep)
    v = _template(JViT(num_classes=4, patch_size=patch, embed_dim=dim, depth=depth,
                       num_heads=heads), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    want = vit_state_dict_from_jax(jax_import_vit(v, twin.state_dict(), num_heads=heads))
    _assert_state_equal(runner.model.state_dict(), want)
    # the EMA starts at the pretrained weights (JAX paths.py:265-269)
    for e, p in zip(runner.train_step.ema, runner.train_step.params):
        assert torch.equal(e, p)
    img = np.random.default_rng(5).standard_normal((4, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        ref = twin(torch.from_numpy(img).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(_eval_logits(runner.model, img), ref, atol=1e-4, rtol=1e-4)


def test_lm_pretrained(tmp_path):
    vocab, seq, dim = 64, 32, 64  # head dim 64: the trainer builds its LM with flash on
    torch.manual_seed(2)
    twin = TorchDecoderLM(vocab=vocab, max_len=seq, dim=dim, depth=2, heads=1)
    with torch.no_grad():
        twin.pos_emb.normal_(0, 0.02)
    torch.save(twin.state_dict(), tmp_path / "lm.pt")
    cfg = {
        "dataset": {"name": "synthetic_text", "root": "none", "n_classes": vocab,
                    "n_samples": 16, "seq_len": seq},
        "training": {"optimizer": {"name": "AdamW", "lr": 3e-4, "weight_decay": 0.1},
                     "lr_schedule": {"name": "cosine", "total_iters": 10},
                     "train_iters": 2, "print_interval": 1, "val_interval": 2,
                     "batch_size": 4, "num_workers": 1, "sync_bn": False},
        "validation": {"batch_size": 4, "num_workers": 1},
        "model": {"name": "TransformerLM", "pretrained": str(tmp_path / "lm.pt"),
                  "embed_dim": dim, "depth": 2, "num_heads": 1, "max_len": seq},
    }
    runner = _setup(cfg)
    assert runner.is_lm
    v = _template(jax_get_model("TransformerLM", num_classes=vocab, embed_dim=dim, depth=2,
                                num_heads=1, max_len=seq), jnp.zeros((1, seq), jnp.int32))
    want = lm_state_dict_from_jax(jax_import_lm(v["params"], twin.state_dict()))
    _assert_state_equal(runner.model.state_dict(), want)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, vocab, (2, seq)))
    with torch.no_grad():
        got, ref = runner.model.eval()(tokens), twin(tokens)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)


def test_pretrained_errors_as_jax(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="model.pretrained"):
        _setup(_image_cfg(tmp_path / "nope.pt"))
    torch.save([torch.zeros(2)], tmp_path / "list.pt")
    with pytest.raises(ValueError, match="does not contain a state_dict"):
        _setup(_image_cfg(tmp_path / "list.pt"))
    torch.manual_seed(0)
    twin = TorchResNet(TorchBasicBlock, [1, 1, 1, 1], num_classes=7)
    torch.save(twin.state_dict(), tmp_path / "r10.pt")  # a block short a stage
    with pytest.raises(KeyError, match="not consumed|missing"):
        _setup(_image_cfg(tmp_path / "r10.pt"))
    # the same topology, other classes: the zoo's ResNet18 cut to the twin's
    monkeypatch.setitem(tmodels.RESNET_CONFIGS, "ResNet18",
                        (tmodels.BasicBlock, (1, 1, 1, 1)))
    with pytest.raises(ValueError, match="shape mismatch for fc.weight"):
        _setup(_image_cfg(tmp_path / "r10.pt", n_classes=10))
    torch.save({}, tmp_path / "empty.pt")
    with pytest.raises(KeyError, match="conv_proj"):
        _setup(_image_cfg(tmp_path / "empty.pt", name="ViT-Ti16"))
    cfg = {"model": {"name": "TransformerLM", "pretrained": "lm.pt", "moe_experts": 4}}
    with pytest.raises(ValueError, match="does not support MoE"):
        parse_model(type("R", (), {})(), cfg)


def test_model_keys_parsed_as_jax():
    """``is_lm`` by JAX's rule, the ResNet-only keys' messages, and every
    other key handed to the constructor (before: any non-ResNet name was an
    LM, and the image path read two keys and dropped the rest)."""
    r = type("R", (), {})()
    with open(REPO / "config" / "ViT-B16.yml") as f:
        left = parse_model(r, yaml.safe_load(f))
    assert (r.is_lm, r.is_moe, r.pretrained, r.model_name, left) == (
        False, False, None, "ViT-B16", {})
    assert parse_model(r, {"model": {"name": "transformerLM", "depth": 2}}) == {"depth": 2}
    assert r.is_lm
    left = parse_model(r, {"model": {"name": "ResNet50", "space_to_depth": True,
                                     "bn_stat_dtype": "bfloat16", "pretrained": "x.pt"}})
    assert left == {"space_to_depth": True, "bn_stat_dtype": torch.bfloat16}
    assert r.pretrained == "x.pt" and not r.is_lm
    with pytest.raises(ValueError, match="only wired for the ResNet family .*ViT-B16"):
        parse_model(r, {"model": {"name": "ViT-B16", "space_to_depth": True}})
    with pytest.raises(ValueError, match="only wired for the ResNet family"):
        parse_model(r, {"model": {"name": "TransformerLM", "bn_stat_dtype": "float32"}})
    with pytest.raises(ValueError, match="must be 'float32' or 'bfloat16', got 'float16'"):
        parse_model(r, {"model": {"name": "ResNet50", "bn_stat_dtype": "float16"}})


@pytest.mark.parametrize("name", ["ResNet18", "ViT-Ti16"])
def test_unknown_model_key_raises(name):
    with pytest.raises(TypeError, match="bogus"):
        _setup({**_image_cfg("unused"), "model": {"name": name, "bogus": 1}})
