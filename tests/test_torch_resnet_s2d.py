"""The space-to-depth stem of the port (``model.space_to_depth``) against
the JAX package's on the CPU.

- ``fold_stem_kernel`` equals JAX's bit for bit (the same numpy copies);
- the packed stem against the 7x7/2 conv with the unfolded kernel, in
  float64: within 1e-12 of the largest output (the same products summed in
  another order; the zero slots add exact zeros);
- the port's s2d ResNet (weights through ``resnet_state_dict_from_jax``)
  against JAX's s2d ResNet, at ``tests/test_torch_resnet_train.py``'s
  tolerances: eval logits within atol 1e-5, the training loss within rtol
  1e-5 and every gradient within 1e-4 of its own largest magnitude;
- the s2d ResNet with folded weights against the 7x7 ResNet with the
  unfolded ones in float64, eval and train forward, within 1e-10 of the
  largest logit: a wrong packing order would miss by O(1);
- odd input dims raise the JAX package's ``ValueError``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_distributed_training_tpu.models.resnet import BasicBlock as JBasic
from pytorch_distributed_training_tpu.models.resnet import ResNet as JResNet
from pytorch_distributed_training_tpu.models.resnet import fold_stem_kernel as jax_fold
from pytorch_distributed_training_tpu.ops import cross_entropy_loss as jax_ce
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch.engine import build_train_step
from pytorch_distributed_training_tpu_torch.models import (
    BasicBlock,
    ResNet,
    fold_stem_kernel,
    resnet_state_dict_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.resnet import (
    StemS2D,
    fold_stem_weight,
    space_to_depth,
)

STAGES, CLASSES, BATCH, SIZE = (1, 1, 1, 1), 10, 8, 32


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread a test: beside the other test workers on the
    same cores, torch's default thread pool oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("c,o", [(3, 64), (5, 7), (1, 2)])
def test_fold_stem_kernel_is_jax_bitwise(c, o):
    w7 = np.random.default_rng(c * o).standard_normal((7, 7, c, o)).astype(np.float32)
    got, want = fold_stem_kernel(w7), np.asarray(jax_fold(w7))
    assert got.shape == want.shape == (4, 4, 4 * c, o) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # a torch tensor folds the same (the init's path), in HWIO and in OIHW
    np.testing.assert_array_equal(fold_stem_kernel(torch.from_numpy(w7)).numpy(), got)
    oihw = fold_stem_weight(torch.from_numpy(w7).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(oihw.permute(2, 3, 1, 0).numpy(), got)


@pytest.mark.parametrize("h,w", [(32, 32), (30, 34), (8, 6)])
def test_s2d_stem_equals_the_7x7_conv_in_float64(h, w):
    rng = np.random.default_rng(h + w)
    x = torch.from_numpy(rng.standard_normal((2, 3, h, w)))
    w7 = torch.from_numpy(rng.standard_normal((16, 3, 7, 7)))
    want = F.conv2d(x, w7, None, 2, 3)
    stem = StemS2D(3, 16).double()
    with torch.no_grad():
        stem.weight.copy_(fold_stem_weight(w7))
        got = stem(space_to_depth(x))
    assert got.shape == want.shape == (2, 16, h // 2, w // 2)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_space_to_depth_channel_order_is_jax_s():
    """Channel ``(u * 2 + v) * C + c`` holds pixel (2p + u, 2q + v), for a
    contiguous and a channels_last input alike."""
    x = torch.arange(2 * 3 * 4 * 6, dtype=torch.float32).reshape(2, 3, 4, 6)
    for inp in (x, x.to(memory_format=torch.channels_last)):
        z = space_to_depth(inp)
        for u in range(2):
            for v in range(2):
                for c in range(3):
                    torch.testing.assert_close(z[:, (u * 2 + v) * 3 + c],
                                               x[:, c, u::2, v::2], atol=0, rtol=0)


def test_odd_input_dims_raise_as_jax():
    jm = JResNet(stage_sizes=STAGES, block_cls=JBasic, num_classes=CLASSES,
                 space_to_depth=True)
    with pytest.raises(ValueError) as jerr:
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 31, 32, 3)), train=False)
    model = ResNet(STAGES, BasicBlock, CLASSES, space_to_depth=True)
    with pytest.raises(ValueError) as terr:
        model(torch.zeros(1, 3, 31, 32))
    want = "space_to_depth requires even input dims, got 31x32"
    assert str(terr.value) == str(jerr.value) == want


@pytest.fixture(scope="module")
def jax_s2d():
    jm = JResNet(stage_sizes=STAGES, block_cls=JBasic, num_classes=CLASSES,
                 space_to_depth=True)
    v = jm.init(jax.random.PRNGKey(6), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    rng = np.random.default_rng(17)
    img = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, BATCH).astype(np.int64)
    return jm, jax.tree_util.tree_map(np.asarray, v), img, labels


def test_s2d_resnet_forward_and_gradients_match_jax(jax_s2d):
    jm, v, img, labels = jax_s2d
    state = resnet_state_dict_from_jax(v)
    assert tuple(state["conv1.weight"].shape) == (64, 12, 4, 4)
    model = ResNet(STAGES, BasicBlock, CLASSES, space_to_depth=True)
    model.load_state_dict(state, strict=True)

    jlogits = np.asarray(jm.apply(v, img, train=False))
    with torch.no_grad():
        tlogits = model.eval()(torch.from_numpy(img).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(tlogits, jlogits, atol=1e-5)

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(img),
                          train=True, mutable=["batch_stats"])
        return jax_ce(out, jnp.asarray(labels))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    step = build_train_step(model.train(), topt.SGD(lr=0.1), lambda s: 0.1)
    loss, _ = step.forward_backward(torch.from_numpy(img), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = resnet_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                       "batch_stats": v["batch_stats"]})
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-4, (name, err)


def test_s2d_resnet_equals_the_7x7_resnet_with_unfolded_weights():
    ref = ResNet(STAGES, BasicBlock, CLASSES, dtype=torch.float64)
    ref.reset_parameters(torch.Generator().manual_seed(2))
    s2d = ResNet(STAGES, BasicBlock, CLASSES, dtype=torch.float64, space_to_depth=True)
    state = ref.state_dict()
    state["conv1.weight"] = fold_stem_weight(state["conv1.weight"])
    s2d.load_state_dict(state, strict=True)
    ref.double()
    s2d.double()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 3, SIZE, SIZE)))
    for train in (False, True):
        ref.train(train)
        s2d.train(train)
        with torch.no_grad():
            want, got = ref(x).double(), s2d(x).double()
        assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max()), train
