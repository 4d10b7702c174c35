"""The port's ResNet pieces against the JAX package's on the CPU:
BatchNorm, the ResNet logits, the weight map, the synthetic image dataset
and the multi_step schedule.

Inputs come from numpy seeds and go through both sides.  Tolerances:
- BatchNorm (f32): outputs, running statistics and gradients within atol
  1e-5 and rtol 1e-5 (values of order 1; the two sides reduce in other
  orders, one f32 rounding per sum of 128 terms);
- eval-mode logits within atol 1e-5: the running statistics fix every
  layer, so only f32 summation order differs;
- train-mode logits within atol 1e-4: at batch 4 and 32x32 the last
  stage normalizes over 4 values a channel, whose small spread magnifies
  the summation-order differences of the statistics (a typical |logit| is
  1-2, so this is ~1e-4 relative);
- the weight map's round trip, the dataset and the schedule's host values
  exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu import optimizers as jopt
from pytorch_distributed_training_tpu import schedulers as jsched
from pytorch_distributed_training_tpu.data import datasets as jdatasets
from pytorch_distributed_training_tpu.models.resnet import BasicBlock as JBasic
from pytorch_distributed_training_tpu.models.resnet import Bottleneck as JBottle
from pytorch_distributed_training_tpu.models.resnet import ResNet as JResNet
from pytorch_distributed_training_tpu.models.torch_port import import_torch_resnet_state_dict
from pytorch_distributed_training_tpu.ops.batch_norm import DistributedBatchNorm as JaxBN
from pytorch_distributed_training_tpu_torch import data as tdata
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch import schedulers as tsched
from pytorch_distributed_training_tpu_torch.models import (
    BasicBlock,
    Bottleneck,
    ResNet,
    get_model,
    resnet_state_dict_from_jax,
)
from pytorch_distributed_training_tpu_torch.ops.batch_norm import DistributedBatchNorm


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------- #
# BatchNorm


def _bn_inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 5, 6, 8)) * 2.0 + 3.0).astype(np.float32)  # NHWC, C = 8
    cot = rng.standard_normal(x.shape).astype(np.float32)
    stats = {"mean": rng.normal(2.5, 0.5, 8).astype(np.float32),
             "var": rng.uniform(2.0, 6.0, 8).astype(np.float32)}
    params = {"scale": rng.normal(1.0, 0.2, 8).astype(np.float32),
              "bias": rng.normal(0.0, 0.2, 8).astype(np.float32)}
    return x, cot, stats, params


def _jax_bn(mode: str, x, cot, stats, params):
    """Output, new running statistics and gradients (x, scale, bias) of the
    JAX BatchNorm; ``sync`` runs it with ``axis_name`` under a size-1 vmap."""
    sync = mode == "sync"
    bn = JaxBN(use_running_average=mode == "eval", axis_name="data" if sync else None)

    def f(p, xx):
        y, mut = bn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    fn = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)
    if sync:
        fn = jax.vmap(fn, in_axes=(None, 0), axis_name="data")
        (_, (y, new)), (gp, gx) = fn(params, jnp.asarray(x)[None])
        y, gx = y[0], gx[0]
        new = jax.tree_util.tree_map(lambda a: a[0], new)
        gp = jax.tree_util.tree_map(lambda a: a[0], gp)
    else:
        (_, (y, new)), (gp, gx) = fn(params, jnp.asarray(x))
    return np.asarray(y), {k: np.asarray(v) for k, v in new.items()}, np.asarray(gx), \
        {k: np.asarray(v) for k, v in gp.items()}


@pytest.mark.parametrize("mode", ["sync", "local", "eval"])
def test_batch_norm_matches_jax(mode):
    """Sync takes raw moments (one all-reduce, skipped at world size 1),
    local the shifted form around the running mean: both against the JAX
    module in the same mode, with a mean far from 0 and running
    statistics far from the batch's."""
    x, cot, stats, params = _bn_inputs(len(mode))
    jy, jstats, jgx, jgp = _jax_bn(mode, x, cot, stats, params)
    bn = DistributedBatchNorm(8, sync=mode == "sync")
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
    bn.train(mode != "eval")
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    ty = bn(tx)
    (ty * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(), jy, **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), jstats["mean"], **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), jstats["var"], **tol)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), jgx, **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), jgp["scale"], **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), jgp["bias"], **tol)
    if mode == "eval":
        np.testing.assert_array_equal(bn.running_mean.numpy(), stats["mean"])


def test_batch_norm_bf16_output_and_statistics():
    """bf16 activations: statistics and running buffers stay f32, the
    output is bf16 and equals the f32 computation on the same bf16 input,
    rounded once."""
    x, _, _, _ = _bn_inputs(7)
    xb = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    bn, ref = DistributedBatchNorm(8), DistributedBatchNorm(8)
    y = bn(xb)
    want = ref(xb.float())
    assert y.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    torch.testing.assert_close(y, want.to(torch.bfloat16), atol=0, rtol=0)
    torch.testing.assert_close(bn.running_var, ref.running_var, atol=0, rtol=0)
    # ported: statistics in bf16 (model.bn_stat_dtype), running buffers f32;
    # within a few bf16 ulps (2^-8 relative) of the f32 statistics
    low = DistributedBatchNorm(8, stat_dtype=torch.bfloat16)
    y_low = low(xb)
    assert y_low.dtype == torch.bfloat16 and low.running_var.dtype == torch.float32
    torch.testing.assert_close(y_low.float(), want, atol=4 * 2**-8, rtol=4 * 2**-8)
    torch.testing.assert_close(low.running_var, ref.running_var, atol=0, rtol=4 * 2**-8)


# --------------------------------------------------------------------- #
# the model

NETS = {"resnet18": (JBasic, BasicBlock, (2, 2, 2, 2)),
        "bottleneck1111": (JBottle, Bottleneck, (1, 1, 1, 1))}


def _jax_net(name: str, seed: int = 1):
    jb, tb, stages = NETS[name]
    jm = JResNet(stage_sizes=stages, block_cls=jb, num_classes=10)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)), train=False)
    return jm, jax.tree_util.tree_map(np.asarray, v), (stages, tb)


def _random_stats(v, rng):
    """Running statistics that are not the init's, so eval mode reads them."""
    bs = jax.tree_util.tree_map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                                v["batch_stats"])
    return {"params": v["params"], "batch_stats": bs}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_resnet_logits_match_jax(name, train):
    jm, v, (stages, tb) = _jax_net(name)
    rng = np.random.default_rng(5)
    if not train:
        v = _random_stats(v, rng)
    model = ResNet(stages, tb, 10)
    model.load_state_dict(resnet_state_dict_from_jax(v), strict=True)
    model.train(train)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    if train:
        jy, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        jy = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        ty = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert ty.dtype == torch.float32 and ty.shape == (4, 10)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4 if train else 1e-5, rtol=0)
    if train:  # the running statistics after one call
        want = resnet_state_dict_from_jax({"params": v["params"],
                                           "batch_stats": jax.tree_util.tree_map(
                                               np.asarray, mut["batch_stats"])})
        for key, val in model.state_dict().items():
            if "running" in key:
                np.testing.assert_allclose(val.numpy(), want[key].numpy(), atol=1e-5,
                                           rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", sorted(NETS))
def test_weight_map_round_trip(name):
    """JAX variables -> the port's state_dict -> the JAX package's own
    torchvision import -> the same variables, bit for bit."""
    _, v, (stages, tb) = _jax_net(name, seed=2)
    v = _random_stats(v, np.random.default_rng(3))
    state = resnet_state_dict_from_jax(v)
    assert set(state) == set(ResNet(stages, tb, 10).state_dict())
    back = import_torch_resnet_state_dict(v, state)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_v = dict(jax.tree_util.tree_leaves_with_path(v))
    assert len(flat_back) == len(flat_v)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_v[path], err_msg=str(path))


@pytest.mark.parametrize("change", ["extra", "missing", "shape"])
def test_weight_map_is_strict(change):
    _, v, _ = _jax_net("bottleneck1111", seed=2)
    params = {k: dict(val) if isinstance(val, dict) else val for k, val in v["params"].items()}
    if change == "extra":
        params["fc"] = dict(params["fc"], extra=np.zeros(3, np.float32))
    elif change == "missing":
        params["layer1_0"] = {k: val for k, val in params["layer1_0"].items() if k != "bn2"}
    else:
        params["fc"] = dict(params["fc"], bias=np.zeros(11, np.float32))
    with pytest.raises(ValueError):
        resnet_state_dict_from_jax({"params": params, "batch_stats": v["batch_stats"]})


@pytest.mark.parametrize("name,n_params", [("ResNet18", 11_689_512), ("ResNet50", 25_557_032),
                                           ("resnet101", 44_549_160)])
def test_resnet_family_sizes_are_torchvision_s(name, n_params):
    """Parameter counts of torchvision's ResNets with 1000 classes."""
    with torch.device("meta"):
        model = get_model(name, num_classes=1000)
    assert sum(p.numel() for p in model.parameters()) == n_params
    assert "layer2.0.downsample.1.running_var" in model.state_dict()


@pytest.mark.parametrize("kwargs", [dict(space_to_depth=True),
                                    dict(bn_stat_dtype=torch.bfloat16),
                                    dict(space_to_depth=True, size=31)])
def test_unported_resnet_options_raise(kwargs):
    """Ported (P3b-2): the space-to-depth stem and bf16 BatchNorm statistics
    build and train-forward to finite logits; the stem refuses odd input
    dims with the JAX package's ``ValueError``."""
    kwargs = dict(kwargs)
    size = kwargs.pop("size", 32)
    model = get_model("ResNet18", num_classes=10, **kwargs)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, size, size),
                                                                   np.float32))
    if size % 2:
        with pytest.raises(ValueError, match="space_to_depth requires even input dims, got "
                                             "31x31"):
            model(x)
        return
    y = model(x)
    assert y.shape == (2, 10) and torch.isfinite(y).all()
    if kwargs.get("space_to_depth"):
        assert tuple(model.conv1.weight.shape) == (64, 12, 4, 4)
    else:
        assert all(m.low_stats for m in model.modules() if isinstance(m, DistributedBatchNorm))


# --------------------------------------------------------------------- #
# data and schedule


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_images_identical(split):
    j = jdatasets.get_dataset("synthetic", "", split, n_classes=37, n_samples=50, image_size=24)
    t = tdata.get_dataset("synthetic", "", split, n_classes=37, n_samples=50, image_size=24)
    assert len(j) == len(t) == 50
    for idx in (0, 1, 36, 49):
        (ji, jl), (ti, tl) = j[idx], t[idx]
        assert ti.dtype == ji.dtype == np.float32 and ti.shape == (24, 24, 3)
        assert type(tl) is type(jl) is np.int64 and tl == jl == idx % 37
        np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("split,n", [("train", 12_800), ("val", 1_280)])
def test_synthetic_defaults_and_aliases(split, n):
    for alias in ("synthetic", "fake", "fake_imagenet"):
        ds = tdata.get_dataset(alias, "", split)
        assert isinstance(ds, tdata.SyntheticDataset)
        assert len(ds) == n and ds.n_classes == 1000 and ds.image_size == 224


@pytest.mark.parametrize("warmup", [
    dict(), dict(warmup_iters=5, warmup_mode="linear", warmup_factor=0.25),
    dict(warmup_iters=3, warmup_mode="constant", warmup_factor=0.5)],
    ids=["plain", "linear-warmup", "constant-warmup"])
def test_multi_step_matches_jax(warmup):
    cfg = dict(name="multi_step", milestones=[7, 4, 12], gamma=0.1, **warmup)
    jfn = jsched.get_scheduler(jopt.SGD(lr=0.1), cfg).lr_fn
    sched = tsched.get_scheduler(topt.SGD(lr=0.1), cfg)
    for step in range(16):
        assert sched.get_last_lr() == [jfn(step)]  # the same float64 host arithmetic
        np.testing.assert_allclose(sched.lr_fn(step), float(jfn(jnp.int32(step))), rtol=1e-6)
        sched.step()
    assert tsched.multi_step_lr(1.0, [2], 0.5)(2) == 0.5


def test_resnet50_model_flop_is_the_published_count():
    """``chip_smoke.py``'s model FLOP (2 x the multiply-adds of the convs
    and ``fc``, from a meta-device forward): ResNet-50 at 224^2 is the
    published 4.09 G multiply-adds an image (within 0.5%)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    flop = cs.resnet_forward_flop(torch, "ResNet50", 1000, 224)
    assert abs(flop / 2 - 4.09e9) <= 0.005 * 4.09e9


@pytest.mark.parametrize("form", ["port", "native", "two_pass"])
def test_gradient_drift_tool_runs_each_batch_norm_form(form):
    """``tools/resnet_grad_drift.py`` at a small size: every gradient
    compared, finite readings; its ``two_pass`` and ``native`` forms give
    the forward of the port's local form on the same batch."""
    from pytorch_distributed_training_tpu_torch.tools import resnet_grad_drift as drift

    got = drift.gradient_drift("ResNet18", image_size=32, batch=4, form=form)
    assert got["tensors"] == len(list(get_model("ResNet18", 1000).parameters()))
    assert np.isfinite(got["norm_rel_all"]) and 0 <= got["beyond_1e_4"] <= got["tensors"]
    x = torch.from_numpy(_bn_inputs(3)[0]).permute(0, 3, 1, 2)
    bn = DistributedBatchNorm(8)
    with drift._batch_norm_form(form):
        y = bn(x)
    torch.testing.assert_close(y, DistributedBatchNorm(8)(x), atol=1e-5, rtol=1e-5)
