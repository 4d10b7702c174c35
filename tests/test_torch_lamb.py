"""The port's LAMB against the JAX package's on the CPU.

Three updates of the same parameters from the same seeded gradients: a
matrix and a conv kernel (adapted, trust ratio ``||p|| / ||u||``), a bias
and a scale (rank <= 1: excluded, no decay, ratio 1), and a zero matrix
(``||p|| = 0``: ratio 1).  Each update's parameters and moments within
rtol 2e-6 / atol 1e-7 of the JAX ones (f32; the two order their
multiply-adds differently), the step count equal; with the learning rate
from a schedule (a per-step ``lr``) and with the default one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu import optimizers as jopt
from pytorch_distributed_training_tpu_torch import optimizers as topt

SHAPES = {"w": (16, 8), "conv": (3, 3, 4, 8), "bias": (8,), "scale": (8,), "zero": (4, 4)}


def _params(rng):
    out = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    out["zero"] = np.zeros(SHAPES["zero"], np.float32)
    return out


@pytest.mark.parametrize("wd,lr_sched", [(0.01, True), (0.0, False), (0.1, True)])
def test_three_lamb_steps_match_jax(wd, lr_sched):
    rng = np.random.default_rng(3)
    p0 = _params(rng)
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    lrs = [1e-3, 2e-3, 5e-4] if lr_sched else [None] * 3
    jo = jopt.LAMB(lr=1e-3, betas=(0.9, 0.999), eps=1e-6, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jo.init(jp)
    to = topt.get_optimizer({"name": "LAMB"})(lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                                                weight_decay=wd)
    names = list(SHAPES)
    tp = [torch.from_numpy(p0[k].copy()) for k in names]
    ts = to.init(tp)
    for g, lr in zip(grads, lrs):
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, lr)
        ts = to.update(tp, [torch.from_numpy(g[k]) for k in names], ts, lr)
        for i, k in enumerate(names):
            for got, want in ((tp[i], jp[k]), (ts.mu[i], js.mu[k]), (ts.nu[i], js.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=1e-7,
                                           err_msg=k)
    assert ts.step == int(js.step) == 3
    assert isinstance(ts, topt.AdamWState)
    # the zero matrix took a plain (ratio 1) step, the excluded leaves no decay
    assert np.abs(tp[names.index("zero")].numpy()).max() > 0


def test_lamb_trust_ratio_scales_the_step():
    """One step of an adapted leaf moves it by ``lr * ||p||`` (ratio
    ``||p|| / ||u||`` times ``||u||``), whatever the gradient's size."""
    for scale in (1e-3, 1.0, 1e3):
        p = torch.full((4, 4), 2.0)
        opt = topt.LAMB(lr=0.1)
        opt.update([p], [torch.full((4, 4), scale)], opt.init([p]))
        np.testing.assert_allclose((p - 2.0).norm().item(), 0.1 * 8.0, rtol=1e-5)
