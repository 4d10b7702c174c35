"""BatchNorm with bfloat16 statistics (``model.bn_stat_dtype: bfloat16``)
in the port against the JAX package's ``stat_dtype=jnp.bfloat16`` on the
CPU, and two gloo ranks of the sync form against one rank.

Inputs: a bf16 NHWC batch [4, 5, 6, 8] with mean ~3 (far from 0, where
bf16's 8 mantissa bits would cancel in raw moments), running statistics
far from the batch's.  Tolerances, in bf16 ulps (2^-8 relative) of each
tensor's largest magnitude, the two sides rounding each bf16 operation at
other places (XLA keeps some intermediates in f32):
- outputs, input gradients and the new running statistics within 4;
- the scale and bias gradients, each a bf16 reduction over the 120
  positions of a channel, within 16 (~sqrt(120) ulps of accumulated
  rounding);
- the running statistics stay float32.
Two gloo ranks on half batches against one rank on the whole batch (the
sync form's single all-reduce of the shifted moments): the same bounds.
"""
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops.batch_norm import DistributedBatchNorm as JaxBN
from pytorch_distributed_training_tpu_torch.ops.batch_norm import DistributedBatchNorm

ULP = 2.0**-8
REPO = Path(__file__).resolve().parent.parent


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 5, 6, 8)) * 2.0 + 3.0).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))  # bf16 values
    cot = rng.standard_normal(x.shape).astype(np.float32)
    stats = {"mean": rng.normal(2.5, 0.5, 8).astype(np.float32),
             "var": rng.uniform(2.0, 6.0, 8).astype(np.float32)}
    params = {"scale": rng.normal(1.0, 0.2, 8).astype(np.float32),
              "bias": rng.normal(0.0, 0.2, 8).astype(np.float32)}
    return x, cot, stats, params


def _jax(mode, x, cot, stats, params):
    sync = mode == "sync"
    bn = JaxBN(use_running_average=mode == "eval", axis_name="data" if sync else None,
               stat_dtype=jnp.bfloat16)

    def f(p, xx):
        y, mut = bn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, mut["batch_stats"])

    fn = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    if sync:
        (_, (y, new)), (gp, gx) = jax.vmap(fn, in_axes=(None, 0), axis_name="data")(
            params, xb[None])
        y, gx, new, gp = y[0], gx[0], {k: a[0] for k, a in new.items()}, \
            {k: a[0] for k, a in gp.items()}
    else:
        (_, (y, new)), (gp, gx) = fn(params, xb)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    return f32(y), {k: np.asarray(v) for k, v in new.items()}, f32(gx), \
        {k: f32(v) for k, v in gp.items()}


def _port(sync, train, x, cot, stats, params):
    bn = DistributedBatchNorm(8, sync=sync, stat_dtype=torch.bfloat16)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
    bn.train(train)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16).requires_grad_(True)
    y = bn(tx)
    (y.float() * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    return bn, y.detach(), tx.grad


def _close(got, want, ulps, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= ulps * ULP * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("mode", ["local", "sync", "eval"])
def test_bf16_statistics_match_jax(mode):
    x, cot, stats, params = _inputs(len(mode))
    jy, jstats, jgx, jgp = _jax(mode, x, cot, stats, params)
    bn, y, gx = _port(mode == "sync", mode != "eval", x, cot, stats, params)
    assert y.dtype == torch.bfloat16 and gx.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    _close(y.float().permute(0, 2, 3, 1).numpy(), jy, 4, "y")
    _close(gx.float().permute(0, 2, 3, 1).numpy(), jgx, 4, "dx")
    _close(bn.weight.grad.numpy(), jgp["scale"], 16, "dscale")
    _close(bn.bias.grad.numpy(), jgp["bias"], 16, "dbias")
    _close(bn.running_mean.numpy(), jstats["mean"], 4, "running_mean")
    _close(bn.running_var.numpy(), jstats["var"], 4, "running_var")
    if mode == "eval":
        np.testing.assert_array_equal(bn.running_mean.numpy(), stats["mean"])


def test_var_is_clamped_at_zero():
    """A constant channel: the bf16 moments may round the variance below
    0; it is clamped, so the output stays finite."""
    bn = DistributedBatchNorm(2, stat_dtype=torch.bfloat16)
    with torch.no_grad():
        bn.running_mean.fill_(-7.0)
    x = torch.full((4, 2, 3, 3), 1000.3, dtype=torch.bfloat16)
    y = bn(x)
    assert torch.isfinite(y).all() and (bn.running_var >= 0).all()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# one rank of a gloo world: the sync bf16 BatchNorm on its half of the batch
_RANK = """
import sys, torch, torch.distributed as dist
from pytorch_distributed_training_tpu_torch.ops.batch_norm import DistributedBatchNorm
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
inp = torch.load(path + "/in.pt")
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port, world_size=2,
                        rank=rank)
bn = DistributedBatchNorm(8, sync=True, stat_dtype=torch.bfloat16)
bn.load_state_dict(inp["state"])
x = inp["x"][rank * 2:(rank + 1) * 2].clone().requires_grad_(True)
y = bn(x)
(y.float() * inp["cot"][rank * 2:(rank + 1) * 2]).sum().backward()
torch.save({"y": y.detach(), "dx": x.grad, "dscale": bn.weight.grad, "dbias": bn.bias.grad,
            "state": bn.state_dict()}, path + f"/rank{rank}.pt")
dist.destroy_process_group()
"""


def test_sync_bf16_two_gloo_ranks_equal_one_rank(tmp_path):
    x, cot, stats, params = _inputs(11)
    bn, y, gx = _port(True, True, x, cot, stats, params)
    start = DistributedBatchNorm(8, sync=True, stat_dtype=torch.bfloat16)
    with torch.no_grad():
        start.running_mean.copy_(torch.from_numpy(stats["mean"]))
        start.running_var.copy_(torch.from_numpy(stats["var"]))
        start.weight.copy_(torch.from_numpy(params["scale"]))
        start.bias.copy_(torch.from_numpy(params["bias"]))
    torch.save({"state": start.state_dict(),
                "x": torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16),
                "cot": torch.from_numpy(cot).permute(0, 3, 1, 2)}, tmp_path / "in.pt")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    _close(torch.cat([r["y"] for r in ranks]).float().numpy(), y.float().numpy(), 4, "y")
    _close(torch.cat([r["dx"] for r in ranks]).float().numpy(), gx.float().numpy(), 4, "dx")
    # each rank's parameter gradient is its half's share: their sum is the whole's
    _close((ranks[0]["dscale"] + ranks[1]["dscale"]).numpy(), bn.weight.grad.numpy(), 16,
           "dscale")
    _close((ranks[0]["dbias"] + ranks[1]["dbias"]).numpy(), bn.bias.grad.numpy(), 16, "dbias")
    for key in ("running_mean", "running_var"):
        assert ranks[0]["state"][key].dtype == torch.float32
        torch.testing.assert_close(ranks[0]["state"][key], ranks[1]["state"][key], atol=0,
                                   rtol=0)
        _close(ranks[0]["state"][key].numpy(), getattr(bn, key).numpy(), 4, key)
