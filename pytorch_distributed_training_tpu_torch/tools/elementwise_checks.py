"""The limits that hold K3 (add+LayerNorm) and K4 (bias+GELU) to their plain
twins on the card, and the wrong kernels those limits must reject.

``chip_smoke.py`` (phase 3) and ``tools/elementwise_ab.py`` read each
kernel's ``y`` against the twin's through :data:`TOL` and
:data:`NORM_LIMIT`; ``s`` must be bitwise equal.  The wrong kernels are
built here from the twin, on the same inputs, as the output a kernel with
that fault would give (an unwritten element reads 0), and
``tests/test_torch_elementwise_variants.py`` holds on the CPU that each lies
outside the limits in the dtypes :data:`REJECT_IN` names, while
:func:`add_layernorm_lane_order`, the twin summing its statistics in the
warp kernel's order, lies inside them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import fused_elementwise as fe

__all__ = [
    "NORM_LIMIT",
    "REJECT_IN",
    "ROWS_PER_BLOCK",
    "TOL",
    "VECTOR",
    "add_layernorm_lane_order",
    "add_layernorm_variants",
    "bias_gelu_variants",
]

# Elementwise |kernel - twin| <= atol + rtol |twin| on y, phase 3's limits
# since the kernels were first ported: f32 summation order only; bf16 rtol
# 1e-2 lets a sum taken in another order round to the neighbouring bf16
# value (one ulp is 2^-8 = 3.9e-3 relative).
TOL = {"float32": dict(atol=1e-5, rtol=0.0), "bfloat16": dict(atol=2e-2, rtol=1e-2)}
# ||kernel - twin|| / ||twin|| on y.  f32: another summation order moves the
# statistics by ~1e-7 relative (the lane-order twin reads 7e-8), and rsqrtf
# and erff differ from torch's by ~2 ulp (2.4e-7): 1e-6 is four times
# that, and 100 times below the mildest wrong kernel required to fail in
# f32 (the variance over E - 1 at E = 4096, 1.2e-4).  bf16: such f32
# differences flip a rounding in few elements (the lane-order twin reads
# 1.7e-5 at [256, 4096]); 1e-3 is 50 times that, and 40 times below the
# mildest wrong kernel required to fail in bf16 (one unwritten 8-vector of a
# 4096-wide row, 4.4e-2).
NORM_LIMIT = {"float32": 1e-6, "bfloat16": 1e-3}
VECTOR = 8  # elements one vector access of the kernels moves
ROWS_PER_BLOCK = 8  # the most rows (warps) a block of the K3 warp kernel owns

# each wrong kernel -> the dtypes in which the limits must reject it
REJECT_IN = {
    "K3 last 8 features of each row unwritten": ("bfloat16", "float32"),
    "K3 rows past the last full block of 8 warps unwritten": ("float32",),
    "K3 variance over E - 1": ("float32",),
    "K3 scale and bias of the neighbouring 8-vector": ("bfloat16",),
    "K4 tanh-approximate GELU": ("float32",),
    "K4 bias of the neighbouring 8-vector": ("bfloat16",),
    "K4 last 8-vector of each row unwritten": ("bfloat16",),
}


def _neighbour(p: torch.Tensor) -> torch.Tensor:
    """``p`` read one 8-vector further on (the last vector reads the first)."""
    return torch.roll(p, -VECTOR, dims=-1)


def _unwritten_tail(y: torch.Tensor, n: int) -> torch.Tensor:
    y = y.clone()
    y[..., -n:] = 0
    return y


def add_layernorm_variants(x, delta, scale, bias, eps: float = 1e-6, out_dtype=None) -> list:
    """``(what, y)`` of each wrong K3 on these inputs: the rows variant only
    where the rows do not fill whole blocks of :data:`ROWS_PER_BLOCK`."""
    _, y = fe.add_layernorm_plain(x, delta, scale, bias, eps, out_dtype)
    out = [("K3 last 8 features of each row unwritten", _unwritten_tail(y, VECTOR))]
    rows = y.numel() // y.shape[-1]
    full = rows // ROWS_PER_BLOCK * ROWS_PER_BLOCK
    if full < rows:
        short = y.clone().reshape(rows, -1)
        short[full:] = 0
        out.append(("K3 rows past the last full block of 8 warps unwritten",
                    short.reshape(y.shape)))
    e = x.shape[-1]
    s32 = (x.float() + delta.float()).to(x.dtype).float()
    mu = s32.mean(-1, keepdim=True)
    var = torch.clamp((s32 * s32).mean(-1, keepdim=True) - mu * mu, min=0.0) * e / (e - 1)
    y_var = (s32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    out.append(("K3 variance over E - 1", y_var.to(y.dtype)))
    _, y_nb = fe.add_layernorm_plain(x, delta, _neighbour(scale), _neighbour(bias), eps,
                                     out_dtype)
    out.append(("K3 scale and bias of the neighbouring 8-vector", y_nb))
    return out


def bias_gelu_variants(u, bias) -> list:
    """``(what, y)`` of each wrong K4 on these inputs."""
    t = u.float() + bias.float()
    return [
        ("K4 tanh-approximate GELU", F.gelu(t, approximate="tanh").to(u.dtype)),
        ("K4 bias of the neighbouring 8-vector", fe.bias_gelu_plain(u, _neighbour(bias))),
        ("K4 last 8-vector of each row unwritten",
         _unwritten_tail(fe.bias_gelu_plain(u, bias), VECTOR)),
    ]


def add_layernorm_lane_order(x, delta, scale, bias, eps: float = 1e-6, out_dtype=None):
    """The twin of K3 with its statistics summed in the warp kernel's order:
    lane l adds, in turn, the 8 elements of vectors l, l + 32, l + 64, ...;
    then the 32 lane sums meet by ``__shfl_xor_sync`` at offsets 16 ... 1.
    Returns ``(s, y)`` as :func:`fe.add_layernorm_plain` does."""
    if out_dtype is None:
        out_dtype = torch.promote_types(x.dtype, torch.promote_types(scale.dtype, bias.dtype))
    e = x.shape[-1]
    s = (x.float() + delta.float()).to(x.dtype)
    s32 = s.float().reshape(-1, e)
    chunk = 32 * VECTOR
    padded = F.pad(s32, (0, -e % chunk)).reshape(s32.shape[0], -1, 32, VECTOR)
    sums, sumsq = (torch.zeros(s32.shape[0], 32, device=s32.device) for _ in range(2))
    for k in range(padded.shape[1]):
        for j in range(VECTOR):
            v = padded[:, k, :, j]
            sums = sums + v
            sumsq = sumsq + v * v
    lane = torch.arange(32, device=s32.device)
    for offset in (16, 8, 4, 2, 1):
        sums = sums + sums[:, lane ^ offset]
        sumsq = sumsq + sumsq[:, lane ^ offset]
    mu = sums[:, :1] / e
    var = torch.clamp(sumsq[:, :1] / e - mu * mu, min=0.0)
    y = (s32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return s, y.reshape(x.shape).to(out_dtype)
