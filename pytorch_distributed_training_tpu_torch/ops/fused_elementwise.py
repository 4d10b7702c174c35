"""The transformer block's elementwise tails, each one hand-written kernel.

Port of ``pytorch_distributed_training_tpu/ops/fused_elementwise.py``:

- :func:`fused_add_layernorm`: ``s = x + delta; y = LN(s)``, emitting both
  the new residual stream ``s`` and its normalisation ``y`` in one pass.
  Replaces the TPU kernel ``_add_ln_kernel`` (``ops/fused_elementwise.py:88``,
  launched at ``:107``).
- :func:`fused_bias_gelu`: ``y = gelu(u + bias)`` with exact-erf GELU, for
  the MLP's first projection.  Replaces ``_bias_gelu_kernel`` (``:203``,
  launched at ``:214``).

On a CUDA tensor each wrapper checks its inputs, launches its kernel
(``csrc/fused_elementwise.cu``) on the current stream, adds one to its
``launches`` count, and raises on anything the kernel does not take; it
never falls back to the plain version.  On a CPU tensor it computes the
plain PyTorch twin (:func:`add_layernorm_plain`, :func:`bias_gelu_plain`),
which repeats the kernel's arithmetic op for op.

Both kernels are bound by memory traffic, at the H100's 3.35 TB/s:
:func:`add_layernorm_bytes` and :func:`bias_gelu_bytes` count each input
read once and each output written once.  Both move 16-byte vectors where
the feature width is a multiple of 8 and every pointer is 16-byte aligned,
and scalars otherwise (a ragged width, or a view that starts mid-vector);
the source says how (``csrc/fused_elementwise.cu``).  The wrappers keep
their host cost low for the decode loop, which calls each one 496 times a
batch: the C entry points are resolved once, the device guard is entered
only for a tensor off the current device, and the stream is read raw.

Numerics follow the JAX module: LayerNorm statistics in f32 over the sum
ROUNDED to the stream dtype, fast variance ``max(0, E[s^2] - E[s]^2)``,
``eps`` (1e-6, flax's default) inside the rsqrt; GELU in f32 over
``f32(u) + f32(bias)`` with the bias already in the compute dtype.

Gradients: each wrapper is a ``torch.autograd.Function`` whenever a
gradient is wanted, on the CPU as on the card, so the CPU tests exercise
the backward the card runs.  The JAX package has no backward kernel for
either: its ``custom_vjp`` backward is plain XLA (``:136-161``,
``:233-239``), and here it is plain torch (:func:`add_layernorm_backward`,
:func:`bias_gelu_backward`).  Without a gradient the wrappers are called
directly (serving's path: the same launches, no autograd bookkeeping).
"""
from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from ..parallel.tensor import copy_to_model
from .layers import Dense

__all__ = [
    "FusedDenseGelu",
    "FusedResidualLayerNorm",
    "KERNELS",
    "MAX_FEATURES",
    "add_layernorm_backward",
    "add_layernorm_bytes",
    "add_layernorm_plain",
    "bias_gelu_backward",
    "bias_gelu_bytes",
    "bias_gelu_plain",
    "fused_add_layernorm",
    "fused_bias_gelu",
    "launch_counts",
    "reset_launch_counts",
]

_INV_SQRT2 = 0.7071067811865476
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# a row is held in registers: one warp x 32 values up to 1024 features,
# 256 threads x 32 above that
MAX_FEATURES = 8192


_INV_SQRT_2PI = 0.3989422804014327


def _check_dtype(name: str, t: torch.Tensor) -> None:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"{name}: the kernel takes float32, bfloat16 or float16, got {t.dtype}"
        )


def _wants_grad(*tensors: torch.Tensor) -> bool:
    if torch.is_grad_enabled():
        for t in tensors:
            if t.requires_grad:
                return True
    return False


# the two C entry points by name, each resolved once (decode calls each
# wrapper 496 times a batch: the host cost of a call is its Python)
_ENTRIES = {}


def _launch(fn: str, t: torch.Tensor, *args) -> int:
    """Call C entry point ``fn`` with ``args`` and the raw current stream of
    ``t``'s card, under a device guard only when that card is not current."""
    entry = _ENTRIES.get(fn)
    if entry is None:
        entry = _ENTRIES[fn] = getattr(kernels.library("fused_elementwise"), fn)
    index = t.get_device()
    if index == torch._C._cuda_getDevice():
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))


# ---------------------------------------------------------------------------
# residual-add + LayerNorm


def add_layernorm_plain(x, delta, scale, bias, eps: float = 1e-6, out_dtype=None):
    """The plain twin of :func:`fused_add_layernorm`, op for op."""
    if out_dtype is None:
        out_dtype = torch.promote_types(x.dtype, torch.promote_types(scale.dtype, bias.dtype))
    s = (x.float() + delta.float()).to(x.dtype)
    s32 = s.float()
    mu = s32.mean(-1, keepdim=True)
    var = torch.clamp((s32 * s32).mean(-1, keepdim=True) - mu * mu, min=0.0)
    xhat = (s32 - mu) * torch.rsqrt(var + eps)
    y = xhat * scale.float() + bias.float()
    return s, y.to(out_dtype)


def add_layernorm_bytes(rows: int, features: int, dtype, out_dtype) -> int:
    """Least device-memory traffic: read x, delta, scale, bias once; write
    s and y once."""
    es = torch.empty((), dtype=dtype).element_size()
    eo = torch.empty((), dtype=out_dtype).element_size()
    return rows * features * (3 * es + eo) + 2 * features * 4


def add_layernorm_backward(s, scale, ds_up, dy, eps: float = 1e-6):
    """The JAX ``custom_vjp`` backward (``fused_elementwise.py:136-161``) in
    plain torch: f32 statistics recomputed from the saved ``s``; returns
    ``(ds, dscale, dbias)``, ``ds`` (the gradient of both ``x`` and
    ``delta``) in ``s``'s dtype, ``dscale``/``dbias`` in ``scale``'s."""
    s32 = s.float()
    mu = s32.mean(-1, keepdim=True)
    var = torch.clamp((s32 * s32).mean(-1, keepdim=True) - mu * mu, min=0.0)
    r = torch.rsqrt(var + eps)
    xhat = (s32 - mu) * r
    dy32 = dy.float() if dy is not None else torch.zeros_like(s32)
    lead = tuple(range(s.dim() - 1))
    dscale = (dy32 * xhat).sum(lead)
    dbias = dy32.sum(lead)
    dxhat = dy32 * scale.float()
    ds = r * (dxhat - dxhat.mean(-1, keepdim=True)
              - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    if ds_up is not None:
        ds = ds_up.float() + ds
    return ds.to(s.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


class _AddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, scale, bias, eps, out_dtype):
        s, y = _add_layernorm(x, delta, scale, bias, eps, out_dtype)
        ctx.save_for_backward(s, scale)
        ctx.eps = eps
        return s, y

    @staticmethod
    def backward(ctx, ds_up, dy):
        s, scale = ctx.saved_tensors
        ds, dscale, dbias = add_layernorm_backward(s, scale, ds_up, dy, ctx.eps)
        return ds, ds, dscale, dbias, None, None


def fused_add_layernorm(x, delta, scale, bias, eps: float = 1e-6, out_dtype=None):
    """``s = x + delta; y = layernorm(s) * scale + bias`` in one kernel.

    ``x``, ``delta``: [..., E] of one dtype (float32, bfloat16 or float16),
    E <= 8192; ``scale``, ``bias``: [E] float32.  Returns ``(s, y)``: ``s``
    in the input dtype, ``y`` in ``out_dtype`` (default: the promotion of
    the inputs and parameters, as in the JAX function; the modules pass
    their compute dtype, one rounding either way).  Differentiable in all
    four inputs.
    """
    if out_dtype is None:
        out_dtype = torch.promote_types(x.dtype, torch.promote_types(scale.dtype, bias.dtype))
    if _wants_grad(x, delta, scale, bias):
        return _AddLayerNorm.apply(x, delta, scale, bias, eps, out_dtype)
    return _add_layernorm(x, delta, scale, bias, eps, out_dtype)


_COUNT_LOCK = threading.Lock()


def _add_layernorm(x, delta, scale, bias, eps, out_dtype):
    """The kernel's wrapper: plain twin on the CPU, launch or raise on CUDA."""
    if x.is_cpu:
        return add_layernorm_plain(x, delta, scale, bias, eps, out_dtype)
    name = "fused_add_layernorm"
    _check_dtype(name, x)
    if delta.dtype != x.dtype or delta.shape != x.shape:
        raise ValueError(
            f"{name}: x and delta must share shape and dtype, got "
            f"{tuple(x.shape)} {x.dtype} and {tuple(delta.shape)} {delta.dtype}"
        )
    feat = x.shape[-1]
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"{name}: scale and bias must be float32")
    if scale.shape != (feat,) or bias.shape != (feat,):
        raise ValueError(f"{name}: scale and bias must have shape ({feat},)")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"{name}: out_dtype must be {x.dtype} or float32, got {out_dtype}")
    if not 1 <= feat <= MAX_FEATURES:
        raise ValueError(f"{name}: feature width {feat} outside [1, {MAX_FEATURES}]")
    kernels.require_contiguous(name, x, delta, scale, bias)
    kernels.require_cuda(name, x, delta, scale, bias)
    s = torch.empty_like(x)
    y = torch.empty_like(x, dtype=out_dtype)
    rows = x.numel() // feat
    if rows == 0:
        return s, y
    err = _launch(
        "pdt_add_layernorm", x, x.data_ptr(), delta.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), s.data_ptr(), y.data_ptr(), rows, feat, float(eps),
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
    )
    kernels.check(err, name)
    with _COUNT_LOCK:  # replicas launch from several threads
        fused_add_layernorm.launches += 1
    return s, y


fused_add_layernorm.launches = 0


# ---------------------------------------------------------------------------
# bias-add + exact-erf GELU


def bias_gelu_plain(u, bias):
    """The plain twin of :func:`fused_bias_gelu`, op for op."""
    t = u.float() + bias.float()
    return (0.5 * t * (1.0 + torch.erf(t * _INV_SQRT2))).to(u.dtype)


def bias_gelu_bytes(rows: int, features: int, dtype) -> int:
    """Least device-memory traffic: read u and bias once, write y once."""
    es = torch.empty((), dtype=dtype).element_size()
    return 2 * rows * features * es + features * es


def bias_gelu_backward(u, bias, dy):
    """The JAX ``custom_vjp`` backward (``fused_elementwise.py:233-239``) in
    plain torch: ``du = dy * (cdf + t * pdf)`` at ``t = u + bias`` in f32;
    returns ``(du, dbias)`` in ``u``'s and ``bias``'s dtypes."""
    t = u.float() + bias.float()
    cdf = 0.5 * (1.0 + torch.erf(t * _INV_SQRT2))
    pdf = torch.exp(-0.5 * t * t) * _INV_SQRT_2PI
    du = dy.float() * (cdf + t * pdf)
    return du.to(u.dtype), du.sum(tuple(range(u.dim() - 1))).to(bias.dtype)


class _BiasGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, bias):
        ctx.save_for_backward(u, bias)
        return _bias_gelu(u, bias)

    @staticmethod
    def backward(ctx, dy):
        u, bias = ctx.saved_tensors
        return bias_gelu_backward(u, bias, dy)


def fused_bias_gelu(u, bias):
    """``gelu(u + bias, approximate=False)`` in one kernel.

    ``u``: [..., H] pre-bias matmul output; ``bias``: [H] in ``u``'s dtype
    (the module rounds it to the compute dtype first).  Output keeps
    ``u``'s dtype.  Differentiable in both inputs.
    """
    if _wants_grad(u, bias):
        return _BiasGelu.apply(u, bias)
    return _bias_gelu(u, bias)


def _bias_gelu(u, bias):
    """The kernel's wrapper: plain twin on the CPU, launch or raise on CUDA."""
    if u.is_cpu:
        return bias_gelu_plain(u, bias)
    name = "fused_bias_gelu"
    _check_dtype(name, u)
    feat = u.shape[-1]
    if bias.dtype != u.dtype or bias.shape != (feat,):
        raise ValueError(
            f"{name}: bias must be [{feat}] in {u.dtype}, got "
            f"{tuple(bias.shape)} {bias.dtype}"
        )
    if feat < 1:
        raise ValueError(f"{name}: empty feature axis")
    kernels.require_contiguous(name, u, bias)
    kernels.require_cuda(name, u, bias)
    y = torch.empty_like(u)
    rows = u.numel() // feat
    if rows == 0:
        return y
    err = _launch(
        "pdt_bias_gelu", u, u.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, feat,
        _DTYPE_CODES[u.dtype],
    )
    kernels.check(err, name)
    with _COUNT_LOCK:  # replicas launch from several threads
        fused_bias_gelu.launches += 1
    return y


fused_bias_gelu.launches = 0


# every kernel wrapper of this module, by the name its launch count goes by
KERNELS = {"add_layernorm": fused_add_layernorm, "bias_gelu": fused_bias_gelu}


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# modules with the JAX modules' parameters


class FusedResidualLayerNorm(nn.Module):
    """``x + delta`` followed by a LayerNorm, as one kernel.

    Same parameters as the LayerNorm it replaces (``weight`` = flax
    ``scale``, ones; ``bias``, zeros; float32, shape [E]).  Returns
    ``(s, y)``: the new residual stream and its normalisation in
    ``dtype``.
    """

    def __init__(self, features: int, dtype=torch.float32, eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x, delta):
        return fused_add_layernorm(
            x, delta, self.weight, self.bias, self.eps, out_dtype=self.dtype
        )


class FusedDenseGelu(Dense):
    """A Dense layer followed by exact-erf GELU; the bias add and GELU are
    one kernel.

    Same parameters as the Dense it replaces (``weight`` [out, in], the
    flax ``kernel`` transposed; ``bias`` [out]).  The matmul is a plain
    torch product in ``dtype``; the bias is rounded to ``dtype`` before the
    kernel adds it, as the JAX module does.  With a ``tensor_group`` it is
    fc1's column form (``split="column"``): the input passes *copy*, and the
    kernel runs on this rank's ``[rows, out / T]`` columns with its slice of
    the bias.
    """

    def forward(self, x):
        d = self.dtype
        x = copy_to_model(x, self.tensor_group)
        u = F.linear(x.to(d), self.weight.to(d))
        return fused_bias_gelu(u, self.bias.to(d))
