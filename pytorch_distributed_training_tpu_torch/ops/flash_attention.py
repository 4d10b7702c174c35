"""Flash attention, forward and backward, each written by hand for Hopper.

Port of ``pytorch_distributed_training_tpu/ops/flash_attention.py``:

- :func:`flash_forward`: ``o, lse`` of ``q, k, v [BH, S, D]`` by online
  softmax over K/V tiles, f32 accumulation, ``o`` in the input dtype and
  ``lse`` [BH, S] f32.  Replaces the TPU kernel ``_fwd_kernel``
  (``flash_attention.py:178``, launched at ``:651``).
- :func:`flash_backward`: ``dq, dk, dv`` recomputing ``p = exp(s - lse)``
  with ``delta = rowsum(dO * O)`` given.  Stands in for the fused backward
  ``_dqkv_kernel`` (``:278``, launched at ``:775``) as two deterministic
  launches, a dK/dV kernel over K tiles and a dQ kernel over Q tiles
  (``csrc/flash_attention.cu`` says why); its launch count goes up by 2 a
  call.
- :func:`flash_attention`: ``[B, S, H, D] -> [B, S, H, D]`` with heads folded
  into the batch (``:895-921``), a ``torch.autograd.Function`` whose
  forward and backward are the two wrappers above.

Numerics follow the JAX kernels: bf16 inputs go into the tensor cores as
bf16 with f32 accumulation, the scale multiplies ``s`` after the dot, and
``p`` and ``ds`` are rounded to bf16 before the products they feed; f32
inputs stay f32 throughout (no TF32) with ``q * scale`` before the forward
dot.  Masked scores are ``-1e30``, not ``-inf`` (``:48-50``): every causal
row keeps at least one valid column, so no NaN can form.  The einsum path
of :mod:`.attention` keeps its own ``-inf``.

On CUDA tensors the wrappers launch the kernels or raise; on CPU tensors
they compute the plain twins (:func:`flash_fwd_plain`,
:func:`flash_bwd_plain`), which repeat the kernels' roundings on whole
score matrices.  Shapes are checked on both, so what runs on the CPU also
launches on the card: bf16 or f32, ``S >= 128`` and ``S % 128 == 0``
(:func:`flash_shapes_ok`, the JAX package's gate), and ``D`` in
``SUPPORTED_HEAD_DIMS``; any other head dim raises rather than leaving the
kernels.  Both kernels are bound by operations: :func:`flash_flops` counts
the products over the pairs the causal mask keeps.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import kernels

__all__ = [
    "KERNELS",
    "SUPPORTED_HEAD_DIMS",
    "flash_attention",
    "flash_backward",
    "flash_bwd_plain",
    "flash_bytes",
    "flash_flops",
    "flash_forward",
    "flash_fwd_plain",
    "flash_shapes_ok",
    "launch_counts",
    "reset_launch_counts",
]

NEG = -1e30  # finite mask value (flash_attention.py:68)
SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the plain twins materialise [chunk, S, S] f32 scores; chunk the folded
# batch so that the full-width check on the card stays within a few GB
_PLAIN_CHUNK = 16


def flash_shapes_ok(s_len: int) -> bool:
    """The dispatch gate of the JAX package (``:145-149``): S >= 128 and
    S % 128 == 0.  The head dim is no part of it: a head dim outside
    ``SUPPORTED_HEAD_DIMS`` raises in the wrappers."""
    return s_len >= 128 and s_len % 128 == 0


def _causal_mask(s_len: int, device) -> torch.Tensor:
    return torch.ones(s_len, s_len, dtype=torch.bool, device=device).tril()


def flash_fwd_plain(q, k, v, causal: bool, scale: float):
    """The plain twin of :func:`flash_forward`: ``(o, lse)``."""
    bf16 = q.dtype == torch.bfloat16
    outs, lses = [], []
    mask = _causal_mask(q.shape[1], q.device) if causal else None
    for i in range(0, q.shape[0], _PLAIN_CHUNK):
        qc, kc, vc = (x[i:i + _PLAIN_CHUNK].float() for x in (q, k, v))
        if bf16:
            s = torch.matmul(qc, kc.transpose(-1, -2)) * scale
        else:
            s = torch.matmul(qc * scale, kc.transpose(-1, -2))
        if causal:
            s = s.masked_fill(~mask, NEG)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        pv = p.to(torch.bfloat16).float() if bf16 else p
        outs.append((torch.matmul(pv, vc) / l).to(q.dtype))
        lses.append((m + torch.log(l))[..., 0])
    return torch.cat(outs), torch.cat(lses)


def flash_bwd_plain(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """The plain twin of :func:`flash_backward`: ``(dq, dk, dv)``."""
    bf16 = q.dtype == torch.bfloat16
    dqs, dks, dvs = [], [], []
    mask = _causal_mask(q.shape[1], q.device) if causal else None

    def rnd(x):
        return x.to(torch.bfloat16).float() if bf16 else x

    for i in range(0, q.shape[0], _PLAIN_CHUNK):
        sl = slice(i, i + _PLAIN_CHUNK)
        qc, kc, vc, dc = (x[sl].float() for x in (q, k, v, dout))
        s = scale * torch.matmul(qc, kc.transpose(-1, -2))
        if causal:
            s = s.masked_fill(~mask, NEG)
        p = torch.exp(s - lse[sl][..., None])
        dvs.append(torch.matmul(rnd(p).transpose(-1, -2), dc).to(v.dtype))
        dp = torch.matmul(dc, vc.transpose(-1, -2))
        ds = rnd(p * (dp - delta[sl][..., None]) * scale)
        dks.append(torch.matmul(ds.transpose(-1, -2), qc).to(k.dtype))
        dqs.append(torch.matmul(ds, kc).to(q.dtype))
    return torch.cat(dqs), torch.cat(dks), torch.cat(dvs)


def _pairs(s_len: int, causal: bool) -> int:
    return s_len * (s_len + 1) // 2 if causal else s_len * s_len


def flash_flops(bh: int, s_len: int, d: int, causal: bool, backward: bool = False) -> int:
    """Multiply-adds x 2 of the products over the (query, key) pairs the
    mask keeps: 2 products forward (QK^T, PV), 5 backward (QK^T, dO V^T,
    P^T dO, dS^T Q, dS K)."""
    return (5 if backward else 2) * 2 * d * bh * _pairs(s_len, causal)


def flash_bytes(bh: int, s_len: int, d: int, dtype, backward: bool = False) -> int:
    """Least traffic: forward reads q, k, v and writes o and lse; backward
    reads q, k, v, dO, lse, delta and writes dq, dk, dv."""
    es = torch.empty((), dtype=dtype).element_size()
    mat = bh * s_len * d * es
    row = bh * s_len * 4
    return 7 * mat + 2 * row if backward else 4 * mat + row


def _check(name: str, *ts) -> None:
    q = ts[0]
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{name}: the kernels take q, k, v (and dO) all float32 or all "
                        f"bfloat16, got {[t.dtype for t in ts]}")
    if q.dim() != 3 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"{name}: q, k, v (and dO) must share one [BH, S, D] shape, "
                         f"got {[tuple(t.shape) for t in ts]}")
    bh, s_len, d = q.shape
    if not flash_shapes_ok(s_len):
        raise ValueError(f"{name}: the kernels take S >= 128 with S % 128 == 0, got S={s_len}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: the kernels take D in {SUPPORTED_HEAD_DIMS}, got D={d}")
    if not 1 <= bh <= 65535:
        raise ValueError(f"{name}: batch x heads {bh} outside [1, 65535]")


def _check_cuda(name: str, *ts) -> None:
    kernels.require_contiguous(name, *ts)
    kernels.require_cuda(name, *ts)
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: the kernels take 16-byte aligned tensors")


def flash_forward(q, k, v, causal: bool, scale: float):
    """``(o, lse)`` of folded ``q, k, v [BH, S, D]``."""
    name = "flash_forward"
    _check(name, q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    _check_cuda(name, q, k, v)
    bh, s_len, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(bh, s_len, dtype=torch.float32, device=q.device)
    lib = kernels.library("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.pdt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                lse.data_ptr(), bh, s_len, d, float(scale), int(causal),
                                _DTYPE_CODES[q.dtype], kernels.stream(q))
    kernels.check(err, name)
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


def flash_backward(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """``(dq, dk, dv)``; ``lse`` from the forward and ``delta = rowsum(dO *
    O)``, both [BH, S] f32."""
    name = "flash_backward"
    _check(name, q, k, v, dout)
    bh, s_len, _ = q.shape
    for what, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (bh, s_len):
            raise ValueError(f"{name}: {what} must be [{bh}, {s_len}] float32")
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, dout, lse, delta, causal, scale)
    _check_cuda(name, q, k, v, dout, lse, delta)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = kernels.library("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.pdt_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                dk.data_ptr(), dv.data_ptr(), bh, s_len, q.shape[2],
                                float(scale), int(causal), _DTYPE_CODES[q.dtype],
                                kernels.stream(q))
    kernels.check(err, name)
    flash_backward.launches += 2  # dK/dV, then dQ
    return dq, dk, dv


flash_backward.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # one f32 elementwise pass outside the kernels, as in JAX (:761-764)
        delta = (do.float() * o.float()).sum(-1)
        dq, dk, dv = flash_backward(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, sm_scale: Optional[float] = None):
    """Flash attention ``q, k, v [B, S, H, D] -> [B, S, H, D]``, scale
    ``1/sqrt(D)`` unless given; differentiable in q, k and v."""
    b, s_len, h, d = q.shape
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, s_len, d)

    qf, kf, vf = fold(q), fold(k), fold(v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        o = _FlashAttention.apply(qf, kf, vf, bool(causal), scale)
    else:
        o = flash_forward(qf, kf, vf, bool(causal), scale)[0]
    return o.reshape(b, h, s_len, d).transpose(1, 2)


# every kernel wrapper of this module, by the name its launch count goes by
KERNELS = {"flash_fwd": flash_forward, "flash_bwd": flash_backward}


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
