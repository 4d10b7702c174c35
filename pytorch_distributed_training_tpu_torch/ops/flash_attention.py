"""Flash attention, forward and backward, each written by hand for Hopper.

Port of ``pytorch_distributed_training_tpu/ops/flash_attention.py``:

- :func:`flash_forward`: ``o, lse`` of ``q, k, v [BH, S, D]`` by online
  softmax over K/V tiles, f32 accumulation, ``o`` in the input dtype and
  ``lse`` [BH, S] f32.  One kernel replaces both TPU forwards: the resident
  ``_fwd_kernel`` (``flash_attention.py:178``, launched at ``:651``) and the
  streamed ``_fwd_stream_kernel`` (``:407``, launched at ``:615``).  On the
  TPU the two differ in what VMEM holds; here K/V always stream through
  shared memory one tile at a time.  In bf16 (``flash_fwd_bf16_kernel``) a
  block owns 128 query rows, two consumer warpgroups of 64, and a producer
  warp streams 128-row K and V tiles by TMA through a 2-stage ring of
  ``mbarrier``s; S = Q K^T is a ``wgmma`` from shared memory and O += P V a
  ``wgmma`` with bf16 P from registers and V read MN-major, untransposed.
  In f32 (``flash_fwd_3xtf32_kernel``) a block of 4 warps owns 64 query
  rows and streams K/V tiles through a 2-stage ``cp.async`` ring; both
  products are ``mma.sync`` m16n8k8 in 3xTF32 on fragments each lane loads
  from the row-major tiles, P straight from S's accumulator registers.
- :func:`flash_backward`: ``dq, dk, dv`` recomputing ``p = exp(s - lse)``
  with ``delta = rowsum(dO * O)`` given, as two deterministic launches: a
  dK/dV kernel over K tiles (:func:`flash_backward_dkv`) and a dQ kernel over
  Q tiles (:func:`flash_backward_dq`), ``csrc/flash_attention.cu`` says why.
  That is the TPU's split backward (``_dkv_kernel`` ``:348`` / ``_dq_kernel``
  ``:233``, streamed ``_dkv_stream_kernel`` ``:506`` / ``_dq_stream_kernel``
  ``:460``), and the pair stands in for the fused ``_dqkv_kernel``
  (``:278``) where the JAX package fuses.  Its launch count goes up by 2 a
  call.  In bf16 the dK/dV launch (``flash_bwd_dkv_bf16_kernel``) is built
  as the forward is: a block owns 128 keys and streams 64-row Q and dO
  tiles with their lse and delta rows by TMA; S^T and dP^T are ``wgmma``
  from shared memory, dV += P^T dO and dK += dS^T Q take P^T and dS^T from
  registers and read dO and Q MN-major from their one staged copy.  The
  bf16 dQ launch (``flash_bwd_dq_bf16_kernel``) has the forward's shape: a
  block owns 128 query rows with their dO, and streams 64-row K and V
  tiles by TMA; S and dP are ``wgmma`` from shared memory and dQ += dS K
  takes dS from registers and reads K MN-major, untransposed.  In f32 the
  dK/dV launch (``flash_bwd_dkv_3xtf32_kernel``) is built as the f32
  forward: a block of 4 warps owns 64 keys (K and V split once into TF32
  planes in shared memory) and streams 32-row Q and dO tiles with their
  lse and delta rows through a 2-stage ``cp.async`` ring; all four
  products are ``mma.sync`` m16n8k8 in 3xTF32, P^T and dS^T straight from
  the accumulator registers of S^T and dP^T, and each tile's dV and dK
  products start from zero before they are added in f32.  The f32 dQ
  launch (``flash_bwd_dq_3xtf32_kernel``) is the f32 forward's loop with
  one more product: a block of 4 warps owns 64 query rows (``q * scale``
  and dO split once into TF32 planes) and streams 32-row K and V tiles;
  S, dP and dQ += dS K are ``mma.sync`` in 3xTF32, dS straight from the
  accumulator registers, each tile's dS K summed apart.
- :func:`flash_attention_lse`: ``(o, lse)`` of ``[B, S, H, D]`` inputs with
  heads folded into the batch (``:878-921``), a ``torch.autograd.Function``
  whose forward and backward are the wrappers above, exact for cotangents
  on both outputs: an lse cotangent shifts the backward's delta,
  ``delta = rowsum(dO * O) - g_lse`` (``:757-764``), and the kernels are
  unchanged.  ``out_f32`` (its default, what ring attention calls) takes
  f32 dots on any input dtype and keeps o in f32: bf16 inputs are upcast
  once a call and run the 3xTF32 kernels, and dq, dk, dv are rounded to
  the input dtype once, at the end (a kernel that widens bf16 tiles in
  shared memory would spare the copies).  :func:`flash_attention` is its
  core with ``out_f32=False`` (``:853-875``): o in the input dtype, bf16
  dots on bf16 inputs.  :func:`flash_lse_plain` is the entry point's plain
  twin, forward and backward.

Numerics follow the JAX kernels: bf16 inputs go into the tensor cores as
bf16 with f32 accumulation, the scale multiplies ``s`` after the dot, and
``p`` and ``ds`` are rounded to bf16 before the products they feed; f32
inputs keep f32 accuracy throughout, with ``q * scale`` before the forward
dot and ``p`` in f32 into ``P V``.  The f32 forward
(``flash_fwd_3xtf32_kernel``), dK/dV (``flash_bwd_dkv_3xtf32_kernel``) and
dQ (``flash_bwd_dq_3xtf32_kernel``) run on the tensor cores in 3xTF32 with
``mma.sync`` (each operand split into a TF32 part and a TF32 remainder,
three TF32 products a step: ``tools/flash_checks.py`` repeats that
arithmetic).
Masked scores are ``-1e30``, not ``-inf`` (``:48-50``): every causal row
keeps at least one valid column, so no NaN can form.  The einsum path of
:mod:`.attention` keeps its own ``-inf``.

Launches are counted twice: by the port's wrapper (:func:`launch_counts`,
``flash_fwd`` / ``flash_bwd``) and by the TPU kernel each launch stands for
(:func:`tpu_launch_counts`), as :func:`tpu_kernels` reads the JAX
package's dispatch for that shape and dtype.

On CUDA tensors the wrappers launch the kernels or raise; on CPU tensors
they compute the plain twins (:func:`flash_fwd_plain`,
:func:`flash_bwd_plain`), which repeat the kernels' roundings on score
matrices chunked over heads and query rows.  Shapes are checked on both,
so what runs on the CPU also launches on the card: bf16 or f32, ``S >= 128``
and ``S % 128 == 0`` (:func:`flash_shapes_ok`, the JAX package's gate), and
``D`` in ``SUPPORTED_HEAD_DIMS``; any other head dim raises rather than
leaving the kernels.  The kernels are bound by operations:
:func:`flash_flops` counts the products over the pairs the causal mask
keeps (2 products in the forward, 4 in dK/dV, 3 in dQ).  Each bf16 kernel
block owns a 128-row tile, so their C entry points take ``S % 128 == 0``
(the gate above) and return ``cudaErrorInvalidValue`` unlaunched on
any other S; ``csrc/flash_attention.cu`` holds the full design notes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import kernels

__all__ = [
    "KERNELS",
    "SUPPORTED_HEAD_DIMS",
    "TPU_KERNELS",
    "flash_attention",
    "flash_attention_lse",
    "flash_backward",
    "flash_backward_dkv",
    "flash_backward_dq",
    "flash_bwd_plain",
    "flash_bytes",
    "flash_flops",
    "flash_forward",
    "flash_fwd_plain",
    "flash_lse_plain",
    "flash_shapes_ok",
    "launch_counts",
    "reset_launch_counts",
    "tpu_kernels",
    "tpu_launch_counts",
]

NEG = -1e30  # finite mask value (flash_attention.py:68)
SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the plain twins hold [heads, rows, S] f32 scores at a time: at most
# _PLAIN_HEADS folded heads and _PLAIN_SCORES scores (256 MB) a chunk, so the
# checks on the card stay within a few GB at S = 32768
_PLAIN_HEADS = 16
_PLAIN_SCORES = 1 << 26
# the JAX package's VMEM budget for its resident kernels (flash_attention.py:108)
_VMEM_BYTES = 8 * 1024 * 1024
# the TPU kernels of the JAX package's flash_attention.py, by the names of
# the kernel table (ROADMAP queue 2)
TPU_KERNELS = ("K2a", "K2b", "K2c", "K2d", "K2e", "K2f", "K2g")
_tpu_launches = dict.fromkeys(TPU_KERNELS, 0)


def flash_shapes_ok(s_len: int) -> bool:
    """The dispatch gate of the JAX package (``:145-149``): S >= 128 and
    S % 128 == 0.  The head dim is no part of it: a head dim outside
    ``SUPPORTED_HEAD_DIMS`` raises in the wrappers."""
    return s_len >= 128 and s_len % 128 == 0


def tpu_kernels(s_len: int, d: int, dtype, bf16_dots: Optional[bool] = None) -> dict:
    """The TPU kernels the JAX package's ``flash_attention_lse`` launches
    for folded inputs ``[BH, S, D]`` all of ``dtype``: ``{"forward": ...,
    "dq": ..., "dkv": ...}``.  The gates' shape rules, without their
    environment overrides:

    - ``_resident_ok`` (``:114-120``): K/V resident while 2 S D 4 <= 8 MiB
      (K2a, and a resident backward), streamed beyond (K2b, K2f + K2g);
    - ``bf16_dots`` (``:910-914``): whether the kernels take bf16 dots,
      which JAX does for all-bf16 inputs with o in their dtype
      (``out_f32=False``); ``None`` reads the dtype alone, which is what
      :func:`flash_attention` runs, and an ``out_f32`` call passes False;
    - ``_fused_bwd_ok`` as on the TPU (``interpret=False``, ``:123-142``):
      bf16 dots and 2 S D (itemsize + 4) <= 8 MiB fuse the backward (K2c);
      otherwise it is split (K2d + K2e).
    """
    if 2 * s_len * d * 4 > _VMEM_BYTES:
        return {"forward": "K2b", "dq": "K2f", "dkv": "K2g"}
    if bf16_dots is None:
        bf16_dots = dtype == torch.bfloat16
    itemsize = torch.empty((), dtype=dtype).element_size()
    if bf16_dots and 2 * s_len * d * (itemsize + 4) <= _VMEM_BYTES:
        return {"forward": "K2a", "dq": "K2c", "dkv": "K2c"}
    return {"forward": "K2a", "dq": "K2d", "dkv": "K2e"}


def _row_chunk(heads: int, s_len: int) -> int:
    return max(1, min(s_len, _PLAIN_SCORES // (heads * s_len)))


def _causal_mask(rows: slice, s_len: int, device) -> torch.Tensor:
    """``[rows, S]``: True where key <= query."""
    r = torch.arange(rows.start, min(rows.stop, s_len), device=device)
    return torch.arange(s_len, device=device)[None, :] <= r[:, None]


def flash_fwd_plain(q, k, v, causal: bool, scale: float):
    """The plain twin of :func:`flash_forward`: ``(o, lse)``."""
    bf16 = q.dtype == torch.bfloat16
    bh, s_len, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(bh, s_len, dtype=torch.float32, device=q.device)
    for h in range(0, bh, _PLAIN_HEADS):
        hs = slice(h, h + _PLAIN_HEADS)
        kc, vc = k[hs].float(), v[hs].float()
        n_rows = _row_chunk(kc.shape[0], s_len)
        for r in range(0, s_len, n_rows):
            rs = slice(r, r + n_rows)
            qc = q[hs, rs].float()
            if bf16:
                sc = torch.matmul(qc, kc.transpose(-1, -2)) * scale
            else:
                sc = torch.matmul(qc * scale, kc.transpose(-1, -2))
            if causal:
                sc = sc.masked_fill(~_causal_mask(rs, s_len, q.device), NEG)
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            l = p.sum(-1, keepdim=True)
            pv = p.to(torch.bfloat16).float() if bf16 else p
            o[hs, rs] = (torch.matmul(pv, vc) / l).to(q.dtype)
            lse[hs, rs] = (m + torch.log(l))[..., 0]
    return o, lse


def flash_bwd_plain(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """The plain twin of :func:`flash_backward`: ``(dq, dk, dv)``.  dK and
    dV accumulate in f32 over the row chunks and are rounded once."""
    bf16 = q.dtype == torch.bfloat16
    bh, s_len, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def rnd(x):
        return x.to(torch.bfloat16).float() if bf16 else x

    for h in range(0, bh, _PLAIN_HEADS):
        hs = slice(h, h + _PLAIN_HEADS)
        kc, vc = k[hs].float(), v[hs].float()
        dk32, dv32 = torch.zeros_like(kc), torch.zeros_like(vc)
        n_rows = _row_chunk(kc.shape[0], s_len)
        for r in range(0, s_len, n_rows):
            rs = slice(r, r + n_rows)
            qc, dc = q[hs, rs].float(), dout[hs, rs].float()
            sc = scale * torch.matmul(qc, kc.transpose(-1, -2))
            if causal:
                sc = sc.masked_fill(~_causal_mask(rs, s_len, q.device), NEG)
            p = torch.exp(sc - lse[hs, rs][..., None])
            dv32 += torch.matmul(rnd(p).transpose(-1, -2), dc)
            dp = torch.matmul(dc, vc.transpose(-1, -2))
            ds = rnd(p * (dp - delta[hs, rs][..., None]) * scale)
            dk32 += torch.matmul(ds.transpose(-1, -2), qc)
            dq[hs, rs] = torch.matmul(ds, kc).to(q.dtype)
        dk[hs], dv[hs] = dk32.to(k.dtype), dv32.to(v.dtype)
    return dq, dk, dv


def _pairs(s_len: int, causal: bool) -> int:
    return s_len * (s_len + 1) // 2 if causal else s_len * s_len


# products over the (query, key) pairs: forward QK^T, PV; fused backward
# QK^T, dO V^T, P^T dO, dS^T Q, dS K; the split backward's dQ launch
# QK^T, dO V^T, dS K and its dK/dV launch QK^T, dO V^T, P^T dO, dS^T Q
_PRODUCTS = {"forward": 2, "backward": 5, "dq": 3, "dkv": 4}


def flash_flops(bh: int, s_len: int, d: int, causal: bool, backward: bool = False,
                part: Optional[str] = None) -> int:
    """Multiply-adds x 2 of the products over the (query, key) pairs the
    mask keeps: the forward's or the whole backward's, or with ``part``
    ("dq" or "dkv") one launch of the backward's."""
    products = _PRODUCTS[part or ("backward" if backward else "forward")]
    return products * 2 * d * bh * _pairs(s_len, causal)


def flash_bytes(bh: int, s_len: int, d: int, dtype, backward: bool = False,
                part: Optional[str] = None) -> int:
    """Least traffic: the forward reads q, k, v and writes o and lse; a
    backward launch reads q, k, v, dO, lse, delta and writes dq (``part``
    "dq"), dk and dv ("dkv") or all three (the whole backward)."""
    es = torch.empty((), dtype=dtype).element_size()
    mat = bh * s_len * d * es
    row = bh * s_len * 4
    if not (backward or part):
        return 4 * mat + row
    written = {"dq": 1, "dkv": 2, None: 3}[part]
    return (4 + written) * mat + 2 * row


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


def _check_bwd(name: str, q, k, v, dout, lse, delta) -> None:
    _check(name, q, k, v, dout)
    bh, s_len, _ = q.shape
    for what, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (bh, s_len):
            raise ValueError(f"{name}: {what} must be [{bh}, {s_len}] float32")


def _check_cuda(name: str, *ts) -> None:
    kernels.require_contiguous(name, *ts)
    kernels.require_cuda(name, *ts)
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: the kernels take 16-byte aligned tensors")


def _counted(q, part: str) -> None:
    # the kernels take bf16 dots exactly when their inputs are bf16: an
    # out_f32 call reaches them with its inputs upcast (flash_attention_lse)
    _, s_len, d = q.shape
    _tpu_launches[tpu_kernels(s_len, d, q.dtype, q.dtype == torch.bfloat16)[part]] += 1


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
    _counted(q, "forward")
    return o, lse


flash_forward.launches = 0


def flash_backward_dkv(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """``(dk, dv)``: the dK/dV launch of :func:`flash_backward`."""
    name = "flash_backward_dkv"
    _check_bwd(name, q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, dout, lse, delta, causal, scale)[1:]
    _check_cuda(name, q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = kernels.library("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.pdt_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                    dv.data_ptr(), q.shape[0], q.shape[1], q.shape[2],
                                    float(scale), int(causal), _DTYPE_CODES[q.dtype],
                                    kernels.stream(q))
    kernels.check(err, name)
    flash_backward.launches += 1
    _counted(q, "dkv")
    return dk, dv


def flash_backward_dq(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """``dq``: the dQ launch of :func:`flash_backward`."""
    name = "flash_backward_dq"
    _check_bwd(name, q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, dout, lse, delta, causal, scale)[0]
    _check_cuda(name, q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    lib = kernels.library("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.pdt_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                   q.shape[0], q.shape[1], q.shape[2], float(scale),
                                   int(causal), _DTYPE_CODES[q.dtype], kernels.stream(q))
    kernels.check(err, name)
    flash_backward.launches += 1
    _counted(q, "dq")
    return dq


def flash_backward(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """``(dq, dk, dv)``; ``lse`` from the forward and ``delta = rowsum(dO *
    O)``, both [BH, S] f32: the dK/dV launch, then the dQ launch."""
    _check_bwd("flash_backward", q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_backward_dkv(q, k, v, dout, lse, delta, causal, scale)
    dq = flash_backward_dq(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


flash_backward.launches = 0


def _upcast(out_f32: bool, *ts):
    """With ``out_f32``, the inputs in f32: f32 dots on any input dtype
    (JAX ``:910-914``), one copy of each, made once a call."""
    if not out_f32:
        return ts
    return tuple(t if t.dtype == torch.float32 else t.float() for t in ts)


def _delta(do, o, dlse):
    """``rowsum(dO * O) - g_lse`` in f32, one elementwise pass outside the
    kernels as in JAX (``:757-764``): d(lse)/d(s) = p, so an lse cotangent
    shifts delta, ``ds = p * (dp - (delta - g_lse))``."""
    delta = (do.float() * o.float()).sum(-1)
    return delta if dlse is None else delta - dlse.float()


class _FlashAttention(torch.autograd.Function):
    """``(o, lse)`` of folded ``q, k, v``; differentiable for cotangents on
    both outputs.  With ``out_f32`` the kernels run on the inputs upcast to
    f32 and o stays f32; dq, dk and dv are rounded to the inputs' dtype
    once, at the end (JAX's ``_out_struct(q.shape, q.dtype)``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, out_f32):
        ctx.set_materialize_grads(False)
        dtype = q.dtype
        q, k, v = _upcast(out_f32, q, k, v)
        o, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.dtype = causal, scale, dtype
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.to(o.dtype).contiguous()
        delta = _delta(do, o, dlse)
        dq, dk, dv = flash_backward(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dq, dk, dv = (g.to(ctx.dtype) for g in (dq, dk, dv))
        return dq, dk, dv, None, None, None


def _scale(d: int, sm_scale) -> float:
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)


def _fold(x):
    """``[B, S, H, D]`` as the kernels' contiguous ``[BH, S, D]`` (at B = 1
    the reshape of a qkv column is a strided view: copied)."""
    b, s_len, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s_len, d).contiguous()


def _unfold(x, b: int, h: int):
    """``[BH, S, ...]`` back to ``[B, S, H, ...]``."""
    return x.reshape(b, h, *x.shape[1:]).transpose(1, 2)


def flash_attention_lse(q, k, v, causal: bool = False, sm_scale: Optional[float] = None,
                        out_f32: bool = True):
    """``(o [B, S, H, D], lse [B, S, H] f32)`` of ``q, k, v [B, S, H, D]``
    (JAX ``:878-921``): the per-row logsumexp that blockwise and ring
    attention combine partial results with, differentiable for cotangents
    on both outputs.  ``out_f32`` (the default) takes f32 dots on any input
    dtype and returns o in f32, so a cross-block combine does not round
    each partial; with False o is in the input dtype and all-bf16 inputs
    take bf16 dots (what :func:`flash_attention` calls)."""
    b, s_len, h, d = q.shape
    scale = _scale(d, sm_scale)
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        o, lse = _FlashAttention.apply(qf, kf, vf, bool(causal), scale, bool(out_f32))
    else:
        o, lse = flash_forward(*_upcast(out_f32, qf, kf, vf), bool(causal), scale)
    return _unfold(o, b, h), _unfold(lse, b, h)


def flash_attention(q, k, v, causal: bool = False, sm_scale: Optional[float] = None):
    """Flash attention ``q, k, v [B, S, H, D] -> [B, S, H, D]``, scale
    ``1/sqrt(D)`` unless given; differentiable in q, k and v.  The core of
    :func:`flash_attention_lse` with ``out_f32=False`` (JAX ``:853-875``)."""
    return flash_attention_lse(q, k, v, causal, sm_scale, out_f32=False)[0]


def flash_lse_plain(q, k, v, do, dlse, causal: bool, sm_scale: Optional[float] = None,
                    out_f32: bool = True):
    """The plain twin of :func:`flash_attention_lse` forward and backward:
    ``(o, lse, dq, dk, dv)`` of ``q, k, v [B, S, H, D]`` with cotangents
    ``do`` on o and ``dlse`` [B, S, H] on lse (``None``: zero), through
    :func:`flash_fwd_plain` and :func:`flash_bwd_plain` with the same
    upcast, delta fold and final rounding as the kernels' path."""
    b, s_len, h, d = q.shape
    scale = _scale(d, sm_scale)
    qf, kf, vf = _upcast(out_f32, _fold(q), _fold(k), _fold(v))
    o, lse = flash_fwd_plain(qf, kf, vf, causal, scale)
    dof = _fold(do).to(o.dtype)
    dlsef = None if dlse is None else dlse.transpose(1, 2).reshape(b * h, s_len)
    grads = flash_bwd_plain(qf, kf, vf, dof, lse, _delta(dof, o, dlsef), causal, scale)
    return (_unfold(o, b, h), _unfold(lse, b, h), *(_unfold(g.to(q.dtype), b, h) for g in grads))


# every kernel wrapper of this module, by the name its launch count goes by
# (flash_backward's count takes the launches of flash_backward_dkv/_dq)
KERNELS = {"flash_fwd": flash_forward, "flash_bwd": flash_backward}


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def tpu_launch_counts():
    """Launches by the TPU kernel each stands for (:func:`tpu_kernels`): a
    forward counts as K2a or K2b, a dQ launch as K2c, K2d or K2f, a dK/dV
    launch as K2c, K2e or K2g."""
    return dict(_tpu_launches)


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for name in _tpu_launches:
        _tpu_launches[name] = 0
