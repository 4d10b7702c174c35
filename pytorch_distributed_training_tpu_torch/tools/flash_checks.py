"""The arithmetic of the f32 flash kernels on the tensor cores, repeated in
plain PyTorch, and the wrong kernels the f32 limits must reject.

``flash_fwd_3xtf32_kernel``, ``flash_bwd_dkv_3xtf32_kernel`` and
``flash_bwd_dq_3xtf32_kernel`` (``csrc/flash_attention.cu``) take every
f32 product in 3xTF32: each operand x is split into ``big = tf32(x)`` and
``small = tf32(x - big)``, both rounded to nearest with ties away from
zero (``cvt.rna.tf32.f32``), and a product of a and b is
``a_small b_big + a_big b_small + a_big b_big``.  TF32 keeps 10 of f32's
23 mantissa bits, so ``big + small`` is x within 2^-22 |x|, and one TF32
product alone is off by up to about 2^-10 of its size.

- :func:`tf32_round` is ``cvt.rna.tf32.f32`` by bit operations on an f32
  tensor (the kernel rounds with the same two integer operations);
- :func:`split_3xtf32` is the kernel's split;
- :func:`flash_fwd_emulated` is the forward of
  :func:`..ops.flash_attention.flash_fwd_plain` with each of its two
  products (``(q * scale) K^T`` and ``P V``) taken in ``terms`` TF32
  products: 3 as the kernel does, 1 as a kernel that ran plain TF32 would;
- :func:`flash_bwd_emulated` is dK/dV of
  :func:`..ops.flash_attention.flash_bwd_plain` with each of its four
  products (``q (scale K)^T``, ``dO V^T``, ``P^T dO``, ``dS^T Q``) taken in
  ``terms`` TF32 products, the scale folded into K as the kernel folds it;
- :func:`flash_dq_emulated` is dQ of the same twin with each of its three
  products (``(q * scale) K^T``, ``dO V^T``, ``dS K``) taken in ``terms``
  TF32 products, the scale folded into q as the kernel folds it.

``chip_smoke.py`` (phases 6 and 9) holds the 1-term forward, dK/dV and dQ
as wrong kernels that its f32 limits must reject at every f32 shape, and
prints the 3-term ones, read only; ``tests/test_torch_flash_f32.py``,
``tests/test_torch_flash_dkv_f32.py`` and ``tests/test_torch_flash_dq_f32.py``
hold them on the CPU.  The products of TF32 values are exact in f32, so
the emulation gives the same result whether a matmul runs in f32 or in
TF32.
"""
from __future__ import annotations

import torch

from ..ops import flash_attention as fa

__all__ = ["FFMA_FLOPS", "TF32X3_FLOPS", "flash_bwd_emulated", "flash_dq_emulated",
           "flash_fwd_emulated", "split_3xtf32", "tf32_round"]

# H100 SXM, dense: f32-accurate products as 3 TF32 products on the tensor
# cores (494.7 TFLOP/s TF32), and f32 FMA on the CUDA cores
TF32X3_FLOPS = 494.7e12 / 3
FFMA_FLOPS = 67e12

_TF32_HALF_ULP = 0x1000  # bit 12: half of the last mantissa bit TF32 keeps
_TF32_MASK = -0x2000     # 0xffffe000 as int32: sign, exponent, 10 mantissa bits


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32, to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` does: half a TF32 ulp is added to the magnitude bits
    (an f32 is sign and magnitude, so this rounds away from zero on either
    sign, and a carry moves into the exponent exactly when the value rounds
    up to the next power of two), then the 13 dropped bits are cleared.
    Values that are not finite pass unchanged."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + _TF32_HALF_ULP) & _TF32_MASK).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_3xtf32(x: torch.Tensor):
    """``(big, small)``: ``big = tf32(x)``, ``small = tf32(x - big)``."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def _matmul(a, b, terms: int) -> torch.Tensor:
    """``a @ b`` from split operands ``(big, small)``: 3 TF32 products, the
    small ones first, or 1."""
    if terms == 1:
        return torch.matmul(a[0], b[0])
    return torch.matmul(a[1], b[0]) + torch.matmul(a[0], b[1]) + torch.matmul(a[0], b[0])


def _check_inputs(name: str, terms: int, *ts) -> None:
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{name} takes float32 inputs, got {[t.dtype for t in ts]}")
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")


def flash_fwd_emulated(q, k, v, causal: bool, scale: float, terms: int = 3):
    """``(o, lse)`` of f32 ``q, k, v [BH, S, D]`` as
    :func:`..ops.flash_attention.flash_fwd_plain` computes them, chunked the
    same way, with ``(q * scale) K^T`` and ``P V`` each taken in ``terms``
    (3 or 1) TF32 products."""
    _check_inputs("flash_fwd_emulated", terms, q, k, v)
    bh, s_len, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(bh, s_len, dtype=torch.float32, device=q.device)
    for h in range(0, bh, fa._PLAIN_HEADS):
        hs = slice(h, h + fa._PLAIN_HEADS)
        kt, vc = split_3xtf32(k[hs].transpose(-1, -2)), split_3xtf32(v[hs])
        n_rows = fa._row_chunk(kt[0].shape[0], s_len)
        for r in range(0, s_len, n_rows):
            rs = slice(r, r + n_rows)
            sc = _matmul(split_3xtf32(q[hs, rs] * scale), kt, terms)
            if causal:
                sc = sc.masked_fill(~fa._causal_mask(rs, s_len, q.device), fa.NEG)
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            l = p.sum(-1, keepdim=True)
            o[hs, rs] = _matmul(split_3xtf32(p), vc, terms) / l
            lse[hs, rs] = (m + torch.log(l))[..., 0]
    return o, lse


def flash_bwd_emulated(q, k, v, dout, lse, delta, causal: bool, scale: float, terms: int = 3):
    """``(dk, dv)`` of f32 ``q, k, v, dout [BH, S, D]`` with ``lse`` and
    ``delta`` [BH, S] as :func:`..ops.flash_attention.flash_bwd_plain`
    computes them, chunked the same way, with ``S = q (scale K)^T``,
    ``dP = dO V^T``, ``dV += P^T dO`` and ``dK += dS^T Q`` each taken in
    ``terms`` (3 or 1) TF32 products."""
    _check_inputs("flash_bwd_emulated", terms, q, k, v, dout, lse, delta)
    bh, s_len, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for h in range(0, bh, fa._PLAIN_HEADS):
        hs = slice(h, h + fa._PLAIN_HEADS)
        kt = split_3xtf32(k[hs].transpose(-1, -2) * scale)
        vt = split_3xtf32(v[hs].transpose(-1, -2))
        dk32, dv32 = torch.zeros_like(k[hs]), torch.zeros_like(v[hs])
        n_rows = fa._row_chunk(k[hs].shape[0], s_len)
        for r in range(0, s_len, n_rows):
            rs = slice(r, r + n_rows)
            qc, dc = split_3xtf32(q[hs, rs]), split_3xtf32(dout[hs, rs])
            sc = _matmul(qc, kt, terms)
            if causal:
                sc = sc.masked_fill(~fa._causal_mask(rs, s_len, q.device), fa.NEG)
            p = torch.exp(sc - lse[hs, rs][..., None])
            pt = split_3xtf32(p.transpose(-1, -2))
            dv32 += _matmul(pt, dc, terms)
            ds = p * (_matmul(dc, vt, terms) - delta[hs, rs][..., None]) * scale
            dk32 += _matmul(split_3xtf32(ds.transpose(-1, -2)), qc, terms)
        dk[hs], dv[hs] = dk32, dv32
    return dk, dv


def flash_dq_emulated(q, k, v, dout, lse, delta, causal: bool, scale: float, terms: int = 3):
    """``dq`` of f32 ``q, k, v, dout [BH, S, D]`` with ``lse`` and ``delta``
    [BH, S] as :func:`..ops.flash_attention.flash_bwd_plain` computes it,
    chunked the same way, with ``S = (q * scale) K^T``, ``dP = dO V^T`` and
    ``dQ = dS K`` each taken in ``terms`` (3 or 1) TF32 products."""
    _check_inputs("flash_dq_emulated", terms, q, k, v, dout, lse, delta)
    bh, s_len, _ = q.shape
    dq = torch.empty_like(q)
    for h in range(0, bh, fa._PLAIN_HEADS):
        hs = slice(h, h + fa._PLAIN_HEADS)
        kt, kc = split_3xtf32(k[hs].transpose(-1, -2)), split_3xtf32(k[hs])
        vt = split_3xtf32(v[hs].transpose(-1, -2))
        n_rows = fa._row_chunk(k[hs].shape[0], s_len)
        for r in range(0, s_len, n_rows):
            rs = slice(r, r + n_rows)
            sc = _matmul(split_3xtf32(q[hs, rs] * scale), kt, terms)
            if causal:
                sc = sc.masked_fill(~fa._causal_mask(rs, s_len, q.device), fa.NEG)
            p = torch.exp(sc - lse[hs, rs][..., None])
            dp = _matmul(split_3xtf32(dout[hs, rs]), vt, terms)
            ds = p * (dp - delta[hs, rs][..., None]) * scale
            dq[hs, rs] = _matmul(split_3xtf32(ds), kc, terms)
    return dq
