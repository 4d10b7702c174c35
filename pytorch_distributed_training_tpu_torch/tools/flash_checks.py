"""The arithmetic of the f32 flash forward on the tensor cores, repeated in
plain PyTorch, and the wrong kernel the f32 limits must reject.

``flash_fwd_3xtf32_kernel`` (``csrc/flash_attention.cu``) takes every f32
product in 3xTF32: each operand x is split into ``big = tf32(x)`` and
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
  products: 3 as the kernel does, 1 as a kernel that ran plain TF32 would.

``chip_smoke.py`` (phases 6 and 9) holds the 1-term forward as a wrong
kernel that its f32 limits must reject at every f32 shape, and prints the
3-term one, read only; ``tests/test_torch_flash_f32.py`` holds both on the
CPU.  The products of TF32 values are exact in f32, so the emulation gives
the same result whether a matmul runs in f32 or in TF32.
"""
from __future__ import annotations

import torch

from ..ops import flash_attention as fa

__all__ = ["FFMA_FLOPS", "TF32X3_FLOPS", "flash_fwd_emulated", "split_3xtf32", "tf32_round"]

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


def flash_fwd_emulated(q, k, v, causal: bool, scale: float, terms: int = 3):
    """``(o, lse)`` of f32 ``q, k, v [BH, S, D]`` as
    :func:`..ops.flash_attention.flash_fwd_plain` computes them, chunked the
    same way, with ``(q * scale) K^T`` and ``P V`` each taken in ``terms``
    (3 or 1) TF32 products."""
    if q.dtype != torch.float32 or any(t.dtype != torch.float32 for t in (k, v)):
        raise TypeError("flash_fwd_emulated takes float32 q, k, v")
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
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
