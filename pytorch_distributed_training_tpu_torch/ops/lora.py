"""Batched multi-adapter LoRA delta (port of the JAX package's ``ops/lora.py``).

The adapters of a projection are stacked, ``A [N, din, r]`` and ``B [N,
r, dout]``, and each batch row carries its adapter id, so rows of many
adapters share one call:

    delta[b] = (x[b] @ A[ids[b]]) @ B[ids[b]]

Id ``-1`` is the base model: the gather clamps to row 0 and the delta is
zeroed.  The two products run in f32 whatever ``x``'s dtype, and the
caller casts the delta to its Dense's dtype, as the JAX module does.
Plain torch, as the JAX function is plain jnp.
"""
from __future__ import annotations

import torch

__all__ = ["lora_delta"]


def lora_delta(x, a_stack, b_stack, adapter_ids):
    """Per-row low-rank delta ``[B, S, dout]`` in f32.

    ``x`` [B, S, din]; ``a_stack`` [N, din, r]; ``b_stack`` [N, r, dout];
    ``adapter_ids`` [B] integer (-1: no adapter, a zero delta).
    """
    if a_stack.ndim != 3 or b_stack.ndim != 3:
        raise ValueError(f"stacked LoRA factors must be [N, din, r]/[N, r, dout], got "
                         f"{tuple(a_stack.shape)}/{tuple(b_stack.shape)}")
    safe = adapter_ids.clamp(min=0)
    a = a_stack[safe].float()  # [B, din, r]
    b = b_stack[safe].float()  # [B, r, dout]
    xr = torch.einsum("bsd,bdr->bsr", x.float(), a)
    delta = torch.einsum("bsr,bro->bso", xr, b)
    return torch.where((adapter_ids >= 0)[:, None, None], delta, 0.0)
