"""Per-channel symmetric int8 weights for the decode path.

Port of the JAX package's ``ops/quant.py``.  Decode is memory-bound: each
single-token step reads every weight once for little arithmetic, so the
int8 copy (one byte a weight and one f32 scale per output channel) is what
the decode calls read; prefill and speculative verification keep the
plain weights.

Scope: every 2-D Dense ``weight`` of a ``state_dict`` (qkv, proj, fc1,
fc2 and the head).  Embeddings, biases, LayerNorm parameters and the
stacked LoRA factors (3-D) pass through.

The port's Dense weight is ``[out, in]``, the flax kernel ``[in, out]``
transposed, so the per-output-channel scale is taken over ``dim=1`` (the
JAX ``amax`` is over axis 0): ``s_j = max_i |W_ji| / 127`` (``1/127`` for
an all-zero row), ``q = round(W / s)`` clipped to [-127, 127], rounding
half to even as ``jnp.round`` does.  So ``q`` and ``s`` are the JAX
package's transposed, bit for bit, when both start from the same f32
weights.  Quantize the f32 master weights, before
:meth:`..models.transformer_lm.TransformerLM.cast_matmul_weights_` rounds
them to the compute dtype.

A quantized entry is ``{"q": int8 [out, in], "s": f32 [out, 1]}``;
:func:`dequantize_tree` rebuilds ``q * s`` in f32 and rounds it once to
each Dense's compute dtype, one ``torch.mul`` launch a weight, as the JAX
decode programs do (``dequantize_tree(params, f32)``, then the Dense's
own cast).
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

__all__ = ["dequantize_tree", "is_quantized_leaf", "quantize_leaf", "quantize_tree"]

_QKEYS = frozenset(("q", "s"))


def _should_quantize(name: str, leaf) -> bool:
    return (name.endswith(".weight") and isinstance(leaf, torch.Tensor) and leaf.ndim == 2
            and leaf.is_floating_point())


def quantize_leaf(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One ``[out, in]`` weight -> ``{"q": int8, "s": f32 [out, 1]}``."""
    w = w.detach().float()
    amax = w.abs().amax(dim=1, keepdim=True)
    # an all-zero channel's q is 0 whatever the scale: avoid the 0/0
    s = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def is_quantized_leaf(node) -> bool:
    return isinstance(node, Mapping) and set(node) == _QKEYS


def quantize_tree(state: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """Quantize every 2-D Dense ``weight`` of ``state``; every other entry
    passes through by reference."""
    return {name: quantize_leaf(leaf) if _should_quantize(name, leaf) else leaf
            for name, leaf in state.items()}


def dequantize_tree(qstate: Mapping[str, object],
                    dtypes: Mapping[str, torch.dtype]) -> Dict[str, torch.Tensor]:
    """The quantized entries of ``qstate`` as plain weights, each in
    ``dtypes[name]``: ``q * s`` in f32, rounded once (one launch each).
    The entries that were not quantized are left out."""
    out = {}
    for name, node in qstate.items():
        if is_quantized_leaf(node):
            q = node["q"]
            out[name] = torch.mul(q, node["s"],
                                  out=torch.empty(q.shape, dtype=dtypes[name], device=q.device))
    return out
