"""Model zoo of the port (``get_model`` mirrors the JAX package's).

Ported so far: ``TransformerLM``.  The ResNets (ROADMAP port item P3) and
the ViTs (P8) raise ``NotImplementedError`` naming their item.
"""
from __future__ import annotations

import torch

from .from_jax import lm_state_dict_from_jax
from .transformer_lm import TransformerLM

__all__ = ["TransformerLM", "get_model", "lm_state_dict_from_jax"]

_NOT_YET = {
    "resnet": "the ResNet family is ROADMAP port item P3 (ResNet DP training)",
    "vit": "the ViT family is ROADMAP port item P8 (ResNet/ViT serving)",
}


def get_model(model_name: str, num_classes: int, dtype=torch.float32, **kwargs):
    """Build a model by zoo name, case-insensitive.  For ``TransformerLM``
    ``num_classes`` is the vocabulary size (``dataset.n_classes``) and the
    ``model:`` config keys arrive as ``kwargs``."""
    key = model_name.lower()
    if key == "transformerlm":
        return TransformerLM(vocab_size=num_classes, dtype=dtype, **kwargs)
    for prefix, why in _NOT_YET.items():
        if key.startswith(prefix):
            raise NotImplementedError(f"model {model_name!r}: {why}")
    raise KeyError(f"unknown model {model_name!r} (the port has: ['TransformerLM'])")
