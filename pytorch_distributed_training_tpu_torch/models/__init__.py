"""Model zoo of the port (``get_model`` mirrors the JAX package's).

The ResNets (18 to 152), the ViTs (Ti/S/B at patch 16) and
``TransformerLM``, by name, case-insensitive.
"""
from __future__ import annotations

import torch

from .from_jax import (
    lm_state_dict_from_jax,
    lm_state_dict_from_jax_pp,
    resnet_state_dict_from_jax,
    vit_state_dict_from_jax,
)
from .resnet import RESNET_CONFIGS, BasicBlock, Bottleneck, ResNet, fold_stem_kernel
from .transformer_lm import TransformerLM
from .vit import VIT_CONFIGS, ViT

__all__ = ["BasicBlock", "Bottleneck", "RESNET_CONFIGS", "ResNet", "TransformerLM",
           "VIT_CONFIGS", "ViT", "fold_stem_kernel", "get_model", "is_resnet",
           "list_models", "lm_state_dict_from_jax", "lm_state_dict_from_jax_pp",
           "resnet_state_dict_from_jax", "vit_state_dict_from_jax"]

_CANONICAL = {name.lower(): name for name in RESNET_CONFIGS}
_CANONICAL.update({name.lower(): name for name in VIT_CONFIGS})
_CANONICAL["transformerlm"] = "TransformerLM"


def list_models():
    return sorted(RESNET_CONFIGS) + sorted(VIT_CONFIGS) + ["TransformerLM"]


def is_resnet(model_name: str) -> bool:
    return _CANONICAL.get(model_name.lower()) in RESNET_CONFIGS


def get_model(model_name: str, num_classes: int, dtype=torch.float32, sync_bn: bool = False,
              group=None, **kwargs):
    """Build a model by zoo name, case-insensitive.  For ``TransformerLM``
    ``num_classes`` is the vocabulary size (``dataset.n_classes``).  The
    ``model:`` config keys arrive as ``kwargs`` and reach the constructor
    as they are, so an unknown key raises ``TypeError``: a ResNet takes
    ``space_to_depth`` and ``bn_stat_dtype``, a ViT ``image_size`` (its
    position table's length).  ``sync_bn`` (over the ranks of ``group``)
    is the JAX ``axis_name``; a ViT accepts and ignores it."""
    key = model_name.lower()
    if key not in _CANONICAL:
        raise KeyError(f"unknown model {model_name!r} (have: {list_models()})")
    name = _CANONICAL[key]
    if name == "TransformerLM":
        return TransformerLM(vocab_size=num_classes, dtype=dtype, **kwargs)
    if name in RESNET_CONFIGS:
        block_cls, stage_sizes = RESNET_CONFIGS[name]
        return ResNet(stage_sizes, block_cls, num_classes, sync_bn=sync_bn, dtype=dtype,
                      group=group, **kwargs)
    patch, embed, depth, heads = VIT_CONFIGS[name]
    return ViT(num_classes, patch_size=patch, embed_dim=embed, depth=depth, num_heads=heads,
               dtype=dtype, sync_bn=sync_bn, group=group, **kwargs)
