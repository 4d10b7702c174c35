"""Model zoo of the port (``get_model`` mirrors the JAX package's).

Ported so far: ``TransformerLM`` and the ResNets (18 to 152).  The ViTs
(ROADMAP port item P8) raise ``NotImplementedError`` naming their item.
"""
from __future__ import annotations

import torch

from .from_jax import lm_state_dict_from_jax, resnet_state_dict_from_jax
from .resnet import RESNET_CONFIGS, BasicBlock, Bottleneck, ResNet, fold_stem_kernel
from .transformer_lm import TransformerLM

__all__ = ["BasicBlock", "Bottleneck", "RESNET_CONFIGS", "ResNet", "TransformerLM",
           "fold_stem_kernel", "get_model", "is_resnet", "lm_state_dict_from_jax",
           "resnet_state_dict_from_jax"]

_RESNETS = {name.lower(): name for name in RESNET_CONFIGS}
_NOT_YET = {
    "vit": "the ViT family is ROADMAP port item P8 (ResNet/ViT serving)",
}


def is_resnet(model_name: str) -> bool:
    return model_name.lower() in _RESNETS


def get_model(model_name: str, num_classes: int, dtype=torch.float32, sync_bn: bool = False,
              group=None, **kwargs):
    """Build a model by zoo name, case-insensitive.  For ``TransformerLM``
    ``num_classes`` is the vocabulary size (``dataset.n_classes``) and the
    ``model:`` config keys arrive as ``kwargs``; a ResNet takes
    ``space_to_depth`` and ``bn_stat_dtype`` there, and ``sync_bn`` (over
    the ranks of ``group``), as the JAX ``axis_name``."""
    key = model_name.lower()
    if key == "transformerlm":
        return TransformerLM(vocab_size=num_classes, dtype=dtype, **kwargs)
    if key in _RESNETS:
        block_cls, stage_sizes = RESNET_CONFIGS[_RESNETS[key]]
        return ResNet(stage_sizes, block_cls, num_classes, sync_bn=sync_bn, dtype=dtype,
                      group=group, **kwargs)
    for prefix, why in _NOT_YET.items():
        if key.startswith(prefix):
            raise NotImplementedError(f"model {model_name!r}: {why}")
    raise KeyError(f"unknown model {model_name!r} (the port has: "
                   f"{sorted(RESNET_CONFIGS) + ['TransformerLM']})")
