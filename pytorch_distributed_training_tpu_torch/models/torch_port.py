"""torchvision and torch-twin checkpoints -> the port's ``state_dict``
(port of ``models/torch_port.py``).

``model.pretrained`` (JAX ``engine/runner.py:536-610``) starts a run from
a torch ``state_dict``: the reference's zoo is torchvision-weight
compatible (its ``TORCH_HOME`` cache).  The JAX package converts these
layouts into flax variables; the port's modules already keep torch's
layouts, so each function here maps names straight into a ``state_dict``
for the port's model:

- :func:`import_torch_resnet_state_dict`: torchvision's ResNet names are
  the port's own (convs OIHW, ``fc`` ``[out, in]``, BatchNorm
  ``weight``/``bias``/``running_mean``/``running_var``); torchvision's
  ``num_batches_tracked`` counters are read past, and a 7x7 ``conv1``
  into the space-to-depth stem is folded (:func:`.resnet.fold_stem_weight`);
- :func:`import_torch_vit_state_dict`: torchvision's ``VisionTransformer``
  (``conv_proj``, ``class_token``, ``encoder.pos_embedding``,
  ``encoder.layers.encoder_layer_{i}`` with ``ln_1``, ``self_attention``
  ``.in_proj_*``/``.out_proj``, ``ln_2``, ``mlp.{0,3}``, ``encoder.ln``,
  ``heads.head``); the packed ``in_proj`` rows ``[q; k; v]`` are permuted
  to the heads-major ``(H, 3, hd)`` order of the port's qkv Dense;
- :func:`import_torch_lm_state_dict`: the decoder twin of the JAX
  package's ``tests/test_torch_port_lm.py`` (``tok_emb.weight``,
  ``pos_emb``, ``blocks.{i}.{ln1,attn_qkv,attn_proj,ln2,fc1,fc2}``,
  ``ln_f``, ``head``), whose qkv is already heads-major.

Each takes the port model's own ``state_dict`` as the template of names,
shapes and dtypes, and is strict both ways with the JAX package's error
texts: a template entry the checkpoint lacks raises ``KeyError``
("missing"), a checkpoint tensor left unconsumed raises ``KeyError`` ("not
consumed"), a shape that differs raises ``ValueError`` ("shape
mismatch").  numpy arrays are taken as well as tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["import_torch_lm_state_dict", "import_torch_resnet_state_dict",
           "import_torch_vit_state_dict", "vit_qkv_perm"]


def _tensor(t) -> torch.Tensor:
    return t.detach().cpu() if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))


def _convert(template: Mapping[str, torch.Tensor], state_dict: Mapping,
             source: Callable[[str], Tuple[str, Callable]], skip=lambda key: False):
    """Fill every entry of ``template`` from ``state_dict``: ``source(name)``
    gives the torch key and the transform of its tensor."""
    consumed, out = set(), {}
    for name, leaf in template.items():
        key, transform = source(name)
        if key not in state_dict:
            raise KeyError(f"torch state_dict missing '{key}' (for the port's {name})")
        arr = transform(_tensor(state_dict[key]), tuple(leaf.shape))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: torch {tuple(arr.shape)} vs port "
                             f"{tuple(leaf.shape)} at {name}")
        out[name] = arr.to(leaf.dtype).contiguous()
        consumed.add(key)
    leftovers = sorted(k for k in state_dict if k not in consumed and not skip(k))
    if leftovers:
        raise KeyError(f"torch state_dict keys not consumed: {leftovers[:8]}")
    return out


def _same(arr, shape):
    return arr


def _stem(arr, shape):
    """A 7x7 stem into the packed space-to-depth one: fold it."""
    if tuple(arr.shape[2:]) == (7, 7) and tuple(shape[2:]) == (4, 4):
        from .resnet import fold_stem_weight

        return fold_stem_weight(arr)
    return arr


def import_torch_resnet_state_dict(template: Mapping[str, torch.Tensor],
                                   state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet ``state_dict`` (18 to 152) as the port's
    ``ResNet`` ``state_dict`` of ``template``'s names, parameters and
    running statistics alike."""
    return _convert(template, state_dict,
                    lambda name: (name, _stem if name == "conv1.weight" else _same),
                    skip=lambda key: key.endswith("num_batches_tracked"))


def vit_qkv_perm(embed_dim: int, num_heads: int) -> torch.Tensor:
    """Row permutation torchvision ``in_proj`` -> the heads-major qkv Dense:
    ``ours[o] = torch[perm[o]]``, with torch row ``which * D + h * hd + d``
    and ours ``h * 3 hd + which * hd + d`` (JAX ``torch_port.py:241-258``)."""
    hd = embed_dim // num_heads
    return torch.arange(3 * embed_dim).view(3, num_heads, hd).transpose(0, 1).reshape(-1)


def _vit_source(num_heads: int):
    perms: Dict[int, torch.Tensor] = {}

    def qkv(arr, shape):
        dim = shape[-1] if len(shape) == 2 else shape[0] // 3
        perm = perms.setdefault(dim, vit_qkv_perm(dim, num_heads))
        if arr.shape[0] != 3 * dim:
            raise ValueError(f"shape mismatch for in_proj: torch {tuple(arr.shape)} vs port "
                             f"{tuple(shape)}")
        return arr[perm]

    def source(name: str):
        if name in ("cls_token", "pos_embedding"):
            return {"cls_token": "class_token",
                    "pos_embedding": "encoder.pos_embedding"}[name], _same
        mod, leaf = name.rsplit(".", 1)
        if mod == "patch_embed":
            return f"conv_proj.{leaf}", _same
        if mod in ("ln", "head"):
            return {"ln": "encoder.ln", "head": "heads.head"}[mod] + f".{leaf}", _same
        if mod.startswith("block"):
            block, sub = mod.split(".", 1)
            pre = f"encoder.layers.encoder_layer_{block[len('block'):]}"
            if sub == "attn.qkv":
                return f"{pre}.self_attention.in_proj_{leaf}", qkv
            torch_sub = {"ln1": "ln_1", "ln2": "ln_2", "attn.proj": "self_attention.out_proj",
                         "mlp.fc1": "mlp.0", "mlp.fc2": "mlp.3"}.get(sub)
            if torch_sub is not None:
                return f"{pre}.{torch_sub}.{leaf}", _same
        raise KeyError(f"unmapped port entry {name}")

    return source


def import_torch_vit_state_dict(template: Mapping[str, torch.Tensor], state_dict: Mapping,
                                num_heads: int) -> Dict[str, torch.Tensor]:
    """A torchvision ``VisionTransformer`` ``state_dict`` (the ``vit_b_16``
    family's layout) as the port's ``ViT`` ``state_dict`` of ``template``,
    taken in the flax model's order (the patch conv first), so a dict of
    another family fails on ``conv_proj`` as in the JAX package."""
    first = ("patch_embed.weight", "patch_embed.bias")
    ordered = {k: template[k] for k in first if k in template}
    ordered.update((k, v) for k, v in template.items() if k not in ordered)
    return _convert(ordered, state_dict, _vit_source(int(num_heads)))


def _lm_source(name: str):
    if name == "tok_embedding":
        return "tok_emb.weight", _same
    if name == "pos_embedding":
        return "pos_emb", _same
    mod, leaf = name.rsplit(".", 1)
    if mod == "ln":
        return f"ln_f.{leaf}", _same
    if mod == "head":
        return f"head.{leaf}", _same
    if mod.startswith("block"):
        block, sub = mod.split(".", 1)
        torch_sub = {"ln1": "ln1", "ln2": "ln2", "attn.qkv": "attn_qkv", "attn.proj": "attn_proj",
                     "mlp.fc1": "fc1", "mlp.fc2": "fc2"}.get(sub)
        if torch_sub is not None:
            return f"blocks.{block[len('block'):]}.{torch_sub}.{leaf}", _same
    raise KeyError(f"unmapped port entry {name}")


def import_torch_lm_state_dict(template: Mapping[str, torch.Tensor],
                               state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A torch decoder-LM ``state_dict`` (the twin naming above) as the
    port's ``TransformerLM`` ``state_dict`` of ``template``."""
    return _convert(template, state_dict, _lm_source)
