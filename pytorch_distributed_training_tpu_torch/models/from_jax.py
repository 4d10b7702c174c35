"""JAX model variables -> the port's ``state_dict``.

:func:`lm_state_dict_from_jax` takes the flax ``params`` tree of the JAX
package's ``TransformerLM`` as nested dicts of numpy float32 arrays (no
JAX needed here) and maps it:

- ``tok_embedding`` and ``pos_embedding`` as they are;
- ``.../{ln1,ln2,ln}/scale`` -> ``weight``, ``bias`` -> ``bias``;
- every ``kernel`` ``[in, out]`` -> a ``weight`` ``[out, in]``, the MoE
  router's (``block{i}/moe/router/kernel``) too;
- a MoE block's stacked experts ``block{i}/moe/{wi,bi,wo,bo}`` as they
  are: the port keeps the JAX layout (``wi [E, d, h]``, ``wo [E, h, d]``),
  which its batched products take without a transpose.

The qkv kernel keeps its column order, heads-major ``(H, 3, hd)``: the
port's attention factors the output the same way, so no permutation is
needed (or correct).  The stacked LoRA factors of a grafted tree
(``.../attn/{qkv,proj}_lora_{a,b}``, present in every block or in none)
map as they are: their einsum layout is the JAX one.

The conversion is strict.  The expected leaves and their shapes follow from
the tree's own dimensions (vocabulary and width from ``tok_embedding``,
depth from the ``block{i}`` count, MLP width from ``block0``'s fc1 or
experts, the expert count from each MoE block's router); a
missing leaf, an extra leaf or a wrong shape raises ``ValueError``.
:func:`lm_state_dict_from_jax_pp` takes the pipeline's layout of the same
tree (JAX ``pp_stack_params``: ``{"blocks": <every block leaf stacked
[depth, ...]>, "shared": <the rest>}``), unstacks it with the port's own
:func:`..parallel.pipeline.pp_unstack` and maps it the same way; with a
``stage_group`` it keeps that stage's blocks and the shared leaves.

:func:`resnet_state_dict_from_jax` does the same for a JAX ``ResNet``'s
``{"params", "batch_stats"}`` into torchvision's names (the inverse of the
JAX package's ``models/torch_port.py``): convs HWIO -> OIHW, the ``fc``
kernel transposed, BatchNorm ``scale``/``bias``/``mean``/``var`` ->
``weight``/``bias``/``running_mean``/``running_var``, ``layer{s}_{b}`` ->
``layer{s}.{b}`` and ``downsample_conv``/``downsample_bn`` ->
``downsample.0``/``.1``.  The expected keys and shapes are those of the
port's ``ResNet`` of the tree's own topology (block type, blocks a stage,
classes, and the space-to-depth stem when ``conv1``'s kernel is 4x4), so
any leaf left over or missing raises ``ValueError``.

:func:`vit_state_dict_from_jax` maps a JAX ``ViT``'s ``params``: the
patch conv's kernel HWIO -> OIHW, every Dense kernel ``[in, out]`` ->
``[out, in]``, ``scale`` -> ``weight``, ``cls_token``/``pos_embedding``
as they are; the flat flax names (``block{i}/attn/qkv``, ...) are the
port's module names (``block{i}.attn.qkv``).  The qkv kernel keeps its
heads-major column order, as for the LM.  The expected keys and shapes
are those of the port's ``ViT`` of the tree's own topology (width, patch,
depth, MLP width, classes and position-table length), so a leaf left
over, missing or of another shape raises ``ValueError``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..parallel.pipeline import pp_unstack, stage_state_dict
from ..parallel.tensor import shard_state_dict

__all__ = ["lm_state_dict_from_jax", "lm_state_dict_from_jax_pp", "resnet_state_dict_from_jax",
           "vit_state_dict_from_jax"]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = np.asarray(val, dtype=np.float32)
    return out


def _expected_shapes(leaves: Dict[str, np.ndarray]) -> Dict[str, tuple]:
    for name in ("tok_embedding", "pos_embedding"):
        if name not in leaves:
            raise ValueError(f"JAX params: missing leaf {name!r}")
    vocab, dim = leaves["tok_embedding"].shape
    max_len = leaves["pos_embedding"].shape[0]
    # the MLP width from block0's fc1, or its experts' wi when every block routes
    if "block0/mlp/fc1/kernel" in leaves:
        hidden = leaves["block0/mlp/fc1/kernel"].shape[1]
    elif "block0/moe/wi" in leaves:
        hidden = leaves["block0/moe/wi"].shape[2]
    else:
        raise ValueError("JAX params: missing leaf 'block0/mlp/fc1/kernel'")
    depth = len({p.split("/")[0] for p in leaves if p.startswith("block")})
    shapes = {
        "tok_embedding": (vocab, dim),
        "pos_embedding": (max_len, dim),
        "ln/scale": (dim,), "ln/bias": (dim,),
        "head/kernel": (dim, vocab), "head/bias": (vocab,),
    }
    for i in range(depth):
        b = f"block{i}"
        for ln in ("ln1", "ln2"):
            shapes[f"{b}/{ln}/scale"] = (dim,)
            shapes[f"{b}/{ln}/bias"] = (dim,)
        router = leaves.get(f"{b}/moe/router/kernel")
        if router is not None:
            experts = router.shape[-1]
            dense = (("attn/qkv", dim, 3 * dim), ("attn/proj", dim, dim),
                     ("moe/router", dim, experts))
            shapes.update({f"{b}/moe/wi": (experts, dim, hidden), f"{b}/moe/bi": (experts, hidden),
                           f"{b}/moe/wo": (experts, hidden, dim), f"{b}/moe/bo": (experts, dim)})
        else:
            dense = (("attn/qkv", dim, 3 * dim), ("attn/proj", dim, dim),
                     ("mlp/fc1", dim, hidden), ("mlp/fc2", hidden, dim))
        for name, fan_in, fan_out in dense:
            shapes[f"{b}/{name}/kernel"] = (fan_in, fan_out)
            shapes[f"{b}/{name}/bias"] = (fan_out,)
    lora = leaves.get("block0/attn/qkv_lora_a")
    if lora is not None and lora.ndim == 3:
        n, _, r = lora.shape
        for i in range(depth):
            for name, out in (("qkv", 3 * dim), ("proj", dim)):
                shapes[f"block{i}/attn/{name}_lora_a"] = (n, dim, r)
                shapes[f"block{i}/attn/{name}_lora_b"] = (n, r, out)
    return shapes


def lm_state_dict_from_jax(params: Mapping, tensor_group=None) -> Dict[str, torch.Tensor]:
    """The port's ``TransformerLM`` state_dict for a JAX ``params`` tree;
    with ``tensor_group`` this rank's slices of it (the rule of
    :func:`..parallel.tensor.param_role`), for a tensor-parallel model."""
    leaves = _flatten(params)
    shapes = _expected_shapes(leaves)
    missing = sorted(set(shapes) - set(leaves))
    extra = sorted(set(leaves) - set(shapes))
    if missing or extra:
        raise ValueError(f"JAX params: missing leaves {missing}, extra leaves {extra}")
    state = {}
    for path, arr in leaves.items():
        if arr.shape != shapes[path]:
            raise ValueError(
                f"JAX params: {path} has shape {arr.shape}, expected {shapes[path]}"
            )
        *mod, leaf = path.split("/")
        if leaf == "kernel":
            arr, leaf = arr.T, "weight"
        elif leaf == "scale":
            leaf = "weight"
        state[".".join(mod + [leaf])] = torch.tensor(np.ascontiguousarray(arr))
    return shard_state_dict(state, tensor_group)


def lm_state_dict_from_jax_pp(pp_params: Mapping, stage_group=None) -> Dict[str, torch.Tensor]:
    """The port's ``TransformerLM`` state_dict for the JAX pipeline layout
    ``{"blocks": <stacked [depth, ...]>, "shared": ...}`` (numpy leaves);
    with ``stage_group`` (a :class:`..parallel.tensor.TensorGroup` of the
    stages) that stage's part of it."""
    stacked = {path: torch.tensor(arr) for path, arr in _flatten(pp_params["blocks"]).items()}
    tree: Dict = {}
    for path, arr in {**_flatten(pp_params["shared"]),
                      **pp_unstack({"blocks": stacked, "shared": {}})}.items():
        # pp_unstack names a block's leaves "block{i}.<flax path>"
        node = tree
        *mods, leaf = path.replace(".", "/", 1).split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.asarray(arr)
    state = lm_state_dict_from_jax(tree)
    if stage_group is None:
        return state
    depth = next(iter(stacked.values())).shape[0]
    return stage_state_dict(state, depth, stage_group.size, stage_group.rank)


def _resnet_key(path: str) -> str:
    """torchvision's key for a ``collection/module.../leaf`` path."""
    collection, *mods, leaf = path.split("/")
    names = []
    for m in mods:
        if m.startswith("layer") and "_" in m:
            names.append(m.replace("_", "."))
        elif m in ("downsample_conv", "downsample_bn"):
            names.append("downsample." + ("0" if m == "downsample_conv" else "1"))
        else:
            names.append(m)
    if collection == "batch_stats":
        leaf = {"mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
    elif collection == "params":
        leaf = {"scale": "weight", "kernel": "weight"}.get(leaf, leaf)
    else:
        raise ValueError(f"JAX variables: unknown collection in {path!r}")
    return ".".join(names + [leaf])


def resnet_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``ResNet`` state_dict for JAX ``{"params", "batch_stats"}``."""
    from .resnet import BasicBlock, Bottleneck, ResNet

    params = variables["params"]
    leaves = _flatten(variables)
    stages: Dict[int, int] = {}
    for name in params:
        if name.startswith("layer") and "_" in name:
            stage, block = (int(v) for v in name[len("layer"):].split("_"))
            stages[stage] = max(stages.get(stage, 0), block + 1)
    if "params/fc/kernel" not in leaves:
        raise ValueError("JAX variables: missing leaf 'params/fc/kernel'")
    block_cls = Bottleneck if "conv3" in params.get("layer1_0", {}) else BasicBlock
    # a [4, 4, 12, 64] stem is the space-to-depth one (JAX resnet.py:233-238)
    stem = leaves.get("params/conv1/kernel")
    s2d = stem is not None and tuple(stem.shape[:2]) == (4, 4)
    with torch.device("meta"):
        template = ResNet([stages[s] for s in sorted(stages)], block_cls,
                          leaves["params/fc/kernel"].shape[1], space_to_depth=s2d)
    shapes = {k: tuple(v.shape) for k, v in template.state_dict().items()}
    state = {}
    for path, arr in leaves.items():
        key = _resnet_key(path)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif path.endswith("fc/kernel"):
            arr = arr.T
        if key in shapes and arr.shape != shapes[key]:
            raise ValueError(f"JAX variables: {path} maps to {key} of shape {arr.shape}, "
                             f"expected {shapes[key]}")
        state[key] = torch.tensor(np.ascontiguousarray(arr))
    missing = sorted(set(shapes) - set(state))
    extra = sorted(set(state) - set(shapes))
    if missing or extra:
        raise ValueError(f"JAX variables: missing {missing}, left over {extra}")
    return state


def vit_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``ViT`` state_dict for a JAX ``ViT`` ``params`` tree."""
    from .vit import ViT

    leaves = _flatten(params)
    for name in ("patch_embed/kernel", "pos_embedding", "block0/mlp/fc1/kernel",
                 "head/kernel"):
        if name not in leaves:
            raise ValueError(f"JAX params: missing leaf {name!r}")
    patch, _, _, dim = leaves["patch_embed/kernel"].shape
    grid = int(round((leaves["pos_embedding"].shape[1] - 1) ** 0.5))
    hidden = leaves["block0/mlp/fc1/kernel"].shape[1]
    depth = len({p.split("/")[0] for p in leaves if p.startswith("block")})
    with torch.device("meta"):
        # the heads do not change a shape: any divisor of the width will do
        template = ViT(leaves["head/kernel"].shape[1], patch_size=patch, embed_dim=dim,
                       depth=depth, num_heads=1, mlp_ratio=hidden / dim,
                       image_size=grid * patch)
    shapes = {k: tuple(v.shape) for k, v in template.state_dict().items()}
    state = {}
    for path, arr in leaves.items():
        *mod, leaf = path.split("/")
        if leaf == "kernel":
            arr, leaf = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T), "weight"
        elif leaf == "scale":
            leaf = "weight"
        key = ".".join(mod + [leaf])
        if key in shapes and arr.shape != shapes[key]:
            raise ValueError(f"JAX params: {path} maps to {key} of shape {arr.shape}, "
                             f"expected {shapes[key]}")
        state[key] = torch.tensor(np.ascontiguousarray(arr))
    missing = sorted(set(shapes) - set(state))
    extra = sorted(set(state) - set(shapes))
    if missing or extra:
        raise ValueError(f"JAX params: missing {missing}, left over {extra}")
    return state
