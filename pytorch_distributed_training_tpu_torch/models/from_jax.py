"""JAX TransformerLM parameters -> the port's ``state_dict``.

Takes the flax ``params`` tree of the JAX package's ``TransformerLM`` as
nested dicts of numpy float32 arrays (no JAX needed here) and maps it:

- ``tok_embedding`` and ``pos_embedding`` as they are;
- ``.../{ln1,ln2,ln}/scale`` -> ``weight``, ``bias`` -> ``bias``;
- every ``kernel`` ``[in, out]`` -> a ``weight`` ``[out, in]``.

The qkv kernel keeps its column order, heads-major ``(H, 3, hd)``: the
port's attention factors the output the same way, so no permutation is
needed (or correct).

The conversion is strict.  The expected leaves and their shapes follow from
the tree's own dimensions (vocabulary and width from ``tok_embedding``,
depth from the ``block{i}`` count, MLP width from ``block0``'s fc1); a
missing leaf, an extra leaf or a wrong shape raises ``ValueError``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["lm_state_dict_from_jax"]


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
    for name in ("tok_embedding", "pos_embedding", "block0/mlp/fc1/kernel"):
        if name not in leaves:
            raise ValueError(f"JAX params: missing leaf {name!r}")
    vocab, dim = leaves["tok_embedding"].shape
    max_len = leaves["pos_embedding"].shape[0]
    hidden = leaves["block0/mlp/fc1/kernel"].shape[1]
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
        for name, fan_in, fan_out in (
            ("attn/qkv", dim, 3 * dim), ("attn/proj", dim, dim),
            ("mlp/fc1", dim, hidden), ("mlp/fc2", hidden, dim),
        ):
            shapes[f"{b}/{name}/kernel"] = (fan_in, fan_out)
            shapes[f"{b}/{name}/bias"] = (fan_out,)
    return shapes


def lm_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``TransformerLM`` state_dict for a JAX ``params`` tree."""
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
    return state
