"""Multi-LoRA adapter registry: many tenants, one base model, one batch.

Port of the JAX package's ``serving/lora.py``.  Finetunes of one base
model that differ by low-rank deltas (LoRA, Hu et al. 2021) share one
engine: the registry stacks every adapter's factors beside each attention
Dense (``[N, din, r]`` / ``[N, r, dout]``,
:class:`..ops.attention.MultiHeadAttention`) and each batch row picks its
adapter by id (:func:`..ops.lora.lora_delta`), so requests of different
tenants decode in the same iteration.

Adapters are synthesised from their config seed, as in the JAX package:
both factors ``normal * 0.02``, leaf by leaf, from a ``torch.Generator``
seeded with the 32 bits that ``numpy.random.SeedSequence([seed, crc])``
gives for the adapter's seed (its low 32 bits) and ``zlib.crc32`` of the
leaf's flax path (``block0/attn/qkv_lora_a``): the CPU generator keeps
only 32 bits of a seed, so the two are mixed rather than packed.  The
numbers cannot equal the JAX package's, which draws from
``fold_in(PRNGKey(seed), crc)``; a test that needs the same factors on
both sides carries the JAX tree across (:mod:`..models.from_jax`).
Restoring real adapter checkpoints waits until such files exist.

:meth:`LoraRegistry.merged_params` is the oracle's other half: adapter
``k`` folded into the base weights (``W + A_k B_k``, in f32 on the f32
master weights), a plain ``state_dict`` that a base engine serves.
"""
from __future__ import annotations

import zlib
from typing import Dict, List

import numpy as np
import torch

__all__ = ["LoraRegistry"]

_LORA_SUFFIXES = ("_lora_a", "_lora_b")


class LoraRegistry:
    """A fixed adapter set (name -> id) and its graft onto a model.

    ``adapters`` entries are dicts ``{name, seed?}`` or bare names (seed:
    the entry's index).  The set is fixed at engine build: the stacked
    factors' shapes depend on it.
    """

    def __init__(self, rank: int, adapters):
        if int(rank) < 1:
            raise ValueError(f"serving.lora.rank must be >= 1, got {rank}")
        entries = list(adapters or [])
        if not entries:
            raise ValueError("serving.lora.adapters must list at least one adapter")
        self.rank = int(rank)
        self.names: List[str] = []
        self.seeds: List[int] = []
        for i, ent in enumerate(entries):
            if isinstance(ent, str):
                name, seed = ent, i
            else:
                e = dict(ent)
                name = e.pop("name", None)
                if name is None:
                    raise ValueError(f"serving.lora.adapters[{i}] needs a name")
                seed = int(e.pop("seed", i))
                if e:
                    raise ValueError(
                        f"unknown serving.lora.adapters keys for {name!r}: {sorted(e)}")
            name = str(name)
            if name in self.names:
                raise ValueError(f"duplicate adapter name {name!r}")
            self.names.append(name)
            self.seeds.append(seed)
        self._ids = {n: i for i, n in enumerate(self.names)}

    def __len__(self) -> int:
        return len(self.names)

    def id_of(self, name: str) -> int:
        """Adapter id (the row of its stacked factors)."""
        if name not in self._ids:
            raise ValueError(f"unknown adapter {name!r}; registered: {self.names}")
        return self._ids[name]

    # ------------------------------------------------------------------ #

    def graft(self, model):
        """``model`` (a :class:`..models.transformer_lm.TransformerLM`)
        cloned with this registry's LoRA factors: the base parameters are
        ``model``'s own tensors (not copied), the factors synthesised."""
        with torch.device("meta"):
            lora_model = model.clone(lora_rank=self.rank, lora_adapters=len(self))
        base = model.state_dict()
        state = {}
        for name, leaf in lora_model.state_dict().items():
            if name.endswith(_LORA_SUFFIXES):
                state[name] = self._factor(name, tuple(leaf.shape)).to(
                    model.tok_embedding.device)
                continue
            have = base.get(name)
            if have is None or tuple(have.shape) != tuple(leaf.shape):
                raise ValueError(f"LoRA graft: the base model has no {name!r} of shape "
                                 f"{tuple(leaf.shape)}")
            state[name] = have
        lora_model.load_state_dict(state, strict=True, assign=True)
        return lora_model.train(model.training)

    def _factor(self, name: str, shape) -> torch.Tensor:
        """One stacked ``[N, ...]`` factor: row ``k`` is adapter ``k``'s,
        drawn from (its seed, the leaf's path)."""
        tag = zlib.crc32(name.replace(".", "/").encode()) & 0x7FFFFFFF
        rows = []
        for seed in self.seeds:
            mixed = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, tag]).generate_state(1)[0]
            g = torch.Generator().manual_seed(int(mixed))
            rows.append(torch.randn(shape[1:], generator=g) * 0.02)
        return torch.stack(rows)

    # ------------------------------------------------------------------ #

    def merged_params(self, state: Dict[str, torch.Tensor], name: str) -> Dict[str, torch.Tensor]:
        """Adapter ``name`` folded into the base weights of a grafted
        ``state_dict``: a plain ``state_dict`` (no factors) with ``W += (A_k
        B_k)^T`` (the port's weights are ``[out, in]``) in f32, rounded
        once to the weight's dtype."""
        k = self.id_of(name)
        out = {n: t for n, t in state.items() if not n.endswith(_LORA_SUFFIXES)}
        for n in state:
            if not n.endswith("_lora_a"):
                continue
            stem = n[: -len("_lora_a")]
            a = state[n][k].float()
            b = state[stem + "_lora_b"][k].float()
            w = out[stem + ".weight"]
            out[stem + ".weight"] = (w.float() + (a @ b).T).to(w.dtype)
        return out
