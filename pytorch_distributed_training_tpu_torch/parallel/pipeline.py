"""The pipeline's layout of the LM's leaves over the stages.

Port of ``pytorch_distributed_training_tpu/parallel/pipeline.py:98-178``.
The JAX package stacks the decoder blocks' leaves into one leading
``[depth]`` axis and shards it over the mesh's ``stage`` axis, so stage
``s`` of ``S`` holds blocks ``[s L/S, (s + 1) L/S)``; the embeddings, the
final LayerNorm and the head (the *shared* leaves) are replicated on every
stage.  The port keeps per-layer modules under their global names
(``block{i}.<leaf>``), so ``from_jax`` and checkpoints keep their keys; a
stage's model holds only its own blocks (:class:`..models.TransformerLM`
with ``pipeline_stage``).  What needs the stacked view (the JAX weights,
the optimizer's stacked-leaf rules, gathering a checkpoint over the stage
group) goes through :func:`pp_stack` and :func:`pp_unstack`, the port's own.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch

from .sequence import GroupExchange
from .tensor import TensorGroup, _all_gather

__all__ = ["STAGE_AXIS", "StageExchange", "block_index", "gather_stages", "pp_stack",
           "pp_unstack", "stage_blocks", "stage_state_dict"]

STAGE_AXIS = "stage"
_BLOCK = re.compile(r"block(\d+)\.(.+)")


def stage_blocks(depth: int, n_stages: int, stage_idx: int) -> range:
    """The global indices of stage ``stage_idx``'s blocks (JAX
    ``pp_param_specs``: the stacked layer axis split evenly over ``stage``);
    a depth the stage count does not divide raises the JAX message."""
    if depth % n_stages != 0:
        raise ValueError(f"model.depth ({depth}) must be divisible by "
                         f"training.pipeline_parallelism ({n_stages})")
    per = depth // n_stages
    return range(stage_idx * per, (stage_idx + 1) * per)


def block_index(name: str) -> Optional[int]:
    """The block a ``state_dict`` key belongs to (``block{i}.<leaf>``), or
    ``None`` for a shared leaf."""
    m = _BLOCK.fullmatch(name)
    return None if m is None else int(m.group(1))


def pp_stack(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"blocks": {leaf: [k, ...]}, "shared": {...}}`` from a ``state_dict``
    holding ``k`` blocks (any contiguous run of them), stacked in block
    order (JAX ``pp_stack_params``)."""
    blocks: Dict[str, Dict[int, torch.Tensor]] = {}
    shared = {}
    for name, t in state.items():
        m = _BLOCK.fullmatch(name)
        if m is None:
            shared[name] = t
        else:
            blocks.setdefault(m.group(2), {})[int(m.group(1))] = t
    return {"blocks": {leaf: torch.stack([by[i] for i in sorted(by)])
                       for leaf, by in blocks.items()},
            "shared": shared}


def pp_unstack(pp: Mapping[str, Mapping[str, torch.Tensor]], first: int = 0
               ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of :func:`pp_stack`'s layout, the stacked axis
    named ``block{first}``, ``block{first + 1}``, ... (JAX
    ``pp_unstack_params``)."""
    out = dict(pp["shared"])
    for leaf, stacked in pp["blocks"].items():
        for j in range(stacked.shape[0]):
            out[f"block{first + j}.{leaf}"] = stacked[j]
    return out


def stage_state_dict(state: Mapping[str, torch.Tensor], depth: int, n_stages: int,
                     stage_idx: int) -> Dict[str, torch.Tensor]:
    """Stage ``stage_idx``'s part of a full ``state_dict``: its own blocks
    and every shared leaf."""
    own = stage_blocks(depth, n_stages, stage_idx)
    return {k: v for k, v in state.items() if block_index(k) is None or block_index(k) in own}


def gather_stages(local: Mapping[str, torch.Tensor], depth: int, stage: TensorGroup
                  ) -> Dict[str, torch.Tensor]:
    """The whole model's entries from every stage's own, on every rank of the
    stage group (a collective): each stage's blocks stacked and flattened
    into one buffer (the blocks share one layout, so every stage's buffer
    has the same length), all-gathered, and cut back into ``block{i}``
    entries; the shared entries are this rank's (equal on every stage)."""
    own = stage_blocks(depth, stage.size, stage.rank)
    pp = pp_stack(local)
    if stage.size == 1:
        return dict(local)
    leaves = sorted(pp["blocks"])
    stacked = [pp["blocks"][leaf] for leaf in leaves]
    flat = torch.cat([t.reshape(-1) for t in stacked])
    everyone = flat.new_empty(stage.size * flat.numel())
    _all_gather(everyone, flat, stage.group)
    out = dict(pp["shared"])
    for s, chunk in enumerate(everyone.chunk(stage.size)):
        parts = chunk.split([t.numel() for t in stacked])
        pieces = {leaf: part.view(t.shape) for leaf, part, t in zip(leaves, parts, stacked)}
        out.update(pp_unstack({"blocks": pieces, "shared": {}}, first=s * len(own)))
    return out


class StageExchange(GroupExchange):
    """The hops between neighbouring stages over the stage group (JAX's
    ``ppermute`` over ``stage``): :meth:`hop` posts one tick's sends and
    receives at once and waits for them.  Activations only ever travel from
    stage ``s`` to ``s + 1`` and cotangents from ``s + 1`` to ``s``, so
    each ordered pair of ranks carries one kind of message and one tag
    serves both.  ``backend`` picks how a CUDA tensor travels, as
    :class:`.sequence.GroupExchange`'s does (under gloo through pinned host
    memory)."""

    def hop(self, send_next=None, send_prev=None, recv_prev=None, recv_next=None) -> None:
        """Send ``send_next`` to stage + 1 and ``send_prev`` to stage - 1;
        receive stage - 1's into ``recv_prev`` and stage + 1's into
        ``recv_next`` (each ``None`` to skip it), all in one batch."""
        s = self.rank
        sends = [(t, peer) for t, peer in ((send_next, s + 1), (send_prev, s - 1))
                 if t is not None]
        recvs = [(t, peer) for t, peer in ((recv_prev, s - 1), (recv_next, s + 1))
                 if t is not None]
        if sends or recvs:
            self._staged_post(sends, recvs)
