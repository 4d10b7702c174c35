"""Mixture-of-Experts MLP with top-k routing (port of ``ops/moe.py``).

The JAX layer (``ops/moe.py:59-138``) is plain jnp, no Pallas kernel, and
so is this one, operation for operation (the GShard/Switch formulation):

- **router**: an f32 Dense on the input cast to f32, softmax, top-k
  (``torch.topk``, sorted: slot 0 is the primary expert).  For k > 1 the
  gates are renormalised over the chosen k; for k = 1 the raw top-1
  probability is the gate (Switch: a gate of exactly 1 would cut the
  router off from the task loss);
- **capacity** ``C = max(1, ceil(capacity_factor * k * S / E))`` per group,
  a group being one leading batch row;
- **slot-major positions**: a cumsum over ``[G, k*S, E]`` gives each
  assignment its place in its expert's buffer, every slot-0 choice ahead
  of any slot-1 choice; an assignment at a place >= C is dropped: its
  combine weight is 0, so the residual around the layer passes the token
  through.  The dispatch and combine tensors ``[G, S, E*C]`` are written
  by one scatter each at ``expert * C + min(place, C - 1)`` with the value
  ``keep`` (``keep * gate``): a token's k experts differ, so its k slots
  never collide, and a dropped assignment writes a 0.  ``F.one_hot`` is
  never asked for a place outside ``[0, C)`` (it raises where
  ``jax.nn.one_hot`` gives a zero row);
- **experts**: stacked ``wi [E, d, h]``, ``bi [E, h]``, ``wo [E, h, out]``,
  ``bo [E, out]`` in the JAX layout, cast to the compute dtype per call;
  dispatch, the two expert products and combine are batched matmuls
  (``torch.bmm``: the ``dots`` remat policy recomputes them, as
  ``dots_with_no_batch_dims_saveable`` does in JAX, and ``dots_saveable``
  keeps them); the biases are added in the compute dtype and the GELU is
  flax's ``nn.gelu``, the tanh form;
- **aux load-balancing loss** (Switch eq. 4) ``E * sum_e f_e P_e`` over all
  tokens, ``f_e`` the share of tokens whose top-1 choice is ``e`` and
  ``P_e`` the mean router probability.  The layer returns its statistics,
  ``stats = [[top-1 count_e], [probability sum_e]]`` (f32 ``[2, E]``),
  beside its output, and :func:`moe_aux` forms the weighted term from
  them.  A data-parallel step sums the statistics over ranks first (a
  differentiable all-reduce) and so gets the global term the JAX GSPMD
  step computes over the whole micro-batch.

Initialisation is flax's: the router a Dense (lecun-normal kernel, zero
bias); ``wi``/``wo`` lecun-normal over the stacked leaf, whose leading
``E`` flax counts as receptive field, so the fan-in is ``E * d`` (``E *
h`` for ``wo``); zero biases.

**Expert parallelism** over a ``tensor_group`` of ``T`` ranks (JAX
``parallel/tensor.py``: the stacked leaves ``P(model)``, tokens ``P(data,
None)``): rank ``m`` keeps experts ``[m E/T, (m+1) E/T)`` (drawn whole,
then sliced) and their dispatch and combine places ``[m E/T C, (m+1) E/T
C)``.  The router stays replicated, and routing, the capacity (over all
``E``), the drop order and ``stats`` are exactly the one-rank layer's:
every rank of a model group holds the same tokens, so it routes them
alike.  It runs its local expert ``bmm``s and *reduce*
(:func:`..parallel.tensor.reduce_from_model`) sums the partial combines.
No all-to-all is needed: an all-to-all carries tokens to the rank that owns
their expert, and here every rank already holds every token (the data
axis, not the model axis, splits the batch); GSPMD derives the same local
products from those shardings.  In the backward each rank sees only its own
experts' part of the gradient of the layer's input and of the gates, so both
pass *copy* (:func:`..parallel.tensor.copy_to_model`) on their way in: the
input before the dispatch product, the gates before the combine scatter.
The router's own input (and the aux term's path) is whole on every rank and
takes no copy.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor import copy_to_model, reduce_from_model, shard_param
from .layers import Dense, lecun_normal_

__all__ = ["MoEMLP", "moe_aux"]


def moe_aux(stats, n_tokens: int, aux_weight: float, num_experts: int):
    """The weighted aux term ``aux_weight * E * sum_e f_e P_e`` of one MoE
    layer from its ``stats`` (``[2, E]``: top-1 counts, probability sums)
    over ``n_tokens`` tokens (JAX ``ops/moe.py:111-115``)."""
    f, p = stats[0] / n_tokens, stats[1] / n_tokens
    return aux_weight * (num_experts * torch.sum(f * p))


class MoEMLP(nn.Module):
    """Drop-in MoE replacement for the block's MLP: ``[G, S, d] -> ([G, S,
    out], stats)``, each leading row one routing group (see the module
    docstring)."""

    def __init__(self, dim: int, num_experts: int, top_k: int, capacity_factor: float,
                 hidden: int, out: int, dtype=torch.float32, tensor_group=None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k ({top_k}) must be in [1, num_experts={num_experts}]")
        self.num_experts, self.top_k = int(num_experts), int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.dtype = dtype
        self.tensor_group = None
        self.router = Dense(dim, num_experts, torch.float32)
        self.wi = nn.Parameter(torch.empty(num_experts, dim, hidden))
        self.bi = nn.Parameter(torch.zeros(num_experts, hidden))
        self.wo = nn.Parameter(torch.empty(num_experts, hidden, out))
        self.bo = nn.Parameter(torch.zeros(num_experts, out))
        self.reset_parameters()
        if tensor_group is not None:
            n, r = tensor_group.size, tensor_group.rank
            if num_experts % n != 0:
                raise ValueError(f"{num_experts} experts do not split over a tensor group of {n}")
            for name in ("wi", "bi", "wo", "bo"):
                setattr(self, name, nn.Parameter(shard_param(getattr(self, name).data, 0, n, r)))
            self.tensor_group = tensor_group

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The stacked leaves' initializers (the router resets itself)."""
        if self.tensor_group is not None:
            raise RuntimeError("an expert-parallel MoEMLP holds a slice of the experts: reset "
                               "the full model (TransformerLM.reset_parameters) instead")
        e, d, h = self.wi.shape
        lecun_normal_(self.wi, generator, fan_in=e * d)
        lecun_normal_(self.wo, generator, fan_in=e * h)
        with torch.no_grad():
            self.bi.zero_()
            self.bo.zero_()

    def capacity(self, group_size: int) -> int:
        """Buffer places an expert has in a group of ``group_size`` tokens."""
        return max(1, int(math.ceil(
            self.capacity_factor * self.top_k * group_size / self.num_experts)))

    def route(self, x):
        """Routing in f32: ``(probs [G, S, E], gate [G, S, k], expert [G, S,
        k], place [G, S, k], keep [G, S, k])``."""
        g, s, _ = x.shape
        E, k = self.num_experts, self.top_k
        probs = torch.softmax(self.router(x.float()), dim=-1)
        gate, expert = torch.topk(probs, k, dim=-1, sorted=True)
        if k > 1:
            gate = gate / gate.sum(dim=-1, keepdim=True)
        # slot-major fill: every token's slot-0 choice takes a place before
        # any slot-1 choice does; a one-hot row has one 1, so the sum over
        # experts reads the chosen expert's running count
        slot_major = F.one_hot(expert.transpose(1, 2).reshape(g, k * s), E)
        place = (torch.cumsum(slot_major, dim=1) * slot_major).sum(-1) - 1
        place = place.view(g, k, s).transpose(1, 2)
        return probs, gate, expert, place, place < self.capacity(s)

    def forward(self, x):
        if x.dim() != 3:
            raise ValueError(f"MoEMLP expects [groups, group_size, d] inputs, got "
                             f"{tuple(x.shape)}")
        g, s, d = x.shape
        E, dt, tg = self.num_experts, self.dtype, self.tensor_group
        cap = self.capacity(s)
        probs, gate, expert, place, keep = self.route(x)
        slot = expert * cap + place.clamp(max=cap - 1)
        keepf = keep.to(torch.float32)
        dispatch = x.new_zeros((g, s, E * cap), dtype=dt).scatter_(-1, slot, keepf.to(dt))
        combine = torch.zeros(g, s, E * cap, dtype=torch.float32, device=x.device).scatter(
            -1, slot, copy_to_model(gate, tg) * keepf).to(dt)
        stats = torch.stack([
            F.one_hot(expert[..., 0].reshape(-1), E).to(torch.float32).sum(0),
            probs.reshape(-1, E).sum(0),
        ])
        n_local = self.wi.shape[0]  # E, or E / T experts on this rank
        if n_local != E:
            places = slice(tg.rank * n_local * cap, (tg.rank + 1) * n_local * cap)
            dispatch, combine = dispatch[..., places], combine[..., places]

        # [G, E*C, d] -> [E, G*C, d]: the experts' rows, group-major
        xe = torch.bmm(dispatch.transpose(1, 2), copy_to_model(x, tg).to(dt))
        xe = xe.view(g, n_local, cap, d).transpose(0, 1).reshape(n_local, g * cap, d)
        h = F.gelu(torch.bmm(xe, self.wi.to(dt)) + self.bi.to(dt)[:, None, :],
                   approximate="tanh")
        ye = torch.bmm(h, self.wo.to(dt)) + self.bo.to(dt)[:, None, :]
        ye = ye.view(n_local, g, cap, -1).transpose(0, 1).reshape(g, n_local * cap, -1)
        # an empty place's bias is harmless: its combine weight is 0
        return reduce_from_model(torch.bmm(combine, ye), tg), stats
