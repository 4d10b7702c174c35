"""Optimizers with PyTorch-exact update rules, written out by hand.

Port of ``pytorch_distributed_training_tpu/optimizers/__init__.py``: the
same ``get_optimizer(cfg) -> class`` surface, instantiated with the config
minus its ``name``, and the same update order as the JAX package (which
replicates ``torch.optim`` step for step; the port does not assume that
``torch.optim`` still does):

- :class:`SGD` (``:138-215``): coupled weight decay ``d = g + wd * p``
  before momentum, torch's first-step buffer ``buf = d``, nesterov.
- :class:`LARS` (``:230-282``): per parameter of rank >= 2 the trust
  ratio ``eta ||p|| / (||g|| + wd ||p|| + eps)`` (1 where either norm is
  0) scales ``g + wd * p``, then plain momentum ``buf = mu buf + d`` (no
  first-step special case); parameters of rank <= 1 take ``d = g``;
- :class:`AdamW` (``:285-390``): decoupled decay ``p *= 1 - lr * wd``
  before the step, bias-corrected moments, ``eps`` outside the square root
  and added to the bias-corrected denominator (``:341``);
  ``exclude_norm_bias`` skips the decay for rank <= 1 parameters.

The JAX optimizers are functional; these keep the same
``init(params) -> state`` / ``update(...)`` split but update the
parameters in place (no second copy of 270 M parameters), each operation
as one multi-tensor ``torch._foreach_*`` pass.  The scalar coefficients
(``1 - lr * wd``, bias corrections) are computed in float32, as the JAX
step computes them on the device.  ``fused`` is accepted for config
compatibility: it picks nothing here, every update is already one pass
per operation over all parameters.

- :class:`LAMB` (``:392-460``): Adam moments, the bias-corrected
  direction with ``eps`` inside the ratio, ``u = (mu / bc1) / (sqrt(nu /
  bc2) + eps)``, decoupled decay folded into it (``u += wd * p``), then
  per parameter of rank >= 2 the trust ratio ``||p|| / ||u||`` (1 where
  either norm is 0) scales ``lr``; parameters of rank <= 1 take ``p -= lr
  * u`` with no decay.  Its state is :class:`AdamWState`, as in JAX.

Every update is elementwise but the trust ratios' norms, which JAX takes
over whole leaves.  A sharded step (tensor parallelism, ZeRO) passes the
parts it holds to ``update`` and, to LARS and LAMB (``per_leaf_norms``),
``whole_norms(norms, idx)``: it turns the norms ``[k, len(idx)]`` of its
parts of the leaves ``idx`` into the whole leaves' norms (a sum of squares
over the ranks that hold the other parts, :class:`..engine.tp_steps.TPLMTrainStep`).
A leaf's slice keeps its rank, so ``_is_excluded`` reads it as it reads the
leaf.

Under the pipeline the JAX optimizers see each stage's blocks as stacked
leaves ``[L/S, ...]`` (JAX ``engine/pp_steps.py:522-526``): a block's bias
or LayerNorm scale has rank 2 there, so the rank rule no longer excludes it
(AdamW's ``exclude_norm_bias`` decays it, LAMB adapts it), and LAMB's trust
ratio is taken over the whole stack.  The port keeps per-layer leaves: the
pipeline step passes ``excluded`` (a flag a leaf, the rule read on the
stacked layout) to AdamW and LAMB, and to LAMB a ``whole_norms`` that takes
each stack's norm over its layers.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

__all__ = ["AdamW", "AdamWState", "LAMB", "LARS", "OPTIMIZERS", "SGD", "SGDState",
           "get_optimizer"]


class SGDState(NamedTuple):
    momentum: List[torch.Tensor]  # like the params (zeros when momentum == 0)
    step: int  # updates applied so far


class AdamWState(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    step: int


def _f32(x) -> float:
    return float(np.float32(x))


def _leaf_norms(lists, idx, whole_norms=None) -> torch.Tensor:
    """The L2 norms ``[k, len(idx)]`` of the leaves ``idx`` of each of the
    ``k`` lists (the parts a rank holds), made whole by ``whole_norms``."""
    norms = torch.stack([torch.stack(torch._foreach_norm(ts)) for ts in lists])
    return norms if whole_norms is None else whole_norms(norms, idx)


def _excluded(params, excluded=None) -> List[bool]:
    """Each leaf's exclusion: ``excluded`` as given, else by rank."""
    return [_is_excluded(p) for p in params] if excluded is None else list(excluded)


def _is_excluded(param: torch.Tensor) -> bool:
    """Biases and norm scales/offsets (rank <= 1), as ``_is_excluded`` of
    the JAX package (``optimizers/__init__.py:216-228``): by rank, not by
    name, so LayerNorm scales are excluded as BatchNorm's are."""
    return param.dim() <= 1


class SGD:
    """``torch.optim.SGD`` semantics (see the module docstring)."""

    def __init__(self, lr: float, momentum: float = 0.0, weight_decay: float = 0.0,
                 dampening: float = 0.0, nesterov: bool = False, fused: bool = False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires momentum > 0 and dampening = 0")
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.dampening = float(dampening)
        self.nesterov = bool(nesterov)

    def init(self, params: List[torch.Tensor]) -> SGDState:
        return SGDState(momentum=[torch.zeros_like(p) for p in params], step=0)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: SGDState, lr=None) -> SGDState:
        """Apply one step to ``params`` in place; returns the new state."""
        lr = self.lr if lr is None else lr
        mu, wd, damp = self.momentum, self.weight_decay, self.dampening
        d = torch._foreach_add(grads, params, alpha=wd) if wd != 0 else list(grads)
        bufs = state.momentum
        if mu != 0:
            if state.step == 0:
                # torch: the buffer starts as the first d, not as mu*0 + (1-damp)*d
                torch._foreach_copy_(bufs, d)
            else:
                torch._foreach_mul_(bufs, mu)
                torch._foreach_add_(bufs, d, alpha=1.0 - damp)
            step_dir = torch._foreach_add(d, bufs, alpha=mu) if self.nesterov else bufs
        else:
            step_dir = d
        torch._foreach_add_(params, step_dir, alpha=-_f32(lr))
        return SGDState(momentum=bufs, step=state.step + 1)


class LARS:
    """Layer-wise Adaptive Rate Scaling with momentum (see the module
    docstring); the norms of a step are one ``torch._foreach_norm`` pass
    each over the adapted parameters and their gradients."""

    per_leaf_norms = True

    def __init__(self, lr: float, momentum: float = 0.9, weight_decay: float = 0.0,
                 eta: float = 0.001, eps: float = 1e-9):
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.eta = float(eta)
        self.eps = float(eps)

    def init(self, params: List[torch.Tensor]) -> SGDState:
        return SGDState(momentum=[torch.zeros_like(p) for p in params], step=0)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: SGDState, lr=None, whole_norms=None) -> SGDState:
        """Apply one step to ``params`` in place; returns the new state."""
        lr = self.lr if lr is None else lr
        wd = self.weight_decay
        d = list(grads)  # rank <= 1: the plain gradient, no decay
        adapt = [i for i, p in enumerate(params) if not _is_excluded(p)]
        if adapt:
            ps, gs = [params[i] for i in adapt], [grads[i] for i in adapt]
            p_norm, g_norm = _leaf_norms([ps, gs], adapt, whole_norms)
            trust = torch.where((p_norm > 0) & (g_norm > 0),
                                self.eta * p_norm / (g_norm + wd * p_norm + self.eps),
                                torch.ones_like(p_norm))
            decayed = torch._foreach_mul(ps, wd)
            torch._foreach_add_(decayed, gs)
            torch._foreach_mul_(decayed, list(trust.unbind()))
            for i, t in zip(adapt, decayed):
                d[i] = t
        bufs = state.momentum
        torch._foreach_mul_(bufs, self.momentum)
        torch._foreach_add_(bufs, d)
        torch._foreach_add_(params, bufs, alpha=-_f32(lr))
        return SGDState(momentum=bufs, step=state.step + 1)


class AdamW:
    """``torch.optim.AdamW`` semantics (see the module docstring)."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, fused: bool = False,
                 exclude_norm_bias: bool = False):
        self.lr = float(lr)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.exclude_norm_bias = bool(exclude_norm_bias)

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        return AdamWState(mu=[torch.zeros_like(p) for p in params],
                          nu=[torch.zeros_like(p) for p in params], step=0)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamWState, lr=None, excluded=None) -> AdamWState:
        """Apply one step to ``params`` in place; returns the new state.
        ``excluded``: the leaves ``exclude_norm_bias`` skips, if not by rank."""
        lr = np.float32(self.lr if lr is None else lr)
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        t = np.float32(state.step + 1)
        bc1 = np.float32(1.0) - b1 ** t
        bc2 = np.float32(1.0) - b2 ** t
        if self.weight_decay != 0.0:
            decay = float(np.float32(1.0) - lr * np.float32(self.weight_decay))
            skip = _excluded(params, excluded) if self.exclude_norm_bias else [False] * len(params)
            decayed = [p for p, s in zip(params, skip) if not s]
            if decayed:
                torch._foreach_mul_(decayed, decay)
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, float(b1))
        torch._foreach_add_(mu, grads, alpha=float(np.float32(1.0) - b1))
        torch._foreach_mul_(nu, float(b2))
        torch._foreach_addcmul_(nu, grads, grads, value=float(np.float32(1.0) - b2))
        denom = torch._foreach_sqrt(nu)
        torch._foreach_div_(denom, float(np.sqrt(bc2)))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(params, mu, denom, value=-float(lr / bc1))
        return AdamWState(mu=mu, nu=nu, step=state.step + 1)


class LAMB:
    """Layer-wise Adaptive Moments (You et al., 2019), see the module
    docstring; the norms of a step are one ``torch._foreach_norm`` pass
    each over the adapted parameters and their directions."""

    per_leaf_norms = True

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        self.lr = float(lr)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        return AdamWState(mu=[torch.zeros_like(p) for p in params],
                          nu=[torch.zeros_like(p) for p in params], step=0)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamWState, lr=None, whole_norms=None, excluded=None) -> AdamWState:
        """Apply one step to ``params`` in place; returns the new state.
        ``excluded``: the leaves the rule excludes, if not by rank."""
        lr = _f32(self.lr if lr is None else lr)
        t = np.float32(state.step + 1)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, denom)
        del denom
        skip = _excluded(params, excluded)
        adapt = [i for i, s in enumerate(skip) if not s]
        plain = [i for i, s in enumerate(skip) if s]
        if plain:
            torch._foreach_add_([params[i] for i in plain], [u[i] for i in plain], alpha=-lr)
        if adapt:
            ps, us = [params[i] for i in adapt], [u[i] for i in adapt]
            if self.weight_decay != 0.0:
                torch._foreach_add_(us, ps, alpha=self.weight_decay)
            p_norm, u_norm = _leaf_norms([ps, us], adapt, whole_norms)
            trust = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm,
                                torch.ones_like(p_norm))
            torch._foreach_mul_(us, list((lr * trust).unbind()))
            torch._foreach_sub_(ps, us)
        return AdamWState(mu=mu, nu=nu, step=state.step + 1)


OPTIMIZERS = {"SGD": SGD, "LARS": LARS, "AdamW": AdamW, "LAMB": LAMB}


def get_optimizer(cfg: Dict[str, Any]):
    """The optimizer *class* for ``cfg['name']`` (reference: :204)."""
    name = cfg["name"]
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer '{name}' (have: {sorted(OPTIMIZERS)})")
    return OPTIMIZERS[name]
