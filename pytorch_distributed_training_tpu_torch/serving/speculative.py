"""Speculative decoding: draft-proposed tokens, target-verified exactly.

Port of the JAX package's ``serving/speculative.py`` (the accept rules
are its pure numpy, copied).  A cheap draft model proposes ``k`` tokens
one at a time, the target scores all ``k + 1`` positions in one batched
``verify`` call (:class:`.decode.PagedFns`), and the host keeps the
longest prefix the target agrees with (Leviathan et al. 2023; Chen et
al. 2023).  Every committed token is the target's own choice, so the
output is the target's; the draft decides only how many tokens one
target call yields.

The scheduler runs the greedy specialisation, :func:`greedy_accept`,
which keeps the committed stream token-identical to plain greedy decode.
:func:`sampled_accept` is the full rejection-sampling rule for
temperature > 0, kept as a pure function, as in the JAX package, until
the scheduler grows a sampled mode.

:class:`SpeculativeSpec` carries the engine's choices: ``k`` and an
optional draft model (a :class:`..models.transformer_lm.TransformerLM`
holding its own weights, on the target's device).  No draft means the
target drafts for itself: no speed-up, but an acceptance rate of 1.0,
the end-to-end check that verification and the pool fork are exact.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["SpeculativeSpec", "greedy_accept", "sampled_accept"]


class SpeculativeSpec:
    """Draft length ``k`` and the draft model (``None``: self-draft).

    The draft gets its own paged calls and its own pool in the scheduler:
    draft K/V and target K/V never share rows.  A torch model carries its
    weights, so the JAX spec's ``draft_params`` has no counterpart here.
    """

    __slots__ = ("k", "draft_model")

    def __init__(self, k: int, draft_model=None):
        k = int(k)
        if k < 1:
            raise ValueError(f"serving.speculative.k must be >= 1, got {k}")
        self.k = k
        self.draft_model = draft_model


def greedy_accept(draft_tokens, target_tokens) -> Tuple[int, List[int]]:
    """Temperature-0 accept rule: ``(n_accepted, emitted_tokens)``.

    ``draft_tokens`` are the draft's ``k`` proposals for generated-token
    indices ``g .. g+k-1``; ``target_tokens`` the target's argmax at the
    ``k+1`` verify positions (``target_tokens[j]`` is its choice for index
    ``g+j``, the bonus row included).  Proposals are kept while they equal
    the target's choice; the first mismatch emits the target's correction
    and stops; a clean sweep emits the bonus.  So ``1 <= len(emitted) <=
    k+1`` and the committed stream is plain greedy decode's whatever the
    draft.  (The caller trims the bonus when the request's cap has no
    room for it.)
    """
    draft = [int(t) for t in draft_tokens]
    target = [int(t) for t in target_tokens]
    if len(target) != len(draft) + 1:
        raise ValueError(f"need k+1 target tokens for k draft tokens, got "
                         f"{len(target)} for {len(draft)}")
    emitted: List[int] = []
    for j, d in enumerate(draft):
        t = target[j]
        emitted.append(t)
        if d != t:
            return j, emitted
    emitted.append(target[len(draft)])
    return len(draft), emitted


def sampled_accept(draft_tokens, draft_probs, target_probs,
                   rng: np.random.Generator) -> Tuple[int, List[int]]:
    """Leviathan rejection sampling: ``(n_accepted, emitted_tokens)``.

    ``draft_probs`` [k, V] are the draft's distributions q, one a proposal;
    ``target_probs`` [k+1, V] the target's p at the verify positions.
    Proposal ``d_j`` is accepted with probability ``min(1, p_j(d_j) /
    q_j(d_j))``; on rejection a correction is drawn from
    ``normalize(max(p_j - q_j, 0))`` and the round stops; a clean sweep
    draws the bonus from ``p_k``.  The emitted marginals are exactly p.
    With a point-mass q this is :func:`greedy_accept` in distribution.
    """
    draft = [int(t) for t in draft_tokens]
    p = np.asarray(target_probs, np.float64)
    q = np.asarray(draft_probs, np.float64)
    if p.ndim != 2 or q.ndim != 2 or p.shape[0] != len(draft) + 1:
        raise ValueError(f"need target_probs [k+1, V] and draft_probs [k, V], got "
                         f"{p.shape} / {q.shape} for k={len(draft)}")
    emitted: List[int] = []
    for j, d in enumerate(draft):
        accept = min(1.0, p[j, d] / max(q[j, d], 1e-300))
        if rng.random() < accept:
            emitted.append(d)
            continue
        resid = np.maximum(p[j] - q[j], 0.0)
        z = resid.sum()
        dist = resid / z if z > 0.0 else p[j] / p[j].sum()
        emitted.append(int(rng.choice(dist.size, p=dist)))
        return j, emitted
    bonus = p[len(draft)] / p[len(draft)].sum()
    emitted.append(int(rng.choice(bonus.size, p=bonus)))
    return len(draft), emitted
