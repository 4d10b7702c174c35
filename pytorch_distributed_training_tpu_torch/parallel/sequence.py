"""Sequence parallelism: ring attention and Ulysses all-to-all attention.

Port of ``pytorch_distributed_training_tpu/parallel/sequence.py``.  The
sequence of ``[B, S, H, D]`` attention inputs is sharded contiguously over
the ``n`` ranks of a sequence group: rank ``i`` holds tokens ``[i S/n,
(i + 1) S/n)``.

- :func:`ring_attention` (JAX ``:70-217``): the local queries attend to
  every K/V block while the blocks rotate around the ring, each rank
  sending its current block to rank ``i - 1`` and receiving rank ``i + 1``'s
  (the JAX ``ppermute``), ``n`` rotations in all, the last one bringing the
  blocks home.  Two inner paths:

  - the plain inner (``impl="xla"``): the online-softmax recurrence of JAX
    ``_block_attn`` (``:42-67``) in f32, running max and normaliser;
  - the flash inner (``impl="flash"``, JAX ``_ring_attention_flash``,
    ``:83-153``): each step is one of three cases by the block's global
    position, a full :func:`..ops.flash_attention.flash_attention_lse` for
    past blocks, a causal one for the diagonal and a masked no-op for
    future blocks; the partial results combine by the logsumexp rule in
    f32, ``o = w_acc o_acc + w_b o_b``, ``w = exp(lse - logaddexp(...))``,
    exact in the backward because ``flash_attention_lse`` takes the lse
    cotangent.  A rank knows its place in the ring, so the case is a Python
    ``if``; the masked no-op computes nothing (the JAX branch's zeros and
    ``-inf`` leave the combine unchanged).

  ``impl=None`` takes the flash inner on CUDA tensors under JAX's gate
  (``_ring_flash_ok``: the local length passes
  :func:`..ops.flash_attention.flash_shapes_ok` and the kernels take the
  head dim), the plain inner otherwise, as JAX does off the TPU.  On CUDA
  the flash inner launches the kernels or raises.
- :func:`ulysses_attention` (JAX ``:220-261``): an all-to-all from ``[B,
  S/n, H, D]`` to ``[B, S, H/n, D]``, local attention over the head group
  through :func:`..ops.attention.dot_product_attention` (the flash kernels
  with ``impl="flash"``, bf16 dots on bf16 inputs), and the inverse
  all-to-all.

The exchanges.  Each function is written once, as a generator that yields
its exchanges (``("shift", tensors)`` and ``("a2a", tensors, split_dim,
concat_dim)``) and takes back what arrives; one of two loops runs it:

- :class:`GroupExchange` drives one rank over a ``torch.distributed``
  process group, the training path.  ``send``/``recv`` and
  ``all_to_all`` are not differentiable, so each exchange is a
  ``torch.autograd.Function`` whose backward is the inverse exchange (K/V
  cotangents travel back to their owners, as JAX gets from ``ppermute``'s
  transpose).  A rotation carries the accumulator through as well, so
  every rotation lies on the path to the loss on every rank and every rank
  runs every exchange's backward, in the same order (the rotation of the
  last step and the ones a causal rank masks included); a rank that left
  one out would stall its neighbours;
- :func:`loopback` drives all ``n`` ranks' generators in one process, in
  lockstep: an exchange hands the tensors from rank to rank, so autograd
  sees one graph across the ranks and needs no exchange in the backward.
  ``chip_smoke.py`` holds the ring on the card this way at the full
  config's shape, four virtual ranks on one card.
"""
from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["GroupExchange", "loopback", "ring_attention", "ring_attention_loop",
           "ulysses_attention", "ulysses_attention_loop"]

_NEG_INF = float("-inf")
_IMPLS = (None, "flash", "xla")


def _block_attn(q, k, v, scale, q_off, k_off, causal, m, l, o):
    """One online-softmax step against one K/V block (JAX ``:42-67``).

    q: [B, Sq, H, D]; k, v: [B, Sk, H, D]; m, l: [B, H, Sq] f32 running
    max and normaliser; o: [B, Sq, H, D] f32 unnormalised accumulator.
    ``q_off``/``k_off``: the global positions of the blocks' first tokens.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_off + torch.arange(q.shape[1], device=q.device)
        k_pos = k_off + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    # a row masked so far keeps m_new = -inf: exp(-inf - -inf) is NaN, so
    # both correction factors are gated on finiteness (the row adds 0)
    finite = torch.isfinite(m_new)
    alpha = torch.where(finite, torch.exp(m - m_new), 0.0)
    p = torch.where(finite[..., None], torch.exp(s - m_new[..., None]), 0.0)
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m_new, l_new, o * alpha.transpose(1, 2)[..., None] + pv


def _ring_flash_ok(q) -> bool:
    """JAX's ``_ring_flash_ok`` on the card: CUDA tensors whose local
    length passes the flash gate, with a head dim the kernels take."""
    from ..ops.flash_attention import SUPPORTED_HEAD_DIMS, flash_shapes_ok

    _, s_local, _, d = q.shape
    return q.is_cuda and flash_shapes_ok(s_local) and d in SUPPORTED_HEAD_DIMS


def _scale(q, sm_scale) -> float:
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def ring_attention_loop(q, k, v, n: int, idx: int, causal: bool = False,
                        sm_scale: Optional[float] = None, impl: Optional[str] = None):
    """Rank ``idx`` of ``n``'s ring attention, as a generator of its
    exchanges (module docstring); returns ``[B, S/n, H, D]`` in q's dtype."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown ring impl {impl!r}")
    scale = _scale(q, sm_scale)
    if impl == "flash" or (impl is None and _ring_flash_ok(q)):
        return (yield from _ring_flash(q, k, v, n, idx, causal, scale))
    return (yield from _ring_plain(q, k, v, n, idx, causal, scale))


def _ring_plain(q, k, v, n, idx, causal, scale):
    b, s_local, h, d = q.shape
    m = torch.full((b, h, s_local), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, s_local, h, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        src = (idx + i) % n
        m, l, o = _block_attn(q, k_cur, v_cur, scale, idx * s_local, src * s_local, causal,
                              m, l, o)
        # rotate on the last step too: the blocks return home (JAX :206-212)
        o, k_cur, v_cur = yield ("shift", (o, k_cur, v_cur))
    l_t = l.transpose(1, 2)[..., None]
    out = torch.where(l_t > 0, o / l_t.clamp_min(1e-37), 0.0)
    return out.to(q.dtype)


def _ring_flash(q, k, v, n, idx, causal, scale):
    from ..ops.flash_attention import flash_attention_lse

    o_acc = lse_acc = None
    k_cur, v_cur = k, v
    for i in range(n):
        src = (idx + i) % n
        if not causal or src < idx:
            o_b, lse_b = flash_attention_lse(q, k_cur, v_cur, causal=False, sm_scale=scale)
        elif src == idx:
            o_b, lse_b = flash_attention_lse(q, k_cur, v_cur, causal=True, sm_scale=scale)
        else:
            o_b = None  # a future block: masked, the combine unchanged
        if o_b is not None:
            if o_acc is None:
                # step 0 is the rank's own block, finite everywhere: the
                # combine against JAX's zeros and -inf gives it unchanged
                o_acc, lse_acc = o_b, lse_b
            else:
                lse_new = torch.logaddexp(lse_acc, lse_b)
                w_acc = torch.exp(lse_acc - lse_new)[..., None]
                w_b = torch.exp(lse_b - lse_new)[..., None]
                o_acc, lse_acc = w_acc * o_acc + w_b * o_b, lse_new
        o_acc, k_cur, v_cur = yield ("shift", (o_acc, k_cur, v_cur))
    return o_acc.to(q.dtype)


def ulysses_attention_loop(q, k, v, n: int, causal: bool = False,
                           sm_scale: Optional[float] = None, impl: Optional[str] = None):
    """One rank's Ulysses attention as a generator of its two all-to-alls
    (module docstring); returns ``[B, S/n, H, D]`` in q's dtype."""
    from ..ops.attention import dot_product_attention

    h = q.shape[2]
    if h % n != 0:
        raise ValueError(f"heads ({h}) must be divisible by the axis size ({n})")
    # [B, S/n, H, D] -> [B, S, H/n, D]
    qg, kg, vg = yield ("a2a", (q, k, v), 2, 1)
    out = dot_product_attention(qg, kg, vg, causal=causal, sm_scale=_scale(q, sm_scale),
                                impl=impl)
    # [B, S, H/n, D] -> [B, S/n, H, D]
    (o,) = yield ("a2a", (out,), 1, 2)
    return o


# --------------------------------------------------------------------- #
# running the generators


def _drive(gen: Iterator, exchange: "GroupExchange"):
    """Run one rank's generator, its exchanges over ``exchange``."""
    try:
        msg = next(gen)
        while True:
            if msg[0] == "shift":
                msg = gen.send(exchange.shift(*msg[1]))
            else:
                msg = gen.send(exchange.all_to_all(*msg[1:]))
    except StopIteration as stop:
        return stop.value


def loopback(gens: Sequence[Iterator]) -> List[torch.Tensor]:
    """Run the generators of all ``n`` ranks of one ring in one process, in
    lockstep, each exchange handing tensors from rank to rank; the ranks'
    outputs, in rank order."""
    n = len(gens)
    msgs = [next(g) for g in gens]
    while True:
        if msgs[0][0] == "shift":
            # rank r keeps its first tensor (the accumulator) and receives
            # the rest from rank r + 1
            outs = [(msgs[r][1][0], *msgs[(r + 1) % n][1][1:]) for r in range(n)]
        else:
            _, _, split, concat = msgs[0]
            chunks = [[t.chunk(n, split) for t in m[1]] for m in msgs]
            outs = [tuple(torch.cat([chunks[src][j][r] for src in range(n)], concat)
                          for j in range(len(msgs[0][1]))) for r in range(n)]
        done, nxt = [], []
        for g, out in zip(gens, outs):
            try:
                nxt.append(g.send(out))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if len(done) != n:
                raise RuntimeError("the ranks of a loopback ring left it at different steps")
            return done
        msgs = nxt


class GroupExchange:
    """The ring's and the all-to-all's exchanges over a ``torch.distributed``
    process group (NCCL on the card, gloo on the CPU): ``size`` and
    ``rank`` in the group.

    ``ranks``: the group's members as global ranks, for a group registered
    with the default process group (``dist.new_group``); its rotations go
    through ``dist.batch_isend_irecv``, which NCCL needs to pair a rank's
    send and receive.  Without it the group object is used on its own
    (a gloo group over a store of its own, as the tests' thread ranks
    build), its ``send``/``recv`` called directly.
    """

    def __init__(self, group, ranks: Optional[Sequence[int]] = None):
        self.group = group
        self.ranks = None if ranks is None else list(ranks)
        self.size = group.size()
        self.rank = group.rank()

    def shift(self, carry, *tensors):
        """``(carry, *blocks of rank + 1)``: send ``tensors`` to rank - 1 and
        receive rank + 1's, ``carry`` passed through (differentiable)."""
        return _Shift.apply(self, carry, *tensors)

    def all_to_all(self, tensors, split_dim: int, concat_dim: int):
        """Each tensor split into ``size`` chunks along ``split_dim``, chunk
        ``j`` sent to rank ``j``, the received chunks concatenated along
        ``concat_dim`` in rank order (JAX ``all_to_all(..., tiled=True)``);
        differentiable."""
        return tuple(_AllToAll.apply(self, t, split_dim, concat_dim) for t in tensors)

    def _rotate(self, tensors, step: int):
        """Send ``tensors`` to rank - step, receive rank + step's."""
        to, frm = (self.rank - step) % self.size, (self.rank + step) % self.size
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        self._post([(t, to) for t in sends], [(t, frm) for t in recvs])
        return recvs

    def _post(self, sends, recvs, tag: int = 0) -> None:
        """Post every ``(tensor, peer)`` send and receive at once (peers are
        ranks of the group), then wait for all of them."""
        if self.ranks is not None:
            ops = [dist.P2POp(dist.isend, t, self.ranks[to], self.group, tag) for t, to in sends]
            ops += [dist.P2POp(dist.irecv, t, self.ranks[frm], self.group, tag)
                    for t, frm in recvs]
            works = dist.batch_isend_irecv(ops) if ops else []
        else:
            works = [self.group.send([t], to, tag) for t, to in sends]
            works += [self.group.recv([t], frm, tag) for t, frm in recvs]
        for w in works:
            w.wait()

    def _all_to_all(self, x, split_dim: int, concat_dim: int):
        n = self.size
        send = torch.stack(x.chunk(n, split_dim))  # [n, ...chunk], contiguous
        recv = torch.empty_like(send)
        self.group.alltoall_base(recv, send, [], []).wait()
        return torch.cat(recv.unbind(0), concat_dim)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ex, carry, *tensors):
        ctx.ex = ex
        return (carry, *ex._rotate(tensors, 1))

    @staticmethod
    def backward(ctx, g_carry, *grads):
        # every rank runs this; a block that went unused has a zero cotangent
        return (None, g_carry, *ctx.ex._rotate(grads, -1))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ex, x, split_dim, concat_dim):
        ctx.ex, ctx.dims = ex, (split_dim, concat_dim)
        return ex._all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return None, ctx.ex._all_to_all(g.contiguous(), concat_dim, split_dim), None, None


def ring_attention(q, k, v, group: GroupExchange, causal: bool = False,
                   sm_scale: Optional[float] = None, impl: Optional[str] = None):
    """Exact attention over a sequence sharded across ``group``'s ring
    (module docstring): ``q, k, v`` this rank's ``[B, S/n, H, D]``;
    ``impl``: ``None`` (flash on the card under JAX's gate), ``"flash"`` or
    ``"xla"`` (the plain inner)."""
    return _drive(ring_attention_loop(q, k, v, group.size, group.rank, causal, sm_scale, impl),
                  group)


def ulysses_attention(q, k, v, group: GroupExchange, causal: bool = False,
                      sm_scale: Optional[float] = None, impl: Optional[str] = None):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses, module
    docstring) over ``group``; heads must divide by its size."""
    return _drive(ulysses_attention_loop(q, k, v, group.size, causal, sm_scale, impl), group)
