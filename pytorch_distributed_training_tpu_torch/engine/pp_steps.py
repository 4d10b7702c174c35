"""The pipeline-parallel LM training and evaluation steps (port of
``engine/pp_steps.py``).

The JAX step is one ``shard_map`` program over a ``(data, stage)`` mesh:
the decoder blocks are stacked and split over ``stage``, microbatches flow
through the stages tick by tick, and one ``ppermute`` a tick moves the
activations to the next stage.  Here each rank is one process (one card)
holding one stage's view of the LM (:class:`..models.TransformerLM` with
``stage_group``; :class:`..parallel.mesh.PPLayout`): stage 0 embeds, every
stage runs its blocks, the last stage runs the final LayerNorm, the head
and the fused CE.  The hops are :class:`..parallel.pipeline.StageExchange`
calls that post a tick's sends and receives together; every rank derives
them from the same static tables, so they pair up, and only the live hops
the tables name are sent.

Two schedules (``training.pp_schedule``), over ``M`` microbatches of the
local batch (``training.microbatches``, default the stage count):

- ``gpipe`` (JAX ``:283-370``, tables :func:`schedule`): ``M + S - 1``
  ticks; at tick ``t`` stage ``s`` runs microbatch ``t - s``.  One autograd
  graph spans the microbatches: each tick's hop is an autograd Function
  whose backward is the reverse hop (the activation's cotangent travels
  back to the stage that sent it), and a carry threaded through every hop
  orders their backwards alike on every rank.  Each microbatch's
  activations live until the backward (``O(M)``);
- ``1f1b`` (JAX ``:116-204``, ``:372-518``, tables :func:`sim_1f1b` and
  :func:`receive_tables`): the event-simulated tick table; each tick has an
  F slot and a B slot.  An F slot runs the stage forward under
  ``no_grad`` (the last stage also runs the head and takes the loss there);
  a B slot recomputes the stage from its saved input with autograd and
  seeds the backward with the cotangent received from the next stage (the
  last stage: its loss, seed 1).  Gradients add into the f32 parameters'
  ``.grad`` (the f32 ``gacc`` of JAX ``:516``); only ``O(S)`` stage inputs
  are held.  The tick's sends (the activation forward, the input's
  cotangent back) go after both slots.

The objective is the global mean CE: each microbatch's partial loss is
:func:`.sp_steps.lm_loss_local` over ``b_local x seq x n_data`` tokens.
After the schedule the shared leaves' gradients (the embeddings' are stage
0's, the head's the last stage's) are summed over the stage group with the
loss, then every gradient and the loss over the data group, the sums JAX's
transposes take; the replicas of the shared leaves stay equal.  Then the
optimizer runs on this rank's leaves, with the stacked-layout rules of
:mod:`..optimizers` (``excluded``; LAMB's norms over each stack).

The eval step (JAX ``:644-760``) runs the GPipe ticks forward only; a
local batch that ``M`` does not divide falls back to ``gcd(M, batch)``
microbatches with a warning, once a batch size.  Every stage returns the
same reduced ``(loss, acc1, acc5)``.
"""
from __future__ import annotations

import logging
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..optimizers import LAMB, AdamW
from ..parallel.pipeline import block_index
from .sp_steps import LMTrainStep, _all_reduce_sum_, _grad, _nbytes, lm_loss_local

__all__ = ["PPLMTrainStep", "build_pp_lm_eval_step", "build_pp_lm_train_step",
           "receive_tables", "schedule", "sim_1f1b"]

SCHEDULES = ("gpipe", "1f1b")


def sim_1f1b(n_micro: int, n_stages: int):
    """Static 1F1B (PipeDream-Flush) tick schedule, event-simulated (JAX
    ``_sim_1f1b``, ``pp_steps.py:116-204``): at each tick a stage runs its
    next forward when the previous stage finished that microbatch at a
    strictly earlier tick and fewer than ``S - s`` are in flight, and its
    next backward when its own forward and the next stage's backward of that
    microbatch are done.  Returns ``(f_mb, f_on, b_mb, b_on, depth)``:
    ``[T, S]`` arrays (tick, stage) and the most intervals alive at once
    (the ring-buffer depth of JAX's activation buffers)."""
    M, S = int(n_micro), int(n_stages)
    fwd_done = [[-1] * M for _ in range(S)]
    bwd_done = [[-1] * M for _ in range(S)]
    next_f, next_b = [0] * S, [0] * S
    rows_f, rows_b = [], []
    t = 0
    while any(nb < M for nb in next_b):
        f_row, b_row = [], []
        for s in range(S):
            m = next_f[s]
            can_f = (m < M and (s == 0 or 0 <= fwd_done[s - 1][m] < t)
                     and (next_f[s] - next_b[s]) < (S - s))
            mb = next_b[s]
            can_b = (mb < M and 0 <= fwd_done[s][mb] < t
                     and (s == S - 1 or 0 <= bwd_done[s + 1][mb] < t))
            f_row.append((m if can_f else 0, can_f))
            b_row.append((mb if can_b else 0, can_b))
        for s in range(S):
            m, on = f_row[s]
            if on:
                fwd_done[s][m] = t
                next_f[s] += 1
            m, on = b_row[s]
            if on:
                bwd_done[s][m] = t
                next_b[s] += 1
        rows_f.append(f_row)
        rows_b.append(b_row)
        t += 1
        if t > 4 * (M + S) + 8:
            raise AssertionError("1F1B schedule simulation did not converge")

    def max_overlap(intervals):
        return max(sum(1 for a, c in intervals if a <= tick <= c) for tick in range(t + 1))

    depth = 1
    for s in range(S):
        arr = [((fwd_done[s - 1][m] if s else fwd_done[s][m]), bwd_done[s][m]) for m in range(M)]
        dy = [(bwd_done[s + 1][m], bwd_done[s][m]) for m in range(M)] if s < S - 1 else []
        sav = [(fwd_done[s][m], bwd_done[s][m]) for m in range(M)]
        depth = max(depth, max_overlap(arr), max_overlap(dy) if dy else 0, max_overlap(sav))

    def table(rows, k, dtype):
        return np.array([[r[s][k] for s in range(S)] for r in rows], dtype)

    return (table(rows_f, 0, np.int32), table(rows_f, 1, bool), table(rows_b, 0, np.int32),
            table(rows_b, 1, bool), depth)


def receive_tables(f_mb, f_on, b_mb, b_on):
    """What arrives at each (tick, stage) of a 1F1B table (JAX
    ``pp_steps.py:396-401``): the previous stage's F slot's activation and
    the next stage's B slot's cotangent; stage 0 receives no activation and
    the last stage no cotangent.  ``(fr_mb, fr_on, br_mb, br_on)``."""
    fr_mb, fr_on = np.roll(f_mb, 1, axis=1), np.roll(f_on, 1, axis=1)
    fr_on[:, 0] = False
    br_mb, br_on = np.roll(b_mb, -1, axis=1), np.roll(b_on, -1, axis=1)
    br_on[:, -1] = False
    return fr_mb, fr_on, br_mb, br_on


def schedule(n_micro: int, n_stages: int):
    """The GPipe tick table (JAX ``_schedule``, ``pp_steps.py:205-227``):
    ``(feed_idx, feed_valid, emit_idx, emit_valid)`` over ``M + S - 1``
    ticks; stage 0 takes microbatch ``t`` in, the last stage finishes
    microbatch ``t - (S - 1)``.  Stage ``s`` runs microbatch ``t - s``."""
    ticks = np.arange(n_micro + n_stages - 1)
    return (np.clip(ticks, 0, n_micro - 1).astype(np.int32), ticks < n_micro,
            np.clip(ticks - (n_stages - 1), 0, n_micro - 1).astype(np.int32),
            ticks >= n_stages - 1)


class _Hop(torch.autograd.Function):
    """One GPipe tick's hop: ``y`` (or ``None``) to the next stage, and an
    activation of shape ``recv`` (or ``None``) from the previous one; the
    backward is the reverse hop.  ``carry`` passes through, so the hops'
    backwards run in the reverse of their order on every rank."""

    @staticmethod
    def forward(ctx, ex, recv, carry, y):
        ctx.ex = ex
        ctx.received = recv is not None
        ctx.sent = None if y is None else (y.shape, y.dtype, y.device)
        x = None
        if ctx.received:
            shape, dtype, device = recv
            x = torch.empty(shape, dtype=dtype, device=device)
        ex.hop(send_next=y, recv_prev=x)
        return carry, (x if ctx.received else carry.new_empty(0))

    @staticmethod
    def backward(ctx, g_carry, g_x):
        dy = None
        if ctx.sent is not None:
            shape, dtype, device = ctx.sent
            dy = torch.empty(shape, dtype=dtype, device=device)
        ctx.ex.hop(send_prev=g_x if ctx.received else None, recv_next=dy)
        return None, None, g_carry, dy


class PPLMTrainStep(LMTrainStep):
    """One pipeline training iteration of this rank's stage:
    ``step(tokens, labels) -> loss`` (the global mean, equal on every rank).
    ``tokens``/``labels`` are the data rank's ``[B_local, S]`` batch, the
    same on every stage of a pipeline.  ``exchange`` is the stage group's
    :class:`..parallel.pipeline.StageExchange`; ``world_size``/``group`` the
    data group's (see the module docstring)."""

    def __init__(self, model, optimizer, lr_fn: Callable[[int], float], exchange,
                 num_microbatches: int, schedule: str = "gpipe", world_size: int = 1,
                 group=None, label_smoothing: float = 0.0):
        m = int(num_microbatches)
        if m < 1:
            raise ValueError(f"num_microbatches must be >= 1, got {m}")
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        self.ex, self.n_micro, self.schedule = exchange, m, schedule
        self.n_stage, self.stage_idx = exchange.size, exchange.rank
        super().__init__(model, optimizer, lr_fn, world_size, group, label_smoothing)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        leaves = [None if block_index(n) is None else n.split(".", 1)[1] for n in names]
        self._shared = [leaf is None for leaf in leaves]
        # JAX's stacked layout: a block leaf has rank >= 2 there (never excluded)
        self._excluded = [sh and p.dim() <= 1 for sh, p in zip(self._shared, self.params)]
        # the stack of each block leaf (LAMB's norms), -1 for a shared leaf
        keys = sorted(set(leaf for leaf in leaves if leaf is not None))
        self._stack = [-1 if leaf is None else keys.index(leaf) for leaf in leaves]

    def __call__(self, tokens, labels):
        b_local, seq = tokens.shape
        if b_local % self.n_micro != 0:
            raise ValueError(f"per-shard batch {b_local} not divisible by num_microbatches "
                             f"{self.n_micro}")
        if seq > self.model.max_len:
            raise ValueError(f"global sequence {seq} exceeds max_len {self.model.max_len}")
        global_tokens = b_local * seq * self.world_size
        tok = tokens.reshape(self.n_micro, -1, seq)
        lab = labels.reshape(self.n_micro, -1, seq)
        for p in self.params:
            p.grad = None
        run = self._gpipe if self.schedule == "gpipe" else self._one_f_one_b
        loss = run(tok, lab, global_tokens)
        grads = self.reduce_grads(loss)
        self.update(grads, self.lr_fn(self.opt_state.step))
        for p in self.params:
            p.grad = None
        return loss

    def _act(self, tok):
        """The shape, dtype and device of a microbatch's activation."""
        return ((tok.shape[1], tok.shape[2], self.model.embed_dim), self.model.dtype,
                tok.device)

    def _head_loss(self, y, lab, global_tokens: int):
        return lm_loss_local(self.model.logits(y), lab, global_tokens, self.label_smoothing)

    def _gpipe(self, tok, lab, global_tokens: int):
        model, s, n, m_count = self.model, self.stage_idx, self.n_stage, self.n_micro
        last = s == n - 1
        shape, dtype, device = self._act(tok)
        carry = torch.zeros((), device=device, requires_grad=True)
        loss = torch.zeros((), device=device)
        xs = {}
        for t in range(m_count + n - 1):
            m, y = t - s, None
            if 0 <= m < m_count:
                y = model.run_blocks(model.embed(tok[m]) if s == 0 else xs.pop(m))
                if last:
                    loss = loss + self._head_loss(y, lab[m], global_tokens)
            nxt = t + 1 - s
            recv = (shape, dtype, device) if s > 0 and 0 <= nxt < m_count else None
            carry, x = _Hop.apply(self.ex, recv, carry, None if last else y)
            if recv is not None:
                xs[nxt] = x
        (loss + carry * 0).backward()
        return loss.detach()

    def _one_f_one_b(self, tok, lab, global_tokens: int):
        model, s, n = self.model, self.stage_idx, self.n_stage
        last = s == n - 1
        f_mb, f_on, b_mb, b_on, _ = sim_1f1b(self.n_micro, n)
        fr_mb, fr_on, br_mb, br_on = receive_tables(f_mb, f_on, b_mb, b_on)
        shape, dtype, device = self._act(tok)
        xbuf, dybuf, saved = {}, {}, {}
        loss = torch.zeros((), device=device)
        for t in range(f_mb.shape[0]):
            send_y = send_dx = None
            if f_on[t, s]:
                m = int(f_mb[t, s])
                with torch.no_grad():
                    x = model.embed(tok[m]) if s == 0 else xbuf.pop(m)
                    if s > 0:
                        saved[m] = x
                    y = model.run_blocks(x)
                    if last:
                        loss += self._head_loss(y, lab[m], global_tokens)
                    else:
                        send_y = y
            if b_on[t, s]:
                m = int(b_mb[t, s])
                x = None if s == 0 else saved.pop(m).requires_grad_()
                y = model.run_blocks(model.embed(tok[m]) if s == 0 else x)
                if last:
                    self._head_loss(y, lab[m], global_tokens).backward()
                else:
                    y.backward(dybuf.pop(m))
                del y
                if s > 0:
                    send_dx = x.grad
            recv_x = (torch.empty(shape, dtype=dtype, device=device) if fr_on[t, s] else None)
            recv_dy = (torch.empty(shape, dtype=dtype, device=device) if br_on[t, s] else None)
            self.ex.hop(send_next=send_y, send_prev=send_dx, recv_prev=recv_x, recv_next=recv_dy)
            if recv_x is not None:
                xbuf[int(fr_mb[t, s])] = recv_x
            if recv_dy is not None:
                dybuf[int(br_mb[t, s])] = recv_dy
        return loss

    def reduce_grads(self, loss):
        """The shared leaves' gradients and the loss summed over the stage
        group, then every gradient and the loss over the data group."""
        grads = [_grad(p) for p in self.params]
        self.grad_bytes = _nbytes(grads)
        shared = [g for g, sh in zip(grads, self._shared) if sh]
        _all_reduce_sum_(shared + [loss.reshape(1)], self.ex.group)
        if self.world_size > 1:
            _all_reduce_sum_(grads + [loss.reshape(1)], self.group)
        return grads

    def update(self, grads, lr) -> None:
        kw = {}
        if isinstance(self.optimizer, (AdamW, LAMB)):
            kw["excluded"] = self._excluded
        if isinstance(self.optimizer, LAMB):
            kw["whole_norms"] = self._stack_norms
        self.opt_state = self.optimizer.update(self.params, grads, self.opt_state, lr, **kw)

    def _stack_norms(self, norms, idx):
        """LAMB's norms over JAX's stacked leaves: the norms ``[k, len(idx)]``
        of the leaves ``idx`` combined over each stack's layers."""
        stack = [self._stack[i] for i in idx]
        if all(k < 0 for k in stack):
            return norms
        ids = torch.tensor([max(k, 0) for k in stack], device=norms.device)
        stacked = torch.tensor([k >= 0 for k in stack], device=norms.device)
        sums = norms.new_zeros(norms.shape[0], max(stack) + 1)
        sums.index_add_(1, ids, torch.where(stacked, norms.square(), 0.0))
        return torch.where(stacked, sums[:, ids].sqrt(), norms)


def build_pp_lm_train_step(model, optimizer, lr_fn: Callable[[int], float], exchange,
                           num_microbatches: int, schedule: str = "gpipe", world_size: int = 1,
                           group=None, label_smoothing: float = 0.0) -> PPLMTrainStep:
    """The pipeline training step of one rank's stage (module docstring)."""
    return PPLMTrainStep(model, optimizer, lr_fn, exchange, num_microbatches, schedule,
                         world_size, group, label_smoothing)


def build_pp_lm_eval_step(model, exchange, num_microbatches: int, world_size: int = 1,
                          group=None, logger: Optional[logging.Logger] = None):
    """``eval_step(tokens, labels) -> (loss, acc1, acc5)`` over the pipeline:
    the GPipe ticks forward only, the mean CE a token and the top-1/top-5
    accuracy in percent, summed over the stage group and the ``world_size``
    data ranks of ``group`` (module docstring)."""
    logger = logger or logging.getLogger(__name__)
    s, n, m_cfg = exchange.rank, exchange.size, int(num_microbatches)
    last = s == n - 1
    warned = set()

    @torch.no_grad()
    def eval_step(tokens, labels):
        b_local, seq = tokens.shape
        m_count = math.gcd(m_cfg, b_local)
        if m_count != m_cfg and b_local not in warned:
            warned.add(b_local)
            logger.warning("pp eval: per-shard tail batch %d not divisible by microbatches %d; "
                           "falling back to M=%d for this batch", b_local, m_cfg, m_count)
        if seq > model.max_len:
            raise ValueError(f"global sequence {seq} exceeds max_len {model.max_len}")
        global_tokens = b_local * seq * world_size
        tok = tokens.reshape(m_count, -1, seq)
        lab = labels.reshape(m_count, -1, seq)
        shape = (tok.shape[1], seq, model.embed_dim)
        sums = torch.zeros(3, device=tokens.device)
        xs = {}
        for t in range(m_count + n - 1):
            m, y = t - s, None
            if 0 <= m < m_count:
                y = model.run_blocks(model.embed(tok[m]) if s == 0 else xs.pop(m))
                if last:
                    logits = model.logits(y)
                    flat, flab = logits.reshape(-1, logits.shape[-1]), lab[m].reshape(-1)
                    top5 = flat.topk(5, dim=-1).indices
                    sums[0] += lm_loss_local(logits, lab[m], global_tokens)
                    sums[1] += (top5[:, 0] == flab).sum()
                    sums[2] += (top5 == flab[:, None]).any(dim=1).sum()
                    del logits, flat
            nxt = t + 1 - s
            recv = (torch.empty(shape, dtype=model.dtype, device=tokens.device)
                    if s > 0 and 0 <= nxt < m_count else None)
            exchange.hop(send_next=None if last else y, recv_prev=recv)
            if recv is not None:
                xs[nxt] = recv
        _all_reduce_sum_([sums], exchange.group)
        if world_size > 1:
            _all_reduce_sum_([sums], group)
        return sums[0], sums[1] / global_tokens * 100.0, sums[2] / global_tokens * 100.0

    return eval_step
