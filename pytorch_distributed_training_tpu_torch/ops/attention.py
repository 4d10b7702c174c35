"""Multi-head attention for the LM serving and training paths.

Port of ``pytorch_distributed_training_tpu/ops/attention.py``:

- the einsum path (``impl="xla"``, and ``impl=None``): scores in f32,
  masked with ``-inf``, softmax in f32, plain torch as in the JAX package;
  serving's prefill and the cache-less forward without ``flash`` run it;
- the flash path (``impl="flash"``): the hand-written kernels of
  :mod:`.flash_attention` (K2a forward, the K2c backward), masked with
  ``-1e30``;
- one decode step against a contiguous KV cache (:func:`decode_attention`);
- the paged path (:func:`paged_attention`, JAX ``:357-437``): prefill,
  prefix-hit chunked prefill and single-token decode against a shared
  block pool (:class:`PagedKVCache`) addressed through block tables, in
  plain torch as the JAX package's is plain jnp (no Pallas kernel).

Choosing flash: the JAX package runs its kernel when the step is inside
``shard_map`` (``ops/attention.py:34-55``), which is where its training
steps run and its serving does not.  The port makes that choice explicit:
``MultiHeadAttention(flash=True)`` (set by the trainer) takes the kernel
whenever the sequence length passes the JAX package's gate
(:func:`.flash_attention.flash_shapes_ok`: S >= 128, S % 128 == 0), the
einsum otherwise, as JAX does; a head dim the kernels are not built for
raises at construction.  Serving keeps ``flash=False``.

The qkv projection's output factors heads-major, ``(H, 3, hd)``, exactly
as the JAX module's (``ops/attention.py:269-275``): checkpoints converted
from the JAX tree keep their meaning.

Multi-LoRA (JAX ``:223-301``): ``lora_rank > 0`` gives the qkv and proj
Denses stacked low-rank factors for ``lora_adapters`` adapters
(``qkv_lora_a`` [N, dim, r], ``qkv_lora_b`` [N, r, 3 dim], ``proj_lora_a``,
``proj_lora_b``; A normal(0.02), B zeros, so a fresh adapter is a no-op),
and a call's ``adapter_ids`` [B] picks each row's adapter
(:func:`.lora.lora_delta`; -1 the base model).  Each delta is added after
its full Dense, cast to the Dense's dtype first.  The factors keep the
JAX einsum layout and stay f32.

Sequence parallelism (JAX ``:280-287``): with ``seq_axis`` set the
module's input is this rank's ``[B, S/n, E]`` shard of the sequence and
the cache-less forward runs ``seq_impl``, ``"ring"``
(:func:`..parallel.sequence.ring_attention`, the default) or
``"ulysses"`` (:func:`..parallel.sequence.ulysses_attention`), over the
sequence group whose exchange ``seq_axis`` is
(:attr:`..parallel.mesh.SPLayout.seq_exchange`).  ``flash`` picks each one's flash path under the gate above (the
ring on its local length, Ulysses on the whole sequence), the plain one
otherwise.  The decode and paged modes refuse ``seq_axis`` with the JAX
messages (``:311-312``, ``:375-376``).

Tensor parallelism (JAX ``parallel/tensor.py:23-25``): with a
``tensor_group`` of ``T`` ranks, qkv is column-parallel and proj
row-parallel (:class:`.layers.Dense`), and the module holds ``H / T``
heads.  The qkv output is heads-major, ``(H, 3, hd)``, so a contiguous
column slice holds whole heads with their q, k and v, and the cache-less
forward runs at ``[B, S, H / T, hd]`` (the flash kernels with ``flash``).
The decode, paged and LoRA modes refuse a tensor group (the JAX serving
path has no tensor parallelism).
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from ..parallel.mesh import resolve_seq_axis
from ..parallel.sequence import ring_attention, ulysses_attention
from .flash_attention import SUPPORTED_HEAD_DIMS, flash_attention, flash_shapes_ok
from .layers import Dense
from .lora import lora_delta

__all__ = ["KVCache", "MultiHeadAttention", "PagedKVCache", "decode_attention",
           "dot_product_attention", "paged_attention"]


def dot_product_attention(q, k, v, causal: bool = False, sm_scale: Optional[float] = None,
                          impl: Optional[str] = None):
    """Full attention ``[B, S, H, D] -> [B, S, H, D]``, out in q's dtype.

    ``impl="flash"`` runs the flash kernels (raising on shapes they do not
    take); ``None`` or ``"xla"`` the f32 einsum.
    """
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl not in (None, "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        n = s.shape[-1]
        mask = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


class KVCache:
    """Per-layer key and value tensors ``[B, cache_len, H, hd]``.

    The JAX module's ``"cache"`` variable collection made explicit: passed
    into the model and returned by it.  The port writes the new rows in
    place rather than returning fresh arrays (one cache per batch, no
    copy per step).  ``live_len`` is how many leading positions a decode
    step may attend to (the largest position written + 1); positions past
    it are masked in every row, so leaving them out is exact.  The decode
    loop sets it from the positions it already holds on the host.
    """

    def __init__(self, keys: List[torch.Tensor], values: List[torch.Tensor]):
        self.keys = keys
        self.values = values
        self.live_len = keys[0].shape[1]

    @classmethod
    def zeros(cls, depth: int, batch: int, cache_len: int, heads: int, head_dim: int,
              dtype, device) -> "KVCache":
        shape = (batch, cache_len, heads, head_dim)
        return cls(
            [torch.zeros(shape, dtype=dtype, device=device) for _ in range(depth)],
            [torch.zeros(shape, dtype=dtype, device=device) for _ in range(depth)],
        )


class PagedKVCache:
    """Per-layer key and value pools ``[num_blocks * block_size + 1, H, hd]``.

    The JAX module's ``k_pool``/``v_pool`` cache variables made explicit,
    in the compute dtype: block ``t`` of the pool holds rows ``[t * bs,
    (t + 1) * bs)``, and the host's :class:`..serving.kv_pool.PagedKVPool`
    decides which request owns which block.  The one row past the end is a
    sink: torch's scatter has no ``mode="drop"``, so the padding positions
    of a call (position -1) write there, never into a real row (row 0
    included).  No block table reaches it, so nothing reads it.  Written in
    place by every paged call.
    """

    def __init__(self, keys: List[torch.Tensor], values: List[torch.Tensor], block_size: int,
                 num_blocks: int):
        if block_size <= 0 or num_blocks <= 0:
            raise ValueError(f"paged mode needs kv_block_size/kv_num_blocks > 0, "
                             f"got {block_size}/{num_blocks}")
        self.keys = keys
        self.values = values
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)

    @property
    def pool_rows(self) -> int:
        """Rows that blocks address (the sink row not counted)."""
        return self.num_blocks * self.block_size

    @classmethod
    def zeros(cls, depth: int, num_blocks: int, block_size: int, heads: int, head_dim: int,
              dtype, device) -> "PagedKVCache":
        pool = cls([], [], block_size, num_blocks)  # checks the size before allocating
        shape = (num_blocks * block_size + 1, heads, head_dim)
        pool.keys = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(depth)]
        pool.values = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(depth)]
        return pool


def paged_attention(q, k, v, k_pool, v_pool, positions, block_tables, block_size: int):
    """Block-table gather attention against one layer's shared pool.

    ``positions`` [B, S] int64: each token's global position in its request
    (-1: a padding column).  ``block_tables`` [B, T] int64: the physical
    block holding logical block ``t`` of row ``b``.  This call's k/v are
    scattered at their physical rows first (padding to the sink row), then
    each row's whole logical sequence is gathered back through its table
    and keys are masked to ``key_pos <= q_pos``.  So one path serves cold
    prefill, prefix-hit chunked prefill (the suffix reads the shared
    prefix blocks) and S = 1 decode.  Dead gathered rows (past a row's
    length, or a padded table entry aliasing block 0) get -inf scores and
    zeroed values: ``0 * NaN`` would otherwise carry a NaN left in a
    recycled block into a row that never wrote it.  Scores, softmax and the
    weighted sum run in f32, as the JAX einsums do.
    """
    b, s, heads, head_dim = q.shape
    sink = k_pool.shape[0] - 1
    valid = positions >= 0
    safe = positions.clamp(min=0)
    blk = torch.gather(block_tables, 1, safe // block_size)  # [B, S]
    phys = torch.where(valid, blk * block_size + safe % block_size, sink).reshape(-1)
    k_pool[phys] = k.reshape(b * s, heads, head_dim).to(k_pool.dtype)
    v_pool[phys] = v.reshape(b * s, heads, head_dim).to(v_pool.dtype)
    length = block_tables.shape[1] * block_size
    offs = torch.arange(block_size, device=q.device)
    rows = ((block_tables * block_size)[:, :, None] + offs).reshape(b, length)
    ck, cv = k_pool[rows], v_pool[rows]  # [B, L, H, hd], in logical order
    scale = 1.0 / math.sqrt(head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float()) * scale
    # [B, S, L]; a padding query keeps key 0 live, so its softmax stays finite
    live = torch.arange(length, device=q.device)[None, None, :] <= safe[:, :, None]
    logits = logits.masked_fill(~live[:, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    # causal: a key live for any query of the row is live for its last one
    cv = torch.where(live.any(dim=1)[:, :, None, None], cv.float(), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, cv)
    return out.to(q.dtype)


def decode_attention(q, k, v, cached_key, cached_value, decode_pos=None, live_len=None):
    """Prefill or one decode step against a layer's KV cache.

    ``decode_pos=None`` is the prefill: the prompt's k/v land in cache rows
    ``[0, S)`` and attention is the ordinary causal one.  Right-padded rows
    write garbage k/v past their real length; each row's k/v depend only on
    that position's own token, and decode steps overwrite those rows before
    any query attends to them.

    ``decode_pos`` ([B] int64) is one step: each row's new k/v go to its own
    position, and q attends over the cache masked to ``<= decode_pos``.
    """
    b, s, heads, head_dim = q.shape
    cache_len = cached_key.shape[1]
    if decode_pos is None:
        if s > cache_len:
            raise ValueError(f"prompt length {s} exceeds cache_len {cache_len}")
        cached_key[:, :s] = k.to(cached_key.dtype)
        cached_value[:, :s] = v.to(cached_value.dtype)
        return dot_product_attention(q, k, v, causal=True)
    if s != 1:
        raise ValueError(f"decode step takes one token per row, got S={s}")
    rows = torch.arange(b, device=q.device)
    cached_key[rows, decode_pos] = k[:, 0].to(cached_key.dtype)
    cached_value[rows, decode_pos] = v[:, 0].to(cached_value.dtype)
    n = cache_len if live_len is None else live_len
    ck, cv = cached_key[:, :n], cached_value[:, :n]
    scale = 1.0 / math.sqrt(head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float()) * scale
    live = torch.arange(n, device=q.device)[None, :] <= decode_pos[:, None]  # [B, n]
    logits = logits.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, cv.float())
    return out.to(q.dtype)


class MultiHeadAttention(nn.Module):
    """QKV-projected multi-head attention (the JAX module's dense paths).

    ``flash``: run the cache-less forward through the flash kernels where
    the sequence length allows (see the module docstring).  ``paged`` is
    the JAX module's flag, taken for its signature: the mode is chosen per
    call, by passing a :class:`PagedKVCache` with per-token positions and
    block tables.  ``lora_rank``/``lora_adapters``: the stacked LoRA
    factors (see the module docstring).
    """

    def __init__(self, dim: int, num_heads: int, causal: bool = False, dtype=torch.float32,
                 seq_axis=None, paged: bool = False, lora_rank: int = 0,
                 flash: bool = False, lora_adapters: int = 0, seq_impl: str = "ring",
                 tensor_group=None):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(f"embed dim {dim} not divisible by {num_heads} heads")
        if tensor_group is not None:
            if num_heads % tensor_group.size != 0:
                raise ValueError(f"{num_heads} heads do not split over a tensor group of "
                                 f"{tensor_group.size}")
            if lora_rank > 0 or seq_axis is not None:
                raise ValueError("tensor parallelism takes no LoRA factors and no seq_axis")
        if lora_rank > 0 and lora_adapters < 1:
            raise ValueError(f"lora_rank {lora_rank} needs lora_adapters >= 1, "
                             f"got {lora_adapters}")
        if flash and dim // num_heads not in SUPPORTED_HEAD_DIMS:
            raise ValueError(f"flash attention takes head dims {SUPPORTED_HEAD_DIMS}, "
                             f"got {dim // num_heads}")
        self.tensor_group = tensor_group
        # this rank's heads
        self.num_heads = num_heads // (tensor_group.size if tensor_group is not None else 1)
        self.causal = causal
        self.flash = flash
        self.seq_axis, self.seq_impl = seq_axis, seq_impl
        self.dtype = dtype
        self.qkv = Dense(dim, 3 * dim, dtype, tensor_group, "column")
        self.proj = Dense(dim, dim, dtype, tensor_group, "row")
        self.lora_rank = int(lora_rank)
        if self.lora_rank > 0:
            n, r = int(lora_adapters), self.lora_rank
            self.qkv_lora_a = nn.Parameter(torch.empty(n, dim, r))
            self.qkv_lora_b = nn.Parameter(torch.empty(n, r, 3 * dim))
            self.proj_lora_a = nn.Parameter(torch.empty(n, dim, r))
            self.proj_lora_b = nn.Parameter(torch.empty(n, r, dim))
            self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The LoRA factors' initializers (the Denses reset themselves)."""
        if self.lora_rank > 0:
            with torch.no_grad():
                for a, b in ((self.qkv_lora_a, self.qkv_lora_b),
                             (self.proj_lora_a, self.proj_lora_b)):
                    if not a.is_meta:
                        a.normal_(0.0, 0.02, generator=generator)
                        b.zero_()

    def forward(self, x, cache=None, layer: int = 0, decode_pos=None, block_tables=None,
                adapter_ids=None):
        b, s, _ = x.shape
        head_dim = self.proj.weight.shape[1] // self.num_heads
        if self.tensor_group is not None and (cache is not None or decode_pos is not None):
            raise ValueError("decode and paged modes are single-shard (tensor_group must be "
                             "None)")
        if adapter_ids is not None and self.lora_rank <= 0:
            raise ValueError("adapter_ids given but the module has no LoRA factors "
                             "(lora_rank is 0)")
        qkv = self.qkv(x)
        if adapter_ids is not None:
            qkv = qkv + lora_delta(x, self.qkv_lora_a, self.qkv_lora_b,
                                   adapter_ids).to(qkv.dtype)
        # heads-major: the flat 3*dim output factors as (H, 3, hd)
        qkv = qkv.reshape(b, s, self.num_heads, 3, head_dim)
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
        if cache is not None and self.seq_axis is not None:
            # JAX :311-312, :375-376
            mode = "paged decode" if isinstance(cache, PagedKVCache) else "decode mode"
            raise ValueError(f"{mode} is single-shard (seq_axis must be None)")
        if isinstance(cache, PagedKVCache):
            if not self.causal:
                raise ValueError("paged decode requires causal attention")
            if decode_pos is None or block_tables is None:
                raise ValueError("paged mode needs positions and block_tables")
            out = paged_attention(q, k, v, cache.keys[layer], cache.values[layer], decode_pos,
                                  block_tables, cache.block_size)
        elif cache is not None:
            if not self.causal:
                raise ValueError("decode mode requires causal attention")
            out = decode_attention(
                q, k, v, cache.keys[layer], cache.values[layer], decode_pos,
                cache.live_len,
            )
        elif decode_pos is not None:
            raise ValueError("decode_pos given without a KV cache")
        elif self.seq_axis is None:
            impl = "flash" if self.flash and flash_shapes_ok(s) else "xla"
            out = dot_product_attention(q, k, v, causal=self.causal, impl=impl)
        else:
            out = self._sequence_parallel(q, k, v)
        out = out.reshape(b, s, self.num_heads * head_dim)
        proj = self.proj(out)
        if adapter_ids is not None:
            proj = proj + lora_delta(out, self.proj_lora_a, self.proj_lora_b,
                                     adapter_ids).to(proj.dtype)
        return proj

    def _sequence_parallel(self, q, k, v):
        """Ring or Ulysses attention over the sequence group (JAX ``:284-289``)."""
        group = resolve_seq_axis(self.seq_axis)
        if self.seq_impl == "ring":
            impl = "flash" if self.flash and flash_shapes_ok(q.shape[1]) else "xla"
            return ring_attention(q, k, v, group, causal=self.causal, impl=impl)
        if self.seq_impl == "ulysses":
            impl = "flash" if self.flash and flash_shapes_ok(q.shape[1] * group.size) else "xla"
            return ulysses_attention(q, k, v, group, causal=self.causal, impl=impl)
        raise ValueError(f"unknown seq_impl {self.seq_impl!r}")
