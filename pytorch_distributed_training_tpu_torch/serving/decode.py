"""Autoregressive generation over the TransformerLM KV caches.

Port of the JAX package's ``serving/decode.py``: ``build_generate_fn``
(the batcher's whole-batch path over a contiguous cache) and
``build_paged_fns`` (the continuous scheduler's calls over the paged pool).

``build_generate_fn``, two phases, timed apart by the engine:

- ``prefill``: one pass over the right-padded prompt batch fills cache rows
  ``[0, S)`` and samples generated token 0 from each row's logits at its
  last REAL position, ``prompt_len - 1``.  Only those rows go through the
  final LayerNorm and the head: the other positions' logits are never
  read, and each row's are computed alone, so the result is the same.
- ``decode``: single-token steps (with ``quant``: over the int8 weights,
  dequantized once a call).  Step ``i`` feeds token ``i - 1`` at
  position ``prompt_len + i - 1`` and samples token ``i``; a row that is
  done emits 0 and stops counting (``gen_len``), and
  ``done |= eos | pos + 1 >= max_len``.  The loop stops early once every
  row is done.  Without an ``eos_id`` that is known on the host, so the
  loop never waits on the device for it.

``build_paged_fns`` (JAX ``:289-430``): ``prefill``, ``decode_step``,
``decode_step_fed``, ``verify``, ``copy_rows`` and ``init_pool`` over a
:class:`..ops.attention.PagedKVCache` that every call writes in place.
Every input is fixed-width (inactive rows ride along at position -1), and
each sampling call returns one device tensor ``[2, B]``: the sampled
tokens and a per-row flag that every logit the row sampled from is finite
(the serving NaN guard), so the host reads both in one copy.  ``verify``
and ``copy_rows`` serve speculative decoding.

The decode modes: ``adapter_ids`` [B] (-1: the base model) reach a model
built with LoRA factors on every call; ``quant`` (the int8 ``state_dict``
of :func:`..ops.quant.quantize_tree`) makes ``decode_step``,
``decode_step_fed`` and the batcher's ``decode`` run over
``q * s``, dequantized at each call into the Denses' dtypes
(``torch.func.functional_call`` swaps them in); ``prefill`` and
``verify`` keep the plain weights, as in the JAX package.  The swap acts
on a private copy of the module tree (:func:`private_modules`) that
shares every tensor with the model, so a fleet's replicas, which serve
one model from several threads, never see each other's swapped weights.

Sampling, one rule for both paths (:func:`token_seeds`,
:func:`sample_tokens`): greedy ``argmax`` at temperature 0 (first maximum
on ties, as ``jnp.argmax``).  Otherwise generated token ``i`` of a request
whose key is ``k`` (a tuple of non-negative ints) is
``argmax(logits / T + g)``, ``g`` a Gumbel draw over the vocabulary made by
a counter-based hash of the 64 bits that ``SeedSequence(k + [i])`` gives
and of each vocabulary index.  A draw depends only on the key, ``i`` and
the row's logits, never on the batch it rides in, so the scheduler (rows
re-batched every step, async or sync, replayed after a restart) repeats
the whole-batch path.  Row ``r`` of a batcher call with seed ``s`` has key
``s + [r]``.  The stream cannot equal the JAX package's, which folds PRNG
keys.
"""
from __future__ import annotations

import copy
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch.func import functional_call

from ..ops.attention import KVCache
from ..ops.quant import dequantize_tree, is_quantized_leaf

__all__ = ["GenerateFn", "PagedFns", "build_generate_fn", "build_paged_fns", "private_modules",
           "sample_tokens", "token_seeds"]

_MASK32 = 0xFFFFFFFF


def token_seeds(keys: Sequence[Optional[Sequence[int]]], index: Sequence[int]) -> np.ndarray:
    """``[B, 2]`` int64: the two 32-bit words of ``SeedSequence(key +
    [index])`` for each row (zeros for a row whose key is ``None``)."""
    out = np.zeros((len(keys), 2), np.int64)
    for r, (key, i) in enumerate(zip(keys, index)):
        if key is not None:
            entropy = [int(x) for x in key] + [int(i)]
            out[r] = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return out


def _mul32(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` in ``[0, 2^32)`` without int64
    overflow: the product is taken in two 16-bit halves of ``x``."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x):
    """A 32-bit integer finaliser (lowbias32): every input bit reaches every
    output bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel(seeds: torch.Tensor, vocab: int) -> torch.Tensor:
    """``[B, vocab]`` f32 standard Gumbel draws, a counter-based hash of each
    row's two seed words (``seeds`` [B, 2] int64) and the vocabulary index;
    the same numbers on any device up to the rounding of ``log``."""
    v = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    h = _mix32(_mul32(v[None, :], 0x9E3779B1) ^ seeds[:, :1])
    h = _mix32(h ^ seeds[:, 1:])
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def private_modules(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model``'s module tree that shares every parameter and
    buffer with it: ``functional_call`` on the copy swaps the copy's
    attributes, never ``model``'s, and costs no weight memory."""
    memo = {id(t): t for t in (*model.parameters(), *model.buffers())}
    return copy.deepcopy(model, memo)


def quant_dtypes(model, quant) -> Dict[str, torch.dtype]:
    """The compute dtype of the Dense owning each quantized weight."""
    return {name: model.get_submodule(name.rsplit(".", 1)[0]).dtype
            for name, node in quant.items() if is_quantized_leaf(node)}


def sample_tokens(logits: torch.Tensor, temperature: float,
                  seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[B]`` int64: greedy ``argmax`` at temperature 0 (first maximum),
    else the Gumbel-max draw of each row with its seed words."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(logits.float() / temperature + gumbel(seeds, logits.shape[-1]), dim=-1)


class _Carry(NamedTuple):
    cache: KVCache
    tok: torch.Tensor  # [B] last sampled token
    out: torch.Tensor  # [B, max_new] generated tokens, 0 past gen_len
    done: torch.Tensor  # [B] bool
    gen_len: torch.Tensor  # [B]
    keys: Optional[List[List[int]]]  # each row's sampling key; None when greedy


class GenerateFn:
    """``prefill`` + ``decode`` pair; ``__call__`` chains them.

    ``tokens`` [B, S] and ``prompt_len`` [B] (1 <= len <= S) are host
    integer arrays; the result is ``(out_tokens [B, max_new_tokens],
    gen_len [B])`` as numpy int32, tokens past ``gen_len`` 0.
    """

    def __init__(self, model, max_new_tokens: int, temperature: float,
                 eos_id: Optional[int], quant=None):
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_id = eos_id
        self.quant = quant
        self._qdtypes = quant_dtypes(model, quant) if quant is not None else None
        self._qmodel = private_modules(model) if quant is not None else None

    @property
    def device(self) -> torch.device:
        return self.model.tok_embedding.device

    def _row_keys(self, seed, batch: int) -> Optional[List[List[int]]]:
        if self.temperature == 0.0:
            return None
        entropy = [int(s) for s in np.atleast_1d(seed)]
        return [entropy + [row] for row in range(batch)]

    def _sample(self, logits, keys, index: int):
        seeds = None
        if keys is not None:
            seeds = torch.from_numpy(token_seeds(keys, [index] * len(keys))).to(self.device)
        return sample_tokens(logits, self.temperature, seeds)

    def _hit_eos(self, tok):
        if self.eos_id is None:
            return torch.zeros_like(tok, dtype=torch.bool)
        return tok == self.eos_id

    @torch.inference_mode()
    def prefill(self, tokens, prompt_len, seed: Union[int, Sequence[int]] = 0) -> _Carry:
        b, s = tokens.shape
        max_len = self.model.max_len
        if s + self.max_new_tokens > max_len:
            raise ValueError(
                f"seq bucket {s} + max_new_tokens {self.max_new_tokens} exceeds "
                f"max_len {max_len}"
            )
        dev = self.device
        tok_d = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
        plen = torch.as_tensor(np.asarray(prompt_len), dtype=torch.long, device=dev)
        cache = self.model.new_cache(b, dev)
        x = self.model.trunk(tok_d, cache)
        last = self.model.logits(x[torch.arange(b, device=dev), plen - 1])  # [B, V]
        keys = self._row_keys(seed, b)
        tok = self._sample(last, keys, 0)
        out = torch.zeros((b, self.max_new_tokens), dtype=torch.long, device=dev)
        out[:, 0] = tok
        gen_len = torch.ones((b,), dtype=torch.long, device=dev)
        return _Carry(cache, tok, out, self._hit_eos(tok), gen_len, keys)

    @torch.inference_mode()
    def decode(self, prompt_len, carry: _Carry):
        cache, prev, out, done, gen_len, keys = carry
        max_len = self.model.max_len
        plen_host = np.asarray(prompt_len, dtype=np.int64)
        plen = torch.as_tensor(plen_host, device=self.device)
        step = self.model
        if self.quant is not None:
            deq = dequantize_tree(self.quant, self._qdtypes)

            def step(*args):
                return functional_call(self._qmodel, deq, args)
        for i in range(1, self.max_new_tokens):
            if self.eos_id is None:
                # done comes only from the length bound, known here
                if (plen_host + i - 1 >= max_len).all():
                    break
            elif bool(done.all()):
                break
            # prev = generated token i-1, at position prompt_len + i - 1
            pos = plen + (i - 1)
            step_pos = torch.clamp(pos, max=max_len - 1)
            cache.live_len = min(int(plen_host.max()) + i - 1, max_len - 1) + 1
            logits, cache = step(prev[:, None], cache, step_pos)
            tok = self._sample(logits[:, 0], keys, i)
            out[:, i] = torch.where(done, torch.zeros_like(tok), tok)
            gen_len += (~done).long()
            done = done | self._hit_eos(tok) | (pos + 1 >= max_len)
            prev = tok
        return (
            out.to(torch.int32).cpu().numpy(),
            gen_len.to(torch.int32).cpu().numpy(),
        )

    def __call__(self, tokens, prompt_len, seed: Union[int, Sequence[int]] = 0):
        return self.decode(prompt_len, self.prefill(tokens, prompt_len, seed))


def build_generate_fn(model, max_new_tokens: int, temperature: float = 0.0,
                      eos_id: Optional[int] = None, quant=None) -> GenerateFn:
    """``generate(tokens, prompt_len, seed) -> (out_tokens, gen_len)`` over
    ``model`` (a :class:`..models.transformer_lm.TransformerLM`); ``quant``:
    the int8 ``state_dict`` the decode phase reads."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    return GenerateFn(model, max_new_tokens, float(temperature), eos_id, quant)


class PagedFns:
    """The paged calls of the continuous scheduler (JAX ``_PagedFns``).

    ``prefill(pool, tokens, positions, block_tables, last_col, keys,
    gen_index, adapter_ids)``: scatter the suffix K/V into ``pool`` and
    sample each row's token ``gen_index[r]`` from the logits at column
    ``last_col[r]`` (only that column goes through the final LayerNorm and
    the head).  ``decode_step(pool, prev_tok, pos, block_tables, keys,
    gen_index, adapter_ids)``: one single-token step for every slot.
    ``decode_step_fed(pool, prev_tok, fresh_mask, fresh_tok, pos,
    block_tables, keys, gen_index, adapter_ids)``: the async pipeline's
    twin; ``prev_tok`` is the previous step's token row on the device, and
    the rows the host knows better are spliced in with ``where(fresh_mask,
    fresh_tok, prev_tok)``.  Each returns ``[2, B]`` int64 on the device:
    tokens, then the finite flags (only active rows' flags mean anything:
    padding rows read stale rows).

    ``verify(pool, tokens, positions, block_tables, adapter_ids)``: the
    speculative round's scoring call, prefill-shaped (it scatters the fed
    tokens' K/V), returning every column's f32 logits ``[B, S, V]``; it
    takes the plain weights in ``quant`` mode too.  ``copy_rows(pool, src,
    dst)``: pool row ``src[i]`` copied to ``dst[i]`` in every layer's K and
    V; a ``dst`` outside the pool goes to the sink row (JAX drops it with
    ``mode="drop"``), a ``src`` outside it is clamped.

    Host inputs are numpy arrays (``keys``: one key or ``None`` a row;
    ``adapter_ids``: ``None``, or one id a row, read only by a model with
    LoRA factors), packed into one host array and copied to the device in
    one non-blocking copy, so a call never waits for the device.
    ``init_pool()``: the zeroed pool.  ``calls`` counts the calls of each
    kind (the port has no compile count).
    """

    def __init__(self, model, block_size: int, num_blocks: int, temperature: float,
                 quant=None):
        self.model = model
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.temperature = float(temperature)
        self.has_lora = getattr(model, "lora_adapters", 0) > 0
        self.quant = quant
        self._qdtypes = quant_dtypes(model, quant) if quant is not None else None
        self._qmodel = private_modules(model) if quant is not None else None
        self.calls = {"prefill": 0, "decode_step": 0, "decode_step_fed": 0, "verify": 0,
                      "copy_rows": 0}

    @property
    def device(self) -> torch.device:
        return self.model.tok_embedding.device

    def init_pool(self):
        return self.model.new_pool(self.num_blocks, self.block_size)

    def _upload(self, *arrays):
        """One host-to-device copy of int64 ``arrays``; views of each
        (``None`` for a ``None``)."""
        real = [a for a in arrays if a is not None]
        flat = np.concatenate([np.asarray(a, np.int64).reshape(-1) for a in real])
        dev = torch.from_numpy(flat).to(self.device, non_blocking=True)
        out, at = [], 0
        for a in arrays:
            if a is None:
                out.append(None)
                continue
            n = int(np.prod(np.shape(a)))
            out.append(dev[at:at + n].view(np.shape(a)))
            at += n
        return out

    def _aids(self, adapter_ids):
        """The ids to upload: only a model with LoRA factors reads them."""
        return adapter_ids if self.has_lora else None

    def _seeds(self, keys, gen_index):
        if self.temperature == 0.0:
            return np.zeros((len(keys), 2), np.int64)
        return token_seeds(keys, gen_index)

    def _sample(self, logits, seeds):
        tok = sample_tokens(logits, self.temperature, seeds)
        return torch.stack([tok, torch.isfinite(logits).all(dim=-1).long()])

    @torch.inference_mode()
    def prefill(self, pool, tokens, positions, block_tables, last_col, keys, gen_index,
                adapter_ids=None):
        self.calls["prefill"] += 1
        tok, pos, tables, last, seeds, aids = self._upload(
            tokens, positions, block_tables, last_col, self._seeds(keys, gen_index),
            self._aids(adapter_ids))
        x = self.model.trunk(tok, pool, pos, tables, aids)
        rows = torch.arange(x.shape[0], device=x.device)
        return self._sample(self.model.logits(x[rows, last]), seeds)

    def _step(self, pool, prev, pos, tables, seeds, aids):
        args = (prev[:, None], pool, pos[:, None], tables, aids)
        if self.quant is None:
            logits, _ = self.model(*args)
        else:
            deq = dequantize_tree(self.quant, self._qdtypes)
            logits, _ = functional_call(self._qmodel, deq, args)
        return self._sample(logits[:, 0], seeds)

    @torch.inference_mode()
    def decode_step(self, pool, prev_tok, pos, block_tables, keys, gen_index, adapter_ids=None):
        self.calls["decode_step"] += 1
        prev, pos, tables, seeds, aids = self._upload(
            prev_tok, pos, block_tables, self._seeds(keys, gen_index), self._aids(adapter_ids))
        return self._step(pool, prev, pos, tables, seeds, aids)

    @torch.inference_mode()
    def decode_step_fed(self, pool, prev_tok, fresh_mask, fresh_tok, pos, block_tables, keys,
                        gen_index, adapter_ids=None):
        self.calls["decode_step_fed"] += 1
        mask, fresh, pos, tables, seeds, aids = self._upload(
            fresh_mask, fresh_tok, pos, block_tables, self._seeds(keys, gen_index),
            self._aids(adapter_ids))
        prev = torch.where(mask.bool(), fresh, prev_tok)
        return self._step(pool, prev, pos, tables, seeds, aids)

    @torch.inference_mode()
    def verify(self, pool, tokens, positions, block_tables, adapter_ids=None):
        self.calls["verify"] += 1
        tok, pos, tables, aids = self._upload(tokens, positions, block_tables,
                                              self._aids(adapter_ids))
        return self.model.logits(self.model.trunk(tok, pool, pos, tables, aids)).float()

    @torch.inference_mode()
    def copy_rows(self, pool, src, dst):
        self.calls["copy_rows"] += 1
        src, dst = self._upload(src, dst)
        rows = pool.pool_rows
        src = src.clamp(0, rows - 1)
        # out-of-range destinations land on the sink row, which nothing reads
        dst = torch.where((dst >= 0) & (dst < rows), dst, rows)
        for t in pool.keys + pool.values:
            t[dst] = t[src]


def build_paged_fns(model, block_size: int, num_blocks: int,
                    temperature: float = 0.0, quant=None) -> PagedFns:
    """The paged call set over a pool of ``num_blocks`` x ``block_size``
    rows a layer.  Shapes are the scheduler's contract: ``tokens`` and
    ``positions`` [B, S] (global positions, -1 padding), ``block_tables``
    [B, T] covering each row's whole reserved footprint, ``last_col``,
    ``gen_index``, ``adapter_ids`` [B].  ``quant``: the int8 ``state_dict``
    the decode steps read.  No ``eos_id``: the host stops requests, as in
    JAX."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if num_blocks < 1:
        raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    return PagedFns(model, block_size, num_blocks, temperature, quant)
