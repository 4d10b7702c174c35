"""Autoregressive generation over the TransformerLM KV cache.

Port of ``build_generate_fn`` of the JAX package's ``serving/decode.py``.
Two phases, timed apart by the engine:

- ``prefill``: one pass over the right-padded prompt batch fills cache rows
  ``[0, S)`` and samples generated token 0 from each row's logits at its
  last REAL position, ``prompt_len - 1``.  Only those rows go through the
  final LayerNorm and the head: the other positions' logits are never
  read, and each row's are computed alone, so the result is the same.
- ``decode``: single-token steps.  Step ``i`` feeds token ``i - 1`` at
  position ``prompt_len + i - 1`` and samples token ``i``; a row that is
  done emits 0 and stops counting (``gen_len``), and
  ``done |= eos | pos + 1 >= max_len``.  The loop stops early once every
  row is done.  Without an ``eos_id`` that is known on the host, so the
  loop never waits on the device for it.

Sampling: greedy ``argmax`` at temperature 0 (first maximum on ties, as
``jnp.argmax``).  Otherwise each row draws from ``softmax(logits / T)``
with its own ``torch.Generator``, seeded from the call's seed and the row
index: a row's stream depends only on its own generator and logits, and
repeats for a seed.  It cannot match the JAX package's, which folds PRNG
keys per token.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.attention import KVCache

__all__ = ["GenerateFn", "build_generate_fn"]


class _Carry(NamedTuple):
    cache: KVCache
    tok: torch.Tensor  # [B] last sampled token
    out: torch.Tensor  # [B, max_new] generated tokens, 0 past gen_len
    done: torch.Tensor  # [B] bool
    gen_len: torch.Tensor  # [B]
    generators: Optional[List[torch.Generator]]


class GenerateFn:
    """``prefill`` + ``decode`` pair; ``__call__`` chains them.

    ``tokens`` [B, S] and ``prompt_len`` [B] (1 <= len <= S) are host
    integer arrays; the result is ``(out_tokens [B, max_new_tokens],
    gen_len [B])`` as numpy int32, tokens past ``gen_len`` 0.
    """

    def __init__(self, model, max_new_tokens: int, temperature: float,
                 eos_id: Optional[int]):
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_id = eos_id

    @property
    def device(self) -> torch.device:
        return self.model.tok_embedding.device

    def _generators(self, seed, batch: int) -> Optional[List[torch.Generator]]:
        if self.temperature == 0.0:
            return None
        entropy = [int(s) for s in np.atleast_1d(seed)]
        gens = []
        for row in range(batch):
            state = np.random.SeedSequence(entropy + [row]).generate_state(1, np.uint64)[0]
            gens.append(torch.Generator(device=self.device).manual_seed(int(state)))
        return gens

    def _sample(self, logits, generators):
        if generators is None:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.cat([
            torch.multinomial(probs[r], 1, generator=g)
            for r, g in enumerate(generators)
        ])

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
        generators = self._generators(seed, b)
        tok = self._sample(last, generators)
        out = torch.zeros((b, self.max_new_tokens), dtype=torch.long, device=dev)
        out[:, 0] = tok
        gen_len = torch.ones((b,), dtype=torch.long, device=dev)
        return _Carry(cache, tok, out, self._hit_eos(tok), gen_len, generators)

    @torch.inference_mode()
    def decode(self, prompt_len, carry: _Carry):
        cache, prev, out, done, gen_len, generators = carry
        max_len = self.model.max_len
        plen_host = np.asarray(prompt_len, dtype=np.int64)
        plen = torch.as_tensor(plen_host, device=self.device)
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
            logits, cache = self.model(prev[:, None], cache, step_pos)
            tok = self._sample(logits[:, 0], generators)
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
                      eos_id: Optional[int] = None) -> GenerateFn:
    """``generate(tokens, prompt_len, seed) -> (out_tokens, gen_len)`` over
    ``model`` (a :class:`..models.transformer_lm.TransformerLM`)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    return GenerateFn(model, max_new_tokens, float(temperature), eos_id)
