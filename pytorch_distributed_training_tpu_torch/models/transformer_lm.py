"""Decoder-only transformer LM (port of ``models/transformer_lm.py``).

Dense blocks only, as the serving path runs them: pre-LN blocks of causal
multi-head attention and a GELU MLP, learned position embeddings, a final
LayerNorm and an f32 head over the compute-dtype stream.  Parameter names
mirror the flax tree (``block{i}.ln1``, ``block{i}.attn.qkv``, ...; see
:mod:`.from_jax`).

Decode mode is chosen per call, not by cloning: passing a
:class:`..ops.attention.KVCache` makes a call a prefill (no
``decode_pos``) or one decode step (``decode_pos`` [B], one token per row);
the cache is written in place and returned with the logits.  Passing a
:class:`..ops.attention.PagedKVCache` (:meth:`TransformerLM.new_pool`)
makes it a paged call (JAX ``:193-200``, ``:220-223``, ``:243-248``):
``decode_pos`` is then [B, S] per-token global positions (-1: padding; the
position embedding is read at the position clipped to ``[0, max_len)``)
and ``block_tables`` [B, T] maps each row's logical blocks to pool blocks,
so one code path serves cold prefill, prefix-hit chunked prefill and S = 1
decode.  The parameters are the same in every mode.

``fused_tails`` runs the residual-add + ln2 pair and fc1's bias + GELU of
every block as the two hand-written kernels of
:mod:`..ops.fused_elementwise`; the parameters are the same either way.

``flash`` runs the cache-less forward's attention through the flash
kernels (:mod:`..ops.flash_attention`), as the JAX model does inside its
``shard_map`` training steps; the trainer sets it, serving does not.
Training keeps f32 master parameters: each Dense casts to its compute dtype
per call, so :meth:`TransformerLM.cast_matmul_weights_` is for serving only.

``remat`` is the JAX model's ``nn.remat(DecoderBlock, policy=...)``
(``models/transformer_lm.py:33-53``, ``:268-279``) through
``torch.utils.checkpoint`` (non-reentrant), one block at a time:

- ``remat_policy="nothing"``: each block keeps only its input for the
  backward and runs its whole forward again there, flash forward included;
- ``"dots"`` (``dots_with_no_batch_dims_saveable``): the outputs of the
  matmuls without batch dimensions are kept, everything else is run
  again.  ``F.linear`` on the ``[B, S, E]`` stream reaches ``aten.addmm``
  (``aten.mm`` without a bias) on the CPU and on the card, so those two
  ops are the policy (:data:`SAVED_OPS`), given to
  ``create_selective_checkpoint_contexts``;
- ``"dots_saveable"``: also the batched matmuls, ``aten.bmm`` and
  ``aten.baddbmm``, which the einsum attention's scores and output reach.

The flash kernels, like the Pallas call in JAX, are no dot: under either
policy their autograd function runs again in the backward (its output
buffers are ``torch.empty`` calls, recomputed, never saved), so on the
card with flash on the two policies keep the same tensors (on the CPU the
kernels' plain twin computes with ``aten.bmm``, which ``dots_saveable``
keeps).  Remat applies only
while autograd records: evaluation, prefill and decode run the blocks as
they are.

``lora_rank``/``lora_adapters`` give every block's attention stacked LoRA
factors (:class:`..ops.attention.MultiHeadAttention`; JAX ``:202-209``);
a call's ``adapter_ids`` [B] picks each row's adapter (-1: the base
model).  The base parameters are unchanged, so plain checkpoints still
load.  :meth:`TransformerLM.clone` is flax's ``model.clone(**overrides)``.

``moe_experts`` > 0 makes every ``moe_every``-th block (the first at
block ``moe_every - 1``) a Mixture-of-Experts block (JAX ``:69-72``,
``:115``, ``:169-173``, ``:281-296``): its MLP is :class:`..ops.moe.MoEMLP`
(top-``moe_top_k`` routing, ``moe_capacity_factor``, stacked experts) and
its ln2 stays plain; the dense blocks keep the fused tails.  A MoE block
returns its aux statistics beside the stream, an output that crosses
``torch.utils.checkpoint`` (so block remat and the ``dots`` policies keep
it; the expert products are ``bmm``s, recomputed under ``dots`` and kept
under ``dots_saveable``); ``forward(tokens, moe_stats=True)`` returns
``(logits, stats)`` and :meth:`TransformerLM.moe_aux` forms the weighted
aux objective.  Serving refuses a MoE model with the JAX message, "decode
mode does not support MoE blocks yet" (``:216-217``): a KV cache, a paged
pool, or a call with either.  The CPU tests are
``tests/test_torch_moe.py``; on the card ``python3 chip_smoke.py --moe``.

``seq_axis`` (JAX ``:150-156``, ``:253-264``) makes the model one rank's
shard of a sequence-parallel model: its tokens are this rank's ``[B,
S/n]`` columns, the position embeddings start at ``seq_idx * S/n``, and
every block's attention runs ``seq_impl`` (``"ring"`` or ``"ulysses"``)
over the sequence group (:class:`..ops.attention.MultiHeadAttention`); a
global sequence past ``max_len`` raises, as JAX does.  ``seq_axis`` is the
sequence group's exchange (:attr:`..parallel.mesh.SPLayout.seq_exchange`,
which the runner passes); the JAX axis name ``"sequence"`` builds, and
raises at a sharded forward.  The parameters are the same, so
:mod:`.from_jax` maps them unchanged.

``tensor_group`` (a :class:`..parallel.tensor.TensorGroup` of ``T`` ranks,
:attr:`..parallel.mesh.TPLayout.tensor_group`; JAX ``engine/paths.py``'s
GSPMD path) makes the model one rank's shard of a Megatron tensor-parallel
model: each block's qkv and fc1 are column-parallel, proj and fc2
row-parallel, its attention holds ``H / T`` heads, and a MoE block holds
``E / T`` experts (expert parallelism over the same group); embeddings,
LayerNorms, routers and the head stay whole.  Every leaf is drawn whole, as
the one-rank model draws it, and sliced (:mod:`..parallel.tensor`), so a
T-rank model starts from the one-rank model's weights of the same seed, as
JAX's global init does; :meth:`TransformerLM.load_full_state_dict` slices a
full ``state_dict`` into it, :meth:`TransformerLM.full_state_dict` gathers
one back.  Serving refuses it (decode, the paged pool).

``zero_group`` (the data group as a :class:`..parallel.tensor.TensorGroup`,
:attr:`..parallel.mesh.TPLayout.zero_group`) makes the parameters live
sharded, ZeRO-3 (JAX ``parallel/tensor.py:151-180``): after the tensor split
each leaf keeps this data rank's slice along
:func:`..parallel.tensor.zero_shard_dim` (``zero_plan``), and every use
gathers it (:func:`..parallel.tensor.zero_gather`: the all-gather forward,
the reduce-scatter of the f32 gradient backward): the embeddings once a
call, each block's leaves at the block's start, **inside** its remat
boundary (the replay gathers again, so no full block leaf lives across the
step), and the final LayerNorm with the head.  A block runs on its gathered
leaves through ``torch.func.functional_call``, so K3 and K4 read them
through the same wrappers.  A leaf a Dense or an expert bank casts to a
narrower compute dtype is gathered in it (the cast commutes with the
gather and halves the bytes); the embeddings, LayerNorms, router and head
are gathered in f32.  A leaf with no ZeRO dimension stays whole.  The full
model's ``state_dict`` loads and gathers as under tensor parallelism, the
data group first when gathering.

``stage_group`` (the stage group of a pipeline as a
:class:`..parallel.tensor.TensorGroup` of ``S`` ranks,
:attr:`..parallel.mesh.PPLayout.stage`; JAX ``parallel/pipeline.py``) makes
the model stage ``s``'s view of the LM: it holds only its own blocks,
``[s L/S, (s + 1) L/S)`` (:func:`..parallel.pipeline.stage_blocks`), under
their global names ``block{i}``, and the shared leaves (the embeddings, the
final LayerNorm and the head), replicated on every stage.  Every block is
still drawn in turn and the others dropped, so a stage starts from the
one-rank model's weights of the same seed.  The pipeline step
(:mod:`..engine.pp_steps`) runs a stage as :meth:`TransformerLM.embed` (stage
0), :meth:`TransformerLM.run_blocks` (block remat as above) and
:meth:`TransformerLM.logits` (the last stage).  The full model's
``state_dict`` loads (each stage keeps its blocks) and gathers over the
stage group.  MoE blocks, tensor parallelism and ZeRO-3 do not compose with
it, and serving refuses it.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..ops.attention import KVCache, MultiHeadAttention, PagedKVCache
from ..ops.fused_elementwise import FusedResidualLayerNorm
from ..ops.layers import Dense, LayerNorm
from ..ops.moe import MoEMLP, moe_aux
from ..parallel.mesh import resolve_seq_axis
from ..parallel.pipeline import block_index, gather_stages, stage_blocks, stage_state_dict
from ..parallel.tensor import ZeroPlan, gather_state_dict, shard_state_dict, zero_gather
from .vit import MLP

__all__ = ["DecoderBlock", "SAVED_OPS", "TransformerLM"]

_aten = torch.ops.aten
# remat policy (the names resolve_remat_policy takes, models/transformer_lm.py:33-54)
# -> the aten ops whose outputs the backward keeps; None: the whole block runs again
SAVED_OPS = {
    "nothing": None,
    "dots": (_aten.mm.default, _aten.addmm.default),
    "dots_saveable": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                      _aten.baddbmm.default),
}


class DecoderBlock(nn.Module):
    """A pre-LN block; with ``moe_experts`` > 0 its MLP is a routed
    :class:`..ops.moe.MoEMLP` and ``forward`` returns ``(x, stats)``, the
    layer's aux statistics as an output of their own (so they cross
    ``torch.utils.checkpoint`` like any activation)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dtype=torch.float32,
                 fused_tails: bool = False, flash: bool = False, lora_rank: int = 0,
                 lora_adapters: int = 0, moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25, seq_axis=None, seq_impl: str = "ring",
                 tensor_group=None):
        super().__init__()
        self.is_moe = moe_experts > 0
        # JAX :115: a MoE block keeps its ln2 plain (its MLP has no fc1 tail)
        self.fused_tails = fused_tails and not self.is_moe
        self.ln1 = LayerNorm(dim, dtype)
        self.attn = MultiHeadAttention(dim, num_heads, causal=True, dtype=dtype, flash=flash,
                                       lora_rank=lora_rank, lora_adapters=lora_adapters,
                                       seq_axis=seq_axis, seq_impl=seq_impl,
                                       tensor_group=tensor_group)
        # ln1 has no add before it, and the block's last add feeds the next
        # block's ln1, so add+ln2 is the pair one kernel can fuse
        self.ln2 = (FusedResidualLayerNorm if self.fused_tails else LayerNorm)(dim, dtype)
        hidden = int(dim * mlp_ratio)
        if self.is_moe:
            self.moe = MoEMLP(dim, moe_experts, moe_top_k, moe_capacity_factor, hidden, dim,
                              dtype, tensor_group)
        else:
            self.mlp = MLP(dim, hidden, dim, dtype, fused_tails, tensor_group)

    def forward(self, x, cache=None, layer: int = 0, decode_pos=None, block_tables=None,
                adapter_ids=None):
        attn_out = self.attn(self.ln1(x), cache, layer, decode_pos, block_tables, adapter_ids)
        if self.fused_tails:
            x, y = self.ln2(x, attn_out)
        else:
            x = x + attn_out
            y = self.ln2(x)
        if self.is_moe:
            out, stats = self.moe(y)
            return x + out, stats
        return x + self.mlp(y)


class TransformerLM(nn.Module):
    """Causal LM over integer tokens ``[B, S] -> logits [B, S, V]`` (f32)."""

    def __init__(
        self,
        vocab_size: int,
        max_len: int = 1024,
        embed_dim: int = 256,
        depth: int = 4,
        num_heads: int = 8,
        mlp_ratio: float = 4.0,
        dtype=torch.float32,
        fused_tails: bool = False,
        flash: bool = False,
        seq_axis=None,
        seq_impl: str = "ring",
        remat: bool = False,
        remat_policy: str = "nothing",
        moe_experts: int = 0,
        moe_top_k: int = 2,
        moe_capacity_factor: float = 1.25,
        moe_aux_weight: float = 0.01,
        moe_every: int = 2,
        paged: bool = False,
        lora_rank: int = 0,
        lora_adapters: int = 0,
        tensor_group=None,
        zero_group=None,
        stage_group=None,
    ):
        super().__init__()
        # the arguments, for clone()
        self._config = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        if moe_experts > 0 and moe_every < 1:
            raise ValueError(f"moe_every must be >= 1, got {moe_every}")
        if stage_group is not None and moe_experts > 0:
            raise ValueError("model.moe_experts does not compose with pipeline_parallelism")
        if stage_group is not None and (tensor_group is not None or zero_group is not None):
            raise NotImplementedError("pipeline parallelism beside tensor parallelism or ZeRO "
                                      "is ROADMAP port item P9")
        # unknown names raise even with remat off, as in JAX
        self.set_remat(remat, remat_policy)
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed dim {embed_dim} not divisible by {num_heads} heads")
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.dtype = dtype
        self.fused_tails = fused_tails
        self.flash = flash
        self.seq_axis, self.seq_impl = seq_axis, seq_impl
        self.tensor_group = tensor_group
        self.lora_rank = int(lora_rank)
        self.lora_adapters = int(lora_adapters) if lora_rank > 0 else 0
        self.moe_experts, self.moe_every = int(moe_experts), int(moe_every)
        self.moe_aux_weight = float(moe_aux_weight)
        # `paged` is the JAX flag, taken for its signature: a PagedKVCache
        # passed to a call selects the mode, and carries the pool's size
        self.tok_embedding = nn.Parameter(torch.empty(vocab_size, embed_dim))
        self.pos_embedding = nn.Parameter(torch.empty(max_len, embed_dim))
        self.stage_group = stage_group
        self.block_ids = (range(depth) if stage_group is None else
                          stage_blocks(depth, stage_group.size, stage_group.rank))
        for i in range(depth):
            # JAX :281-296: every moe_every-th block routes, the first at
            # block moe_every - 1
            is_moe = moe_experts > 0 and i % moe_every == moe_every - 1
            block = DecoderBlock(embed_dim, num_heads, mlp_ratio, dtype, fused_tails, flash,
                                 lora_rank, lora_adapters, moe_experts if is_moe else 0,
                                 moe_top_k, moe_capacity_factor, seq_axis, seq_impl,
                                 tensor_group)
            if i in self.block_ids:  # a pipeline stage drops the others' (drawn all the same)
                self.add_module(f"block{i}", block)
        self.ln = LayerNorm(embed_dim, dtype)
        self.head = Dense(embed_dim, vocab_size, torch.float32)
        # the submodules initialised themselves; the embeddings are ours
        if not self.tok_embedding.is_meta:
            with torch.no_grad():
                self.tok_embedding.normal_(0.0, 0.02)
                self.pos_embedding.normal_(0.0, 0.02)
        self.zero_group, self.zero_plan = zero_group, None
        if zero_group is not None and zero_group.size > 1:
            self._shard_zero3(zero_group)

    def _shard_zero3(self, zero_group) -> None:
        """Keep this data rank's slice of every leaf (module docstring) and
        the gather sets: the embeddings, each block, the final LayerNorm
        with the head."""
        named = list(self.named_parameters())
        plan = ZeroPlan([n for n, _ in named], [p.shape for _, p in named], zero_group)
        for i, (name, p) in enumerate(named):
            if plan.dims[i] is not None:
                owner, _, leaf = name.rpartition(".")
                setattr(self.get_submodule(owner) if owner else self, leaf,
                        nn.Parameter(plan.slice(p.data, i)))
        narrow = {}  # leaf -> the compute dtype its module casts it to
        for owner, module in self.named_modules():
            leaves = (("weight", "bias") if isinstance(module, Dense) else
                      ("wi", "bi", "wo", "bo") if isinstance(module, MoEMLP) else ())
            if leaves and module.dtype != torch.float32:
                narrow.update({f"{owner}.{leaf}": module.dtype for leaf in leaves})
        units = {"embed": ("tok_embedding", "pos_embedding"), "final": ("ln.", "head.")}
        units.update({f"block{i}": (f"block{i}.",) for i in range(self.depth)})
        self._zero_units = {}
        for unit, prefixes in units.items():
            idx = [i for i in plan.sharded if plan.names[i].startswith(prefixes)]
            self._zero_units[unit] = (
                idx, [plan.names[i].removeprefix(prefixes[0]) if unit.startswith("block")
                      else plan.names[i] for i in idx],
                [narrow.get(plan.names[i], torch.float32) for i in idx])
        self.zero_plan = plan

    def _zero_full(self, unit: str) -> Dict[str, torch.Tensor]:
        """ZeRO-3: the gathered leaves of ``unit`` by name (module docstring)."""
        idx, names, dtypes = self._zero_units[unit]
        parts = [self.get_parameter(self.zero_plan.names[i]) for i in idx]
        return dict(zip(names, zero_gather(self.zero_plan, idx, parts, dtypes)))

    def _zero_block(self, i: int, x, *args):
        """Block ``i`` on its gathered leaves (inside the remat boundary)."""
        return functional_call(self.blocks[i], self._zero_full(f"block{i}"), (x,) + args)

    def clone(self, **overrides) -> "TransformerLM":
        """A new model of this one's arguments with ``overrides`` (flax
        ``clone``), freshly initialised; built under ``torch.device("meta")``
        it allocates nothing, for ``load_state_dict(..., assign=True)``."""
        return TransformerLM(**{**self._config, **overrides})

    def set_remat(self, remat: bool, policy: str = "nothing") -> None:
        """Block remat on or off, under ``policy`` (a name of
        :data:`SAVED_OPS`); the parameters are the same either way."""
        if policy not in SAVED_OPS:
            raise ValueError(f"model.remat_policy must be one of {sorted(SAVED_OPS)}, "
                             f"got {policy!r}")
        self.remat, self.remat_policy = bool(remat), policy
        saved = SAVED_OPS[policy]
        self._remat_context = (None if saved is None else
                               functools.partial(create_selective_checkpoint_contexts,
                                                 list(saved)))

    @property
    def blocks(self):
        """This model's blocks (a pipeline stage's own), in order."""
        return [getattr(self, f"block{i}") for i in self.block_ids]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initializers: normal(0.02) embeddings, lecun-normal
        kernels, zero biases, unit LayerNorm scales; drawn in a fixed module
        order from ``generator``.  A tensor-parallel, ZeRO-3 or pipeline-stage
        model draws the full model and keeps its part."""
        if (self.tensor_group is not None or self.zero_plan is not None
                or self.stage_group is not None):
            with torch.device("meta"):
                full = self.clone(tensor_group=None, zero_group=None, stage_group=None)
            full.to_empty(device=self.tok_embedding.device)
            full.reset_parameters(generator)
            self.load_full_state_dict(full.state_dict())
            return
        with torch.no_grad():
            self.tok_embedding.normal_(0.0, 0.02, generator=generator)
            self.pos_embedding.normal_(0.0, 0.02, generator=generator)
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def cast_matmul_weights_(self) -> "TransformerLM":
        """Round every Dense weight and bias to its compute dtype, once.

        Each Dense casts its parameters to its dtype on every call (flax
        ``promote_dtype``); casting the stored parameters ahead gives the
        same numbers and spares decode the per-step conversion.  The head
        (f32) and the LayerNorm and embedding parameters are unchanged.
        """
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, Dense):
                    module.weight.data = module.weight.data.to(module.dtype)
                    module.bias.data = module.bias.data.to(module.dtype)
        return self

    def full_keys(self):
        """The full model's ``state_dict`` keys (a pipeline stage's blocks
        stand for every stage's)."""
        local = list(self.state_dict())
        if self.stage_group is None:
            return local
        first = f"block{self.block_ids[0]}."
        leaves = [k[len(first):] for k in local if k.startswith(first)]
        return ([k for k in local if block_index(k) is None]
                + [f"block{i}.{leaf}" for i in range(self.depth) for leaf in leaves])

    def load_full_state_dict(self, state) -> None:
        """Load the full model's ``state_dict`` (strict): a tensor-parallel
        or ZeRO-3 model keeps its slices of it, a pipeline stage its blocks."""
        if self.stage_group is not None:
            differ = sorted(set(self.full_keys()) ^ set(state))
            if differ:
                raise ValueError(f"full state_dict keys differ from the model's: {differ[:4]}")
            state = stage_state_dict(state, self.depth, self.stage_group.size,
                                     self.stage_group.rank)
        local = shard_state_dict(state, self.tensor_group)
        plan = self.zero_plan
        if plan is not None:
            local = {k: plan.slice(v, plan.index[k]) for k, v in local.items()}
        self.load_state_dict(local, strict=True)

    def full_state_dict(self) -> dict:
        """The full model's ``state_dict``: a ZeRO-3 model gathers its leaves
        over the data group, then a tensor-parallel one over the model group;
        a pipeline stage gathers the blocks over the stage group (collectives
        on every rank)."""
        return self.gather_full(self.state_dict())

    def gather_full(self, local) -> dict:
        """The full model's entries from ``local``, this model's by name (its
        ``state_dict`` or a like-named dict of optimizer slots), gathered as
        :meth:`full_state_dict` gathers (collectives on every rank)."""
        plan = self.zero_plan
        if plan is not None:
            local = dict(zip(plan.names, plan.gather_all([local[n] for n in plan.names])))
        if self.stage_group is not None:
            return gather_stages(local, self.depth, self.stage_group)
        return gather_state_dict(local, self.tensor_group)

    def _refuse_decode(self) -> None:
        # JAX :216-217: serving (the batcher's cache, the paged pool) is dense
        if self.moe_experts > 0:
            raise ValueError("decode mode does not support MoE blocks yet")
        if (self.tensor_group is not None or self.zero_plan is not None
                or self.stage_group is not None):
            raise ValueError("decode and paged modes are single-shard (tensor_group must be None)")

    def moe_aux(self, stats, n_tokens: int):
        """The aux objective: every MoE block's weighted term
        (:func:`..ops.moe.moe_aux`) from its ``stats`` over ``n_tokens``
        tokens, summed; 0 for a dense model."""
        return sum(moe_aux(st, n_tokens, self.moe_aux_weight, self.moe_experts) for st in stats)

    def new_cache(self, batch: int, device=None) -> KVCache:
        """A zeroed KV cache of capacity ``max_len`` for ``batch`` rows."""
        self._refuse_decode()
        device = self.tok_embedding.device if device is None else device
        return KVCache.zeros(
            self.depth, batch, self.max_len, self.num_heads,
            self.embed_dim // self.num_heads, self.dtype, device,
        )

    def new_pool(self, num_blocks: int, block_size: int, device=None) -> PagedKVCache:
        """A zeroed paged pool of ``num_blocks`` blocks of ``block_size``
        rows a layer, in the compute dtype."""
        self._refuse_decode()
        device = self.tok_embedding.device if device is None else device
        return PagedKVCache.zeros(
            self.depth, num_blocks, block_size, self.num_heads,
            self.embed_dim // self.num_heads, self.dtype, device,
        )

    def trunk(self, tokens, cache=None, decode_pos=None, block_tables=None, adapter_ids=None,
              moe_stats: bool = False):
        """Embeddings and blocks: the residual stream ``[B, S, E]`` before
        the final LayerNorm and head; with ``moe_stats`` also the list of
        the MoE blocks' aux statistics, in block order."""
        if cache is not None:
            self._refuse_decode()
        if adapter_ids is not None and self.lora_rank <= 0:
            raise ValueError("adapter_ids given but the model has no LoRA factors "
                             "(clone with lora_rank/lora_adapters set)")
        b, s = tokens.shape
        full = {} if self.zero_plan is None else self._zero_full("embed")
        tok_embedding = full.get("tok_embedding", self.tok_embedding)
        pos_embedding = full.get("pos_embedding", self.pos_embedding)
        # F.embedding, not indexing: the same rows, and a backward that sums
        # each row's gradient in a fixed order (indexing's scatter-add on the
        # CPU does not), so a resumed run repeats a straight one bit for bit
        x = F.embedding(tokens, tok_embedding).to(self.dtype)
        if isinstance(cache, PagedKVCache):
            if decode_pos is None or block_tables is None:
                raise ValueError("paged mode needs positions and block_tables")
            # per-token positions; padding (-1) reads row 0, its output unused
            pe = pos_embedding[decode_pos.clamp(0, self.max_len - 1)]
        elif decode_pos is not None:
            if cache is None:
                raise ValueError("decode_pos given without a KV cache")
            # one new token per row at its own position
            pe = pos_embedding[decode_pos][:, None]
        elif self.seq_axis is not None and cache is None:
            # shard i holds global positions [i s, (i + 1) s) (JAX :253-264)
            group = resolve_seq_axis(self.seq_axis)
            if s * group.size > self.max_len:
                raise ValueError(f"global sequence {s * group.size} (= {s} local x "
                                 f"{group.size} shards) exceeds max_len {self.max_len}")
            pe = pos_embedding[group.rank * s:(group.rank + 1) * s][None]
        else:
            if s > self.max_len:
                raise ValueError(f"sequence {s} exceeds max_len {self.max_len}")
            pe = pos_embedding[:s][None]
        x = x + pe.to(self.dtype)
        recompute = self.remat and cache is None and torch.is_grad_enabled()
        stats = []
        for i, block in zip(self.block_ids, self.blocks):
            x = self._apply_block(i, block, x, recompute, cache, i, decode_pos, block_tables,
                                  adapter_ids)
            if block.is_moe:
                x, st = x
                stats.append(st)
        return (x, stats) if moe_stats else x

    def _apply_block(self, i: int, block, x, recompute: bool, *args):
        """Block ``i`` over ``x``, under remat when ``recompute`` (the remat
        boundary takes the stream alone)."""
        run = block if self.zero_plan is None else functools.partial(self._zero_block, i)
        if recompute and self._remat_context is not None:
            return checkpoint(run, x, use_reentrant=False, context_fn=self._remat_context)
        if recompute:
            return checkpoint(run, x, use_reentrant=False)
        return run(x, *args)

    def embed(self, tokens):
        """The token and position embeddings of a plain call, ``[B, S]`` ->
        the stream ``[B, S, E]`` in the compute dtype (a pipeline's stage 0;
        the caller checks the sequence against ``max_len``)."""
        x = F.embedding(tokens, self.tok_embedding).to(self.dtype)
        return x + self.pos_embedding[:tokens.shape[1]][None].to(self.dtype)

    def run_blocks(self, x):
        """This model's blocks (a pipeline stage's own) over the stream ``x``,
        under block remat while autograd records, as :meth:`trunk` runs them."""
        recompute = self.remat and torch.is_grad_enabled()
        for i, block in zip(self.block_ids, self.blocks):
            x = self._apply_block(i, block, x, recompute)
        return x

    def logits(self, x):
        """Final LayerNorm and the f32 head over stream rows ``x``."""
        if self.zero_plan is None:
            return self.head(self.ln(x))
        full = self._zero_full("final")
        ln = {k[3:]: v for k, v in full.items() if k.startswith("ln.")}
        head = {k[5:]: v for k, v in full.items() if k.startswith("head.")}
        return functional_call(self.head, head, (functional_call(self.ln, ln, (x,)),))

    def forward(self, tokens, cache=None, decode_pos=None, block_tables=None, adapter_ids=None,
                moe_stats: bool = False):
        """Logits ``[B, S, V]`` (with a cache: ``(logits, cache)``; with
        ``moe_stats``: ``(logits, stats)``, see :meth:`trunk`)."""
        if moe_stats:
            x, stats = self.trunk(tokens, moe_stats=True)
            return self.logits(x), stats
        logits = self.logits(self.trunk(tokens, cache, decode_pos, block_tables, adapter_ids))
        return logits if cache is None else (logits, cache)
