"""The port's paged attention and paged model against the JAX package's.

Same weights (the JAX model's init, biases and LayerNorm parameters
perturbed so a mis-mapped one shows) and the same pool contents on both
sides, in float32 on the CPU; the JAX model's fused tails run their Pallas
kernels in interpret mode.  The pool starts as seeded noise, with NaNs
planted in rows no live position reads: block 0 (every padded block-table
entry aliases it) and the tail of a row's last block past its length.
Three paged calls, each against the pool the last one left: a cold
prefill of two ragged rows, a prefix-hit chunked prefill reading a shared
block, and a single-token decode step with a padding row.  Every logit
(padding positions included: both sides read key 0 for them) within 1e-5,
every output finite, and the pools equal afterwards.

Also the sampling rule the port's batcher and scheduler share
(:mod:`..serving.decode`): a draw depends only on its key, its token index
and its logits row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.ops.attention import MultiHeadAttention as JaxMHA
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.ops.attention import (
    MultiHeadAttention,
    PagedKVCache,
    paged_attention,
)
from pytorch_distributed_training_tpu_torch.serving.decode import (
    gumbel,
    sample_tokens,
    token_seeds,
)

VOCAB, MAXLEN, EMBED, DEPTH, HEADS = 61, 32, 32, 2, 4
BS, NB = 4, 8
TOL = dict(atol=1e-5, rtol=1e-5)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        arr = np.asarray(leaf, np.float32)
        if path[-1].key in ("bias", "scale"):
            arr = arr + (0.1 * rng.normal(size=arr.shape)).astype(np.float32)
        return arr

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(vocab_size=VOCAB, max_len=MAXLEN, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
               fused_tails=True)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"], 0)
    paged = jm.clone(decode=True, paged=True, kv_block_size=BS, kv_num_blocks=NB)
    pm = TransformerLM(VOCAB, max_len=MAXLEN, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
                       fused_tails=True, paged=True)
    pm.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return paged, params, pm.eval()


def _noisy_pools(depth, heads, head_dim, seed=1):
    """The same seeded pool for both sides, NaN in the dead rows."""
    rng = np.random.default_rng(seed)
    rows = NB * BS
    leaves = {}
    for i in range(depth):
        for name in ("k_pool", "v_pool"):
            a = rng.normal(size=(rows, heads, head_dim)).astype(np.float32)
            a[0:BS] = np.nan  # block 0: what padded table entries alias
            a[3 * BS + 3] = np.nan  # block 3, row 3: past row 1's length
            leaves[(f"block{i}", name)] = a
    jpool = {f"block{i}": {"attn": {n: jnp.asarray(leaves[(f"block{i}", n)])
                                    for n in ("k_pool", "v_pool")}} for i in range(depth)}
    sink = np.zeros((1, heads, head_dim), np.float32)
    ppool = PagedKVCache(
        [torch.from_numpy(np.concatenate([leaves[(f"block{i}", "k_pool")], sink]))
         for i in range(depth)],
        [torch.from_numpy(np.concatenate([leaves[(f"block{i}", "v_pool")], sink]))
         for i in range(depth)], BS, NB)
    return jpool, ppool


def _same_pools(jpool, ppool):
    for i in range(len(ppool.keys)):
        for name, got in (("k_pool", ppool.keys[i]), ("v_pool", ppool.values[i])):
            want = np.asarray(jpool[f"block{i}"]["attn"][name])
            np.testing.assert_allclose(got[:-1].numpy(), want, **TOL)


# the three calls: (tokens, positions, block tables); row 0 owns blocks 1, 2,
# row 1 owns blocks 3 (length 3: its row 3 is dead) and 4; table width 3,
# the padded entries 0 (a NaN block)
rng = np.random.default_rng(7)
_PROMPT0 = rng.integers(0, VOCAB, 6)
_CALLS = [
    ("cold prefill",
     np.stack([_PROMPT0, np.r_[rng.integers(0, VOCAB, 3), [0, 0, 0]]]),
     np.array([np.arange(6), [0, 1, 2, -1, -1, -1]]),
     np.array([[1, 2, 0], [3, 4, 0]])),
    # a new row sharing row 0's first block (prefix hit): its suffix at
    # positions 4..6 in a fresh block 5; row 1 pads
    ("prefix-hit prefill",
     np.stack([np.r_[rng.integers(0, VOCAB, 3)], [0, 0, 0]]),
     np.array([[4, 5, 6], [-1, -1, -1]]),
     np.array([[1, 5, 0], [3, 4, 0]])),
    ("decode step",
     np.array([[int(rng.integers(0, VOCAB))], [0]]),
     np.array([[6], [-1]]),
     np.array([[1, 2, 0], [3, 4, 0]])),
]


def test_paged_model_matches_jax(models):
    paged, params, pm = models
    jpool, ppool = _noisy_pools(DEPTH, HEADS, EMBED // HEADS)
    for what, toks, pos, tables in _CALLS:
        jlogits, v = paged.apply({"params": params, "cache": jpool}, jnp.asarray(toks, jnp.int32),
                                 jnp.asarray(pos, jnp.int32), jnp.asarray(tables, jnp.int32),
                                 mutable=["cache"])
        jpool = v["cache"]
        with torch.inference_mode():
            plogits, _ = pm(torch.from_numpy(toks).long(), ppool, torch.from_numpy(pos).long(),
                            torch.from_numpy(tables).long())
        assert torch.isfinite(plogits).all(), what
        np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), **TOL, err_msg=what)
        _same_pools(jpool, ppool)
    # the padding writes went to the sink row, never row 0
    assert torch.isnan(ppool.keys[0][0]).all()


def test_paged_attention_matches_jax():
    """The attention module alone (JAX ``_paged_attention``), B = 3 rows,
    one of them all padding (its table all block 0)."""
    heads, dim = 2, 16
    jmha = JaxMHA(num_heads=heads, causal=True, decode=True, paged=True, kv_block_size=BS,
                  kv_num_blocks=NB)
    r = np.random.default_rng(3)
    x = r.normal(size=(3, 5, dim)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [2, 3, 4, 5, -1], [-1] * 5])
    tables = np.array([[1, 2], [6, 7], [0, 0]])
    variables = jmha.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(pos),
                          jnp.asarray(tables))
    p = _perturbed(variables["params"], 2)
    jpool, ppool = _noisy_pools(1, heads, dim // heads, seed=4)
    jcache = {k: jnp.asarray(v) for k, v in jpool["block0"]["attn"].items()}
    jout, _ = jmha.apply({"params": p, "cache": jcache}, jnp.asarray(x), jnp.asarray(pos),
                         jnp.asarray(tables), mutable=["cache"])
    mha = MultiHeadAttention(dim, heads, causal=True, paged=True)
    with torch.no_grad():
        for name in ("qkv", "proj"):
            getattr(mha, name).weight.copy_(torch.tensor(np.asarray(p[name]["kernel"]).T))
            getattr(mha, name).bias.copy_(torch.tensor(np.asarray(p[name]["bias"])))
        out = mha(torch.from_numpy(x), ppool, 0, torch.from_numpy(pos), torch.from_numpy(tables))
    # the all-padding row reads key 0 of block 0, a NaN row, on both sides:
    # only an active row's output (and finite flag) means anything
    assert torch.isfinite(out[:2]).all() and torch.isnan(out[2]).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_dead_values_are_zeroed_not_only_masked():
    """A NaN value row that no query may read stays out of every output;
    without the zeroing, 0 * NaN would carry it into the weighted sum."""
    q = torch.randn(1, 2, 1, 4)
    kp, vp = torch.randn(3 * 2 + 1, 1, 4), torch.randn(3 * 2 + 1, 1, 4)
    vp[3] = float("nan")  # block 1, row 1: position 3, past the row's length
    pos, tables = torch.tensor([[0, 1]]), torch.tensor([[2, 1]])
    out = paged_attention(q, q, q, kp, vp, pos, tables, 2)
    assert torch.isfinite(out).all()
    # the same weights against the values as gathered, not zeroed: NaN
    rows = torch.tensor([4, 5, 2, 3])
    s = torch.einsum("bqhd,khd->bhqk", q, kp[rows]).masked_fill(
        torch.arange(4) > pos[0][:, None], float("-inf"))
    assert torch.isnan(torch.einsum("bhqk,khd->bqhd", s.softmax(-1), vp[rows])).any()


@pytest.mark.parametrize("case", ["not causal", "no positions", "no tables", "block size 0"])
def test_paged_errors_as_jax(case):
    mha = MultiHeadAttention(8, 2, causal=case != "not causal", paged=True)
    pool = PagedKVCache.zeros(1, 2, 2, 2, 4, torch.float32, "cpu")
    pos, tables = torch.zeros(1, 1, dtype=torch.long), torch.zeros(1, 1, dtype=torch.long)
    x = torch.zeros(1, 1, 8)
    if case == "no positions":
        pos = None
    if case == "no tables":
        tables = None
    if case == "block size 0":
        # checked once, where a pool is made: no paged call sees such a pool
        with pytest.raises(ValueError, match="kv_block_size/kv_num_blocks > 0"):
            PagedKVCache.zeros(1, 2, 0, 2, 4, torch.float32, "cpu")
        with pytest.raises(ValueError, match="kv_block_size/kv_num_blocks > 0"):
            PagedKVCache(pool.keys, pool.values, 2, 0)
        return
    match = {"not causal": "requires causal", "no positions": "positions and block_tables",
             "no tables": "positions and block_tables"}[case]
    with pytest.raises(ValueError, match=match):
        mha(x, pool, 0, pos, tables)


# --------------------------------------------------------------------- #
# the sampling rule


def test_token_seeds_are_seed_sequence_words():
    got = token_seeds([(7, 1, 2), None, (0,)], [5, 9, 0])
    want = np.random.SeedSequence([7, 1, 2, 5]).generate_state(2, np.uint32)
    np.testing.assert_array_equal(got[0], want.astype(np.int64))
    np.testing.assert_array_equal(got[1], [0, 0])
    assert got.dtype == np.int64 and (got >= 0).all() and (got < 2 ** 32).all()


def test_draw_depends_on_key_index_and_row_only():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    keys = [(3, 0, r) for r in range(4)]
    seeds = torch.from_numpy(token_seeds(keys, [2, 2, 5, 5]))
    tok = sample_tokens(logits, 0.9, seeds)
    perm = [2, 0, 3, 1]  # the same rows in another batch
    again = sample_tokens(logits[perm], 0.9, seeds[perm])
    assert torch.equal(again, tok[perm])
    assert torch.equal(sample_tokens(logits[1:2], 0.9, seeds[1:2]), tok[1:2])
    draws = torch.stack([sample_tokens(logits, 0.9, torch.from_numpy(
        token_seeds(keys, [i] * 4))) for i in range(40)])
    assert len(set(draws[:, 0].tolist())) > 3  # the index moves the draw


def test_greedy_takes_the_first_maximum():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert sample_tokens(logits, 0.0).tolist() == [1, 0]


def test_gumbel_max_draws_the_softmax():
    """Over 4000 keys the draws of one logits row follow softmax(l / T)
    (a chi-square-sized tolerance on 5 categories)."""
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5])
    n, t = 4000, 0.7
    seeds = torch.from_numpy(token_seeds([(11, k) for k in range(n)], [0] * n))
    draws = sample_tokens(logits.expand(n, 5), t, seeds)
    freq = torch.bincount(draws, minlength=5).float() / n
    want = torch.softmax(logits / t, dim=0)
    assert (freq - want).abs().max().item() < 0.03
    g = gumbel(seeds[:2], 1000)
    assert torch.isfinite(g).all() and abs(g.mean().item() - 0.5772) < 0.1
