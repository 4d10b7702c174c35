"""The port's TransformerLM serving path against the JAX package's.

Same weights on both sides: the JAX model's init, with its biases and
LayerNorm parameters perturbed (so a mis-mapped bias or scale shows),
carried over by ``lm_state_dict_from_jax``.  Both run in float32 on the
CPU; the JAX side's fused tails run their Pallas kernels in interpret mode.

Tolerances: logits within atol/rtol 1e-4 (the bar of
``tests/test_torch_port_lm.py``); greedy tokens identical, with every
step's top-1/top-2 logit margin above 1e-3 so that a near tie is reported
as such rather than as a mismatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.transformer_lm import (
    TransformerLM as JaxLM,
)
from pytorch_distributed_training_tpu.serving.decode import (
    build_generate_fn as jax_build_generate_fn,
)
from pytorch_distributed_training_tpu_torch.models import (
    TransformerLM,
    get_model,
    lm_state_dict_from_jax,
)
from pytorch_distributed_training_tpu_torch.ops.attention import (
    MultiHeadAttention,
    PagedKVCache,
    dot_product_attention,
)
from pytorch_distributed_training_tpu_torch.ops.layers import LayerNorm
from pytorch_distributed_training_tpu_torch.serving.decode import build_generate_fn

VOCAB, MAXLEN, EMBED, DEPTH, HEADS = 64, 48, 32, 2, 2


def _jax_lm(fused_tails):
    return JaxLM(vocab_size=VOCAB, max_len=MAXLEN, embed_dim=EMBED, depth=DEPTH,
                 num_heads=HEADS, fused_tails=fused_tails)


def _perturbed_params(seed=0):
    params = _jax_lm(False).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        arr = np.asarray(leaf, np.float32)
        if path[-1].key in ("bias", "scale"):
            arr = arr + (0.1 * rng.normal(size=arr.shape)).astype(np.float32)
        return arr

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def params():
    return _perturbed_params()


def _port_lm(params, fused_tails):
    model = TransformerLM(VOCAB, max_len=MAXLEN, embed_dim=EMBED, depth=DEPTH,
                          num_heads=HEADS, fused_tails=fused_tails)
    model.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return model.eval()


def _ragged_batch(rng, lens, width):
    toks = np.zeros((len(lens), width), np.int32)
    for i, ln in enumerate(lens):
        toks[i, :ln] = rng.integers(0, VOCAB, ln)
    return toks


# --------------------------------------------------------------------- #
# (b) the converter is strict


def test_converter_maps_every_leaf(params):
    sd = lm_state_dict_from_jax(params)
    model = TransformerLM(VOCAB, max_len=MAXLEN, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS)
    assert set(sd) == set(model.state_dict())
    # kernels transpose to torch's [out, in]; the qkv columns keep their
    # heads-major (H, 3, hd) order
    np.testing.assert_array_equal(
        sd["block0.attn.qkv.weight"].numpy(), params["block0"]["attn"]["qkv"]["kernel"].T
    )
    np.testing.assert_array_equal(sd["ln.weight"].numpy(), params["ln"]["scale"])


def _without(tree, *path):
    tree = jax.tree_util.tree_map(lambda a: a, tree)  # copy the containers
    node = tree
    for key in path[:-1]:
        node = node[key]
    del node[path[-1]]
    return tree


@pytest.mark.parametrize("case", ["missing", "extra", "shape"])
def test_converter_is_strict(params, case):
    tree = jax.tree_util.tree_map(lambda a: a, params)
    if case == "missing":
        tree = _without(tree, "block1", "mlp", "fc2", "bias")
        match = "missing leaves"
    elif case == "extra":
        tree["block0"]["attn"]["qkv"]["lora_a"] = np.zeros((EMBED, 4), np.float32)
        match = "extra leaves"
    else:
        tree["block1"]["ln2"]["scale"] = np.ones(EMBED + 1, np.float32)
        match = "has shape"
    with pytest.raises(ValueError, match=match):
        lm_state_dict_from_jax(tree)


# --------------------------------------------------------------------- #
# (c) logits: cache-less forward, prefill, one decode step


@pytest.mark.parametrize("fused_tails", [True, False])
def test_logits_match_jax(params, fused_tails):
    rng = np.random.default_rng(1)
    lens = [3, 12, 7]
    toks = _ragged_batch(rng, lens, 12)
    jm = _jax_lm(fused_tails)
    port = _port_lm(params, fused_tails)
    with torch.inference_mode():
        full = port(torch.from_numpy(toks).long())
        np.testing.assert_allclose(
            full.numpy(), np.asarray(jm.apply({"params": params}, toks)), atol=1e-4, rtol=1e-4
        )
        jdm = jm.clone(decode=True)
        jpre, jvars = jdm.apply({"params": params}, toks, mutable=["cache"])
        cache = port.new_cache(len(lens))
        tpre, cache = port(torch.from_numpy(toks).long(), cache)
        assert tpre.dtype == torch.float32
        np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), atol=1e-4, rtol=1e-4)
        # one decode step, each row at its own position
        nxt = rng.integers(0, VOCAB, (len(lens), 1)).astype(np.int32)
        pos = np.asarray(lens, np.int32)
        jstep, _ = jdm.apply({"params": params, "cache": jvars["cache"]}, nxt,
                             jnp.asarray(pos), mutable=["cache"])
        cache.live_len = int(pos.max()) + 1
        tstep, _ = port(torch.from_numpy(nxt).long(), cache, torch.from_numpy(pos).long())
        np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), atol=1e-4, rtol=1e-4)


def test_attention_matches_jax():
    from pytorch_distributed_training_tpu.ops.attention import (
        dot_product_attention as jax_dpa,
    )

    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 9, 3, 8)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_dpa(q, k, v, causal=True, impl="xla"))
    got = dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_layernorm_is_flax_in_bf16():
    from flax import linen as nn

    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(5, 40)).astype(np.float32) * 3 + 1).astype(jnp.bfloat16)
    p = {"scale": (1 + 0.2 * rng.normal(size=40)).astype(np.float32),
         "bias": (0.1 * rng.normal(size=40)).astype(np.float32)}
    want = nn.LayerNorm(dtype=jnp.bfloat16).apply({"params": p}, x)
    ln = LayerNorm(40, dtype=torch.bfloat16)
    ln.load_state_dict({"weight": torch.from_numpy(p["scale"]), "bias": torch.from_numpy(p["bias"])})
    got = ln(torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)), atol=8e-3, rtol=8e-3
    )


# --------------------------------------------------------------------- #
# (d) greedy generation, token for token


def _worst_margin(jm, params, toks, lens, out, gen_len):
    """Top-1/top-2 logit margin at every generated step, from the JAX full
    forward over prompt + generated tokens."""
    seqs = np.zeros((len(lens), toks.shape[1] + out.shape[1]), np.int32)
    for r, ln in enumerate(lens):  # right padding leaves earlier positions be
        seqs[r, : ln + gen_len[r]] = np.concatenate([toks[r, :ln], out[r, : gen_len[r]]])
    logits = np.asarray(jm.apply({"params": params}, seqs))
    worst = np.inf
    for r, ln in enumerate(lens):
        for i in range(gen_len[r]):
            top2 = np.sort(logits[r, ln - 1 + i])[-2:]
            worst = min(worst, top2[1] - top2[0])
    return worst


def test_greedy_generate_matches_jax(params):
    rng = np.random.default_rng(5)
    lens = [1, 6, 9, 4]
    toks = _ragged_batch(rng, lens, 10)
    max_new = 8
    jm = _jax_lm(True)
    plen = np.asarray(lens, np.int32)
    port = _port_lm(params, True)
    # pick an eos the run really emits: row 1's third token without eos
    eos = int(build_generate_fn(port, max_new)(toks, plen)[0][1, 2])
    jout, jlen = jax_build_generate_fn(jm, max_new, eos_id=eos)(
        params, toks, plen, jax.random.PRNGKey(0)
    )
    jout, jlen = np.asarray(jout), np.asarray(jlen)
    assert jlen.min() < max_new  # the eos stops at least one row early
    gen = build_generate_fn(port, max_new, eos_id=eos)
    out, gen_len = gen(toks, plen, seed=0)
    margin = _worst_margin(jm, params, toks, lens, jout, jlen)
    assert margin > 1e-3, f"near tie (margin {margin}): pick another seed"
    np.testing.assert_array_equal(gen_len, jlen)
    np.testing.assert_array_equal(out, jout)
    assert out.dtype == np.int32 and gen_len.dtype == np.int32


# --------------------------------------------------------------------- #
# (h) sampled generation repeats for a seed


def test_sampled_generate_is_reproducible(params):
    rng = np.random.default_rng(6)
    lens = [2, 5, 3]
    toks = _ragged_batch(rng, lens, 8)
    plen = np.asarray(lens, np.int32)
    gen = build_generate_fn(_port_lm(params, True), 6, temperature=1.0)
    a, la = gen(toks, plen, seed=(7, 1))
    b, lb = gen(toks, plen, seed=(7, 1))
    c, _ = gen(toks, plen, seed=(7, 2))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < VOCAB)).all()


# --------------------------------------------------------------------- #
# what the slice leaves for later raises, naming its ROADMAP item


@pytest.mark.parametrize(
    "kwargs,item",
    [# ported (P9, MoE): the model builds and serving refuses it, as JAX does
     pytest.param({"moe_experts": 2}, None, id="kwargs0-P9"),
     # ported (P9, sequence parallelism): the model builds and serving
     # refuses a sharded sequence with the JAX messages
     pytest.param({"seq_axis": "sequence"}, None, id="kwargs1-P9"),
     # ported (P2b): the dots policy builds
     pytest.param({"remat": True, "remat_policy": "dots"}, None, id="kwargs2-P2"),
     # ported (P4): the paged model builds and makes its pool
     pytest.param({"paged": True}, None, id="kwargs3-P4"),
     # ported (P5): the stacked LoRA factors
     pytest.param({"lora_rank": 4, "lora_adapters": 2}, None, id="kwargs4-P5")],
)
def test_unported_model_options_raise(kwargs, item):
    if item is None:
        model = TransformerLM(VOCAB, max_len=MAXLEN, embed_dim=EMBED,
                              depth=2 if "moe_experts" in kwargs else 1, num_heads=HEADS,
                              **kwargs)
        if "moe_experts" in kwargs:
            assert model.block1.is_moe and model.block1.moe.wi.shape == (2, EMBED, 4 * EMBED)
            with pytest.raises(ValueError) as want:
                JaxLM(vocab_size=VOCAB, max_len=MAXLEN, embed_dim=EMBED, depth=2,
                      num_heads=HEADS, moe_experts=2, decode=True).init(
                    jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
            assert str(want.value) == "decode mode does not support MoE blocks yet"
            tokens = np.ones((2, 4), np.int32)
            # the batcher's cache, the scheduler's paged pool, a call with a cache
            for serve in (lambda: build_generate_fn(model, 2)(tokens, np.full(2, 4, np.int32)),
                          lambda: model.new_pool(3, 4), lambda: model.new_cache(2),
                          lambda: model(torch.ones(2, 4, dtype=torch.long),
                                        model.clone(moe_experts=0).new_cache(2))):
                with pytest.raises(ValueError) as got:
                    serve()
                assert str(got.value) == str(want.value)
        elif "seq_axis" in kwargs:
            tokens = torch.ones(2, 4, dtype=torch.long)
            pos, tables = torch.zeros(2, 4, dtype=torch.long), torch.zeros(2, 1, dtype=torch.long)
            for call, want in ((lambda: model(tokens, model.new_cache(2)), "decode mode"),
                               (lambda: model(tokens, model.new_pool(3, 4), pos, tables),
                                "paged decode")):
                with pytest.raises(ValueError) as got:
                    call()
                assert str(got.value) == f"{want} is single-shard (seq_axis must be None)"
        elif "remat" in kwargs:
            assert model.remat and model.remat_policy == kwargs["remat_policy"]
        elif "lora_rank" in kwargs:
            # stacked factors, B zero: a fresh adapter is the base model
            assert model.block0.attn.qkv_lora_a.shape == (2, EMBED, 4)
            tokens = torch.arange(6).view(2, 3)
            with torch.no_grad():
                torch.testing.assert_close(model(tokens, adapter_ids=torch.tensor([1, -1])),
                                           model(tokens), rtol=0, atol=0)
            # as in JAX, a rank needs an adapter count
            with pytest.raises(ValueError, match="lora_adapters"):
                TransformerLM(VOCAB, max_len=MAXLEN, embed_dim=EMBED, depth=1,
                              num_heads=HEADS, lora_rank=4)
        else:
            pool = model.new_pool(3, 4)
            assert pool.block_size == 4 and pool.num_blocks == 3
            assert pool.keys[0].shape == (3 * 4 + 1, HEADS, EMBED // HEADS)
        return
    with pytest.raises(NotImplementedError, match=item):
        TransformerLM(VOCAB, max_len=MAXLEN, embed_dim=EMBED, depth=1, num_heads=HEADS, **kwargs)


@pytest.mark.parametrize("name,item", [("ViT-B16", "P8"), ("ViT-S16", "P8")])
def test_unported_models_raise(name, item):
    # ported (P8): the ViTs build, on the meta device here; a name the zoo
    # lacks still raises
    with torch.device("meta"):
        model = get_model(name, num_classes=10)
    assert model.head.weight.shape == (10, model.embed_dim) and model.patch_size == 16
    with pytest.raises(KeyError, match="unknown model"):
        get_model(name + "x", num_classes=10)


def test_flash_and_paged_attention_raise():
    # flash is ported: forced on a shape its kernels do not take, it raises
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="S >= 128"):
        dot_product_attention(q, q, q, impl="flash")
    # paged is ported (P4): it builds, and a paged call needs its positions
    mha = MultiHeadAttention(16, 2, causal=True, paged=True)
    pool = PagedKVCache.zeros(1, 2, 4, 2, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="positions and block_tables"):
        mha(torch.zeros(1, 1, 16), pool, 0)
