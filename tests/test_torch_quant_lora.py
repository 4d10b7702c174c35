"""The port's decode-mode pieces on the CPU, against the JAX package.

- ``ops/quant.py``: ``quantize_tree``'s ``q`` and ``s`` equal the JAX
  package's ``quantize_leaf`` bit for bit (transposed: the port's weight
  is ``[out, in]``) for every 2-D weight, the head included, from the
  same f32 weights; the dequantized weight lies within half a step.
- ``ops/lora.py``, ``MultiHeadAttention`` and ``TransformerLM`` with
  stacked LoRA factors against the JAX modules on the same weights, with
  base rows (id -1) mixed in, within ``tests/test_torch_port_lm.py``'s
  tolerances; the grafted JAX tree crosses through ``from_jax``.
- ``serving/speculative.py``: ``greedy_accept`` and ``sampled_accept``
  against the JAX package's on the same numpy ``default_rng`` seeds.
- ``LoraRegistry``'s validation and graft, the metrics' per-adapter
  instruments and acceptance floor, and ``copy_rows``' sink row.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.ops.attention import MultiHeadAttention as JaxMHA
from pytorch_distributed_training_tpu.ops.lora import lora_delta as jax_lora_delta
from pytorch_distributed_training_tpu.ops.quant import quantize_tree as jax_quantize_tree
from pytorch_distributed_training_tpu.serving import speculative as jax_spec
from pytorch_distributed_training_tpu.serving.lora import LoraRegistry as JaxRegistry
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.ops.attention import MultiHeadAttention
from pytorch_distributed_training_tpu_torch.ops.lora import lora_delta
from pytorch_distributed_training_tpu_torch.ops.quant import (
    dequantize_tree,
    is_quantized_leaf,
    quantize_tree,
)
from pytorch_distributed_training_tpu_torch.serving import LoraRegistry, ServingMetrics
from pytorch_distributed_training_tpu_torch.serving import speculative as port_spec
from pytorch_distributed_training_tpu_torch.serving.decode import build_paged_fns

VOCAB = 61
SMALL = dict(max_len=32, embed_dim=32, depth=2, num_heads=4)


@pytest.fixture(scope="module")
def lm():
    """The JAX small LM's init with biases and scales perturbed, a JAX
    graft of two adapters (B factors nonzero), and the port's models."""
    jm = JaxLM(vocab_size=VOCAB, **SMALL)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        arr = np.asarray(leaf, np.float32)
        if path[-1].key in ("bias", "scale"):
            arr = arr + (0.1 * rng.normal(size=arr.shape)).astype(np.float32)
        return arr

    params = jax.tree_util.tree_map_with_path(perturb, params)
    pm = TransformerLM(VOCAB, **SMALL)
    pm.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return jm, params, pm.eval()


# --------------------------------------------------------------------- #
# int8 weights


def test_quantize_tree_matches_jax_bitwise(lm):
    _, params, pm = lm
    jq = jax_quantize_tree(params)
    state = pm.state_dict()
    pq = quantize_tree(state)
    checked = 0
    for name, node in pq.items():
        if not is_quantized_leaf(node):
            assert node is state[name], name  # passed through by reference
            continue
        *mods, _ = name.split(".")
        want = jq
        for m in mods:
            want = want[m]
        want = want["kernel"]
        q, s = node["q"], node["s"]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(want["q"]).T)
        np.testing.assert_array_equal(s.numpy(), np.asarray(want["s"]).T)
        w = state[name].numpy()
        err = np.abs(w - q.numpy().astype(np.float32) * s.numpy())
        assert (err <= s.numpy() / 2 + 1e-7).all(), name
        checked += 1
    assert checked == 4 * SMALL["depth"] + 1  # qkv, proj, fc1, fc2 a block + the head
    assert not is_quantized_leaf(pq["tok_embedding"])


def test_dequantize_rounds_once_to_the_dense_dtype():
    w = torch.randn(6, 5)
    w[2] = 0.0  # an all-zero channel: scale 1/127, q 0
    q = quantize_tree({"fc.weight": w, "fc.bias": torch.ones(6)})
    assert set(q) == {"fc.weight", "fc.bias"}
    assert torch.equal(q["fc.weight"]["s"][2], torch.tensor([1.0 / 127.0]))
    for dtype in (torch.float32, torch.bfloat16):
        deq = dequantize_tree(q, {"fc.weight": dtype})
        assert set(deq) == {"fc.weight"} and deq["fc.weight"].dtype == dtype
        want = (q["fc.weight"]["q"].float() * q["fc.weight"]["s"]).to(dtype)
        assert torch.equal(deq["fc.weight"], want)


# --------------------------------------------------------------------- #
# LoRA


def _ids():
    return np.asarray([1, -1, 0], np.int32)


def test_lora_delta_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    a = rng.normal(size=(2, 8, 4)).astype(np.float32)
    b = rng.normal(size=(2, 4, 12)).astype(np.float32)
    want = np.asarray(jax_lora_delta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(_ids())))
    got = lora_delta(torch.from_numpy(x).bfloat16(), torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(_ids()).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_lora_delta(jnp.asarray(x, jnp.bfloat16), jnp.asarray(a),
                                               jnp.asarray(b), jnp.asarray(_ids()))),
        atol=1e-5, rtol=1e-5)
    got = lora_delta(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(_ids()).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert not got[1].any()  # id -1: the base model
    with pytest.raises(ValueError, match="stacked"):
        lora_delta(torch.zeros(1, 1, 8), torch.zeros(8, 4), torch.zeros(2, 4, 12),
                   torch.zeros(1, dtype=torch.long))


def test_attention_with_lora_matches_jax():
    dim, heads = 32, 4
    jmod = JaxMHA(num_heads=heads, causal=True, lora_rank=4, lora_adapters=2)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 6, dim)).astype(np.float32)
    p = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), None, None, jnp.asarray(_ids()))
    p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), p["params"])
    for key in ("qkv_lora_b", "proj_lora_b"):  # zero-init B: make the delta real
        p[key] = (0.1 * rng.normal(size=p[key].shape)).astype(np.float32)
    want = np.asarray(jmod.apply({"params": p}, jnp.asarray(x), None, None,
                                 jnp.asarray(_ids())))
    mod = MultiHeadAttention(dim, heads, causal=True, lora_rank=4, lora_adapters=2)
    state = {f"{d}.weight": torch.from_numpy(np.ascontiguousarray(p[d]["kernel"].T))
             for d in ("qkv", "proj")}
    state.update({f"{d}.bias": torch.from_numpy(p[d]["bias"]) for d in ("qkv", "proj")})
    state.update({k: torch.from_numpy(p[k]) for k in p if "lora" in k})
    mod.load_state_dict(state, strict=True)
    got = mod(torch.from_numpy(x), adapter_ids=torch.from_numpy(_ids()).long())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="lora_adapters"):
        MultiHeadAttention(dim, heads, lora_rank=4)
    with pytest.raises(ValueError, match="no LoRA factors"):
        MultiHeadAttention(dim, heads)(torch.from_numpy(x), adapter_ids=torch.zeros(3).long())


@pytest.mark.parametrize("paged", [False, True], ids=["full", "paged"])
def test_lm_with_lora_matches_jax(lm, paged):
    """The grafted JAX tree through ``from_jax``; a cache-less forward and a
    paged prefill (positions, block tables), ids -1 mixed in."""
    jm, params, _ = lm
    reg = JaxRegistry(4, ["tenant-a", "tenant-b"])
    lm_j, lparams = reg.graft(jm, params)
    lparams = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), lparams)
    pm = TransformerLM(VOCAB, **SMALL, lora_rank=4, lora_adapters=2)
    pm.load_state_dict(lm_state_dict_from_jax(lparams), strict=True)
    pm.eval()
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, VOCAB, (3, 8)).astype(np.int32)
    ids = _ids()
    if not paged:
        want = np.asarray(lm_j.apply({"params": lparams}, jnp.asarray(tokens), None, None,
                                     jnp.asarray(ids)))
        with torch.no_grad():
            got = pm(torch.from_numpy(tokens).long(), adapter_ids=torch.from_numpy(ids).long())
    else:
        bs, nb = 4, 8
        pos = np.tile(np.arange(8, dtype=np.int32), (3, 1))
        pos[1, 5:] = -1
        tables = np.asarray([[0, 1], [2, 3], [4, 5]], np.int32)
        jp = lm_j.clone(decode=True, paged=True, kv_block_size=bs, kv_num_blocks=nb)
        want, _ = jp.apply({"params": lparams}, jnp.asarray(tokens), jnp.asarray(pos),
                           jnp.asarray(tables), jnp.asarray(ids), mutable=["cache"])
        want = np.asarray(want)[pos >= 0]
        pool = pm.new_pool(nb, bs)
        with torch.no_grad():
            got, _ = pm(torch.from_numpy(tokens).long(), pool, torch.from_numpy(pos).long(),
                        torch.from_numpy(tables).long(), torch.from_numpy(ids).long())
        got = got[torch.from_numpy(pos >= 0)]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # the adapters change the logits; the base row (id -1) is the base model's
    with torch.no_grad():
        base = TransformerLM(VOCAB, **SMALL)
        base.load_state_dict(lm_state_dict_from_jax(params), strict=True)
        plain = base(torch.from_numpy(tokens).long())
    if not paged:
        np.testing.assert_allclose(got[1].numpy(), plain[1].numpy(), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="no LoRA factors"):
        base(torch.from_numpy(tokens).long(), adapter_ids=torch.from_numpy(ids).long())


def test_registry_validation_graft_and_merge(lm):
    _, _, pm = lm
    for bad, match in (((0, ["a"]), "rank"), ((4, []), "at least one"),
                       ((4, ["a", {"name": "a"}]), "duplicate"),
                       ((4, [{"name": "a", "rank": 2}]), "unknown serving.lora.adapters"),
                       ((4, [{"seed": 1}]), "needs a name")):
        with pytest.raises(ValueError, match=match):
            LoraRegistry(*bad)
    reg = LoraRegistry(4, ["a", {"name": "b", "seed": 7}])
    assert reg.id_of("b") == 1 and len(reg) == 2
    with pytest.raises(ValueError, match="registered"):
        reg.id_of("nope")
    g1, g2 = reg.graft(pm), reg.graft(pm)
    state = g1.state_dict()
    # base leaves are the base model's tensors; factors repeat for a seed
    assert state["block0.attn.qkv.weight"].data_ptr() == pm.block0.attn.qkv.weight.data_ptr()
    a = state["block1.attn.proj_lora_a"]
    assert a.shape == (2, SMALL["embed_dim"], 4) and state["block1.attn.qkv_lora_b"].abs().sum()
    assert torch.equal(a, g2.state_dict()["block1.attn.proj_lora_a"])
    assert not torch.equal(a[0], a[1])
    merged = reg.merged_params(state, "b")
    assert not any("lora" in k for k in merged)
    want = pm.block0.attn.qkv.weight + (state["block0.attn.qkv_lora_a"][1]
                                        @ state["block0.attn.qkv_lora_b"][1]).T
    assert torch.equal(merged["block0.attn.qkv.weight"], want)
    assert merged["block0.mlp.fc1.weight"] is state["block0.mlp.fc1.weight"]


# --------------------------------------------------------------------- #
# speculative accept rules


def test_accept_rules_match_jax():
    rng = np.random.default_rng(5)
    for case in range(40):
        k = int(rng.integers(1, 5))
        draft = rng.integers(0, 4, k)
        target = rng.integers(0, 4, k + 1)
        if case % 3 == 0:
            target[:k] = draft  # a clean sweep
        assert port_spec.greedy_accept(draft, target) == jax_spec.greedy_accept(draft, target)
        q = rng.dirichlet(np.ones(6), size=k)
        p = rng.dirichlet(np.ones(6), size=k + 1)
        d = [int(rng.choice(6, p=row)) for row in q]
        got = port_spec.sampled_accept(d, q, p, np.random.default_rng(case))
        assert got == jax_spec.sampled_accept(d, q, p, np.random.default_rng(case))
    with pytest.raises(ValueError, match=r"k\+1"):
        port_spec.greedy_accept([1, 2], [1, 2])
    with pytest.raises(ValueError, match="k must be"):
        port_spec.SpeculativeSpec(0)


# --------------------------------------------------------------------- #
# metrics and copy_rows


def test_metrics_per_adapter_and_acceptance_floor(caplog):
    import time

    m = ServingMetrics()
    t0 = time.monotonic() - 0.01
    m.record_request(t0, gen_len=4, adapter="tenant-a")
    m.record_request(t0, gen_len=2, adapter="tenant-a")
    m.record_request(t0, gen_len=8, adapter="tenant-b")
    m.record_request(t0, gen_len=1)
    snap = m.snapshot()
    assert snap["requests"] == 4 and snap["gen_tokens"] == 15
    assert snap["adapter_tenant-a_requests"] == 2 and snap["adapter_tenant-a_gen_tokens"] == 6
    assert snap["adapter_tenant-b_gen_tokens"] == 8 and snap["adapter_tenant-b_latency_ms_p99"] > 0
    m.incr("spec_proposed", 8)
    m.incr("spec_accepted", 1)
    assert m.snapshot()["spec_acceptance_rate"] == 0.125
    assert "spec_acceptance_below_floor" not in m.snapshot()
    m.spec_min_acceptance = 0.2
    with caplog.at_level(logging.WARNING):
        assert m.snapshot()["spec_acceptance_below_floor"] == 1.0
        m.snapshot()
    assert sum("min_acceptance" in r.getMessage() for r in caplog.records) == 1


def test_copy_rows_drops_out_of_range_rows_on_the_sink():
    model = TransformerLM(VOCAB, **SMALL).eval()
    fns = build_paged_fns(model, block_size=4, num_blocks=3)
    pool = fns.init_pool()
    for i, t in enumerate(pool.keys + pool.values):
        t.copy_(torch.arange(t.numel(), dtype=t.dtype).view(t.shape) + 1000 * i)
    before = [t.clone() for t in pool.keys + pool.values]
    rows = pool.pool_rows
    fns.copy_rows(pool, np.asarray([1, 2, 5, 99]), np.asarray([9, rows, -1, 10]))
    assert fns.calls["copy_rows"] == 1
    for t, b in zip(pool.keys + pool.values, before):
        changed = sorted(set(torch.nonzero((t != b).flatten(1).any(1)).flatten().tolist()))
        assert changed == [9, 10, rows]  # rows 9 and 10, and the sink for the rest
        assert torch.equal(t[9], b[1]) and torch.equal(t[10], b[rows - 1])  # src clamped
