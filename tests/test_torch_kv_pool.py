"""The port's paged-pool bookkeeping and trace spans against the JAX package's.

``serving/kv_pool.py`` of the port is its own copy of the JAX module (the
port imports nothing of the JAX package).  Both pools are driven through
one seeded trace of admit, register and release, with prompts that share
block-aligned prefixes and a pool small enough to wait and to evict: every
admission's block ids, every refcount, the prefix cache's entries in LRU
order, the free list and the eviction count must agree at every step.
"""
import numpy as np
import pytest

from pytorch_distributed_training_tpu.serving import kv_pool as jkv
from pytorch_distributed_training_tpu.telemetry import spans as jspans
from pytorch_distributed_training_tpu_torch.serving import kv_pool as pkv
from pytorch_distributed_training_tpu_torch.telemetry import spans as pspans


def _state(pool):
    return (list(pool._alloc._free), sorted(pool._alloc._allocated), dict(pool._ref),
            list(pool._cache.items()), pool.prefix_evictions, pool.blocks_in_use)


def _trace(seed, prefix_cache, steps=60):
    """(op, args) pairs: prompts drawn from a few shared stems so prefixes
    hit, lengths and budgets so the 12-block pool waits and evicts."""
    rng = np.random.default_rng(seed)
    stems = [rng.integers(0, 50, 12).tolist() for _ in range(3)]
    ops = []
    for _ in range(steps):
        if rng.random() < 0.4:
            ops.append(("release", int(rng.integers(0, 1 << 20))))
            continue
        stem = stems[int(rng.integers(0, 3))]
        cut = int(rng.integers(1, len(stem) + 1))
        prompt = stem[:cut] + rng.integers(0, 50, int(rng.integers(0, 6))).tolist()
        ns = int(rng.integers(0, 2)) if prefix_cache else None
        ops.append(("admit", (prompt, int(rng.integers(1, 9)), ns)))
    return ops


@pytest.mark.parametrize("prefix_cache", [True, False], ids=["prefix", "noprefix"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pool_trace_matches_jax(seed, prefix_cache):
    jp = jkv.PagedKVPool(12, 4, prefix_cache)
    pp = pkv.PagedKVPool(12, 4, prefix_cache)
    held = []  # (jax admission, port admission, prompt, namespace)
    waits = 0
    for op, arg in _trace(seed, prefix_cache):
        if op == "release":
            if not held:
                continue
            ja, pa, _, _ = held.pop(arg % len(held))
            jp.release(ja)
            pp.release(pa)
        else:
            prompt, max_new, ns = arg
            if jp.blocks_needed(len(prompt), max_new) > jp.num_blocks:
                continue
            pa = pp.admit(prompt, max_new, namespace=ns)
            try:
                ja = jp.admit(prompt, max_new, namespace=ns)
            except KeyError:
                # the JAX pool's eviction of a chain it just looked up (see
                # test_eviction_of_the_looked_up_chain): the port admitted
                # against a shorter chain; the two pools part here
                pp.check_invariants()
                return
            assert (ja is None) == (pa is None)
            if ja is None:
                waits += 1
                continue
            assert (pa.block_ids, pa.n_shared, pa.cached_len) == (
                ja.block_ids, ja.n_shared, ja.cached_len)
            jp.register_prefix(prompt, ja, namespace=ns)
            pp.register_prefix(prompt, pa, namespace=ns)
            held.append((ja, pa, prompt, ns))
        assert _state(pp) == _state(jp)
        pp.check_invariants()
    assert waits > 0  # the trace did reach a full pool
    if prefix_cache:
        assert pp.prefix_evictions > 0
        assert any(pa.n_shared for _, pa, _, _ in held) or jp.prefix_evictions
    for ja, pa, _, _ in held:
        jp.release(ja)
        pp.release(pa)
    assert _state(pp) == _state(jp)


def test_eviction_of_the_looked_up_chain():
    """An admission whose LRU sweep reaches the prefix chain it just looked
    up: the JAX pool frees those blocks and then raises ``KeyError`` taking
    its references (``kv_pool.py:198``); the port gives the fresh blocks
    back and admits again against the chain that is left."""
    prompt = list(range(9))  # two cacheable blocks
    pools = {}
    for name, mod in (("jax", jkv), ("port", pkv)):
        pool = mod.PagedKVPool(4, 4, True)
        adm = pool.admit(prompt, 3)
        pool.register_prefix(prompt, adm)
        pool.release(adm)  # two cache-only blocks, two free
        pool.admit([49], 1)  # one of the free blocks held
        pools[name] = pool
    with pytest.raises(KeyError):
        pools["jax"].admit(prompt, 7)  # 2 shared + 2 fresh; 1 free
    port = pools["port"]
    assert port.admit(prompt, 7) is None  # 4 blocks, 1 held: it waits
    port.check_invariants()
    assert port.lookup_prefix(prompt) == [] and port.prefix_evictions == 2
    assert port.blocks_in_use == 1
    adm = port.admit(prompt, 3)  # 3 fresh blocks still fit
    assert adm is not None and adm.n_shared == 0
    port.check_invariants()


def test_allocator_and_admission_errors_as_jax():
    for mod in (jkv, pkv):
        a = mod.BlockAllocator(num_blocks=4, block_size=8)
        assert sorted(a.alloc(3)) == [0, 1, 2] and a.alloc(2) is None and a.num_free == 1
        a.free([1])
        assert a.alloc(1) == [1]  # LIFO: the block freed last comes first
        with pytest.raises(ValueError, match="double free"):
            a.free([3, 3])
        pool = mod.PagedKVPool(num_blocks=4, block_size=4, prefix_cache=False)
        with pytest.raises(ValueError, match="only has"):
            pool.admit(list(range(16)), 4)
        with pytest.raises(ValueError, match="extra_blocks"):
            pool.admit([1], 1, extra_blocks=-1)
        with pytest.raises(ValueError, match="num_blocks"):
            mod.BlockAllocator(0, 4)


def test_transfer_bookkeeping_as_jax():
    """``cached_chain``/``adopt_block`` (kept for kv-transfer, P6) give the
    same chain keys and blocks on both sides."""
    prompt = list(range(13))
    out = []
    for mod in (jkv, pkv):
        pool = mod.PagedKVPool(8, 4, True)
        adm = pool.admit(prompt, 2)
        pool.register_prefix(prompt, adm)
        chain = pool.cached_chain(prompt)
        pool.release(adm)
        other = pool.adopt_block(("x",))
        assert pool.is_cached(("x",)) and not pool.is_cached(("y",))
        pool.check_invariants()
        out.append((chain, other, _state(pool)))
    assert out[0] == out[1]


def test_check_invariants_catches_a_leak():
    pool = pkv.PagedKVPool(4, 4, prefix_cache=False)
    adm = pool.admit([1, 2, 3], 2)
    pool._ref.pop(adm.block_ids[0])  # a refcount lost
    with pytest.raises(AssertionError, match="refcount"):
        pool.check_invariants()


def test_spans_record_as_jax():
    records = []
    for mod in (jspans, pspans):
        rec = mod.set_recorder(mod.SpanRecorder(ring=2))
        with mod.span("decode_step", step=3, active=2):
            pass
        with mod.span("serving_restart", step=4, cause="DeviceLostError"):
            pass
        with mod.span("poison_bisect", step=5):
            pass
        recent = rec.recent()
        assert mod.get_recorder() is rec and rec.recent(1) == recent[-1:]
        assert all(r["ms"] >= 0 for r in recent)
        mod.set_recorder(None)
        assert mod.get_recorder() is not rec
        records.append([{k: r[k] for k in ("kind", "step", "host", "thread")} |
                        {k: v for k, v in r.items() if k in ("active", "cause")}
                        for r in recent])
    assert records[0] == records[1]
    assert [r["kind"] for r in records[1]] == ["serving_restart", "poison_bisect"]
