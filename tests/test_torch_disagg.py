"""The port's KV-block transfer and prefill/decode disaggregation on the CPU.

- ``payload_checksum`` equal to the JAX package's over the same names and
  arrays, f32 and bf16 (the port stages bf16 as ``uint16`` bits named
  ``bfloat16``), and ``FleetCacheDirectory.key_of`` equal to JAX's; the
  CRC rejects a flipped byte, another address and a reshape.
- The tentpole oracle of ``tests/test_disagg.py``: a block transferred
  into another replica's pool holds the same K/V rows, byte for byte, as
  the block that replica computes itself, and the streams decoded over it
  are a recompute's (f32 and bf16); the port's exports name, key and
  shape their blocks as the JAX scheduler's do on the same weights, and
  its streams over imported blocks equal the JAX scheduler's greedy ones.
- Each rung of the recovery ladder with its counter: a prefill replica
  that dies mid-transfer, a corrupt payload, a stalled transfer; a corrupt
  block in mid-chain; a pool without a prefix cache; first writer wins;
  namespaces never alias; closed and dead schedulers refuse; the
  directory's LRU and its eviction of a retired replica; refs that outlive
  later writes to the pool; the coordinator end to end on threaded
  replicas, its threads gone after ``close``.

The small LM of ``tests/test_fleet.py`` (vocab 61, 32 wide, depth 2), its
JAX weights drawn with numpy over ``jax.eval_shape``; the JAX scheduler
runs once, in a module fixture.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.serving import kv_transfer as jkv
from pytorch_distributed_training_tpu.serving.disagg import FleetCacheDirectory as JaxDirectory
from pytorch_distributed_training_tpu.serving.scheduler import (
    ContinuousScheduler as JaxScheduler,
)
from pytorch_distributed_training_tpu_torch.engine import fault
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.serving import (
    ContinuousScheduler,
    DisaggFleet,
    FleetCacheDirectory,
    FleetRouter,
    ServingFleet,
    kv_transfer,
)
from pytorch_distributed_training_tpu_torch.serving.kv_transfer import (
    BlockPayload,
    corrupt_payload,
    payload_checksum,
    verify_payload,
)

VOCAB = 61
SMALL = dict(max_len=32, embed_dim=32, depth=2, num_heads=4)
REPLICA = dict(slots=4, block_size=4, num_blocks=16, batch_buckets=[4], seq_buckets=[16],
               max_new_tokens=8, temperature=0.0, eos_id=None, prefix_cache=True, start=False)
# 13 tokens: (13 - 1) // 4 = 3 full cached blocks, a real chain
PROMPT = np.array([7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53], np.int32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fault_hygiene():
    fault.install(None)
    fault.reset_counters()
    yield
    fault.install(None)


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(vocab_size=VOCAB, **SMALL)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(2)

    def draw(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        leaf = path[-1].key
        if leaf == "kernel":
            return x / np.float32(np.sqrt(s.shape[0]))
        return 1.0 + 0.1 * x if leaf == "scale" else (0.1 if leaf == "bias" else 0.5) * x

    params = jax.tree_util.tree_map_with_path(draw, shapes)["params"]
    pm = TransformerLM(VOCAB, **SMALL)
    pm.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return jm, params, pm.eval()


@pytest.fixture(scope="module")
def bf16_model(lm):
    pm = TransformerLM(VOCAB, dtype=torch.bfloat16, **SMALL)
    pm.load_state_dict(lm[2].state_dict(), strict=True)
    return pm.cast_matmul_weights_().eval()


def _replica(model, rid, **kw):
    return ContinuousScheduler(model, **{**REPLICA, "replica_id": rid, **kw})


def _serve(sched, prompt, limit=300, **kw):
    fut = sched.submit(prompt, **kw)
    n = 0
    while not fut.done():
        sched.tick()
        n += 1
        assert n < limit, "the scheduler did not converge"
    return fut.result()["tokens"].tolist()


def _export(sched, prompt, namespace=-1):
    fut = sched.export_kv_prefix(prompt, namespace=namespace)
    sched.tick()
    return fut.result(timeout=5)


def _import(sched, payloads):
    fut = sched.import_kv_blocks(payloads)
    sched.tick()
    return fut.result(timeout=5)


def _rows(sched, keys):
    """Each chain key's pool rows in every leaf, on the host."""
    bs = sched._kv.block_size
    leaves = kv_transfer.pool_row_leaves(sched._pool, sched._kv.num_blocks * bs)
    out = []
    for key in keys:
        blk = sched._kv._cache[key]
        out.append({n: leaf[blk * bs:(blk + 1) * bs].clone() for n, leaf in leaves})
    return out


@pytest.fixture(scope="module")
def jax_export(lm):
    """The JAX scheduler's greedy stream of PROMPT and its export."""
    jm, params, _ = lm
    js = JaxScheduler(jm, params, **REPLICA)
    fut = js.submit(PROMPT)
    while not fut.done():
        js.tick()
    tokens = list(map(int, fut.result()["tokens"]))
    xf = js.export_kv_prefix(PROMPT, namespace=-1)
    js.tick()
    payloads = xf.result(timeout=5)
    names = [n for n, _ in jkv.pool_row_leaves(js._pool, js._kv.num_blocks * js._kv.block_size)]
    js.close()
    return tokens, payloads, names


# --------------------------------------------------------------------- #
# the directory and the checksum against the JAX package's


def test_key_of_matches_jax():
    for prompt, bs, ns in (([1, 2, 3, 4], 4, -1), ([1, 2], 4, -1), ([1, 2, 3, 4, 5], 4, -1),
                           ([1, 2, 3, 4, 5], 4, 0), ([1, 2, 3, 4, 9, 9], 4, -1),
                           (list(PROMPT), 4, 7), (list(PROMPT), 8, -1), (list(PROMPT), 0, -1)):
        assert FleetCacheDirectory.key_of(prompt, bs, ns) == JaxDirectory.key_of(prompt, bs, ns)
    assert FleetCacheDirectory.key_of([1, 2, 3, 4, 5], 4) == (-1, (1, 2, 3, 4))


def test_directory_lru_and_evict_replica():
    d = FleetCacheDirectory(capacity=2)
    d.publish(("a",), 0)
    d.publish(("b",), 1)
    assert d.lookup(("a",)) == 0  # refreshes its recency
    d.publish(("c",), 1)  # evicts the least recent, ("b",)
    assert d.lookup(("b",)) is None and d.lookup(("a",)) == 0 and d.lookup(("c",)) == 1
    d.publish(("a",), 1)  # the last writer wins
    assert d.evict_replica(1) == 2 and len(d) == 0
    snap = d.snapshot()
    assert (snap["hits"], snap["misses"], snap["evictions"]) == (3, 1, 3)
    d.count_reject(2)
    assert d.snapshot()["rejects"] == 2
    assert fault.counters()["serving_fleet_cache_rejects"] == 2
    with pytest.raises(ValueError):
        FleetCacheDirectory(capacity=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_payload_checksum_matches_jax(dtype):
    rng = np.random.default_rng(4)
    key = ((-1,), (1, 2, 3, 4))
    ref = {n: rng.standard_normal((4, 2, 8)).astype(np.float32)
           for n in ("block0/attn/k_pool", "block0/attn/v_pool")}
    if dtype == "float32":
        arrays, dtypes, jarrays = ref, {}, ref
    else:
        t = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in ref.items()}
        arrays = {n: x.view(torch.int16).numpy().view(np.uint16) for n, x in t.items()}
        dtypes = {n: "bfloat16" for n in arrays}
        jarrays = {n: np.asarray(a, dtype=jnp.bfloat16) for n, a in ref.items()}
        assert all(arrays[n].tobytes() == jarrays[n].tobytes() for n in arrays)
    crc = payload_checksum(key, 0, arrays, dtypes)
    assert crc == jkv.payload_checksum(key, 0, jarrays)
    p = BlockPayload(key=key, index=0, arrays=dict(arrays), crc=crc, dtypes=dtypes)
    assert verify_payload(p) and p.nbytes == sum(a.nbytes for a in arrays.values())
    # the identity and the layout are sealed, not only the bytes
    assert payload_checksum(key, 1, arrays, dtypes) != crc
    assert payload_checksum(((-1,), (9, 9, 9, 9)), 0, arrays, dtypes) != crc
    assert payload_checksum(key, 0, {n: a.reshape(4, 16) for n, a in arrays.items()},
                            dtypes) != crc
    corrupt_payload(p)
    assert not verify_payload(p)


# --------------------------------------------------------------------- #
# transfer == recompute


def test_export_matches_jax_and_imported_streams_equal_jax(lm, jax_export):
    jtokens, jpayloads, jnames = jax_export
    pm = lm[2]
    src, dst = _replica(pm, 0), _replica(pm, 1)
    assert _serve(src, PROMPT) == jtokens
    payloads = _export(src, PROMPT)
    assert [n for n, _ in kv_transfer.pool_row_leaves(src._pool, 64)] == jnames
    assert [(p.key, p.index) for p in payloads] == [(p.key, p.index) for p in jpayloads]
    for p, j in zip(payloads, jpayloads):
        assert sorted(p.arrays) == sorted(j.arrays)
        for n in p.arrays:
            assert p.arrays[n].dtype == j.arrays[n].dtype and p.arrays[n].shape == j.arrays[n].shape
            np.testing.assert_allclose(p.arrays[n], j.arrays[n], rtol=1e-5, atol=1e-5)
    assert _import(dst, payloads)["accepted"] == 3
    assert _serve(dst, PROMPT) == jtokens and dst._hit_blocks == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transfer_bitwise_identical_to_recompute(lm, bf16_model, dtype):
    model = lm[2] if dtype == "float32" else bf16_model
    src, dst, ref = (_replica(model, i) for i in range(3))
    expected = _serve(src, PROMPT)
    payloads = _export(src, PROMPT)
    assert [p.index for p in payloads] == [0, 1, 2] and all(map(verify_payload, payloads))
    assert payloads[1].key[0] == payloads[0].key and payloads[2].key[0] == payloads[1].key
    want_dtype = np.float32 if dtype == "float32" else np.uint16
    assert all(a.dtype == want_dtype for a in payloads[0].arrays.values())
    res = _import(dst, payloads)
    assert res == {"accepted": 3, "rejected": 0, "bytes": sum(p.nbytes for p in payloads)}
    dst._kv.check_invariants()
    assert _serve(ref, PROMPT) == expected  # the recompute
    keys = [p.key for p in payloads]
    for got, want in zip(_rows(dst, keys), _rows(ref, keys)):
        for n in want:
            assert torch.equal(got[n].view(torch.uint8), want[n].view(torch.uint8)), n
    assert _serve(dst, PROMPT) == expected and dst._hit_blocks == 3
    again = _export(dst, PROMPT)  # transfers compose without drift
    assert [p.crc for p in again] == [p.crc for p in payloads]
    snap = dst.metrics.snapshot()
    assert snap["kv_transfer_blocks"] == 3 and snap["kv_transfer_ms_p50"] >= 0.0
    assert fault.counters()["serving_r1_kv_transfer_bytes"] == res["bytes"]
    for s in (src, dst, ref):
        s.close()


def test_corrupt_block_rejected_chain_dropped_tokens_unchanged(lm):
    pm = lm[2]
    src, mid, first = (_replica(pm, i) for i in range(3))
    expected = _serve(src, PROMPT)
    payloads = _export(src, PROMPT)
    corrupt_payload(payloads[1])  # mid-chain: the verified head lands
    assert _import(mid, payloads)["accepted"] == 1
    assert mid._kv.is_cached(payloads[0].key) and not mid._kv.is_cached(payloads[1].key)
    mid._kv.check_invariants()
    assert _serve(mid, PROMPT) == expected and mid._hit_blocks == 1
    payloads = _export(src, PROMPT)
    corrupt_payload(payloads[0])
    res = _import(first, payloads)
    assert (res["accepted"], res["rejected"]) == (0, 1)
    assert _serve(first, PROMPT) == expected and first._hit_blocks == 0
    assert fault.counters()["serving_r2_kv_transfer_rejects"] == 1


def test_import_rejects_a_foreign_dtype_and_undoes_a_failed_scatter(lm, bf16_model, monkeypatch):
    """No cast and no half-import: f32 rows offered to a bf16 pool are
    rejected as a bad CRC is, and a scatter that raises (say, out of
    memory) leaves no key naming an unwritten block."""
    pm = lm[2]
    src, half, dst = _replica(pm, 0), _replica(bf16_model, 1), _replica(pm, 2)
    expected = _serve(src, PROMPT)
    payloads = _export(src, PROMPT)
    assert _import(half, payloads) == {"accepted": 0, "rejected": 1, "bytes": 0}
    assert not any(half._kv.is_cached(p.key) for p in payloads)
    assert fault.counters()["serving_r1_kv_transfer_rejects"] == 1
    narrow = BlockPayload(key=payloads[0].key, index=0, dtypes=payloads[0].dtypes,
                          arrays={n: a[:, :1] for n, a in payloads[0].arrays.items()}, crc=0)
    narrow.crc = payload_checksum(narrow.key, 0, narrow.arrays, narrow.dtypes)
    assert "shape" in kv_transfer.payload_mismatch(narrow, dst._pool, dst._kv.block_size)
    used = dst._kv.blocks_in_use

    def oom(*args, **kwargs):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(kv_transfer, "scatter_payloads", oom)
    fut = dst.import_kv_blocks(payloads)
    dst.tick()
    with pytest.raises(RuntimeError, match="out of memory"):
        fut.result(timeout=5)
    monkeypatch.undo()
    assert not any(dst._kv.is_cached(p.key) for p in payloads)
    assert dst._kv.blocks_in_use == used
    dst._kv.check_invariants()
    assert _serve(dst, PROMPT) == expected and dst._hit_blocks == 0
    for s in (src, half, dst):
        s.close()


def test_import_into_cache_disabled_pool_is_a_noop(lm):
    pm = lm[2]
    src, dst = _replica(pm, 0), _replica(pm, 1, prefix_cache=False)
    expected = _serve(src, PROMPT)
    assert _import(dst, _export(src, PROMPT)) == {"accepted": 0, "rejected": 0, "bytes": 0}
    dst._kv.check_invariants()
    assert _serve(dst, PROMPT) == expected


def test_import_is_first_writer_wins(lm):
    pm = lm[2]
    src, dst = _replica(pm, 0), _replica(pm, 1)
    _serve(src, PROMPT)
    _serve(dst, PROMPT)  # dst prefilled the prefix itself
    used = dst._kv.blocks_in_use
    assert _import(dst, _export(src, PROMPT)) == {"accepted": 0, "rejected": 0, "bytes": 0}
    assert dst._kv.blocks_in_use == used
    dst._kv.check_invariants()


def test_cross_namespace_prefix_never_exports(lm):
    src = _replica(lm[2], 0)
    _serve(src, PROMPT)
    assert len(_export(src, PROMPT, namespace=-1)) == 3
    assert src._kv.cached_chain(PROMPT, namespace=7) == []
    assert _export(src, PROMPT, namespace=7) == []


def test_verbs_refuse_closed_and_dead_schedulers(lm):
    pm = lm[2]
    sched = _replica(pm, 0)
    sched.close()
    with pytest.raises(RuntimeError):
        sched.export_kv_prefix(PROMPT)
    with pytest.raises(RuntimeError):
        sched.import_kv_blocks([])
    dead = _replica(pm, 1)
    fut = dead.export_kv_refs(PROMPT)
    dead.hard_kill(fault.DeviceLostError("the replica dies"))
    dead.tick()  # the death: queued verbs fail, they do not hang
    with pytest.raises(fault.DeviceLostError):
        fut.result(timeout=5)
    with pytest.raises(RuntimeError):
        dead.export_kv_prefix(PROMPT)


def test_block_refs_outlive_later_pool_writes(lm):
    """Refs are a gathered copy: writes to the pool after the export do not
    reach them (the JAX package has immutable arrays for this)."""
    sched = _replica(lm[2], 0)
    _serve(sched, PROMPT)
    one_shot = kv_transfer.extract_payloads(sched._kv, sched._pool, PROMPT, namespace=-1)
    refs = kv_transfer.extract_block_refs(sched._kv, sched._pool, PROMPT, namespace=-1)
    for t in sched._pool.keys + sched._pool.values:
        t.zero_()
    for chunk_rows in (None, 1, 3):
        staged = kv_transfer.materialize_payloads(refs, chunk_rows)
        assert [p.crc for p in staged] == [p.crc for p in one_shot]
        assert all(np.array_equal(a.arrays[n], b.arrays[n])
                   for a, b in zip(staged, one_shot) for n in a.arrays)
    with pytest.raises(ValueError, match="chunk_rows"):
        kv_transfer.materialize_payloads(refs, 0)
    fut = sched.export_kv_refs(PROMPT, namespace=-1)
    sched.tick()
    assert len(fut.result(timeout=5)) == 3
    assert sched.metrics.snapshot()["kv_transfer_exported_blocks"] == 3


# --------------------------------------------------------------------- #
# the fleet side: membership coherence, config, the ladder, end to end


def _router(reps):
    return FleetRouter(reps, base_key=(42,), heartbeat_timeout_s=None, start_monitor=False)


def test_remove_replica_evicts_its_directory_entries(lm):
    pm = lm[2]
    r0, r1 = _replica(pm, 0, prefix_cache=False), _replica(pm, 1, prefix_cache=False)
    router = _router([r0, r1])
    fleet = ServingFleet([r0, r1], router)
    directory = FleetCacheDirectory()
    fleet.cache_directory = directory
    directory.publish((-1, (1, 2, 3, 4)), 1)
    directory.publish((-1, (5, 6, 7, 8)), 0)
    fleet.remove_replica(1)
    assert directory.lookup((-1, (1, 2, 3, 4))) is None
    assert directory.lookup((-1, (5, 6, 7, 8))) == 0 and len(directory) == 1
    assert router.peek_placement(PROMPT) == 0
    fleet.close()


def test_disagg_config_validation(lm):
    r0 = _replica(lm[2], 0, prefix_cache=False)
    fleet = ServingFleet([r0], _router([r0]))
    for dcfg in ({"enabled": False}, {"bogus_key": 1}, {"transfer_deadline_ms": 0},
                 {"transfer_workers": 0}, {"prefill_replicas": 0}, {"staging_workers": 0},
                 {"staging_chunk_rows": 0}):
        with pytest.raises(ValueError):
            DisaggFleet(fleet, disagg=dcfg, prefill_replicas=[object()])
    fleet.close()


def _disagg(model, **dcfg):
    decode = [_replica(model, i, start=True) for i in range(2)]
    prefill = _replica(model, 100, start=True)
    fleet = ServingFleet(decode, _router(decode))
    return DisaggFleet(fleet, disagg={"transfer_workers": 1, **dcfg}, prefill_replicas=[prefill])


def _leaked(before):
    """Threads of the fleet tier started since ``before`` and still alive
    (another file in the same worker may have left its own)."""
    return [t.name for t in set(threading.enumerate()) - before
            if t.name.startswith(("disagg-", "kv-staging", "serving-scheduler", "fleet-monitor"))]


@pytest.mark.parametrize("spec,counter,dcfg", [
    ("prefill_replica_down@1:0", "serving_disagg_transfer_recomputes", {}),
    ("kv_transfer_corrupt@1", "serving_disagg_rejects", {}),
    ("kv_transfer_stall@1:0.4", "serving_disagg_deadline_degrades",
     {"transfer_deadline_ms": 100.0}),
], ids=["prefill_down", "corrupt", "stall"])
def test_recovery_ladder_recomputes_same_tokens(lm, spec, counter, dcfg):
    pm = lm[2]
    ref = _replica(pm, 9)
    expected = _serve(ref, PROMPT)
    fault.install(spec)
    before = set(threading.enumerate())
    disagg = _disagg(pm, **dcfg)
    try:
        got = disagg.submit(PROMPT).result(timeout=60)["tokens"].tolist()
    finally:
        disagg.close()
    assert got == expected
    c = fault.counters()
    assert c[counter] >= 1 and c["serving_disagg_transfers"] == 1
    assert fault.get_injector().pending() == {}
    if "corrupt" in spec:
        assert disagg.directory.snapshot()["rejects"] == 1
    else:
        assert len(disagg.directory) == 0  # nothing published
    assert not _leaked(before)


def test_disagg_coordinator_end_to_end(lm, jax_export):
    """Two prefix groups of two requests: the first of each transfers from
    the prefill replica, the second rides its directory entry; the streams
    equal the JAX scheduler's greedy ones and a recompute's."""
    pm = lm[2]
    prompts = [np.r_[PROMPT[:4], sfx].astype(np.int32)
               for sfx in ([5, 6, 7, 8, 9], [10, 11, 12], [5, 6, 7, 8, 9], [10, 11, 12])]
    ref = _replica(pm, 9)
    expected = [_serve(ref, p) for p in prompts]
    before = set(threading.enumerate())
    disagg = _disagg(pm, transfer_deadline_ms=60_000.0)
    try:
        assert disagg.submit(PROMPT).result(timeout=60)["tokens"].tolist() == jax_export[0]
        streams = {i: [] for i in range(len(prompts))}
        futs = [disagg.submit(p, on_token=lambda t, i=i: streams[i].append(t))
                for i, p in enumerate(prompts)]
        got = [f.result(timeout=60)["tokens"].tolist() for f in futs]
        snap = disagg.snapshot()
        for rep in disagg.fleet.replicas:
            rep._kv.check_invariants()
    finally:
        disagg.close()
    assert got == expected and [streams[i] for i in range(len(prompts))] == expected
    assert fault.counters()["serving_disagg_transfers"] >= 1
    assert snap["disagg"]["transfers"] >= 1 and snap["disagg"]["directory"]["entries"] >= 1
    assert snap["disagg"]["prefill_replicas"] == 1 and set(snap["disagg"]["prefill"]) == {"p0"}
    assert sum(s.get("kv_transfer_blocks", 0) for s in snap["replicas"].values()) >= 1
    assert not _leaked(before)
