"""The port's fleet router and ServingFleet on the CPU.

The tentpole oracle, as ``tests/test_fleet.py``'s: killing a replica
mid-stream completes every request with a stream bitwise equal to an
unkilled twin of the port (greedy and sampled), ``on_token`` never fires
twice for a token, and ``replay_parity_mismatch`` stays 0.  The router
fixes each request's key once (``base_key + (n,)``), so the survivor's
replay resumes the dead replica's per-token draws.  Also: greedy fleet
streams equal one JAX ``ContinuousScheduler`` run on the same weights
(converted by ``from_jax``), the ``replica_down`` and ``replica_hang``
faults, heartbeat staleness, the liveness clock, affinity, placement
around a down replica, ``FleetDownError``, shedding, first-writer-wins
hedging, concurrent drain and SIGTERM, the ``serving_r<i>_*`` names and
``aggregate_snapshots``, scale-down through drain, a sticky CUDA error in
every replica, ``ServingFleet.from_config`` over one shared model, and
int8 replicas whose weight swaps never reach that model.

The small LM of ``tests/test_fleet.py`` (vocab 61, 32 wide, depth 2),
its JAX weights drawn with numpy over ``jax.eval_shape``.  Replicas are
built with ``start=False`` and ticked by hand, the router with
``start_monitor=False`` and polled by hand (``_poll_once``), so kill
order is scripted; the JAX scheduler runs once, in a module fixture.
"""
import json
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.serving.scheduler import (
    ContinuousScheduler as JaxScheduler,
)
from pytorch_distributed_training_tpu_torch.engine import fault
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.serving import (
    ContinuousScheduler,
    EngineRestartError,
    FleetDownError,
    FleetRouter,
    InferenceEngine,
    OverloadedError,
    ReplicaDownError,
    ServingFleet,
    ServingMetrics,
    aggregate_snapshots,
)
from pytorch_distributed_training_tpu_torch.telemetry.registry import get_registry

VOCAB = 61
SMALL = dict(max_len=32, embed_dim=32, depth=2, num_heads=4)
REPLICA = dict(slots=4, block_size=4, num_blocks=16, batch_buckets=[4], seq_buckets=[8],
               max_new_tokens=8, temperature=0.0, eos_id=None, prefix_cache=False, start=False)


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


def jax_params(seed=0):
    """The small JAX LM's params drawn with numpy over ``jax.eval_shape``
    (Dense kernels at lecun scale, biases and scales perturbed)."""
    jm = JaxLM(vocab_size=VOCAB, **SMALL)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        leaf = path[-1].key
        if leaf == "kernel":
            return x / np.float32(np.sqrt(s.shape[0]))
        if leaf == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x if leaf == "bias" else 0.5 * x

    return jm, jax.tree_util.tree_map_with_path(draw, shapes)["params"]


@pytest.fixture(scope="module")
def lm():
    jm, params = jax_params()
    pm = TransformerLM(VOCAB, **SMALL)
    pm.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return jm, params, pm.eval()


def _prompts(seed=3, lens=(6, 5, 7, 6)):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, VOCAB, n).astype(np.int32) for n in lens]


def _replica(model, rid, **kw):
    return ContinuousScheduler(model, **{**REPLICA, "replica_id": rid, **kw})


def _router(replicas, base=(42,), **kw):
    return FleetRouter(replicas, **{"base_key": base, "heartbeat_timeout_s": None,
                                    "start_monitor": False, **kw})


def _drive(scheds, futs, limit=300):
    n = 0
    while any(not f.done() for f in futs):
        for s in scheds:
            s.tick()
        n += 1
        assert n < limit, "the fleet did not converge"


def _twin(model, prompts, base=(42,), **kw):
    """What one unkilled scheduler gives with the keys the router hands
    out, ``base + (n,)``."""
    sched = _replica(model, 9, **kw)
    futs = [sched.submit(p, key=base + (i,)) for i, p in enumerate(prompts)]
    _drive([sched], futs)
    sched.close()
    return [f.result()["tokens"].tolist() for f in futs]


def _placements(router):
    with router._lock:
        return {i: [a.replica_idx for a in fr.assignments]
                for i, fr in enumerate(router._outstanding)}


def _tokens(futs):
    return [f.result()["tokens"].tolist() for f in futs]


def _mismatches(*scheds):
    return sum(s.metrics.snapshot().get("replay_parity_mismatch", 0) for s in scheds)


@pytest.fixture(scope="module")
def jax_greedy(lm):
    """The JAX scheduler's greedy streams of ``_prompts()``, once."""
    jm, params, _ = lm
    js = JaxScheduler(jm, params, **{k: v for k, v in REPLICA.items()})
    futs = [js.submit(p) for p in _prompts()]
    _drive([js], futs)
    js.close()
    return [list(map(int, f.result()["tokens"])) for f in futs]


# --------------------------------------------------------------------- #
# failover


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["greedy", "sampled"])
def test_failover_token_identity(lm, temperature):
    pm = lm[2]
    prompts = _prompts()
    expected = _twin(pm, prompts, temperature=temperature)
    r0, r1 = _replica(pm, 0, temperature=temperature), _replica(pm, 1, temperature=temperature)
    router = _router([r0, r1])
    streams = {i: [] for i in range(len(prompts))}
    futs = [router.submit(p, on_token=lambda t, i=i: streams[i].append(t))
            for i, p in enumerate(prompts)]
    # least-loaded placement alternates: both replicas hold work
    assert {i for a in _placements(router).values() for i in a} == {0, 1}
    for _ in range(3):
        r0.tick()
        r1.tick()
    assert all(0 < len(s) < len(expected[i]) for i, s in streams.items())
    r0.hard_kill(ReplicaDownError("replica 0 dies mid-stream"))
    r0.tick()  # the death, at a tick boundary
    router._poll_once()  # failovers onto the survivor
    _drive([r1], futs)
    router.shutdown()
    r0.close()
    r1.close()
    assert _tokens(futs) == expected
    assert [streams[i] for i in range(len(prompts))] == expected  # no token twice
    c = fault.counters()
    assert c["serving_fleet_failovers"] >= 1 and c["serving_fleet_replicas_down"] == 1
    assert c.get("serving_fleet_parity_mismatch", 0) == 0
    assert c["serving_r1_replayed_tokens"] > 0 and c["serving_r0_replica_down"] == 1
    assert _mismatches(r0, r1) == 0


def test_fleet_greedy_matches_jax_scheduler(lm, jax_greedy):
    pm = lm[2]
    reps = [_replica(pm, 0), _replica(pm, 1)]
    router = _router(reps)
    futs = [router.submit(p) for p in _prompts()]
    _drive(reps, futs)
    router.shutdown()
    assert _tokens(futs) == jax_greedy


def test_replica_down_injector_fires_failover(lm):
    pm = lm[2]
    prompts = _prompts(seed=5, lens=(6, 6))
    expected = _twin(pm, prompts, base=(7,))
    r0, r1 = _replica(pm, 0), _replica(pm, 1)
    router = _router([r0, r1], base=(7,))
    fault.install("replica_down@2:0")
    futs = [router.submit(p) for p in prompts]
    r0.tick()
    r1.tick()
    router._poll_once()  # poll 1: nothing
    router._poll_once()  # poll 2: replica 0 hard-killed
    r0.tick()  # the death; its request queued for failover
    router._poll_once()  # poll 3: dispatched to replica 1
    _drive([r1], futs)
    router.shutdown()
    assert _tokens(futs) == expected
    c = fault.counters()
    assert c["injected_replica_downs"] == 1 and c["serving_fleet_replicas_down"] == 1
    assert c["fault_fired_replica_down"] == 1 and _mismatches(r0, r1) == 0


def test_heartbeat_staleness_marks_down_and_fails_over(lm, tmp_path):
    """A replica that stops beating is seen from outside, by its heartbeat
    file's age, and its requests fail over."""
    pm = lm[2]
    prompts = _prompts(seed=11, lens=(6, 6))
    expected = _twin(pm, prompts, base=(13,))
    hb = str(tmp_path / "r0.json")
    r0 = _replica(pm, 0, heartbeat_path=hb, heartbeat_interval_s=0.01)
    r1 = _replica(pm, 1)
    assert json.loads(open(hb).read())["replica_id"] == 0  # written at birth
    router = _router([r0, r1], base=(13,), heartbeat_timeout_s=0.2)
    r0.tick()
    futs = [router.submit(p) for p in prompts]
    assert {i for a in _placements(router).values() for i in a} == {0, 1}
    r0.tick()
    r1.tick()
    router._poll_once()
    assert not router.health()["replicas"][0]["heartbeat_stale"]
    time.sleep(0.3)  # replica 0 wedges: no tick, no beat
    assert router._is_stale(r0)
    router._poll_once()
    _drive([r1], futs)
    health = router.health()
    router.shutdown()
    assert _tokens(futs) == expected
    assert health["replicas"][0]["routed_down"] is True and health["ready"] is True
    assert fault.counters()["serving_fleet_replicas_down"] == 1


@pytest.mark.parametrize("slow", ["phases", "blocks"])
def test_slow_tick_keeps_beating(lm, tmp_path, slow):
    """A tick slower than the staleness limit that makes progress (a
    one-process fleet's replica under host load) keeps the heartbeat
    fresh: the scheduler beats at every phase of a tick and before every
    block of a forward, so the router marks no live replica down.  Against
    a limit of 0.25 s, each of 5 phases takes 0.1 s more, or each block
    0.15 s more (a forward of 2 blocks 0.3 s more)."""
    pm = lm[2]
    r0 = _replica(pm, 0, heartbeat_path=str(tmp_path / "r0.json"), heartbeat_interval_s=0.01)
    router = _router([r0], base=(15,), heartbeat_timeout_s=0.25)
    fut = router.submit(_prompts(seed=13, lens=(6,))[0])

    def slowed(fn):
        def run(*args, **kw):
            time.sleep(0.1)
            return fn(*args, **kw)
        return run

    phases = ("_service_kv_transfers", "_admit", "_prefill", "_consult_injector", "_decode_step")
    hooks = []
    if slow == "phases":
        for name in phases:
            setattr(r0, name, slowed(getattr(r0, name)))
    else:
        hooks = [b.register_forward_pre_hook(lambda m, a: time.sleep(0.15)) for b in pm.blocks]
    tick = threading.Thread(target=r0.tick)
    t0 = time.monotonic()
    tick.start()
    stale = False
    while tick.is_alive():
        stale = stale or router._is_stale(r0)
        time.sleep(0.01)
    tick.join()
    took = time.monotonic() - t0
    for h in hooks:
        h.remove()
    for name in phases if slow == "phases" else ():
        delattr(r0, name)
    router._poll_once()
    assert took > 1.5 * router.heartbeat_timeout_s  # one beat a tick would have gone stale
    assert not stale and not router.health()["replicas"][0]["routed_down"]
    _drive([r0], [fut])
    router.shutdown()
    assert fut.result()["gen_len"] == REPLICA["max_new_tokens"]
    assert fault.counters().get("serving_fleet_replicas_down", 0) == 0


@pytest.mark.chaos
def test_replica_hang_injector_goes_stale_and_fails_over(lm, tmp_path):
    """``replica_hang@P:SEC`` wedges replica 0 inside its next tick, before
    its beat: the router sees it stale and fails its request over."""
    pm = lm[2]
    prompts = _prompts(seed=12, lens=(6, 6))
    expected = _twin(pm, prompts, base=(14,))
    r0 = _replica(pm, 0, heartbeat_path=str(tmp_path / "r0.json"), heartbeat_interval_s=0.01)
    r1 = _replica(pm, 1)
    router = _router([r0, r1], base=(14,), heartbeat_timeout_s=0.15)
    futs = [router.submit(p) for p in prompts]
    r0.tick()
    r1.tick()
    fault.install("replica_hang@1:0.5")
    router._poll_once()  # poll 1: the hang armed on replica 0
    wedged = threading.Thread(target=r0.tick)
    wedged.start()
    time.sleep(0.3)
    router._poll_once()  # replica 0 stale: marked down, its request failed over
    _drive([r1], futs)
    wedged.join()
    r0.tick()  # the router's kill, processed when it wakes
    router.shutdown()
    assert _tokens(futs) == expected
    c = fault.counters()
    assert c["injected_replica_hangs"] == 1 and c["serving_fleet_replicas_down"] == 1
    assert c.get("serving_fleet_parity_mismatch", 0) == 0 and r0.health()["live"] is False


def test_liveness_clock_reports_a_stall(lm):
    pm = lm[2]
    sched = _replica(pm, 0, liveness_timeout_s=0.05)
    fut = sched.submit(_prompts()[0])
    sched.tick()
    assert sched.health()["live"] and not sched.health()["stalled"]
    time.sleep(0.1)  # work pending, no progress
    h = sched.health()
    assert h["stalled"] and not h["live"] and not h["ready"]
    _drive([sched], [fut])
    assert not sched.health()["stalled"]  # idle never stalls
    time.sleep(0.1)
    assert sched.health()["live"]
    assert sched.metrics.snapshot()["health_stalled"] == 0.0


# --------------------------------------------------------------------- #
# placement and backpressure


def test_affinity_routes_shared_prefix_to_one_replica(lm):
    pm = lm[2]
    r0, r1 = _replica(pm, 0, prefix_cache=True), _replica(pm, 1, prefix_cache=True)
    router = _router([r0, r1], base=(21,))
    shared = np.array([9, 8, 7, 6], np.int32)  # one full block
    group = [np.r_[shared, [i + 2, i + 3]].astype(np.int32) for i in range(3)]
    first = router.submit(group[0])
    (owner,) = {i for a in _placements(router).values() for i in a}
    _drive([r0, r1], [first])
    futs = [router.submit(p) for p in group[1:]]
    assert all(a == [owner] for a in _placements(router).values())
    _drive([r0, r1], futs)
    router.shutdown()
    assert get_registry().gauge(f"serving_r{owner}_prefix_hit_rate").value > 0.0
    assert fault.counters()["serving_fleet_affinity_hits"] >= 2


def test_placement_skips_down_replica_and_fleet_down(lm):
    pm = lm[2]
    r0, r1 = _replica(pm, 0), _replica(pm, 1)
    router = _router([r0, r1], base=(23,))
    r0.hard_kill(ReplicaDownError("dead"))
    r0.tick()
    router._poll_once()  # the liveness sweep routes replica 0 out
    futs = [router.submit(p) for p in _prompts(seed=31, lens=(6, 6))]
    assert all(a == [1] for a in _placements(router).values())
    _drive([r1], futs)
    _tokens(futs)
    r1.hard_kill(ReplicaDownError("dead too"))
    r1.tick()
    router._poll_once()
    with pytest.raises(FleetDownError):
        router.submit(np.array([2, 3, 4, 5, 6], np.int32))
    router.shutdown()


def test_fleet_backpressure_sheds_at_router(lm):
    r0 = _replica(lm[2], 0)
    router = _router([r0], max_backlog=2)
    p = np.array([2, 3, 4, 5, 6], np.int32)
    futs = [router.submit(p) for _ in range(2)]
    with pytest.raises(OverloadedError):
        router.submit(p)
    _drive([r0], futs)
    router.shutdown()
    assert fault.counters()["serving_fleet_sheds"] == 1


def test_hedge_first_writer_wins(lm):
    """A straggler is dispatched again; both replicas deliver, each token
    index once, and the stream is the unhedged twin's."""
    pm = lm[2]
    prompts = _prompts(seed=17, lens=(6,))
    expected = _twin(pm, prompts, base=(19,), temperature=1.0)
    r0, r1 = _replica(pm, 0, temperature=1.0), _replica(pm, 1, temperature=1.0)
    router = _router([r0, r1], base=(19,), hedge_ms=50.0)
    stream = []
    fut = router.submit(prompts[0], on_token=stream.append)
    r0.tick()
    r0.tick()
    with router._lock:
        freq = router._outstanding[0]
        freq.last_progress -= 10.0  # the primary stalls (simulated)
    router._poll_once()
    with router._lock:
        assert len(freq.assignments) == 2, "no hedge"
    _drive([r0, r1], [fut])
    router.shutdown()
    assert fut.result()["tokens"].tolist() == expected[0] == stream
    c = fault.counters()
    assert c["serving_fleet_hedges"] == 1 and c.get("serving_fleet_parity_mismatch", 0) == 0
    assert _mismatches(r0, r1) == 0


# --------------------------------------------------------------------- #
# lifecycle


def test_fleet_drain_concurrent_and_late_submit_raises(lm):
    pm = lm[2]
    r0, r1 = _replica(pm, 0), _replica(pm, 1)
    fleet = ServingFleet([r0, r1], _router([r0, r1], base=(2,)))
    futs = [fleet.submit(p) for p in _prompts(seed=37)]
    assert fleet.drain(deadline_ms=30_000) >= 0.0
    assert all(len(f.result(timeout=1)["tokens"]) == 8 for f in futs)
    assert r0.health()["closed"] and r1.health()["closed"]
    with pytest.raises(RuntimeError, match="closed"):
        fleet.submit(np.array([2, 3, 4, 5, 6], np.int32))
    assert fleet.drain() == 0.0
    fleet.close()


def test_fleet_sigterm_routes_to_drain(lm):
    r0 = _replica(lm[2], 0)
    fleet = ServingFleet([r0], _router([r0], base=(3,)))
    fut = fleet.submit(np.array([5, 6, 7, 8, 9], np.int32))
    prev = signal.getsignal(signal.SIGTERM)
    try:
        fleet.install_drain_handler()
        handler = signal.getsignal(signal.SIGTERM)
        assert callable(handler) and handler is not prev
        handler(signal.SIGTERM, None)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not r0.health()["closed"]:
            time.sleep(0.01)
        assert r0.health()["closed"] and len(fut.result(timeout=1)["tokens"]) == 8
    finally:
        signal.signal(signal.SIGTERM, prev)
        fleet.close()


def test_metrics_namespacing_and_fleet_aggregate(lm):
    assert ServingMetrics(3).global_name("sheds") == "serving_r3_sheds"
    assert ServingMetrics().global_name("sheds") == "serving_sheds"
    pm = lm[2]
    r0, r1 = _replica(pm, 0), _replica(pm, 1)
    fleet = ServingFleet([r0, r1], _router([r0, r1], base=(29,)))
    futs = [fleet.submit(p) for p in _prompts(seed=41, lens=(6, 6))]
    _drive([r0, r1], futs)
    _tokens(futs)
    snap = fleet.snapshot()
    fleet.close()
    per = snap["replicas"]
    assert set(per) == {"r0", "r1"}
    agg = snap["fleet"]
    assert agg["replicas"] == 2 and agg == aggregate_snapshots(per)
    assert agg["requests"] == per["r0"]["requests"] + per["r1"]["requests"] == 2
    assert agg["latency_ms_p99"] == max(per["r0"]["latency_ms_p99"], per["r1"]["latency_ms_p99"])
    c = fault.counters()
    assert c["serving_r0_retired"] == 1 and c["serving_r1_retired"] == 1
    assert "serving_retired" not in c  # no replica wrote the flat name


def test_aggregate_snapshots_matches_jax():
    from pytorch_distributed_training_tpu.serving.metrics import (
        aggregate_snapshots as jax_aggregate,
    )

    per = {"r0": {"requests": 3, "items": 24, "latency_ms_p50": 4.0, "latency_ms_p99": 9.0,
                  "prefix_hit_blocks": 2, "prefix_miss_blocks": 6, "health_ready": 1.0,
                  "decode_tokens_per_sec": 100.0, "tick_host_ms_mean": 3.0, "retired": 3,
                  "scale_up_ready_ms": 50.0, "ready": True},
           "r1": {"requests": 5, "items": 40, "latency_ms_p50": 6.0, "latency_ms_p99": 7.0,
                  "prefix_hit_blocks": 4, "health_ready": 0.0, "decode_tokens_per_sec": 80.0,
                  "kv_transfer_ms_p99": 2.5, "retired": 5}}
    assert aggregate_snapshots(per) == jax_aggregate(per)
    assert aggregate_snapshots(per)["prefix_hit_rate"] == 0.5
    for rid in (None, 0, 7):
        assert ServingMetrics(rid).global_name("block_util") == (
            "serving_block_util" if rid is None else f"serving_r{rid}_block_util")


def test_scale_down_drains_in_flight_requests_token_identical(lm):
    """Retiring a replica mid-stream completes its requests on it, as an
    unscaled twin does: nothing killed, failed over or replayed."""
    pm = lm[2]
    prompts = _prompts(seed=23)
    expected = _twin(pm, prompts, base=(31,))
    r0, r1 = _replica(pm, 0), _replica(pm, 1)
    router = _router([r0, r1], base=(31,))
    fleet = ServingFleet([r0, r1], router)
    streams = {i: [] for i in range(len(prompts))}
    futs = [router.submit(p, on_token=lambda t, i=i: streams[i].append(t))
            for i, p in enumerate(prompts)]
    on_retiree = [i for i, a in _placements(router).items() if 1 in a]
    for _ in range(3):
        r0.tick()
        r1.tick()
    assert on_retiree and all(0 < len(s) < 8 for s in streams.values())
    # the fleet's scale-down: retire, then drain (r1 ticks itself in drain)
    tail = router.submit(prompts[0])
    drain_ms = fleet.remove_replica(1)
    assert router.live_indices() == [0] and drain_ms >= 0.0 and r1.health()["closed"]
    assert all(f.done() for i, f in enumerate(futs) if i in on_retiree)
    _drive([r0], futs + [tail])
    fleet.close()
    assert _tokens(futs) == expected and [streams[i] for i in range(len(prompts))] == expected
    c = fault.counters()
    assert c["serving_fleet_replicas_retired"] == 1
    assert c.get("serving_fleet_failovers", 0) == 0 and c.get("serving_fleet_replicas_down", 0) == 0
    assert _mismatches(r0, r1) == 0


def test_sticky_cuda_error_in_every_replica_ends_in_fleet_down(lm, monkeypatch):
    """On one card every replica shares the CUDA context: a sticky error
    fails each replica's restarts, and the requests end in
    ``FleetDownError``, not a hang."""
    pm = lm[2]
    # replica 0 spends its budget first, so its requests fail over to 1
    reps = [_replica(pm, i, resilience={"max_restarts": 2 * i}) for i in range(2)]

    def sticky(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    for r in reps:
        monkeypatch.setattr(r._fns, "decode_step", sticky)
    router = _router(reps)
    futs = [router.submit(p) for p in _prompts(lens=(6, 6))]
    for _ in range(20):
        for r in reps:
            r.tick()
        router._poll_once()
        if all(f.done() for f in futs):
            break
    router.shutdown()
    assert all(isinstance(f.exception(), FleetDownError) for f in futs)
    assert router.live_indices() == [] and not router.health()["ready"]
    c = fault.counters()
    assert c["serving_fleet_replicas_down"] == 2 and c["serving_fleet_failovers"] >= 1
    assert c["serving_r0_restart_budget_exhausted"] >= 1
    assert c["serving_r1_restart_budget_exhausted"] >= 1
    assert issubclass(EngineRestartError, RuntimeError)


# --------------------------------------------------------------------- #
# ServingFleet.from_config: one resolution, N replicas over one model


def _cfg(**fleet):
    return {"dataset": {"name": "synthetic_text", "n_classes": VOCAB},
            "model": {"name": "TransformerLM", **SMALL},
            "serving": {"dtype": "float32", "max_batch_size": 4, "batch_buckets": [4],
                        "seq_buckets": [8], "max_new_tokens": 6, "seed": 5,
                        "scheduler": {"enabled": True, "slots": 4, "block_size": 4,
                                      "num_blocks": 16},
                        "fleet": {"replicas": 2, **fleet}}}


def test_fleet_from_config_serves_one_model(lm, tmp_path):
    pm = lm[2]
    state = pm.state_dict()
    cfg = _cfg(heartbeat_dir=str(tmp_path), poll_interval_s=0.01)
    fleet = ServingFleet.from_config(cfg, device="cpu", state_dict=state)
    prompts = _prompts(seed=43)
    try:
        a, b = fleet.replicas
        assert a.model is b.model and a.scheduler is not b.scheduler  # one model, two pools
        assert (a.replica_id, b.replica_id) == (0, 1)
        assert a.heartbeat_path == str(tmp_path / "replica_0.json")
        futs = [fleet.submit(p) for p in prompts]
        got = [f.result(timeout=60)["tokens"].tolist() for f in futs]
        idx = fleet.add_replica()
        c = fleet.replicas[idx]
        assert idx == 2 and c.model is a.model and fleet.live_replicas() == 3
        assert c.metrics.snapshot()["scale_up_ready_ms"] > 0.0
        assert fleet.pick_retire_candidate() == 2
        fleet.remove_replica(2)
        assert fleet.live_replicas() == 2 and fleet.health()["healthy_replicas"] == 2
    finally:
        fleet.drain()
        fleet.close()
    # one engine of the same config and weights: the router's keys are its own
    with InferenceEngine.from_config(_cfg(), device="cpu", state_dict=state) as eng:
        ref = [f.result(timeout=60)["tokens"].tolist() for f in [eng.submit(p) for p in prompts]]
    assert got == ref
    with pytest.raises(ValueError, match="serving.fleet keys"):
        ServingFleet.from_config(_cfg(bogus=1), device="cpu")
    batcher = _cfg()
    batcher["serving"]["scheduler"]["enabled"] = False
    with pytest.raises(ValueError, match="scheduler"):
        ServingFleet.from_config(batcher, device="cpu")


def test_fleet_int8_swaps_stay_off_the_shared_model(lm):
    """int8 decode swaps its dequantized weights into a private copy of
    the module tree: whenever any call reaches the head (prefill on the
    shared model, decode steps on a copy), the shared model holds its own
    parameters, and two int8 replicas give one int8 scheduler's streams."""
    pm = TransformerLM(VOCAB, **SMALL)
    pm.load_state_dict(lm[2].state_dict(), strict=True)
    pm.eval()
    held = [(pm.get_submodule(n.rpartition(".")[0]), n.rpartition(".")[2], p)
            for n, p in pm.named_parameters()]
    seen = []
    # registered before the replicas exist, so each private copy keeps it
    pm.head.register_forward_pre_hook(
        lambda *_: seen.append(all(getattr(m, a) is p for m, a, p in held)))
    prompts = _prompts(seed=47)
    expected = _twin(pm, prompts, quant=True)
    reps = [_replica(pm, i, quant=True) for i in range(2)]
    router = _router(reps)
    futs = [router.submit(p) for p in prompts]
    _drive(reps, futs)
    router.shutdown()
    decode_calls = sum(r._fns.calls["decode_step"] + r._fns.calls["decode_step_fed"]
                       for r in reps)
    assert decode_calls > 0 and len(seen) > decode_calls and all(seen)
    assert _tokens(futs) == expected


def test_fleet_from_config_int8_matches_one_engine(lm):
    """``serving.quant`` through ``ServingFleet.from_config``: two replica
    threads decode int8 over one shared model at once and give one int8
    engine's streams."""
    state = lm[2].state_dict()
    cfg = _cfg()
    cfg["serving"]["quant"] = {"enabled": True}
    prompts = _prompts(seed=53, lens=(6, 5, 7, 6, 5, 7, 6, 5))
    fleet = ServingFleet.from_config(cfg, device="cpu", state_dict=state)
    try:
        a, b = fleet.replicas
        assert a.model is b.model and a.serving_modes["quant"]
        got = [f.result(timeout=60)["tokens"].tolist() for f in [fleet.submit(p) for p in prompts]]
    finally:
        fleet.drain()
        fleet.close()
    one = _cfg()
    one["serving"]["quant"] = {"enabled": True}
    with InferenceEngine.from_config(one, device="cpu", state_dict=state) as eng:
        ref = [f.result(timeout=60)["tokens"].tolist() for f in [eng.submit(p) for p in prompts]]
    assert got == ref


def test_engine_replay_tokens_continue_a_stream(lm):
    """The router's fail-over verb on the engine: a stream's head replayed
    under its key, the rest generated as the one-shot run."""
    pm = lm[2]
    cfg = _cfg()
    cfg["serving"]["temperature"] = 1.0
    with InferenceEngine.from_config(cfg, device="cpu", state_dict=pm.state_dict()) as eng:
        p = _prompts()[0]
        whole = eng.submit(p, key=(4, 2)).result(timeout=60)["tokens"].tolist()
        seen = []
        rest = eng.submit(p, key=(4, 2), replay_tokens=whole[:3], on_token=seen.append)
        assert rest.result(timeout=60)["tokens"].tolist() == whole and seen == whole[3:]
        assert eng.snapshot()["replayed_tokens"] == 3
        assert eng.snapshot().get("replay_parity_mismatch", 0) == 0
        with pytest.raises(ValueError, match="key"):
            eng.submit(p, replay_tokens=whole[:3])
