"""The port's trace generator, autoscaler and router membership on the CPU.

- ``TraceGenerator``: ``trace_json`` byte-identical to the JAX package's
  for three seeds (and a custom workload), prefix-stable under truncation,
  its bounds and its refusals.
- ``FleetAutoscaler``: its decisions equal JAX ``FleetAutoscaler``'s over
  one scripted sequence of signals and clock, both driving the same
  duck-typed fake fleet; cooldowns, healing below the minimum, the ceiling,
  the replica-minutes ledger and the ``autoscale_hang`` fault (the signals
  read after the hang).
- ``FleetRouter``'s membership verbs (add, retire, the last live replica
  refused, a race against health sweeps), and a fleet scaled up and down
  by the autoscaler whose greedy streams equal one JAX
  ``ContinuousScheduler``'s (the small LM of ``tests/test_fleet.py``, JAX
  weights drawn with numpy over ``jax.eval_shape``; run once, in a module
  fixture).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.engine import fault as jfault
from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.serving.autoscaler import (
    FleetAutoscaler as JaxAutoscaler,
)
from pytorch_distributed_training_tpu.serving.scheduler import (
    ContinuousScheduler as JaxScheduler,
)
from pytorch_distributed_training_tpu.serving.workload import TraceGenerator as JaxTrace
from pytorch_distributed_training_tpu_torch.engine import fault
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.serving import (
    ContinuousScheduler,
    FleetAutoscaler,
    FleetRouter,
    ServingFleet,
    TraceGenerator,
    TraceRequest,
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


# --------------------------------------------------------------------- #
# the trace generator


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_trace_json_matches_jax_and_truncation_is_a_prefix(seed):
    assert TraceGenerator(seed=seed).trace_json() == JaxTrace(seed=seed).trace_json()
    wl = {"duration_s": 30.0, "base_rps": 4.0, "flash_crowds": 3, "prompt_max": 40,
          "gen_max": 12, "tail_alpha": 1.5, "prefix_groups": 2, "prefix_fraction": 0.7}
    port = TraceGenerator(seed=seed, workload=wl)
    assert port.trace_json() == JaxTrace(seed=seed, workload=dict(wl)).trace_json()
    assert port.trace_json(limit=7) == JaxTrace(seed=seed, workload=dict(wl)).trace_json(limit=7)
    full = TraceGenerator(seed=seed).generate()
    assert TraceGenerator(seed=seed).generate(limit=10) == full[:10]
    assert port.peak_rate() == JaxTrace(seed=seed, workload=dict(wl)).peak_rate()
    assert TraceGenerator(seed=seed + 1).trace_json() != TraceGenerator(seed=seed).trace_json()


def test_trace_shape_bounds_and_refusals():
    wl = {"duration_s": 20.0, "base_rps": 3.0, "prompt_min": 4, "prompt_max": 9,
          "gen_min": 2, "gen_max": 5}
    trace = TraceGenerator(seed=3, workload=wl).generate()
    assert trace and all(isinstance(r, TraceRequest) for r in trace)
    assert all(0.0 <= r.t <= 20.0 and 4 <= r.prompt_len <= 9 and 2 <= r.gen_len <= 5
               for r in trace)
    assert [r.t for r in trace] == sorted(r.t for r in trace)
    by_group = {}
    for r in trace:
        if r.group is not None:
            by_group.setdefault(r.group, set()).add(r.prompt_seed)
    assert by_group and all(len(s) == 1 for s in by_group.values())
    gen = TraceGenerator(seed=9)
    assert gen.peak_rate() > 2.0 * gen.rate_at(0.0)  # flash crowds over the trough
    for bad in ({"burst_rps": 3}, {"tail_alpha": 1.0}, {"diurnal_amplitude": 1.0},
                {"prompt_min": 0}):
        with pytest.raises(ValueError):
            TraceGenerator(seed=0, workload=bad)


# --------------------------------------------------------------------- #
# the control loop against a fake fleet and a hand clock


class FakeFleet:
    """The ServingFleet surface the autoscaler reads and drives."""

    def __init__(self, n=1):
        self.n = n
        self.backlog = 0
        self.occupancy = 0.0
        self.p99 = 0.0
        self.queued = 0
        self.removed = []  # (idx, deadline_ms)

    def health(self):
        reps = [{"replica": i, "routed_down": False, "retired": False, "ready": True,
                 "live": True, "slots": 4, "active_slots": int(round(self.occupancy * 4)),
                 "queue_depth": self.queued} for i in range(self.n)]
        return {"ready": True, "outstanding": self.backlog, "replicas": reps}

    def snapshot(self):
        return {"fleet": {"latency_ms_p99": self.p99}}

    def live_replicas(self):
        return self.n

    def add_replica(self):
        self.n += 1
        return self.n - 1

    def pick_retire_candidate(self):
        return self.n - 1 if self.n > 1 else None

    def remove_replica(self, idx, deadline_ms=None):
        self.removed.append((idx, deadline_ms))
        self.n -= 1
        return 1.0


ASC = dict(min_replicas=1, max_replicas=3, backlog_high=8, backlog_low=1, occupancy_high=0.85,
           occupancy_low=0.25, scale_up_cooldown_s=2.0, scale_down_cooldown_s=8.0,
           drain_deadline_ms=60000)
# (t, backlog, occupancy, queued, p99, replicas lost before the poll)
SCRIPT = [(0.0, 0, 0.0, 0, 0.0, 0), (0.5, 10, 0.5, 0, 0.0, 0), (1.0, 10, 0.5, 0, 0.0, 0),
          (2.6, 12, 0.9, 0, 0.0, 0), (3.0, 3, 0.9, 0, 0.0, 0), (5.0, 0, 0.0, 0, 0.0, 0),
          (9.0, 0, 0.0, 0, 0.0, 0), (12.0, 0, 0.1, 0, 0.0, 0), (17.5, 0, 0.0, 0, 0.0, 0),
          (18.0, 0, 0.0, 0, 0.0, 1), (19.0, 2, 0.3, 1, 250.0, 0), (22.0, 2, 0.2, 0, 250.0, 0),
          (26.0, 0, 0.1, 0, 250.0, 0), (40.0, 0, 0.0, 0, 10.0, 0), (60.0, 0, 0.0, 0, 10.0, 0)]


def _run_script(cls, **over):
    fleet, now = FakeFleet(n=1), [0.0]
    asc = cls(fleet, autoscale={**ASC, **over}, clock=lambda: now[0])
    out = []
    for t, backlog, occ, queued, p99, lost in SCRIPT:
        now[0] = t
        fleet.backlog, fleet.occupancy, fleet.queued, fleet.p99 = backlog, occ, queued, p99
        fleet.n -= lost
        out.append((asc.poll(), fleet.n))
    now[0] = 75.0
    return out, fleet.removed, asc.replica_minutes(), (asc.scale_ups, asc.scale_downs)


@pytest.mark.parametrize("over", [{}, {"target_p99_ms": 100.0, "min_replicas": 1},
                                  {"min_replicas": 2, "max_replicas": 2}],
                         ids=["default", "p99", "fixed"])
def test_decisions_match_jax_autoscaler(over):
    port = _run_script(FleetAutoscaler, **over)
    assert port == _run_script(JaxAutoscaler, **over)
    decisions = {d for d, _ in port[0]}
    # the script reaches every branch: heal below a floor of 2, up and
    # down otherwise
    assert decisions == ({"heal", "hold"} if over.get("min_replicas") == 2
                         else {"up", "down", "hold"})


def test_cooldowns_ceiling_and_drain():
    fleet, now = FakeFleet(n=1), [0.0]
    asc = FleetAutoscaler(fleet, autoscale=dict(ASC), clock=lambda: now[0])
    fleet.backlog = 10
    assert asc.poll() == "up" and fleet.n == 2
    assert asc.poll() == "hold"  # inside the up-cooldown
    now[0] = 2.5
    assert asc.poll() == "up" and fleet.n == 3
    now[0] = 5.0
    assert asc.poll() == "hold" and fleet.n == 3  # the ceiling
    fleet.backlog = 0
    now[0] = 9.0
    assert asc.poll() == "hold"  # downs wait out the up-cooldown too
    now[0] = 10.6
    assert asc.poll() == "down" and fleet.removed == [(2, 60000.0)]
    assert asc.scale_ups == 2 and asc.scale_downs == 1


def test_heal_below_min_ignores_cooldown_and_refusals():
    fleet, now = FakeFleet(n=2), [0.0]
    asc = FleetAutoscaler(fleet, autoscale={**ASC, "min_replicas": 2}, clock=lambda: now[0])
    fleet.backlog = 10
    assert asc.poll() == "up"
    fleet.backlog, fleet.n = 0, 1  # a replica lost
    assert asc.poll() == "heal" and fleet.n == 2
    assert FleetAutoscaler(FakeFleet(), autoscale={"enabled": False}).poll() == "hold"
    for bad, match in (({"scale_factor": 2}, "autoscale"), ({"min_replicas": 0}, "min_replicas"),
                       ({"backlog_high": 2, "backlog_low": 2}, "backlog_low"),
                       ({"occupancy_low": 0.9}, "occupancy_low")):
        with pytest.raises(ValueError, match=match):
            FleetAutoscaler(FakeFleet(), autoscale=bad)


def test_autoscale_hang_fires_then_reads_fresh_signals():
    fleet, now = FakeFleet(n=1), [0.0]
    asc = FleetAutoscaler(fleet, autoscale=dict(ASC), clock=lambda: now[0])
    fault.install("autoscale_hang@2:0.01")
    assert asc.poll() == "hold"
    fleet.backlog = 10  # the pressure it wakes up to
    assert asc.poll() == "up"
    assert fault.counters()["injected_autoscale_hangs"] == 1
    assert fault.get_injector().pending() == {}
    # the signals it decided on, mirrored as gauges
    assert get_registry().gauge("autoscale_backlog").value == 10.0
    assert jfault.FaultInjector("autoscale_hang@2").take("autoscale_hang", 2) == 1.0


# --------------------------------------------------------------------- #
# the router's membership, and a scaled fleet against the JAX scheduler


def _jax_lm():
    jm = JaxLM(vocab_size=VOCAB, **SMALL)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(1)

    def draw(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        leaf = path[-1].key
        if leaf == "kernel":
            return x / np.float32(np.sqrt(s.shape[0]))
        return 1.0 + 0.1 * x if leaf == "scale" else (0.1 if leaf == "bias" else 0.5) * x

    return jm, jax.tree_util.tree_map_with_path(draw, shapes)["params"]


@pytest.fixture(scope="module")
def lm():
    jm, params = _jax_lm()
    pm = TransformerLM(VOCAB, **SMALL)
    pm.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return jm, params, pm.eval()


def _replica(model, rid):
    return ContinuousScheduler(model, **REPLICA, replica_id=rid)


def _router(replicas):
    return FleetRouter(replicas, base_key=(0,), heartbeat_timeout_s=None, start_monitor=False)


def _drive(scheds, futs, limit=300):
    n = 0
    while any(not f.done() for f in futs):
        for s in scheds:
            s.tick()
        n += 1
        assert n < limit, "the fleet did not converge"


def test_router_membership_verbs(lm):
    pm = lm[2]
    router = _router([_replica(pm, i) for i in range(2)])
    assert router.live_indices() == [0, 1]
    assert router.add_replica(_replica(pm, 2)) == 2
    assert router.live_indices() == [0, 1, 2] and len(router.replicas) == 3
    router.retire_replica(1)
    router.retire_replica(1)  # idempotent
    assert router.live_indices() == [0, 2] and router.retired() == {1}
    h = router.health()
    assert h["replicas"][1]["retired"] is True and h["healthy_replicas"] == 2
    with pytest.raises(IndexError):
        router.retire_replica(9)
    router.retire_replica(0)
    with pytest.raises(ValueError, match="last"):
        router.retire_replica(2)
    assert router.live_indices() == [2]
    c = fault.counters()
    assert c["serving_fleet_replicas_added"] == 1 and c["serving_fleet_replicas_retired"] == 2
    router.shutdown()
    with pytest.raises(RuntimeError, match="closed"):
        router.add_replica(_replica(pm, 3))


def test_router_add_retire_races_health_sweep(lm):
    pm = lm[2]
    router = _router([_replica(pm, i) for i in range(2)])
    errors, stop = [], threading.Event()

    def sweeper():
        while not stop.is_set():
            try:
                router.health()
                router._sweep_health()
                router._healthy()
            except Exception as e:  # the regression
                errors.append(e)
                return

    threads = [threading.Thread(target=sweeper) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        added = []
        for i in range(6):
            added.append(router.add_replica(_replica(pm, 2 + i)))
            if i % 2:
                router.retire_replica(added[-2])
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors and added == [2, 3, 4, 5, 6, 7]
    assert router.live_indices() == [0, 1, 3, 5, 7]
    router.shutdown()


def test_autoscaled_fleet_streams_match_jax_scheduler(lm):
    """Scale up through the factory, place work on the new replica, scale
    down through drain: every greedy stream is the JAX scheduler's."""
    jm, params, pm = lm
    rng = np.random.default_rng(8)
    prompts = [rng.integers(2, VOCAB, n).astype(np.int32) for n in (6, 5, 7, 6, 8, 4)]
    js = JaxScheduler(jm, params, **REPLICA)
    jfuts = [js.submit(p) for p in prompts]
    _drive([js], jfuts)
    want = [list(map(int, f.result()["tokens"])) for f in jfuts]

    made = []

    def factory(rid):
        made.append(_replica(pm, rid))
        return made[-1]

    r0 = _replica(pm, 0)
    router = _router([r0])
    fleet = ServingFleet([r0], router, replica_factory=factory)
    now = [0.0]
    asc = FleetAutoscaler(fleet, autoscale={**ASC, "backlog_high": 3, "max_replicas": 2},
                          clock=lambda: now[0])
    futs = [fleet.submit(p) for p in prompts[:3]]
    assert asc.poll() == "up" and fleet.live_replicas() == 2
    assert made[0].metrics.snapshot()["scale_up_ready_ms"] >= 0.0
    futs += [fleet.submit(p) for p in prompts[3:]]
    assert any(a.replica_idx == 1 for fr in router._outstanding for a in fr.assignments)
    for _ in range(2):
        r0.tick()
        made[0].tick()
    now[0] = 20.0
    _drive([r0, made[0]], futs)
    assert asc.poll() == "down" and fleet.live_replicas() == 1
    assert made[0].health()["closed"]
    fleet.close()
    assert [f.result()["tokens"].tolist() for f in futs] == want
    assert asc.replica_minutes() > 0.0
    c = fault.counters()
    assert c["autoscale_ups"] == 1 and c["autoscale_downs"] == 1
    assert c.get("serving_fleet_failovers", 0) == 0
