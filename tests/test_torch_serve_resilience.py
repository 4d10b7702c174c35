"""Serving fault tolerance of the port (``serving/resilience.py`` and the
scheduler), the counterparts of ``tests/test_serving_resilience.py``.

The oracles are the port's own: a run under an injected fault against the
same requests run clean.

- Replay: a request cut by ``serve_device_lost`` and resumed by a hot
  restart gives the clean run's tokens, greedy and sampled.
- Poison isolation: under ``serve_raise`` or ``serve_nan`` in one slot,
  exactly that request fails with a diagnosed ``PoisonedRequestError``,
  the others equal the clean run, and the pool returns to empty.
- The tick watchdog turns ``serve_hang`` into a restart; a CUDA error that
  every restart meets again spends the budget and fails the futures with
  ``EngineRestartError`` instead of hanging.

Every driver checks the pool's accounting after every tick.
"""
import signal
import threading
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu_torch.engine import fault
from pytorch_distributed_training_tpu_torch.models import TransformerLM
from pytorch_distributed_training_tpu_torch.serving import InferenceEngine
from pytorch_distributed_training_tpu_torch.serving.resilience import (
    EngineRestartError,
    HungTickError,
    PoisonedRequestError,
    _is_device_loss,
)
from pytorch_distributed_training_tpu_torch.serving.scheduler import ContinuousScheduler
from pytorch_distributed_training_tpu_torch.telemetry.registry import get_registry

VOCAB = 61


@pytest.fixture(scope="module")
def model():
    m = TransformerLM(VOCAB, max_len=32, embed_dim=32, depth=2, num_heads=4)
    m.reset_parameters(torch.Generator().manual_seed(0))
    return m.eval()


@pytest.fixture(autouse=True)
def _inert_injector():
    fault.install(None)
    yield
    fault.install(None)


def _prompts(seed=3, lens=(2, 6, 4)):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, VOCAB, n).astype(np.int32) for n in lens]


def _sched(model, **kw):
    # prefix cache off by default, so blocks_in_use == 0 is an exact leak check
    kw = {**dict(slots=4, block_size=4, num_blocks=16, batch_buckets=[4], seq_buckets=[8],
                 max_new_tokens=6, temperature=0.0, eos_id=None, prefix_cache=False,
                 start=False), **kw}
    return ContinuousScheduler(model, **kw)


def _drive(sched, futures, limit=200):
    n = 0
    while any(not f.done() for f in futures):
        sched.tick()
        sched._kv.check_invariants()
        n += 1
        assert n < limit, "scheduler failed to drain"


def _run(model, spec, **kw):
    fault.install(spec)
    try:
        sched = _sched(model, **kw)
        futs = [sched.submit(p) for p in _prompts()]
        _drive(sched, futs)
        return sched, futs
    finally:
        fault.install(None)


def _tokens(futs):
    return [f.result()["tokens"] for f in futs]


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_replay_after_device_loss(model, temperature):
    clean_sched, clean = _run(model, None, temperature=temperature, prefix_cache=True)
    sched, futs = _run(model, "serve_device_lost@3", temperature=temperature,
                       prefix_cache=True)
    for got, want in zip(_tokens(futs), _tokens(clean)):
        np.testing.assert_array_equal(got, want)
    assert sched._supervisor.restarts() == 1
    snap = sched.metrics.snapshot()
    assert snap["engine_restarts"] == 1 and snap["replayed_tokens"] > 0
    assert snap.get("replay_parity_mismatch", 0) == 0
    assert sched._kv.blocks_in_use == clean_sched._kv.blocks_in_use
    assert fault.counters()["injected_serve_device_lost"] >= 1


def test_replay_is_not_redelivered(model):
    streamed = []
    fault.install("serve_device_lost@3")
    sched = _sched(model)
    fut = sched.submit(_prompts()[1], on_token=streamed.append)
    _drive(sched, [fut])
    assert sched._supervisor.restarts() == 1
    assert streamed == fut.result()["tokens"].tolist()


@pytest.mark.parametrize("depth", [0, 1, 2], ids=["sync", "async1", "async2"])
def test_poison_isolation_decode_raise(model, depth):
    _, clean = _run(model, None)
    sched, futs = _run(model, "serve_raise@2:1", async_depth=depth)
    assert [i for i, f in enumerate(futs) if f.exception() is not None] == [1]
    exc = futs[1].exception()
    assert isinstance(exc, PoisonedRequestError)
    assert "slot 1" in str(exc) and "tick 2" in str(exc)
    assert isinstance(exc.__cause__, fault.FaultInjectionError)
    for i in (0, 2):
        np.testing.assert_array_equal(futs[i].result()["tokens"], _tokens(clean)[i])
    assert sched._supervisor.restarts() == 0
    snap = sched.metrics.snapshot()
    assert snap["requests_poisoned"] == 1 and snap["poison_probes"] >= 2
    assert sched._kv.blocks_in_use == 0


@pytest.mark.parametrize("depth", [0, 1, 2], ids=["sync", "async1", "async2"])
def test_poison_isolation_nan_guard(model, depth):
    _, clean = _run(model, None)
    sched, futs = _run(model, "serve_nan@2:0", async_depth=depth)
    assert [i for i, f in enumerate(futs) if f.exception() is not None] == [0]
    exc = futs[0].exception()
    assert isinstance(exc, PoisonedRequestError) and "non-finite" in str(exc)
    assert exc.__cause__ is None  # the guard path: nothing raised
    for i in (1, 2):
        np.testing.assert_array_equal(futs[i].result()["tokens"], _tokens(clean)[i])
    assert sched._supervisor.restarts() == 0
    assert sched.metrics.snapshot()["requests_poisoned"] == 1
    assert sched._kv.blocks_in_use == 0


def test_poisoned_blocks_recycle_cleanly(model):
    """A request admitted on the NaN-stained blocks of an evicted one still
    gives the clean tokens (dead rows are masked and their values zeroed)."""
    _, clean = _run(model, None)
    fault.install("serve_nan@2:0")
    sched = _sched(model, num_blocks=6)
    prompts = _prompts()
    futs = [sched.submit(p) for p in prompts]
    late = sched.submit(prompts[0])  # waits for blocks, then recycles them
    _drive(sched, futs + [late])
    assert isinstance(futs[0].exception(), PoisonedRequestError)
    np.testing.assert_array_equal(late.result()["tokens"], _tokens(clean)[0])
    assert sched._kv.blocks_in_use == 0


def test_bisect_disabled_escalates_and_exhausts(model):
    sched, futs = _run(model, "serve_raise@2:1",
                       resilience={"poison_bisect": False, "max_restarts": 1})
    assert sched._supervisor.restarts() == 1 and sched._supervisor.exhausted()
    for f in futs:
        assert isinstance(f.exception(), EngineRestartError)
        assert isinstance(f.exception().__cause__, fault.FaultInjectionError)
    assert sched.metrics.snapshot().get("poison_probes", 0) == 0
    assert sched._kv.blocks_in_use == 0


def test_single_suspect_evicted_without_probing(model):
    fault.install("serve_raise@2:0")
    sched = _sched(model, resilience={"poison_bisect": False})
    fut = sched.submit(_prompts()[0])
    _drive(sched, [fut])
    assert isinstance(fut.exception(), PoisonedRequestError)
    assert sched._supervisor.restarts() == 0
    assert sched.metrics.snapshot().get("poison_probes", 0) == 0


def test_restart_budget_exhaustion_chains_cause(model):
    sched, futs = _run(model, "serve_device_lost@2;serve_device_lost@4",
                       resilience={"max_restarts": 1})
    for f in futs:
        assert isinstance(f.exception(), EngineRestartError)
        assert isinstance(f.exception().__cause__, fault.DeviceLostError)
    snap = sched.metrics.snapshot()
    assert snap["engine_restarts"] == 1 and snap["restart_budget_exhausted"] == 1
    assert snap["failed_inflight"] == 3 and sched._kv.blocks_in_use == 0
    health = sched.health()
    assert health["live"] is False and health["ready"] is False
    assert sched.metrics.snapshot()["health_live"] == 0.0


def test_sticky_cuda_error_ends_in_engine_restart_error(model):
    """A CUDA error that every restart meets again (a poisoned context)
    spends the budget; the futures fail with EngineRestartError."""
    sched = _sched(model, resilience={"max_restarts": 2})

    def lost(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    sched._fns.decode_step = lost
    futs = [sched.submit(p) for p in _prompts()]
    _drive(sched, futs)
    for f in futs:
        assert isinstance(f.exception(), EngineRestartError)
        assert "illegal memory access" in str(f.exception().__cause__)
    assert sched._supervisor.restarts() == 2 and sched._supervisor.exhausted()
    assert sched.metrics.snapshot().get("poison_probes", 0) == 0  # never bisected


@pytest.mark.parametrize("exc,lost", [
    (fault.DeviceLostError("x"), True), (HungTickError("x"), True),
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (RuntimeError("shape mismatch"), False), (ValueError("CUDA error"), False),
])
def test_device_loss_classification(exc, lost):
    assert _is_device_loss(exc) is lost
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        assert _is_device_loss(accel.__new__(accel))


def test_resilience_config_rejects_unknown_keys(model):
    with pytest.raises(ValueError, match="resilience"):
        _sched(model, resilience={"max_restart": 1})
    with pytest.raises(ValueError, match="watchdog"):
        _sched(model, resilience={"watchdog": {"factr": 2.0}})
    with pytest.raises(ValueError, match="drain_deadline_ms"):
        _sched(model, resilience={"drain_deadline_ms": 0})


def test_hung_tick_becomes_a_restart(model):
    _, clean = _run(model, None)
    sched, futs = _run(model, "serve_hang@5:0.5", resilience={"watchdog": {
        "enabled": True, "min_seconds": 0.15, "factor": 4.0, "warmup": 3,
        "poll_seconds": 0.02}})
    for got, want in zip(_tokens(futs), _tokens(clean)):
        np.testing.assert_array_equal(got, want)
    assert sched._supervisor.restarts() == 1
    snap = sched.metrics.snapshot()
    assert snap["serve_watchdog_fires"] >= 1 and snap["engine_restarts"] == 1
    sched.close()


def test_admission_wait_deadline_swept(model):
    sched = _sched(model, num_blocks=4, max_new_tokens=4, slots=2, batch_buckets=[2])
    p = np.arange(2, 10, dtype=np.int32)
    first = sched.submit(p)
    sched.tick()
    parked = sched.submit(p, deadline_ms=20)
    time.sleep(0.03)
    sched.tick()  # the parked request expires at this tick's admission
    with pytest.raises(TimeoutError):
        parked.result(timeout=0)
    _drive(sched, [first])
    assert sched.metrics.snapshot()["timeouts"] == 1


def test_drain(model):
    sched = _sched(model, start=True)
    futs = [sched.submit(p) for p in _prompts()]
    assert sched.drain() >= 0.0
    assert all(f.result()["gen_len"] == 6 for f in futs)
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(_prompts()[0])
    # a drain deadline fails what is left and ends the drain
    sched = _sched(model, max_new_tokens=6, resilience={"drain_deadline_ms": 1})
    futs = [sched.submit(p) for p in _prompts()]
    sched.tick()
    time.sleep(0.005)
    sched.drain()
    assert all(isinstance(f.exception(), TimeoutError) for f in futs)
    assert sched.metrics.snapshot()["drain_expired"] == 1 and sched._kv.blocks_in_use == 0


def test_unfired_fault_reported_at_close(model):
    fault.install("serve_nan@500:0")
    before = get_registry().counters().get("fault_unfired_serve_nan", 0)
    sched = _sched(model)
    _drive(sched, [sched.submit(_prompts()[0])])
    sched.close()
    assert get_registry().counters()["fault_unfired_serve_nan"] == before + 1


def test_health_snapshot_and_gauges(model):
    sched = _sched(model)
    sched.submit(_prompts()[0])
    h = sched.health()
    assert h["ready"] and h["live"] and h["queue_depth"] == 1 and h["slots"] == 4
    assert h["last_tick_age_s"] is None and h["restart_budget"] == 2
    snap = sched.metrics.snapshot()
    assert snap["health_queue_depth"] == 1.0 and snap["health_ready"] == 1.0
    sched.close()


def test_signal_drains_the_engine():
    cfg = {"dataset": {"name": "synthetic_text", "n_classes": VOCAB},
           "model": {"name": "TransformerLM", "embed_dim": 32, "depth": 2, "num_heads": 4,
                     "max_len": 32},
           "serving": {"dtype": "float32", "max_batch_size": 2, "batch_buckets": [2],
                       "seq_buckets": [8],
                       "max_new_tokens": 3, "scheduler": {"enabled": True, "slots": 2,
                                                           "block_size": 4, "num_blocks": 8},
                       "resilience": {"max_restarts": 1}}}
    previous = signal.getsignal(signal.SIGUSR1)
    engine = InferenceEngine.from_config(cfg, device="cpu")
    try:
        engine.install_drain_handler(signal.SIGUSR1)
        futs = [engine.submit(np.asarray([3, 4, 5])) for _ in range(3)]
        signal.raise_signal(signal.SIGUSR1)
        deadline = time.monotonic() + 30
        while not engine.health()["closed"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine.health()["closed"]
        assert [f.result(timeout=10)["gen_len"] for f in futs] == [3, 3, 3]
    finally:
        signal.signal(signal.SIGUSR1, previous)
        engine.close()
    # the drain thread ends once the scheduler has closed
    for t in threading.enumerate():
        if t.name == "serving-drain":
            t.join(timeout=10)
            assert not t.is_alive()


def test_hard_kill_fails_everything_and_closes(model):
    """``hard_kill`` (``_die`` on the scheduler thread): every queued and
    in-flight request fails with the given error, the blocks are released,
    and the scheduler is closed and no longer live."""
    sched = _sched(model, slots=2, batch_buckets=[2])
    futs = [sched.submit(p) for p in _prompts()]
    sched.tick()  # two in flight, one queued
    boom = RuntimeError("replica lost")
    sched.hard_kill(boom)
    sched.tick()
    assert all(f.exception() is boom for f in futs)
    assert sched._kv.blocks_in_use == 0
    assert sched.metrics.snapshot()["failed_inflight"] == 3
    h = sched.health()
    assert h["closed"] and not h["live"]
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(_prompts()[0])
