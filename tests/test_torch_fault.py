"""The port's fault layer against the JAX package's, on the CPU.

- ``engine/fault.py``: over valid specs the port's injector holds the same
  entries as the JAX one (one-shot faults and fail-point windows); over
  malformed specs it raises the same error class with the same text;
  ``take``, ``check_fail_point``, ``pending`` and ``fired`` step for step
  as the JAX injector's on the same calls; ``poison_batches`` poisons the
  same steps of a float stream with NaN and passes an integer one on;
  ``PDT_FAULT_SPEC`` wins over the config's spec; every kind whose
  recovery path is not ported raises ``NotImplementedError`` naming its
  ROADMAP item.
- ``parse_fault_tolerance``: the same attributes and the same
  ``ValueError`` texts as the JAX function.
- ``engine/watchdog.py``: unarmed during warm-up, fires once on a stalled
  step, and ``reset`` enters the warm-up again.
- ``utils/retry.py``: the backoff sequence against the JAX policy's with
  the same seeded jitter (equal floats), the allowlist, exhaustion and
  the total deadline.
- the checkpoint's ``retry`` key: ``ckpt_fail`` and ``restore_fail``
  absorbed, counted in ``ckpt_retries`` and ``Checkpointer.retries``.
"""
import logging
import random
import time
import types

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.engine import fault as jfault
from pytorch_distributed_training_tpu.engine.topology import (
    parse_fault_tolerance as jax_parse_fault_tolerance,
)
from pytorch_distributed_training_tpu.utils.retry import Retry as JaxRetry
from pytorch_distributed_training_tpu_torch.engine import fault
from pytorch_distributed_training_tpu_torch.engine.checkpoint import (
    UNPORTED_CHECKPOINT_KEYS,
    Checkpointer,
)
from pytorch_distributed_training_tpu_torch.engine.topology import parse_fault_tolerance
from pytorch_distributed_training_tpu_torch.engine.watchdog import StepWatchdog
from pytorch_distributed_training_tpu_torch.utils.retry import Retry


@pytest.fixture(autouse=True)
def _clean():
    fault.reset_counters()
    fault.install(None)
    yield
    fault.install(None)


VALID = [
    "",
    "nan_batch@3",
    "nan_batch@2, kill_worker@4:1 ; stall_step@8:0.5",
    "ckpt_fail@0:2;restore_fail@1;ckpt_fail@5",
    "kill_peer@8,sdc_flip@9:0;kill_peer@10:1",
    "serve_nan@3:1;serve_hang@2:0.25;serve_device_lost@4;serve_raise@1",
    "replica_down@2:1;replica_hang@3;autoscale_hang@4:0.5",
    "kv_transfer_stall@1:0.2;kv_transfer_corrupt@2;prefill_replica_down@3:1",
    " ckpt_corrupt@2 ; ; ckpt_async_fail@0:3 ",
]
MALFORMED = [
    "nan_batch", "nan_batch@x", "nan_batch@-1", "nan_batch@3:1", "ckpt_fail@0:0",
    "bogus@1", "kil_peer@3", "nan_batch@2;nan_batch@2", "kill_worker@1:x",
    "stall_step@1:abc", "ckpt_fail@1:y", "@4",
]


@pytest.mark.parametrize("spec", VALID)
def test_spec_parses_as_jax(spec):
    got, want = fault.FaultInjector(spec), jfault.FaultInjector(spec)
    assert got.active == want.active
    assert got._step_faults == want._step_faults
    assert got._fail_windows == want._fail_windows
    assert got.pending() == want.pending()


@pytest.mark.parametrize("spec", MALFORMED)
def test_malformed_spec_raises_as_jax(spec):
    with pytest.raises(Exception) as want:
        jfault.FaultInjector(spec)
    with pytest.raises(type(want.value)) as got:
        fault.FaultInjector(spec)
    assert str(got.value) == str(want.value)


def test_take_fail_points_pending_and_fired_as_jax():
    spec = "nan_batch@2;stall_step@5:0.1;kill_worker@3:1;ckpt_fail@1:2;restore_fail@0"
    sides = (fault.FaultInjector(spec), jfault.FaultInjector(spec))
    calls = [("take", "nan_batch", 1), ("take", "nan_batch", 2), ("take", "nan_batch", 2),
             ("take", "kill_worker", 3), ("point", "ckpt_save"), ("point", "ckpt_save"),
             ("point", "ckpt_restore"), ("point", "ckpt_save"), ("point", "ckpt_save"),
             ("take", "stall_step", 5), ("point", "ckpt_restore")]
    for call in calls:
        results = []
        for inj in sides:
            if call[0] == "take":
                results.append(inj.take(call[1], call[2]))
            else:
                try:
                    inj.check_fail_point(call[1])
                    results.append(None)
                except OSError as e:
                    results.append((type(e).__name__, str(e)))
            results[-1] = (results[-1], inj.pending(), inj.fired())
        assert results[0] == results[1], call
    assert sides[0].pending() == {} and sides[0].fired() == {
        "nan_batch": 1, "kill_worker": 1, "stall_step": 1, "ckpt_save": 2, "ckpt_restore": 1}
    assert isinstance(fault.FaultInjectionError("x"), OSError)
    c = fault.counters()
    assert c["fault_fired_nan_batch"] == 1 and c["injected_ckpt_save_failures"] == 2
    assert c["injected_ckpt_restore_failures"] == 1


def test_poison_batches_as_jax():
    rng = np.random.default_rng(0)
    imgs = [(rng.standard_normal((2, 4, 4, 3)).astype(np.float32), np.arange(2)) for _ in range(5)]
    toks = [(rng.integers(0, 9, (2, 8)).astype(np.int32), np.arange(2)) for _ in range(5)]
    for batches in (imgs, toks):
        outs = [list(mod.poison_batches(iter(batches), mod.FaultInjector("nan_batch@3;nan_batch@5"),
                                        start_iter=2, logger=logging.getLogger("t")))
                for mod in (fault, jfault)]
        for (a, la), (b, lb), (c, _) in zip(*outs, batches):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)
            assert a.dtype == c.dtype
    poisoned = list(fault.poison_batches(iter(imgs), fault.FaultInjector("nan_batch@3"),
                                         start_iter=2))
    assert [bool(np.isnan(x).all()) for x, _ in poisoned] == [False, True, False, False, False]
    assert fault.counters()["injected_nan_batches"] == 3  # two in the loop above, one here
    tokens = list(fault.poison_batches(iter(toks), fault.FaultInjector("nan_batch@0")))
    np.testing.assert_array_equal(tokens[0][0], toks[0][0])  # int tokens cannot carry NaN


@pytest.mark.parametrize("kind,spec,item", [
    ("kill_peer", "kill_peer@3", "P10"), ("sdc_flip", "sdc_flip@2:0", "P10"),
    ("ckpt_corrupt", "ckpt_corrupt@1", "P10"), ("ckpt_async_fail", "ckpt_async_fail@0:2", "P10"),
    # ported (P4): the serving supervisor takes them
    pytest.param("serve_nan", "serve_nan@1", None, id="serve_nan-serve_nan@1-P4"),
    pytest.param("serve_raise", "serve_raise@1", None, id="serve_raise-serve_raise@1-P4"),
    pytest.param("serve_device_lost", "serve_device_lost@1", None,
                 id="serve_device_lost-serve_device_lost@1-P4"),
    pytest.param("serve_hang", "serve_hang@1", None, id="serve_hang-serve_hang@1-P4"),
    # ported (P6): the router, the autoscaler and the disagg coordinator take them
    *[pytest.param(k, f"{k}@1", None, id=f"{k}-{k}@1-P6")
      for k in ("replica_down", "replica_hang", "autoscale_hang", "kv_transfer_stall",
                "kv_transfer_corrupt", "prefill_replica_down")],
])
def test_unported_kind_raises_its_item(kind, spec, item):
    if item is None:
        injector = fault.FaultInjector("nan_batch@1;" + spec)
        fault.check_ported(injector)
        assert kind in injector.kinds() and kind not in fault.UNPORTED_FAULT_KINDS
        # JAX's semantics: one-shot at its tick, a slot or seconds argument
        arg = {"serve_nan": 0.0, "serve_raise": 0.0, "serve_hang": 1.0, "replica_down": 0.0,
               "prefill_replica_down": 0.0}.get(kind, 1.0)
        assert injector.take(kind, 1) == jfault.FaultInjector(spec).take(kind, 1) == arg
        assert injector.take(kind, 1) is None
    else:
        with pytest.raises(NotImplementedError, match=item) as e:
            fault.check_ported(fault.FaultInjector("nan_batch@1;" + spec))
        assert repr(kind) in str(e.value)
    assert set(fault.UNPORTED_FAULT_KINDS) == (
        set(jfault._STEP_KINDS) | set(jfault._POINT_KINDS)) - {
        "nan_batch", "kill_worker", "stall_step", "ckpt_fail", "restore_fail", "serve_nan",
        "serve_raise", "serve_device_lost", "serve_hang", "replica_down", "replica_hang",
        "autoscale_hang", "kv_transfer_stall", "kv_transfer_corrupt", "prefill_replica_down"}
    assert issubclass(fault.DeviceLostError, fault.FaultInjectionError)


@pytest.mark.parametrize("spec", ["nan_batch@1;kill_worker@2:1;stall_step@3:0.5",
                                  "ckpt_fail@0:2;restore_fail@1", ""])
def test_ported_kinds_install(spec):
    fault.check_ported(fault.install(spec))
    assert fault.get_injector().spec == spec


def test_env_var_wins_over_config(monkeypatch):
    from pytorch_distributed_training_tpu_torch.engine import Runner

    monkeypatch.setenv(fault.ENV_VAR, "stall_step@0:0.01")
    runner = Runner(1, 0, 0, "", False, None, {}, device="cpu")
    runner.fault_spec = "nan_batch@1"
    runner.anomaly_window = 4
    runner.logger = logging.getLogger("t")
    runner._setup_faults()
    assert runner._injector.spec == "stall_step@0:0.01"
    assert fault.get_injector() is runner._injector
    monkeypatch.delenv(fault.ENV_VAR)
    runner.fault_spec = None
    runner._setup_faults()  # a runner never inherits the injector before it
    assert not fault.get_injector().active
    runner.fault_spec = "kill_peer@1"
    with pytest.raises(NotImplementedError, match="P10"):
        runner._setup_faults()
    assert not fault.get_injector().active  # refused before it was installed


# --------------------------------------------------------------------- #
# parse_fault_tolerance


FT_CASES = [
    {},
    {"fault_tolerance": None},
    {"fault_tolerance": {"anomaly": {"enabled": True}}},
    {"fault_tolerance": {"anomaly": {"grad_norm_factor": 0, "window": 3, "max_consecutive": 2},
                         "watchdog": {"factor": 3.0, "min_seconds": 0.5, "poll_seconds": 0.1,
                                      "window": 4, "warmup": 2, "checkpoint_and_exit": True},
                         "fault_spec": "nan_batch@2;ckpt_fail@0:1"}},
    {"fault_tolerance": {"anomaly": {"enabled": False}, "watchdog": {"enabled": False,
                                                                     "factor": 0.5}}},
    {"fault_tolerance": {"bogus": 1}},
    {"fault_tolerance": {"anomaly": {"factor": 4}}},
    {"fault_tolerance": {"anomaly": {"grad_norm_factor": -1}}},
    {"fault_tolerance": {"anomaly": {"window": 0}}},
    {"fault_tolerance": {"anomaly": {"max_consecutive": 0}}},
    {"fault_tolerance": {"watchdog": {"timeout": 3}}},
    {"fault_tolerance": {"watchdog": {"factor": 1.0}}},
    {"fault_tolerance": {"watchdog": {"min_seconds": 0}}},
    {"fault_tolerance": {"watchdog": {"poll_seconds": -1}}},
    {"fault_tolerance": {"watchdog": {"warmup": 0}}},
    {"fault_tolerance": {"fault_spec": "bogus@1"}},
]


@pytest.mark.parametrize("cfg", FT_CASES, ids=[str(i) for i in range(len(FT_CASES))])
def test_parse_fault_tolerance_as_jax(cfg):
    want, got = types.SimpleNamespace(), types.SimpleNamespace()
    try:
        jax_parse_fault_tolerance(want, cfg)
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            parse_fault_tolerance(got, cfg)
        assert str(ei.value) == str(e)
        return
    parse_fault_tolerance(got, cfg)
    assert vars(got) == vars(want)


# --------------------------------------------------------------------- #
# the watchdog


@pytest.mark.chaos
def test_watchdog_unarmed_during_warmup():
    fired = []
    with StepWatchdog(factor=2.0, min_seconds=0.05, window=8, warmup=3, poll_seconds=0.02,
                      on_hang=lambda *a: fired.append(a)) as wd:
        wd.step_started(0)
        time.sleep(0.3)
        wd.step_finished()
        assert wd.fires == 0 and not fired


@pytest.mark.chaos
def test_watchdog_fires_once_on_a_stalled_step():
    fired = []
    with StepWatchdog(factor=2.0, min_seconds=0.15, window=8, warmup=2, poll_seconds=0.02,
                      on_hang=lambda *a: fired.append(a)) as wd:
        for i in range(2):
            wd.step_started(i)
            time.sleep(0.01)
            wd.step_finished()
        assert wd.trailing_median() is not None
        wd.step_started(2)
        time.sleep(0.4)
        wd.step_finished()
        deadline = time.monotonic() + 5.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.01)
    assert wd.fires == 1
    step, elapsed, limit = fired[0]
    assert step == 2 and elapsed > limit >= 0.15


@pytest.mark.chaos
def test_watchdog_reset_reenters_warmup():
    fired = []
    with StepWatchdog(factor=2.0, min_seconds=0.05, window=8, warmup=2, poll_seconds=0.02,
                      on_hang=lambda *a: fired.append(a)) as wd:
        for i in range(2):
            wd.step_started(i)
            time.sleep(0.01)
            wd.step_finished()
        assert wd.trailing_median() is not None
        wd.reset()
        assert wd.resets == 1 and wd.trailing_median() is None
        wd.step_started(2)
        time.sleep(0.3)
        wd.step_finished()
        assert wd.fires == 0 and not fired


@pytest.mark.parametrize("kwargs", [dict(factor=1.0), dict(min_seconds=0), dict(warmup=0),
                                    dict(poll_seconds=-1.0)])
def test_watchdog_rejects_as_jax(kwargs):
    from pytorch_distributed_training_tpu.engine.watchdog import StepWatchdog as JaxWatchdog

    with pytest.raises(ValueError) as want:
        JaxWatchdog(**kwargs).close()
    with pytest.raises(ValueError) as got:
        StepWatchdog(**kwargs).close()
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- #
# Retry


def _flaky(n_fail, exc=OSError):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n_fail:
            raise exc("transient")
        return "ok"

    return fn, calls


@pytest.mark.parametrize("jitter", [0.0, 0.25, 1.0])
def test_retry_backoff_sequence_as_jax(jitter):
    """The same delays, float for float, from the same seeded jitter."""
    seqs = []
    for cls in (Retry, JaxRetry):
        slept, retries = [], []
        policy = cls(attempts=6, backoff=0.1, max_backoff=0.9, jitter=jitter,
                     sleep=slept.append, rng=random.Random(7))
        fn, calls = _flaky(5)
        assert policy.call(fn, on_retry=lambda a, e, d: retries.append((a, d))) == "ok"
        assert calls["n"] == 6
        seqs.append((slept, retries))
    assert seqs[0] == seqs[1]
    if jitter == 0.0:
        assert seqs[0][0] == pytest.approx([0.1, 0.2, 0.4, 0.8, 0.9])


def test_retry_allowlist_exhaustion_and_deadline():
    policy = Retry(attempts=3, backoff=0.0, jitter=0.0, sleep=lambda d: None)
    fn, calls = _flaky(5, ValueError)
    with pytest.raises(ValueError):
        policy.call(fn)
    assert calls["n"] == 1  # not allowlisted: no retry
    fn, calls = _flaky(5)
    with pytest.raises(OSError, match="transient"):
        policy.call(fn)
    assert calls["n"] == 3 and fault.counters()["retry_exhausted"] == 1
    now, slept = {"t": 0.0}, []

    def fake_sleep(d):
        slept.append(d)
        now["t"] += d

    policy = Retry(attempts=5, backoff=1.0, max_backoff=8.0, jitter=0.0, total_timeout_s=2.0,
                   sleep=fake_sleep, clock=lambda: now["t"])
    fn, calls = _flaky(9)
    with pytest.raises(OSError):
        policy.call(fn)
    assert calls["n"] == 2 and slept == [1.0]
    assert fault.counters()["retry_deadline_exceeded"] == 1
    for kwargs in (dict(attempts=0), dict(backoff=-1.0), dict(jitter=2.0),
                   dict(total_timeout_s=0.0)):
        with pytest.raises(ValueError) as want:
            JaxRetry(**kwargs)
        with pytest.raises(ValueError) as got:
            Retry(**kwargs)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- #
# the checkpoint's retry key


def _payload(it):
    return {"iter": it, "x": torch.arange(4.0) + it}


def test_checkpoint_retry_absorbs_save_and_restore_failures(tmp_path):
    assert "retry" not in UNPORTED_CHECKPOINT_KEYS
    ck = Checkpointer.from_config(
        {"checkpoint": {"dir": str(tmp_path), "retry": {"attempts": 3, "backoff": 0.0,
                                                         "jitter": 0.0}}})
    fault.install("ckpt_fail@0:2;restore_fail@0:1")
    ck.save(0, _payload(0), extras={"epoch": 0})
    assert ck.all_steps() == [0] and ck.retries == 2
    seen = []
    assert ck.restore_latest(lambda p: seen.append(p["x"]), "cpu") == 1
    torch.testing.assert_close(seen[0], torch.arange(4.0))
    assert ck.retries == 3
    c = fault.counters()
    assert c["ckpt_retries"] == 3 and c["injected_ckpt_save_failures"] == 2
    assert c["injected_ckpt_restore_failures"] == 1
    assert fault.get_injector().pending() == {}


def test_checkpoint_retry_exhausted_and_unknown_keys(tmp_path):
    ck = Checkpointer.from_config(
        {"checkpoint": {"dir": str(tmp_path), "retry": {"attempts": 2, "backoff": 0.0}}})
    fault.install("ckpt_fail@0:2")
    with pytest.raises(fault.FaultInjectionError):
        ck.save(0, _payload(0))
    assert ck.all_steps() == [] and ck.retries == 1
    ck.save(0, _payload(0))  # the window is spent
    assert ck.all_steps() == [0]
    with pytest.raises(ValueError, match=r"checkpoint.retry: unknown key\(s\) \['tries'\]"):
        Checkpointer.from_config({"checkpoint": {"dir": str(tmp_path), "retry": {"tries": 3}}})
