"""The port's runner under injected faults against the JAX runner, on the CPU.

The four scenarios of the JAX package's ``tests/test_fault_tolerance.py``
(``:507-637``), ResNet-18 at 16x16 over the synthetic set, batch 16, SGD
with momentum at lr 0.001 (at their 0.01 two clean runs of the packages
part by 8.5e-4 in 4 steps: BatchNorm over 16 values a channel in the last
stage magnifies f32 rounding), local BatchNorm statistics; the JAX runner on a one-device
mesh; the port's runner from the JAX runner's initial weights:

- ``nan_batch@1`` with the guard: one skipped step, 3 iterations, 2
  applied;
- ``nan_batch@2;3;4`` with ``max_consecutive: 3`` and a checkpoint every
  2 iterations: one rollback (to the save of iteration 3), 6 iterations, 4
  applied; the port's final state bitwise that of its own run of
  ``nan_batch@2;3`` (no rollback);
- the same burst from iteration 1 with no checkpoint: ``RuntimeError``
  naming ``no training.checkpoint`` on both;
- ``ckpt_fail@0:2`` with ``retry``: 2 retries, the final parameters
  bitwise the port's clean run's, and a new run resumes from the saves.

Each holds the recovery counters, ``iter`` and ``opt_state.step`` equal
to the JAX runner's and every parameter and BatchNorm buffer within atol
1e-4 (``tests/test_torch_resnet_train.py``'s limit after SGD steps).
Besides, port only: ``stall_step`` past the watchdog's warm-up (armed for
a second past its limit, read from the steps it timed) fires it once
(and with ``checkpoint_and_exit`` saves and stops), ``kill_worker``
without a process pool logs and goes on, and with one the pool respawns
the worker and the batches stay the clean run's.
"""
import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.engine import fault as jfault
from pytorch_distributed_training_tpu_torch.engine import Runner, fault
from pytorch_distributed_training_tpu_torch.models import resnet_state_dict_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean():
    for mod in (fault, jfault):
        mod.reset_counters()
        mod.install(None)
    yield
    for mod in (fault, jfault):
        mod.install(None)


def _cfg(tmp_path, train_iters, fault_spec=None, ckpt=False, interval=2, anomaly=None,
          retry=None, watchdog=None, **training):
    cfg = {"dataset": {"name": "synthetic", "root": str(tmp_path), "n_classes": 10,
                       "image_size": 16, "n_samples": 64},
           "training": {"optimizer": {"name": "SGD", "lr": 0.001, "weight_decay": 1.0e-4,
                                      "momentum": 0.9},
                        "lr_schedule": {"name": "multi_step", "milestones": [100],
                                        "gamma": 0.1},
                        "train_iters": train_iters, "print_interval": 10, "val_interval": 100,
                        "batch_size": 16, "num_workers": 0, "sync_bn": False, **training},
           "validation": {"batch_size": 16, "num_workers": 0},
           "model": {"name": "ResNet18"}}
    ft = {}
    if anomaly is not None:
        ft["anomaly"] = anomaly
    if watchdog is not None:
        ft["watchdog"] = watchdog
    if fault_spec is not None:
        ft["fault_spec"] = fault_spec
    if ft:
        cfg["training"]["fault_tolerance"] = ft
    if ckpt:
        cfg["training"]["checkpoint"] = {"dir": str(tmp_path / "ckpt"), "interval": interval,
                                         "resume": True}
        if retry is not None:
            cfg["training"]["checkpoint"]["retry"] = retry
    return cfg


def _jax_run(cfg, monkeypatch):
    from pytorch_distributed_training_tpu.engine import Runner as JaxRunner
    from pytorch_distributed_training_tpu.engine import paths
    from pytorch_distributed_training_tpu.parallel import make_mesh

    mesh = make_mesh(jax.devices()[:1])
    monkeypatch.setattr(paths, "make_mesh", lambda *a, **kw: mesh)

    class _Jax(JaxRunner):
        def _train_loop(self, iter_generator, train_cfg):
            self.init = jax.tree_util.tree_map(
                np.asarray, {"params": self.state.params, "batch_stats": self.state.batch_stats})
            super()._train_loop(iter_generator, train_cfg)

    runner = _Jax(num_nodes=1, rank=0, seed=3, dist_url="tcp://127.0.0.1:9901",
                  dist_backend="tpu", multiprocessing=False, logger_queue=None, global_cfg=cfg,
                  tb_writer_constructor=lambda: None)
    try:
        runner()
    finally:
        counters = {k: v for k, v in jfault.counters().items() if not k.startswith("compiles/")}
    return runner, counters


def _port_run(cfg, init, on_iter=None):
    state = resnet_state_dict_from_jax(init)

    class _Port(Runner):
        def _build_image_model(self, *args):
            super()._build_image_model(*args)
            self.model.load_state_dict(state, strict=True)

    runner = _Port(num_nodes=1, rank=0, seed=3, dist_url="", multiprocessing=False,
                   logger_queue=None, global_cfg=cfg, device="cpu", on_iter=on_iter)
    runner()
    return runner


def _assert_near_jax(port, jax_runner):
    want = resnet_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jax_runner.state.params,
                     "batch_stats": jax_runner.state.batch_stats}))
    for name, val in port.model.state_dict().items():
        np.testing.assert_allclose(val.numpy(), want[name].numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)
    assert port.train_step.opt_state.step == int(jax_runner.state.opt_state.step)
    assert port.iter == jax_runner.iter


def _state(runner):
    step = runner.train_step
    return ({k: v.clone() for k, v in runner.model.state_dict().items()},
            [m.clone() for m in step.opt_state.momentum], step.opt_state.step)


def _assert_equal_states(a, b):
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1])) and a[2] == b[2]


def test_nan_batch_skips_and_continues_as_jax(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, 3, fault_spec="nan_batch@1", anomaly={"enabled": True})
    jr, jc = _jax_run(cfg, monkeypatch)
    port = _port_run(_cfg(tmp_path / "p", 3, fault_spec="nan_batch@1",
                          anomaly={"enabled": True}), jr.init)
    assert fault.counters() == jc == {"fault_fired_nan_batch": 1, "injected_nan_batches": 1,
                                      "skipped_steps": 1}
    assert port.iter == 3 and port.train_step.opt_state.step == 2
    _assert_near_jax(port, jr)


def test_rollback_after_a_burst_as_jax(tmp_path, monkeypatch):
    spec = "nan_batch@2;nan_batch@3;nan_batch@4"
    anomaly = {"enabled": True, "max_consecutive": 3}
    jr, jc = _jax_run(_cfg(tmp_path / "j", 6, fault_spec=spec, ckpt=True, anomaly=anomaly),
                      monkeypatch)
    port = _port_run(_cfg(tmp_path / "p", 6, fault_spec=spec, ckpt=True, anomaly=anomaly),
                     jr.init)
    got = fault.counters()
    assert got == jc
    assert got["rollbacks"] == 1 and got["skipped_steps"] == 3
    assert port.iter == 6 and port.train_step.opt_state.step == 4
    assert len(port.rollback_seconds) == 1
    _assert_near_jax(port, jr)
    # the replay from the save of iteration 3 is the run that only skipped
    fault.reset_counters()
    skip_only = _port_run(_cfg(tmp_path / "s", 6, fault_spec="nan_batch@2;nan_batch@3",
                               anomaly=anomaly), jr.init)
    assert "rollbacks" not in fault.counters()
    _assert_equal_states(_state(port), _state(skip_only))


def test_rollback_without_a_checkpoint_is_loud_as_jax(tmp_path, monkeypatch):
    spec = "nan_batch@1;nan_batch@2;nan_batch@3"
    anomaly = {"enabled": True, "max_consecutive": 3}
    with pytest.raises(RuntimeError, match="no training.checkpoint") as want:
        _jax_run(_cfg(tmp_path, 6, fault_spec=spec, anomaly=anomaly), monkeypatch)
    with pytest.raises(RuntimeError, match="no training.checkpoint") as got:
        Runner(1, 0, 3, "", False, None, _cfg(tmp_path / "p", 6, fault_spec=spec,
                                               anomaly=anomaly), device="cpu")()
    assert str(got.value) == str(want.value)


def test_ckpt_save_failures_retried_as_jax(tmp_path, monkeypatch):
    retry = {"attempts": 3, "backoff": 0.0, "jitter": 0.0}
    jr, jc = _jax_run(_cfg(tmp_path / "j", 4, ckpt=True, fault_spec="ckpt_fail@0:2",
                           retry=retry), monkeypatch)
    port = _port_run(_cfg(tmp_path / "p", 4, ckpt=True, fault_spec="ckpt_fail@0:2",
                          retry=retry), jr.init)
    got = fault.counters()
    assert {k: got.get(k) for k in jc} == jc
    assert got["ckpt_retries"] == 2 and got["injected_ckpt_save_failures"] == 2
    assert port.checkpointer.retries == 2
    _assert_near_jax(port, jr)
    fault.install(None)
    clean = _port_run(_cfg(tmp_path / "c", 4, ckpt=True), jr.init)
    _assert_equal_states(_state(port), _state(clean))
    resumed = _port_run(_cfg(tmp_path / "p", 4, ckpt=True), jr.init)
    assert resumed.iter == 4 and resumed.checkpointer.last_restore["step"] == 3


# --------------------------------------------------------------------- #
# port only: the watchdog and kill_worker through the runner


WATCHDOG = {"factor": 2.0, "min_seconds": 0.5, "poll_seconds": 0.02, "warmup": 3}


def _stall_past_the_limit(runner):
    """After step 3 (the warm-up done), arm ``stall_step@4`` for a second
    past the watchdog's limit, read from the steps it timed: a fixed stall
    could sit under the limit of a loaded host's slow steps."""
    if runner.iter == 3:
        wd = runner._watchdog
        limit = max(wd.min_seconds, wd.factor * wd.trailing_median())
        runner._injector = fault.install(f"stall_step@4:{limit + 1.0}")


@pytest.mark.chaos
def test_stall_past_the_warmup_fires_the_watchdog_once(tmp_path):
    port = _port_run(_cfg(tmp_path, 6, watchdog=WATCHDOG), _jax_init(), _stall_past_the_limit)
    assert port._watchdog.fires == 1 and fault.counters()["watchdog_fires"] == 1
    assert fault.counters()["fault_fired_stall_step"] == 1 and port.iter == 6


@pytest.mark.chaos
def test_watchdog_checkpoint_and_exit(tmp_path):
    watchdog = {**WATCHDOG, "checkpoint_and_exit": True}
    port = _port_run(_cfg(tmp_path, 8, watchdog=watchdog, ckpt=True, interval=100), _jax_init(),
                     _stall_past_the_limit)
    assert port._watchdog.fires == 1 and port.iter == 4
    assert port.checkpointer.all_steps() == [4]
    with pytest.raises(ValueError, match="checkpoint_and_exit needs the preemption path"):
        Runner(1, 0, 3, "", False, None, _cfg(tmp_path / "x", 2, watchdog=watchdog),
               device="cpu")()


@pytest.mark.chaos
@pytest.mark.parametrize("mode", ["thread", "process"])
def test_kill_worker(tmp_path, mode, caplog):
    init = _jax_init()
    seen = {}

    def record(name):
        return lambda r: seen.setdefault(name, []).append(float(r.last_loss))

    cfg = _cfg(tmp_path / "c", 6, worker_mode=mode, num_workers=2)
    _port_run(cfg, init, record("clean"))
    fault.reset_counters()
    port = _port_run(_cfg(tmp_path / "k", 6, fault_spec="kill_worker@2", worker_mode=mode,
                          num_workers=2), init, record("killed"))
    assert seen["killed"] == seen["clean"]  # the same batches, step for step
    if mode == "process":
        assert fault.counters().get("worker_respawns") == 1
        assert port.train_loader._pool is None  # closed with the runner
    else:
        assert "worker_respawns" not in fault.counters()
        assert fault.get_injector().fired() == {"kill_worker": 1}


_INIT = {}


def _jax_init():
    """The initial weights of the JAX ResNet-18 at 16x16 (seed 3), once."""
    if not _INIT:
        from pytorch_distributed_training_tpu.models import get_model

        import jax.numpy as jnp

        model = get_model("ResNet18", num_classes=10)
        v = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)), train=False)
        _INIT.update(jax.tree_util.tree_map(np.asarray, dict(v)))
    return _INIT
