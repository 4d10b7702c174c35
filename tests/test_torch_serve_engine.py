"""The port's serving engine, batcher and CLI on the CPU.

The load-bearing test holds the port's ``InferenceEngine(device="cpu")``
against the JAX package's ``InferenceEngine`` on the same weights: every
request gets the same greedy tokens.  The JAX engine pads each batch to a
multiple of its 8 virtual devices and batches by its own timing; rows are
independent, so the real rows must still agree.
"""
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu_torch.config_parsing import (
    get_serve_cfg,
    validate_serve_cfg,
)
from pytorch_distributed_training_tpu_torch.models import lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.serving import (
    DynamicBatcher,
    InferenceEngine,
    OverloadedError,
)
from pytorch_distributed_training_tpu_torch.serving.__main__ import main
from pytorch_distributed_training_tpu_torch.serving.metrics import ServingMetrics

VOCAB = 64


def _cfg(**serving):
    serve = {
        "dtype": "float32", "max_batch_size": 4, "max_delay_ms": 2,
        "batch_buckets": [4], "seq_buckets": [16], "max_new_tokens": 6,
        "temperature": 0.0, "eos_id": None, "seed": 0,
    }
    serve.update(serving)
    return {
        "dataset": {"name": "synthetic_text", "n_classes": VOCAB},
        "model": {"name": "TransformerLM", "embed_dim": 32, "depth": 2,
                  "num_heads": 2, "max_len": 48, "fused_tails": True},
        "serving": serve,
    }


def _prompts(n, seed, max_len=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, int(rng.integers(1, max_len + 1))).astype(np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def cpu_engine():
    with InferenceEngine.from_config(_cfg(), device="cpu") as engine:
        yield engine


# --------------------------------------------------------------------- #
# (e) the port's engine serves the JAX engine's tokens


def test_engine_matches_jax_engine():
    from pytorch_distributed_training_tpu.serving.engine import (
        InferenceEngine as JaxEngine,
    )

    cfg = _cfg(eos_id=21)
    prompts = _prompts(10, seed=1)
    with JaxEngine.from_config(cfg) as jax_engine:
        params = jax.tree_util.tree_map(np.asarray, jax_engine.params)
        want = [f.result(timeout=120) for f in [jax_engine.submit(p) for p in prompts]]
    with InferenceEngine.from_config(
        cfg, device="cpu", state_dict=lm_state_dict_from_jax(params)
    ) as engine:
        got = [f.result(timeout=120) for f in [engine.submit(p) for p in prompts]]
    assert any(w["gen_len"] < 6 for w in want)  # the eos stopped some row
    for w, g in zip(want, got):
        assert g["gen_len"] == w["gen_len"]
        np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]))


# --------------------------------------------------------------------- #
# (f) no silent CPU fallback


def test_from_config_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine.from_config(_cfg())


# --------------------------------------------------------------------- #
# (g) the CLI in-process


def test_cli_serves_and_prints_snapshot(tmp_path, capsys):
    import yaml

    path = tmp_path / "serve.yml"
    path.write_text(yaml.safe_dump(_cfg(seq_buckets=[8, 16])))
    rc = main(["--config", str(path), "--requests", "6", "--device", "cpu",
               "--log-dir", str(tmp_path / "log")])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    snap = json.loads(last)["serving"]
    assert snap["requests"] == 6 and snap["gen_tokens"] == 36
    # the CPU path runs the plain twins: no kernel launched
    assert snap["launches_add_layernorm"] == 0 and snap["launches_bias_gelu"] == 0
    assert (tmp_path / "log" / "serve.log").exists()


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import yaml

    path = tmp_path / "serve.yml"
    path.write_text(yaml.safe_dump(_cfg()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config", str(path), "--log-dir", str(tmp_path / "log")])


def test_shipped_config_is_the_full_width_model():
    from pathlib import Path

    import pytorch_distributed_training_tpu_torch as pkg

    cfg = get_serve_cfg(str(Path(pkg.__file__).parent / "configs" / "serve-lm-1024.yml"))
    assert cfg["model"] == {"name": "TransformerLM", "embed_dim": 1024, "depth": 16,
                            "num_heads": 16, "max_len": 2048, "fused_tails": True}
    assert cfg["dataset"]["n_classes"] == 32768
    assert cfg["serving"]["dtype"] == "bfloat16" and cfg["serving"]["eos_id"] is None


# --------------------------------------------------------------------- #
# engine surface


def test_engine_results_warmup_and_snapshot(cpu_engine):
    warm = cpu_engine.warmup()
    assert warm["pairs"] == 1.0 and warm["warmup_ms"] > 0
    futs = [cpu_engine.submit(p) for p in _prompts(5, seed=2)]
    futs.append(cpu_engine.submit(np.array([1, 2, 3]), max_new_tokens=2))
    res = [f.result(timeout=60) for f in futs]
    for r in res[:-1]:
        assert r["gen_len"] == 6 and r["tokens"].dtype == np.int32
        assert ((r["tokens"] >= 0) & (r["tokens"] < VOCAB)).all()
    assert res[-1]["gen_len"] == 2 and res[-1]["tokens"].shape == (2,)
    snap = cpu_engine.snapshot()
    assert snap["requests"] >= 6 and snap["warmup_ms"] == warm["warmup_ms"]
    assert {"launches_add_layernorm", "launches_bias_gelu"} <= set(snap)
    assert cpu_engine.health() == {"ready": True, "live": True, "queue_depth": 0}
    assert cpu_engine.depth() == 0


@pytest.mark.parametrize(
    "payload,match",
    [(np.zeros(17, np.int32), "exceeds largest seq bucket"),
     (np.zeros((2, 4), np.int32), "1-D"),
     (np.array([1, VOCAB]), r"\[0, 64\)"),
     (np.array([0.5, 1.0]), "integer")],
)
def test_engine_rejects_bad_prompts(cpu_engine, payload, match):
    with pytest.raises(ValueError, match=match):
        cpu_engine.submit(payload)


@pytest.mark.parametrize(
    "serving,item",
    # ported (P7a): a port training checkpoint serves
    [pytest.param({"checkpoint": "run/ckpt"}, None, id="serving0-P7"),
     # ported (P4): the continuous scheduler, and its supervisor
     pytest.param({"scheduler": {"enabled": True}}, None, id="serving1-P4"),
     # ported (P5): the decode modes
     pytest.param({"quant": {"enabled": True}}, None, id="serving2-P5"),
     pytest.param({"lora": {"enabled": True, "adapters": ["tenant-a"]}}, None,
                  id="serving3-P5"),
     pytest.param({"speculative": {"enabled": True, "k": 2}}, None, id="serving4-P5"),
     pytest.param({"resilience": {"max_restarts": 1}}, None, id="serving5-P4")],
)
def test_unported_serving_modes_raise(serving, item, tmp_path):
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            InferenceEngine.from_config(_cfg(**serving), device="cpu")
        return
    from pytorch_distributed_training_tpu_torch.engine.checkpoint import Checkpointer

    serving = dict(serving)
    state = None
    if "checkpoint" in serving:
        source = InferenceEngine.from_config(_cfg(seed=5), device="cpu")
        source.close()
        state = {k: v.float() for k, v in source.model.state_dict().items()}
        serving["checkpoint"] = str(tmp_path / "ckpt")
        Checkpointer(serving["checkpoint"]).save(
            0, {"iter": 0, "model": state, "optimizer": None, "ema": None})
    if "resilience" in serving or "lora" in serving or "speculative" in serving:
        # as in JAX, the supervisor, the adapters and the draft live in the
        # scheduler: alone they raise
        with pytest.raises(ValueError, match="requires? serving.scheduler.enabled"):
            InferenceEngine.from_config(_cfg(**serving), device="cpu")
        serving["scheduler"] = {"enabled": True}
    with InferenceEngine.from_config(_cfg(**serving), device="cpu") as engine:
        adapter = "tenant-a" if "lora" in serving else None
        assert engine.submit(np.array([5]), adapter=adapter).result(timeout=60)["gen_len"] == 6
        assert (engine.scheduler is not None) == ("scheduler" in serving)
        for mode in ("quant", "lora", "speculative"):
            assert engine.serving_modes[mode] == (mode in serving)
        if "resilience" in serving:
            assert engine.health()["restart_budget"] == 1
        if state is not None:
            for k, v in engine.model.state_dict().items():
                assert torch.equal(v.float(), state[k]), k


def test_disabled_mode_blocks_are_accepted():
    cfg = _cfg(scheduler={"enabled": False}, quant={"enabled": False})
    with InferenceEngine.from_config(cfg, device="cpu") as engine:
        assert engine.submit(np.array([5])).result(timeout=60)["gen_len"] == 6


def test_bucket_overflow_guard():
    with pytest.raises(ValueError, match="exceeds model max_len"):
        InferenceEngine.from_config(_cfg(seq_buckets=[44]), device="cpu")


def test_random_init_repeats_for_a_seed():
    a = InferenceEngine.from_config(_cfg(seed=3), device="cpu")
    b = InferenceEngine.from_config(_cfg(seed=3), device="cpu")
    try:
        for (name, pa), (_, pb) in zip(a.model.named_parameters(), b.model.named_parameters()):
            assert torch.equal(pa, pb), name
        w = a.model.block0.attn.qkv.weight
        # lecun normal: variance 1/fan_in, nothing past two (pre-scale) sigmas
        assert abs(w.std().item() - (1 / 32) ** 0.5) < 0.02
        assert w.abs().max().item() <= 2 * (1 / 32) ** 0.5 / 0.87962566103423978 + 1e-6
    finally:
        a.close()
        b.close()


def test_validate_serve_cfg_requires_sections():
    with pytest.raises(KeyError, match="serving"):
        validate_serve_cfg({"dataset": {"name": "x", "n_classes": 2}, "model": {"name": "m"}})


# --------------------------------------------------------------------- #
# batcher + metrics (host code carried over from the JAX package)


def _echo(requests):
    return [r.payload for r in requests]


def test_batcher_flushes_full_batches():
    sizes = []

    def run(reqs):
        sizes.append(len(reqs))
        return _echo(reqs)

    with DynamicBatcher(run, max_batch_size=4, max_delay_ms=1000) as b:
        futs = [b.submit(i) for i in range(8)]
        assert [f.result(timeout=10) for f in futs] == list(range(8))
    assert sum(sizes) == 8 and max(sizes) <= 4


def test_batcher_sheds_and_times_out():
    gate = threading.Event()

    def run(reqs):
        gate.wait(10)
        return _echo(reqs)

    b = DynamicBatcher(run, max_batch_size=1, max_delay_ms=0, deadline_ms=50, max_backlog=2)
    try:
        first = b.submit("a")
        time.sleep(0.05)  # the flush thread holds "a"
        queued = [b.submit("b"), b.submit("c")]
        with pytest.raises(OverloadedError):
            b.submit("d")
        time.sleep(0.1)
        gate.set()
        assert first.result(timeout=10) == "a"
        for f in queued:
            with pytest.raises(TimeoutError):
                f.result(timeout=10)
        assert b.sheds == 1 and b.timeouts == 2
    finally:
        gate.set()
        b.close()


def test_batcher_propagates_runner_errors():
    def run(reqs):
        raise RuntimeError("boom")

    with DynamicBatcher(run, max_batch_size=2, max_delay_ms=1) as b:
        with pytest.raises(RuntimeError, match="boom"):
            b.submit(1).result(timeout=10)


def test_metrics_phase_attribution():
    m = ServingMetrics()
    now = time.monotonic()
    m.record_batch([now, now], n_items=10, queue_depth=3, gen_lens=[6, 4],
                   prompt_tokens=20, prefill_s=0.5, decode_s=2.0)
    m.incr("sheds")
    snap = m.snapshot()
    assert snap["requests"] == 2 and snap["batches"] == 1 and snap["sheds"] == 1
    # prefill answers for the prompt tokens plus each request's token 0
    assert snap["prefill_tokens_per_sec"] == pytest.approx(22 / 0.5)
    assert snap["decode_tokens_per_sec"] == pytest.approx(8 / 2.0)
    assert snap["max_queue_depth"] == 3 and snap["gen_tokens"] == 10


def test_registry_reservoir_is_bounded_and_exact():
    from pytorch_distributed_training_tpu_torch.telemetry.registry import MetricsRegistry

    reg = MetricsRegistry()
    small = reg.histogram("small", 64)
    vals = np.random.default_rng(0).normal(size=50)
    for v in vals:
        small.observe(v)
    snap = small.snapshot()
    # below the reservoir size the percentiles are numpy's, exactly
    assert snap["p99"] == pytest.approx(np.percentile(vals, 99))
    big = reg.histogram("big", 16)
    for v in range(1000):
        big.observe(v)
    snap = big.snapshot()
    assert snap["count"] == 1000 and snap["sum"] == sum(range(1000)) and snap["max"] == 999
    assert len(big._sample) == 16
    with pytest.raises(TypeError, match="already registered"):
        reg.counter("big")
