"""The port's continuous scheduler on the CPU.

- Against the JAX package's ``ContinuousScheduler`` on the same weights:
  one scripted trace (ragged prompts, a shared prefix, per-request caps,
  an EOS, more requests than slots), greedy, token for token.
- Against the port's own whole-batch path (the counterparts of
  ``tests/test_serving.py:569`` and ``:604``): greedy and sampled, row
  ``r`` of a batcher call with seed ``s`` submitted with key ``s + [r]``.
- Retire-and-refill determinism, admission waits, deadline expiry and
  backlog shedding, the async pipeline against the sync loop (bitwise, at
  depths 1 and 2, greedy and sampled), streaming, the background loop, and
  the engine and CLI with ``serving.scheduler`` on.

The JAX scheduler is built once for the module; traces are a few requests
of at most 8 tokens.
"""
import json
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
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.serving import InferenceEngine, OverloadedError
from pytorch_distributed_training_tpu_torch.serving.__main__ import main
from pytorch_distributed_training_tpu_torch.serving.decode import build_generate_fn
from pytorch_distributed_training_tpu_torch.serving.scheduler import ContinuousScheduler
from pytorch_distributed_training_tpu_torch.telemetry.registry import get_registry

VOCAB = 61
SMALL = dict(max_len=32, embed_dim=32, depth=2, num_heads=4)


@pytest.fixture(scope="module")
def lm():
    """The JAX small LM's init (biases and scales perturbed), and the port's
    model on the same weights."""
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


def _sched(model, **kw):
    kw = {**dict(slots=2, block_size=4, num_blocks=16, batch_buckets=[2], seq_buckets=[8],
                 max_new_tokens=6, temperature=0.0, eos_id=None, start=False), **kw}
    return ContinuousScheduler(model, **kw)


def _drive(sched, futures, limit=200):
    n = 0
    while any(not f.done() for f in futures):
        sched.tick()
        n += 1
        assert n < limit, "scheduler failed to drain"
    return n


def _results(sched, prompts, kwargs=None):
    futs = [sched.submit(p, **k) for p, k in zip(prompts, kwargs or [{}] * len(prompts))]
    _drive(sched, futs)
    return [f.result() for f in futs]


def _trace():
    """Five requests through two slots: ragged, two sharing a prefix block,
    two with caps."""
    rng = np.random.default_rng(3)
    stem = rng.integers(2, VOCAB, 4)
    prompts = [rng.integers(2, VOCAB, 2), np.r_[stem, rng.integers(2, VOCAB, 3)],
               rng.integers(2, VOCAB, 5), np.r_[stem, rng.integers(2, VOCAB, 2)],
               rng.integers(2, VOCAB, 8)]
    return [p.astype(np.int32) for p in prompts], [None, 3, None, 2, None]


def test_greedy_trace_matches_jax_scheduler(lm):
    jm, params, pm = lm
    prompts, caps = _trace()
    kw = dict(slots=2, block_size=4, num_blocks=16, batch_buckets=[2], seq_buckets=[8],
              max_new_tokens=6, temperature=0.0, eos_id=1, start=False)
    js = JaxScheduler(jm, params, **kw)
    want = _results(js, prompts, [{"max_new_tokens": c} for c in caps])
    ps = ContinuousScheduler(pm, **kw)
    got = _results(ps, prompts, [{"max_new_tokens": c} for c in caps])
    for w, g in zip(want, got):
        assert g["gen_len"] == w["gen_len"]
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
    ps_snap, js_snap = ps.metrics.snapshot(), js.metrics.snapshot()
    for key in ("admitted", "retired", "prefix_hit_blocks", "prefix_miss_blocks"):
        assert ps_snap.get(key) == js_snap.get(key), key
    assert ps_snap["prefix_hit_blocks"] > 0


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_matches_whole_batch_path(lm, temperature):
    """Row r of the batcher's call with seed (7, 1) draws with key (7, 1, r):
    the scheduler, re-batching rows every step, repeats it."""
    _, _, pm = lm
    rng = np.random.default_rng(3)
    lens = [2, 6, 4]
    toks = np.zeros((3, 8), np.int32)
    rows = [rng.integers(2, VOCAB, n).astype(np.int32) for n in lens]
    for i, r in enumerate(rows):
        toks[i, : len(r)] = r
    gen = build_generate_fn(pm, 6, temperature=temperature, eos_id=1)
    out, gl = gen(toks, np.asarray(lens, np.int32), seed=(7, 1))
    sched = _sched(pm, slots=4, batch_buckets=[4], temperature=temperature, eos_id=1)
    got = _results(sched, rows, [{"key": (7, 1, i)} for i in range(3)])
    for i, res in enumerate(got):
        assert res["gen_len"] == gl[i]
        np.testing.assert_array_equal(res["tokens"], out[i, : gl[i]])


def test_retire_and_refill_is_deterministic(lm):
    _, _, pm = lm
    rng = np.random.default_rng(5)
    p_long, p_short, p_queued = (rng.integers(2, VOCAB, n).astype(np.int32) for n in (6, 3, 4))

    def run():
        sched = _sched(pm)
        futs = [sched.submit(p_long), sched.submit(p_short, max_new_tokens=2),
                sched.submit(p_queued)]
        events, ticks = [], 0
        while any(not f.done() for f in futs):
            sched.tick()
            ticks += 1
            events.append((sched.active(),) + tuple(f.done() for f in futs))
        # the short request retired and its slot refilled while the long one ran
        assert any(e[2] and not e[1] and e[0] == 2 for e in events)
        return ticks, events, [f.result()["tokens"].tolist() for f in futs], sched

    t1, e1, r1, s1 = run()
    t2, e2, r2, _ = run()
    assert (t1, e1, r1) == (t2, e2, r2)
    assert len(r1[1]) == 2
    snap = s1.metrics.snapshot()
    assert snap["retired"] == snap["admitted"] == 3
    assert 0 < snap["slot_occupancy_mean"] <= 1.0 and snap["block_util_max"] <= 1.0


def test_admission_waits_instead_of_oom(lm):
    _, _, pm = lm
    rng = np.random.default_rng(6)
    # 8 + 4 tokens = 3 blocks of a 4-block pool: two never fit together
    sched = _sched(pm, num_blocks=4, prefix_cache=False, max_new_tokens=4)
    res = _results(sched, [rng.integers(2, VOCAB, 8).astype(np.int32) for _ in range(2)])
    assert [r["gen_len"] for r in res] == [4, 4]
    assert sched.metrics.snapshot()["admission_waits"] >= 1
    assert sched._kv.blocks_in_use == 0


def test_deadline_expiry_and_backlog_shedding(lm):
    _, _, pm = lm
    sched = _sched(pm, num_blocks=4, prefix_cache=False, max_new_tokens=4, max_backlog=2)
    p = np.arange(2, 10, dtype=np.int32)
    first = sched.submit(p)
    sched.tick()  # first admitted; the pool cannot hold another
    doomed = sched.submit(p, deadline_ms=300)
    waiting = sched.submit(p)
    with pytest.raises(OverloadedError):
        sched.submit(p)  # two live requests wait: shed
    time.sleep(0.35)
    late = sched.submit(p)  # the expired one is swept first: room again
    _drive(sched, [first, waiting, late])
    with pytest.raises(TimeoutError, match="deadline"):
        doomed.result()
    snap = sched.metrics.snapshot()
    assert snap["sheds"] == 1 and snap["timeouts"] == 1
    assert get_registry().counters()["serving_sheds"] >= 1


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("depth", [1, 2])
def test_async_is_bitwise_sync(lm, temperature, depth):
    """Six prompts through two slots (refill while the pipeline is full),
    caps and an EOS: the pipelined streams equal the sync loop's."""
    _, _, pm = lm
    rng = np.random.default_rng(11)
    prompts = [rng.integers(2, VOCAB, n).astype(np.int32) for n in (2, 6, 4, 3, 5, 2)]
    kwargs = [{"max_new_tokens": c, "key": (7, i)}
              for i, c in enumerate([None, 2, None, 1, 3, None])]
    out = []
    for async_depth in (0, depth):
        sched = _sched(pm, temperature=temperature, eos_id=1, async_depth=async_depth)
        out.append(_results(sched, prompts, kwargs))
        snap = sched.metrics.snapshot()
        assert snap["tick_host_ms_p50"] >= 0 and snap["decode_dispatch_gap_ms_p50"] >= 0
        sched.close()
    calls = sched.calls()
    assert calls["decode_step_fed"] > 0 and calls["decode_step"] == 0
    for a, b in zip(*out):
        assert a["gen_len"] == b["gen_len"]
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_streams_tokens_and_mirrors_telemetry(lm):
    _, _, pm = lm
    before = get_registry().counters().get("serving_retired", 0)
    sched = _sched(pm, max_new_tokens=4)
    seen = []
    fut = sched.submit(np.asarray([5, 9, 13], np.int32), on_token=seen.append)
    _drive(sched, [fut])
    assert seen == fut.result()["tokens"].tolist()
    assert get_registry().counters()["serving_retired"] == before + 1


def test_background_loop_and_closed(lm):
    _, _, pm = lm
    with _sched(pm, max_new_tokens=3, start=True) as sched:
        futs = [sched.submit(np.asarray([3 + i, 7], np.int32)) for i in range(5)]
        assert [f.result(timeout=60)["gen_len"] for f in futs] == [3] * 5
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(np.asarray([1], np.int32))


@pytest.mark.parametrize("kwargs,item", [
    # ported (P5): each decode mode builds and serves
    pytest.param({"quant": True}, None, id="kwargs0-P5"),
    pytest.param({"lora": "registry"}, None, id="kwargs1-P5"),
    pytest.param({"speculative": "spec"}, None, id="kwargs2-P5"),
    # ported (P6): the fleet's stamps build and serve
    pytest.param({"replica_id": 0}, None, id="kwargs3-P6"),
    pytest.param({"heartbeat_path": "hb"}, None, id="kwargs4-P6"),
    pytest.param({"liveness_timeout_s": 1.0}, None, id="kwargs5-P6"),
])
def test_unported_scheduler_features_raise(lm, kwargs, item, tmp_path):
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            _sched(lm[2], **kwargs)
        return
    from pytorch_distributed_training_tpu_torch.serving import LoraRegistry, SpeculativeSpec

    model, submit = lm[2], {}
    if "lora" in kwargs:
        kwargs = {"lora": LoraRegistry(4, ["tenant-a"])}
        model, submit = kwargs["lora"].graft(model).eval(), {"adapter": "tenant-a"}
    elif "speculative" in kwargs:
        kwargs = {"speculative": SpeculativeSpec(2)}
    elif "heartbeat_path" in kwargs:
        kwargs = {"heartbeat_path": str(tmp_path / "hb.json")}
    sched = _sched(model, **kwargs)
    res = _results(sched, [np.asarray([5, 9, 13], np.int32)], [submit])
    assert res[0]["gen_len"] == 6
    if "replica_id" in kwargs:
        assert get_registry().counters().get("serving_r0_retired", 0) >= 1
    elif "heartbeat_path" in kwargs:
        assert json.loads((tmp_path / "hb.json").read_text())["replica_id"] is None
    elif "liveness_timeout_s" in kwargs:
        assert sched.health()["stalled"] is False


def test_validation_and_unported_verbs(lm):
    _, _, pm = lm
    with pytest.raises(ValueError, match="async_depth"):
        _sched(pm, async_depth=-1)
    with pytest.raises(ValueError, match="worst-case"):
        _sched(pm, num_blocks=2)
    sched = _sched(pm)
    # ported (P6): the transfer verbs resolve at the next tick, nothing
    # cached yet; a replay needs the original key
    futs = [verb(arg) for verb, arg in ((sched.export_kv_prefix, [1, 2]),
                                        (sched.export_kv_refs, [1, 2]),
                                        (sched.import_kv_blocks, []))]
    sched.tick()
    assert [f.result(timeout=5) for f in futs] == [
        [], [], {"accepted": 0, "rejected": 0, "bytes": 0}]
    with pytest.raises(ValueError, match="key"):
        sched.submit(np.asarray([1, 2]), replay_tokens=[3])
    for bad, match in (([VOCAB], r"\[0, 61\)"), ([0.5], "integer")):
        with pytest.raises(ValueError, match=match):
            sched.submit(np.asarray(bad))
    with pytest.raises(ValueError, match="key"):
        sched.submit(np.asarray([1]), key=(-1,))


# --------------------------------------------------------------------- #
# the engine and the CLI with serving.scheduler on


def _cfg(use_scheduler=True, **serving):
    serve = {"dtype": "float32", "max_batch_size": 4, "max_delay_ms": 2, "batch_buckets": [4],
             "seq_buckets": [8, 16], "max_new_tokens": 4, "temperature": 0.0, "seed": 0}
    if use_scheduler:
        serve["scheduler"] = {"enabled": True, "slots": 4, "block_size": 4, "num_blocks": 32,
                              "prefix_cache": True, "async_depth": 0}
    serve.update(serving)
    return {"dataset": {"name": "synthetic_text", "n_classes": VOCAB},
            "model": {"name": "TransformerLM", "embed_dim": 32, "depth": 2, "num_heads": 4,
                      "max_len": 32, "fused_tails": True},
            "serving": serve}


def test_engine_scheduler_matches_batcher_engine():
    """The issue's phase-20 (b) oracle at the test size: the same greedy
    requests through the batcher engine and the scheduler engine."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, VOCAB, int(n)).astype(np.int32) for n in rng.integers(1, 17, 6)]
    out = {}
    for sched in (False, True):
        with InferenceEngine.from_config(_cfg(sched), device="cpu") as engine:
            assert (engine.scheduler is not None) == sched
            warm = engine.warmup()
            assert warm["pairs"] == 2
            assert engine.health()["ready"]
            futs = [engine.submit(p) for p in prompts]
            out[sched] = [f.result(timeout=60)["tokens"].tolist() for f in futs]
            snap = engine.snapshot()
            assert "launches_add_layernorm" in snap
    assert out[True] == out[False]
    assert snap["retired"] == snap["admitted"] == 6


def test_engine_scheduler_options():
    with InferenceEngine.from_config(_cfg(), device="cpu") as engine:
        seen = []
        fut = engine.submit(np.asarray([3, 4, 5]), max_new_tokens=2, on_token=seen.append,
                            key=(1, 2))
        assert fut.result(timeout=60)["gen_len"] == 2 and len(seen) == 2
        assert engine.depth() == 0
        assert engine.drain() >= 0.0
        assert engine.health()["closed"]
    with InferenceEngine.from_config(_cfg(False), device="cpu") as engine:
        with pytest.raises(ValueError, match="scheduler"):
            engine.submit(np.asarray([3]), key=(1,))
    with pytest.raises(ValueError, match="unknown serving.scheduler keys"):
        InferenceEngine.from_config(_cfg(**{"scheduler": {"enabled": True, "slot": 2}}),
                                    device="cpu")
    with pytest.raises(ValueError, match="resilience requires"):
        InferenceEngine.from_config(_cfg(False, resilience={"max_restarts": 1}), device="cpu")


def test_cli_serves_through_the_scheduler(tmp_path, capsys):
    import yaml

    cfg = tmp_path / "serve.yml"
    cfg.write_text(yaml.safe_dump(_cfg()))
    assert main(["--config", str(cfg), "--requests", "6", "--device", "cpu",
                 "--log-dir", str(tmp_path / "log")]) == 0
    snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["serving"]
    assert snap["retired"] == snap["admitted"] == 6 and snap["requests"] == 6
    assert snap["slot_occupancy_mean"] > 0 and "tick_host_ms_p50" in snap


def test_shipped_sched_config_serves_on_cuda_by_default(tmp_path):
    """``configs/serve-lm-1024-sched.yml``: serve-lm-1024.yml's model block,
    the scheduler on; the CLI asks for the card unless told otherwise."""
    from pathlib import Path

    import pytorch_distributed_training_tpu_torch as pkg
    from pytorch_distributed_training_tpu_torch.config_parsing import get_serve_cfg

    root = Path(pkg.__file__).parent / "configs"
    sched = get_serve_cfg(str(root / "serve-lm-1024-sched.yml"))
    batch = get_serve_cfg(str(root / "serve-lm-1024.yml"))
    assert sched["model"] == batch["model"] and sched["dataset"] == batch["dataset"]
    assert sched["serving"]["scheduler"] == {"enabled": True, "slots": 8, "block_size": 16,
                                             "num_blocks": 320, "prefix_cache": True,
                                             "async_depth": 0}
    # one worst-case request: ceil((512 + 32) / 16) = 34 blocks; 8 slots fit
    worst = -(-(sched["serving"]["seq_buckets"][-1] + sched["serving"]["max_new_tokens"]) // 16)
    assert worst == 34 and 8 * worst <= 320
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config", str(root / "serve-lm-1024-sched.yml"), "--log-dir",
              str(tmp_path / "log")])
