"""The port's scheduler decode modes against the JAX scheduler, on the CPU.

On the same weights and prompts (three requests, ragged, through four
slots, an EOS), greedy, token for token:

- int8 decode (``quant``);
- a mixed-adapter batch (tenant-a, base, tenant-b) over the JAX-grafted
  factors scaled x30 (as the JAX oracle does, so the delta flips tokens),
  and the port-only merged-weights (``W + A B``) oracle;
- self-draft speculative decoding, ``k = 3``: acceptance 1.0;
- a distinct depth-1 draft (JAX-initialised, carried across):
  ``spec_proposed`` and ``spec_accepted`` equal the JAX scheduler's.

Port only: prefix isolation per adapter, a hot restart in speculative
mode replayed bitwise against an unfaulted run, the batcher's int8
decode against the scheduler's, the refusals, and the engine's
``serving.quant/lora/speculative`` keys.

One JAX plain-scheduler run is shared by the module (JAX's
``plain_sched_results``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.serving.lora import LoraRegistry as JaxRegistry
from pytorch_distributed_training_tpu.serving.scheduler import (
    ContinuousScheduler as JaxScheduler,
)
from pytorch_distributed_training_tpu.serving.speculative import SpeculativeSpec as JaxSpec
from pytorch_distributed_training_tpu_torch.engine import fault
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.serving import (
    ContinuousScheduler,
    InferenceEngine,
    LoraRegistry,
    SpeculativeSpec,
)
from pytorch_distributed_training_tpu_torch.serving.decode import build_generate_fn

VOCAB = 61
SMALL = dict(max_len=32, embed_dim=32, depth=2, num_heads=4)
# JAX tests/test_serving.py's _paged_sched
KW = dict(slots=4, block_size=4, num_blocks=24, batch_buckets=[4], seq_buckets=[8],
          max_new_tokens=6, temperature=0.0, eos_id=1, start=False)


def _port_lm(params, **kw):
    m = TransformerLM(VOCAB, **{**SMALL, **kw})
    m.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(vocab_size=VOCAB, **SMALL)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    return jm, params, _port_lm(params)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(2, VOCAB, n).astype(np.int32) for n in (2, 6, 4)]


def _results(sched, prompts, kwargs=None, limit=200):
    futs = [sched.submit(p, **k) for p, k in zip(prompts, kwargs or [{}] * len(prompts))]
    n = 0
    while any(not f.done() for f in futs):
        sched.tick()
        n += 1
        assert n < limit, "scheduler failed to drain"
    return [f.result()["tokens"].tolist() for f in futs]


@pytest.fixture(scope="module")
def jax_plain(lm, prompts):
    jm, params, _ = lm
    return _results(JaxScheduler(jm, params, **KW), prompts)


def test_int8_streams_match_jax(lm, prompts, jax_plain):
    jm, params, pm = lm
    want = _results(JaxScheduler(jm, params, quant=True, **KW), prompts)
    sched = ContinuousScheduler(pm, quant=True, **KW)
    assert _results(sched, prompts) == want
    assert sched.calls()["decode_step"] > 0
    # the plain port scheduler repeats JAX's plain streams too
    assert _results(ContinuousScheduler(pm, **KW), prompts) == jax_plain


def test_batcher_int8_decode_matches_the_scheduler(lm, prompts):
    _, _, pm = lm
    sched = ContinuousScheduler(pm, quant=True, **KW)
    want = _results(sched, prompts, [{"key": (7, 1, i)} for i in range(3)])
    tokens = np.zeros((3, 8), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, : p.size] = p
    gen = build_generate_fn(pm, 6, eos_id=1, quant=sched._quant)
    out, gl = gen(tokens, np.asarray([p.size for p in prompts], np.int32), seed=(7, 1))
    assert [out[i, : gl[i]].tolist() for i in range(3)] == want


def test_mixed_adapter_batch_matches_jax_and_merged(lm, prompts, jax_plain):
    jm, params, pm = lm
    jreg = JaxRegistry(4, [{"name": "tenant-a", "seed": 0}, "tenant-b"])
    jlm, lparams = jreg.graft(jm, params)
    # x30, as the JAX oracle: a delta that flips greedy tokens on this model
    lparams = jax.tree_util.tree_map_with_path(
        lambda p, leaf: np.asarray(leaf, np.float32) * (
            30.0 if str(p[-1].key).endswith(("_lora_a", "_lora_b")) else 1.0),
        lparams)
    submit = [{"adapter": "tenant-a"}, {}, {"adapter": "tenant-b"}]
    want = _results(JaxScheduler(jlm, lparams, lora=jreg, **KW), prompts, submit)
    reg = LoraRegistry(4, [{"name": "tenant-a", "seed": 0}, "tenant-b"])
    lora_model = _port_lm(lparams, lora_rank=4, lora_adapters=2)
    sched = ContinuousScheduler(lora_model, lora=reg, **KW)
    got = _results(sched, prompts, submit)
    assert got == want
    assert got[1] == jax_plain[1]  # the base row rides the same batch
    assert got[0] != jax_plain[0] or got[2] != jax_plain[2], "the delta flipped nothing"
    for name, row in (("tenant-a", 0), ("tenant-b", 2)):
        merged = TransformerLM(VOCAB, **SMALL).eval()
        merged.load_state_dict(reg.merged_params(lora_model.state_dict(), name), strict=True)
        assert _results(ContinuousScheduler(merged, **KW), prompts)[row] == got[row], name
    snap = sched.metrics.snapshot()
    assert snap["adapter_tenant-a_requests"] == snap["adapter_tenant-b_requests"] == 1


def test_prefix_cache_isolated_per_adapter(lm):
    """The same prompt twice under one adapter hits the prefix cache; under
    two adapters it misses (JAX ``tests/test_serving.py:1106``)."""
    _, _, pm = lm
    prompt = np.arange(2, 8).astype(np.int32)  # 6 tokens: one cacheable block
    reg = LoraRegistry(4, ["tenant-a", "tenant-b"])
    lora_model = reg.graft(pm).eval()

    def hits(pair):
        sched = ContinuousScheduler(lora_model, lora=reg, **KW)
        for name in pair:
            _results(sched, [prompt], [{"adapter": name}])
        return sched.metrics.snapshot().get("prefix_hit_blocks", 0)

    assert hits(("tenant-a", "tenant-a")) == 1
    assert hits(("tenant-a", "tenant-b")) == 0
    assert hits((None, "tenant-a")) == 0  # the base model is its own namespace


def test_self_draft_matches_jax(lm, prompts, jax_plain):
    jm, params, pm = lm
    js = JaxScheduler(jm, params, speculative=JaxSpec(k=3), **KW)
    want = _results(js, prompts)
    sched = ContinuousScheduler(pm, speculative=SpeculativeSpec(3), **KW)
    got = _results(sched, prompts)
    assert got == want == jax_plain
    snap = sched.metrics.snapshot()
    assert snap["spec_acceptance_rate"] == js.metrics.snapshot()["spec_acceptance_rate"] == 1.0
    calls = sched.calls()
    assert calls["decode_step"] == 0 and calls["verify"] == calls["copy_rows"] >= 1
    # k + 1 draft steps a round, fewer where a request's cap clamps k
    assert calls["verify"] < calls["draft_decode_step"] <= 4 * calls["verify"]
    assert sched._kv.blocks_in_use == js._kv.blocks_in_use  # prefix cache only


def test_distinct_draft_matches_jax_counters(lm, prompts, jax_plain):
    jm, params, pm = lm
    jdraft = JaxLM(vocab_size=VOCAB, **{**SMALL, "depth": 1})
    dparams = jdraft.init(jax.random.PRNGKey(9), jnp.zeros((1, 1), jnp.int32))["params"]
    dparams = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), dparams)
    js = JaxScheduler(jm, params, speculative=JaxSpec(3, jdraft, dparams), **KW)
    want = _results(js, prompts)
    draft = _port_lm(dparams, depth=1)
    sched = ContinuousScheduler(pm, speculative=SpeculativeSpec(3, draft), **KW)
    assert _results(sched, prompts) == want == jax_plain
    got, ref = sched.metrics.snapshot(), js.metrics.snapshot()
    for key in ("spec_rounds", "spec_proposed", "spec_accepted"):
        assert got.get(key, 0) == ref.get(key, 0), key
    assert got["spec_proposed"] > 0


def test_speculative_replay_after_device_loss_is_bitwise(lm, prompts):
    _, _, pm = lm

    def run(spec):
        fault.install(spec)
        try:
            sched = ContinuousScheduler(pm, speculative=SpeculativeSpec(3), **KW)
            return sched, _results(sched, prompts)
        finally:
            fault.install(None)

    clean_sched, clean = run(None)
    sched, got = run("serve_device_lost@2")
    assert got == clean
    assert sched._supervisor.restarts() == 1
    snap = sched.metrics.snapshot()
    assert snap["replayed_tokens"] > 0 and snap.get("replay_parity_mismatch", 0) == 0
    assert sched._dkv.blocks_in_use == 0
    assert sched._kv.blocks_in_use == clean_sched._kv.blocks_in_use


def test_mode_refusals(lm):
    _, _, pm = lm
    with pytest.raises(ValueError, match="temperature 0.0"):
        ContinuousScheduler(pm, speculative=SpeculativeSpec(2), **{**KW, "temperature": 0.8})
    with pytest.raises(ValueError, match="mutually exclusive"):
        ContinuousScheduler(pm, speculative=SpeculativeSpec(2), async_depth=1, **KW)
    with pytest.raises(ValueError, match="no stacked factors"):
        ContinuousScheduler(pm, lora=LoraRegistry(4, ["a"]), **KW)
    sched = ContinuousScheduler(pm, **KW)
    with pytest.raises(ValueError, match="requires serving.lora"):
        sched.submit(np.asarray([3, 4]), adapter="a")


def _cfg(**serving):
    base = dict(max_batch_size=4, batch_buckets=[4], seq_buckets=[8], max_new_tokens=4,
                scheduler={"enabled": True, "slots": 4, "block_size": 4, "num_blocks": 24})
    return {"dataset": {"name": "synthetic_text", "n_classes": VOCAB},
            "model": {"name": "TransformerLM", **SMALL},
            "serving": {**base, **serving}}


@pytest.mark.parametrize("serving,match", [
    ({"quant": {"enabled": True, "bogus": 1}}, "unknown serving.quant"),
    ({"lora": {"enabled": True, "adapters": ["a"], "alpha": 2}}, "unknown serving.lora"),
    ({"speculative": {"enabled": True, "kk": 2}}, "unknown serving.speculative"),
    ({"speculative": {"enabled": True, "min_acceptance": 1.5}}, "min_acceptance"),
    ({"lora": {"enabled": True, "adapters": ["a"]}, "scheduler": {"enabled": False}},
     "scheduler.enabled"),
    ({"speculative": {"enabled": True}, "scheduler": {"enabled": False}}, "scheduler.enabled"),
], ids=["quant-key", "lora-key", "spec-key", "spec-floor", "lora-batcher", "spec-batcher"])
def test_engine_mode_config_refusals(serving, match):
    with pytest.raises(ValueError, match=match):
        InferenceEngine.from_config(_cfg(**serving), device="cpu")


def test_engine_serves_every_mode_at_once():
    """quant, two adapters and a depth-1 draft in one engine, warmed up."""
    cfg = _cfg(quant={"enabled": True},
               lora={"enabled": True, "rank": 4,
                     "adapters": [{"name": "tenant-a", "seed": 0}, {"name": "tenant-b"}]},
               speculative={"enabled": True, "k": 2, "draft": {"depth": 1}, "draft_seed": 3,
                            "min_acceptance": 0.2})
    with InferenceEngine.from_config(cfg, device="cpu") as engine:
        assert engine.serving_modes == {"quant": True, "lora": True, "speculative": True}
        sched = engine.scheduler
        assert sched._spec.draft_model.depth == 1 and sched._spec.draft_model.lora_rank == 0
        assert engine.model.lora_adapters == 2 and len(engine.quant_state) == 4 * 2 + 1
        engine.warmup()
        futs = [engine.submit(np.asarray([5, 9, 13]), adapter=a)
                for a in ("tenant-a", None, "tenant-b")]
        assert [f.result(timeout=60)["gen_len"] for f in futs] == [4, 4, 4]
        snap = engine.snapshot()
        assert snap["spec_rounds"] >= 1 and 0.0 <= snap["spec_acceptance_rate"] <= 1.0
        assert snap["adapter_tenant-b_requests"] == 1
