"""The port's Mixture-of-Experts LM (``ops/moe.py``, MoE decoder blocks,
``engine/tp_steps.py``) against the JAX package's on the CPU.

Tiny on purpose (d 32, 4 experts, S 16, depth 2, f32): the JAX weights
are drawn with numpy over ``jax.eval_shape``'s trees, the JAX legs run
compiled (eager JAX compiles every op apart) in three programs at XLA's
lowest optimisation (:data:`FAST_XLA`), and the router logits are
scaled up so that no token's k-th and (k+1)-th router logit lie within
:data:`MIN_GAP` (asserted: a mismatch in the chosen experts is a fault,
not a tie broken otherwise).

- ``MoEMLP`` in three cases, (k 2, cf 1.25), (k 1: the raw gate) and (k 2,
  cf 0.5: tokens dropped): the chosen experts and the kept assignments
  equal JAX's, the output and the aux term within 1e-5, and the gradients
  of x and of every leaf within 1e-5 of their largest magnitude;
- the MoE ``TransformerLM``'s logits within 1e-5 (fused tails on the
  port's dense block, its MoE block's ln2 plain), its MoE block's chosen
  experts and kept assignments equal JAX's, its aux terms equal the sown
  ``moe_aux`` entries;
- the GSPMD-path step: JAX ``build_tp_lm_train_step`` on one device with
  ``grad_accumulation`` 2 against the port's, 2 SGD steps: losses within
  rtol 1e-5, parameters within atol 1e-5 (the port's other LM step tests'
  limits), the aux objective equal to the mean of the per-micro sown terms;
- two gloo ranks (a thread each), each holding half of every
  micro-batch: the global aux, the losses and the parameters equal the
  same single-device JAX run;
- the layout checks and refusals with the JAX package's messages,
  ``tensor_parallelism``, ``expert_parallelism`` and ``zero`` accepted and
  the pipeline beside expert (= tensor) parallelism still naming P9;
- flax's initializers: lecun-normal over the stacked leaves with fan-in
  ``E * d``.
"""
import threading
from datetime import timedelta
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax import linen as nn

from pytorch_distributed_training_tpu import optimizers as jopt
from pytorch_distributed_training_tpu.engine import TrainState
from pytorch_distributed_training_tpu.engine import paths as jpaths
from pytorch_distributed_training_tpu.engine import topology as jtopo
from pytorch_distributed_training_tpu.engine.tp_steps import build_tp_lm_train_step as jax_tp_step
from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.ops.moe import MoEMLP as JaxMoE
from pytorch_distributed_training_tpu.parallel import make_mesh
from pytorch_distributed_training_tpu.parallel.tensor import tp_state_shardings
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch.engine import runner as trunner
from pytorch_distributed_training_tpu_torch.engine.topology import (
    check_gspmd_path,
    check_moe,
    parse_model,
)
from pytorch_distributed_training_tpu_torch.engine import build_lm_eval_step
from pytorch_distributed_training_tpu_torch.engine.tp_steps import build_tp_lm_train_step
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.ops.moe import MoEMLP, moe_aux

VOCAB, SEQ, D, H, E, HEADS, DEPTH, BATCH, ACCUM = 64, 16, 32, 64, 4, 4, 2, 4, 2
AUX_WEIGHT = 0.01
SGD_KW = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)
# the least gap between a token's k-th and (k+1)-th router logit (their
# log-probabilities differ by as much); f32 rounding moves a logit ~1e-6
MIN_GAP = 1e-3
LM_KW = dict(max_len=SEQ, embed_dim=D, depth=DEPTH, num_heads=HEADS, mlp_ratio=H / D,
             moe_experts=E, moe_top_k=2, moe_capacity_factor=1.25, moe_aux_weight=AUX_WEIGHT,
             moe_every=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(shapes, seed: int):
    """Weights for a flax tree of ``ShapeDtypeStruct``s: kernels and
    stacked experts at lecun scale over their in-axis (the router x4, so
    its probabilities spread), small random biases, scales near 1,
    embeddings at 0.5."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        where = "/".join(str(getattr(k, "key", k)) for k in path)
        if name in ("kernel", "wi", "wo"):
            scale = (4.0 if "router" in where else 1.0) / np.sqrt(sd.shape[-2])
            arr = rng.normal(0.0, scale, sd.shape)
        elif name == "scale":
            arr = 1.0 + 0.1 * rng.normal(size=sd.shape)
        elif "embedding" in name:
            arr = 0.5 * rng.normal(size=sd.shape)
        else:
            arr = 0.05 * rng.normal(size=sd.shape)
        return arr.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _gap(logits, k: int) -> float:
    top = np.sort(np.asarray(logits), axis=-1)[..., ::-1]
    return float((top[..., k - 1] - top[..., k]).min())


def _jax_routing(logits, k: int, cap: int):
    """Chosen experts and kept assignments by the JAX layer's formulas
    (``ops/moe.py:89-104``) on router logits ``[G, S, E]``."""
    g, s, _ = logits.shape
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    oh = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    slot_major = jnp.swapaxes(oh, 1, 2).reshape(g, k * s, E)
    pos = jnp.cumsum(slot_major, axis=1) * slot_major - 1
    keep = ((pos >= 0) & (pos < cap)).any(-1).reshape(g, k, s).swapaxes(1, 2)
    return idx, keep


# XLA's CPU backend at its lowest optimisation, compiling and running on
# one thread: the JAX legs are tiny, so compiling them is much of this
# file's cost (the step's compile 1.0 s instead of 1.6 s alone), and under
# the suite's load extra threads only contend (with one codegen thread the
# file took 10.2-15.2 s against 16.2-18.2 s, alternated on a loaded host);
# f32 results agree with the default's far inside the limits
FAST_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
            "xla_cpu_parallel_codegen_split_count": 1, "xla_cpu_multi_thread_eigen": False}


def _compiled(fn, *args):
    """``fn`` compiled for ``args``' shapes under :data:`FAST_XLA`."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)


def _close(got, want, what: str, tol: float = 1e-5) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max |port - jax| / max |jax| = {err}"


# --------------------------------------------------------------------- #
# the layer


# the layer's cases: (top k, capacity factor)
LAYER_CASES = ((2, 1.25), (1, 1.25), (2, 0.5))
# the init test's stacked wi leaf: (E, d, h)
INIT_SHAPE = (8, 64, 256)


@pytest.fixture(scope="module")
def jax_layer():
    """The JAX layer's weights (their shapes do not depend on k or the
    capacity factor), its input and output weighting [2, S, d], and in one
    compiled program: for each of :data:`LAYER_CASES` the objective's
    value, output, aux and gradients, the router logits, the chosen experts
    and the kept assignments; and flax's lecun-normal draw of a stacked
    :data:`INIT_SHAPE` leaf."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, SEQ, D)).astype(np.float32)
    w = rng.normal(size=(2, SEQ, D)).astype(np.float32)
    shapes = jax.eval_shape(JaxMoE(num_experts=E, top_k=2, capacity_factor=1.0, hidden=H,
                                   out=D).init, jax.random.PRNGKey(0), x)["params"]
    params = _draw(shapes, 5)

    def case(p, xin, k, cf):
        jm = JaxMoE(num_experts=E, top_k=k, capacity_factor=cf, hidden=H, out=D,
                    aux_weight=AUX_WEIGHT)

        def objective(pp, xx):
            y, inter = jm.apply({"params": pp}, xx, mutable="intermediates")
            aux = inter["intermediates"]["moe_aux"][0]
            return jnp.sum(y * w) + aux, (y, aux)

        grads = jax.value_and_grad(objective, argnums=(0, 1), has_aux=True)(p, xin)
        logits = xin @ p["router"]["kernel"] + p["router"]["bias"]
        cap = max(1, int(np.ceil(cf * k * SEQ / E)))
        return grads, logits, _jax_routing(logits, k, cap)

    def jax_legs(p, xin):
        init = nn.initializers.lecun_normal()(jax.random.PRNGKey(1), INIT_SHAPE)
        return [case(p, xin, k, cf) for k, cf in LAYER_CASES], init

    legs, init = _compiled(jax_legs, params, x)(params, x)
    return params, x, w, legs, np.asarray(init)


@pytest.mark.parametrize("case", range(len(LAYER_CASES)),
                         ids=["k2-cf1.25", "k1-raw-gate", "k2-cf0.5-drops"])
def test_moe_mlp_matches_jax(jax_layer, case):
    params, x, w, legs, _ = jax_layer
    (k, cf), g = LAYER_CASES[case], x.shape[0]
    cap = max(1, int(np.ceil(cf * k * SEQ / E)))
    ((_, (jy, jaux)), (jgp, jgx)), jlogits, (jidx, jkeep) = legs[case]

    port = MoEMLP(D, E, k, cf, H, D)
    with torch.no_grad():
        port.router.weight.copy_(torch.from_numpy(params["router"]["kernel"].T.copy()))
        port.router.bias.copy_(torch.from_numpy(params["router"]["bias"]))
        for name in ("wi", "bi", "wo", "bo"):
            getattr(port, name).copy_(torch.from_numpy(params[name]))
    tx = torch.from_numpy(x).requires_grad_()
    y, stats = port(tx)
    aux = moe_aux(stats, g * SEQ, AUX_WEIGHT, E)
    ((y * torch.from_numpy(w)).sum() + aux).backward()

    # the routing: no near-tie, then the same experts and the same drops
    assert _gap(jlogits, k) > MIN_GAP
    assert port.capacity(SEQ) == cap
    jidx, jkeep = np.asarray(jidx), np.asarray(jkeep)
    with torch.no_grad():
        _, _, expert, _, keep = port.route(tx)
    np.testing.assert_array_equal(expert.numpy(), jidx)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    if cf < 1:
        assert not jkeep.all()  # the case drops tokens

    _close(y.detach(), jy, "output")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5, atol=1e-8)
    _close(tx.grad, jgx, "grad x")
    _close(port.router.weight.grad.T, jgp["router"]["kernel"], "grad router/kernel")
    _close(port.router.bias.grad, jgp["router"]["bias"], "grad router/bias")
    for name in ("wi", "bi", "wo", "bo"):
        _close(getattr(port, name).grad, jgp[name], f"grad {name}")


def test_moe_init_is_flax(jax_layer):
    """lecun-normal over the stacked leaves: fan-in E x d for wi (E x h for
    wo), truncated at 2 sigma; the router a Dense; zero biases."""
    e, d, h = INIT_SHAPE
    port = MoEMLP(d, e, 2, 1.25, h, d)
    port.reset_parameters(torch.Generator().manual_seed(0))
    want = jax_layer[4]  # the JAX layer's initializer on a wi leaf
    for name, arrays, fan_in in (("wi", (port.wi, want), e * d), ("wo", (port.wo,), e * h)):
        for arr in arrays:
            arr = np.asarray(arr.detach() if isinstance(arr, torch.Tensor) else arr)
            assert arr.shape == getattr(port, name).shape
            # std 1/sqrt(fan_in) (0.0442 for wi); 131k draws: within 2%
            assert abs(arr.std() * np.sqrt(fan_in) - 1.0) < 0.02, name
            assert abs(arr.std() * np.sqrt(arr.shape[1]) - 1.0) > 0.5, name  # not [in, out]'s
            assert np.abs(arr).max() <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-7
    assert abs(port.router.weight.std().item() * np.sqrt(d) - 1.0) < 0.1
    assert not port.bi.any() and not port.bo.any() and not port.router.bias.any()


# --------------------------------------------------------------------- #
# the model and the GSPMD-path step


def _batch(seed: int):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _jax_forward(jm):
    """The JAX model's forward: logits, and for each MoE block its sown
    ``moe_aux`` entry, its router logits, and its chosen experts and kept
    assignments (:func:`_jax_routing`)."""
    cap = max(1, int(np.ceil(LM_KW["moe_capacity_factor"] * 2 * SEQ / E)))

    def forward(p, tokens):
        logits, inter = jm.apply({"params": p}, tokens, mutable=["intermediates"],
                                 capture_intermediates=lambda mdl, _: mdl.name == "router")
        blocks = inter["intermediates"]
        moe = [blocks[b]["moe"] for b in sorted(blocks) if "moe" in blocks[b]]
        router = [m["router"]["__call__"][0] for m in moe]
        return (logits, [m["moe_aux"][0] for m in moe], router,
                [_jax_routing(r, 2, cap) for r in router])

    return forward


@pytest.fixture(scope="module")
def jax_run():
    """The JAX MoE LM's weights, 2 batches, and 2 SGD steps of the JAX
    GSPMD step with grad_accumulation 2 on one device: losses, the
    per-micro sown aux terms of each step and the parameters after."""
    jm = JaxLM(vocab_size=VOCAB, **LM_KW)
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                  jnp.zeros((1, SEQ), jnp.int32))["params"], 3)
    batches = [_batch(21), _batch(22)]
    micro = BATCH // ACCUM
    forward = _compiled(_jax_forward(jm), params, batches[0][0][:micro])
    opt = jopt.SGD(**SGD_KW)
    mesh = make_mesh(devices=jax.devices()[:1])
    # SGD's initial state is zeros: drawn over its shapes, as the weights are
    zeros = jax.tree_util.tree_map(lambda sd: np.zeros(sd.shape, sd.dtype),
                                   jax.eval_shape(opt.init, params))
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params), batch_stats={},
                       opt_state=zeros)
    state = jax.device_put(state, tp_state_shardings(state, mesh, zero=0))
    inp, tgt = (jnp.asarray(a) for a in batches[0])
    step = jax_tp_step(jm, opt, lambda _: jnp.float32(SGD_KW["lr"]), mesh, donate=False,
                       grad_accum=ACCUM)(state).lower(state, inp, tgt).compile(
        compiler_options=FAST_XLA)
    losses, auxes, gaps = [], [], []
    for inp, tgt in batches:
        host = jax.tree_util.tree_map(np.asarray, state.params)
        per_micro = []
        for j in range(ACCUM):
            _, aux, router, _ = forward(host, inp[j * micro:(j + 1) * micro])
            per_micro.append(float(sum(aux)))
            gaps += [_gap(r, 2) for r in router]
        auxes.append(per_micro)
        state, loss = step(state, jnp.asarray(inp), jnp.asarray(tgt))
        losses.append(float(loss))
    after = jax.tree_util.tree_map(np.asarray, state.params)
    return dict(forward=forward, params=params, batches=batches, losses=losses, auxes=auxes,
                after=after, min_gap=min(gaps))


def _port_lm(params):
    model = TransformerLM(VOCAB, fused_tails=True, **LM_KW)
    model.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return model


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_moe_lm_logits_match_jax(jax_run):
    params = jax_run["params"]
    inp = jax_run["batches"][0][0][:BATCH // ACCUM]  # a micro-batch: forward's compiled shape
    jlogits, jaux, jrouter, jrouting = jax_run["forward"](params, inp)
    model = _port_lm(params)
    assert [b.is_moe for b in model.blocks] == [False, True]
    assert model.block0.fused_tails and not model.block1.fused_tails
    routed, moe_in = [], []
    hooks = [model.block1.moe.router.register_forward_hook(lambda m, a, out: routed.append(out)),
             model.block1.moe.register_forward_pre_hook(lambda m, a: moe_in.append(a[0]))]
    with torch.no_grad():
        logits, stats = model(_t(inp), moe_stats=True)
        _, _, expert, _, keep = model.block1.moe.route(moe_in[0])
    for h in hooks:
        h.remove()
    assert _gap(jrouter[0], 2) > MIN_GAP
    _close(routed[0], jrouter[0], "router logits")
    # the same chosen experts, in order, and the same dropped assignments
    jidx, jkeep = jrouting[0]
    np.testing.assert_array_equal(expert.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    _close(logits, jlogits, "logits")
    np.testing.assert_allclose([float(moe_aux(s, inp.size, AUX_WEIGHT, E)) for s in stats],
                               [float(a) for a in jaux], rtol=1e-5)
    with torch.no_grad():  # the plain call gives the same logits, without the statistics
        torch.testing.assert_close(model(_t(inp)), logits, rtol=0, atol=0)


def test_tp_step_with_accumulation_matches_jax(jax_run):
    assert jax_run["min_gap"] > MIN_GAP
    model = _port_lm(jax_run["params"])
    step = build_tp_lm_train_step(model, topt.SGD(**SGD_KW), lambda s: SGD_KW["lr"],
                                  grad_accum=ACCUM)
    for (inp, tgt), jloss, jaux in zip(jax_run["batches"], jax_run["losses"], jax_run["auxes"]):
        loss = step(_t(inp), _t(tgt))
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
        np.testing.assert_allclose(float(step.aux), np.mean(jaux), rtol=1e-5)
    assert step.opt_state.step == 2
    want = lm_state_dict_from_jax(jax_run["after"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)
    # validation is pure CE: no aux term in the eval loss
    inp, tgt = jax_run["batches"][0]
    loss, acc1, acc5 = build_lm_eval_step(model)(_t(inp), _t(tgt))
    logits = model(_t(inp)).detach()
    want_ce = torch.nn.functional.cross_entropy(logits.reshape(-1, VOCAB), _t(tgt).reshape(-1))
    np.testing.assert_allclose(float(loss), float(want_ce), rtol=1e-5)


# --------------------------------------------------------------------- #
# two gloo ranks


def _rank(rank: int, world: int, store, params, batches) -> dict:
    """One gloo rank of the port's GSPMD-path step, holding row ``rank`` of
    every micro-batch of ``world`` rows: its losses, aux objectives and
    parameters after the batches."""
    group = dist.ProcessGroupGloo(store, rank, world, timedelta(seconds=60))
    model = _port_lm(params)
    step = build_tp_lm_train_step(model, topt.SGD(**SGD_KW), lambda s: SGD_KW["lr"],
                                  world_size=world, group=group, grad_accum=ACCUM)
    out = {"loss": [], "aux": []}
    for inp, tgt in batches:
        out["loss"].append(float(step(_t(inp)[rank::world], _t(tgt)[rank::world])))
        out["aux"].append(float(step.aux))
    out["state"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return out


def test_two_gloo_ranks_take_the_global_aux(jax_run):
    """Two gloo ranks, one thread each (a process group of their own over
    one store), each holding half of every micro-batch."""
    store, outs, errors = dist.HashStore(), {}, []

    def run(rank):
        try:
            outs[rank] = _rank(rank, 2, store, jax_run["params"], jax_run["batches"])
        except BaseException as err:  # re-raised below, in the test's thread
            errors.append(err)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(outs) == 2, errors
    want = lm_state_dict_from_jax(jax_run["after"])
    for r, got in outs.items():
        # the aux of a micro-batch's statistics over both ranks: JAX's over the whole
        np.testing.assert_allclose(got["aux"], [np.mean(a) for a in jax_run["auxes"]],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["loss"], jax_run["losses"], rtol=1e-5)
        for name, arr in want.items():
            np.testing.assert_allclose(got["state"][name].numpy(), arr.numpy(), atol=1e-5,
                                       err_msg=f"rank {r} {name}")


# --------------------------------------------------------------------- #
# the layout checks and refusals


def _cfg(model=None, training=None):
    m = dict(name="TransformerLM", embed_dim=D, depth=DEPTH, num_heads=HEADS, max_len=SEQ,
             moe_experts=E)
    m.update(model or {})
    return {"model": m, "training": dict(training or {}),
            "dataset": {"name": "synthetic_text", "n_classes": VOCAB, "seq_len": SEQ}}


def _jax_topology_error(cfg) -> str:
    with pytest.raises(ValueError) as err:
        jtopo.parse_topology(SimpleNamespace(distributed=False), cfg,
                             {"sync_bn": False, **cfg["training"]},
                             [(np.zeros(SEQ, np.int32), None)])
    return str(err.value)


@pytest.mark.parametrize("model,training", [
    ({}, {"pipeline_parallelism": 2}),
    ({"moe_experts": 3}, {"tensor_parallelism": 2}),
    ({"moe_every": 0}, {}),
    ({"moe_every": 3}, {}),
], ids=["pipeline", "uneven-experts", "every-0", "every-past-depth"])
def test_moe_layout_checks_raise_the_jax_messages(model, training):
    cfg = _cfg(model, training)
    want = _jax_topology_error(cfg)
    with pytest.raises(ValueError) as err:
        check_moe(cfg)
    assert str(err.value) == want


def test_moe_refusals():
    # the GSPMD path's refusals, with the JAX paths' messages
    for runner, jax_reject in (
            (SimpleNamespace(anomaly_enabled=True), jpaths._reject_anomaly),
            (SimpleNamespace(comm=SimpleNamespace(overlap=True)), jpaths._reject_comm)):
        with pytest.raises(ValueError) as want:
            jax_reject(runner, "gspmd")
        train_cfg = {"comm": {"overlap": True}} if hasattr(runner, "comm") else {}
        with pytest.raises(ValueError) as got:
            check_gspmd_path(runner, train_cfg)
        assert str(got.value) == str(want.value)
    assert check_moe(_cfg()) and not check_moe(_cfg({"moe_experts": 0}))
    # the runner: comm.overlap reaches the GSPMD refusal, not P9, for a MoE model
    trunner._reject_unported({"comm": {"overlap": True}}, gspmd=True)
    # tensor (= expert) parallelism and ZeRO are ported on the GSPMD path, and
    # training.expert_parallelism is no JAX key (left unread, as the JAX
    # runner leaves it); the pipeline beside expert (= tensor) parallelism
    # still names P9 on the runner (a MoE LM under the pipeline is JAX's
    # ValueError, test_moe_layout_checks_raise_the_jax_messages)
    trunner._reject_unported({"tensor_parallelism": 4}, gspmd=True)
    trunner._reject_unported({"expert_parallelism": 4}, gspmd=True)
    trunner._reject_unported({"zero": 1}, gspmd=True)
    with pytest.raises(NotImplementedError, match="P9"):
        trunner._reject_unported({"pipeline_parallelism": 2, "tensor_parallelism": 4},
                                 gspmd=True)
    # model.pretrained still refuses a MoE model, as JAX does
    cfg = _cfg({"pretrained": "/nonexistent.pt"})
    want = _jax_topology_error(cfg)
    with pytest.raises(ValueError) as err:
        parse_model(SimpleNamespace(), cfg)
    assert str(err.value) == want
    # the model's own check (JAX :212-213)
    with pytest.raises(ValueError, match="moe_every must be >= 1, got 0"):
        TransformerLM(VOCAB, **{**LM_KW, "moe_every": 0})
