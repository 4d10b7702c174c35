"""The port's sequence-parallel LM step and runner against the JAX
package's on the CPU.

- four gloo ranks as threads (a process group of their own each, over one
  store), data x sequence = 1 x 4 and 2 x 2, ring and Ulysses attention,
  block remat on (the ring's exchanges run again in the backward): two SGD
  steps of the port's :class:`LMTrainStep` against the JAX SP step
  (``engine/sp_steps.py`` on a (data, sequence) mesh of 4 CPU devices,
  compiled once a case at XLA's lowest optimisation) and against the
  port's single-device full-batch step: losses atol 1e-5, parameters after
  each step atol 1e-5 (``tests/test_transformer_lm.py:45-106``'s limits).
  The JAX legs take the smallest LM that shards (S 32, width 32, 4 heads,
  depth 2), its weights drawn with numpy over ``jax.eval_shape``'s tree;
  the port's attention runs its plain path there (the JAX ring's on the
  CPU);
- the flash path (head dim 64, the ring's local length 128, the flash
  kernels' CPU twins; ``flash_attention_lse`` in the ring): the 4 ranks'
  step against the single-device full-batch step;
- the eval step's reductions over (data, sequence);
- the runner on ``config/TransformerLM-sp.yml``'s ``training:`` block
  (``sequence_parallelism: 4``, bf16, remat) at a tiny depth, width and
  sequence, four gloo ranks as processes: every rank of the sequence group
  draws one sample set, the single rank's set, and reports the same loss,
  near the single rank's run on the same batches;
- the refusals: sequence parallelism beside tensor or pipeline
  parallelism, ZeRO or MoE names P9; off the LM, past the ranks, past the
  sequence or past ``max_len`` raises the JAX package's messages.
"""
import json
import os
import socket
import subprocess
import sys
import threading
from datetime import timedelta
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from pytorch_distributed_training_tpu import optimizers as jopt
from pytorch_distributed_training_tpu.engine import TrainState
from pytorch_distributed_training_tpu.engine.sp_steps import build_lm_train_step as jax_sp_step
from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu.parallel import make_sp_mesh, replicated_sharding
from pytorch_distributed_training_tpu_torch import optimizers as topt
from pytorch_distributed_training_tpu_torch.engine import (
    Runner,
    build_lm_eval_step,
    build_lm_train_step,
)
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.parallel import GroupExchange

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, EMBED, HEADS, DEPTH, BATCH, WORLD = 64, 32, 32, 4, 2, 4, 4
SGD_KW = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)
LAYOUTS = {"1x4": (1, 4), "2x2": (2, 2)}
FAST_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
            "xla_cpu_parallel_codegen_split_count": 1, "xla_cpu_multi_thread_eigen": False}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(shapes, seed: int):
    """Weights for the LM's flax tree: kernels at lecun scale, small
    biases, LayerNorm scales near 1, embeddings at 0.02 (flax's init)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            arr = rng.normal(0.0, 1.0 / np.sqrt(sd.shape[0]), sd.shape)
        elif name == "scale":
            arr = 1.0 + 0.1 * rng.normal(size=sd.shape)
        elif "embedding" in name:
            arr = 0.02 * rng.normal(size=sd.shape)
        else:
            arr = 0.05 * rng.normal(size=sd.shape)
        return arr.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batches(seq, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        toks = rng.integers(0, VOCAB, (BATCH, seq + 1)).astype(np.int32)
        out.append((toks[:, :-1], toks[:, 1:]))  # shifted on the host, whole
    return out


@pytest.fixture(scope="module")
def lm():
    """The small LM's JAX weights and two batches of [4, 32]."""
    shapes = jax.eval_shape(
        JaxLM(vocab_size=VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH,
              num_heads=HEADS).init, jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
    return _draw(shapes["params"], 31), _batches(SEQ, 32)


_JAX_RUNS = {}


def _jax_run(lm, impl, layout):
    """The JAX SP step on a (data, sequence) mesh of 4 devices, compiled
    once: the losses and the parameters after each step."""
    key = (impl, layout)
    if key not in _JAX_RUNS:
        params, batches = lm
        n_data, n_seq = LAYOUTS[layout]
        jm = JaxLM(vocab_size=VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH,
                   num_heads=HEADS, seq_axis="sequence", seq_impl=impl, remat=True)
        jo = jopt.SGD(**SGD_KW)
        mesh = make_sp_mesh(n_seq, devices=jax.devices()[:WORLD])
        assert mesh.shape == {"data": n_data, "sequence": n_seq}
        state = jax.device_put(
            TrainState(params=jax.tree_util.tree_map(jnp.asarray, params), batch_stats={},
                       opt_state=jo.init(params)), replicated_sharding(mesh))
        step = jax_sp_step(jm, jo, lambda s: SGD_KW["lr"], mesh, donate=False)
        inp, tgt = (jnp.asarray(x) for x in batches[0])
        step = step.lower(state, inp, tgt).compile(compiler_options=FAST_XLA)
        losses, after = [], []
        for inp, tgt in batches:
            state, loss = step(state, jnp.asarray(inp), jnp.asarray(tgt))
            losses.append(float(loss))
            after.append(lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                       state.params)))
        _JAX_RUNS[key] = losses, after
    return _JAX_RUNS[key]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).long()


def _model(state, **kw):
    model = TransformerLM(VOCAB, max_len=kw.pop("seq", SEQ), remat=True, **kw)
    model.load_state_dict(state, strict=True)
    return model


def _full_batch(state, batches, **kw):
    """The port's single-device step over the whole batches."""
    model = _model(state, **kw)
    step = build_lm_train_step(model, topt.SGD(**SGD_KW), lambda s: SGD_KW["lr"])
    losses, after = [], []
    for inp, tgt in batches:
        losses.append(float(step(_t(inp), _t(tgt))))
        after.append({k: v.detach().clone() for k, v in model.state_dict().items()})
    return losses, after


def _sp_ranks(state, batches, impl, layout, eval_batch=None, **kw):
    """Four gloo ranks as threads: rank r = data_idx * n_seq + seq_idx holds
    rows ``data_idx`` and columns ``seq_idx`` of every batch.  Per rank:
    the losses, the parameters after each step and the eval step's
    ``(loss, acc1, acc5)`` on ``eval_batch``."""
    n_data, n_seq = LAYOUTS[layout]
    store, outs, errors = dist.HashStore(), {}, []

    def rank(r):
        try:
            d, j = divmod(r, n_seq)
            world = dist.ProcessGroupGloo(dist.PrefixStore("world", store), r, WORLD,
                                          timedelta(seconds=60))
            seq = dist.ProcessGroupGloo(dist.PrefixStore(f"seq{d}", store), j, n_seq,
                                        timedelta(seconds=60))
            model = _model(state, seq_axis=GroupExchange(seq), seq_impl=impl, **kw)
            step = build_lm_train_step(model, topt.SGD(**SGD_KW), lambda s: SGD_KW["lr"],
                                       world_size=WORLD, group=world)

            def mine(x):
                rows, cols = x.shape[0] // n_data, x.shape[1] // n_seq
                return _t(x[d * rows:(d + 1) * rows, j * cols:(j + 1) * cols])

            out = {"loss": [], "after": []}
            for inp, tgt in batches:
                out["loss"].append(float(step(mine(inp), mine(tgt))))
                out["after"].append({k: v.detach().clone()
                                     for k, v in model.state_dict().items()})
            if eval_batch is not None:
                ev = build_lm_eval_step(model.eval(), world_size=WORLD, group=world)
                out["eval"] = [float(x) for x in ev(*(mine(x) for x in eval_batch))]
            outs[r] = out
        except BaseException as err:  # re-raised below, in the test's thread
            errors.append(err)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(WORLD)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and len(outs) == WORLD, errors
    return outs


def _assert_run(outs, losses, after, what):
    for r, got in outs.items():
        np.testing.assert_allclose(got["loss"], losses, atol=1e-5, rtol=0,
                                   err_msg=f"{what} rank {r} loss")
        for i, want in enumerate(after):
            for name, arr in want.items():
                np.testing.assert_allclose(got["after"][i][name].numpy(), np.asarray(arr),
                                           atol=1e-5, rtol=0,
                                           err_msg=f"{what} rank {r} step {i} {name}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_step_matches_jax_and_the_full_batch(lm, impl, layout):
    params, batches = lm
    state = lm_state_dict_from_jax(params)
    kw = dict(embed_dim=EMBED, depth=DEPTH, num_heads=HEADS)
    outs = _sp_ranks(state, batches, impl, layout, **kw)
    _assert_run(outs, *_jax_run(lm, impl, layout), "jax")
    _assert_run(outs, *_full_batch(state, batches, **kw), "full batch")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_flash_sp_step_matches_the_full_batch(impl):
    """Head dim 64 and S 512: the ring's flash inner (``flash_attention_lse``
    on 128-row blocks) and Ulysses' flash over the whole sequence, through
    the kernels' CPU twins, held to the full-batch step's flash."""
    torch.manual_seed(5)
    kw = dict(embed_dim=256, depth=DEPTH, num_heads=HEADS, flash=True, seq=512)
    state = _model(TransformerLM(VOCAB, max_len=512, embed_dim=256, depth=DEPTH,
                                 num_heads=HEADS).state_dict(), **kw).state_dict()
    batches = _batches(512, 33)[:1]
    outs = _sp_ranks(state, batches, impl, "1x4", eval_batch=batches[0], **kw)
    losses, after = _full_batch(state, batches, **kw)
    _assert_run(outs, losses, after, "full batch")
    # the eval step reduced over (data, sequence): the stepped weights' eval
    # on the whole batch, every rank alike
    want = build_lm_eval_step(_model(after[0], **kw).eval())(*(_t(x) for x in batches[0]))
    for got in outs.values():
        np.testing.assert_allclose(got["eval"], [float(x) for x in want], atol=1e-5, rtol=0)


# --------------------------------------------------------------------- #
# the runner


def _sp_cfg(tmp_path, **training):
    with open(os.path.join(REPO, "config", "TransformerLM-sp.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"].update(root=str(tmp_path), n_classes=VOCAB, seq_len=512, n_samples=16)
    cfg["training"].update(train_iters=2, print_interval=1, val_interval=100, batch_size=2,
                           num_workers=0, **training)
    cfg["validation"].update(batch_size=2, num_workers=0)
    cfg["model"].update(embed_dim=256, depth=1, num_heads=4, max_len=512)
    return cfg


_RANK = """
import json, sys
import torch
from pytorch_distributed_training_tpu_torch.engine import Runner
torch.set_num_threads(1)
rank, world, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfg = json.load(open(path + "/cfg.json"))
r = Runner(world, rank, 0, "tcp://127.0.0.1:" + port, False, None, cfg, device="cpu")
r()
json.dump({"loss": [x["loss"] for x in r.train_log], "val": r.val_log,
           "samples": list(r.train_loader.sampler), "global_batch": r.global_batch,
           "columns": [r._columns.start, r._columns.stop]},
          open(path + f"/rank{rank}.json", "w"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_runner_takes_the_sp_config(tmp_path):
    cfg = _sp_cfg(tmp_path)
    assert cfg["training"]["sequence_parallelism"] == 4 and cfg["model"]["remat"]
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f)
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(WORLD), port,
                               str(tmp_path)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env) for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(WORLD)]
    one = Runner(1, 0, 0, "", False, None, _sp_cfg(tmp_path, sequence_parallelism=1),
                 device="cpu")
    one()
    for r, got in enumerate(ranks):
        # one sample set for the sequence group, the single rank's
        assert got["samples"] == list(one.train_loader.sampler)
        assert got["columns"] == [r * 128, (r + 1) * 128]
        assert got["global_batch"] == one.global_batch == 2
        assert got["loss"] == ranks[0]["loss"] and got["val"] == ranks[0]["val"]
    # bf16 compute: the ring's f32 blocks against one whole-sequence flash
    np.testing.assert_allclose(ranks[0]["loss"], [x["loss"] for x in one.train_log],
                               atol=2e-2, rtol=0)
    assert len(ranks[0]["val"]) == 1 and np.isfinite(ranks[0]["val"][0]["loss"])


def _tiny_runner(tmp_path, model=None, **training):
    cfg = _sp_cfg(tmp_path, **training)
    cfg["model"].update(model or {})
    return Runner(1, 0, 0, "", False, None, cfg, device="cpu")


@pytest.mark.parametrize("training,model", [
    ({"tensor_parallelism": 2}, None),
    ({"pipeline_parallelism": 2}, None),
    ({"zero": 1}, None),
    ({}, {"moe_experts": 2, "moe_every": 1}),
], ids=["tp", "pp", "zero", "moe"])
def test_sp_beside_other_families_names_p9(tmp_path, training, model):
    with pytest.raises(NotImplementedError, match="P9"):
        _tiny_runner(tmp_path, model, **training)()


def test_sp_checks_raise_the_jax_messages(tmp_path):
    with pytest.raises(ValueError, match=r"training.sequence_parallelism \(4\) must divide the "
                                         r"number of ranks \(1\)"):
        _tiny_runner(tmp_path)()
    cfg = _sp_cfg(tmp_path)
    cfg["model"] = {"name": "ResNet18"}
    with pytest.raises(ValueError, match="require model.name: TransformerLM"):
        Runner(1, 0, 0, "", False, None, cfg, device="cpu")()
    r = SimpleNamespace(seq_par=3)
    from pytorch_distributed_training_tpu_torch.engine.topology import check_sequence_parallel
    with pytest.raises(ValueError, match=r"dataset.seq_len \(512\) must be divisible by "
                                         r"training.sequence_parallelism \(3\)"):
        check_sequence_parallel(r, 512, 3)
    # the global sequence past max_len (JAX transformer_lm.py:253-264)
    model = TransformerLM(VOCAB, max_len=16, embed_dim=EMBED, depth=1, num_heads=HEADS,
                          seq_axis=SimpleNamespace(size=4, rank=1))
    with pytest.raises(ValueError) as got:
        model(torch.zeros(1, 8, dtype=torch.long))
    assert str(got.value) == "global sequence 32 (= 8 local x 4 shards) exceeds max_len 16"
    with pytest.raises(ValueError, match="names no process group"):
        TransformerLM(VOCAB, max_len=16, embed_dim=EMBED, depth=1, num_heads=HEADS,
                      seq_axis="sequence")(torch.zeros(1, 4, dtype=torch.long))
