"""The remat policies ``dots`` and ``dots_saveable`` of the port's
TransformerLM, on the CPU.

- gradients: under each policy, with flash on (the kernels' plain twin)
  and off (the einsum), the loss and every gradient equal to the same model
  without remat (the recompute repeats the same operations on the same
  inputs; the token embedding's scatter-add within one f32 rounding), and
  within atol 2e-5 / rtol 1e-4 of the JAX model with the same policy on
  the same weights (``tests/test_torch_longctx_model.py``'s limits);
- what each policy saves, read from the ops the backward runs: ``F.linear``
  on the block's 3-D stream reaches ``aten.addmm`` (``SAVED_OPS`` names it,
  and ``aten.mm`` for a linear without a bias); under ``nothing`` the
  backward runs 3 of each block's 4 forward ``addmm`` again (the
  recompute stops before fc2, whose output no gradient needs), under
  ``dots`` and ``dots_saveable`` none; ``dots_saveable`` also keeps the einsum
  attention's 2 batched products a block (``aten.bmm``), which ``dots``
  runs again; with flash on every policy runs each block's flash forward
  again, and the two policies differ only in the plain twin's ``aten.bmm``
  (on the card, where the kernels are no aten op, they run the same ops:
  ``chip_smoke.py`` phase 18 counts the launches).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from pytorch_distributed_training_tpu.engine.sp_steps import lm_loss_local as jax_lm_loss
from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu_torch.engine import lm_loss_local
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.models.transformer_lm import SAVED_OPS
from pytorch_distributed_training_tpu_torch.ops import flash_attention as tfa

VOCAB, SEQ, EMBED, DEPTH, HEADS, BATCH = 64, 128, 128, 2, 2, 2
POLICIES = ("dots", "dots_saveable")
aten = torch.ops.aten


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    params = JaxLM(vocab_size=VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH,
                   num_heads=HEADS).init(jax.random.PRNGKey(7),
                                         jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        arr = np.asarray(leaf, np.float32)
        if path[-1].key in ("bias", "scale"):
            arr = arr + (0.1 * rng.normal(size=arr.shape)).astype(np.float32)
        return arr

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def batch():
    toks = np.random.default_rng(8).integers(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _port_lm(params, policy, flash):
    model = TransformerLM(VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
                          flash=flash, remat=policy is not None,
                          remat_policy=policy or "nothing")
    model.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return model


def _grads(model, tokens, labels):
    loss = lm_loss_local(model(torch.from_numpy(tokens).long()),
                         torch.from_numpy(labels).long(), labels.size)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


_JAX = {}


def _jax_grads(params, batch, policy):
    """The JAX model's loss and gradients under ``policy`` (once a policy:
    the JAX side does not depend on the port's flash flag)."""
    if policy not in _JAX:
        tokens, labels = batch
        jm = JaxLM(vocab_size=VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH,
                   num_heads=HEADS, remat=True, remat_policy=policy)
        jl, jgrads = jax.value_and_grad(lambda p: jax_lm_loss(
            jm.apply({"params": p}, jnp.asarray(tokens)), jnp.asarray(labels),
            labels.size))(params)
        _JAX[policy] = (float(jl),
                        lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads)))
    return _JAX[policy]


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "einsum"])
@pytest.mark.parametrize("policy", POLICIES)
def test_gradients_equal_no_remat_and_match_jax(params, batch, policy, flash):
    tokens, labels = batch
    loss, got = _grads(_port_lm(params, policy, flash), tokens, labels)
    loss0, plain = _grads(_port_lm(params, None, flash), tokens, labels)
    assert torch.equal(loss, loss0)
    for name in got:
        tol = dict(atol=1e-7, rtol=1e-6) if name == "tok_embedding" else dict(atol=0, rtol=0)
        torch.testing.assert_close(got[name], plain[name], msg=name, **tol)
    jl, want = _jax_grads(params, batch, policy)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


class _Ops(TorchDispatchMode):
    """Counts the aten ops that run under it."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_linear_on_the_stream_reaches_the_policy_ops():
    """``F.linear`` on a 3-D bf16 (and f32) stream, with and without a
    bias, lowers to the ops ``dots`` names."""
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(2, 8, 16, dtype=dtype)
        w, b = torch.randn(32, 16, dtype=dtype), torch.randn(32, dtype=dtype)
        for bias, op in ((b, aten.addmm.default), (None, aten.mm.default)):
            with _Ops() as seen:
                F.linear(x, w, bias)
            assert op in seen.counts and op in SAVED_OPS["dots"]
            assert not set(seen.counts) & {aten.bmm.default, aten.baddbmm.default}
    assert SAVED_OPS["nothing"] is None
    assert set(SAVED_OPS["dots"]) < set(SAVED_OPS["dots_saveable"])


def _backward_ops(model, tokens, labels, monkeypatch):
    loss = lm_loss_local(model(torch.from_numpy(tokens).long()),
                         torch.from_numpy(labels).long(), labels.size)
    calls = []
    real = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain", lambda *a: (calls.append(1), real(*a))[1])
    with _Ops() as seen:
        loss.backward()
    monkeypatch.setattr(tfa, "flash_fwd_plain", real)
    return seen.counts, len(calls)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "einsum"])
def test_what_each_policy_saves(params, batch, flash, monkeypatch):
    tokens, labels = batch
    ops, fwd = {}, {}
    for policy in (None, "nothing", "dots", "dots_saveable"):
        ops[policy], fwd[policy] = _backward_ops(_port_lm(params, policy, flash), tokens, labels,
                                                 monkeypatch)
    addmm, bmm = aten.addmm.default, aten.bmm.default
    # 4 Dense layers a block (qkv, out, fc1, fc2), each an addmm forward;
    # the non-reentrant recompute stops once it has what the backward
    # needs, and fc2's output is needed by nothing: 3 of them run again
    assert ops["nothing"].get(addmm, 0) - ops[None].get(addmm, 0) == 3 * DEPTH
    for policy in POLICIES:
        assert ops[policy].get(addmm, 0) == ops[None].get(addmm, 0)
    if flash:
        # every policy runs each block's flash forward again; on the CPU the
        # kernels' plain twin computes with aten.bmm, which dots_saveable
        # keeps: the two policies differ there and nowhere else (on the
        # card the kernels are no aten op, chip_smoke.py phase 18)
        assert fwd == {None: 0, "nothing": DEPTH, "dots": DEPTH, "dots_saveable": DEPTH}
        assert ops["dots"][bmm] > ops["dots_saveable"][bmm]
        assert ({k: n for k, n in ops["dots"].items() if k != bmm}
                == {k: n for k, n in ops["dots_saveable"].items() if k != bmm})
    else:
        # the einsum's scores and output: 2 batched products a block
        assert ops["dots"].get(bmm, 0) - ops["dots_saveable"].get(bmm, 0) == 2 * DEPTH
        assert ops["dots"].get(bmm, 0) == ops["nothing"].get(bmm, 0)
