"""Block remat in the port's TransformerLM against the JAX model's.

``TransformerLM(remat=True)`` (policy ``nothing``) against the JAX model
with ``remat=True`` (flax ``nn.remat`` of every block) on the same weights,
carried over by ``lm_state_dict_from_jax``: the loss and every parameter's
gradient, f32, at tiny widths with head dim 64 and sequence 128 so that the
port's flash path takes the shape.  The JAX side runs on the CPU, where its
attention is the einsum; the port's is the flash kernels' plain twin.
Tolerances as ``tests/test_torch_train_lm.py``: loss rtol 1e-5, gradients
atol 2e-5 / rtol 1e-4 (summation order only).  Remat on against remat off
in the port: equal, since the recompute repeats the same operations on the
same inputs (the token embedding's gradient up to the CPU's run-to-run
order of its scatter-add).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.engine.sp_steps import lm_loss_local as jax_lm_loss
from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu_torch.engine import build_lm_eval_step, lm_loss_local
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.ops import flash_attention as tfa

VOCAB, SEQ, EMBED, DEPTH, HEADS, BATCH = 64, 128, 128, 2, 2, 2


@pytest.fixture(scope="module")
def params():
    params = JaxLM(vocab_size=VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH,
                   num_heads=HEADS).init(jax.random.PRNGKey(5),
                                         jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.default_rng(5)

    def perturb(path, leaf):
        arr = np.asarray(leaf, np.float32)
        if path[-1].key in ("bias", "scale"):
            arr = arr + (0.1 * rng.normal(size=arr.shape)).astype(np.float32)
        return arr

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def batch():
    toks = np.random.default_rng(6).integers(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _port_lm(params, remat):
    model = TransformerLM(VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
                          flash=True, remat=remat)
    model.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return model


def _port_grads(model, tokens, labels):
    loss = lm_loss_local(model(torch.from_numpy(tokens).long()),
                         torch.from_numpy(labels).long(), labels.size)
    loss.backward()
    return loss.detach(), {name: p.grad for name, p in model.named_parameters()}


def test_remat_model_matches_jax_remat(params, batch):
    tokens, labels = batch
    jm = JaxLM(vocab_size=VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
               remat=True)
    jl, jgrads = jax.value_and_grad(lambda p: jax_lm_loss(
        jm.apply({"params": p}, jnp.asarray(tokens)), jnp.asarray(labels), labels.size))(params)
    loss, got = _port_grads(_port_lm(params, remat=True), tokens, labels)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_remat_on_equals_remat_off(params, batch):
    tokens, labels = batch
    loss_on, on = _port_grads(_port_lm(params, remat=True), tokens, labels)
    loss_off, off = _port_grads(_port_lm(params, remat=False), tokens, labels)
    assert torch.equal(loss_on, loss_off)
    for name in on:
        # the token embedding's gradient is a scatter-add over the batch's
        # tokens, which the CPU sums in an order that changes from call to
        # call, remat or not: one f32 rounding apart
        tol = dict(atol=1e-7, rtol=1e-6) if name == "tok_embedding" else dict(atol=0, rtol=0)
        torch.testing.assert_close(on[name], off[name], msg=name, **tol)


def test_remat_reruns_every_block_forward_flash_included(params, batch, monkeypatch):
    """A training step runs each block's forward twice (the recompute in
    the backward), evaluation and serving once: on the card that is 2 x
    depth flash forwards a step and depth an eval batch."""
    calls = []
    real = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain", lambda *a: (calls.append(1), real(*a))[1])
    tokens, labels = batch
    _port_grads(_port_lm(params, remat=True), tokens, labels)
    assert len(calls) == 2 * DEPTH
    calls.clear()
    _port_grads(_port_lm(params, remat=False), tokens, labels)
    assert len(calls) == DEPTH
    calls.clear()
    model = _port_lm(params, remat=True)
    build_lm_eval_step(model)(torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
    assert len(calls) == DEPTH


def test_remat_leaves_decode_unchanged(params):
    model, plain = _port_lm(params, remat=True).eval(), _port_lm(params, remat=False).eval()
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, VOCAB, (2, 9)))
    with torch.no_grad():
        a, cache = model(toks, model.new_cache(2))
        b, _ = plain(toks, plain.new_cache(2))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert cache.keys[0].abs().sum() > 0  # the prefill wrote the cache


@pytest.mark.parametrize(
    "remat,policy,exc,match",
    [(True, "nothing", None, None), (False, "dots", None, None),
     # ported (P2b): the policies that save dots build
     pytest.param(True, "dots", None, None, id="True-dots-NotImplementedError-P2b"),
     pytest.param(True, "dots_saveable", None, None,
                  id="True-dots_saveable-NotImplementedError-P2b"),
     (False, "everything", ValueError, "remat_policy must be one of"),
     (True, "everything", ValueError, "remat_policy must be one of")],
)
def test_remat_policy_names(remat, policy, exc, match):
    """``resolve_remat_policy``'s names: unknown ones raise even with remat
    off; ``nothing``, ``dots`` and ``dots_saveable`` build
    (``tests/test_torch_remat_dots.py`` runs them)."""
    def build():
        return TransformerLM(VOCAB, max_len=SEQ, embed_dim=EMBED, depth=1, num_heads=HEADS,
                             remat=remat, remat_policy=policy)

    if exc is None:
        model = build()
        assert model.remat is remat and model.remat_policy == policy
    else:
        with pytest.raises(exc, match=match):
            build()
