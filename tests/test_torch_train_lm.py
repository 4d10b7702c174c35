"""The port's TransformerLM training forward and backward against the JAX
package's: the tiny model's loss and every parameter's gradient.

Same weights on both sides: the JAX model's init with its biases and
LayerNorm parameters perturbed (so a mis-mapped one shows), carried over by
``lm_state_dict_from_jax``; the JAX gradients go through the same
converter and are compared key by key.  The JAX side runs on the CPU, where
its attention is the einsum (``-inf`` mask) and its CE the XLA formula; the
port runs with ``flash=True``, so its attention is the flash kernels'
plain twin (``-1e30`` mask) and its CE the fused pair's twin -- the
functions the card's kernels are held against.  The head dim is 64 and the
sequence 128 so that the flash path takes the shape.

Tolerances (``tests/test_torch_port_lm.py``): f32 logits atol 1e-4, loss
rtol 1e-5, gradients atol 2e-5 / rtol 1e-4 -- summation order only.  bf16:
the loss within rtol 1e-2, because the two sides round at different places
(the JAX einsum keeps p in f32 before PV, the flash path rounds p to bf16,
as the JAX flash kernel does) and bf16 keeps 8 bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.engine.sp_steps import lm_loss_local as jax_lm_loss
from pytorch_distributed_training_tpu.models.transformer_lm import TransformerLM as JaxLM
from pytorch_distributed_training_tpu_torch.engine import lm_loss_local
from pytorch_distributed_training_tpu_torch.models import TransformerLM, lm_state_dict_from_jax
from pytorch_distributed_training_tpu_torch.ops import attention as tattn

VOCAB, SEQ, EMBED, DEPTH, HEADS, BATCH = 64, 128, 128, 2, 2, 2


def _jax_lm(fused_tails, dtype=jnp.float32):
    return JaxLM(vocab_size=VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH,
                 num_heads=HEADS, fused_tails=fused_tails, dtype=dtype)


@pytest.fixture(scope="module")
def params():
    params = _jax_lm(False).init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        arr = np.asarray(leaf, np.float32)
        if path[-1].key in ("bias", "scale"):
            arr = arr + (0.1 * rng.normal(size=arr.shape)).astype(np.float32)
        return arr

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    toks = rng.integers(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _port_lm(params, fused_tails, dtype=torch.float32):
    model = TransformerLM(VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
                          fused_tails=fused_tails, flash=True, dtype=dtype)
    model.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return model


@pytest.mark.parametrize("fused_tails", [True, False])
def test_loss_and_every_gradient_match_jax(params, batch, fused_tails):
    tokens, labels = batch
    jm = _jax_lm(fused_tails)

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(tokens))
        return jax_lm_loss(logits, jnp.asarray(labels), labels.size), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = _port_lm(params, fused_tails)
    logits = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    loss = lm_loss_local(logits, torch.from_numpy(labels).long(), labels.size)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_bf16_loss_matches_jax(params, batch):
    tokens, labels = batch
    jm = _jax_lm(True, jnp.bfloat16)
    jl = jax_lm_loss(jm.apply({"params": params}, jnp.asarray(tokens)), jnp.asarray(labels),
                     labels.size)
    model = _port_lm(params, True, torch.bfloat16)
    loss = lm_loss_local(model(torch.from_numpy(tokens).long()),
                         torch.from_numpy(labels).long(), labels.size)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-2)
    # f32 master parameters, f32 gradients, all finite
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name


def test_flash_flag_picks_the_kernel_where_the_shape_allows(monkeypatch):
    calls = []
    real = tattn.flash_attention

    def spy(q, k, v, causal=False, sm_scale=None):
        calls.append(q.shape)
        return real(q, k, v, causal=causal, sm_scale=sm_scale)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    mha = tattn.MultiHeadAttention(128, 2, causal=True, flash=True)
    mha(torch.randn(1, 128, 128))
    assert calls == [(1, 128, 2, 64)]
    mha(torch.randn(1, 96, 128))  # S % 128 != 0: the einsum, as JAX's gate
    assert len(calls) == 1
    tattn.MultiHeadAttention(128, 2, causal=True)(torch.randn(1, 128, 128))  # serving
    assert len(calls) == 1
    # the two paths agree
    torch.manual_seed(0)
    x = torch.randn(2, 128, 128)
    flash = tattn.MultiHeadAttention(128, 2, causal=True, flash=True)
    plain = tattn.MultiHeadAttention(128, 2, causal=True)
    plain.load_state_dict(flash.state_dict())
    torch.testing.assert_close(flash(x), plain(x), atol=1e-5, rtol=1e-5)


def test_dot_product_attention_impls_agree():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 128, 2, 64)).astype(np.float32))
               for _ in range(3))
    for causal in (True, False):
        a = tattn.dot_product_attention(q, k, v, causal=causal, impl="flash")
        b = tattn.dot_product_attention(q, k, v, causal=causal, impl="xla")
        c = tattn.dot_product_attention(q, k, v, causal=causal, sm_scale=0.125)
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(b, c, atol=0, rtol=0)  # 1/sqrt(64) is the default
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.dot_product_attention(q, k, v, impl="ring")


def test_model_flash_flag_and_remat():
    m = TransformerLM(VOCAB, max_len=SEQ, embed_dim=EMBED, depth=1, num_heads=HEADS, flash=True)
    assert m.flash and m.blocks[0].attn.flash
    assert not TransformerLM(VOCAB, max_len=SEQ, embed_dim=EMBED, depth=1,
                             num_heads=HEADS).blocks[0].attn.flash
    # block remat (policy "nothing") and the policies that save dots (P2b) build
    assert TransformerLM(VOCAB, max_len=SEQ, embed_dim=EMBED, depth=1, num_heads=HEADS,
                         remat=True).remat
    for policy in ("dots", "dots_saveable"):
        m = TransformerLM(VOCAB, max_len=SEQ, embed_dim=EMBED, depth=1, num_heads=HEADS,
                          remat=True, remat_policy=policy)
        assert m.remat and m.remat_policy == policy


def test_decode_cache_keeps_the_einsum_under_flash(params):
    """A flash model still serves: prefill and decode run the cache path."""
    model = _port_lm(params, True).eval()
    plain = TransformerLM(VOCAB, max_len=SEQ, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
                          fused_tails=True).eval()
    plain.load_state_dict(model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, VOCAB, (2, 9)))
    with torch.inference_mode():
        a, _ = model(toks, model.new_cache(2))
        b, _ = plain(toks, plain.new_cache(2))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
