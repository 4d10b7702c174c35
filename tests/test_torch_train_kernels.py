"""The port's training kernels (K1 fused CE, K2 flash attention) and the
K3/K4 gradients against the JAX package's.

The JAX functions run their Pallas kernels in interpret mode off the TPU,
as the JAX package's own tests run them; the port's wrappers run their
plain twins on CPU tensors, through the same ``torch.autograd.Function``s
the card runs (the CUDA kernels are held against those twins on the card
by ``chip_smoke.py``).  Inputs come from numpy seeds.

Tolerances: f32 values within atol 1e-5 (losses rtol 1e-5) and f32
gradients within atol 2e-5 / rtol 1e-4 -- summation order only.  bf16
outputs and gradients within atol/rtol 2e-2: both sides round the same
quantities to bf16 (o, p before PV and dV, ds before dK and dQ, the
gradients once at the end), so what differs is one bf16 ulp where an f32
sum taken in another order lands on the other side of a rounding boundary
(an ulp is 2^-8 relative, 1.6e-2 at |x| in [2, 4)).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops import fused_elementwise as jfe
from pytorch_distributed_training_tpu.ops.flash_attention import flash_attention as jax_flash
from pytorch_distributed_training_tpu.ops.fused_ce import fused_cross_entropy as jax_fused_ce
from pytorch_distributed_training_tpu_torch import kernels
from pytorch_distributed_training_tpu_torch.ops import flash_attention as tfa
from pytorch_distributed_training_tpu_torch.ops import fused_ce as tce
from pytorch_distributed_training_tpu_torch.ops import fused_elementwise as tfe
from pytorch_distributed_training_tpu_torch.ops import losses as tlosses

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _pair(arr32: np.ndarray, dtype: str, requires_grad: bool = False):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = _DT[dtype]
    j = jnp.asarray(arr32).astype(jdt)
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(tdt)
    return j, t.requires_grad_(requires_grad)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --------------------------------------------------------------------- #
# K1: fused cross-entropy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c", [(6, 40), (37, 1000)])
def test_fused_ce_loss_and_grad_match_jax(dtype, b, c):
    rng = np.random.default_rng(b * 31 + c)
    jx, tx = _pair((rng.normal(size=(b, c)) * 3.0).astype(np.float32), dtype, True)
    labels = rng.integers(0, c, b).astype(np.int32)
    jloss, jgrad = jax.value_and_grad(
        lambda x: jax_fused_ce(x, jnp.asarray(labels), interpret=True))(jx)
    tloss = tce.fused_cross_entropy(tx, torch.from_numpy(labels).long())
    tloss.backward()
    assert tloss.dtype == torch.float32 and tx.grad.dtype == tx.dtype
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    tol = dict(atol=1e-5, rtol=0) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(tx.grad), _np(jgrad), **tol)
    # the same function as the plain XLA formula
    np.testing.assert_allclose(
        float(tlosses.cross_entropy_loss_xla(tx.detach(), torch.from_numpy(labels))),
        float(tloss.detach()), rtol=1e-5)


def test_fused_ce_rows_and_out_of_range_label_match_jax():
    """Per-row nll and lse against the JAX kernel one row at a time (a batch
    of one's mean is its row's nll); row 3's label lies past the vocabulary
    and contributes a true logit of 0 on both sides, a finite wrong loss."""
    rng = np.random.default_rng(7)
    b, c = 5, 48
    x = (rng.normal(size=(b, c)) * 2.0).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    labels[3] = c + 9
    nll, lse = tce.fused_ce_forward(torch.from_numpy(x), torch.from_numpy(labels))
    for i in range(b):
        want = float(jax_fused_ce(jnp.asarray(x[i:i + 1]), jnp.asarray(labels[i:i + 1]),
                                  interpret=True))
        true_logit = x[i, labels[i]] if labels[i] < c else 0.0
        np.testing.assert_allclose(float(nll[i]), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(lse[i]), want + true_logit, rtol=1e-5, atol=1e-5)
    assert np.isfinite(nll.numpy()).all()
    np.testing.assert_allclose(float(lse[3]), float(nll[3]), rtol=1e-6)
    loss_all = float(jax_fused_ce(jnp.asarray(x), jnp.asarray(labels), interpret=True))
    np.testing.assert_allclose(float(nll.mean()), loss_all, rtol=1e-5)


def test_fused_ce_backward_twin_matches_its_formula():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(7, 30)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 30, 7))
    _, lse = tce.ce_forward_plain(x, labels)
    d = tce.fused_ce_backward(x, labels, lse, torch.tensor([0.25]))
    want = (torch.softmax(x, -1) - torch.nn.functional.one_hot(labels, 30)) * 0.25
    torch.testing.assert_close(d, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_loss_label_smoothing_matches_jax(smoothing):
    from pytorch_distributed_training_tpu.ops.losses import cross_entropy_loss_xla as jax_ce

    rng = np.random.default_rng(9)
    x = (rng.normal(size=(12, 33)) * 2).astype(np.float32)
    labels = rng.integers(0, 33, 12).astype(np.int32)
    want = float(jax_ce(jnp.asarray(x), jnp.asarray(labels), smoothing))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tlosses.cross_entropy_loss(tx, torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)
    got.backward()
    jgrad = jax.grad(lambda a: jax_ce(a, jnp.asarray(labels), smoothing))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), atol=1e-6)


# --------------------------------------------------------------------- #
# K2: flash attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [128, 256])
def test_flash_attention_matches_jax(dtype, causal, seq):
    rng = np.random.default_rng(seq + 2 * causal + (dtype == "bfloat16"))
    shape = (1, seq, 2, 64)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=shape).astype(np.float32), dtype, True) for _ in range(3))
    w = rng.normal(size=shape).astype(np.float32)

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    to = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert to.dtype == tq.dtype and to.shape == tq.shape
    (to.float() * torch.from_numpy(w)).sum().backward()
    if dtype == "float32":
        np.testing.assert_allclose(_np(to), _np(jo), atol=1e-5, rtol=0)
        for t, j in zip((tq, tk, tv), jgrads):
            np.testing.assert_allclose(_np(t.grad), _np(j), atol=2e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(_np(to), _np(jo), **BF16_TOL)
        for t, j in zip((tq, tk, tv), jgrads):
            assert t.grad.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(t.grad), _np(j), **BF16_TOL)


def test_flash_lse_and_masking():
    """lse is the row logsumexp of the scaled, masked scores; the causal
    first row attends to itself only."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 128, 64)).astype(np.float32))
               for _ in range(3))
    o, lse = tfa.flash_forward(q, k, v, True, 0.125)
    s = (q @ k.transpose(-1, -2)) * 0.125
    s = s.masked_fill(~torch.ones(128, 128, dtype=torch.bool).tril(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(o[:, 0], v[:, 0], atol=1e-6, rtol=0)
    assert tfa.launch_counts() == {"flash_fwd": 0, "flash_bwd": 0}  # CPU: no kernel


@pytest.mark.parametrize("s_len", [64, 100, 128, 200, 256, 2048, 16384])
def test_flash_shape_gate_is_the_jax_gate(s_len):
    # the gate reads S alone, as JAX's does; the head dim never sends a
    # flash model to the einsum
    from pytorch_distributed_training_tpu.ops.flash_attention import flash_shapes_ok

    for d in (32, 64, 128):
        assert tfa.flash_shapes_ok(s_len) == flash_shapes_ok(s_len, d)


def test_flash_model_raises_on_head_dims_the_kernels_do_not_take():
    from pytorch_distributed_training_tpu_torch.ops.attention import MultiHeadAttention

    with pytest.raises(ValueError, match=r"head dims \(64, 128\), got 32"):
        MultiHeadAttention(64, 2, causal=True, flash=True)
    MultiHeadAttention(64, 2, causal=True)  # the einsum takes any head dim
    q = torch.zeros(1, 128, 2, 32)
    with pytest.raises(ValueError, match="D in"):
        tfa.flash_attention(q, q, q, causal=True)


def test_flash_bounds_at_the_lm_shape():
    # B 8 x H 16, S 2048, D 64, causal: the causal half of 2 products
    # forward, 5 backward (the figures of the kernel table)
    fwd = tfa.flash_flops(128, 2048, 64, causal=True)
    bwd = tfa.flash_flops(128, 2048, 64, causal=True, backward=True)
    assert fwd == 4 * 64 * 128 * 2048 * 2049 // 2
    # 2 S^2 D BH = 68.7 GFLOP; the diagonal's own pairs add S D BH x 4
    assert round(fwd / 1e9, 2) == 68.75 and round(bwd / 1e9, 2) == 171.88
    assert tfa.flash_bytes(128, 2048, 64, torch.bfloat16) == 4 * 128 * 2048 * 64 * 2 + 128 * 2048 * 4
    assert tce.ce_forward_bytes(16384, 32768, torch.float32) == 16384 * 32768 * 4 + 3 * 16384 * 4


# --------------------------------------------------------------------- #
# K3 / K4 gradients


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_layernorm_grads_match_jax(dtype):
    rng = np.random.default_rng(21)
    rows, feat = 6, 48
    jx, tx = _pair(rng.normal(size=(rows, feat)).astype(np.float32) * 2, dtype, True)
    jd, td = _pair(rng.normal(size=(rows, feat)).astype(np.float32), dtype, True)
    scale = (1.0 + 0.3 * rng.normal(size=feat)).astype(np.float32)
    bias = (0.1 * rng.normal(size=feat)).astype(np.float32)
    ws = rng.normal(size=(rows, feat)).astype(np.float32)
    wy = rng.normal(size=(rows, feat)).astype(np.float32)

    def jobj(x, d, sc, bi):
        s, y = jfe.fused_add_layernorm(x, d, sc, bi)
        return jnp.sum(s.astype(jnp.float32) * ws) + jnp.sum(y.astype(jnp.float32) * wy)

    jgrads = jax.grad(jobj, argnums=(0, 1, 2, 3))(jx, jd, jnp.asarray(scale), jnp.asarray(bias))
    tsc = torch.from_numpy(scale).requires_grad_(True)
    tbi = torch.from_numpy(bias).requires_grad_(True)
    # out_dtype f32: the JAX function's promotion of (dtype, f32 params)
    s, y = tfe.fused_add_layernorm(tx, td, tsc, tbi)
    ((s.float() * torch.from_numpy(ws)).sum() + (y.float() * torch.from_numpy(wy)).sum()).backward()
    tol = dict(atol=2e-5, rtol=1e-4) if dtype == "float32" else BF16_TOL
    for t, j in zip((tx, td), jgrads[:2]):
        assert t.grad.dtype == tx.dtype
        np.testing.assert_allclose(_np(t.grad), _np(j), **tol)
    # the parameter gradients reduce over rows in f32 on both sides
    for t, j in zip((tsc, tbi), jgrads[2:]):
        np.testing.assert_allclose(_np(t.grad), _np(j), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_gelu_grads_match_jax(dtype):
    rng = np.random.default_rng(22)
    ju, tu = _pair(rng.normal(size=(9, 40)).astype(np.float32) * 2, dtype, True)
    jb, tb = _pair(rng.normal(size=40).astype(np.float32) * 0.5, dtype, True)
    w = rng.normal(size=(9, 40)).astype(np.float32)
    jgrads = jax.grad(
        lambda u, b: jnp.sum(jfe.fused_bias_gelu(u, b).astype(jnp.float32) * w),
        argnums=(0, 1))(ju, jb)
    (tfe.fused_bias_gelu(tu, tb).float() * torch.from_numpy(w)).sum().backward()
    tol = dict(atol=2e-5, rtol=1e-4) if dtype == "float32" else BF16_TOL
    for t, j in zip((tu, tb), jgrads):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(_np(t.grad), _np(j), **tol)


def test_fused_tail_modules_train_through_their_functions():
    """Serving's path (no grad) and training's (autograd) launch the same
    wrappers; the modules' gradients reach every parameter."""
    ln = tfe.FusedResidualLayerNorm(16)
    mlp = tfe.FusedDenseGelu(16, 32)
    x = torch.randn(3, 16, requires_grad=True)
    s, y = ln(x, torch.randn(3, 16))
    (s.sum() + mlp(y).square().sum()).backward()
    for p in list(ln.parameters()) + list(mlp.parameters()) + [x]:
        assert p.grad is not None and torch.isfinite(p.grad).all()
    with torch.no_grad():
        s2, _ = ln(x, torch.zeros(3, 16))
    assert s2.grad_fn is None


# --------------------------------------------------------------------- #
# wrappers off the CPU, and the C interface


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "logits,labels,exc,match",
    [
        (_meta((4, 8), torch.float64), _meta(4, torch.int64), TypeError, "float32 or bfloat16"),
        (_meta((4, 8), torch.float16), _meta(4, torch.int64), TypeError, "float32 or bfloat16"),
        (_meta((4, 8)), _meta(4, torch.float32), TypeError, "int32 or int64"),
        (_meta((4, 8)), _meta(5, torch.int64), ValueError, r"\[B, C\]"),
        (_meta((8, 4)).t(), _meta(4, torch.int64), ValueError, "contiguous"),
        (_meta((4, 8)), _meta(4, torch.int64), ValueError, "CUDA"),
    ],
    ids=["f64", "f16", "float-labels", "label-shape", "non-contiguous", "not-cuda"],
)
def test_ce_wrapper_raises_off_the_cpu(logits, labels, exc, match):
    with pytest.raises(exc, match=match):
        tce.fused_ce_forward(logits, labels)


@pytest.mark.parametrize(
    "shape,dtype,exc,match",
    [
        ((2, 128, 64), torch.float16, TypeError, "all float32 or all"),
        ((2, 128, 32), torch.bfloat16, ValueError, "D in"),
        ((2, 100, 64), torch.bfloat16, ValueError, "S % 128"),
        ((2, 128, 64), torch.bfloat16, ValueError, "CUDA"),
    ],
    ids=["f16", "head-dim-32", "seq-100", "not-cuda"],
)
def test_flash_wrapper_raises_off_the_cpu(shape, dtype, exc, match):
    q = _meta(shape, dtype)
    with pytest.raises(exc, match=match):
        tfa.flash_forward(q, q, q, True, 0.125)


def test_flash_wrapper_raises_on_unsupported_shapes_on_the_cpu_too():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="S >= 128"):
        tfa.flash_attention(q, q, q, causal=True)


_CTYPE_OF = {"void*": "c_void_p", "int": "c_int", "float": "c_float"}


@pytest.mark.parametrize("lib", sorted(kernels.SOURCES))
def test_ctypes_argtypes_match_extern_c_signatures(lib):
    """No compiler runs here: hold each ctypes argument list against the
    exported C function's parameter types in the CUDA source."""
    src, fns = kernels.SOURCES[lib]
    text = (Path(kernels.CSRC_DIR) / src).read_text()
    exported = {m.group(1): m.group(2) for m in
                re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text)}
    assert set(exported) == set(fns)
    for fn, argtypes in fns.items():
        params = [" ".join(p.split()) for p in exported[fn].split(",")]
        kinds = ["void*" if "*" in p else p.rsplit(" ", 1)[0].replace("const ", "")
                 for p in params]
        assert [_CTYPE_OF[k] for k in kinds] == [a.__name__ for a in argtypes], fn


@pytest.mark.parametrize("lib", ["fused_ce", "flash_attention"])
def test_new_libraries_build_recipe(lib):
    path = kernels.library_path(lib)
    assert path.startswith(kernels.BUILD_DIR) and f"lib{lib}-" in path
    cmd = kernels.nvcc_command(lib, "/x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1].endswith(f"{lib}.cu")


def test_cpu_wrappers_launch_nothing():
    tce.reset_launch_counts()
    tfa.reset_launch_counts()
    x = torch.randn(4, 10, requires_grad=True)
    tce.fused_cross_entropy(x, torch.tensor([1, 2, 3, 4])).backward()
    q = torch.randn(1, 128, 1, 64, requires_grad=True)
    tfa.flash_attention(q, q, q, causal=True).sum().backward()
    assert tce.launch_counts() == {"ce_fwd": 0, "ce_bwd": 0}
    assert tfa.launch_counts() == {"flash_fwd": 0, "flash_bwd": 0}
