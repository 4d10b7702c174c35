"""The port's flash kernels on the long-context slice against the JAX
package's streamed and split kernels, and the accounting by TPU kernel.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do, with its escape hatches set through ``monkeypatch``:
``PDT_FLASH_FORCE_STREAM=1`` runs the streamed kernels (K2b forward,
K2f/K2g backward) and ``PDT_FLASH_NO_FUSED_BWD=1`` the resident split
backward (K2d/K2e).  At S = 2048 the JAX tiles are 1024 rows, so the
streamed grid has 2 x 2 tiles per head.  The port runs its plain twins on
CPU tensors, the functions its CUDA kernels are held against on the card.

Tolerances (``tests/test_torch_train_kernels.py``): f32 o within atol 1e-5,
gradients within atol 2e-5 / rtol 1e-4 -- summation order only; bf16
within atol/rtol 2e-2 (one bf16 ulp at |x| in [2, 4) is 1.6e-2, and both
sides round the same quantities).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops import flash_attention as jfa
from pytorch_distributed_training_tpu_torch.ops import flash_attention as tfa

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _pair(arr32: np.ndarray, dtype: str):
    jdt, tdt = _DT[dtype]
    j = jnp.asarray(arr32).astype(jdt)
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(tdt)
    return j, t.requires_grad_(True)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture
def jax_gates(monkeypatch):
    """Neither escape hatch set unless a test sets one."""
    monkeypatch.delenv("PDT_FLASH_FORCE_STREAM", raising=False)
    monkeypatch.delenv("PDT_FLASH_NO_FUSED_BWD", raising=False)
    monkeypatch.delenv("PDT_FLASH_F32_DOTS", raising=False)
    return monkeypatch


def _against_jax(dtype: str, causal: bool, seed: int) -> None:
    rng = np.random.default_rng(seed)
    shape = (1, 2048, 2, 64)  # B 1, S 2048, H 2, D 64: BH 2 once folded
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=shape).astype(np.float32), dtype) for _ in range(3))
    w = rng.normal(size=shape).astype(np.float32)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    to = tfa.flash_attention(tq, tk, tv, causal=causal)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_streamed_kernels(jax_gates, dtype, causal):
    """K2b forward, K2f/K2g backward (2 x 2 tiles of 1024 per head)."""
    jax_gates.setenv("PDT_FLASH_FORCE_STREAM", "1")
    assert not jfa._resident_ok(2048, 64)
    _against_jax(dtype, causal, seed=10 + 2 * causal + (dtype == "bfloat16"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_split_backward(jax_gates, dtype, causal):
    """K2a forward, K2d/K2e backward."""
    jax_gates.setenv("PDT_FLASH_NO_FUSED_BWD", "1")
    assert not jfa._fused_bwd_ok(2048, 64, 2, True, True)
    _against_jax(dtype, causal, seed=20 + 2 * causal + (dtype == "bfloat16"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s_len", [128, 1024, 2048, 4096, 8192, 16384, 32768, 65536])
def test_tpu_kernels_are_the_jax_gates(jax_gates, s_len, d, dtype):
    """The classification reads the JAX package's gates on the TPU: resident
    K/V or streamed, fused backward only with bf16 dots (interpret off)."""
    jdt, tdt = _DT[dtype]
    got = tfa.tpu_kernels(s_len, d, tdt)
    resident = jfa._resident_ok(s_len, d)
    bf16_dots = dtype == "bfloat16"
    fused = jfa._fused_bwd_ok(s_len, d, jnp.dtype(jdt).itemsize, bf16_dots, interpret=False)
    if not resident:
        want = {"forward": "K2b", "dq": "K2f", "dkv": "K2g"}
    elif fused:
        want = {"forward": "K2a", "dq": "K2c", "dkv": "K2c"}
    else:
        want = {"forward": "K2a", "dq": "K2d", "dkv": "K2e"}
    assert got == want


def test_tpu_kernels_of_the_slices():
    # the long-context slice streams; the LM slice fuses; f32 always splits
    assert tfa.tpu_kernels(32768, 64, torch.bfloat16) == {"forward": "K2b", "dq": "K2f",
                                                           "dkv": "K2g"}
    assert tfa.tpu_kernels(2048, 64, torch.bfloat16)["dq"] == "K2c"
    assert tfa.tpu_kernels(2048, 64, torch.float32) == {"forward": "K2a", "dq": "K2d",
                                                         "dkv": "K2e"}
    # 2 S D 4 = 8 MiB exactly is still resident (<=)
    assert tfa.tpu_kernels(16384, 64, torch.float32)["forward"] == "K2a"
    assert tfa.tpu_kernels(16384, 128, torch.float32)["forward"] == "K2b"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_twin_equals_unchunked(monkeypatch, dtype, causal):
    """Chunking over heads and query rows keeps every rounding: o and lse
    as computed whole, dq/dk/dv within the reordering of f32 sums (dK and
    dV add the row chunks' products in f32 before their one rounding; a
    bf16 result may land one ulp, at most 2^-7 relative, the other way)."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(5, 384, 64, generator=g).to(dtype) for _ in range(4))
    o, lse = tfa.flash_fwd_plain(q, k, v, causal, 0.125)
    delta = (do.float() * o.float()).sum(-1)
    grads = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal, 0.125)
    # 2 heads and 64 rows a chunk: 3 head chunks x 6 row chunks
    monkeypatch.setattr(tfa, "_PLAIN_HEADS", 2)
    monkeypatch.setattr(tfa, "_PLAIN_SCORES", 2 * 64 * 384)
    assert tfa._row_chunk(2, 384) == 64
    o2, lse2 = tfa.flash_fwd_plain(q, k, v, causal, 0.125)
    grads2 = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal, 0.125)
    tol = dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-6, rtol=2 ** -7)
    torch.testing.assert_close(lse2, lse, atol=1e-6, rtol=1e-6)
    for a, b in zip((o2, *grads2), (o, *grads)):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **tol)


def test_split_wrappers_on_the_cpu_are_the_twin_and_launch_nothing():
    tfa.reset_launch_counts()
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn(2, 256, 64, generator=g) for _ in range(4))
    o, lse = tfa.flash_forward(q, k, v, True, 0.125)
    delta = (do * o).sum(-1)
    dq, dk, dv = tfa.flash_backward(q, k, v, do, lse, delta, True, 0.125)
    assert torch.equal(tfa.flash_backward_dq(q, k, v, do, lse, delta, True, 0.125), dq)
    dk2, dv2 = tfa.flash_backward_dkv(q, k, v, do, lse, delta, True, 0.125)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    assert tfa.launch_counts() == {"flash_fwd": 0, "flash_bwd": 0}
    assert tfa.tpu_launch_counts() == dict.fromkeys(tfa.TPU_KERNELS, 0)
    with pytest.raises(ValueError, match="delta must be"):
        tfa.flash_backward_dq(q, k, v, do, lse, delta[:, :128], True, 0.125)


def test_flash_bounds_at_the_long_context_shape():
    # B 2 x H 8, S 32768, D 64, causal: the figures of the kernel table
    bh, s, d = 16, 32768, 64
    fwd = tfa.flash_flops(bh, s, d, causal=True)
    assert round(fwd / 1e12, 2) == 2.2  # 2.2 ms at 989 TFLOP/s, 32.8 ms at 67
    dq = tfa.flash_flops(bh, s, d, causal=True, part="dq")
    dkv = tfa.flash_flops(bh, s, d, causal=True, part="dkv")
    assert 2 * dq == 3 * fwd and dkv == 2 * fwd
    assert tfa.flash_flops(bh, s, d, causal=True, backward=True) == 5 * fwd // 2
    mat = bh * s * d * 2
    assert tfa.flash_bytes(bh, s, d, torch.bfloat16, part="dq") == 5 * mat + 2 * bh * s * 4
    assert tfa.flash_bytes(bh, s, d, torch.bfloat16, part="dkv") == 6 * mat + 2 * bh * s * 4
    assert tfa.flash_bytes(bh, s, d, torch.bfloat16, backward=True) == 7 * mat + 2 * bh * s * 4
