"""The port's dQ launch (``flash_backward_dq``) against the JAX package's
split backward, at the tile counts that ``chip_smoke.py`` adds for the bf16
dQ kernel, and the dQ wrong variants of ``chip_smoke.py`` against the twin.

(a) The JAX side runs with ``PDT_FLASH_NO_FUSED_BWD=1`` in interpret mode,
as its own tests do: its ``_dq_kernel`` takes one whole-array tile at S =
384 and S = 640.  The port side runs its forward and then its dQ wrapper on
CPU tensors, that is the plain twin that the CUDA kernel is held against on
the card, with ``delta = rowsum(dO * O)`` as its autograd backward forms
it.  Tolerances are those of ``tests/test_torch_longctx_kernels.py``: f32
dq within atol 2e-5 / rtol 1e-4 (summation order only), bf16 within
atol/rtol 2e-2 (both sides round p, ds and dq to bf16 at the same places;
one ulp at |x| in [2, 4) is 1.6e-2).

(b) Each dQ wrong variant that ``chip_smoke.py`` holds the kernel's limits
against must read outside ``FLASH_NORM_LIMIT["bfloat16"]["dq"]`` here
already, through the script's own ``readings`` / ``within``: a variant
that is a no-op would let a wrong kernel pass on the card.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops import flash_attention as jfa
from pytorch_distributed_training_tpu_torch.ops import flash_attention as tfa

REPO = Path(__file__).resolve().parents[1]
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
F32_TOL = dict(atol=2e-5, rtol=1e-4)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pair(arr32: np.ndarray, dtype: str):
    jdt, tdt = _DT[dtype]
    j = jnp.asarray(arr32).astype(jdt)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(tdt)


def _fold(x: torch.Tensor) -> torch.Tensor:
    b, s_len, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s_len, d).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 384, 2, 128), (1, 640, 2, 64)])
def test_dq_matches_jax_split_backward(monkeypatch, shape, causal, dtype):
    """K2d's dq (``_dq_kernel``) against the port's dQ launch: B, S, H, D as
    ``chip_smoke.py``'s [2, 4, 384, 128] and [2, 4, 640, 64] in S and D."""
    monkeypatch.delenv("PDT_FLASH_FORCE_STREAM", raising=False)
    monkeypatch.delenv("PDT_FLASH_F32_DOTS", raising=False)
    monkeypatch.setenv("PDT_FLASH_NO_FUSED_BWD", "1")
    b, s_len, h, d = shape
    assert jfa._resident_ok(s_len, d) and not jfa._fused_bwd_ok(s_len, d, 2, True, True)
    rng = np.random.default_rng(s_len + d + 2 * causal + (dtype == "bfloat16"))
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=shape).astype(np.float32), dtype) for _ in range(3))
    w = rng.normal(size=shape).astype(np.float32)

    def jloss(q):
        o = jfa.flash_attention(q, jk, jv, causal=causal, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w)

    jdq = np.asarray(jax.grad(jloss)(jq).astype(jnp.float32))

    _, tdt = _DT[dtype]
    scale = 1.0 / d ** 0.5
    q, k, v = _fold(tq), _fold(tk), _fold(tv)
    do = _fold(torch.from_numpy(w).to(tdt))  # the cotangent of o, in o's dtype
    o, lse = tfa.flash_forward(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    dq = tfa.flash_backward_dq(q, k, v, do, lse, delta, causal, scale)
    assert dq.dtype == tdt and dq.shape == q.shape
    tdq = dq.float().reshape(b, h, s_len, d).transpose(1, 2).numpy()
    np.testing.assert_allclose(tdq, jdq, **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_dq_wrong_variants_read_outside_the_limit(which):
    """At [4, 640, 64] bf16 causal (5 tiles of 128 rows): a dQ whose K loop
    skips a middle 64-key block, one that skips the diagonal block of the
    odd 64-row blocks, and one whose mask leaves out each query's own key,
    are all rejected against the twin."""
    cs = _chip_smoke()
    rng = np.random.default_rng(41)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(4, 640, 64)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    scale = 0.125
    o, lse = tfa.flash_fwd_plain(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    dq = tfa.flash_bwd_plain(q, k, v, do, lse, delta, True, scale)[0]
    limit = cs.FLASH_NORM_LIMIT["bfloat16"]["dq"]
    tol = cs.FLASH_TOL["bfloat16"]
    # the twin itself reads inside: the checks can pass at all
    assert cs.within(cs.readings(dq, dq, **tol), limit)
    variants = cs.dq_variants(torch, q, k, v, do, lse, delta, scale)
    assert [w for w, _ in variants] == ["K tile 5 skipped", "second diagonal block skipped",
                                        "own key dropped"]
    what, wrong = variants[which]
    assert wrong.dtype == torch.bfloat16 and wrong.shape == dq.shape
    r = cs.readings(wrong, dq, **tol)
    assert not cs.within(r, limit), (what, r)
    assert r["norm_rel"] > 10 * limit, (what, r)
