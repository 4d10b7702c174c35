"""The f32 flash dQ of the port: its 3xTF32 arithmetic on the CPU, and the
limits ``chip_smoke.py`` holds ``flash_bwd_dq_3xtf32_kernel`` to.

(a) ``tools/flash_checks.py``'s :func:`flash_dq_emulated` repeats the
kernel's arithmetic: each of the three products (``(q * scale) K^T``,
``dO V^T``, ``dS K``) in 3 TF32 products.  Its dq must lie within the
limits that ``chip_smoke.py`` holds the kernel to against the twin
(elementwise ``FLASH_TOL["float32"]``, norm-relative
``FLASH_NORM_LIMIT["float32"]["dq"]``), read through the script's own
``readings`` / ``within``; with one TF32 product a step (the wrong variant
of phases 6 and 9) it must lie outside the norm limit.  Shapes: [2, 4,
256, 64] causal and [2, 4, 256, 128] non-causal.

(b) The 3-term dq against the JAX package's f32 split backward
(``_dq_kernel``, K2d: ``PDT_FLASH_NO_FUSED_BWD=1``, interpret mode), within
atol 2e-5 / rtol 1e-4: f32 summation order and the 2^-22 of each split
product only, the tolerance of ``tests/test_torch_flash_dkv_f32.py``.

(c) The dQ wrong variants that phases 6 and 9 add at their f32 shapes
(a middle K block skipped, the odd rows' diagonal block skipped, each
query's own key dropped), causal and not, read outside the limits, and a
second dQ call repeats the first bit for bit.

Inputs are made with numpy from a seed.
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
from pytorch_distributed_training_tpu_torch.tools import flash_checks as fc

REPO = Path(__file__).resolve().parents[1]
# (B, H, S, D, causal)
SHAPES = [(2, 4, 256, 64, True), (2, 4, 256, 128, False)]
SHAPE_IDS = ["2x4x256x64-causal", "2x4x256x128-full"]
F32_TOL = dict(atol=2e-5, rtol=1e-4)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(shape):
    """q, k, v, dO as [B, S, H, D] f32 numpy arrays."""
    b, h, s_len, d, causal = shape
    rng = np.random.default_rng(3 * s_len + d + causal)
    return [rng.normal(size=(b, s_len, h, d)).astype(np.float32) for _ in range(4)]


def _fold(x: np.ndarray) -> torch.Tensor:
    b, s_len, h, d = x.shape
    return torch.from_numpy(x).transpose(1, 2).reshape(b * h, s_len, d).contiguous()


def _backward_inputs(shape):
    """Folded q, k, v, dO with the forward's lse and ``delta = rowsum(dO *
    O)``, as the port's autograd backward forms them, and the scale."""
    d, causal = shape[3], shape[4]
    q, k, v, do = (_fold(x) for x in _inputs(shape))
    o, lse = tfa.flash_fwd_plain(q, k, v, causal, d ** -0.5)
    return q, k, v, do, lse, (do * o).sum(-1), d ** -0.5


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_3xtf32_dq_is_within_the_f32_limits(shape):
    cs = _chip_smoke()
    causal = shape[4]
    q, k, v, do, lse, delta, scale = _backward_inputs(shape)
    dq_p = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)[0]
    dq_e = fc.flash_dq_emulated(q, k, v, do, lse, delta, causal, scale, terms=3)
    r = cs.readings(dq_e, dq_p, **cs.FLASH_TOL["float32"])
    assert cs.within(r, cs.FLASH_NORM_LIMIT["float32"]["dq"]), r


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_1xtf32_dq_exceeds_the_norm_limit(shape):
    """One TF32 product a step reads outside the dq norm limit, so a kernel
    that dropped the small products fails on the card; phase 6's checks
    say so through ``judge``."""
    cs = _chip_smoke()
    causal = shape[4]
    q, k, v, do, lse, delta, scale = _backward_inputs(shape)
    dq_p = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)[0]
    dq_1 = fc.flash_dq_emulated(q, k, v, do, lse, delta, causal, scale, terms=1)
    limit = cs.FLASH_NORM_LIMIT["float32"]["dq"]
    r = cs.readings(dq_1, dq_p, **cs.FLASH_TOL["float32"])
    assert r["norm_rel"] > limit and not cs.within(r), r
    checks = cs.dq_tf32_checks(fc, q, k, v, do, lse, delta, causal, scale, dq_p,
                               cs.FLASH_TOL["float32"], limit, "cpu")
    assert [(what, sound) for what, _, _, sound in checks] == [
        ("flash dq cpu, 3xTF32 emulated", None), ("flash dq cpu, 1xTF32 emulated", False)]
    cs.judge(checks)  # raises if the 1-term variant were within the limits


def test_emulation_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 128, 64)
    rows = torch.zeros(1, 128)
    with pytest.raises(TypeError, match="float32"):
        fc.flash_dq_emulated(x.bfloat16(), x.bfloat16(), x.bfloat16(), x.bfloat16(), rows, rows,
                             True, 0.125)
    with pytest.raises(TypeError, match="float32"):
        fc.flash_dq_emulated(x, x, x, x, rows, rows.double(), True, 0.125)
    with pytest.raises(ValueError, match="terms"):
        fc.flash_dq_emulated(x, x, x, x, rows, rows, True, 0.125, terms=2)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_3xtf32_dq_matches_jax_split_backward(monkeypatch, shape):
    """K2d's dq (``_dq_kernel`` in interpret mode) against the 3-term
    emulation on the same inputs, dO being the weights of the loss
    ``sum(o * dO)``."""
    monkeypatch.delenv("PDT_FLASH_FORCE_STREAM", raising=False)
    monkeypatch.delenv("PDT_FLASH_F32_DOTS", raising=False)
    monkeypatch.setenv("PDT_FLASH_NO_FUSED_BWD", "1")
    b, h, s_len, d, causal = shape
    assert jfa._resident_ok(s_len, d)
    assert tfa.tpu_kernels(s_len, d, torch.float32)["dq"] == "K2d"
    q, k, v, do = _inputs(shape)

    def jloss(qq):
        o = jfa.flash_attention(qq, jnp.asarray(k), jnp.asarray(v), causal=causal,
                                interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    jdq = jax.grad(jloss)(jnp.asarray(q))
    tq, tk, tv, tdo = (_fold(x) for x in (q, k, v, do))
    o, lse = tfa.flash_fwd_plain(tq, tk, tv, causal, d ** -0.5)
    dq = fc.flash_dq_emulated(tq, tk, tv, tdo, lse, (tdo * o).sum(-1), causal, d ** -0.5)
    want = np.asarray(jdq).transpose(0, 2, 1, 3).reshape(b * h, s_len, d)
    np.testing.assert_allclose(dq.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_f32_dq_variants_are_rejected(shape):
    """The dQ wrong variants of phases 6 and 9 at an f32 shape, causal or
    not, built as the script builds them, read outside the f32 dq limits;
    the last one drops each query's own key."""
    cs = _chip_smoke()
    causal = shape[4]
    q, k, v, do, lse, delta, scale = _backward_inputs(shape)
    dq_p = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)[0]
    tol, limit = cs.FLASH_TOL["float32"], cs.FLASH_NORM_LIMIT["float32"]["dq"]
    variants = cs.dq_variants(torch, q, k, v, do, lse, delta, scale, causal)
    assert [w for w, _ in variants] == ["K tile 2 skipped", "second diagonal block skipped",
                                        "own key dropped"]
    for what, wrong in variants:
        r = cs.readings(wrong, dq_p, **tol)
        assert not cs.within(r, limit) and r["norm_rel"] > 10 * limit, (what, r)


def test_dq_repeats_passes_an_equal_launch_and_fails_another(capsys):
    cs = _chip_smoke()
    q, k, v, do, lse, delta, scale = _backward_inputs((1, 2, 128, 64, True))
    args = (q, k, v, do, lse, delta, True, scale)
    got = tfa.flash_backward_dq(*args)
    cs.dq_repeats(torch, tfa, got, args, "cpu")
    assert "two launches bitwise equal" in capsys.readouterr().out
    nudged = got.clone()
    nudged[0, 0, 0] = torch.nextafter(nudged[0, 0, 0], torch.tensor(1e30))
    with pytest.raises(AssertionError, match="two launches differ"):
        cs.dq_repeats(torch, tfa, nudged, args, "cpu")
