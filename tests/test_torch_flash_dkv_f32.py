"""The f32 flash dK/dV of the port: its 3xTF32 arithmetic on the CPU, and
the limits ``chip_smoke.py`` holds ``flash_bwd_dkv_3xtf32_kernel`` to.

(a) ``tools/flash_checks.py``'s :func:`flash_bwd_emulated` repeats the
kernel's arithmetic: each of the four products (``q (scale K)^T``,
``dO V^T``, ``P^T dO``, ``dS^T Q``) in 3 TF32 products.  Its dk and dv
must lie within the limits that ``chip_smoke.py`` holds the kernel to
against the twin (elementwise ``FLASH_TOL["float32"]``, norm-relative
``FLASH_NORM_LIMIT["float32"]``), read through the script's own
``readings`` / ``within``; with one TF32 product a step (the wrong
variant of phases 6 and 9) they must lie outside the norm limit.  Shapes:
[2, 4, 256, 64] causal and [2, 4, 256, 128] non-causal.

(b) The 3-term dk and dv against the JAX package's f32 split backward
(``_dkv_kernel``, K2e: ``PDT_FLASH_NO_FUSED_BWD=1``, interpret mode, as
``tests/test_torch_longctx_kernels.py`` runs it), within atol 2e-5 / rtol
1e-4: f32 summation order and the 2^-22 of each split product only, the
tolerance of that file's f32 gradients.

(c) The wrong variants that phase 6 adds at its f32 shapes (a Q tile or
the diagonal blocks left out, non-causal too) read outside the limits,
and a second dK/dV call repeats the first bit for bit.

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
    rng = np.random.default_rng(s_len + d + causal)
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
def test_3xtf32_dkv_is_within_the_f32_limits(shape):
    cs = _chip_smoke()
    causal = shape[4]
    q, k, v, do, lse, delta, scale = _backward_inputs(shape)
    _, dk_p, dv_p = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    dk_e, dv_e = fc.flash_bwd_emulated(q, k, v, do, lse, delta, causal, scale, terms=3)
    for what, got, want in (("dk", dk_e, dk_p), ("dv", dv_e, dv_p)):
        r = cs.readings(got, want, **cs.FLASH_TOL["float32"])
        assert cs.within(r, cs.FLASH_NORM_LIMIT["float32"][what]), (what, r)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_1xtf32_dkv_exceeds_the_norm_limit(shape):
    """One TF32 product a step reads outside the dk/dv norm limits, so a
    kernel that dropped the small products fails on the card; phase 6's
    checks say so through ``judge``."""
    cs = _chip_smoke()
    causal = shape[4]
    q, k, v, do, lse, delta, scale = _backward_inputs(shape)
    _, dk_p, dv_p = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    dk_1, dv_1 = fc.flash_bwd_emulated(q, k, v, do, lse, delta, causal, scale, terms=1)
    for what, got, want in (("dk", dk_1, dk_p), ("dv", dv_1, dv_p)):
        r = cs.readings(got, want, **cs.FLASH_TOL["float32"])
        assert r["norm_rel"] > cs.FLASH_NORM_LIMIT["float32"][what] and not cs.within(r), r
    checks = cs.dkv_tf32_checks(fc, q, k, v, do, lse, delta, causal, scale, (dk_p, dv_p),
                                cs.FLASH_TOL["float32"], cs.FLASH_NORM_LIMIT["float32"], "cpu")
    assert [(what.split()[1], sound) for what, _, _, sound in checks] == [
        ("dk", None), ("dv", None), ("dk", False), ("dv", False)]
    cs.judge(checks)  # raises if the 1-term variant were within the limits


def test_emulation_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 128, 64)
    rows = torch.zeros(1, 128)
    with pytest.raises(TypeError, match="float32"):
        fc.flash_bwd_emulated(x.bfloat16(), x.bfloat16(), x.bfloat16(), x.bfloat16(), rows,
                              rows, True, 0.125)
    with pytest.raises(TypeError, match="float32"):
        fc.flash_bwd_emulated(x, x, x, x, rows.double(), rows, True, 0.125)
    with pytest.raises(ValueError, match="terms"):
        fc.flash_bwd_emulated(x, x, x, x, rows, rows, True, 0.125, terms=2)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_3xtf32_dkv_matches_jax_split_backward(monkeypatch, shape):
    """K2e's dk and dv (``_dkv_kernel`` in interpret mode) against the
    3-term emulation on the same inputs, dO being the weights of the loss
    ``sum(o * dO)``."""
    monkeypatch.delenv("PDT_FLASH_FORCE_STREAM", raising=False)
    monkeypatch.delenv("PDT_FLASH_F32_DOTS", raising=False)
    monkeypatch.setenv("PDT_FLASH_NO_FUSED_BWD", "1")
    b, h, s_len, d, causal = shape
    assert jfa._resident_ok(s_len, d)
    assert tfa.tpu_kernels(s_len, d, torch.float32)["dkv"] == "K2e"
    q, k, v, do = _inputs(shape)

    def jloss(kk, vv):
        o = jfa.flash_attention(jnp.asarray(q), kk, vv, causal=causal, interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    jdk, jdv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tdo = (_fold(x) for x in (q, k, v, do))
    o, lse = tfa.flash_fwd_plain(tq, tk, tv, causal, d ** -0.5)
    dk, dv = fc.flash_bwd_emulated(tq, tk, tv, tdo, lse, (tdo * o).sum(-1), causal, d ** -0.5)
    for got, want in ((dk, jdk), (dv, jdv)):
        want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b * h, s_len, d)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_phase6_dkv_variants_are_rejected(shape):
    """The dK/dV wrong variants of phase 6's f32 cases, built as the
    script builds them (the port's dK/dV launch on CPU tensors stands in
    for the kernel), read outside the f32 limits."""
    cs = _chip_smoke()
    causal = shape[4]
    q, k, v, do, lse, delta, scale = _backward_inputs(shape)
    want = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    tile = q.shape[1] // cs.VARIANT_ROWS // 2
    rows = slice(tile * cs.VARIANT_ROWS, (tile + 1) * cs.VARIANT_ROWS)
    do_cut, delta_cut = do.clone(), delta.clone()
    do_cut[:, rows], delta_cut[:, rows] = 0, 0
    cut = tfa.flash_backward_dkv(q, k, v, do_cut, lse, delta_cut, causal, scale)
    diag = cs.attention_dropping(torch, q, k, v, scale,
                                 lambda r, c: cs.tile_of(r) == cs.tile_of(c), do, lse, delta,
                                 causal)
    tol, limit = cs.FLASH_TOL["float32"], cs.FLASH_NORM_LIMIT["float32"]
    for got, wanted, names in ((cut, want[1:], ("dk", "dv")), (diag, want, ("dq", "dk", "dv"))):
        for what, a, c in zip(names, got, wanted):
            assert not cs.within(cs.readings(a, c, **tol), limit[what]), what


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_attention_dropping_with_nothing_dropped_is_the_twin(causal):
    """``attention_dropping`` with an empty drop gives the twin's gradients,
    causal or not: the variants above differ from the twin only by what
    they leave out."""
    cs = _chip_smoke()
    q, k, v, do, lse, delta, scale = _backward_inputs((1, 2, 128, 64, causal))
    want = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    got = cs.attention_dropping(torch, q, k, v, scale, lambda r, c: torch.zeros_like(r == c),
                                do, lse, delta, causal)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, atol=1e-5, rtol=1e-5)


def test_dkv_repeats_passes_an_equal_launch_and_fails_another(capsys):
    cs = _chip_smoke()
    q, k, v, do, lse, delta, scale = _backward_inputs((1, 2, 128, 64, True))
    args = (q, k, v, do, lse, delta, True, scale)
    got = tfa.flash_backward_dkv(*args)
    cs.dkv_repeats(torch, tfa, got, args, "cpu")
    assert "two launches bitwise equal" in capsys.readouterr().out
    nudged = (got[0], got[1].clone())
    nudged[1][0, 0, 0] = torch.nextafter(nudged[1][0, 0, 0], torch.tensor(1e30))
    with pytest.raises(AssertionError, match="two launches differ"):
        cs.dkv_repeats(torch, tfa, nudged, args, "cpu")
