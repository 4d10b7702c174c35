"""The f32 flash forward of the port: its 3xTF32 arithmetic on the CPU, and
the port's f32 forward against the JAX package's.

(a) ``tools/flash_checks.py`` repeats the arithmetic of
``flash_fwd_3xtf32_kernel``: :func:`tf32_round` must be ``cvt.rna.tf32.f32``
(to nearest, ties away from zero, 13 low bits cleared), and the split
``big + small`` must give x back within 2^-22 |x|.

(b) The limits that ``chip_smoke.py`` holds the f32 forward to (elementwise
``FLASH_TOL["float32"]``, norm-relative ``FLASH_NORM_LIMIT["float32"]["o"]``,
lse within 1e-4) must take the kernel's arithmetic (the 3-term emulation)
and reject one TF32 product a step (the 1-term emulation, the wrong
variant of phases 6 and 9), read through the script's own ``readings`` /
``within`` at the two CPU shapes: [2, 4, 256, 64] causal and [1, 2, 384,
128] full.

(c) The port's f32 forward on CPU tensors (the plain twin that the kernel
is held against on the card) against the JAX package's f32 flash forward
in interpret mode, o within atol 1e-5 and lse within 1e-5 (summation order
only), at both head dims.

Inputs are made with numpy from a seed.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops import flash_attention as jfa
from pytorch_distributed_training_tpu_torch.ops import flash_attention as tfa
from pytorch_distributed_training_tpu_torch.tools import flash_checks as fc

REPO = Path(__file__).resolve().parents[1]
# (B, H, S, D, causal): chip_smoke's phase-6 f32 case and a D = 128 one
SHAPES = [(2, 4, 256, 64, True), (1, 2, 384, 128, False)]
SHAPE_IDS = ["2x4x256x64-causal", "1x2x384x128-full"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bits(value: int) -> torch.Tensor:
    return torch.tensor([value], dtype=torch.int64).to(torch.int32).view(torch.float32)


def _inputs(shape):
    b, h, s_len, d, _ = shape
    rng = np.random.default_rng(s_len + d)
    return [rng.normal(size=(b, s_len, h, d)).astype(np.float32) for _ in range(3)]


def _fold(x: np.ndarray) -> torch.Tensor:
    b, s_len, h, d = x.shape
    return torch.from_numpy(x).transpose(1, 2).reshape(b * h, s_len, d).contiguous()


# (bits in, bits out): the 13 dropped bits below, at and above half a TF32
# ulp, and a carry from the mantissa into the exponent
ROUNDINGS = [
    (0x3F800FFF, 0x3F800000),  # below half: down
    (0x3F801000, 0x3F802000),  # a tie: away from zero
    (0x3F803000, 0x3F804000),  # a tie with the kept bit set: still away
    (0x3F801001, 0x3F802000),  # above half: up
    (0x3F7FF000, 0x3F800000),  # up into the next power of two (1.0)
    (0x00000000, 0x00000000),  # zero
]


@pytest.mark.parametrize("sign", [0, 1], ids=["positive", "negative"])
@pytest.mark.parametrize("bits_in, bits_out", ROUNDINGS,
                         ids=[f"{a:08x}" for a, _ in ROUNDINGS])
def test_tf32_round_is_cvt_rna(bits_in, bits_out, sign):
    x = _bits(bits_in | sign << 31)
    want = _bits(bits_out | sign << 31)
    assert torch.equal(fc.tf32_round(x).view(torch.int32), want.view(torch.int32))


def test_tf32_round_passes_what_is_not_finite_and_takes_f32_only():
    x = torch.tensor([math.inf, -math.inf, math.nan])
    got = fc.tf32_round(x)
    assert got[0] == math.inf and got[1] == -math.inf and math.isnan(got[2].item())
    with pytest.raises(TypeError, match="float32"):
        fc.tf32_round(torch.zeros(2, dtype=torch.float64))


@pytest.mark.parametrize("scale", [1e-20, 1.0, 1e20])
def test_split_is_exact(scale):
    """big and small are TF32 (13 low bits zero), and big + small is x within
    2^-22 |x|, over f32 values of either sign and of 60 binades around
    ``scale`` (all normal, their remainders too)."""
    rng = np.random.default_rng(7)
    n = 200_000
    mag = (0.5 + np.abs(rng.normal(size=n))) * scale * 2.0 ** rng.integers(-30, 30, n)
    x = torch.from_numpy((np.sign(rng.normal(size=n)) * mag).astype(np.float32))
    big, small = fc.split_3xtf32(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    assert (big - x).abs().max() > 0  # the split did round


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_3xtf32_emulation_is_within_the_f32_limits(shape):
    cs = _chip_smoke()
    _, _, _, d, causal = shape
    q, k, v = (_fold(x) for x in _inputs(shape))
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, causal, d ** -0.5)
    o_e, lse_e = fc.flash_fwd_emulated(q, k, v, causal, d ** -0.5, terms=3)
    r = cs.readings(o_e, o_p, **cs.FLASH_TOL["float32"])
    assert cs.within(r, cs.FLASH_NORM_LIMIT["float32"]["o"]), r
    torch.testing.assert_close(lse_e, lse_p, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_1xtf32_emulation_exceeds_the_norm_limit(shape):
    """One TF32 product a step (the wrong variant of phases 6 and 9) reads
    outside the f32 norm limit, so a kernel that dropped the small products
    fails on the card; the check of phase 6 says so through ``judge``."""
    cs = _chip_smoke()
    _, _, _, d, causal = shape
    q, k, v = (_fold(x) for x in _inputs(shape))
    o_p, _ = tfa.flash_fwd_plain(q, k, v, causal, d ** -0.5)
    o_1, _ = fc.flash_fwd_emulated(q, k, v, causal, d ** -0.5, terms=1)
    r = cs.readings(o_1, o_p, **cs.FLASH_TOL["float32"])
    assert r["norm_rel"] > cs.FLASH_NORM_LIMIT["float32"]["o"] and not cs.within(r)
    checks = cs.tf32_checks(fc, q, k, v, causal, d ** -0.5, o_p, cs.FLASH_TOL["float32"],
                            cs.FLASH_NORM_LIMIT["float32"]["o"], "cpu")
    assert [sound for *_, sound in checks] == [None, False]
    cs.judge(checks)  # raises if the 1-term variant were within the limits


def test_emulation_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 128, 64)
    with pytest.raises(TypeError, match="float32"):
        fc.flash_fwd_emulated(x.bfloat16(), x.bfloat16(), x.bfloat16(), True, 0.125)
    with pytest.raises(ValueError, match="terms"):
        fc.flash_fwd_emulated(x, x, x, True, 0.125, terms=2)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_f32_forward_matches_jax(shape):
    """The JAX f32 flash forward (interpret mode, K2a at these S) against the
    port's ``flash_forward`` on CPU tensors: o and lse."""
    b, h, s_len, d, causal = shape
    assert jfa._resident_ok(s_len, d)
    q, k, v = _inputs(shape)
    jo, jlse = jfa.flash_attention_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=causal, interpret=True)
    to, tlse = tfa.flash_forward(_fold(q), _fold(k), _fold(v), causal, d ** -0.5)
    jo = np.asarray(jo).transpose(0, 2, 1, 3).reshape(b * h, s_len, d)
    jlse = np.asarray(jlse).transpose(0, 2, 1).reshape(b * h, s_len)
    np.testing.assert_allclose(to.numpy(), jo, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), jlse, atol=1e-5, rtol=0)


def test_f32_flash_bounds_at_the_lm_shape():
    """The bounds of the f32 forward at [8, 16, 2048, 64] causal: 0.4169 ms
    at the 3xTF32 rate, 1.0262 ms as FFMA (``PERF.md``'s kernel table), as
    ``chip_smoke.py`` computes them."""
    cs = _chip_smoke()
    flops = tfa.flash_flops(128, 2048, 64, causal=True)
    assert round(flops / fc.TF32X3_FLOPS * 1e3, 4) == 0.4169
    assert round(flops / fc.FFMA_FLOPS * 1e3, 4) == 1.0262
    assert cs.TF32X3_FLOPS == fc.TF32X3_FLOPS and cs.F32_FLOPS == fc.FFMA_FLOPS
    got = cs.flash_bound(tfa, 128, 2048, 64, torch.float32, True)
    assert got == dict(bound_ms=pytest.approx(0.41694, abs=1e-5), bound_by="operations",
                       ffma_bound_ms=pytest.approx(1.02616, abs=1e-5))
    bf16 = cs.flash_bound(tfa, 128, 2048, 64, torch.bfloat16, True)
    assert bf16["ffma_bound_ms"] is None and round(bf16["bound_ms"], 4) == 0.0695


SASS = """
        Function : _ZN12_GLOBAL__N_123flash_fwd_3xtf32_kernelILi64EEEvPKfS2_S2_PfS3_ifi
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0030*/                   LDS R8, [R2] ;
        /*0040*/                   IADD3 R9, R8, 0x1000, RZ ;
        /*0050*/                   LOP3.LUT R9, R9, 0xffffe000, RZ, 0xc0, !PT ;
        /*0060*/                   FADD R10, R8, -R9 ;
        /*0070*/                   HMMA.1688.F32.TF32 R12, R4, R9, R12 ;
        /*0080*/                   MUFU.EX2 R13, R13 ;
        /*0090*/               @P0 BRA 0x20 ;
        /*00a0*/                   NOP ;
        /*00b0*/                   STG.E.64 desc[UR4][R6.64], R12 ;
        /*00c0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_126flash_bwd_dq_3xtf32_kernelILi64EEEvPKfS2_S2_S2_S2_S2_Pfifi
        /*0000*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   HMMA.1688.F32.TF32 R12, R4, R9, R12 ;
        /*0030*/                   HMMA.1688.F32.TF32 R16, R4, R10, R16 ;
        /*0040*/               @P0 BRA 0x10 ;
        /*0050*/                   EXIT ;
"""


def test_sass_mix_counts_the_tile_loop_by_class():
    """``tools/flash_ab.py``'s SASS line: the loop runs from the backward
    branch's target (the barrier) to the branch; NOPs and other kernels are
    left out."""
    from pytorch_distributed_training_tpu_torch.tools import flash_ab

    got = flash_ab.sass_mix(SASS, "flash_fwd_3xtf32_kernel")
    assert got == {"flash_fwd_3xtf32_kernel<64>": dict(
        instructions=12, loop_instructions=8,
        loop_mix=dict(hmma=1, lds=1, mufu=1, int_alu=2, float_alu=1, cvt=0, other=2))}
    got = flash_ab.sass_mix(SASS, "flash_bwd_dq_3xtf32_kernel")
    assert got == {"flash_bwd_dq_3xtf32_kernel<64>": dict(
        instructions=6, loop_instructions=4,
        loop_mix=dict(hmma=2, lds=0, mufu=0, int_alu=0, float_alu=0, cvt=0, other=2))}


def test_chip_smoke_f32_runner_needs_a_card(monkeypatch, capsys):
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main(["--f32-runner"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
