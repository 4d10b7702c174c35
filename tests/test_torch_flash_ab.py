"""The flash A/B tool of the port (``tools/flash_ab.py``) on the CPU: which
backward it binds in a library, its arguments, and its refusal to run
without a card.  The libraries here are stand-ins that expose (or lack)
the C entry points by name, as ``ctypes.CDLL`` does."""
import argparse
import ctypes
import types

import pytest

from pytorch_distributed_training_tpu_torch.tools import flash_ab


def fake_lib(*names):
    lib = types.SimpleNamespace()
    for name in names:
        setattr(lib, name, lambda *args: 0)
    return lib


def test_binds_the_split_pair_when_the_library_exports_it():
    lib = fake_lib("pdt_flash_fwd", "pdt_flash_bwd_dkv", "pdt_flash_bwd_dq", "pdt_flash_bwd")
    bound = flash_ab.bind(lib)
    assert set(bound) == {"fwd", "dkv", "dq"}
    assert bound["dkv"] is lib.pdt_flash_bwd_dkv and bound["dq"] is lib.pdt_flash_bwd_dq
    # q, k, v, dout, lse, delta, dk, dv, then bh, seq, head_dim, scale,
    # causal, dtype, stream
    assert len(bound["dkv"].argtypes) == 15 and len(bound["dq"].argtypes) == 14
    assert bound["fwd"].argtypes[8] is ctypes.c_float
    assert all(fn.restype is ctypes.c_int for fn in bound.values())


def test_binds_the_single_backward_of_an_older_library():
    lib = fake_lib("pdt_flash_fwd", "pdt_flash_bwd")
    bound = flash_ab.bind(lib)
    assert set(bound) == {"fwd", "bwd"}
    argtypes = bound["bwd"].argtypes
    assert argtypes[:9] == [ctypes.c_void_p] * 9 and argtypes[12] is ctypes.c_float
    assert len(argtypes) == 16


@pytest.mark.parametrize("names", [("pdt_flash_fwd",),
                                   ("pdt_flash_fwd", "pdt_flash_bwd_dkv"),
                                   ("pdt_flash_bwd_dkv", "pdt_flash_bwd_dq")],
                         ids=["no backward", "half the split pair", "no forward"])
def test_raises_on_a_library_without_the_entry_points(names):
    with pytest.raises(RuntimeError):
        flash_ab.bind(fake_lib(*names))


def test_arguments_default_to_bf16_and_the_main_paths_shapes():
    args = flash_ab.parse_args(["--parent", "run/parent"])
    assert args.parent == "run/parent" and args.dtype == "bfloat16"
    assert args.shapes == [(8, 16, 2048, 64, True), (2, 8, 32768, 64, True),
                           (2, 4, 512, 128, False)]


def test_arguments_parse_dtype_and_shapes():
    args = flash_ab.parse_args(["--parent", "p", "--dtype", "float32", "--shapes",
                                "1,2,256,64", "2,4,512,128,full", "1,8,4096,128,causal"])
    assert args.dtype == "float32"
    assert args.shapes == [(1, 2, 256, 64, True), (2, 4, 512, 128, False),
                           (1, 8, 4096, 128, True)]


@pytest.mark.parametrize("text", ["1,2,256", "1,2,256,64,sometimes", "a,2,256,64"])
def test_bad_shapes_are_refused(text):
    with pytest.raises(argparse.ArgumentTypeError):
        flash_ab.parse_shape(text)
    with pytest.raises(SystemExit):
        flash_ab.parse_args(["--parent", "p", "--shapes", text])


def test_bad_dtype_is_refused():
    with pytest.raises(SystemExit):
        flash_ab.parse_args(["--parent", "p", "--dtype", "float16"])


@pytest.mark.parametrize("parent, parts", [
    (("pdt_flash_fwd", "pdt_flash_bwd_dkv", "pdt_flash_bwd_dq"), ("fwd", "dkv", "dq")),
    (("pdt_flash_fwd", "pdt_flash_bwd"), ("fwd", "bwd")),
], ids=["split parent", "single-backward parent"])
def test_times_each_launch_only_where_both_trees_split_the_backward(monkeypatch, parent, parts):
    import torch

    from pytorch_distributed_training_tpu_torch.ops import flash_attention as fa

    launched = []

    def entry(role):
        return lambda *args: launched.append(role) or 0

    def lib(*names):
        return flash_ab.bind(types.SimpleNamespace(**{n: entry(n) for n in names}))

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(flash_ab, "time_ms", lambda torch, fn, flush, reps: (fn(), 1.0)[1])
    libs = {"this": lib("pdt_flash_fwd", "pdt_flash_bwd_dkv", "pdt_flash_bwd_dq"),
            "parent": lib(*parent)}
    row = flash_ab.measure(torch, fa, libs, (1, 2, 256, 64, True), "bfloat16",
                           torch.Generator().manual_seed(0), torch.empty(16, dtype=torch.uint8))
    assert [k[:-3] for k in row if k.endswith("_ms") and "bound" not in k] == list(parts)
    for part in parts:
        assert row[f"{part}_ms"] == {"parent": [1.0, 1.0], "this": [1.0, 1.0]}
        assert row[f"{part}_speedup"] == 1.0 and row[f"{part}_bound_ms"] > 0
    assert set(row["norm_rel_vs_twin"]) == {"this", "parent"}
    if "bwd" in parts:  # one check launch and two timed turns; this tree's are its two launches
        assert launched.count("pdt_flash_bwd") == 3
        assert launched.count("pdt_flash_bwd_dkv") == launched.count("pdt_flash_bwd_dq") == 3


def test_main_returns_1_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert flash_ab.main(["--parent", "does-not-exist"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


SASS_TWO_KERNELS = """
        Function : _ZN12_GLOBAL__N_127flash_bwd_dkv_3xtf32_kernelILi64EEEvPKfS2_S2_S2_S2_S2_PfS3_ifi
        /*0000*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;
        /*0010*/                   LDG.E.128 R8, desc[UR4][R6.64] ;
        /*0020*/                   LDGDEPBAR ;
        /*0030*/                   DEPBAR.LE SB0, 0x0 ;
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0050*/                   LDS R8, [R2] ;
        /*0060*/                   HMMA.1688.F32.TF32 R12, R4, R9, R12 ;
        /*0070*/                   HMMA.1688.F32.TF32 R16, R4, R10, R16 ;
        /*0080*/                   FADD R20, R12, R16 ;
        /*0090*/               @P0 BRA 0x30 ;
        /*00a0*/                   STG.E.64 desc[UR4][R6.64], R12 ;
        /*00b0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_123flash_fwd_3xtf32_kernelILi128EEEvPKfS2_S2_PfS3_ifi
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0010*/                   HMMA.1688.F32.TF32 R12, R4, R9, R12 ;
        /*0020*/               @P0 BRA 0x0 ;
        /*0030*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_126flash_bwd_dq_3xtf32_kernelILi128EEEvPKfS2_S2_S2_S2_S2_Pfifi
        /*0000*/                   LDG.E.128 R8, desc[UR4][R6.64] ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   LDS R8, [R2] ;
        /*0030*/                   HMMA.1688.F32.TF32 R12, R4, R9, R12 ;
        /*0040*/                   HMMA.1688.F32.TF32 R16, R4, R10, R16 ;
        /*0050*/                   HMMA.1688.F32.TF32 R20, R4, R11, R20 ;
        /*0060*/                   MUFU.EX2 R13, R13 ;
        /*0070*/               @P0 BRA 0x10 ;
        /*0080*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_112ce_fwd_kernelEPKfPKlPfS3_ii
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0010*/               @P0 BRA 0x0 ;
        /*0020*/                   EXIT ;
"""


def test_sass_line_covers_the_f32_forward_and_dkv(monkeypatch):
    """The SASS line names the three f32 tensor-core kernels (forward,
    dK/dV, dQ) at their head dims, each with its tile loop's HMMA count;
    a kernel that is not one of them is left out."""
    monkeypatch.setattr(flash_ab.kernels, "_nvcc", lambda: "/toolkit/bin/nvcc")
    seen = []

    def run(cmd, **kwargs):
        seen.append(cmd)
        return types.SimpleNamespace(stdout=SASS_TWO_KERNELS)

    monkeypatch.setattr(flash_ab.subprocess, "run", run)
    got = flash_ab.sass_line("lib.so")["sass"]
    assert seen == [["/toolkit/bin/cuobjdump", "-sass", "lib.so"]]
    assert set(got) == {"flash_fwd_3xtf32_kernel<128>", "flash_bwd_dkv_3xtf32_kernel<64>",
                        "flash_bwd_dq_3xtf32_kernel<128>"}
    dkv = got["flash_bwd_dkv_3xtf32_kernel<64>"]
    assert dkv["instructions"] == 12 and dkv["loop_instructions"] == 7
    assert dkv["loop_mix"] == dict(hmma=2, lds=1, mufu=0, int_alu=0, float_alu=1, cvt=0, other=3)
    assert got["flash_fwd_3xtf32_kernel<128>"]["loop_mix"]["hmma"] == 1
    dq = got["flash_bwd_dq_3xtf32_kernel<128>"]
    assert dq["instructions"] == 9 and dq["loop_instructions"] == 7
    assert dq["loop_mix"] == dict(hmma=3, lds=1, mufu=1, int_alu=0, float_alu=0, cvt=0, other=2)
