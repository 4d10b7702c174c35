"""The elementwise A/B tool of the port (``tools/elementwise_ab.py``) on the
CPU: which entry points it binds in a library, its arguments, the order of
its timed turns, its reading of a SASS listing, and its refusal to run
without a card.  The libraries here are stand-ins that expose (or lack)
the C entry points by name, as ``ctypes.CDLL`` does."""
import argparse
import ctypes
import types

import pytest
import torch

from pytorch_distributed_training_tpu_torch.ops import fused_elementwise as fe
from pytorch_distributed_training_tpu_torch.tools import elementwise_ab as ab
from pytorch_distributed_training_tpu_torch.tools import elementwise_checks as ec


def fake_lib(*names, log=None, tag=None):
    lib = types.SimpleNamespace()
    for name in names:
        setattr(lib, name, lambda *args, name=name: (log.append((tag, name)) if log is not None
                                                     else None) or 0)
    return lib


def test_binds_both_entry_points_with_this_trees_signatures():
    bound = ab.bind(fake_lib("pdt_add_layernorm", "pdt_bias_gelu", "pdt_other"))
    assert set(bound) == {"pdt_add_layernorm", "pdt_bias_gelu"}
    # x, delta, scale, bias, s, y, rows, features, eps, dtype, out_dtype, stream
    assert len(bound["pdt_add_layernorm"].argtypes) == 12
    assert bound["pdt_add_layernorm"].argtypes[8] is ctypes.c_float
    assert len(bound["pdt_bias_gelu"].argtypes) == 7
    assert all(fn.restype is ctypes.c_int for fn in bound.values())


@pytest.mark.parametrize("names", [("pdt_add_layernorm",), ("pdt_bias_gelu",), ()],
                         ids=["no bias_gelu", "no add_layernorm", "neither"])
def test_raises_on_a_library_without_the_entry_points(names):
    with pytest.raises(RuntimeError, match="exports no"):
        ab.bind(fake_lib(*names))


def test_arguments_default_to_bf16_and_the_main_paths_shapes():
    args = ab.parse_args(["--parent", "run/parent"])
    assert args.parent == "run/parent" and args.dtype == "bfloat16"
    assert args.ln == [(16384, 1024), (4096, 1024), (8, 1024)]
    assert args.gelu == [(16384, 4096), (4096, 4096), (8, 4096)]


def test_arguments_parse_dtype_and_shapes():
    args = ab.parse_args(["--parent", "p", "--dtype", "float32", "--ln", "37,1001",
                          "--gelu", "8,4096", "37,1000"])
    assert args.dtype == "float32" and args.ln == [(37, 1001)]
    assert args.gelu == [(8, 4096), (37, 1000)]


@pytest.mark.parametrize("text", ["16384", "1,2,3", "a,1024", "0,1024", "8,-1"])
def test_bad_shapes_are_refused(text):
    with pytest.raises(argparse.ArgumentTypeError):
        ab.parse_shape(text)
    with pytest.raises(SystemExit):
        ab.parse_args(["--parent", "p", "--ln", text])


def test_bad_dtype_is_refused():
    with pytest.raises(SystemExit):
        ab.parse_args(["--parent", "p", "--dtype", "float16"])


@pytest.mark.parametrize("kernel, entry", [("add_layernorm", "pdt_add_layernorm"),
                                           ("bias_gelu", "pdt_bias_gelu")])
def test_checks_both_trees_then_times_them_in_turns(monkeypatch, kernel, entry):
    log = []
    libs = {tree: ab.bind(fake_lib(*ab.ENTRY_POINTS, log=log, tag=tree))
            for tree in ("this", "parent")}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ab, "time_ms", lambda torch, fn, flush, reps=20: (fn(), 2.0)[1])
    row = ab.measure(torch, fe, ec, libs, kernel, (8, 64), "bfloat16",
                     torch.Generator().manual_seed(0), torch.empty(16, dtype=torch.uint8))
    # one check launch a tree, then the turns parent, this, this, parent
    assert log == [(t, entry) for t in ("this", "parent", "parent", "this", "this", "parent")]
    assert row["ms"] == {"parent": [2.0, 2.0], "this": [2.0, 2.0]} and row["speedup"] == 1.0
    assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    assert row["torch_two_calls_ms"] == 2.0
    # the stand-ins write nothing: the outputs are not the twin's
    assert set(row["within_limits"]) == {"this", "parent"}


SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_116bias_gelu_kernelI13__nv_bfloat16Li8ELi8EEEvPKT_S4_PS2_ii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   MUFU.EX2 R5, R4 ;
        /*0020*/              @!P0 BRA `(.L_x_1) ;
        /*0030*/                   NOP ;
        /*0040*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_120add_layernorm_kernelIffLi32ELi8EEEvPKT_S3_PKfS5_PS1_PT0_iif
        /*0000*/                   SHFL.BFLY PT, R3, R2, 0x10, 0x1f ;
        /*0010*/                   EXIT ;
"""


def test_sass_counts_and_the_issue_bound(monkeypatch):
    monkeypatch.setattr(ab.kernels, "_nvcc", lambda: "/cuda/bin/nvcc")
    seen = []

    def run(cmd, **kwargs):
        seen.append(cmd)
        return types.SimpleNamespace(stdout=SASS)

    monkeypatch.setattr(ab.subprocess, "run", run)
    counts = ab.sass_counts("lib.so")
    assert seen == [["/cuda/bin/cuobjdump", "-sass", "lib.so"]]
    gelu, ln = counts
    assert counts[gelu] == {"instructions": 4, "mufu": 1}  # the NOP is left out
    assert counts[ln] == {"instructions": 2, "mufu": 0}
    row = ab.sass_row(counts, [(16384, 4096)], 1980.0)
    assert row["k4_main"] == gelu and row["k4_instructions_per_element"] == 4 / 64
    want = 4 / 64 * 16384 * 4096 / (132 * 128 * 1980e6) * 1e3
    assert row["k4_issue_bound_ms"]["16384x4096"] == pytest.approx(want)


def test_main_returns_1_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ab.main(["--parent", "does-not-exist"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
