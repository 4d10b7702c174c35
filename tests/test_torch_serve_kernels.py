"""The port's fused elementwise tails against the JAX package's.

The JAX functions run their Pallas kernels in interpret mode off the TPU
(``ops/fused_elementwise.py:76-77``), exactly as the JAX package's own tests
run them; the port's wrappers run their plain twins on CPU tensors (the
CUDA kernels themselves are held against those twins on the card by
``chip_smoke.py``).  Inputs come from numpy seeds and reach both sides as
the same values.

Tolerances: f32 ``y`` within 1e-5 (summation order of the LayerNorm
statistics, erf implementations); bf16 ``s`` bitwise equal (one rounding of
an f32 sum on both sides) and bf16 ``y`` within atol/rtol 8e-3, one bf16
ulp at |y| up to 4.
"""
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops import fused_elementwise as jfe
from pytorch_distributed_training_tpu_torch import kernels
from pytorch_distributed_training_tpu_torch.ops import fused_elementwise as tfe

REPO = Path(__file__).resolve().parent.parent

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(arr32: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = _DT[dtype]
    j = jnp.asarray(arr32).astype(jdt)
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(tdt)
    return j, t


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=8e-3, rtol=8e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,feat", [(1, 48), (37, 48), (16, 128)])
def test_add_layernorm_matches_jax(dtype, rows, feat):
    rng = np.random.default_rng(rows * 1000 + feat)
    x32 = rng.normal(size=(rows, feat)).astype(np.float32) * 2.0
    d32 = rng.normal(size=(rows, feat)).astype(np.float32)
    scale = (1.0 + 0.3 * rng.normal(size=feat)).astype(np.float32)
    bias = (0.1 * rng.normal(size=feat)).astype(np.float32)
    jx, tx = _pair(x32, dtype)
    jd, td = _pair(d32, dtype)
    js, jy = jfe.fused_add_layernorm(jx, jd, jnp.asarray(scale), jnp.asarray(bias))
    ts, ty = tfe.add_layernorm_plain(tx, td, torch.from_numpy(scale), torch.from_numpy(bias))
    assert ts.dtype == tx.dtype and ty.dtype == torch.float32  # JAX's promotion
    np.testing.assert_array_equal(_np(ts), np.asarray(js.astype(jnp.float32)))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=0)
    # the wrapper on CPU tensors IS the plain twin, and launches nothing
    tfe.reset_launch_counts()
    ws, wy = tfe.fused_add_layernorm(tx, td, torch.from_numpy(scale), torch.from_numpy(bias))
    assert torch.equal(ws, ts) and torch.equal(wy, ty)
    assert tfe.launch_counts() == {"add_layernorm": 0, "bias_gelu": 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,feat", [(1, 64), (37, 40), (8, 256)])
def test_bias_gelu_matches_jax(dtype, rows, feat):
    rng = np.random.default_rng(rows * 7 + feat)
    ju, tu = _pair(rng.normal(size=(rows, feat)).astype(np.float32) * 2.0, dtype)
    jb, tb = _pair(rng.normal(size=feat).astype(np.float32) * 0.5, dtype)
    jy = jfe.fused_bias_gelu(ju, jb)
    ty = tfe.bias_gelu_plain(tu, tb)
    assert ty.dtype == tu.dtype
    _close(_np(ty), np.asarray(jy.astype(jnp.float32)), dtype)
    assert torch.equal(tfe.fused_bias_gelu(tu, tb), ty)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_residual_layernorm_module_matches_jax(dtype):
    rng = np.random.default_rng(11)
    rows, feat = 37, 48
    jdt, tdt = _DT[dtype]
    jx, tx = _pair(rng.normal(size=(3, rows, feat)).astype(np.float32), dtype)
    jd, td = _pair(rng.normal(size=(3, rows, feat)).astype(np.float32), dtype)
    params = {
        "scale": (1.0 + 0.3 * rng.normal(size=feat)).astype(np.float32),
        "bias": (0.1 * rng.normal(size=feat)).astype(np.float32),
    }
    js, jy = jfe.FusedResidualLayerNorm(dtype=jdt).apply({"params": params}, jx, jd)
    mod = tfe.FusedResidualLayerNorm(feat, dtype=tdt)
    mod.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                         "bias": torch.from_numpy(params["bias"])})
    ts, ty = mod(tx, td)
    assert ts.dtype == tdt and ty.dtype == tdt
    np.testing.assert_array_equal(_np(ts), np.asarray(js.astype(jnp.float32)))
    _close(_np(ty), np.asarray(jy.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_gelu_module_matches_jax(dtype):
    rng = np.random.default_rng(12)
    feat, hidden = 32, 128
    jdt, tdt = _DT[dtype]
    jx, tx = _pair(rng.normal(size=(2, 5, feat)).astype(np.float32), dtype)
    params = {
        "kernel": (rng.normal(size=(feat, hidden)) / np.sqrt(feat)).astype(np.float32),
        "bias": (0.2 * rng.normal(size=hidden)).astype(np.float32),
    }
    jy = jfe.FusedDenseGelu(hidden=hidden, dtype=jdt).apply({"params": params}, jx)
    mod = tfe.FusedDenseGelu(feat, hidden, dtype=tdt)
    mod.load_state_dict({"weight": torch.from_numpy(params["kernel"].T.copy()),
                         "bias": torch.from_numpy(params["bias"])})
    ty = mod(tx)
    assert ty.dtype == tdt
    _close(_np(ty), np.asarray(jy.astype(jnp.float32)), dtype)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "args,kwargs,exc,match",
    [
        ((_meta((4, 8), torch.int32), _meta((4, 8), torch.int32),
          _meta(8, torch.float32), _meta(8, torch.float32)), {}, TypeError, "float32, bfloat16"),
        ((_meta((4, 8)), _meta((4, 8), torch.float16),
          _meta(8, torch.float32), _meta(8, torch.float32)), {}, ValueError, "share shape"),
        ((_meta((4, 8)), _meta((4, 8)), _meta(8), _meta(8)), {}, TypeError, "float32"),
        ((_meta((4, 8)), _meta((4, 8)), _meta(8, torch.float32),
          _meta(8, torch.float32)), {"out_dtype": torch.float16}, TypeError, "out_dtype"),
        ((_meta((2, 8200)), _meta((2, 8200)), _meta(8200, torch.float32),
          _meta(8200, torch.float32)), {}, ValueError, "8192"),
        ((_meta((8, 4)).t(), _meta((8, 4)).t(), _meta(8, torch.float32),
          _meta(8, torch.float32)), {}, ValueError, "contiguous"),
        ((_meta((4, 8)), _meta((4, 8)), _meta(8, torch.float32),
          _meta(8, torch.float32)), {}, ValueError, "CUDA"),
    ],
    ids=["int-dtype", "delta-mismatch", "bf16-params", "bad-out-dtype", "too-wide",
         "non-contiguous", "not-cuda"],
)
def test_add_layernorm_wrapper_raises_off_the_cpu(args, kwargs, exc, match):
    """Off the CPU the wrapper launches its kernel or raises: every input it
    does not take raises before any launch, never falls back."""
    with pytest.raises(exc, match=match):
        tfe.fused_add_layernorm(*args, **kwargs)


@pytest.mark.parametrize(
    "u,bias,exc,match",
    [
        (_meta((4, 8), torch.float64), _meta(8, torch.float64), TypeError, "float32, bfloat16"),
        (_meta((4, 8)), _meta(8, torch.float32), ValueError, "bias must be"),
        (_meta((8, 4)).t(), _meta(8), ValueError, "contiguous"),
        (_meta((4, 8)), _meta(8), ValueError, "CUDA"),
    ],
    ids=["f64", "bias-dtype", "non-contiguous", "not-cuda"],
)
def test_bias_gelu_wrapper_raises_off_the_cpu(u, bias, exc, match):
    with pytest.raises(exc, match=match):
        tfe.fused_bias_gelu(u, bias)


def test_traffic_bounds_count_each_byte_once():
    # K3 at the main path's prefill shape: x, delta read, s, y written in
    # bf16, plus the two f32 parameter rows
    assert tfe.add_layernorm_bytes(4096, 1024, torch.bfloat16, torch.bfloat16) == (
        4 * 4096 * 1024 * 2 + 2 * 1024 * 4
    )
    assert tfe.bias_gelu_bytes(4096, 4096, torch.bfloat16) == 2 * 4096 * 4096 * 2 + 4096 * 2


def test_c_signatures_match_the_source():
    """No compiler runs here: hold the ctypes argument lists against the
    exported C functions' parameter lists in the CUDA source."""
    for name, (src, fns) in kernels.SOURCES.items():
        text = (Path(kernels.CSRC_DIR) / src).read_text()
        exported = {
            m.group(1): [p for p in m.group(2).split(",") if p.strip()]
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text)
        }
        assert set(exported) == set(fns), name
        for fn, argtypes in fns.items():
            assert len(exported[fn]) == len(argtypes), fn


def test_build_recipe():
    path = kernels.library_path("fused_elementwise")
    assert path.startswith(kernels.BUILD_DIR) and path.endswith(".so")
    # keyed by the source's hash: the name is stable for unchanged sources
    assert kernels.library_path("fused_elementwise") == path
    cmd = kernels.nvcc_command("fused_elementwise", "/x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert "pytorch_distributed_training_tpu_torch/_build/" in (REPO / ".gitignore").read_text()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc present: this checks the message on machines without it")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
