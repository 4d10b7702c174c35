"""The phase-3 limits of ``chip_smoke.py`` for K3 (add+LayerNorm) and K4
(bias+GELU) on the CPU: every wrong kernel of
``tools/elementwise_checks.py`` lies outside them in the dtypes it names,
and a twin that sums the LayerNorm statistics in the warp kernel's order
(``add_layernorm_lane_order``) lies inside them, with ``s`` bitwise equal.
So the card check can fail, and fails only for a wrong kernel.

The readings are ``chip_smoke.py``'s own (``readings``, ``within``), with
``TOL`` and ``NORM_LIMIT`` of ``tools/elementwise_checks.py``.  Inputs are
made with numpy from a seed, at phase 3's scales: x ~ 2 N(0, 1), delta ~
N(0, 1), scale ~ 1 + 0.3 N(0, 1), bias ~ 0.1 N(0, 1); u ~ 2 N(0, 1), the
GELU bias ~ 0.5 N(0, 1).  Shapes: [37, 1000] (8-wide vectors, rows past
the last block of 8), [37, 1001] (ragged) and [8, 1024] (decode).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu_torch.ops import fused_elementwise as fe
from pytorch_distributed_training_tpu_torch.tools import elementwise_checks as ec

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(37, 1000), (37, 1001), (8, 1024)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _normal(rng, shape, scale=1.0, shift=0.0, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale + shift).to(dtype)


def _ln_inputs(shape, dtype):
    rng = np.random.default_rng(shape[0] * 10007 + shape[1])
    x, d = _normal(rng, shape, 2.0, dtype=dtype), _normal(rng, shape, dtype=dtype)
    return x, d, _normal(rng, shape[1], 0.3, 1.0), _normal(rng, shape[1], 0.1)


def _gelu_inputs(shape, dtype):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    return _normal(rng, shape, 2.0, dtype=dtype), _normal(rng, shape[1], 0.5, dtype=dtype)


def _cases(prefix):
    """(what, dtype, shape) for every wrong kernel whose name starts with
    ``prefix``, in each dtype that must reject it, at each shape it exists at."""
    out = []
    for what, dtypes in ec.REJECT_IN.items():
        if not what.startswith(prefix):
            continue
        for dtype in dtypes:
            for shape in SHAPES:
                if "rows past" in what and shape[0] % ec.ROWS_PER_BLOCK == 0:
                    continue
                out.append(pytest.param(what, dtype, shape, id=f"{what}-{dtype}-{shape}"))
    return out


def _rejected(cs, what, wrong, want, dtype):
    r = cs.readings(wrong, want, **ec.TOL[dtype])
    assert wrong.dtype == want.dtype and wrong.shape == want.shape
    assert not cs.within(r, ec.NORM_LIMIT[dtype]), (what, r)


@pytest.mark.parametrize("what, dtype, shape", _cases("K3"))
def test_wrong_add_layernorm_is_rejected(what, dtype, shape):
    cs = _chip_smoke()
    x, d, scale, bias = _ln_inputs(shape, DTYPES[dtype])
    _, want = fe.add_layernorm_plain(x, d, scale, bias, out_dtype=x.dtype)
    variants = dict(ec.add_layernorm_variants(x, d, scale, bias, out_dtype=x.dtype))
    _rejected(cs, what, variants[what], want, dtype)


@pytest.mark.parametrize("what, dtype, shape", _cases("K4"))
def test_wrong_bias_gelu_is_rejected(what, dtype, shape):
    cs = _chip_smoke()
    u, b = _gelu_inputs(shape, DTYPES[dtype])
    variants = dict(ec.bias_gelu_variants(u, b))
    _rejected(cs, what, variants[what], fe.bias_gelu_plain(u, b), dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lane_order_twin_is_inside_the_limits(dtype, shape):
    cs = _chip_smoke()
    x, d, scale, bias = _ln_inputs(shape, DTYPES[dtype])
    s, want = fe.add_layernorm_plain(x, d, scale, bias, out_dtype=x.dtype)
    s_lane, y_lane = ec.add_layernorm_lane_order(x, d, scale, bias, out_dtype=x.dtype)
    assert torch.equal(s_lane, s)
    r = cs.readings(y_lane, want, **ec.TOL[dtype])
    assert cs.within(r, ec.NORM_LIMIT[dtype]), r
    # the twin itself reads inside: the check can pass at all
    assert cs.within(cs.readings(want, want, **ec.TOL[dtype]), ec.NORM_LIMIT[dtype])


def test_every_named_variant_is_built():
    x, d, scale, bias = _ln_inputs((37, 1000), torch.float32)
    u, b = _gelu_inputs((37, 1000), torch.float32)
    built = [w for w, _ in ec.add_layernorm_variants(x, d, scale, bias)]
    built += [w for w, _ in ec.bias_gelu_variants(u, b)]
    assert built == list(ec.REJECT_IN)
    # 8 rows fill a block: no rows variant there
    x8, d8, s8, b8 = _ln_inputs((8, 1024), torch.float32)
    assert not any("rows past" in w for w, _ in ec.add_layernorm_variants(x8, d8, s8, b8))
