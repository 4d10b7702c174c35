"""K3 (add+LayerNorm) and K4 (bias+GELU) of this tree against another checkout's, in one process on one card.

    git archive <commit> | tar -x -C run/parent       # the other tree
    python -m pytorch_distributed_training_tpu_torch.tools.elementwise_ab --parent run/parent \\
        [--dtype {bfloat16,float32}] [--ln R,E ...] [--gelu R,E ...]

Builds ``<parent>/pytorch_distributed_training_tpu_torch/csrc/fused_elementwise.cu``
with this tree's nvcc flags beside this tree's library and binds the C entry
points of both (``pdt_add_layernorm``, ``pdt_bias_gelu``; their semantics are
the same in every tree).  For each shape it checks both trees against the
plain twins of ``ops/fused_elementwise.py`` (``s`` bitwise, ``y`` within the
limits of ``tools/elementwise_checks.py``), then times the launches in turns
(parent, this, this, parent) within this one process: the median of 20
CUDA-event timings, the L2 flushed before each launch and a spin kernel
queued ahead of the start event, so that the events bracket device work
only.  Beside them: the bound (bytes at 3.35 TB/s), each tree's share of
it, and torch's own two-call composition of the same function
(``F.layer_norm(x + d)``, ``F.gelu(u + b)``), timed the same way as a
yardstick only: the port never calls it.  Then the SASS of this tree's K4
(``cuobjdump -sass``): instructions a kernel, and for the 8-row, 8-wide
instantiation the instructions an element and the issue bound they set at
each K4 shape (132 SMs, 4 schedulers of 32 lanes each issuing one
instruction a clock, at ``nvidia-smi``'s maximum SM clock).

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line per
shape and one for the SASS.  Default shapes: the LM-1024 step's, serving's
prefill and decode ([16384|4096|8, 1024] for K3, [..., 4096] for K4).  Needs
one CUDA card and nvcc; exits 1 without a card, and 1 when this tree's
kernels disagree with the twins.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

from .. import kernels

DEFAULT_LN = ("16384,1024", "4096,1024", "8,1024")
DEFAULT_GELU = ("16384,4096", "4096,4096", "8,4096")
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's clock: covers any host enqueue
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
SMS, LANES_PER_CLOCK = 132, 4 * 32  # H100 SXM: 4 schedulers of one warp instruction a clock
ENTRY_POINTS = ("pdt_add_layernorm", "pdt_bias_gelu")
_DTYPE_CODES = {"float32": 0, "bfloat16": 1}
# the K4 instantiation of the LM and prefill shapes: bf16, 8 rows of one
# 8-wide vector a thread (mangled: bias_gelu_kernel<__nv_bfloat16, 8, 8>)
K4_MAIN = ("bias_gelu_kernel", "13__nv_bfloat16Li8ELi8E", 64)


def parse_shape(text: str):
    """``"R,E"`` -> ``(R, E)``, both positive."""
    try:
        r, e = (int(x) for x in text.split(","))
    except ValueError as exc:
        raise argparse.ArgumentTypeError(f"expected R,E (two integers), got {text!r}") from exc
    if r < 1 or e < 1:
        raise argparse.ArgumentTypeError(f"expected positive R,E, got {text!r}")
    return r, e


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True, help="root of the other checkout")
    parser.add_argument("--dtype", choices=tuple(_DTYPE_CODES), default="bfloat16")
    parser.add_argument("--ln", nargs="+", type=parse_shape,
                        default=[parse_shape(s) for s in DEFAULT_LN], metavar="R,E")
    parser.add_argument("--gelu", nargs="+", type=parse_shape,
                        default=[parse_shape(s) for s in DEFAULT_GELU], metavar="R,E")
    return parser.parse_args(argv)


def bind(lib) -> dict:
    """The two entry points of an elementwise library by name, each with
    this tree's argtypes.  Raises ``RuntimeError`` on a library without one."""
    missing = [n for n in ENTRY_POINTS if getattr(lib, n, None) is None]
    if missing:
        raise RuntimeError(f"the library exports no {', '.join(missing)}")
    bound = {}
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = kernels.SOURCES["fused_elementwise"][1][name], ctypes.c_int
        bound[name] = fn
    return bound


def parent_build(parent: str):
    """Start nvcc on the parent's elementwise source; returns ``(process or
    None, library path)`` (None when that source was built before)."""
    src = os.path.join(parent, "pytorch_distributed_training_tpu_torch", "csrc",
                       "fused_elementwise.cu")
    with open(src, "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(kernels.NVCC_FLAGS).encode())
    out = os.path.join(kernels.BUILD_DIR,
                       f"libfused_elementwise-parent-{digest.hexdigest()[:16]}.so")
    if os.path.isfile(out):
        return None, out
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out + ".tmp", src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def time_ms(torch, fn, flush, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def measure(torch, fe, ec, libs: dict, kernel: str, shape, dtype_name: str, gen, flush) -> dict:
    """One JSON row: both trees against the twin, then their times in turns
    beside the bound and torch's two-call composition."""
    import torch.nn.functional as F

    r, e = shape
    dtype = getattr(torch, dtype_name)
    dev, code = flush.device, _DTYPE_CODES[dtype_name]
    stream = torch.cuda.current_stream().cuda_stream

    def randn(*size, scale=1.0, shift=0.0, dt=dtype):
        return (torch.randn(*size, generator=gen, device=dev) * scale + shift).to(dt)

    if kernel == "add_layernorm":
        x, d = randn(r, e, scale=2.0), randn(r, e)
        scale, bias = randn(e, scale=0.3, shift=1.0, dt=torch.float32), randn(e, scale=0.1, dt=torch.float32)
        s_want, want = fe.add_layernorm_plain(x, d, scale, bias, out_dtype=dtype)
        outs = {tree: (torch.empty_like(x), torch.empty_like(x)) for tree in libs}

        def launch(tree):
            s, y = outs[tree]
            kernels.check(libs[tree]["pdt_add_layernorm"](
                x.data_ptr(), d.data_ptr(), scale.data_ptr(), bias.data_ptr(), s.data_ptr(),
                y.data_ptr(), r, e, 1e-6, code, code, stream), f"{tree} add_layernorm")

        sc, bi = scale.to(dtype), bias.to(dtype)
        torch_fn = lambda: F.layer_norm(x + d, (e,), sc, bi, 1e-6)  # noqa: E731
        nbytes = fe.add_layernorm_bytes(r, e, dtype, dtype)
    else:
        u, b = randn(r, e, scale=2.0), randn(e, scale=0.5)
        s_want, want = None, fe.bias_gelu_plain(u, b)
        outs = {tree: (None, torch.empty_like(u)) for tree in libs}

        def launch(tree):
            kernels.check(libs[tree]["pdt_bias_gelu"](
                u.data_ptr(), b.data_ptr(), outs[tree][1].data_ptr(), r, e, code, stream),
                f"{tree} bias_gelu")

        torch_fn = lambda: F.gelu(u + b)  # noqa: E731
        nbytes = fe.bias_gelu_bytes(r, e, dtype)
    for tree in libs:
        launch(tree)
    torch.cuda.synchronize()
    tol, limit = ec.TOL[dtype_name], ec.NORM_LIMIT[dtype_name]
    row = dict(kernel=kernel, shape=[r, e], dtype=dtype_name, norm_rel_vs_twin={},
               worst_vs_twin={}, within_limits={})
    for tree, (s, y) in outs.items():
        diff = (y.float() - want.float()).abs()
        worst = (diff / (tol["atol"] + tol["rtol"] * want.float().abs())).max().item()
        norm_rel = (diff.norm() / want.float().norm()).item()
        row["norm_rel_vs_twin"][tree], row["worst_vs_twin"][tree] = norm_rel, worst
        row["within_limits"][tree] = (worst <= 1.0 and norm_rel <= limit
                                      and (s is None or torch.equal(s, s_want)))
    t = [time_ms(torch, lambda tree=tree: launch(tree), flush)
         for tree in ("parent", "this", "this", "parent")]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    row.update(ms={"parent": [t[0], t[3]], "this": [t[1], t[2]]},
               speedup=(t[0] + t[3]) / (t[1] + t[2]), bound_ms=bound, bound_by="bytes",
               share_of_bound={"parent": 2 * bound / (t[0] + t[3]),
                               "this": 2 * bound / (t[1] + t[2])},
               torch_two_calls_ms=time_ms(torch, torch_fn, flush))
    return row


def sass_counts(lib_path: str) -> dict:
    """Instructions (NOPs left out) of each kernel in the library's SASS, by
    mangled name, with the MUFU (special function) count beside each."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            name = func.group(1)
            counts[name] = collections.Counter()
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and op and not op.group(1).startswith("NOP"):
            counts[name]["instructions"] += 1
            counts[name]["mufu"] += op.group(1).startswith("MUFU")
    return {n: dict(c) for n, c in counts.items()}


def sass_row(counts: dict, gelu_shapes, max_sm_mhz: float) -> dict:
    """The K4 SASS line: instructions of every elementwise kernel, and for
    the main instantiation its instructions an element (the whole function
    over the 64 elements a thread owns in one pass) and the issue bound at
    each K4 shape."""
    name, args, elements = K4_MAIN
    main = [n for n in counts if name in n and args in n]
    row = dict(sass={n: c for n, c in counts.items() if "kernel" in n})
    if main:
        per_element = counts[main[0]]["instructions"] / elements
        rate = SMS * LANES_PER_CLOCK * max_sm_mhz * 1e6
        row.update(k4_main=main[0], k4_instructions_per_element=per_element,
                   k4_issue_bound_ms={f"{r}x{e}": per_element * r * e / rate * 1e3
                                      for r, e in gelu_shapes},
                   max_sm_mhz=max_sm_mhz)
    return row


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("elementwise_ab: CUDA is not available; this tool runs on the card", file=sys.stderr)
        return 1
    from ..ops import fused_elementwise as fe
    from . import elementwise_checks as ec

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name, power, max_sm_mhz = (x.strip() for x in smi.split(","))
    print(f"{name}, {power} W", flush=True)
    proc, parent_path = parent_build(args.parent)
    libs = {"this": bind(kernels.library("fused_elementwise"))}
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's elementwise source:\n{log}")
        os.replace(parent_path + ".tmp", parent_path)
    libs["parent"] = bind(ctypes.CDLL(parent_path))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    agree = True
    for kernel, shapes in (("add_layernorm", args.ln), ("bias_gelu", args.gelu)):
        for shape in shapes:
            row = measure(torch, fe, ec, libs, kernel, shape, args.dtype, gen, flush)
            agree = agree and row["within_limits"]["this"]
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    counts = sass_counts(kernels.library_path("fused_elementwise"))
    print(json.dumps(sass_row(counts, args.gelu, float(max_sm_mhz))), flush=True)
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
