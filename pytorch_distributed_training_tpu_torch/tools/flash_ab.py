"""The flash kernels of this tree against another checkout's, in one process on one card.

    git archive <commit> | tar -x -C run/parent       # the other tree
    python -m pytorch_distributed_training_tpu_torch.tools.flash_ab --parent run/parent \\
        [--dtype {bfloat16,float32}] [--shapes B,H,S,D[,causal|full] ...]

Builds ``<parent>/pytorch_distributed_training_tpu_torch/csrc/flash_attention.cu``
with this tree's nvcc flags beside this tree's library, and binds the C entry
points of both: the forward, and the backward as the split pair
(``pdt_flash_bwd_dkv`` / ``pdt_flash_bwd_dq``) where a library exports it, or
as the single ``pdt_flash_bwd`` of the first training slice otherwise.  For
each shape it checks both trees against the plain twins of
``ops/flash_attention.py`` (norm-relative error of o, dq, dk, dv; largest
|lse error|), then times each launch in turns (parent, this, this, parent)
within this one process: the forward, and dK/dV and dQ apart where both
trees have the split pair, the whole backward otherwise.  Each time is the
median of CUDA-event timings with the L2 flushed before each launch and a
spin kernel queued ahead of the start event, so that the events bracket
device work only (20 launches; 5 at S >= 32768).  Each time stands beside
its bound: bf16 at the bf16 tensor-core rate, f32 at the 3xTF32 one
(``tools/flash_checks.py``), with the bound of the same work as FFMA on the
CUDA cores beside it in f32 (``*_ffma_bound_ms``).  Prints the card's
``nvidia-smi`` name and power limit, then one JSON line per shape, then a
SASS line for this tree's library (``cuobjdump -sass``): for each f32
tensor-core kernel (the forward, dK/dV and dQ, ``SASS_KERNELS``), its
instructions and those of its tile loop, by class (HMMA, LDS, MUFU,
integer and float ALU, the rest).  Default shapes:
the two training paths' [8, 16, 2048, 64] and [2, 8, 32768, 64], causal,
and [2, 4, 512, 128] non-causal.  Needs one CUDA card and nvcc; exits 1
without a card, and 1 when this tree's kernels disagree with the twins
beyond ``chip_smoke.py``'s norm limits.
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
from .flash_checks import FFMA_FLOPS, TF32X3_FLOPS

DEFAULT_SHAPES = ("8,16,2048,64", "2,8,32768,64", "2,4,512,128,full")
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's clock: covers any host enqueue
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FLOPS_PER_S = {"bfloat16": 989e12, "float32": TF32X3_FLOPS}  # H100 SXM, dense
# chip_smoke.py's norm-relative limits of each kernel output against its twin
NORM_LIMIT = {"bfloat16": {"o": 3e-3, "dq": 1e-3, "dk": 1e-3, "dv": 1e-3},
              "float32": {"o": 1e-5, "dq": 1e-5, "dk": 1e-5, "dv": 1e-5}}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C signatures: this tree's, and the single backward of the first
# training slice (q, k, v, dout, lse, delta, dq, dk, dv, bh, seq, head_dim,
# scale, causal, dtype, stream)
SIGNATURES = dict(kernels.SOURCES["flash_attention"][1],
                  pdt_flash_bwd=[_P] * 9 + [_I, _I, _I, _F, _I, _I, _P])


def parse_shape(text: str):
    """``"B,H,S,D"`` or ``"B,H,S,D,causal"`` / ``"B,H,S,D,full"`` ->
    ``(B, H, S, D, causal)``; causal unless said otherwise."""
    parts = text.split(",")
    if len(parts) not in (4, 5) or (len(parts) == 5 and parts[4] not in ("causal", "full")):
        raise argparse.ArgumentTypeError(f"expected B,H,S,D[,causal|full], got {text!r}")
    try:
        b, h, s_len, d = (int(x) for x in parts[:4])
    except ValueError as exc:
        raise argparse.ArgumentTypeError(f"expected integers in {text!r}") from exc
    return b, h, s_len, d, len(parts) == 4 or parts[4] == "causal"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True, help="root of the other checkout")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--shapes", nargs="+", type=parse_shape,
                        default=[parse_shape(s) for s in DEFAULT_SHAPES],
                        metavar="B,H,S,D[,causal|full]")
    return parser.parse_args(argv)


def bind(lib) -> dict:
    """The entry points of a flash library by role: ``fwd`` and either
    ``dkv`` and ``dq`` (the split backward) or ``bwd`` (the single one),
    each with its argtypes set.  Raises ``RuntimeError`` on a library that
    has no forward or neither backward."""
    def has(name):
        return getattr(lib, name, None) is not None

    roles = {"fwd": "pdt_flash_fwd"}
    if has("pdt_flash_bwd_dkv") and has("pdt_flash_bwd_dq"):
        roles.update(dkv="pdt_flash_bwd_dkv", dq="pdt_flash_bwd_dq")
    elif has("pdt_flash_bwd"):
        roles["bwd"] = "pdt_flash_bwd"
    else:
        raise RuntimeError("the library exports neither pdt_flash_bwd_dkv with pdt_flash_bwd_dq "
                           "nor pdt_flash_bwd")
    if not has("pdt_flash_fwd"):
        raise RuntimeError("the library exports no pdt_flash_fwd")
    bound = {}
    for role, name in roles.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = SIGNATURES[name], ctypes.c_int
        bound[role] = fn
    return bound


def parent_build(parent: str):
    """Start nvcc on the parent's flash source; returns ``(process or None,
    library path)`` (None when that source was built before)."""
    src = os.path.join(parent, "pytorch_distributed_training_tpu_torch", "csrc",
                       "flash_attention.cu")
    with open(src, "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(kernels.NVCC_FLAGS).encode())
    out = os.path.join(kernels.BUILD_DIR, f"libflash_attention-parent-{digest.hexdigest()[:16]}.so")
    if os.path.isfile(out):
        return None, out
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out + ".tmp", src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def time_ms(torch, fn, flush, reps: int) -> float:
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


def measure(torch, fa, libs: dict, shape, dtype_name: str, gen, flush) -> dict:
    """One JSON row: both trees against the twins, then their times."""
    b, h, s_len, d, causal = shape
    dtype = getattr(torch, dtype_name)
    bh, scale, dev = b * h, 1.0 / d ** 0.5, flush.device
    code = 1 if dtype == torch.bfloat16 else 0
    stream = torch.cuda.current_stream().cuda_stream
    q, k, v, do = (torch.randn(bh, s_len, d, generator=gen, device=dev).to(dtype)
                   for _ in range(4))
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do.float() * o_p.float()).sum(-1)
    want = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_plain(q, k, v, do, lse_p, delta, causal,
                                                           scale)), o=o_p)
    common = (bh, s_len, d, scale, int(causal), code, stream)
    grads = (q, k, v, do, lse_p, delta)

    def launches(tree, lib, out):
        def run(role, *args):
            kernels.check(lib[role](*(t.data_ptr() for t in args), *common), f"{tree} {role}")

        fns = {"fwd": lambda: run("fwd", q, k, v, out["o"], out["lse"])}
        if "dkv" in lib:
            fns["dkv"] = lambda: run("dkv", *grads, out["dk"], out["dv"])
            fns["dq"] = lambda: run("dq", *grads, out["dq"])
            fns["bwd"] = lambda: (fns["dkv"](), fns["dq"]())
        else:
            fns["bwd"] = lambda: run("bwd", *grads, out["dq"], out["dk"], out["dv"])
        return fns

    calls, outs = {}, {}
    for tree, lib in libs.items():
        outs[tree] = {n: torch.empty_like(q) for n in ("o", "dq", "dk", "dv")}
        outs[tree]["lse"] = torch.empty_like(lse_p)
        calls[tree] = launches(tree, lib, outs[tree])
        calls[tree]["fwd"]()
        calls[tree]["bwd"]()
    torch.cuda.synchronize()

    def rel(a, c):
        return ((a.float() - c.float()).norm() / c.float().norm()).item()

    limit = NORM_LIMIT[dtype_name]
    row = dict(shape=[b, h, s_len, d], dtype=dtype_name, causal=causal,
               norm_rel_vs_twin={}, lse_max_abs_vs_twin={}, within_limits={})
    for tree, out in outs.items():
        errs = {n: rel(out[n], want[n]) for n in ("o", "dq", "dk", "dv")}
        row["norm_rel_vs_twin"][tree] = errs
        row["lse_max_abs_vs_twin"][tree] = (out["lse"] - lse_p).abs().max().item()
        row["within_limits"][tree] = all(errs[n] <= limit[n] for n in errs)
    parts = ("fwd", "dkv", "dq") if all("dkv" in f for f in calls.values()) else ("fwd", "bwd")
    reps = 5 if s_len >= 32768 else 20
    for part in parts:
        f_old, f_new = calls["parent"][part], calls["this"][part]
        t = [time_ms(torch, f, flush, reps) for f in (f_old, f_new, f_new, f_old)]
        row[f"{part}_ms"] = {"parent": [t[0], t[3]], "this": [t[1], t[2]]}
        row[f"{part}_speedup"] = (t[0] + t[3]) / (t[1] + t[2])
        launch = part if part in ("dkv", "dq") else None
        flops = fa.flash_flops(bh, s_len, d, causal, backward=part == "bwd", part=launch)
        nbytes = fa.flash_bytes(bh, s_len, d, dtype, backward=part == "bwd", part=launch)
        row[f"{part}_bound_ms"] = max(flops / FLOPS_PER_S[dtype_name],
                                      nbytes / HBM_BYTES_PER_S) * 1e3
        if dtype == torch.float32:
            row[f"{part}_ffma_bound_ms"] = max(flops / FFMA_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    return row


# the kernels of the SASS line: the f32 forward and dQ (loops over K/V
# tiles) and the f32 dK/dV (loop over Q/dO tiles)
SASS_KERNELS = ("flash_fwd_3xtf32_kernel", "flash_bwd_dkv_3xtf32_kernel",
                "flash_bwd_dq_3xtf32_kernel")
# SASS opcodes by class, for the mix of a kernel's loop
SASS_CLASSES = (("hmma", ("HMMA",)), ("lds", ("LDS",)), ("mufu", ("MUFU",)),
                ("int_alu", ("IADD3", "VIADD", "LOP3", "IMAD", "SHF", "LEA", "ISETP", "SEL")),
                ("float_alu", ("FADD", "FFMA", "FMUL", "FMNMX", "FSEL", "FSETP")),
                ("cvt", ("F2F", "F2FP", "I2F", "F2I")))


def sass_mix(text: str, name_part: str) -> dict:
    """For each kernel in ``cuobjdump -sass`` output ``text`` whose name holds
    ``name_part``: its instructions (NOPs left out), and those of its loop
    by class.  The loop runs from the target of the first backward branch
    after the kernel's first barrier (``BAR``) to that branch: the tile
    loop of a kernel whose only barrier heads the loop."""
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        if name_part not in name:
            continue
        ins = []
        for line in part.splitlines():
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)",
                          line)
            if m and not m.group(2).startswith("NOP"):
                ins.append((int(m.group(1), 16), m.group(2).split(".")[0], m.group(3)))
        bar = next((a for a, op, _ in ins if op == "BAR"), None)
        loop = []
        for addr, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" and bar is not None else None
            if target and addr > bar and int(target.group(1), 16) <= bar:
                loop = [o for a, o, _ in ins if int(target.group(1), 16) <= a <= addr]
                break
        counts = collections.Counter(loop)
        mix = {cls: sum(counts[o] for o in ops) for cls, ops in SASS_CLASSES}
        mix["other"] = len(loop) - sum(mix.values())
        arg = re.search(name_part + r"ILi(\d+)E", name)
        out[f"{name_part}<{arg.group(1)}>" if arg else name] = dict(
            instructions=len(ins), loop_instructions=len(loop), loop_mix=mix)
    return out


def sass_line(lib_path: str) -> dict:
    """The SASS line: :func:`sass_mix` of this tree's kernels named in
    ``SASS_KERNELS``, at each head dim."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    mix = {}
    for name in SASS_KERNELS:
        mix.update(sass_mix(text, name))
    return {"sass": mix}


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available; this tool runs on the card", file=sys.stderr)
        return 1
    from ..ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    proc, parent_path = parent_build(args.parent)
    libs = {"this": bind(kernels.library("flash_attention"))}
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's flash source:\n{log}")
        os.replace(parent_path + ".tmp", parent_path)
    libs["parent"] = bind(ctypes.CDLL(parent_path))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    agree = True
    for shape in args.shapes:
        row = measure(torch, fa, libs, shape, args.dtype, gen, flush)
        agree = agree and row["within_limits"]["this"]
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(sass_line(kernels.library_path("flash_attention"))), flush=True)
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
