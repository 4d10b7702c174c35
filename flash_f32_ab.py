#!/usr/bin/env python3
"""The f32 flash kernels of this tree against another checkout's, on one card.

    git archive <commit> | tar -x -C run/parent       # the other tree
    python3 flash_f32_ab.py --parent run/parent

Builds ``<parent>/pytorch_distributed_training_tpu_torch/csrc/flash_attention.cu``
with this tree's nvcc flags beside this tree's library, checks that both
agree with the plain twin, then times the f32 forward and the whole f32
backward (every launch of one backward) of each at [B, H, S, D] = [2, 4,
256, 64], [8, 16, 2048, 64] and [2, 8, 32768, 64], causal, in turns
(parent, this, this, parent) within this one process.  Each time is the
median of CUDA-event timings with the L2 flushed before each launch (20
launches; 3 at S = 32768) and a spin kernel queued ahead of the start event.
Prints the card's ``nvidia-smi`` name and power limit and one JSON line per
shape.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

SHAPES = ((2, 4, 256, 64), (8, 16, 2048, 64), (2, 8, 32768, 64))
SPIN_CYCLES = 2_000_000


def build_parent(parent: str, kernels) -> ctypes.CDLL:
    src = os.path.join(parent, "pytorch_distributed_training_tpu_torch", "csrc",
                       "flash_attention.cu")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    out = os.path.join(kernels.BUILD_DIR, "libflash_attention-parent.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pdt_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, f, i, i, p]
    lib.pdt_flash_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, f, i, i, p]
    lib.pdt_flash_fwd.restype = lib.pdt_flash_bwd.restype = ctypes.c_int
    return lib


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True, help="root of the other checkout")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_f32_ab: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 1
    from pytorch_distributed_training_tpu_torch import kernels
    from pytorch_distributed_training_tpu_torch.ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    kernels.build(["flash_attention"])
    old = build_parent(args.parent, kernels)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for b, h, s_len, d in SHAPES:
        bh, scale = b * h, 1.0 / d ** 0.5
        q, k, v, do = (torch.randn(bh, s_len, d, generator=gen, device=dev) for _ in range(4))
        o_p, lse = fa.flash_fwd_plain(q, k, v, True, scale)
        delta = (do * o_p).sum(-1)
        o_old, lse_old = torch.empty_like(q), torch.empty_like(lse)
        g_old = [torch.empty_like(q) for _ in range(3)]

        def old_fwd():
            err = old.pdt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o_old.data_ptr(),
                                    lse_old.data_ptr(), bh, s_len, d, scale, 1, 0, stream)
            kernels.check(err, "parent flash forward")

        def old_bwd():
            err = old.pdt_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                    lse.data_ptr(), delta.data_ptr(),
                                    *(t.data_ptr() for t in g_old), bh, s_len, d, scale, 1, 0,
                                    stream)
            kernels.check(err, "parent flash backward")

        def new_fwd():
            return fa.flash_forward(q, k, v, True, scale)

        def new_bwd():
            return fa.flash_backward(q, k, v, do, lse, delta, True, scale)

        old_fwd()
        old_bwd()
        o_new = new_fwd()[0]
        g_new = new_bwd()
        g_p = fa.flash_bwd_plain(q, k, v, do, lse, delta, True, scale)
        torch.cuda.synchronize()

        def rel(a, c):
            return ((a - c).norm() / c.norm()).item()

        row = dict(shape=[b, h, s_len, d], dtype="float32", causal=True,
                   norm_rel_vs_twin={"parent": [rel(o_old, o_p)] + [rel(a, c) for a, c in
                                                                     zip(g_old, g_p)],
                                     "this": [rel(o_new, o_p)] + [rel(a, c) for a, c in
                                                                  zip(g_new, g_p)]})
        reps = 3 if s_len >= 32768 else 20
        for what, (f_old, f_new) in (("fwd", (old_fwd, new_fwd)), ("bwd", (old_bwd, new_bwd))):
            t = [time_ms(torch, f, flush, reps) for f in (f_old, f_new, f_new, f_old)]
            row[f"{what}_ms"] = {"parent": [t[0], t[3]], "this": [t[1], t[2]]}
        print(json.dumps(row), flush=True)
        del q, k, v, do, o_p, o_old, g_old, o_new, g_new, g_p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
