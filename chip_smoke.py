#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``pytorch_distributed_training_tpu_torch``).

    python3 chip_smoke.py              # needs one CUDA card
    python3 chip_smoke.py --profile    # also: a torch.profiler breakdown of one batch

Phases, in order; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build every hand-written kernel from ``csrc/`` with nvcc for sm_90a;
3. each kernel against its plain PyTorch twin on the card, at the main path's
   shapes and a ragged one, with the time of each (CUDA events, median of
   20 launches after warm-up, L2 flushed before each) beside its bound;
   inputs the kernels do not take must raise;
4. the model at full width (depth 2, float32, TF32 off) on the card with the
   kernels against the same weights on the CPU with the plain twins:
   prefill and one decode step's logits;
5. the main path: ``InferenceEngine.from_config`` on the full-width config
   (TransformerLM 1024 wide, 16 blocks, 32768 tokens, bf16, fused tails),
   ``warmup()``, then 16 requests with seeded prompt lengths in [1, 512];
   every request generates 32 tokens in range, and each kernel launched
   exactly 16 x (1 + 31) = 512 times per batch.

The line before the last lists every kernel with its TPU counterpart, its
launches on the main path, its error against the plain twin, and its
times.  The last line is ``{"ok": true, "device": {...}}``.  With no card
the script prints no result and exits 1.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's 1.98 GHz: covers any host enqueue
CONFIG = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "pytorch_distributed_training_tpu_torch", "configs", "serve-lm-1024.yml",
)
SOURCE = "pytorch_distributed_training_tpu_torch/csrc/fused_elementwise.cu"
TPU_KERNELS = {
    "add_layernorm": ("K3", "pytorch_distributed_training_tpu/ops/fused_elementwise.py:88"),
    "bias_gelu": ("K4", "pytorch_distributed_training_tpu/ops/fused_elementwise.py:203"),
}
# arithmetic per element, for the operations bound: add, two reductions
# (sum, sum of squares), centre, scale by rstd, affine / add, scale,
# erf, add, two products
FLOPS_PER_ELEMENT = {"add_layernorm": 8, "bias_gelu": 6}


def say(*parts) -> None:
    print(*parts, flush=True)


def bound(name: str, nbytes: int, elements: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_ELEMENT[name] * elements / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, flush, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each after the
    L2 cache was flushed by writing a buffer larger than it.  A spin kernel
    queued ahead of the start event keeps the device busy while the host
    enqueues ``fn``, so the events bracket device work only, not the
    wrapper's Python."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def call_ms(torch, fn, calls: int = 50) -> float:
    """Host wall time per call of ``fn``, back to back, synchronised once at
    the end: what a caller's thread spends per call when the device keeps
    up (the decode loop's regime)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def expect_raise(exc, fn, what: str) -> None:
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"{what}: expected {exc.__name__}")


def phase_kernels(torch, fe):
    """Phase 3: each kernel against its plain twin; returns per-kernel rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = {"add_layernorm": [], "bias_gelu": []}

    def randn(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        tol = dict(atol=1e-5, rtol=0.0) if dtype == torch.float32 else dict(atol=2e-2, rtol=1e-2)
        for r, e in ((4096, 1024), (8, 1024), (37, 1000)):
            x, d = randn((r, e), dtype, 2.0), randn((r, e), dtype)
            scale, bias = randn(e, torch.float32, 0.3, 1.0), randn(e, torch.float32, 0.1)
            s_k, y_k = fe.fused_add_layernorm(x, d, scale, bias, out_dtype=dtype)
            s_p, y_p = fe.add_layernorm_plain(x, d, scale, bias, out_dtype=dtype)
            torch.cuda.synchronize()
            if not torch.equal(s_k, s_p):
                raise AssertionError(f"add_layernorm {r}x{e} {dtype}: s not bitwise equal")
            torch.testing.assert_close(y_k.float(), y_p.float(), **tol)
            err = (y_k.float() - y_p.float()).abs().max().item()
            kernel = lambda: fe.fused_add_layernorm(x, d, scale, bias, out_dtype=dtype)  # noqa: E731
            k_ms, c_ms = time_ms(torch, kernel, flush), call_ms(torch, kernel)
            p_ms = time_ms(torch, lambda: fe.add_layernorm_plain(x, d, scale, bias, out_dtype=dtype), flush)
            b_ms, b_by = bound("add_layernorm", fe.add_layernorm_bytes(r, e, dtype, dtype), r * e)
            rows["add_layernorm"].append(dict(
                shape=[r, e], dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, call_ms=c_ms))
        for r, h in ((4096, 4096), (8, 4096), (37, 1000)):
            u, b = randn((r, h), dtype, 2.0), randn(h, dtype, 0.5)
            y_k = fe.fused_bias_gelu(u, b)
            y_p = fe.bias_gelu_plain(u, b)
            torch.cuda.synchronize()
            torch.testing.assert_close(y_k.float(), y_p.float(), **tol)
            err = (y_k.float() - y_p.float()).abs().max().item()
            kernel = lambda: fe.fused_bias_gelu(u, b)  # noqa: E731
            k_ms, c_ms = time_ms(torch, kernel, flush), call_ms(torch, kernel)
            p_ms = time_ms(torch, lambda: fe.bias_gelu_plain(u, b), flush)
            b_ms, b_by = bound("bias_gelu", fe.bias_gelu_bytes(r, h, dtype), r * h)
            rows["bias_gelu"].append(dict(
                shape=[r, h], dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, call_ms=c_ms))
    for name, cases in rows.items():
        for c in cases:
            say(f"  {name} {c['shape']} {c['dtype']}: kernel_ms={c['ms']} "
                f"plain_ms={c['plain_ms']} bound_ms={c['bound_ms']} ({c['bound_by']}) "
                f"call_ms={c['call_ms']} max_abs_err={c['max_abs_err']}")
    # what the kernels do not take raises; nothing falls back to the plain twin
    x = torch.zeros(4, 64, device=dev, dtype=torch.float64)
    p32 = torch.ones(64, device=dev)
    expect_raise(TypeError, lambda: fe.fused_add_layernorm(x, x, p32, p32), "add_layernorm f64")
    xb = torch.zeros(4, 64, device=dev, dtype=torch.bfloat16)
    expect_raise(ValueError, lambda: fe.fused_add_layernorm(xb, xb, p32.cpu(), p32.cpu()),
                 "add_layernorm params on the CPU")
    expect_raise(TypeError, lambda: fe.fused_bias_gelu(x, x[0]), "bias_gelu f64")
    expect_raise(ValueError, lambda: fe.fused_bias_gelu(xb, xb[0].cpu()), "bias_gelu bias on the CPU")
    say("  wrong dtype / wrong device raise: ok")
    del flush
    return rows


def phase_model_vs_cpu(torch, fe):
    """Phase 4: full width, depth 2, f32: card (kernels) vs CPU (plain)."""
    from pytorch_distributed_training_tpu_torch.models import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"  allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    cpu = TransformerLM(32768, max_len=2048, embed_dim=1024, depth=2, num_heads=16,
                        fused_tails=True).eval()
    cpu.reset_parameters(torch.Generator().manual_seed(1))
    gpu = TransformerLM(32768, max_len=2048, embed_dim=1024, depth=2, num_heads=16,
                        fused_tails=True).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.cuda()
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, 32768, (2, 64), generator=gen)
    nxt = torch.randint(0, 32768, (2, 1), generator=gen)
    pos = torch.tensor([64, 64])
    before = fe.launch_counts()
    worst = 0.0
    with torch.inference_mode():
        c_cache, g_cache = cpu.new_cache(2), gpu.new_cache(2)
        c_pre, c_cache = cpu(tokens, c_cache)
        g_pre, g_cache = gpu(tokens.cuda(), g_cache)
        c_cache.live_len = g_cache.live_len = 65
        c_step, _ = cpu(nxt, c_cache, pos)
        g_step, _ = gpu(nxt.cuda(), g_cache, pos.cuda())
        for what, c, g in (("prefill", c_pre, g_pre), ("decode step", c_step, g_step)):
            g = g.cpu()
            if not torch.isfinite(g).all():
                raise AssertionError(f"{what}: non-finite logits on the card")
            err = (g - c).abs().max().item()
            say(f"  {what} logits {tuple(g.shape)}: max |card - cpu| = {err:.3g}")
            torch.testing.assert_close(g, c, atol=2e-3, rtol=0.0)
            worst = max(worst, err)
    after = fe.launch_counts()
    if any(after[k] - before[k] != 4 for k in after):  # 2 blocks x (prefill + step)
        raise AssertionError(f"model on the card did not run the kernels: {before} -> {after}")
    del cpu, gpu, c_cache, g_cache
    torch.cuda.empty_cache()
    return worst


def phase_main_path(torch, fe, np):
    """Phase 5: the serving batcher path at full width."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_serve_cfg
    from pytorch_distributed_training_tpu_torch.serving import InferenceEngine

    cfg = get_serve_cfg(CONFIG)
    vocab, max_new = cfg["dataset"]["n_classes"], cfg["serving"]["max_new_tokens"]
    depth = cfg["model"]["depth"]
    t0 = time.perf_counter()
    engine = InferenceEngine.from_config(cfg)
    say(f"  engine built in {time.perf_counter() - t0:.1f} s on {engine.device}; "
        f"{sum(p.numel() for p in engine.model.parameters()) / 1e6:.1f} M parameters")
    with engine:
        warm = engine.warmup()
        say(f"  warmup: {warm['warmup_ms']:.0f} ms over {warm['pairs']:.0f} bucket pairs")
        torch.cuda.reset_peak_memory_stats()
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, vocab, int(rng.integers(1, 513))).astype(np.int32)
                   for _ in range(16)]
        fe.reset_launch_counts()
        futures = [engine.submit(p) for p in prompts]
        results = [f.result(timeout=600) for f in futures]
        launches = fe.launch_counts()
        snap = engine.snapshot()
    for r in results:
        if r["gen_len"] != max_new:
            raise AssertionError(f"gen_len {r['gen_len']} != {max_new}")
        toks = r["tokens"]
        if toks.shape != (max_new,) or toks.min() < 0 or toks.max() >= vocab:
            raise AssertionError(f"tokens out of range or shape: {toks}")
    per_batch = depth * (1 + (max_new - 1))
    want = per_batch * snap["batches"]
    for name, n in launches.items():
        if n != want:
            raise AssertionError(
                f"{name}: {n} launches, expected {per_batch} x {snap['batches']} batches"
            )
    say(f"  16 requests in {snap['batches']} batches; launches {launches} "
        f"= {per_batch} x {snap['batches']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say("serving: " + json.dumps(snap))
    return launches, engine


def phase_profile(torch, engine, np):
    """``--profile``: device time by kernel for one batch's prefill and its
    decode loop at the larger seq bucket, and the device's busy share of
    each phase's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from torch.autograd import DeviceType

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    bb, sb = engine.batch_buckets[-1], engine.seq_buckets[-1]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, engine.vocab_size, (bb, sb)).astype(np.int32)
    plen = np.full((bb,), sb, np.int32)
    carry = []
    phases = (
        ("prefill", lambda: carry.append(engine._generate.prefill(tokens, plen))),
        ("decode", lambda: engine._generate.decode(plen, carry[0])),
    )
    for phase, fn in phases:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # kernel rows only: an operator's row repeats its kernels' time
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and device_us(e) > 0]
        busy_ms = sum(device_us(e) for e in events) / 1e3
        say(f"  profile {phase} [{bb}x{sb}]: wall {wall_ms} ms, device kernel time "
            f"{busy_ms} ms, busy share {busy_ms / wall_ms}, kernel launches "
            f"{sum(e.count for e in events)}")
        for e in sorted(events, key=lambda e: -device_us(e))[:15]:
            say(f"    {device_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    from pytorch_distributed_training_tpu_torch import kernels
    from pytorch_distributed_training_tpu_torch.ops import fused_elementwise as fe

    t_start = time.perf_counter()
    say("== phase 1: the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    say("== phase 2: build")
    built = kernels.build()
    for name, secs in built.items():
        say(f"  built {name} in {secs:.1f} s -> {kernels.library_path(name)}")
        for line in kernels.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                say(f"    {line.strip()}")

    say("== phase 3: kernels against their plain twins")
    cases = phase_kernels(torch, fe)

    say("== phase 4: full-width model, card vs CPU")
    phase_model_vs_cpu(torch, fe)

    say("== phase 5: main path (serving batcher, full width)")
    launches, engine = phase_main_path(torch, fe, np)
    if args.profile:
        say("== profile")
        phase_profile(torch, engine, np)

    summary = []
    for name, (tpu, replaces) in TPU_KERNELS.items():
        main_case = cases[name][0]  # bf16 at the main path's prefill shape
        decode_case = cases[name][1]  # bf16 at the decode shape
        summary.append(dict(
            name=name, tpu_kernel=tpu, route="cuda", source=SOURCE, replaces=replaces,
            matched=True, launches=launches[name], max_abs_err=main_case["max_abs_err"],
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"], library_ms=None,
            shape=main_case["shape"], dtype=main_case["dtype"],
            call_ms=main_case["call_ms"],
            decode_shape=decode_case["shape"], decode_ms=decode_case["ms"],
            decode_plain_ms=decode_case["plain_ms"], decode_bound_ms=decode_case["bound_ms"],
            decode_call_ms=decode_case["call_ms"],
        ))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": summary}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
