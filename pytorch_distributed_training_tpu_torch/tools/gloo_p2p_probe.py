"""Whether gloo's send/recv take CUDA tensors, raw and through the stage exchange.

    python -m pytorch_distributed_training_tpu_torch.tools.gloo_p2p_probe

For f32 and bf16 tensors of 2^20 elements on ``cuda:0``, two processes join
a gloo group and either hop one tensor each way through
:class:`..parallel.pipeline.StageExchange` (the pipeline's hops, staged
through pinned host memory under gloo) or send one from rank 0 to rank 1
with ``dist.send``/``dist.recv`` (raw).  Each pair runs in processes of its
own, since gloo's transport hands a tensor's raw pointer to its socket and
a refused send may abort the process.  Each result is ``"exact"``, ``"wrong
values"``, or the exit code and the last line the pair printed.  Prints
the card's ``nvidia-smi`` name and power limit, then one JSON line per
dtype.  Needs one CUDA card; exits 1 without one, and 1 when the stage
exchange does not deliver exact values.
"""
from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
from datetime import timedelta

N = 1 << 20


def _rank(rank: int, port: int, mode: str, dtype_name: str) -> None:
    """One process of a pair: prints ``exact`` or ``wrong values`` (rank 1
    for a raw send, both ranks for the exchange)."""
    import torch
    import torch.distributed as dist

    from pytorch_distributed_training_tpu_torch.parallel import StageExchange

    torch.cuda.set_device(0)
    dtype = getattr(torch, dtype_name)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=timedelta(seconds=30))
    base = torch.arange(N, device="cuda").float()
    if mode == "exchange":
        ex = StageExchange(dist.group.WORLD, [0, 1], dist.get_backend())
        mine, got = (base + 3 * rank).to(dtype), torch.empty(N, dtype=dtype, device="cuda")
        if rank == 0:
            ex.hop(send_next=mine, recv_next=got)
        else:
            ex.hop(send_prev=mine, recv_prev=got)
        want = (base + 3 * (1 - rank)).to(dtype)
    else:
        got = base.to(dtype) if rank == 0 else torch.empty(N, dtype=dtype, device="cuda")
        (dist.send if rank == 0 else dist.recv)(got, 1 - rank)
        want = base.to(dtype)
    torch.cuda.synchronize()
    print("exact" if torch.equal(got, want) else "wrong values", flush=True)
    dist.destroy_process_group()


def _pair(mode: str, dtype_name: str) -> str:
    """Run one pair; its verdict (rank 1's), or the exit codes and the last
    line either process printed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, "--rank", str(r), "--port",
                               str(port), "--mode", mode, "--dtype", dtype_name],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0].strip().splitlines() or [""])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append((p.communicate()[0].strip().splitlines() or [""]) + ["timed out"])
    if all(p.returncode == 0 for p in procs):
        return outs[1][-1]
    return "; ".join(f"rank {r} exit {p.returncode}: {o[-1][-120:]}"
                     for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode != 0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rank", type=int)
    parser.add_argument("--port", type=int)
    parser.add_argument("--mode", choices=("exchange", "raw"))
    parser.add_argument("--dtype")
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank(args.rank, args.port, args.mode, args.dtype)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("gloo_p2p_probe: CUDA is not available; this tool runs on the card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    ok = True
    for name in ("float32", "bfloat16"):
        row = {"dtype": name, "stage_exchange": _pair("exchange", name),
               "raw": _pair("raw", name)}
        print(json.dumps(row), flush=True)
        ok &= row["stage_exchange"] == "exact"
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
