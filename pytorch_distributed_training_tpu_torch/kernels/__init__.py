"""Build and bind the port's hand-written CUDA kernels.

Every source under ``csrc/`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`.  The build
happens at first use, on the machine with the card, into ``_build/`` inside
the package (listed in ``.gitignore``); each library's file name carries a
hash of its source and of the compiler flags, so an edited source builds
anew and an unchanged one is reused.  ``build()`` starts one ``nvcc`` per
missing library, all at once, and waits for them together.

Nothing here runs at import, so a machine without ``nvcc`` or a card can
import it: at import the module only names the sources and their C
signatures.  Pointers and the stream are passed as
``c_void_p``, ints as ``c_int``; every C function returns
``cudaGetLastError()`` and :func:`check` raises when it is not 0.

Libraries: ``fused_elementwise`` (K3/K4), ``fused_ce`` (K1a/K1b) and
``flash_attention`` (one forward for K2a/K2b, a dQ kernel for K2d/K2f and
a dK/dV kernel for K2e/K2g, the pair standing in for K2c; bf16 on the
tensor cores with TMA and ``wgmma``; the f32 forward, dK/dV and dQ on
the tensor cores in 3xTF32 with ``mma.sync`` and ``cp.async``).  The TMA
kernels take their tensor maps from ``cuTensorMapEncodeTiled``, which the
library fetches from the driver through the runtime
(``cudaGetDriverEntryPoint``), so no library links ``-lcuda``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

__all__ = [
    "BUILD_DIR",
    "CSRC_DIR",
    "NVCC_FLAGS",
    "SOURCES",
    "build",
    "build_logs",
    "check",
    "library",
    "library_path",
    "nvcc_command",
    "require_contiguous",
    "require_cuda",
    "stream",
]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# route (b) of the Hopper build: sm_90a so wgmma/setmaxnreg stay available
# to later kernels; -Xptxas -v reports registers, shared memory and spills
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# library name -> (source file under csrc/, {C function: argtypes})
SOURCES = {
    "fused_elementwise": (
        "fused_elementwise.cu",
        {
            # x, delta, scale, bias, s, y, rows, features, eps, dtype,
            # out_dtype, stream
            "pdt_add_layernorm": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
            # u, bias, y, rows, features, dtype, stream
            "pdt_bias_gelu": [_P, _P, _P, _I, _I, _I, _P],
        },
    ),
    "fused_ce": (
        "fused_ce.cu",
        {
            # logits, labels, nll, lse, rows, classes, dtype, stream
            "pdt_ce_fwd": [_P, _P, _P, _P, _I, _I, _I, _P],
            # logits, labels, lse, scale, dlogits, rows, classes, dtype, stream
            "pdt_ce_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        },
    ),
    "flash_attention": (
        "flash_attention.cu",
        {
            # q, k, v, o, lse, bh, seq, head_dim, scale, causal, dtype, stream
            "pdt_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
            # q, k, v, dout, lse, delta, dk, dv, bh, seq, head_dim, scale,
            # causal, dtype, stream
            "pdt_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
            # q, k, v, dout, lse, delta, dq, bh, seq, head_dim, scale, causal,
            # dtype, stream
            "pdt_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
        },
    ),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register/spill report) per library built here
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built on the machine with the card"
    )


def library_path(name: str) -> str:
    """Where library ``name`` lives once built, keyed by source + flags."""
    src, _ = SOURCES[name]
    digest = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, src), "rb") as fp:
        digest.update(fp.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def nvcc_command(name: str, out_path: str, nvcc: str = "nvcc") -> list:
    src, _ = SOURCES[name]
    return [nvcc, *NVCC_FLAGS, "-o", out_path, os.path.join(CSRC_DIR, src)]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library in ``names`` (default: all), one
    ``nvcc`` each, started together.  Returns wall seconds per library
    built (0.0 for one already on disk); raises ``RuntimeError`` with the
    compiler's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    seconds = {n: 0.0 for n in names}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if os.path.isfile(path):
            continue
        # write to a private name and rename into place: a concurrent
        # process never loads a half-written library
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (
            subprocess.Popen(
                nvcc_command(name, tmp, _nvcc()),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, path,
        )
    failures = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = out
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing.  Once it is
    loaded this takes no lock: a dict read is atomic, and the wrappers call
    it on every launch."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.isfile(path):
                build([name])
            lib = ctypes.CDLL(path)
            for fn, argtypes in SOURCES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# --- checks the wrappers share (torch is imported by the caller's module)


def stream(t) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``t``'s device, read
    without building a ``torch.cuda.Stream``."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require_cuda(name: str, *tensors) -> None:
    """Raise ``ValueError`` unless every tensor is a CUDA tensor on one device."""
    dev = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(
                f"{name}: the kernel takes CUDA tensors on one device, got "
                f"{[str(u.device) for u in tensors]}"
            )


def require_contiguous(name: str, *tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
