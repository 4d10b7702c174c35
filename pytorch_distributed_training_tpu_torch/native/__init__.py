"""ctypes bindings for the host input pipeline's native library (port of
``native/__init__.py``).

The library is the repo's ``native/preprocess.cpp`` (fused uint8 ->
normalised float32 batch assembly) and ``native/decode.cpp`` (a whole
batch of JPEGs decoded, cropped, antialias-resized, flipped and
normalised or rounded to uint8 on a C++ thread pool, the GIL released),
compiled with the flags of ``native/Makefile`` and linked with
``-ljpeg``.  It builds at first use into the package's ``_build/``
(listed in ``.gitignore``), not through the Makefile, which writes into
the JAX package.  The file name carries a hash of the sources, the
compiler and the flags, so an edited source builds anew; the compiler
writes a private file that is renamed into place under a file lock, so
processes building at once never load a half-written library.

There is no numpy fallback: a build that fails raises ``RuntimeError``
with the compiler's output.  ``normalize_batch`` and
``decode_jpeg_batch`` keep the JAX package's signatures and its
``x * scale + bias`` form (``scale = 1 / (255 std)``, ``bias = -mean /
std``), so both packages' batches agree bit for bit.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = [
    "BUILD_DIR",
    "CXXFLAGS",
    "SOURCES",
    "SRC_DIR",
    "build",
    "decode_jpeg_batch",
    "library",
    "library_path",
    "normalize_batch",
]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SRC_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
SOURCES = ("preprocess.cpp", "decode.cpp")
# native/Makefile:3, then the JPEG library it links (:9)
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17", "-Wall")
LIBS = ("-ljpeg",)
BUILD_TIMEOUT_S = 300

_P = ctypes.POINTER
_SIGNATURES = {
    # in u8, out f32, n_images, pixels_per_image, scale[3], bias[3], n_threads
    "pdt_normalize_u8_nhwc": [_P(ctypes.c_uint8), _P(ctypes.c_float), ctypes.c_long,
                              ctypes.c_long, _P(ctypes.c_float), _P(ctypes.c_float),
                              ctypes.c_int],
    # paths, boxes [n, 4] f64, flips [n] u8, n, out_size, scale[3], bias[3],
    # out f32, dct_denom, n_threads, status [n] i32
    "pdt_decode_jpeg_batch": [_P(ctypes.c_char_p), _P(ctypes.c_double), _P(ctypes.c_uint8),
                              ctypes.c_long, ctypes.c_int, _P(ctypes.c_float),
                              _P(ctypes.c_float), _P(ctypes.c_float), ctypes.c_int,
                              ctypes.c_int, _P(ctypes.c_int32)],
    # paths, boxes, flips, n, out_size, out u8, dct_denom, n_threads, status
    "pdt_decode_jpeg_batch_u8": [_P(ctypes.c_char_p), _P(ctypes.c_double), _P(ctypes.c_uint8),
                                 ctypes.c_long, ctypes.c_int, _P(ctypes.c_uint8), ctypes.c_int,
                                 ctypes.c_int, _P(ctypes.c_int32)],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path(cxx: str = "g++", build_dir: str = BUILD_DIR) -> str:
    """Where the library lives once built, keyed by sources, compiler and flags."""
    digest = hashlib.sha256()
    for src in SOURCES:
        with open(os.path.join(SRC_DIR, src), "rb") as fp:
            digest.update(fp.read())
    digest.update(" ".join((cxx,) + CXXFLAGS + LIBS).encode())
    return os.path.join(build_dir, f"libpdt_native-{digest.hexdigest()[:16]}.so")


def build(cxx: str = "g++", build_dir: str = BUILD_DIR) -> str:
    """Compile the library unless it is on disk; returns its path.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    path = library_path(cxx, build_dir)
    if os.path.isfile(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.isfile(path):  # another process built it meanwhile
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [cxx, *CXXFLAGS, *(os.path.join(SRC_DIR, s) for s in SOURCES), "-o", tmp, *LIBS]
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building the native library failed: {' '.join(cmd)}: "
                               f"{e}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"building the native library failed (exit "
                               f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = None
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _affine(mean, std):
    """``(scale, bias)`` of ``(x / 255 - mean) / std`` as ``x * scale + bias``, f32."""
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError(f"mean/std must have shape (3,), got {mean.shape} / {std.shape}")
    return (1.0 / (255.0 * std)).astype(np.float32), (-mean / std).astype(np.float32)


def normalize_batch(batch_u8: np.ndarray, mean: np.ndarray, std: np.ndarray,
                    n_threads: int = 0) -> np.ndarray:
    """uint8 NHWC batch -> float32 ``(x / 255 - mean) / std`` in one native pass."""
    if batch_u8.dtype != np.uint8 or batch_u8.ndim != 4 or batch_u8.shape[-1] != 3:
        raise ValueError(f"expected uint8 NHWC3 batch, got {batch_u8.dtype} {batch_u8.shape}")
    scale, bias = _affine(mean, std)
    lib = library()
    batch_u8 = np.ascontiguousarray(batch_u8)
    n, h, w, _ = batch_u8.shape
    out = np.empty((n, h, w, 3), dtype=np.float32)
    lib.pdt_normalize_u8_nhwc(_ptr(batch_u8, ctypes.c_uint8), _ptr(out, ctypes.c_float), n,
                              h * w, _ptr(scale, ctypes.c_float), _ptr(bias, ctypes.c_float),
                              int(n_threads))
    return out


def decode_jpeg_batch(paths, boxes: np.ndarray, flips: np.ndarray, out_size: int,
                      mean: Optional[np.ndarray], std: Optional[np.ndarray],
                      out: Optional[np.ndarray] = None, dct_denom: int = 1,
                      n_threads: int = 0):
    """Decode a batch of JPEG files into NHWC images (``native/decode.cpp``).

    Per image: libjpeg decode (DCT-domain downscale by ``dct_denom``: 1, 2,
    4, 8, or 0 to pick the largest that keeps the crop at least
    ``out_size``), crop to ``boxes[i]`` (original-image coordinates),
    PIL-style antialiased resize to ``out_size``, optional horizontal flip;
    then normalised float32 with ``mean``/``std``, or round-clamped uint8
    when both are ``None`` (normalised on the card).

    Returns ``(out, status)``; ``status[i] != 0`` marks rows libjpeg could
    not decode (not a JPEG, CMYK, corrupt), which the caller redoes in PIL.
    """
    n = len(paths)
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    flips = np.ascontiguousarray(flips, dtype=np.uint8)
    if boxes.shape != (n, 4) or flips.shape != (n,):
        raise ValueError(f"boxes {boxes.shape} / flips {flips.shape} mismatch n={n}")
    if (mean is None) != (std is None):
        raise ValueError("mean and std must both be None (uint8 mode) or both be set "
                         f"(normalized f32 mode); got mean={mean!r} std={std!r}")
    raw_u8 = mean is None
    out_dtype = np.uint8 if raw_u8 else np.float32
    if out is None:
        out = np.empty((n, out_size, out_size, 3), dtype=out_dtype)
    elif out.shape != (n, out_size, out_size, 3) or out.dtype != out_dtype:
        raise ValueError(f"bad out buffer: {out.dtype} {out.shape}")
    elif not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out buffer must be C-contiguous")
    lib = library()
    status = np.zeros(n, dtype=np.int32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    common = (c_paths, _ptr(boxes, ctypes.c_double), _ptr(flips, ctypes.c_uint8), n,
              int(out_size))
    if raw_u8:
        lib.pdt_decode_jpeg_batch_u8(*common, _ptr(out, ctypes.c_uint8), int(dct_denom),
                                     int(n_threads), _ptr(status, ctypes.c_int32))
        return out, status
    scale, bias = _affine(mean, std)
    lib.pdt_decode_jpeg_batch(*common, _ptr(scale, ctypes.c_float), _ptr(bias, ctypes.c_float),
                              _ptr(out, ctypes.c_float), int(dct_denom), int(n_threads),
                              _ptr(status, ctypes.c_int32))
    return out, status
