"""ctypes binding of the port's host-side image ops (``image_ops.cpp``).

Counterpart of ``mtlora_tpu/data/native/native.py``, without its cv2
fallback: the port has no cv2, so a failed build raises. The library is
built with ``g++ -O3 -march=native`` at the first call that needs it,
never at import, into ``build/`` at the root of the checkout. Its file
name carries a hash of the source, the flags and the host's CPU, so an
edit rebuilds, and a library built for another CPU is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

# interpolation codes of the C entry points (cv2's INTER_* values)
NEAREST, LINEAR, CUBIC = 0, 1, 2

_lib = None
build_seconds = None   # wall time of the build this process ran, if any


def _cpu_id() -> str:
    """The model and feature flags of the host's first CPU: what
    ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().split("\n\n")[0].splitlines()
    except OSError:
        return platform.processor()
    keep = ("model name", "flags", "Features", "CPU part")
    return "\n".join(l for l in lines if l.split(":")[0].strip() in keep)


def library() -> ctypes.CDLL:
    """The image ops' library, built on the first call of the process.
    Raises if ``g++`` is missing or the build fails."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    digest.update(f"{platform.machine()}\n{_cpu_id()}".encode())
    out = BUILD_DIR / f"libimage_ops_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                                  capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("the image ops need g++ to build, and g++ "
                               "was not found") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builds agree
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    fp = ctypes.POINTER(ctypes.c_float)
    dp = ctypes.POINTER(ctypes.c_double)
    i = ctypes.c_int
    lib.resize_f32.argtypes = [fp, i, i, i, fp, i, i, i]
    lib.warp_affine_f32.argtypes = [fp, i, i, i, fp, i, i, dp, i]
    lib.hflip_f32.argtypes = [fp, i, i, i, fp]
    for fn in (lib.resize_f32, lib.warp_affine_f32, lib.hflip_f32):
        fn.restype = None
    _lib = lib
    return lib


def _as3d(img: np.ndarray):
    """float32, C-contiguous, HxWxC with 1 <= C <= 8 (the C code's pixel
    buffer); a 2-d image gains a channel axis, dropped again after."""
    img = np.ascontiguousarray(img, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    if img.ndim != 3 or not 1 <= img.shape[2] <= 8:
        raise ValueError(f"image ops take HxW or HxWxC with C <= 8, got "
                         f"shape {img.shape}")
    return img, squeeze


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _interp(interp) -> int:
    if interp not in (NEAREST, LINEAR, CUBIC):
        raise ValueError(f"interpolation {interp!r}: the image ops take "
                         f"NEAREST, LINEAR or CUBIC")
    return int(interp)


def resize(img: np.ndarray, dsize, interp: int = LINEAR) -> np.ndarray:
    """``cv2.resize``; ``dsize`` is (width, height) as cv2 takes it. The
    result is float32."""
    interp = _interp(interp)
    lib = library()
    src, squeeze = _as3d(img)
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w, c = src.shape
    dst = np.empty((dh, dw, c), np.float32)
    lib.resize_f32(_ptr(src), h, w, c, _ptr(dst), dh, dw, interp)
    return dst[:, :, 0] if squeeze else dst


def warp_affine(img: np.ndarray, m: np.ndarray, dsize,
                interp: int = LINEAR) -> np.ndarray:
    """``cv2.warpAffine`` with the forward 2x3 matrix ``m`` and a
    constant 0 border. The result is float32."""
    interp = _interp(interp)
    lib = library()
    src, squeeze = _as3d(img)
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w, c = src.shape
    m = np.ascontiguousarray(m, np.float64)
    if m.shape != (2, 3):
        raise ValueError(f"warp_affine takes a 2x3 matrix, got {m.shape}")
    dst = np.empty((dh, dw, c), np.float32)
    lib.warp_affine_f32(_ptr(src), h, w, c, _ptr(dst), dh, dw,
                        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        interp)
    return dst[:, :, 0] if squeeze else dst


def hflip(img: np.ndarray) -> np.ndarray:
    """``cv2.flip(img, 1)``. The result is float32."""
    lib = library()
    src, squeeze = _as3d(img)
    h, w, c = src.shape
    dst = np.empty_like(src)
    lib.hflip_f32(_ptr(src), h, w, c, _ptr(dst))
    return dst[:, :, 0] if squeeze else dst
