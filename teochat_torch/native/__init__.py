"""Native host preprocessing (C++, bound with ctypes, built at first use).

The port's own copy of teochat_tpu/native/__init__.py. `preprocess.cc`
(a copy of the JAX package's) resizes with PIL's fixed-point bicubic, bit
for bit, crops and CLIP-normalizes into float32 CHW, threaded over the
batch. It is compiled with g++ at first use into `teochat_torch/csrc/build/`
(listed in `.gitignore`) as `_preprocess_<hash>.so`, the hash that of the
source. If there is no compiler or the build fails, `available()` is False
and data/processing.py's `ImageProcessor` takes its PIL path, which gives
the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "preprocess.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "csrc", "build")

_lock = threading.Lock()
_lib = None
_lib_error: Optional[str] = None


def _build_lib() -> Optional[ctypes.CDLL]:
    """Compile (if stale) and dlopen the preprocessing library."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"_preprocess_{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
            _SRC, "-o", tmp,
        ]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)  # atomic; concurrent builders converge
    lib = ctypes.CDLL(so_path)
    lib.teochat_preprocess_batch.restype = ctypes.c_int
    lib.teochat_preprocess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),   # srcs
        ctypes.POINTER(ctypes.c_int32),    # hs
        ctypes.POINTER(ctypes.c_int32),    # ws
        ctypes.c_int32,                    # n
        ctypes.c_int32,                    # out_size
        ctypes.POINTER(ctypes.c_float),    # mean
        ctypes.POINTER(ctypes.c_float),    # std
        ctypes.POINTER(ctypes.c_float),    # out
        ctypes.c_int32,                    # n_threads
    ]
    lib.teochat_resize_bicubic.restype = ctypes.c_int
    lib.teochat_resize_bicubic.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when native support is unavailable."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    with _lock:
        if _lib is None and _lib_error is None:
            try:
                _lib = _build_lib()
            except (OSError, subprocess.SubprocessError) as e:  # no g++, or the build failed
                _lib_error = str(e)
    return _lib


def available() -> bool:
    return get_lib() is not None


def preprocess_batch(
    frames: List[np.ndarray],
    out_size: int,
    mean: Sequence[float],
    std: Sequence[float],
    n_threads: int = 0,
) -> np.ndarray:
    """[h,w,3]-uint8 frames -> [n,3,out_size,out_size] float32 (resize
    shorter-side->out_size bicubic, center crop, CLIP-normalize), threaded.

    Bit-exact vs the PIL path in data/processing.py (same fixed-point
    resampler); raises RuntimeError when the native library is unavailable —
    callers should check available() and fall back.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native preprocess unavailable: {_lib_error}")
    n = len(frames)
    frames = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    for f in frames:
        if f.ndim != 3 or f.shape[2] != 3:
            raise ValueError(f"expected [h,w,3] uint8 frames, got {f.shape}")
    srcs = (ctypes.c_void_p * n)(
        *[f.ctypes.data_as(ctypes.c_void_p).value for f in frames]
    )
    hs = (ctypes.c_int32 * n)(*[f.shape[0] for f in frames])
    ws = (ctypes.c_int32 * n)(*[f.shape[1] for f in frames])
    mean_c = (ctypes.c_float * 3)(*[float(m) for m in mean])
    std_c = (ctypes.c_float * 3)(*[float(s) for s in std])
    out = np.empty((n, 3, out_size, out_size), np.float32)
    rc = lib.teochat_preprocess_batch(
        srcs, hs, ws, n, out_size, mean_c, std_c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
    )
    if rc != 0:
        raise RuntimeError(f"teochat_preprocess_batch failed (rc={rc})")
    return out


def resize_bicubic(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Exact-parity test hook: PIL Image.resize((ow, oh), BICUBIC) on uint8."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native preprocess unavailable: {_lib_error}")
    src = np.ascontiguousarray(src, dtype=np.uint8)
    out = np.empty((oh, ow, 3), np.uint8)
    rc = lib.teochat_resize_bicubic(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        src.shape[0], src.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), oh, ow,
    )
    if rc != 0:
        raise RuntimeError(f"teochat_resize_bicubic failed (rc={rc})")
    return out
