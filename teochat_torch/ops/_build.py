"""Builds the CUDA sources in ``teochat_torch/csrc`` and loads them with ctypes.

The kernels have a plain C interface (pointers, sizes, strides and the stream
as arguments; each entry returns ``cudaGetLastError()``), so they compile with
``nvcc`` alone, in seconds, without PyTorch's headers. The shared library is
built at first use into ``teochat_torch/csrc/build/`` (listed in
``.gitignore``) under a name that hashes the sources and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Each
source compiles in its own ``nvcc``, all started together, then one link.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "teochat_flash_attention_fwd": (
        [_P, _P, _P, _P] + [_I] * 6 + [_LL] * 9 + [_F, _I, _P]
    ),
    "teochat_flash_attention_fwd_res": (
        [_P] * 6 + [_I] * 6 + [_LL] * 9 + [_F, _I, _P]
    ),
    "teochat_flash_attention_bwd_dkv": (
        [_P] * 7 + [_I] * 6 + [_LL] * 12 + [_F, _I, _P] + [_P] * 2
    ),
    "teochat_flash_attention_bwd_dq": (
        [_P] * 7 + [_I] * 6 + [_LL] * 12 + [_F, _I, _P] + [_P]
    ),
    "teochat_decode_attention": (
        [_P] * 5 + [_I] * 5 + [_LL] * 8 + [_F, _P]
    ),
}


class KernelLibrary:
    """The loaded shared library, with what its build printed."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Launch through the C entry `name`; raise if it reports an error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")


_library = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _compile_and_link(sources, out: Path) -> str:
    """One nvcc -c per source, run together, then nvcc -shared into `out`;
    returns what they printed."""
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    for src, proc in zip(sources, procs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return log


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernels."""
    global _library
    if _library is not None:
        return _library
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libteochat_kernels_{digest.hexdigest()[:16]}.so"
    log, seconds = "", 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _compile_and_link(sources, out)
        seconds = time.perf_counter() - t0
    _library = KernelLibrary(out, seconds, log)
    return _library


def check_bf16_operand(name: str, t, ndim: int) -> None:
    """Raise unless `t` is a CUDA bf16 tensor the kernels can read as is:
    last dimension contiguous, other strides and the base 16-byte aligned
    (rows are read with 16-byte loads)."""
    import torch

    if not t.is_cuda or t.dtype != torch.bfloat16 or t.ndim != ndim:
        raise ValueError(
            f"{name}: need a {ndim}-d CUDA bfloat16 tensor, got "
            f"{t.ndim}-d {t.dtype} on {t.device}"
        )
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: strides {t.stride()} / base alignment not supported "
            "(last dim contiguous, other strides multiples of 8 elements)"
        )


class LaunchCounter:
    """Counts the launches of one kernel (reset it before a run to read)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0
