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

import contextlib
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
    # q, k, v, o (and K4a's m, l), the bias table or null; the bias rows' stride
    "teochat_flash_attention_fwd": (
        [_P] * 5 + [_I] * 6 + [_LL] * 10 + [_F, _I, _P]
    ),
    "teochat_flash_attention_fwd_res": (
        [_P] * 7 + [_I] * 6 + [_LL] * 10 + [_F, _I, _P]
    ),
    # q, k, v, dO, m, l, di, the bias table or null; the strides, the bias
    # rows' stride; then the outputs
    "teochat_flash_attention_bwd_dkv": (
        [_P] * 8 + [_I] * 6 + [_LL] * 13 + [_F, _I, _P] + [_P] * 2
    ),
    "teochat_flash_attention_bwd_dq": (
        [_P] * 8 + [_I] * 6 + [_LL] * 13 + [_F, _I, _P] + [_P]
    ),
    "teochat_flash_attention_bwd_di": [_P, _P, _P, _I, _I, _I, _I, _P],
    "teochat_decode_attention": (
        [_P] * 8 + [_I] * 5 + [_LL] * 8 + [_F, _P]
    ),
    "teochat_decode_attention_multi": (
        [_P] * 8 + [_I] * 9 + [_LL] * 9 + [_F, _P]
    ),
    # the same two kernels over an fp8 (e4m3) cache
    "teochat_decode_attention_e4m3": (
        [_P] * 8 + [_I] * 5 + [_LL] * 8 + [_F, _P]
    ),
    "teochat_decode_attention_multi_e4m3": (
        [_P] * 8 + [_I] * 9 + [_LL] * 9 + [_F, _P]
    ),
    "teochat_int4_matmul": [_P] * 4 + [_I] * 4 + [_LL, _I, _P, _P, _P],
    "teochat_int4_matmul_tiled": [_P] * 4 + [_I] * 6 + [_LL, _I, _I, _P, _P, _P],
    "teochat_int4_matmul_tiled_stacked": (
        [_P] * 4 + [_I] * 6 + [_LL, _I, _I, _LL, _I, _P, _P, _P]
    ),
    "teochat_vit_attention": [_P] * 4 + [_I] * 4 + [_LL] * 9 + [_F, _P],
    # the kernel benches' variants (csrc/bench_int4_kernel.cu, bench_vit_attention.cu)
    "teochat_bench_int4_v2": [_P] * 5 + [_I] * 6 + [_P] * 3,
    "teochat_bench_int4_v3": [_P] * 5 + [_I] * 7 + [_P] * 3,
    "teochat_bench_int4_v5": [_P] * 5 + [_I] * 6 + [_P] * 3,
    "teochat_bench_int4_v4": [_P] * 4 + [_I] * 6 + [_P] * 3,
    "teochat_bench_int4_dma": [_P, _LL, _P, _P] + [_I] * 6 + [_P] * 3,
    "teochat_bench_int4_vpu": [_P, _P] + [_I] * 4 + [_P] * 3,
    "teochat_bench_vit_attention_b": [_P] * 4 + [_I] * 5 + [_LL] * 9 + [_F, _P],
    "teochat_bench_vit_attention_c": [_P] * 4 + [_I] * 3 + [_F, _P],
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


def launch(name: str, like, *args) -> None:
    """Launch entry `name` on `like`'s device and current stream (the stream
    is passed as the entry's last argument); raise if the launch is refused.
    The device guard is taken only when that device is not the current one."""
    import torch

    device = like.device
    if device.index == torch.cuda.current_device():
        library().call(name, *args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            library().call(name, *args, torch.cuda.current_stream(device).cuda_stream)


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


def check_kv_operand(name: str, t, ndim: int) -> None:
    """Raise unless `t` is a KV cache slab the decode kernels (K2, K2m) read
    as is: a CUDA bf16 or float8_e4m3fn tensor, last dimension contiguous,
    other strides and the base 16-byte aligned (K2m copies rows in 16-byte
    pieces: 8 bf16 or 16 e4m3 elements)."""
    import torch

    if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float8_e4m3fn) or t.ndim != ndim:
        raise ValueError(
            f"{name}: need a {ndim}-d CUDA bfloat16 or float8_e4m3fn tensor, got "
            f"{t.ndim}-d {t.dtype} on {t.device}"
        )
    if (t.stride(-1) != 1 or any(st * t.element_size() % 16 for st in t.stride()[:-1])
            or t.data_ptr() % 16):
        raise ValueError(
            f"{name}: strides {t.stride()} / base alignment not supported "
            "(last dim contiguous, other strides multiples of 16 bytes)"
        )


_tickets = {}  # (device, count) -> int32 zeros, reset by the kernels after each launch


def tickets_for(device, count: int):
    """A buffer of `count` zero tickets on `device` for the kernels that merge
    their blocks' partials in the launch (the last block to take a ticket
    resets it, so the buffer is zero again after every launch). Kept for the
    next call and never freed, so a captured launch keeps its pointer.

    K2 and K3's decode kernel may share one buffer, also inside a CUDA graph
    of the decode step (models/generation.py): that is safe because their
    launches, eager or replayed, run one after another on one stream. A
    buffer must exist before a capture (a captured fill runs nothing), which
    the step's eager first run sees to; making one in a capture raises."""
    import torch

    key = (device, count)
    if key not in _tickets:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("tickets_for: a new ticket buffer inside a CUDA graph capture")
        _tickets[key] = torch.zeros(count, dtype=torch.int32, device=device)
    return _tickets[key]


_sm_counts = {}  # device -> its streaming multiprocessors


def sm_count(device) -> int:
    """The streaming multiprocessors of CUDA `device`, read once."""
    import torch

    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device]


_counters = []  # every LaunchCounter made, in order


class LaunchCounter:
    """Counts the launches of one kernel (reset it before a run to read).

    A wrapper adds one where it enqueues its kernel. A launch captured into
    a CUDA graph runs nothing then: `capture_counts` takes it back off and
    records it, and the graph's owner adds it at each replay
    (`add_counts`), so a count is what the device ran."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        _counters.append(self)

    def reset(self) -> None:
        self.count = 0


@contextlib.contextmanager
def capture_counts():
    """Around a CUDA graph's capture: yields a dict that holds, on exit, the
    launches each counter saw in the block (only the counters that moved),
    and sets every counter back to what it read before the block."""
    before = [c.count for c in _counters]
    seen = {}
    try:
        yield seen
    finally:
        for c, n in zip(_counters, before):
            if c.count != n:
                seen[c] = c.count - n
                c.count = n


def add_counts(seen, times: int) -> None:
    """Count `times` replays of a graph whose capture saw `seen`."""
    for c, n in seen.items():
        c.count += n * times
