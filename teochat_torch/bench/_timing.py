"""Timing on the card, and the least time the card could take.

The JAX benches time a `lax.scan` of dependent calls inside one jit to hide
their dispatch floor. Here a kernel's time is read between two CUDA events
around calls that were enqueued behind a blocking product, so the events
bracket the device's work alone; end-to-end phases use the host clock around
work that ends in a synchronize.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

# the H100 SXM's published rates, for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
L2_BYTES = 50 * 2**20
N_TIMED = 25


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def hold_device():
    """Enqueue ~3 ms of device work (an fp32 product without TF32), so that
    what the host enqueues next waits in the stream and then runs back to
    back. Its 64 MB operands also push earlier data out of the L2."""
    a = torch.ones((4096, 4096), device="cuda")
    torch.mm(a, a)


def time_ms(fn, n=N_TIMED, inner=4, queued=True):
    """One call's device time: the median over n measurements, each of `inner`
    calls between two CUDA events, after one warm-up. With `queued` the calls
    are enqueued behind a blocking product, so the events bracket the device's
    work alone; without it a call's host time counts where it is the longer."""
    fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            hold_device()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def sync(device=None):
    """Wait for the card (nothing to wait for on the CPU)."""
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def wall(fn, device=None):
    """(fn's result, its wall seconds with the device drained before and after)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def timeit_all(fn, iters, device=None, batches=3):
    """Wall seconds per call of each of `batches` batches of `iters` calls
    (ascending), after one warm-up; the device is drained at each batch's end."""
    return timeit_interleaved([fn], iters, device, batches)[0]


def timeit_interleaved(fns, iters, device=None, batches=3):
    """timeit_all of each of `fns`, with their batches taken in turn (a, b, a,
    b, ...): a load that comes and goes on the host falls on each alike, so
    the difference of two of them is not the difference of two moments."""
    for fn in fns:
        fn()
    sync(device)
    times = [[] for _ in fns]
    for _ in range(batches):
        for fn, out in zip(fns, times):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            sync(device)
            out.append((time.perf_counter() - t0) / iters)
    return [sorted(t) for t in times]


def timeit(fn, iters, device=None):
    """The median of three batches (see timeit_all)."""
    return timeit_all(fn, iters, device)[1]


def bound_ms(nbytes: float, flops: float, ops_per_s: float = BF16_FLOPS_PER_S):
    """The least time the card could take: (ms, 'bytes' | 'operations'); the
    operations at `ops_per_s` (bf16's rate unless given, INT8_OPS_PER_S for
    an int8 product)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_row(err, ms, plain_ms, nbytes, flops, library_ms=None):
    """One kernel's measurements for the smoke's JSON line (launches come later)."""
    bound, by = bound_ms(nbytes, flops)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms}


def rotation(t: torch.Tensor, total_bytes: int = 3 * L2_BYTES + 10 * 2**20):
    """Copies of `t` that together exceed the L2 three times, and a function
    that returns the next copy: a timed launch then finds its weight out of
    the cache, as a decode step finds each layer's."""
    reps = max(2, -(-total_bytes // (t.numel() * t.element_size())))
    copies = t[None].expand(reps, *t.shape).contiguous()
    state = [0]

    def nxt():
        state[0] = (state[0] + 1) % reps
        return copies[state[0]]

    return nxt
