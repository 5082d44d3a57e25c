"""Kernel bench: ViT attention variants on the card ([32, 257, 16, 64] bf16).

Port of scripts/bench_vit_attention.py. Variants:

  plain     the plain attention (ops/attention.plain_attention): the score
            matrices go through device memory (the script's XLA row)
  current   the production kernel (ops/vit_attention.vit_attention, K5): P
            rounded to bf16 before P V, divided by l after
  b_nopad   [B, S, H, D] read in place, `bh` heads a work item, p / l
            rounded to bf16 before P V (the script's `_kernel_b`)
  c_flat    the same on contiguous [B H, S, D] rows; the call includes the
            transposes to and from that layout (`_kernel_c`)
  library   one `scaled_dot_product_attention` call, as the library's time
            (measured here, used nowhere in the port)

b and c are one CUDA kernel (csrc/bench_vit_attention.cu) behind two entries
that differ in their tensor maps, with their plain version beside them
(`call_plain`, taken by CPU tensors) and a launch counter each. The kernel
is K5's design: keys in windows of WINDOW = 272 whose scores a 64-row query
tile holds in registers, `wgmma` on TMA-fed tiles, persistent blocks. Up to
one window (the bench's S = 257) it is one sweep; past it a first sweep
takes each row's maximum and sum and a second recomputes the scores for
bf16(p / l) V. `one_sweep_schedule` is that walk in plain PyTorch, held
against the script's Pallas kernels on the CPU by the tests.

Run: python3 -m teochat_torch.bench.vit_attention
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F

from teochat_torch.bench import _timing
from teochat_torch.ops import _build
from teochat_torch.ops import vit_attention as vit_mod
from teochat_torch.ops.attention import NEG_INF, plain_attention
from teochat_torch.utils import resolve_device

B, S, H, D = 32, 257, 16, 64
HEAD_DIM = 64
TILE_Q = 64  # query rows a consumer warpgroup of the kernel takes
WINDOW = 272  # keys whose scores a query tile holds at once (256 + 16)
MAX_SEQ = 832  # the bench's gate: up to four windows
LOG2E = 1.4426950408889634
# |kernel (bf16 out) - plain (fp32 on the same bf16 inputs)|: outputs are averages of
# N(0, 1) values, |o| < 4, so the bf16 output rounding alone reaches 2^-8 * 4 = 1.6e-2;
# p / l is rounded to bf16 before the product with v on both sides
TOL = 2e-2

LAUNCHES_B = _build.LaunchCounter("bench_vit_attention_b")
LAUNCHES_C = _build.LaunchCounter("bench_vit_attention_c")
COUNTERS = {"S2-b": LAUNCHES_B, "S2-c": LAUNCHES_C}


def call_plain(q, k, v):
    """softmax(q k^T / sqrt(d)) v through materialized scores."""
    return plain_attention(q, k, v, causal=False)


call_b_plain = call_plain  # what S2-b computes
call_c_plain = call_plain  # what S2-c computes (its transposes cancel)


def one_sweep_schedule(q, k, v, *, window: int = WINDOW, tile_q: int = TILE_Q,
                       scale: float | None = None) -> torch.Tensor:
    """The kernel's walk, in plain PyTorch; [B, S, H, D] in and out.

    As in csrc/bench_vit_attention.cu: query tiles of `tile_q` rows (rows
    past S read as zeros) meet the keys in windows of `window`; keys past S
    are read as zeros and their scores masked; the scale rides on the
    base-2 exponent, p = 2^(s c2 - m) with c2 = scale log2 e and m the row's
    maximum in those units. Each window updates m and l = sum p, l rescaled
    by 2^(m_old - m_new) (0 in the first window). The kernel holds a single
    window's p in registers and goes on to P V with it; past one window it
    recomputes each window's scores in a second sweep: the numbers are the
    same either way, and are the ones below. p (1 / l) is rounded to v's
    dtype (bf16 on the card) before P V; o leaves in q's dtype."""
    b, s, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    c2 = scale * LOG2E
    pad_s, pad_t = -s % tile_q, -s % window
    pad = torch.nn.functional.pad
    qp = pad(q, (0, 0, 0, 0, 0, pad_s)).float()
    kp = pad(k, (0, 0, 0, 0, 0, pad_t)).float()
    vp = pad(v, (0, 0, 0, 0, 0, pad_t))
    starts = range(0, s + pad_t, window)
    o = torch.zeros((b, s + pad_s, h, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, s + pad_s, tile_q):
        def scores(k0):
            sc = torch.einsum("bshd,bthd->bhst", qp[:, q0:q0 + tile_q], kp[:, k0:k0 + window])
            return torch.where(torch.arange(k0, k0 + window, device=q.device) >= s, NEG_INF, sc)

        m = torch.full((b, h, tile_q), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        for k0 in starts:  # the first sweep: m and l
            sc = scores(k0)
            m_next = torch.maximum(m, sc.amax(-1) * c2)
            l = torch.exp2(m - m_next) * l + torch.exp2(sc * c2 - m_next[..., None]).sum(-1)
            m = m_next
        inv = 1 / l
        acc = torch.zeros((b, h, tile_q, d), device=q.device)
        for k0 in starts:  # the second: bf16(p / l) V
            p = torch.exp2(scores(k0) * c2 - m[..., None]) * inv[..., None]
            acc += torch.einsum("bhst,bthd->bhsd", p.to(v.dtype).float(),
                                vp[:, k0:k0 + window].float())
        o[:, q0:q0 + tile_q] = acc.transpose(1, 2)
    return o[:, :s].to(q.dtype)


def call_current(q, k, v):
    """The production kernel (K5) on the card, its plain version on the CPU."""
    return vit_mod.vit_attention(q, k, v)


def call_library(q, k, v):
    """One scaled_dot_product_attention call on the [B, H, S, D] views."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)


def _check(name, q, k, v):
    for label, t in (("q", q), ("k", k), ("v", v)):
        _build.check_bf16_operand(label, t, 4)
    b, s, h, d = q.shape
    if d != HEAD_DIM or not 0 < s <= MAX_SEQ:
        raise ValueError(f"{name}: head_dim {d} (need {HEAD_DIM}) or S {s} (need 1..{MAX_SEQ}) "
                         "not supported")
    if k.shape != q.shape or v.shape != q.shape or not (q.device == k.device == v.device):
        raise ValueError(f"{name}: shapes q {q.shape} k {k.shape} v {v.shape} or devices differ")
    return b, s, h, d


def call_b(q, k, v, bh: int = 8):
    """S2-b: one-sweep attention on [B, S, H, D] read in place, `bh` heads a block."""
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"call_b: no kernel for device {q.device}")
        return call_b_plain(q, k, v)
    b, s, h, d = _check("call_b", q, k, v)
    if bh <= 0 or h % bh:
        raise ValueError(f"call_b: bh {bh} must divide H {h}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _build.launch(
        "teochat_bench_vit_attention_b", q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d, bh,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), d ** -0.5)
    LAUNCHES_B.count += 1
    return out


def call_c_flat(qf, kf, vf):
    """S2-c's kernel alone, on contiguous [B, H, S, D] tensors on the card."""
    b, h, s, d = qf.shape
    out = torch.empty_like(qf)
    _build.launch("teochat_bench_vit_attention_c", qf, qf.data_ptr(), kf.data_ptr(),
                  vf.data_ptr(), out.data_ptr(), b * h, s, d, d ** -0.5)
    LAUNCHES_C.count += 1
    return out


def call_c(q, k, v):
    """S2-c: the same on contiguous [B H, S, D] rows; transposes to and from
    that layout around the kernel, as the JAX function has them."""
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"call_c: no kernel for device {q.device}")
        return call_c_plain(q, k, v)
    b, s, h, d = _check("call_c", q, k, v)
    if q.numel() == 0:
        return torch.empty_like(q)
    qf, kf, vf = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # [B, H, S, D]
    return call_c_flat(qf, kf, vf).transpose(1, 2).contiguous()


def bound(b: int, s: int, h: int, d: int):
    """(bytes, operations) the function needs: q, k, v read and o written once
    in bf16; the two products."""
    return 2 * 4 * b * s * h * d, 4 * b * h * s * s * d


def main(device=None):
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the kernel bench measures the card: it does not run on the CPU")
    smi = _timing.smi_line()
    print(smi, flush=True)
    lib = _build.library()
    print(f"[build] {lib.path.name} nvcc {lib.build_seconds:.2f}s", flush=True)
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(B, S, H, D).astype(np.float32)).to(device, torch.bfloat16)
               for _ in range(3))
    rows = []

    ref = call_plain(q.float(), k.float(), v.float())
    variants = [("current", call_current), ("b_nopad", call_b), ("c_flat", call_c)]
    for name, fn in variants:
        err = (fn(q, k, v).float() - ref).abs().max().item()
        print(f"{name:12s} max_err={err:.3e} (tol {TOL})", flush=True)
        rows.append({"row": name, "max_err": err})
        if not err <= TOL:
            raise RuntimeError(f"{name}: max_err {err} > {TOL}")

    nbytes, flops = bound(B, S, H, D)
    bound_ms, by = _timing.bound_ms(nbytes, flops)
    for name, fn in [("plain", call_plain)] + variants + [("library", call_library)]:
        ms = _timing.time_ms(lambda: fn(q, k, v))
        print(f"{name:12s} {ms:8.4f} ms/call   {flops / ms / 1e9:7.1f} TFLOP/s", flush=True)
        rows.append({"row": name, "ms": ms, "tflops": flops / ms / 1e9})
    # c's kernel alone, on rows that are already flat
    qf, kf, vf = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = _timing.time_ms(lambda: call_c_flat(qf, kf, vf))
    print(f"{'c kernel alone':12s} {ms:8.4f} ms/call   {flops / ms / 1e9:7.1f} TFLOP/s", flush=True)
    rows.append({"row": "c_flat kernel alone", "ms": ms, "tflops": flops / ms / 1e9})
    for bh in (1, 2, 4, 16):
        ms = _timing.time_ms(lambda: call_b(q, k, v, bh=bh))
        print(f"b_nopad bh={bh:<3d} {ms:8.4f} ms/call", flush=True)
        rows.append({"row": f"b_nopad bh={bh}", "ms": ms, "tflops": flops / ms / 1e9})
    out = {"bench": "vit_attention", "device": torch.cuda.get_device_name(0), "smi": smi,
           "shape": [B, S, H, D], "bound_ms": bound_ms, "bound_by": by, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
