"""Kernel bench: int4 fused-dequant matmul unpack variants on the card.

Port of scripts/bench_int4_kernel.py. It times unpack strategies on a
representative decode projection (gate: [1, 4096] x [4096, 11008]):

  v0        the production kernel (ops/int4_matmul.int4_matmul_tiled, K3b):
            both nibbles extracted, two subtractions, two products
  v2_byte   byte reuse on u8 tiles: y = xa @ lo + xb @ byte with
            xb = x_hi / 16, xa = x_lo - xb; the high nibble is never extracted
  v3_i8     the same on int8 bytes b = (L + 8) + 16 H (mask at 32 or 16 bits)
  v5_words  v3 with the low nibbles of four bytes masked by one word mask
  v4_native two signed nibbles of consecutive K rows a byte: sign-extend,
            convert, multiply
  vpu_only  unpack only, no product
  dma_only  no unpack, one product against the raw bytes

Each variant is a CUDA kernel of csrc/bench_int4_kernel.cu with its plain
PyTorch version beside it (`*_plain`, taken by CPU tensors) and its launch
counter. A timed launch finds its tiles out of the L2 (copies are rotated).
The JAX script's `block_k2` is a Pallas grid parameter; the sweep here walks
the tile width (the data's format) and, for v3, the CUDA kernel's own split of
a block between columns and K (`band` = 32, 64 or 128 columns a block, i.e.
32, 16 or 8 row groups across K).

Run: python3 -m teochat_torch.bench.int4_kernel [--quick | --stage2 | --sass]
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from teochat_torch.bench import _timing
from teochat_torch.ops import _build
from teochat_torch.ops import int4_matmul as int4_mod
from teochat_torch.ops.int4_matmul import TILE_BN, untile
from teochat_torch.ops.quant import quantized_proj
from teochat_torch.utils import resolve_device

K, N = 4096, 11008
M = 1
# largest error over the largest |reference| against the exact x @ unpack * scale:
# the bf16 output rounding alone is up to 2^-8 of an element (as K3); the byte
# reuse also rounds xa = x_lo - x_hi / 16 to bf16 (2^-9 relative on each term of
# the low half: ~1e-3 relative L2, a few times that at the worst element)
EXACT_REL_MAX = 4e-3
BYTE_REUSE_REL_MAX = 1e-2

LAUNCHES_V2 = _build.LaunchCounter("bench_int4_v2")
LAUNCHES_V3 = _build.LaunchCounter("bench_int4_v3")
LAUNCHES_V4 = _build.LaunchCounter("bench_int4_v4")
LAUNCHES_V5 = _build.LaunchCounter("bench_int4_v5")
LAUNCHES_VPU = _build.LaunchCounter("bench_int4_vpu")
LAUNCHES_DMA = _build.LaunchCounter("bench_int4_dma")

pack_int4_i8 = int4_mod.pack_int4_tiled_i8  # [K, N] -> [n_tiles, K/2, bn] int8, b = (L+8) + 16 H


def pack_int4_native(w_q: torch.Tensor, bn: int = TILE_BN) -> torch.Tensor:
    """[K, N] int4 values -> [n_tiles, K/2, bn] uint8 (N zero-padded): the
    [n_tiles, K, bn] 4-bit array stored two values a byte, K row 2i in the low
    nibble and 2i + 1 in the high one, both signed (two's complement)."""
    k = int4_mod._even_fan_in(w_q)
    nib = (w_q.to(torch.int32) & 0xF).to(torch.uint8).reshape(k // 2, 2, -1)
    return int4_mod._tile(nib[:, 0] | (nib[:, 1] << 4), bn)


def unpack_int4_native(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[n_tiles, K/2, bn] native bytes -> [K, n_tiles * bn] signed values."""
    p = untile(packed).to(torch.int32)
    lo, hi = ((p & 0xF) ^ 8) - 8, ((p >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=1).reshape(2 * p.shape[0], p.shape[1]).to(dtype)


def byte_reuse_operands(x: torch.Tensor, k2: int):
    """(xa, xb) of the byte-reuse identity, rounded to x's dtype:
    xb = x_hi / 16, xa = x_lo - xb."""
    x_lo, x_hi = x[:, :k2], x[:, k2:]
    xb = (x_hi.float() / 16.0).to(x.dtype)
    xa = (x_lo.float() - xb.float()).to(x.dtype)
    return xa.contiguous(), xb.contiguous()


# ----------------------------------------------------------- plain versions

def _byte_reuse_plain(x, lo, byte, scale, n_out: int, c: float, operands):
    """(xa @ lo + xb @ byte - 8 (sum xa + c sum xb)) * scale in fp32."""
    xa, xb = operands or byte_reuse_operands(x, lo.shape[0])
    xa, xb = xa.float(), xb.float()
    y = xa @ lo.float() + xb @ byte.float()
    y = y - 8.0 * (xa.sum(1) + c * xb.sum(1))[:, None]
    return (y[:, :n_out] * scale[:n_out].float()).to(x.dtype)


def v2_matmul_plain(x, packed_tiles, scale, *, n_out, operands=None):
    """What S1-v2 computes: u8 byte = (L+8) + 16 (H+8), correction 8 (sum xa + 17 sum xb)."""
    p = untile(packed_tiles).to(torch.int32)
    return _byte_reuse_plain(x, p & 0xF, p, scale, n_out, 17.0, operands)


def v3_matmul_plain(x, packed_i8, scale, *, n_out, mask_dtype=torch.int32, operands=None):
    """What S1-v3 computes: int8 byte b = (L+8) + 16 H, correction 8 sum (xa + xb).
    `mask_dtype` is the width the low-nibble mask runs at, not the result."""
    b = untile(packed_i8)
    lo = b.to(mask_dtype) & 0xF  # on the two's-complement bits
    return _byte_reuse_plain(x, lo, b.to(torch.int32), scale, n_out, 1.0, operands)


def v5_matmul_plain(x, packed_i8, scale, *, n_out, operands=None):
    """What S1-v5 computes: v3 with four low nibbles masked a 32-bit word at a time."""
    words = packed_i8.contiguous().view(torch.int32) & 0x0F0F0F0F
    lo = untile(words.view(torch.int8))
    return _byte_reuse_plain(x, lo, untile(packed_i8).to(torch.int32), scale, n_out, 1.0,
                             operands)


def v4_matmul_plain(x, packed_i4, scale, *, n_out):
    """What S1-v4 computes: x @ w * scale on the natively stored signed nibbles."""
    w = unpack_int4_native(packed_i4, torch.float32)
    return ((x.float() @ w)[:, :n_out] * scale[:n_out].float()).to(x.dtype)


def vpu_only_plain(packed_tiles):
    """What S1-vpu computes: per column the sum over byte rows of (lo - 8) + (hi - 8)
    of the u8 format, padded columns included: ([n_tiles, bn] fp32, their total)."""
    p = packed_tiles.to(torch.int32)
    cols = ((p & 0xF) + (p >> 4) - 16).sum(dim=1).float()
    return cols, cols.sum()


def dma_only_matmul_plain(x, packed_tiles, *, n_out):
    """What S1-dma computes: x_lo @ float(byte), unscaled."""
    p = untile(packed_tiles).float()
    return (x[:, : p.shape[0]].float() @ p)[:, :n_out].to(x.dtype)


# ------------------------------------------------------------ the wrappers

def _on_card(name: str, x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {x.device}")


def _check_tiles(name, tiles, dtype, band=0):
    if tiles.dtype != dtype or tiles.ndim != 3 or not tiles.is_contiguous():
        raise ValueError(f"{name}: tiles must be contiguous [n_tiles, K/2, bn] {dtype}, got "
                         f"{tuple(tiles.shape)} {tiles.dtype}")
    n_tiles, k2, bn = tiles.shape
    if bn % 128 or k2 % 8 or band not in (0, 32, 64, 128):
        raise ValueError(f"{name}: tile width {bn} (need a multiple of 128), {k2} byte rows "
                         f"(a multiple of 8) or band {band} not supported")
    return n_tiles, k2, bn


def _check_product(name, x, tiles, scale, n_out):
    n_tiles, k2, bn = tiles.shape
    _build.check_bf16_operand("x", x, 2)
    if x.shape[1] != 2 * k2 or not 0 < n_out <= n_tiles * bn:
        raise ValueError(f"{name}: x {tuple(x.shape)} against {k2} byte rows, n_out {n_out}")
    if scale is not None and (scale.dtype != torch.float32 or scale.ndim != 1
                              or scale.shape[0] < n_out or not scale.is_contiguous()):
        raise ValueError(f"{name}: scale must be contiguous fp32 with at least {n_out} entries")
    if any(t.device != x.device for t in (tiles, scale) if t is not None):
        raise ValueError(f"{name}: x, tiles and scale on different devices")


def _byte_reuse_cuda(entry, counter, x, tiles, dtype, scale, n_out, band, operands, extra=()):
    n_tiles, k2, bn = _check_tiles(entry, tiles, dtype, band)
    _check_product(entry, x, tiles, scale, n_out)
    xa, xb = operands or byte_reuse_operands(x, k2)
    for name, t in (("xa", xa), ("xb", xb)):
        _build.check_bf16_operand(name, t, 2)
        if t.shape != (x.shape[0], k2) or not t.is_contiguous():
            raise ValueError(f"{entry}: {name} must be contiguous [M, K/2]")
    out = torch.empty((x.shape[0], n_out), dtype=x.dtype, device=x.device)
    _build.launch(entry, x, xa.data_ptr(), xb.data_ptr(), tiles.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), x.shape[0], k2, n_tiles, bn, n_out, band, *extra)
    counter.count += 1
    return out


def v2_matmul(x, packed_tiles, scale, *, n_out, operands=None):
    """S1-v2: byte reuse on u8 tiles. x [M, K]; packed_tiles uint8 [n_tiles, K/2, bn];
    scale fp32 with at least n_out entries. `operands` = byte_reuse_operands(x, K/2),
    where the caller has them already."""
    if not _on_card("v2_matmul", x):
        return v2_matmul_plain(x, packed_tiles, scale, n_out=n_out, operands=operands)
    return _byte_reuse_cuda("teochat_bench_int4_v2", LAUNCHES_V2, x, packed_tiles, torch.uint8,
                            scale, n_out, 0, operands)


def v3_matmul(x, packed_i8, scale, *, n_out, band=0, mask_dtype=torch.int32, operands=None):
    """S1-v3: the same identity on int8 bytes; mask_dtype int32 or int16. `band`
    (the tile sweep) fixes the columns a block owns: 0 lets the kernel choose."""
    if mask_dtype not in (torch.int32, torch.int16):
        raise ValueError(f"v3_matmul: mask_dtype {mask_dtype}")
    if not _on_card("v3_matmul", x):
        return v3_matmul_plain(x, packed_i8, scale, n_out=n_out, mask_dtype=mask_dtype,
                               operands=operands)
    return _byte_reuse_cuda("teochat_bench_int4_v3", LAUNCHES_V3, x, packed_i8, torch.int8,
                            scale, n_out, band, operands, (int(mask_dtype == torch.int16),))


def v5_matmul(x, packed_i8, scale, *, n_out, operands=None):
    """S1-v5: v3 with the low nibbles masked a word at a time."""
    if not _on_card("v5_matmul", x):
        return v5_matmul_plain(x, packed_i8, scale, n_out=n_out, operands=operands)
    return _byte_reuse_cuda("teochat_bench_int4_v5", LAUNCHES_V5, x, packed_i8, torch.int8,
                            scale, n_out, 0, operands)


def v4_matmul(x, packed_i4, scale, *, n_out):
    """S1-v4: natively stored signed nibbles (pack_int4_native), no byte trick."""
    if not _on_card("v4_matmul", x):
        return v4_matmul_plain(x, packed_i4, scale, n_out=n_out)
    n_tiles, k2, bn = _check_tiles("v4_matmul", packed_i4, torch.uint8)
    _check_product("v4_matmul", x, packed_i4, scale, n_out)
    if not x.is_contiguous():
        raise ValueError("v4_matmul: x must be contiguous")
    out = torch.empty((x.shape[0], n_out), dtype=x.dtype, device=x.device)
    _build.launch("teochat_bench_int4_v4", x, x.data_ptr(), packed_i4.data_ptr(),
                  scale.data_ptr(), out.data_ptr(), x.shape[0], k2, n_tiles, bn, n_out, 0)
    LAUNCHES_V4.count += 1
    return out


def vpu_only(packed_tiles):
    """S1-vpu: the unpack alone. Returns ([n_tiles, bn] fp32 column sums, their total)."""
    if not _on_card("vpu_only", packed_tiles):
        return vpu_only_plain(packed_tiles)
    n_tiles, k2, bn = _check_tiles("vpu_only", packed_tiles, torch.uint8)
    cols = torch.empty((n_tiles, bn), dtype=torch.float32, device=packed_tiles.device)
    _build.launch("teochat_bench_int4_vpu", packed_tiles, packed_tiles.data_ptr(),
                  cols.data_ptr(), k2, n_tiles, bn, 0)
    LAUNCHES_VPU.count += 1
    return cols, cols.sum()


def dma_only_matmul(x, packed_tiles, *, n_out):
    """S1-dma: x_lo @ float(byte), unscaled: the floor set by the bytes and one product."""
    if not _on_card("dma_only_matmul", x):
        return dma_only_matmul_plain(x, packed_tiles, n_out=n_out)
    n_tiles, k2, bn = _check_tiles("dma_only_matmul", packed_tiles, torch.uint8)
    _check_product("dma_only_matmul", x, packed_tiles, None, n_out)
    out = torch.empty((x.shape[0], n_out), dtype=x.dtype, device=x.device)
    _build.launch("teochat_bench_int4_dma", x, x.data_ptr(), x.stride(0), packed_tiles.data_ptr(),
                  out.data_ptr(), x.shape[0], k2, n_tiles, bn, n_out, 0)
    LAUNCHES_DMA.count += 1
    return out


COUNTERS = {"S1-v2": LAUNCHES_V2, "S1-v3": LAUNCHES_V3, "S1-v4": LAUNCHES_V4,
            "S1-v5": LAUNCHES_V5, "S1-vpu": LAUNCHES_VPU, "S1-dma": LAUNCHES_DMA}


# ----------------------------------------------------------------- harness

def _pad_scale(scale: torch.Tensor, n_pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(scale, (0, n_pad - scale.shape[0]))


def time_variant(rows, name, call, tiles, nbytes=K // 2 * N):
    """ms a call and effective GB/s (`nbytes` of packed weight over the time);
    `call(tiles)` gets the next of a rotation of copies that exceeds the L2."""
    nxt = _timing.rotation(tiles)
    ms = _timing.time_ms(lambda: call(nxt()))
    gbs = nbytes / (ms * 1e-3) / 1e9
    print(f"{name:32s} {ms:8.4f} ms/call   {gbs:7.1f} GB/s effective", flush=True)
    rows.append({"row": name, "ms": ms, "gbps": gbs})
    return ms


def _inputs(device, m=M):
    rng = np.random.RandomState(0)
    w_q = torch.from_numpy(rng.randint(-8, 8, size=(K, N)).astype(np.int8)).to(device)
    scale_full = torch.from_numpy(rng.rand(N).astype(np.float32) * 0.01).to(device)
    x = torch.from_numpy(rng.randn(m, K).astype(np.float32)).to(device, torch.bfloat16)
    return rng, w_q, scale_full, x


def _header(device):
    if device.type != "cuda":
        raise RuntimeError("the kernel bench measures the card: it does not run on the CPU")
    smi = _timing.smi_line()
    print(smi, flush=True)
    lib = _build.library()
    print(f"[build] {lib.path.name} nvcc {lib.build_seconds:.2f}s", flush=True)
    return smi


def _finish(bench: str, smi: str, rows):
    out = {"bench": bench, "device": torch.cuda.get_device_name(0), "smi": smi,
           "shape": {"K": K, "N": N, "M": M}, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


def stage2(device=None):
    """Separate the per-call overhead from the per-byte rate."""
    device = resolve_device(device)
    smi = _header(device)
    rng, w_q, scale_full, x = _inputs(device)
    w_q2 = torch.from_numpy(rng.randint(-8, 8, size=(K, N)).astype(np.int8)).to(device)
    x8 = torch.from_numpy(rng.randn(8, K).astype(np.float32)).to(device, torch.bfloat16)
    tiles, tiles2 = int4_mod.pack_int4_tiled(w_q), int4_mod.pack_int4_tiled(w_q2)
    sp = _pad_scale(scale_full, tiles.shape[0] * TILE_BN)
    rows = []

    # the port's int8 weight-only projection on the same values (K * N bytes)
    time_variant(rows, "int8 convert + torch.matmul (45 MB)",
                 lambda w: quantized_proj(x, {"kernel": w, "scale": scale_full}), w_q,
                 nbytes=K * N)
    # the plain int4 version: unpack, then a matmul
    time_variant(rows, "plain unpack + matmul",
                 lambda p: int4_mod.int4_matmul_plain(x, p, scale_full), int4_mod.pack_int4(w_q))
    # K3b once and twice a call: the difference is what the bytes cost
    time_variant(rows, "K3b x1", lambda t: int4_mod.int4_matmul_tiled(x, t, sp, n_out=N), tiles)
    nxt2 = _timing.rotation(tiles2)
    time_variant(rows, "K3b x2",
                 lambda t: int4_mod.int4_matmul_tiled(x, t, sp, n_out=N)
                 + int4_mod.int4_matmul_tiled(x, nxt2(), sp, n_out=N), tiles,
                 nbytes=K * N)
    time_variant(rows, "K3b m=8", lambda t: int4_mod.int4_matmul_tiled(x8, t, sp, n_out=N), tiles)
    return _finish("int4_kernel stage2", smi, rows)


def main(quick: bool = False, device=None):
    device = resolve_device(device)
    smi = _header(device)
    _, w_q, scale_full, x = _inputs(device)
    x8 = torch.from_numpy(np.random.RandomState(1).randn(8, K).astype(np.float32)).to(
        device, torch.bfloat16)
    tiles, tiles_i8 = int4_mod.pack_int4_tiled(w_q), pack_int4_i8(w_q)
    tiles_i4 = pack_int4_native(w_q)
    scale_pad = _pad_scale(scale_full, tiles.shape[0] * TILE_BN)
    rows = []

    variants = [  # (name, tiles, call(x, tiles), bound against the exact product)
        ("v0", tiles, lambda xx, t: int4_mod.int4_matmul_tiled(xx, t, scale_pad, n_out=N),
         EXACT_REL_MAX),
        ("v2_byte", tiles, lambda xx, t: v2_matmul(xx, t, scale_pad, n_out=N),
         BYTE_REUSE_REL_MAX),
        ("v3_i8", tiles_i8, lambda xx, t: v3_matmul(xx, t, scale_pad, n_out=N),
         BYTE_REUSE_REL_MAX),
        ("v3_i8_m16", tiles_i8,
         lambda xx, t: v3_matmul(xx, t, scale_pad, n_out=N, mask_dtype=torch.int16),
         BYTE_REUSE_REL_MAX),
        ("v5_words", tiles_i8, lambda xx, t: v5_matmul(xx, t, scale_pad, n_out=N),
         BYTE_REUSE_REL_MAX),
        ("v4_native", tiles_i4, lambda xx, t: v4_matmul(xx, t, scale_pad, n_out=N),
         EXACT_REL_MAX),
    ]
    # correctness against the exact product x @ unpack * scale, at M = 1 and 8
    w = int4_mod.unpack_int4_halves(int4_mod.pack_int4(w_q), torch.float32)
    for xx in (x, x8):
        ref = xx.float() @ w * scale_full
        top = ref.abs().max().item() + 1e-9
        for name, t, fn, bound in variants:
            err = (fn(xx, t).float() - ref).abs().max().item() / top
            print(f"{name:10s} M={xx.shape[0]} rel_err={err:.2e} (bound {bound})", flush=True)
            rows.append({"row": name, "M": xx.shape[0], "rel_err": err})
            if not err <= bound:
                raise RuntimeError(f"{name} M={xx.shape[0]}: rel_err {err} > {bound}")
        # the two probes against their plain versions (dma reaches ~1e5: relative)
        got, want = dma_only_matmul(xx, tiles, n_out=N).float(), dma_only_matmul_plain(
            xx.float(), tiles, n_out=N)
        err = (got - want).abs().max().item() / want.abs().max().item()
        rows.append({"row": "dma_only", "M": xx.shape[0], "rel_err": err})
        if not err <= EXACT_REL_MAX:
            raise RuntimeError(f"dma_only M={xx.shape[0]}: rel_err {err} > {EXACT_REL_MAX}")
    cols, total = vpu_only(tiles)
    want_cols, want_total = vpu_only_plain(tiles)
    if not (torch.equal(cols, want_cols) and total.item() == want_total.item()):
        raise RuntimeError("vpu_only: column sums differ from the plain version")
    rows.append({"row": "vpu_only", "total": total.item()})
    print(f"dma_only, vpu_only agree with their plain versions (vpu total {total.item():.0f})",
          flush=True)

    for xx in (x, x8):
        m = xx.shape[0]
        tag = "" if m == 1 else f" m={m}"
        time_variant(rows, "dma_only" + tag, lambda t: dma_only_matmul(xx, t, n_out=N), tiles)
        for name, t0, fn, _ in variants:
            time_variant(rows, name + tag, lambda t: fn(xx, t), t0)
        # the byte-reuse kernels alone, xa and xb made beforehand
        ops = byte_reuse_operands(xx, K // 2)
        for name, t0, fn in (
            ("v2_byte", tiles, v2_matmul), ("v3_i8", tiles_i8, v3_matmul),
            ("v5_words", tiles_i8, v5_matmul),
        ):
            time_variant(rows, f"{name} kernel alone{tag}",
                         lambda t: fn(xx, t, scale_pad, n_out=N, operands=ops), t0)
        time_variant(rows, f"v3_i8_m16 kernel alone{tag}",
                     lambda t: v3_matmul(xx, t, scale_pad, n_out=N, mask_dtype=torch.int16,
                                         operands=ops), tiles_i8)
    time_variant(rows, "vpu_only", lambda t: vpu_only(t)[0], tiles)
    if quick:
        return _finish("int4_kernel quick", smi, rows)

    # tile sweep: fewer, wider tiles; for v3 also the block's own column / K split
    ops = byte_reuse_operands(x, K // 2)
    for bn_tile in (512, 1024, 2048):
        tiles_b = int4_mod.pack_int4_tiled(w_q, bn_tile)
        tiles_i8_b = pack_int4_i8(w_q, bn_tile)
        sp = _pad_scale(scale_full, tiles_b.shape[0] * bn_tile)
        time_variant(rows, f"v0 bn={bn_tile}",
                     lambda t: int4_mod.int4_matmul_tiled(x, t, sp, n_out=N), tiles_b)
        for band in (32, 64, 128):
            cells = tiles_b.shape[0] * bn_tile // band
            time_variant(rows, f"v3 bn={bn_tile} band={band} cells={cells}",
                         lambda t: v3_matmul(x, t, sp, n_out=N, band=band, operands=ops),
                         tiles_i8_b)
    return _finish("int4_kernel", smi, rows)


# ------------------------------------------------------------- what was compiled

def sass_counts():
    """Instruction counts by opcode of each S1 kernel's BN = 32, MT = 1
    instantiation, from `cuobjdump -sass` of the built library."""
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(_build.library().path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        found = re.match(r"\S*bench_int4_(\w+?)_kernelILi32ELi1E", block)
        if found:
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_]*)", block)
            out[found.group(1)] = dict(Counter(ops).most_common())
    return out


if __name__ == "__main__":
    if "--sass" in sys.argv:
        print(json.dumps({"sass": sass_counts()}))
    elif "--stage2" in sys.argv:
        stage2()
    else:
        main(quick="--quick" in sys.argv)
