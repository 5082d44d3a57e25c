"""Kernel bench: int4 fused-dequant matmul unpack variants on the card.

Port of scripts/bench_int4_kernel.py. It times unpack strategies on a
representative decode projection (gate: [1, 4096] x [4096, 11008]):

  v0        the production kernel (ops/int4_matmul.int4_matmul_tiled, K3b):
            both nibbles extracted, two subtractions, two products
  v2_byte   byte reuse on u8 tiles: y = xa @ lo + xb @ byte with
            xb = x_hi / 16, xa = x_lo - xb; the high nibble is never extracted
  v3_i8     the same on int8 bytes b = (L + 8) + 16 H (mask at 32 or 16 bits)
  v5_words  v3 with the low nibbles of four bytes masked by one word mask
  v4_native two signed nibbles of consecutive K rows a byte, decoded under
            the magic exponent 2^23 (no int-to-float conversion)
  vpu_only  unpack only, no product
  dma_only  no unpack, one product against the raw bytes

Each variant is a CUDA kernel of csrc/bench_int4_kernel.cu with its plain
PyTorch version beside it (`*_plain`, taken by CPU tensors) and its launch
counter. A timed launch finds its tiles out of the L2 (copies are rotated).
All six run on one body, the ring: items of (tile, K slice), each slice
streamed by bulk copies into a shared-memory ring, fp32 FMAs at M = 1 (v3 at
every M; v2, v4, v5 and dma at M > 1 on mma.sync; vpu takes no x, so M is
1), the slices' fp32 partials merged in the launch by the tile's last block;
`ring_k_slices` picks the slice count from the card's SM count and
`ring_schedule` is the walk in plain PyTorch, for the CPU tests. The JAX
script's `block_k2` is a Pallas grid parameter; the sweep here walks the tile
width (the data's format) and, for v3, the ring's `k_slices` (the K slices of
a tile: items = tiles x k_slices).

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
from teochat_torch.ops.int4_matmul import H100_SXM_SMS, TILE_BN, untile
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

# The ring body of all six S1 kernels (csrc/bench_int4_kernel.cu: RING_*)
RING_STAGES = 4  # stages of the shared-memory ring
RING_STAGE_BYTES = 16384  # a stage: the whole groups of RING_ALIGN rows it holds (32 at tw 512)
RING_WARPS = 8  # consumer warps at M > 1; one more warp issues the bulk copies
RING_WARPS_M1 = 16  # consumer warps at M = 1
RING_ALIGN = 8  # a K slice's byte rows are whole groups of this
RING_X_BYTES = 80 * 1024  # the most shared memory an item's slice of x takes
RING_M_TILE = 8  # rows of x an item takes where M > 1
RING_MAX_TW = 2048  # widest tile the ring takes
# the longest slice whose x fits at RING_M_TILE rows (4 bytes of x a byte row a row)
RING_MAX_SLICE_ROWS = RING_X_BYTES // (4 * RING_M_TILE)

LAUNCHES_V2 = _build.LaunchCounter("bench_int4_v2")
LAUNCHES_V3 = _build.LaunchCounter("bench_int4_v3")
LAUNCHES_V4 = _build.LaunchCounter("bench_int4_v4")
LAUNCHES_V5 = _build.LaunchCounter("bench_int4_v5")
LAUNCHES_VPU = _build.LaunchCounter("bench_int4_vpu")
LAUNCHES_DMA = _build.LaunchCounter("bench_int4_dma")

pack_int4_i8 = int4_mod.pack_int4_tiled_i8  # [K, N] -> [n_tiles, K/2, bn] int8, b = (L+8) + 16 H

# The byte-reuse variants on the ring: (tile dtype, the correction's coefficient
# on sum xb: 8 (sum xa + c sum xb); v2's high nibble is stored + 8 as well)
BYTE_REUSE = {"v2": (torch.uint8, 17.0), "v3": (torch.int8, 1.0), "v5": (torch.int8, 1.0)}
RING_VARIANTS = (*BYTE_REUSE, "v4", "dma", "vpu")


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


# ----------------------------------------------------------- the ring body

def ring_stage_rows(tw: int) -> int:
    """The byte rows of a stage of a tile `tw` bytes wide: the whole groups
    of RING_ALIGN rows that RING_STAGE_BYTES holds."""
    return RING_STAGE_BYTES // tw // RING_ALIGN * RING_ALIGN


def ring_slice_rows(k2: int, k_slices: int) -> int:
    """The byte rows of each K slice but the last, as the ring kernels cut
    them: k2 / k_slices rounded up to whole groups of RING_ALIGN."""
    per_slice = -(-k2 // k_slices)
    return -(-per_slice // RING_ALIGN) * RING_ALIGN


def _exact_k_slices(k2: int, k_slices: int) -> int:
    """The largest count at most `k_slices` that the kernels' cut gives
    exactly (no slice left without rows)."""
    while -(-k2 // ring_slice_rows(k2, k_slices)) != k_slices:
        k_slices -= 1
    return k_slices


def ring_k_slices(n_tiles: int, k2: int, sms: int) -> int:
    """How many K slices the ring kernels cut each tile's k2 byte rows into,
    on a card of `sms` SMs: as many as fill whole waves of one item an SM
    (22 tiles x 6 = 132 at tw 512, 11 x 12 at tw 1024, 6 x 22 at tw 2048),
    one where the tiles alone fill the card; at least enough that a slice of
    x fits beside the ring (RING_MAX_SLICE_ROWS), slices of RING_ALIGN rows
    at most; then the largest count at most that which the cut gives exactly.
    M does not enter: rows of x past RING_M_TILE are more items."""
    k_slices = max(1, min(sms // n_tiles, k2 // RING_ALIGN))
    k_slices = max(k_slices, -(-k2 // RING_MAX_SLICE_ROWS))
    return _exact_k_slices(k2, k_slices)


def _ring_m_tile(m: int) -> int:
    return 1 if m == 1 else RING_M_TILE


def _check_k_slices(name: str, k2: int, k_slices: int, m: int) -> None:
    """Raise unless the ring kernels take `k_slices` for k2 byte rows at M = m."""
    rows = ring_slice_rows(k2, k_slices) if k_slices >= 1 else 0
    if (k_slices < 1 or -(-k2 // rows) != k_slices
            or 4 * rows * _ring_m_tile(m) > RING_X_BYTES):
        raise ValueError(f"{name}: k_slices {k_slices} does not cut {k2} byte rows into "
                         f"slices that all have rows and whose x fits at M {m}")


def _ring_decode(variant: str, tiles: torch.Tensor):
    """The multiplicands the ring kernels take from each byte, as fp32
    [n_tiles, k2, tw] pairs (wa, wb): v2 (p & 15, p) on u8 bytes; v3
    (b & 15, b) on int8 bytes; v5 the same with the low nibbles masked a
    32-bit word at a time; v4 (L, 16 H) of the native nibbles; dma (p, None);
    vpu the u8 format's (lo - 8, hi - 8), which it adds."""
    if variant in ("dma", "vpu"):
        p = tiles.view(torch.uint8).to(torch.int32)
        if variant == "dma":
            return p.float(), None
        return ((p & 0xF) - 8).float(), ((p >> 4) - 8).float()
    if variant == "v4":
        s = tiles.view(torch.uint8).to(torch.int32) ^ 0x88  # every nibble + 8
        return ((s & 0xF) - 8).float(), ((s & 0xF0) - 128).float()
    if variant == "v2":
        byte = tiles.view(torch.uint8).to(torch.int32)
        return (byte & 0xF).float(), byte.float()
    byte = tiles.view(torch.int8)
    if variant == "v5":
        lo = (byte.contiguous().view(torch.int32) & 0x0F0F0F0F).view(torch.int8)
    else:
        lo = byte.to(torch.int32) & 0xF
    return lo.float(), byte.float()


def ring_schedule(x: torch.Tensor | None, tiles: torch.Tensor, scale: torch.Tensor | None, *,
                  n_out: int, variant: str, k_slices: int | None = None,
                  sms: int = H100_SXM_SMS, operands=None) -> torch.Tensor:
    """The ring kernels' walk, in plain PyTorch: S1-v2 on u8 tiles, S1-v3 or
    S1-v5 on int8 tiles (the byte-reuse identity on `operands` = (xa, xb),
    made from x unless given), S1-v4 on pack_int4_native's bytes, or the
    probes on u8 tiles: S1-dma (x's first K/2 columns against the byte, no
    scale, no correction) and S1-vpu (no x: x, scale and n_out are unused;
    returns the fp32 column sums [n_tiles, tw] of every column).

    Items of (tile, K slice) for each chunk of RING_M_TILE rows of x (one
    row at M = 1): K cut into `k_slices` slices of `ring_slice_rows` byte
    rows (the last one ragged), `ring_k_slices`' count for a card of `sms`
    SMs unless given; a slice walked in stages of `ring_stage_rows` rows (a
    ragged last stage). v4 decodes L and 16 H and takes x's odd K row / 16
    (at M > 1 the kernel decodes L and H to bf16 for mma.sync, which sums
    the same exact products); the byte reuse takes `_ring_decode`'s low
    nibble against xa and the byte against xb (at M > 1 on mma.sync as the
    bf16 pair (low nibble, byte): the same exact products); dma one product
    a byte (at M > 1 two byte rows a bf16 pair on mma.sync m16n8k8). Each
    item sums into an fp32 partial (the byte reuse: and sums its slice of
    xa + c xb, c = 17 for v2, 1 for v3 and v5); a tile's partials are summed
    in slice order, then the correction, 8 times the items' sums in slice
    order, is taken once, the scale applied and the result rounded once to
    x's dtype (vpu: none of these). Used by tests only."""
    if variant not in RING_VARIANTS:
        raise ValueError(f"ring_schedule: variant {variant!r} not one of {RING_VARIANTS}")
    n_tiles, k2, tw = tiles.shape
    vpu = variant == "vpu"
    m = 1 if vpu else x.shape[0]
    k_slices = ring_k_slices(n_tiles, k2, sms) if k_slices is None else k_slices
    _check_k_slices("ring_schedule", k2, k_slices, m)
    rows, stage_rows = ring_slice_rows(k2, k_slices), ring_stage_rows(tw)
    wa, wb = _ring_decode(variant, tiles)
    corr = torch.zeros(m, device=tiles.device)
    a = b = None
    if variant == "v4":
        xf = x.float()
        a, b = xf[:, 0::2], xf[:, 1::2] / 16.0  # the odd rows meet 16 H
    elif variant == "dma":
        a = x[:, :k2].float()
    elif not vpu:
        xa, xb = operands or byte_reuse_operands(x, k2)
        a, b = xa.float(), xb.float()
        c = BYTE_REUSE[variant][1]
        for r0 in range(0, k2, rows):  # each item's sum of xa + c xb, in slice order
            corr = corr + (a[:, r0:r0 + rows] + c * b[:, r0:r0 + rows]).sum(1)
        corr = 8.0 * corr
    if vpu:
        n_out = n_tiles * tw
        out = torch.empty((n_tiles, tw), dtype=torch.float32, device=tiles.device)
    else:
        out = torch.empty((m, n_out), dtype=x.dtype, device=x.device)
    m_tile = _ring_m_tile(m)
    for m0 in range(0, m, m_tile):
        rm = slice(m0, m0 + m_tile)
        for t in range(n_tiles):
            n0, n1 = t * tw, min(n_out, (t + 1) * tw)
            if n0 >= n_out:
                break
            partials = []
            for r0 in range(0, k2, rows):  # an item
                acc = torch.zeros((min(m, m0 + m_tile) - m0, tw), dtype=torch.float32,
                                  device=tiles.device)
                for s0 in range(r0, min(k2, r0 + rows), stage_rows):  # its stages
                    rs = slice(s0, min(k2, r0 + rows, s0 + stage_rows))
                    if vpu:  # the decoded values, added
                        acc = acc + (wa[t, rs] + wb[t, rs]).sum(0)
                    else:
                        acc = acc + a[rm, rs] @ wa[t, rs]
                        if b is not None:
                            acc = acc + b[rm, rs] @ wb[t, rs]
                partials.append(acc)
            total = partials[0]
            for part in partials[1:]:  # slice order
                total = total + part
            if vpu:
                out[t] = total[0]
                continue
            y = total[:, : n1 - n0]
            if variant != "dma":
                y = (y - corr[rm, None]) * scale[n0:n1].float()
            out[rm, n0:n1] = y.to(x.dtype)
    return out


# The M > 1 consumer's A operand for v2 and v5 (csrc/bench_int4_kernel.cu::
# byte_pair_bf16x2): the byte at bits 0 and 16, its sign over bits 24-31,
# (lo, byte & 127) kept under bf16 128, then the subtrahend taken away.
PAIR_KEEP = 0x007F000F
PAIR_MAGIC = 0x43004300
PAIR_SIGN_U8 = 0xFF000000  # u8: 128 comes off the byte's half only below 128
PAIR_TOP_I8 = 0x00800000  # int8: 256 comes off it where the byte is negative


def byte_pair_bf16x2(byte: torch.Tensor, signed: bool) -> torch.Tensor:
    """The kernel's bf16 pair (low nibble, byte) of each byte (uint8 bits), in
    plain torch with the `.cu`'s constants: [..., 2] bf16 (low half first, as
    mma.sync reads it). The prmt, the two lop3 and the hsub2, written out."""
    b = byte.to(torch.int64) & 0xFF
    h = b | (b << 16) | (b >= 128).to(torch.int64) * 0xFF000000  # sign: selector nibble 8 + P
    v = (h & PAIR_KEEP) | PAIR_MAGIC
    sub = (PAIR_MAGIC | (h & PAIR_TOP_I8)) if signed else (PAIR_MAGIC & ~(h & PAIR_SIGN_U8))
    return _bf16_halves(v) - _bf16_halves(sub)  # bf16 - bf16 of small integers: exact


def _bf16_halves(word: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) -> [..., 2] bf16, the low half first."""
    bits = torch.stack([word & 0xFFFF, word >> 16], dim=-1)
    return (bits - (bits >= 0x8000).to(torch.int64) * 0x10000).to(torch.int16).view(
        torch.bfloat16)


# dma's M > 1 A operand (csrc/bench_int4_kernel.cu::byte_rows_bf16x2): a byte
# of each of two byte rows, each with its sign above it
ROWS_KEEP = 0x007F007F


def byte_rows_bf16x2(byte0: torch.Tensor, byte1: torch.Tensor) -> torch.Tensor:
    """The kernel's bf16 pair (byte0, byte1) of two u8 bytes, in plain torch
    with the `.cu`'s constants: [..., 2] bf16. The prmt, the two lop3 and the
    hsub2, written out."""
    b0, b1 = byte0.to(torch.int64) & 0xFF, byte1.to(torch.int64) & 0xFF
    # selector nibbles P, 8 + P, 4 + P, 12 + P: each byte, then its sign replicated
    h = b0 | (b0 >= 128).long() * 0xFF00 | b1 << 16 | (b1 >= 128).long() * 0xFF000000
    v = (h & ROWS_KEEP) | PAIR_MAGIC
    sub = PAIR_MAGIC & ~h
    return _bf16_halves(v) - _bf16_halves(sub)  # bf16 - bf16 of small integers: exact


# ------------------------------------------------------------ the wrappers

def _on_card(name: str, x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {x.device}")


def _check_tiles(name, tiles, dtype):
    if tiles.dtype != dtype or tiles.ndim != 3 or not tiles.is_contiguous():
        raise ValueError(f"{name}: tiles must be contiguous [n_tiles, K/2, bn] {dtype}, got "
                         f"{tuple(tiles.shape)} {tiles.dtype}")
    n_tiles, k2, bn = tiles.shape
    if bn % 128 or k2 % 8:
        raise ValueError(f"{name}: tile width {bn} (need a multiple of 128) or {k2} byte rows "
                         "(a multiple of 8) not supported")
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


def _byte_reuse_operands_cuda(entry, x, k2, operands):
    xa, xb = operands or byte_reuse_operands(x, k2)
    for name, t in (("xa", xa), ("xb", xb)):
        _build.check_bf16_operand(name, t, 2)
        if t.shape != (x.shape[0], k2) or not t.is_contiguous():
            raise ValueError(f"{entry}: {name} must be contiguous [M, K/2]")
    return xa, xb


def _ring_split(entry, m, device, tiles, k_slices):
    """The ring entries' last arguments for M = m rows of x on `device`: the
    K slices (0: `ring_k_slices` for that card), the items' fp32 partials (a
    fresh buffer each call, of a size fixed by the shape) and the tiles' zero
    tickets (a kept buffer); (1, 0, 0) where K is not split. Also returns the
    partials' tensor, which the caller holds until the launch is enqueued."""
    n_tiles, k2, bn = tiles.shape
    if bn > RING_MAX_TW or tiles.data_ptr() % 16:
        raise ValueError(f"{entry}: tiles {bn} wide (at most {RING_MAX_TW}) or not 16-byte "
                         "aligned")
    if k_slices == 0:
        k_slices = ring_k_slices(n_tiles, k2, _build.sm_count(device))
    _check_k_slices(entry, k2, k_slices, m)
    if k_slices == 1:
        return (1, 0, 0), None
    # the items' partials [n_tiles, k_slices, M, bn], then the byte reuse's row sums
    # [n_tiles, k_slices, M]
    part = torch.empty(n_tiles * k_slices * m * (bn + 1), dtype=torch.float32, device=device)
    tickets = _build.tickets_for(device, -(-m // _ring_m_tile(m)) * n_tiles)
    return (k_slices, part.data_ptr(), tickets.data_ptr()), part


def _byte_reuse_ring(variant, x, tiles, scale, n_out, k_slices, operands, *flags):
    """Launch S1-v2, v3 or v5 on the ring body; `flags` (v3's mask width) go
    between the K slices and the workspace."""
    entry = f"teochat_bench_int4_{variant}"
    n_tiles, k2, bn = _check_tiles(entry, tiles, BYTE_REUSE[variant][0])
    _check_product(entry, x, tiles, scale, n_out)
    xa, xb = _byte_reuse_operands_cuda(entry, x, k2, operands)
    split, _part = _ring_split(entry, x.shape[0], x.device, tiles, k_slices)
    out = torch.empty((x.shape[0], n_out), dtype=x.dtype, device=x.device)
    _build.launch(entry, x, xa.data_ptr(), xb.data_ptr(), tiles.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), x.shape[0], k2, n_tiles, bn, n_out, split[0], *flags,
                  *split[1:])
    COUNTERS[f"S1-{variant}"].count += 1
    return out


def v2_matmul(x, packed_tiles, scale, *, n_out, k_slices=0, operands=None):
    """S1-v2: byte reuse on u8 tiles, on the ring body. x [M, K]; packed_tiles
    uint8 [n_tiles, K/2, bn]; scale fp32 with at least n_out entries.
    `operands` = byte_reuse_operands(x, K/2), where the caller has them
    already. `k_slices` (the sweep) fixes the K slices of a tile: 0 takes
    `ring_k_slices` for the card."""
    if not _on_card("v2_matmul", x):
        return v2_matmul_plain(x, packed_tiles, scale, n_out=n_out, operands=operands)
    return _byte_reuse_ring("v2", x, packed_tiles, scale, n_out, k_slices, operands)


def v3_matmul(x, packed_i8, scale, *, n_out, k_slices=0, mask_dtype=torch.int32, operands=None):
    """S1-v3: the same identity on int8 bytes, on the ring body; mask_dtype int32
    or int16; `k_slices` as for v2_matmul."""
    if mask_dtype not in (torch.int32, torch.int16):
        raise ValueError(f"v3_matmul: mask_dtype {mask_dtype}")
    if not _on_card("v3_matmul", x):
        return v3_matmul_plain(x, packed_i8, scale, n_out=n_out, mask_dtype=mask_dtype,
                               operands=operands)
    return _byte_reuse_ring("v3", x, packed_i8, scale, n_out, k_slices, operands,
                            int(mask_dtype == torch.int16))


def v5_matmul(x, packed_i8, scale, *, n_out, k_slices=0, operands=None):
    """S1-v5: v3 with the low nibbles masked a word at a time, on the ring body."""
    if not _on_card("v5_matmul", x):
        return v5_matmul_plain(x, packed_i8, scale, n_out=n_out, operands=operands)
    return _byte_reuse_ring("v5", x, packed_i8, scale, n_out, k_slices, operands)


def v4_matmul(x, packed_i4, scale, *, n_out, k_slices=0):
    """S1-v4: natively stored signed nibbles (pack_int4_native), no byte trick, on
    the ring body; `k_slices` as for v2_matmul."""
    if not _on_card("v4_matmul", x):
        return v4_matmul_plain(x, packed_i4, scale, n_out=n_out)
    entry = "teochat_bench_int4_v4"
    n_tiles, k2, bn = _check_tiles(entry, packed_i4, torch.uint8)
    _check_product(entry, x, packed_i4, scale, n_out)
    if not x.is_contiguous():
        raise ValueError("v4_matmul: x must be contiguous")
    split, _part = _ring_split(entry, x.shape[0], x.device, packed_i4, k_slices)
    out = torch.empty((x.shape[0], n_out), dtype=x.dtype, device=x.device)
    _build.launch(entry, x, x.data_ptr(), packed_i4.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), x.shape[0], k2, n_tiles, bn, n_out, *split)
    LAUNCHES_V4.count += 1
    return out


def vpu_column_sums(packed_tiles, *, k_slices=0):
    """S1-vpu's kernel, on the ring body (no x: M is 1): the [n_tiles, bn]
    fp32 column sums of (lo - 8) + (hi - 8); `k_slices` as for v2_matmul."""
    if not _on_card("vpu_column_sums", packed_tiles):
        return vpu_only_plain(packed_tiles)[0]
    entry = "teochat_bench_int4_vpu"
    n_tiles, k2, bn = _check_tiles(entry, packed_tiles, torch.uint8)
    split, _part = _ring_split(entry, 1, packed_tiles.device, packed_tiles, k_slices)
    cols = torch.empty((n_tiles, bn), dtype=torch.float32, device=packed_tiles.device)
    _build.launch(entry, packed_tiles, packed_tiles.data_ptr(), cols.data_ptr(), k2, n_tiles, bn,
                  *split)
    LAUNCHES_VPU.count += 1
    return cols


def vpu_only(packed_tiles, *, k_slices=0):
    """S1-vpu: the unpack alone. Returns ([n_tiles, bn] fp32 column sums,
    their total): the kernel, then one torch sum, as the script sums its
    kernel's output."""
    if not _on_card("vpu_only", packed_tiles):
        return vpu_only_plain(packed_tiles)
    cols = vpu_column_sums(packed_tiles, k_slices=k_slices)
    return cols, cols.sum()


def dma_only_matmul(x, packed_tiles, *, n_out, k_slices=0):
    """S1-dma: x_lo @ float(byte), unscaled: the floor set by the bytes and one
    product, on the ring body. x [M, K] is read in place (its first K/2
    columns, at its row stride); `k_slices` as for v2_matmul."""
    if not _on_card("dma_only_matmul", x):
        return dma_only_matmul_plain(x, packed_tiles, n_out=n_out)
    entry = "teochat_bench_int4_dma"
    n_tiles, k2, bn = _check_tiles(entry, packed_tiles, torch.uint8)
    _check_product(entry, x, packed_tiles, None, n_out)
    split, _part = _ring_split(entry, x.shape[0], x.device, packed_tiles, k_slices)
    out = torch.empty((x.shape[0], n_out), dtype=x.dtype, device=x.device)
    _build.launch(entry, x, x.data_ptr(), x.stride(0), packed_tiles.data_ptr(), out.data_ptr(),
                  x.shape[0], k2, n_tiles, bn, n_out, *split)
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

    # tile sweep: fewer, wider tiles; for v3 also the K slices of a tile (one,
    # the rule's, twice the rule's: items = tiles x k_slices)
    ops = byte_reuse_operands(x, K // 2)
    for bn_tile in (512, 1024, 2048):
        tiles_b = int4_mod.pack_int4_tiled(w_q, bn_tile)
        tiles_i8_b = pack_int4_i8(w_q, bn_tile)
        sp = _pad_scale(scale_full, tiles_b.shape[0] * bn_tile)
        time_variant(rows, f"v0 bn={bn_tile}",
                     lambda t: int4_mod.int4_matmul_tiled(x, t, sp, n_out=N), tiles_b)
        n_tiles = tiles_b.shape[0]
        rule = ring_k_slices(n_tiles, K // 2, _build.sm_count(device))
        for k_slices in sorted({_exact_k_slices(K // 2, c) for c in (1, rule, 2 * rule)}):
            time_variant(rows, f"v3 bn={bn_tile} k_slices={k_slices} items={n_tiles * k_slices}",
                         lambda t: v3_matmul(x, t, sp, n_out=N, k_slices=k_slices, operands=ops),
                         tiles_i8_b)
    return _finish("int4_kernel", smi, rows)


# ------------------------------------------------------------- what was compiled

# a kernel's mangled name: the ring body's <MT = 1 or 8>
SASS_KERNEL = re.compile(r"\S*bench_int4_(\w+?)_kernelILi(1|8)E")


def sass_key(name: str) -> str | None:
    """The key `sass_counts` files the kernel of mangled name `name` under:
    `v2_ring` .. `v5_ring`, `dma_ring`, `vpu_ring` at M = 1, `v2_ring m8` ..
    at M > 1; None for a name that is no S1 kernel, and for vpu's M > 1
    instance (built because `RING_LAUNCH` names it, empty, never launched)."""
    found = SASS_KERNEL.match(name)
    if not found or found.group(2) == "8" and found.group(1) == "vpu_ring":
        return None
    return found.group(1) + (" m8" if found.group(2) == "8" else "")


def sass_counts():
    """Instruction counts by opcode of each S1 kernel's M = 1 instantiation
    (keyed `v2_ring` .. `v5_ring`, `dma_ring`, `vpu_ring`) and of its M > 1
    one (keyed `v2_ring m8` ..; vpu has none), from `cuobjdump -sass` of
    the built library."""
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(_build.library().path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        key = sass_key(block)
        if key:
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_]*)", block)
            out[key] = dict(Counter(ops).most_common())
    return out


if __name__ == "__main__":
    if "--sass" in sys.argv:
        print(json.dumps({"sass": sass_counts()}))
    elif "--stage2" in sys.argv:
        stage2()
    else:
        main(quick="--quick" in sys.argv)
