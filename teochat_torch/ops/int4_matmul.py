"""Fused int4-dequantize matmul (w4a16): packing, the kernels' wrappers, the plain versions.

Port of teochat_tpu/ops/int4_matmul.py. Packing: W [K, N] int4 -> one byte
per two weights, [K/2, N], where the LOW four bits hold rows [0, K/2) and the
HIGH four bits rows [K/2, K). Two byte formats, told apart by dtype:

    uint8 (v0):  p = (L + 8) | ((H + 8) << 4)
    int8  (v3):  b = (L + 8) + 16 * H            (the v0 bits with the top bit flipped)

and two layouts: flat `[K/2, N]`, and tiled `[ceil(N/bn), K/2, bn]` where each
bn-wide column band is contiguous (N zero-padded; a pad byte decodes to
nonzero values, so padded columns are never scaled into an output).

`int4_matmul` (flat, K3a), `int4_matmul_tiled` (K3b) and
`int4_matmul_tiled_stacked` (K3c, the layer picked from the stacked buffer
without a copy) launch the CUDA kernels of csrc/int4_matmul.cu for a CUDA
tensor and take the plain version beside them (unpack -> matmul with fp32
accumulation -> scale -> cast) for a CPU tensor. On the card x must be bf16
and its rows contiguous; the kernels read the bytes as the quantizer wrote
them and bound their reads of x at its true K, so a fan-in padded at
quantize time needs no padded copy of x. At M <= SMALL_M the wrapper also
picks the decode kernel's K slices (`decode_k_slices`) and hands it an fp32
workspace for the slices' partials and a kept buffer of zero tickets;
`int4_decode_schedule` and `int4_prefill_schedule` are the two kernels'
walks in plain PyTorch, for the CPU tests.
"""

from __future__ import annotations

import torch

from teochat_torch.ops import _build

TILE_BN = 512
# The M > 8 kernel's tiles (csrc/int4_matmul.cu: TEOCHAT_INT4_BM, _BN, _STEP)
PREFILL_BLOCK_M = 128  # rows of x a block: two warpgroups of 64
PREFILL_BLOCK_N = 128  # columns a block
PREFILL_STEP = 64  # byte rows a step: 64 k of each half of K
SMALL_M = 8  # the .cu runs M <= SMALL_M on its split-K mma.sync (decode) kernel
# The M <= 8 kernel's walk (csrc/int4_matmul.cu: TEOCHAT_INT4_DECODE_BN, _ALIGN)
DECODE_BLOCK_N = 128  # columns a block
DECODE_ALIGN = 8  # a K slice's byte rows are whole groups of this (one mma's k)
# The split rule's sizes (PERF.md section 6, PR 10): the kernel's blocks
# resident on an SM at once (csrc/int4_matmul.cu: DC_BLOCKS_PER_SM, held by
# its launch bounds); the most slices a band's last block sums one after
# another before they cost more than they save
DECODE_BLOCKS_PER_SM = 3
DECODE_MAX_SLICES = 32
# The SMs the plain walk assumes unless given a count: an H100 SXM's (the
# wrappers read the count of the card they launch on)
H100_SXM_SMS = 132

LAUNCHES_FLAT = _build.LaunchCounter("int4_matmul")
LAUNCHES_TILED = _build.LaunchCounter("int4_matmul_tiled")
LAUNCHES_STACKED = _build.LaunchCounter("int4_matmul_tiled_stacked")
# the launches of LAUNCHES_STACKED that went to the decode kernel (M <= SMALL_M)
LAUNCHES_STACKED_SMALL_M = _build.LaunchCounter("int4_matmul_tiled_stacked, M <= 8")


# ------------------------------------------------------------------ packing

def _even_fan_in(w_q: torch.Tensor) -> int:
    k = w_q.shape[-2]
    if k % 2:
        raise ValueError(f"int4 packing needs an even fan-in, got {k}")
    return k


def pack_int4(w_q: torch.Tensor) -> torch.Tensor:
    """[..., K, N] int values in [-8, 7] -> packed uint8 [..., K/2, N] (split halves)."""
    k = _even_fan_in(w_q)
    lo = (w_q[..., : k // 2, :].to(torch.int32) + 8).to(torch.uint8)
    hi = (w_q[..., k // 2:, :].to(torch.int32) + 8).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4_halves(packed: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """packed uint8 [..., K/2, N] -> [..., K, N] values (lo half then hi half)."""
    p = packed.to(torch.int32)
    return torch.cat([(p & 0xF) - 8, (p >> 4) - 8], dim=-2).to(dtype)


def pack_int4_i8(w_q: torch.Tensor) -> torch.Tensor:
    """[..., K, N] int values in [-8, 7] -> packed int8 [..., K/2, N], b = (L+8) + 16*H."""
    k = _even_fan_in(w_q)
    lo = w_q[..., : k // 2, :].to(torch.int32) + 8
    hi = w_q[..., k // 2:, :].to(torch.int32)
    return (lo + 16 * hi).to(torch.int8)  # range [-128, 127], exact


def unpack_int4_i8(packed: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """int8 [..., K/2, N] -> [..., K, N] values (lo half then hi half)."""
    p = packed.to(torch.int32)
    # arithmetic shift = floor(b / 16) = H exactly (L + 8 is in [0, 15])
    return torch.cat([(p & 0xF) - 8, p >> 4], dim=-2).to(dtype)


def unpack_int4_any(packed: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Layout-dispatching unpack: int8 = v3 combined byte, uint8 = v0 nibbles."""
    if packed.dtype == torch.int8:
        return unpack_int4_i8(packed, dtype)
    return unpack_int4_halves(packed, dtype)


def _tile(packed: torch.Tensor, bn: int) -> torch.Tensor:
    """[K/2, N] bytes -> [ceil(N/bn), K/2, bn], N zero-padded."""
    k2, n = packed.shape
    n_pad = -(-n // bn) * bn
    if n_pad != n:
        packed = torch.nn.functional.pad(packed, (0, n_pad - n))
    return packed.reshape(k2, n_pad // bn, bn).permute(1, 0, 2).contiguous()


def pack_int4_tiled(w_q: torch.Tensor, bn: int = TILE_BN) -> torch.Tensor:
    """[K, N] int4 values -> [ceil(N/bn), K/2, bn] uint8 (N zero-padded)."""
    return _tile(pack_int4(w_q), bn)


def pack_int4_tiled_i8(w_q: torch.Tensor, bn: int = TILE_BN) -> torch.Tensor:
    """[K, N] int4 values -> [ceil(N/bn), K/2, bn] int8 v3 bytes (N zero-padded).

    Pad value 0 decodes as (L, H) = (-8, 0): padded output columns are sliced
    off and their scales never applied."""
    return _tile(pack_int4_i8(w_q), bn)


def untile(packed_tiles: torch.Tensor) -> torch.Tensor:
    """[..., n_tiles, K/2, bn] -> flat [..., K/2, n_tiles * bn]."""
    n_tiles, k2, bn = packed_tiles.shape[-3:]
    return packed_tiles.movedim(-3, -2).reshape(*packed_tiles.shape[:-3], k2, n_tiles * bn)


# ----------------------------------------------------------- plain versions

def _pad_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Zero activations against the quantizer's zero-padded fan-in rows."""
    if x.shape[-1] == k:
        return x
    return torch.nn.functional.pad(x, (0, k - x.shape[-1]))


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """What K3a computes, in plain PyTorch: unpack, fp32 product, scale, cast."""
    w = unpack_int4_any(packed, torch.float32)
    y = torch.matmul(_pad_k(x, w.shape[-2]).float(), w)
    return (y * scale.float()).to(x.dtype)


def int4_matmul_tiled_plain(x: torch.Tensor, packed_tiles: torch.Tensor, scale: torch.Tensor,
                            *, n_out: int) -> torch.Tensor:
    """What K3b computes, in plain PyTorch; padded columns are dropped before the scale."""
    w = unpack_int4_any(untile(packed_tiles), torch.float32)[..., :n_out]
    y = torch.matmul(_pad_k(x, w.shape[-2]).float(), w)
    return (y * scale[..., :n_out].float()).to(x.dtype)


def int4_matmul_tiled_stacked_plain(x, packed_tiles, scale, layer: int, *, n_out: int):
    """What K3c computes, in plain PyTorch, on layer `layer` of the stack."""
    return int4_matmul_tiled_plain(x, packed_tiles[layer], scale[layer], n_out=n_out)


def int4_prefill_schedule(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
                          n_out: int | None = None, layer: int | None = None) -> torch.Tensor:
    """The M > 8 kernel's walk over one product, in plain PyTorch.

    `packed` is any of the three layouts: flat [k2, N] (one tile of TW = N),
    tiles [n_tiles, k2, TW], or a stack of them with `layer`. Row tiles of
    PREFILL_BLOCK_M and column bands of PREFILL_BLOCK_N (a band never straddles
    two tiles); each band walks the byte rows in steps of PREFILL_STEP. A
    step reads x at columns r0 and k2 + r0, zero past K and past M as TMA
    gives them, and dequantizes its bytes into a low and a high weight tile,
    with zero weights for byte rows past k2 (so the high half's x values that
    the low box reads when k2 % 64 != 0 add nothing) and zero bytes past a
    flat weight's last column. The sums are fp32; the scale is applied to the
    accumulator and the result rounded once to x's dtype; columns past n_out
    and rows past M are never written."""
    if layer is not None:
        packed, scale = packed[layer], scale[layer]
    tiles = packed[None] if packed.ndim == 2 else packed
    n_tiles, k2, tw = tiles.shape
    n_out = n_tiles * tw if n_out is None else n_out
    bm, bn, step = PREFILL_BLOCK_M, PREFILL_BLOCK_N, PREFILL_STEP
    if tiles.shape[0] > 1 and tw % bn:
        raise ValueError(f"a band of {bn} columns would straddle tiles of {tw}")
    m, k = x.shape
    raw = tiles.view(torch.uint8) if tiles.dtype == torch.int8 else tiles
    flip = 0x80 if tiles.dtype == torch.int8 else 0
    out = torch.empty((m, n_out), dtype=x.dtype, device=x.device)
    for m0 in range(0, m, bm):
        xt = torch.zeros((bm, 2 * k2 + step), dtype=torch.float32, device=x.device)
        xt[: min(bm, m - m0), :k] = x[m0:m0 + bm].float()  # TMA: zeros past M and K
        for n0 in range(0, n_out, bn):
            t, c0 = divmod(n0, tw)
            cols = min(bn, tw - c0)
            acc = torch.zeros((bm, bn), dtype=torch.float32, device=x.device)
            for r0 in range(0, k2, step):
                rows = min(step, k2 - r0)
                b = torch.zeros((step, bn), dtype=torch.int32, device=x.device)
                b[:rows, :cols] = raw[t, r0:r0 + rows, c0:c0 + cols].to(torch.int32)
                b ^= flip
                w_lo, w_hi = ((b & 15) - 8).float(), ((b >> 4) - 8).float()
                w_lo[rows:], w_hi[rows:] = 0.0, 0.0  # byte rows past k2: zero weights
                acc += xt[:, r0:r0 + step] @ w_lo + xt[:, k2 + r0:k2 + r0 + step] @ w_hi
            n1 = min(n0 + bn, n_out)
            y = acc[: min(bm, m - m0), : n1 - n0] * scale[n0:n1].float()
            out[m0:m0 + bm, n0:n1] = y.to(x.dtype)
    return out


def decode_k_slices(n_out: int, k2: int, sms: int) -> int:
    """How many K slices the M <= 8 kernel cuts k2 byte rows into, for
    ceil(n_out / DECODE_BLOCK_N) bands on a card of `sms` SMs, by what
    measured fastest on an H100: one block an SM where the bands are fewer
    than the SMs (at most DECODE_MAX_SLICES), two slices where twice the
    bands still fit in one wave (DECODE_BLOCKS_PER_SM blocks an SM), else
    one; then the largest count at most that which the kernel's cut
    (`decode_slice_rows`) gives exactly. M does not enter: at every M <= 8
    the kernel does the same work."""
    bands = -(-n_out // DECODE_BLOCK_N)
    if bands <= sms:
        k_slices = min(sms // bands, DECODE_MAX_SLICES, k2 // DECODE_ALIGN)
    else:
        k_slices = 2 if 2 * bands <= DECODE_BLOCKS_PER_SM * sms else 1
    while -(-k2 // decode_slice_rows(k2, k_slices)) != k_slices:
        k_slices -= 1
    return k_slices


def decode_slice_rows(k2: int, k_slices: int) -> int:
    """The byte rows of each K slice but the last, as the kernel cuts them:
    k2 / k_slices rounded up to whole groups of DECODE_ALIGN."""
    per_slice = -(-k2 // k_slices)
    return -(-per_slice // DECODE_ALIGN) * DECODE_ALIGN


def int4_decode_schedule(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
                         n_out: int | None = None, layer: int | None = None,
                         k_slices: int | None = None,
                         sms: int = H100_SXM_SMS) -> torch.Tensor:
    """The M <= 8 kernel's walk over one product, in plain PyTorch.

    `packed` is any of the three layouts, as for `int4_prefill_schedule`.
    Column bands of DECODE_BLOCK_N (a band never straddles two tiles: tiles
    must be a whole number of bands wide, as the kernel's entries require);
    K cut into `k_slices` slices of `decode_slice_rows` byte rows (the last
    one ragged), `decode_k_slices`' count for a card of `sms` SMs unless
    given. Each (band, slice) sums x at columns r and k2 + r of its rows,
    zero past K, against the low and high nibbles of those byte rows into
    an fp32 partial; the band's partials are summed in slice order, the
    scale applied to that sum and the result rounded once to x's dtype.
    Columns past the last are never written."""
    if layer is not None:
        packed, scale = packed[layer], scale[layer]
    bn = DECODE_BLOCK_N
    if packed.ndim == 3 and packed.shape[-1] % bn:
        raise ValueError(f"a band of {bn} columns would straddle tiles of {packed.shape[-1]}")
    flat = packed if packed.ndim == 2 else untile(packed)  # [k2, columns]
    k2, n_total = flat.shape
    n_out = n_total if n_out is None else n_out
    k_slices = decode_k_slices(n_out, k2, sms) if k_slices is None else k_slices
    rows = decode_slice_rows(k2, k_slices)
    m, k = x.shape
    raw = flat.view(torch.uint8) if flat.dtype == torch.int8 else flat
    flip = 0x80 if flat.dtype == torch.int8 else 0
    xf = torch.zeros((m, 2 * k2), dtype=torch.float32, device=x.device)
    xf[:, :k] = x.float()
    out = torch.empty((m, n_out), dtype=x.dtype, device=x.device)
    for n0 in range(0, n_out, bn):
        n1 = min(n0 + bn, n_out)
        b = raw[:, n0:n1].to(torch.int32) ^ flip
        w_lo, w_hi = ((b & 15) - 8).float(), ((b >> 4) - 8).float()
        acc = torch.zeros((m, n1 - n0), dtype=torch.float32, device=x.device)
        for r0 in range(0, k2, rows):  # slice order
            r1 = min(k2, r0 + rows)
            acc = acc + (xf[:, r0:r1] @ w_lo[r0:r1] + xf[:, k2 + r0:k2 + r1] @ w_hi[r0:r1])
        out[:, n0:n1] = (acc * scale[n0:n1].float()).to(x.dtype)
    return out


# ------------------------------------------------------------ the wrappers

def _use_kernel(name: str, x: torch.Tensor, impl: str) -> bool:
    if impl == "auto":
        if x.is_cuda:
            return True
        if x.device.type == "cpu":
            return False
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown {name} impl {impl!r}")
    return impl == "kernel"


def _check_cuda_args(name: str, x, packed, scale, byte_dtypes, packed_ndim: int, n_scale: int):
    """Raise on what the kernels cannot read."""
    if x.ndim != 2:
        raise ValueError(f"{name}: x must be [M, K], got {tuple(x.shape)}")
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(f"{name}: the int4 kernels are forward only")
    _build.check_bf16_operand("x", x, 2)
    if packed.dtype not in byte_dtypes or packed.ndim != packed_ndim:
        raise ValueError(f"{name}: packed must be {packed_ndim}-d {byte_dtypes}, got "
                         f"{packed.ndim}-d {packed.dtype}")
    if scale.dtype != torch.float32 or scale.shape[-1] < n_scale:
        raise ValueError(f"{name}: scale must be fp32 with at least {n_scale} columns, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if not (packed.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: packed and scale must be contiguous")
    if not (x.device == packed.device == scale.device):
        raise ValueError(f"{name}: x, packed and scale on different devices")
    k, k2 = x.shape[1], packed.shape[-2]
    # the fan-in may have been padded at quantize time, never the activations
    if k > 2 * k2 or k % 8 or k2 % 8:
        raise ValueError(f"{name}: K = {k} against {k2} byte rows not supported "
                         "(need K <= 2 * k2, both multiples of 8)")


def _split_args(x: torch.Tensor, m: int, n_out: int, k2: int):
    """The entries' last three arguments: the M <= 8 kernel's K slices, its
    fp32 partials (a fresh buffer each call, of a size fixed by the shape)
    and the bands' zero tickets (a kept buffer); (1, 0, 0) where nothing is
    split, and for M > 8. Also returns the partials' tensor, which the caller
    holds until the launch is enqueued.

    In a CUDA graph's capture (the decode step's, models/generation.py) the
    partials come from the graph's pool and keep their address in every
    replay, as do x and `out`, which the step's capture makes too: the TMA
    map of x that the entry encodes on the host holds x's captured address.
    The entries the graph captures call no `cudaFuncSetAttribute`."""
    k_slices = decode_k_slices(n_out, k2, _build.sm_count(x.device)) if m <= SMALL_M else 1
    if k_slices == 1:
        return (1, 0, 0), None
    bands = -(-n_out // DECODE_BLOCK_N)
    part = torch.empty(bands * k_slices * m * DECODE_BLOCK_N, dtype=torch.float32,
                       device=x.device)
    tickets = _build.tickets_for(x.device, bands)
    return (k_slices, part.data_ptr(), tickets.data_ptr()), part


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """y = (x @ unpack(packed)) * scale from the flat layout.

    x [M, K]; packed uint8 [K/2, N] (split halves); scale fp32 [N]. Returns
    [M, N] in x's dtype. impl: auto | plain | kernel."""
    if not _use_kernel("int4_matmul", x, impl):
        return int4_matmul_plain(x, packed, scale)
    k2, n = packed.shape[-2:]
    _check_cuda_args("int4_matmul", x, packed, scale, (torch.uint8,), 2, n)
    if n % 4 or scale.ndim != 1:
        raise ValueError(f"int4_matmul: N = {n} must be a multiple of 4 and scale 1-d")
    m, k = x.shape
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    split, _part = _split_args(x, m, n, k2)
    _build.launch("teochat_int4_matmul", x, x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), m, k, k2, n, x.stride(0), *split)
    LAUNCHES_FLAT.count += 1
    return out


def int4_matmul_tiled(x: torch.Tensor, packed_tiles: torch.Tensor, scale: torch.Tensor, *,
                      n_out: int, impl: str = "auto") -> torch.Tensor:
    """y[:, :n_out] = (x @ unpack(packed_tiles)) * scale with dense per-tile reads.

    x [M, K]; packed_tiles [n_tiles, K/2, bn] (int8 = v3 bytes, uint8 = v0);
    scale fp32 with at least n_out entries (the true width, or padded to
    n_tiles * bn as the JAX function takes it)."""
    if not _use_kernel("int4_matmul_tiled", x, impl):
        return int4_matmul_tiled_plain(x, packed_tiles, scale, n_out=n_out)
    _check_cuda_args("int4_matmul_tiled", x, packed_tiles, scale,
                     (torch.int8, torch.uint8), 3, n_out)
    n_tiles, k2, bn = packed_tiles.shape
    if bn % 128 or n_out > n_tiles * bn or scale.ndim != 1:
        raise ValueError(f"int4_matmul_tiled: tile width {bn} (need a multiple of 128), "
                         f"n_out {n_out} or scale {tuple(scale.shape)} not supported")
    m, k = x.shape
    out = torch.empty((m, n_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    split, _part = _split_args(x, m, n_out, k2)
    _build.launch("teochat_int4_matmul_tiled", x, x.data_ptr(), packed_tiles.data_ptr(),
                  scale.data_ptr(), out.data_ptr(), m, k, k2, n_tiles, bn, n_out, x.stride(0),
                  int(packed_tiles.dtype == torch.int8), *split)
    LAUNCHES_TILED.count += 1
    return out


def int4_matmul_tiled_stacked(x: torch.Tensor, packed_tiles: torch.Tensor, scale: torch.Tensor,
                              layer: int, *, n_out: int, impl: str = "auto") -> torch.Tensor:
    """y[:, :n_out] = (x @ unpack(packed_tiles[layer])) * scale[layer].

    packed_tiles [L, n_tiles, K/2, bn] and scale fp32 [L, >= n_out] stay whole:
    the kernel reads only the selected layer's bytes."""
    layer = int(layer)
    if not _use_kernel("int4_matmul_tiled_stacked", x, impl):
        return int4_matmul_tiled_stacked_plain(x, packed_tiles, scale, layer, n_out=n_out)
    _check_cuda_args("int4_matmul_tiled_stacked", x, packed_tiles, scale,
                     (torch.int8, torch.uint8), 4, n_out)
    n_layers, n_tiles, k2, bn = packed_tiles.shape
    if bn % 128 or n_out > n_tiles * bn or scale.ndim != 2 or scale.shape[0] != n_layers:
        raise ValueError(f"int4_matmul_tiled_stacked: tile width {bn} (need a multiple of "
                         f"128), n_out {n_out} or scale {tuple(scale.shape)} not supported")
    if not 0 <= layer < n_layers:
        raise IndexError(f"int4_matmul_tiled_stacked: layer {layer} of {n_layers}")
    m, k = x.shape
    out = torch.empty((m, n_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    split, _part = _split_args(x, m, n_out, k2)
    _build.launch("teochat_int4_matmul_tiled_stacked", x, x.data_ptr(), packed_tiles.data_ptr(),
                  scale.data_ptr(), out.data_ptr(), m, k, k2, n_tiles, bn, n_out, x.stride(0),
                  int(packed_tiles.dtype == torch.int8), layer, scale.stride(0), *split)
    LAUNCHES_STACKED.count += 1
    if m <= SMALL_M:
        LAUNCHES_STACKED_SMALL_M.count += 1
    return out
