// The int4 unpack variants of the kernel bench, for Hopper (sm_90a).
//
// Replaces the six TPU kernels of scripts/bench_int4_kernel.py: _v2_kernel
// (:55), _v3_kernel (:135), _v4_kernel (:219), _v5_kernel (:281), _vpu_kernel
// (:342) and _dma_kernel (:383). Each computes, for a few rows of x, a product
// with a weight stored as 4-bit values in [n_tiles, byte rows, bn] tiles; they
// differ in which machine operations turn a byte into multiplicands:
//
//   v2   u8 byte p = (L+8) + 16 (H+8), L from row r and H from row k2 + r.
//        y = (xa . (p & 15) + xb . p - 8 (sum xa + 17 sum xb)) * scale with
//        xb = bf16(x_hi / 16), xa = bf16(x_lo - xb): the high nibble is never
//        extracted. One prmt puts the byte under 2^23 (widen and convert in
//        one), one mask on that word gives the low nibble, two subtractions.
//   v3   int8 byte b = (L+8) + 16 H: y = (xa . (b & 15) + xb . b
//        - 8 sum (xa + xb)) * scale. The signed byte is read by flipping its
//        top bit (one xor a word) and subtracting 2^23 + 128. The mask runs
//        on the widened 32-bit value, or (mask16) on the word's two 16-bit
//        halves before the widening.
//   v5   v3 with the low nibbles of four bytes masked by one & 0x0F0F0F0F on
//        the word, then widened by a prmt each.
//        At M > 1, v2 and v5 take a byte as the bf16 pair (low nibble, byte)
//        against (xa, xb) on mma.sync (byte_pair_bf16x2: no int-to-float
//        conversion); the word mask buys nothing there, as one lop3 masks
//        both halves of the pair.
//   v4   native 4-bit storage: a byte holds the signed values of K rows 2i
//        (low nibble) and 2i + 1 (high). No int-to-float conversion: one xor
//        a word biases every nibble by 8, one prmt puts a byte under 2^23,
//        one mask keeps the low nibble (2^23 + L + 8) and one the high
//        nibble in place (2^23 + 16 (H + 8)), two subtractions; x's odd K
//        row is taken / 16 (exact) against the high value 16 H.
//   vpu  unpack only: per column the sum over byte rows of (lo - 8) + (hi - 8)
//        of the u8 format, padded columns included; no x, no product.
//   dma  no unpack: x_lo . float(byte), no scale: what the ring body costs
//        with one multiply-add a byte, its merge of K slices included (so the
//        floor of this body, not of the bytes alone: PERF.md, sections 6 and
//        7). At M > 1 a byte is one k slot of mma.sync m16n8k8: two byte rows
//        make the bf16 pair (byte_rows_bf16x2).
//
// What bounds them on an H100: at M <= 8 the packed bytes (23 MB for the
// 4096 x 11008 projection, each read once: 6.9 us at 3.35 TB/s), and, as
// measured on the card (PERF.md, section 6, PR 12), ~12 us for any single
// launch that reads them (a plain 16-byte-load stream: 11.6-12.8 us, ~3 us
// of it the launch), before any decode. One body, ring_body, runs all six.
// A work item is (tile, K slice); the slice count
// (bench/int4_kernel.py::ring_k_slices, from the card's SM count) makes
// n_tiles x k_slices fill whole waves of one block an SM (22 x 6 = 132 at tw
// 512). A K slice of a tile is one contiguous range of bytes, so one thread
// streams it with 1-D bulk copies of whole stages (RING_STAGE_BYTES: 32 rows
// at tw 512) into a ring of RING_STAGES, 64 KB an SM in flight (4 stages
// measured as fast as 3, faster than 2, 6, 8); no tensor map, nothing encoded
// on the host. The item's slice of x (vpu has none) is bulk-copied once
// beside it. At M = 1, 16 consumer warps read a stage's rows with 16-byte
// loads (a 512-byte row is one warp) and FMA into 16 columns of fp32 a thread
// (vpu adds the decoded values); at M > 1, 8 warps take 8 rows of x at once:
// v3 by FMAs, v2, v4, v5 and dma on mma.sync with x's rows as n (v4's nibbles
// decoded to bf16 under 0x4300; v2's and v5's bytes as the bf16 pair (low
// nibble, byte) against (xa, xb); dma's bytes of two rows as one pair against
// x's two rows). The producer warp, idle once its copies are issued, loads
// the tile's scales and sums the byte-reuse slice of xa + c xb from shared
// memory. Each item writes its fp32 partial [M, tw] to a workspace and takes
// a ticket; the tile's last block sums the partials in slice order, takes the
// byte-reuse correction once, scales, rounds once to bf16 (vpu: stores the
// fp32 sums) and resets the ticket, so the same inputs give the same bits on
// every launch. Beyond the stream, what sets its pace (measured): the merge,
// ~2 us (three round trips through the L2: partial, ticket, partials), and
// the consumers, ~7 instructions a byte at M = 1 (two FADD and two FFMA among
// them): some 60 % of an SM's issue slots over the stream's ~10 us, and the
// last stages expose ~1.3 us of it. M > 8 runs as row chunks of 8 in the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_async.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace teochat;

constexpr uint32_t MAGIC = 0x4B000000u;  // the float 2^23: an integer < 2^23 or-ed in adds to it
constexpr float TWO23 = 8388608.f;

enum Variant { V2, V3, V3_M16, V5, V4, DMA, VPU };

// byte j of w as the low mantissa bits of 2^23: widen and convert in one prmt
__device__ __forceinline__ uint32_t under_magic(uint32_t w, int j) {
  return __byte_perm(w, MAGIC, 0x7440 | j);
}

// One 4-byte word (4 columns of one byte row) -> the two multiplicands of each
// column: wa meets the first activation operand, wb the second.
template <int V>
__device__ __forceinline__ void decode(uint32_t w, float (&wa)[4], float (&wb)[4]) {
  if (V == V2 || V == DMA) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t t = under_magic(w, j);
      if (V == DMA) {
        wa[j] = __uint_as_float(t) - TWO23;
        wb[j] = 0.f;
      } else {
        wa[j] = __uint_as_float(t & 0xFFFFFF0Fu) - TWO23;
        wb[j] = __uint_as_float(t) - TWO23;
      }
    }
  } else if (V == V3 || V == V3_M16 || V == V5) {
    const uint32_t s = w ^ 0x80808080u;  // b + 128 in every byte
    uint32_t lo_src[4];
    if (V == V3) {  // mask at 32 bits, after the widening
#pragma unroll
      for (int j = 0; j < 4; ++j) lo_src[j] = under_magic(s, j) & 0xFFFFFF0Fu;
    } else if (V == V3_M16) {  // mask on the two 16-bit halves, then widen
      const uint32_t h[2] = {static_cast<uint16_t>(static_cast<uint16_t>(w) & 0x0F0Fu),
                             static_cast<uint16_t>(static_cast<uint16_t>(w >> 16) & 0x0F0Fu)};
#pragma unroll
      for (int j = 0; j < 4; ++j) lo_src[j] = under_magic(h[j >> 1], j & 1);
    } else {  // v5: one mask a word, then widen
      const uint32_t m = w & 0x0F0F0F0Fu;
#pragma unroll
      for (int j = 0; j < 4; ++j) lo_src[j] = under_magic(m, j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wa[j] = __uint_as_float(lo_src[j]) - TWO23;
      wb[j] = __uint_as_float(under_magic(s, j)) - (TWO23 + 128.f);
    }
  } else if (V == V4) {  // wa = L, wb = 16 H: the caller divides x's odd row by 16
    const uint32_t s = w ^ 0x88888888u;  // every nibble + 8, in [0, 16)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t t = under_magic(s, j);
      wa[j] = __uint_as_float(t & 0xFFFFFF0Fu) - (TWO23 + 8.f);
      wb[j] = __uint_as_float(t & 0xFFFFFFF0u) - (TWO23 + 128.f);
    }
  } else {  // VPU: both nibbles as K3 decodes them; only their sum is used
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wa[j] = __uint_as_float(MAGIC | ((w >> (8 * j)) & 15u)) - (TWO23 + 8.f);
      wb[j] = __uint_as_float(MAGIC | ((w >> (8 * j + 4)) & 15u)) - (TWO23 + 8.f);
    }
  }
}

// ------------------------------------------------------------ the ring body

// The walk, written out in plain PyTorch as
// teochat_torch/bench/int4_kernel.py::ring_schedule, whose constants a test
// holds equal to these. The K slice count is the wrapper's
// (int4_kernel.py::ring_k_slices); the kernel only cuts k2 by it.
constexpr int RING_STAGES = 4;            // stages of the ring
constexpr int RING_STAGE_BYTES = 16384;   // a stage: its whole groups of RING_ALIGN rows
constexpr int RING_WARPS = 8;             // consumer warps at M > 1; one more issues the copies
constexpr int RING_WARPS_M1 = 16;         // consumer warps at M = 1
constexpr int RING_ALIGN = 8;             // a K slice's byte rows are whole groups of this
constexpr int RING_X_BYTES = 80 * 1024;   // the most an item's slice of x takes
constexpr int RING_M_TILE = 8;            // rows of x an item takes where M > 1
constexpr int RING_MAX_TW = 2048;         // widest tile: 8 rows a stage
constexpr int RING_BYTES = RING_STAGES * RING_STAGE_BYTES;
__host__ __device__ constexpr int ring_warps(int mt) {
  return mt == 1 ? RING_WARPS_M1 : RING_WARPS;
}
// The warps' sums [slots][MT][tw] go where the ring and x's slice were, once
// both are consumed. An FMA consumer owns 16 columns (one 16-byte chunk of a
// row), so they take 32 W * 16 * MT floats at most; mma.sync's, less.
__host__ __device__ constexpr int ring_sums_bytes(int mt) {
  return ring_warps(mt) * 32 * 16 * mt * 4;
}
static_assert(RING_BYTES + RING_X_BYTES + 10 * 1024 <= 227 * 1024 &&
                  ring_sums_bytes(RING_M_TILE) + 10 * 1024 <= 227 * 1024,
              "ring and x's slice, or the sums, beside the scales and barriers in 227 KB");
static_assert(RING_STAGE_BYTES % RING_MAX_TW == 0 && RING_STAGE_BYTES / RING_MAX_TW >= 1,
              "whole rows a stage at every tile width");

struct RingArgs {
  // v2, v3, v5: xa [M, k2]; v4: x [M, 2 k2] (K rows 2i, 2i + 1: byte row i); dma: x, its
  // first k2 columns; vpu: unused. Row stride a_rs elements, 16-byte rows.
  const uint16_t* a;
  long long a_rs;
  const uint16_t* b;     // v2, v3, v5: xb [M, k2]; else unused
  const uint8_t* tiles;  // [n_tiles, k2, tw] bytes
  const float* scale;    // v2-v5: fp32, at least n_out entries
  uint16_t* out;         // bf16 [M, n_out] (all but vpu)
  float* sums;           // vpu: fp32 [n_tiles * tw], every column
  float* part;           // fp32 [n_tiles, k_slices, M, tw], then [n_tiles, k_slices, M]
  int* tickets;          // int32 [m_chunks, n_tiles], zero before and after (k_slices > 1)
  int M, k2, tw, n_tiles, n_out, k_slices, slice_rows;
  int mask16;            // v3: mask on 16-bit halves instead of the 32-bit value
};

struct RingShared {
  uint64_t bars[2 * RING_STAGES + 1];  // full, empty, then x's
  float scale[RING_MAX_TW];            // the tile's scales, zero past n_out
  float corr[RING_M_TILE];  // byte reuse: the item's sums of xa + c xb, a row of x each
  int last;
};
static_assert(sizeof(RingShared) <= 10 * 1024 - 1024, "static shared memory");

// bf16 pair (128 + a, 128 + b) as bits, minus (136, 136): a - 8, b - 8 exactly
__device__ __forceinline__ uint32_t minus_136(uint32_t biased) {
  const uint32_t k136 = 0x43084308u;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                             *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte P of s (v4 bytes with every nibble + 8; s4 = s >> 4) as the bf16 pair
// (L, H): one prmt puts the byte's low nibble at bit 0 and its high nibble at
// bit 16, one lop3 masks them under bf16 128, one hsub2 takes 136 away.
template <int P>
__device__ __forceinline__ uint32_t byte_to_bf16x2(uint32_t s, uint32_t s4) {
  const uint32_t h = __byte_perm(s, s4, P | (P << 4) | ((4 + P) << 8) | ((4 + P) << 12));
  return minus_136((h & 0x000F000Fu) | 0x43004300u);
}

// Byte P of w (v2: u8 p; v5: int8 b) as the bf16 pair (low nibble, byte), the
// k slots of one byte row against (xa, xb). bf16 holds 7 bits under 0x4300
// (128), so the byte's top bit picks what comes off. One prmt puts the byte at
// bits 0 and 16 and its sign over bits 24-31 (selector nibble 8 + P: replicate
// the byte's top bit), one lop3 keeps (lo, byte & 127) under 128, one lop3
// makes the subtrahend, one hsub2 takes it away: lo = (128 + lo) - 128;
// u8: p = (128 + (p & 127)) - (128, or 0 where p >= 128);
// int8: b = (128 + (b & 127)) - (128, or 256 where b < 0). All exact.
template <int V, int P>
__device__ __forceinline__ uint32_t byte_pair_bf16x2(uint32_t w) {
  uint32_t h;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(h)
      : "r"(w), "r"(0u), "r"(P | (P << 8) | ((8 | P) << 12)));
  const uint32_t v = (h & 0x007F000Fu) | 0x43004300u;
  const uint32_t sub = V == V2 ? 0x43004300u & ~(h & 0xFF000000u)   // u8
                               : 0x43004300u | (h & 0x00800000u);  // int8
  __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&sub));
  return *reinterpret_cast<uint32_t*>(&d);
}

// Byte P of w0 and byte P of w1 (dma: u8 bytes of two byte rows) as a bf16
// pair, the two k slots of an m16n8k8 A operand. As byte_pair_bf16x2, with a
// byte in each half: one prmt puts w0's byte at bit 0 and w1's at bit 16, each
// with its sign over the next 8 bits (selector nibbles 8 + P, 12 + P), one lop3
// keeps both under 128 (bf16 0x4300), one lop3 makes each half's subtrahend
// (128, or 0 where the byte is >= 128), one hsub2 takes them away. Exact.
template <int P>
__device__ __forceinline__ uint32_t byte_rows_bf16x2(uint32_t w0, uint32_t w1) {
  uint32_t h;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(h)
      : "r"(w0), "r"(w1), "r"(P | ((8 | P) << 4) | ((4 + P) << 8) | ((12 + P) << 12)));
  const uint32_t v = (h & 0x007F007Fu) | 0x43004300u;
  const uint32_t sub = 0x43004300u & ~h;
  __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&sub));
  return *reinterpret_cast<uint32_t*>(&d);
}

__device__ __forceinline__ float bf16_bits(uint32_t h) { return __uint_as_float(h << 16); }

// The correction's coefficient on sum xb: 8 (sum xa + c sum xb), c = 17 for
// v2's u8 byte (its high nibble stored + 8 as well), 1 for v3's and v5's int8.
template <int V>
__host__ __device__ constexpr float ring_xb_coeff() {
  return V == V2 ? 17.f : 1.f;
}

// The producer warp, once its last copy is issued: the tile's scales (zero
// past n_out) into sh.scale and, for the byte reuse, the item's share of the
// correction, the sum over its slice of xa + c xb for each row of x, into
// sh.corr (from the slice of x in shared memory; lanes stride the rows, then
// a shuffle). The probes (dma, vpu) have neither.
template <int V, int MT>
__device__ __forceinline__ void ring_producer_tail(const RingArgs& p, const uint8_t* xs,
                                                   int x_row_bytes, int rows, int tile,
                                                   int m_live, RingShared& sh) {
  if (V == DMA || V == VPU) return;
  const int lane = threadIdx.x & 31;
  for (int col = lane; col < p.tw; col += 32) {
    const int n = tile * p.tw + col;
    sh.scale[col] = n < p.n_out ? __ldg(p.scale + n) : 0.f;
  }
  if (V == V4) return;
  constexpr float C = ring_xb_coeff<V>();
  mbar_wait(smem_u32(&sh.bars[2 * RING_STAGES]), 0);  // x's slice has landed
#pragma unroll 1
  for (int m = 0; m < m_live; ++m) {
    const uint16_t* xa = reinterpret_cast<const uint16_t*>(xs + m * x_row_bytes);
    const uint16_t* xb = reinterpret_cast<const uint16_t*>(xs + (MT + m) * x_row_bytes);
    float s = 0.f;
    for (int r = lane; r < rows; r += 32) s += bf16_bits(xa[r]) + C * bf16_bits(xb[r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sh.corr[m] = s;
  }
}

// The stage rows of a tile `tw` bytes wide: whole groups of RING_ALIGN rows
// (one k step of the mma.sync consumer) in RING_STAGE_BYTES.
__device__ __forceinline__ int ring_stage_rows(int tw) {
  return RING_STAGE_BYTES / tw / RING_ALIGN * RING_ALIGN;
}

// The FMA consumer (M = 1, and v3 at every M). Thread (g, c) = (tid / (tw /
// 16), tid % (tw / 16)) owns bytes [16 c, 16 c + 16) of rows g, g + groups,
// ... of each stage: 16 columns, all MT rows of x, fp32 accumulators in
// registers (dma: one FMA a byte; vpu: no x, the decoded values added). Its
// sums go to red[g][MT][tw]; returns the row groups.
template <int V, int MT, int W>
__device__ __forceinline__ int ring_consume_fma(const RingArgs& p, const uint8_t* smem,
                                                const uint8_t* xs, int x_row_bytes, int rows,
                                                RingShared& sh, float* red) {
  constexpr bool NATIVE = V == V4;
  const int tid = threadIdx.x, lane = tid & 31, tw = p.tw;
  const int cpr = tw / 16, groups = W * 32 / cpr;
  const int g = tid / cpr, c = tid % cpr;
  const int stage_rows = ring_stage_rows(tw);
  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  for (int s = 0, r_stage = 0; r_stage < rows; ++s, r_stage += stage_rows) {
    const int st = s % RING_STAGES;
    const int n_rows = min(stage_rows, rows - r_stage);
    mbar_wait(smem_u32(&sh.bars[st]), (s / RING_STAGES) & 1);
    if (g < groups) {
      const uint8_t* stage = smem + st * RING_STAGE_BYTES + 16 * c;
#pragma unroll 1
      for (int r = g; r < n_rows; r += groups) {
        const uint4 wv = *reinterpret_cast<const uint4*>(stage + r * tw);
        const int rr = r_stage + r;  // the row within the slice
        float fa[MT], fb[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (NATIVE) {  // x's K rows 2 rr and 2 rr + 1, the second / 16 (exact)
            const uint32_t pair =
                *reinterpret_cast<const uint32_t*>(xs + m * x_row_bytes + 4 * rr);
            fa[m] = bf16_bits(pair & 0xffffu);
            fb[m] = __uint_as_float(pair & 0xffff0000u) * 0.0625f;
          } else if (V == VPU) {  // no x
            fa[m] = fb[m] = 0.f;
          } else {
            fa[m] = bf16_bits(*reinterpret_cast<const uint16_t*>(xs + m * x_row_bytes + 2 * rr));
            fb[m] = V == DMA ? 0.f
                             : bf16_bits(*reinterpret_cast<const uint16_t*>(
                                   xs + (MT + m) * x_row_bytes + 2 * rr));
          }
        }
        const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float wa[4], wb[4];
          decode<V>(words[q], wa, wb);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (V == VPU) {  // the unpack alone: no product
                acc[m][4 * q + j] += wa[j] + wb[j];
                continue;
              }
              acc[m][4 * q + j] = fmaf(fa[m], wa[j], acc[m][4 * q + j]);
              if (V != DMA) acc[m][4 * q + j] = fmaf(fb[m], wb[j], acc[m][4 * q + j]);
            }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&sh.bars[RING_STAGES + st]));
  }
  __syncthreads();  // every stage consumed: the ring's and x's memory take the sums
  if (g < groups) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(red + (g * MT + m) * tw + 16 * c + 4 * q) =
            make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2], acc[m][4 * q + 3]);
  }
  return groups;
}

// The mma.sync consumer (v2, v4, v5, dma at M > 1, x's 8 rows as n). A warp owns
// 128-column blocks cb (cb = warp % (tw / 128) and the warps that share it
// take turns over a stage's 8-row groups, or cb = warp, warp + 8 where a tile
// has 8 or more). Lane (g, t) reads 16 bytes, columns [16 g, 16 g + 16) of
// the block, of byte rows t and t + 4 of a group: the A operands of 8
// m16n8k16 products, product j's rows g and g + 8 being columns 16 g + 2 j
// and 16 g + 2 j + 1, its k slots 2t, 2t + 1 and 2t + 8, 2t + 9 a bf16 pair
// of those rows' bytes: v4 the two nibbles (K rows 2 r, 2 r + 1), v2 and v5
// (low nibble, byte). The B operand is x's row g at the same slots: v4 K rows
// 2 r, 2 r + 1 (one 32-bit load), v2 and v5 (xa[r], xb[r]) (two 16-bit loads
// and a prmt). dma's byte is one k slot: lane (g, t) reads byte rows 2t and
// 2t + 1 instead, 8 m16n8k8 products take a group, each A register the pair
// of those rows' bytes of one column (byte_rows_bf16x2), and B = (x[r],
// x[r + 1]) is one 32-bit load. Its sums go to red[slot][8][tw], slot = the
// warp's turn among its block's.
template <int V, int MT, int W>
__device__ __forceinline__ void ring_consume_mma(const RingArgs& p, const uint8_t* smem,
                                                 const uint8_t* xs, int x_row_bytes, int rows,
                                                 RingShared& sh, float* red) {
  constexpr bool NATIVE = V == V4;
  constexpr bool K8 = V == DMA;  // a byte is one k slot: m16n8k8
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tw = p.tw;
  const int gq = lane >> 2, t = lane & 3;
  const int ra = K8 ? 2 * t : t, rb = K8 ? 2 * t + 1 : t + 4;  // the lane's rows of a group
  const int n_cb = tw / 128, wide = n_cb >= W;
  const int cb0 = wide ? warp : warp % n_cb, slot = wide ? 0 : warp / n_cb;
  const int n_slot = wide ? 1 : (W - 1 - cb0) / n_cb + 1;
  const int n_blocks = wide && warp + W < n_cb ? 2 : 1;
  const int stage_rows = ring_stage_rows(tw);
  const uint16_t* xa = reinterpret_cast<const uint16_t*>(xs + gq * x_row_bytes);
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(xs + (MT + gq) * x_row_bytes);
  float acc[2][8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.f;

  for (int s = 0, r_stage = 0; r_stage < rows; ++s, r_stage += stage_rows) {
    const int st = s % RING_STAGES;
    const int n_groups = min(stage_rows, rows - r_stage) / RING_ALIGN;
    mbar_wait(smem_u32(&sh.bars[st]), (s / RING_STAGES) & 1);
    const uint8_t* stage = smem + st * RING_STAGE_BYTES + 16 * gq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h >= n_blocks) break;
      const uint8_t* col = stage + (cb0 + h * W) * 128;
      for (int rg = slot; rg < n_groups; rg += n_slot) {
        const int r0 = rg * RING_ALIGN, r = r_stage + r0 + ra;  // r: the row within the slice
        const uint4 w0 = *reinterpret_cast<const uint4*>(col + (r0 + ra) * tw);
        const uint4 w1 = *reinterpret_cast<const uint4*>(col + (r0 + rb) * tw);
        uint32_t b0, b1;
        if (K8) {
          b0 = *reinterpret_cast<const uint32_t*>(xa + r);
          b1 = 0;
        } else if (NATIVE) {
          const uint8_t* xr = xs + gq * x_row_bytes + 4 * r;
          b0 = *reinterpret_cast<const uint32_t*>(xr);
          b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
        } else {
          b0 = __byte_perm(xa[r], xb[r], 0x5410);
          b1 = __byte_perm(xa[r + 4], xb[r + 4], 0x5410);
        }
        const uint32_t u0[4] = {w0.x, w0.y, w0.z, w0.w}, u1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (K8) {  // columns 4q, 4q + 1, then 4q + 2, 4q + 3 of the lane's 16
            mma_1688(acc[h][2 * q], byte_rows_bf16x2<0>(u0[q], u1[q]),
                     byte_rows_bf16x2<1>(u0[q], u1[q]), b0);
            mma_1688(acc[h][2 * q + 1], byte_rows_bf16x2<2>(u0[q], u1[q]),
                     byte_rows_bf16x2<3>(u0[q], u1[q]), b0);
            continue;
          }
          uint32_t a[2][4];
          if (NATIVE) {
            const uint32_t s0 = u0[q] ^ 0x88888888u, s1 = u1[q] ^ 0x88888888u;
            const uint32_t s04 = s0 >> 4, s14 = s1 >> 4;
            a[0][0] = byte_to_bf16x2<0>(s0, s04);
            a[0][1] = byte_to_bf16x2<1>(s0, s04);
            a[0][2] = byte_to_bf16x2<0>(s1, s14);
            a[0][3] = byte_to_bf16x2<1>(s1, s14);
            a[1][0] = byte_to_bf16x2<2>(s0, s04);
            a[1][1] = byte_to_bf16x2<3>(s0, s04);
            a[1][2] = byte_to_bf16x2<2>(s1, s14);
            a[1][3] = byte_to_bf16x2<3>(s1, s14);
          } else {
            a[0][0] = byte_pair_bf16x2<V, 0>(u0[q]);
            a[0][1] = byte_pair_bf16x2<V, 1>(u0[q]);
            a[0][2] = byte_pair_bf16x2<V, 0>(u1[q]);
            a[0][3] = byte_pair_bf16x2<V, 1>(u1[q]);
            a[1][0] = byte_pair_bf16x2<V, 2>(u0[q]);
            a[1][1] = byte_pair_bf16x2<V, 3>(u0[q]);
            a[1][2] = byte_pair_bf16x2<V, 2>(u1[q]);
            a[1][3] = byte_pair_bf16x2<V, 3>(u1[q]);
          }
          mma_16816(acc[h][2 * q], a[0], b0, b1);
          mma_16816(acc[h][2 * q + 1], a[1], b0, b1);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&sh.bars[RING_STAGES + st]));
  }
  __syncthreads();  // every stage consumed: the ring's and x's memory take the sums
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h >= n_blocks) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (cb0 + h * W) * 128 + 16 * gq + 2 * j;
      float* r = red + slot * RING_M_TILE * tw + c;
      r[(2 * t) * tw] = acc[h][j][0];
      r[(2 * t + 1) * tw] = acc[h][j][1];
      r[(2 * t) * tw + 1] = acc[h][j][2];
      r[(2 * t + 1) * tw + 1] = acc[h][j][3];
    }
  }
}

// Block (slice, tile, chunk): byte rows [slice * slice_rows, + slice_rows) of
// tile `tile` (the last slice ragged), x rows [chunk MT, chunk MT + MT).
// Warp W's lane 0 bulk-copies the item's slice of x (v4: x's K rows
// 2 r .. of each row; the byte reuse: xa and xb at r ..; dma: x at r ..;
// vpu: nothing) after the ring,
// then the slice's stages of ring_stage_rows(tw) rows into the ring (a
// ragged last stage copies what is left), waiting on a slot's `empty`
// barrier before reusing it; the warp then loads the tile's scales (and the
// byte reuse's row sums) while the consumers take the stages; the sums of
// the warps meet in the ring's memory, in order.
template <int V, int MT, int W>
__device__ __forceinline__ void ring_body(const RingArgs& p, uint8_t* smem, RingShared& sh) {
  constexpr bool NATIVE = V == V4;
  constexpr bool BYTE_REUSE = V == V2 || V == V3 || V == V3_M16 || V == V5;  // xa, xb, a correction
  constexpr int X_COPIES = V == VPU ? 0 : BYTE_REUSE ? 2 : 1;  // copies of x's slice, a row of x
  constexpr bool MMA = MT > 1 && V != V3 && V != V3_M16;  // v3 keeps its FMAs at every M
  constexpr int C = W * 32;  // consumer threads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slice = blockIdx.x, tile = blockIdx.y, chunk = blockIdx.z;
  const int m0 = chunk * MT, m_live = min(MT, p.M - m0);
  const int tw = p.tw, k2 = p.k2, slice_rows = p.slice_rows;
  const int r_begin = slice * slice_rows, rows = min(k2 - r_begin, slice_rows);
  // x's slice after the ring: v4 [MT][2 slice_rows] bf16; else xa (dma: x) [MT][slice_rows],
  // then xb
  uint8_t* xs = smem + RING_BYTES;
  const int x_row_bytes = (NATIVE ? 4 : 2) * slice_rows;

  if (tid == 0) {
    for (int st = 0; st < RING_STAGES; ++st) {
      mbar_init(smem_u32(&sh.bars[st]), 1);                         // the copy's bytes
      mbar_init(smem_u32(&sh.bars[RING_STAGES + st]), W);  // a consumer warp each
    }
    mbar_init(smem_u32(&sh.bars[2 * RING_STAGES]), 1);
    mbar_init_fence();
  }
  __syncthreads();

  float* red = reinterpret_cast<float*>(smem);  // the sums: [slots][MT][tw]
  int slots = 0;                                // of the FMA consumer
  if (warp == W) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      const uint32_t x_bar = smem_u32(&sh.bars[2 * RING_STAGES]);
      const int x_bytes = (NATIVE ? 4 : 2) * rows;  // one row of x's slice (of xa, of xb)
      if (X_COPIES) mbar_arrive_expect_tx(x_bar, m_live * x_bytes * X_COPIES);
      for (int m = 0; X_COPIES && m < m_live; ++m) {
        bulk_load_1d(smem_u32(xs + m * x_row_bytes),
                     p.a + (m0 + m) * p.a_rs + (NATIVE ? 2LL : 1LL) * r_begin, x_bytes, x_bar);
        if (X_COPIES == 2)
          bulk_load_1d(smem_u32(xs + (MT + m) * x_row_bytes),
                       p.b + (m0 + m) * (long long)k2 + r_begin, x_bytes, x_bar);
      }
      const uint8_t* src = p.tiles + (static_cast<long long>(tile) * k2 + r_begin) * tw;
      const int stage_rows = ring_stage_rows(tw);
      for (int s = 0, r_stage = 0; r_stage < rows; ++s, r_stage += stage_rows) {
        const int st = s % RING_STAGES;
        const int n_bytes = min(stage_rows, rows - r_stage) * tw;
        // a fresh slot is free at once
        mbar_wait(smem_u32(&sh.bars[RING_STAGES + st]), ((s / RING_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(smem_u32(&sh.bars[st]), n_bytes);
        bulk_load_1d(smem_u32(smem + st * RING_STAGE_BYTES),
                     src + static_cast<long long>(r_stage) * tw, n_bytes, smem_u32(&sh.bars[st]));
      }
    }
    __syncwarp();
    ring_producer_tail<V, MT>(p, xs, x_row_bytes, rows, tile, m_live, sh);
    __syncthreads();
  } else {
    // ----------------------------------------------------------- consumers
    if (X_COPIES) mbar_wait(smem_u32(&sh.bars[2 * RING_STAGES]), 0);
    if constexpr (MMA)
      ring_consume_mma<V, MT, W>(p, smem, xs, x_row_bytes, rows, sh, red);
    else
      slots = ring_consume_fma<V, MT, W>(p, smem, xs, x_row_bytes, rows, sh, red);
  }
  __syncthreads();

  // four columns' sums over the warps' slots, in order
  const int n_cb = tw / 128;
  auto column_sum4 = [&](int m, int col) {
    const int n_slot = !MMA ? slots : n_cb >= W ? 1 : (W - 1 - (col >> 7)) / n_cb + 1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sl = 0; sl < n_slot; ++sl) {
      const float4 q = *reinterpret_cast<const float4*>(red + (sl * MT + m) * tw + col);
      v.x += q.x, v.y += q.y, v.z += q.z, v.w += q.w;
    }
    return v;
  };
  auto finish4 = [&](int m, int col, float4 v, float row_sum) {  // correction, scale, rounding
    const float vals[4] = {v.x, v.y, v.z, v.w};
    const float corr = BYTE_REUSE ? 8.f * row_sum : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tile * tw + col + j;
      if (V == VPU)  // every column, padding included, unrounded
        p.sums[n] = vals[j];
      else if (n < p.n_out)
        p.out[static_cast<long long>(m0 + m) * p.n_out + n] = __bfloat16_as_ushort(
            __float2bfloat16_rn(V == DMA ? vals[j] : (vals[j] - corr) * sh.scale[col + j]));
    }
  };
  auto part_at = [&](int sl, int m, int col) {
    return reinterpret_cast<float4*>(
        p.part + ((static_cast<long long>(tile) * p.k_slices + sl) * p.M + m0 + m) * tw + col);
  };
  // the byte reuse: the items' sums of xa + c xb (the coefficient taken in
  // ring_producer_tail), [n_tiles, k_slices, M] after the partials
  float* part_sums = p.part + static_cast<long long>(p.n_tiles) * p.k_slices * p.M * tw;
  auto sum_at = [&](int sl, int m) {
    return part_sums + (static_cast<long long>(tile) * p.k_slices + sl) * p.M + m0 + m;
  };
  const bool split = p.k_slices > 1;
  if (tid < C) {
    for (int m = 0; m < m_live; ++m)
      for (int col = 4 * tid; col < tw; col += 4 * C) {
        const float4 v = column_sum4(m, col);
        if (split)
          __stcg(part_at(slice, m, col), v);
        else
          finish4(m, col, v, sh.corr[m]);
      }
    if (BYTE_REUSE && split && tid < m_live) __stcg(sum_at(slice, tid), sh.corr[tid]);
  }
  if (!split) return;

  // The tile's last block to take its ticket merges the partials. One thread
  // releases the block's partial (the barrier orders the other threads'
  // stores before its fence) and takes the ticket; the last block acquires.
  __syncthreads();
  if (tid == 0) {
    const int ticket = chunk * p.n_tiles + tile;
    int taken;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(taken)
                 : "l"(p.tickets + ticket)
                 : "memory");
    sh.last = taken == p.k_slices - 1;
    if (sh.last) p.tickets[ticket] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!sh.last || tid >= C) return;
  for (int m = 0; m < m_live; ++m)
    for (int col = 4 * tid; col < tw; col += 4 * C) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float row_sum = 0.f;
#pragma unroll 4
      for (int sl = 0; sl < p.k_slices; ++sl) {  // slice order: the same sum on every launch
        const float4 q = __ldcg(part_at(sl, m, col));
        v.x += q.x, v.y += q.y, v.z += q.z, v.w += q.w;
        if (BYTE_REUSE) row_sum += __ldcg(sum_at(sl, m));
      }
      finish4(m, col, v, row_sum);
    }
}

template <int MT>
__global__ void __launch_bounds__((ring_warps(MT) + 1) * 32, 1)
    bench_int4_v3_ring_kernel(RingArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ RingShared sh;
  // the two mask widths are one kernel: the flag is uniform over the grid
  if (p.mask16)
    ring_body<V3_M16, MT, ring_warps(MT)>(p, smem, sh);
  else
    ring_body<V3, MT, ring_warps(MT)>(p, smem, sh);
}

template <int MT>
__global__ void __launch_bounds__((ring_warps(MT) + 1) * 32, 1)
    bench_int4_v4_ring_kernel(RingArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ RingShared sh;
  ring_body<V4, MT, ring_warps(MT)>(p, smem, sh);
}

template <int MT>
__global__ void __launch_bounds__((ring_warps(MT) + 1) * 32, 1)
    bench_int4_v5_ring_kernel(RingArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ RingShared sh;
  ring_body<V5, MT, ring_warps(MT)>(p, smem, sh);
}

template <int MT>
__global__ void __launch_bounds__((ring_warps(MT) + 1) * 32, 1)
    bench_int4_v2_ring_kernel(RingArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ RingShared sh;
  ring_body<V2, MT, ring_warps(MT)>(p, smem, sh);
}

template <int MT>
__global__ void __launch_bounds__((ring_warps(MT) + 1) * 32, 1)
    bench_int4_dma_ring_kernel(RingArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ RingShared sh;
  ring_body<DMA, MT, ring_warps(MT)>(p, smem, sh);
}

// vpu has no x: its entry launches M = 1 alone. RING_LAUNCH names an M > 1
// instance of every kernel, so vpu's is built on purpose, empty and never
// launched (bench/int4_kernel.py::sass_key leaves it out)
template <int MT>
__global__ void __launch_bounds__((ring_warps(MT) + 1) * 32, 1)
    bench_int4_vpu_ring_kernel(RingArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ RingShared sh;
  if constexpr (MT == 1) ring_body<VPU, MT, ring_warps(MT)>(p, smem, sh);
}

// byte rows of each K slice but the last: k2 / k_slices rounded up to whole groups
int ring_slice_rows(int k2, int k_slices) {
  const int per = (k2 + k_slices - 1) / k_slices;
  return (per + RING_ALIGN - 1) / RING_ALIGN * RING_ALIGN;
}

int ring_check(const RingArgs& p, int m_tile) {
  if (p.M <= 0 || p.k2 <= 0 || p.k2 % RING_ALIGN || p.tw % 128 || p.tw > RING_MAX_TW) return 1;
  if (p.n_tiles <= 0 || p.n_out <= 0 || p.n_out > p.n_tiles * p.tw) return 1;
  if (p.k_slices < 1 || p.k_slices > p.k2 / RING_ALIGN) return 1;
  // every slice has rows, and x's slice fits beside the ring
  if ((p.k2 + p.slice_rows - 1) / p.slice_rows != p.k_slices) return 1;
  if (4 * p.slice_rows * m_tile > RING_X_BYTES) return 1;
  if (p.k_slices > 1 && (!p.part || !p.tickets)) return 1;
  // 16-byte aligned bases and rows of x for the bulk copies (slices keep it)
  if (p.a_rs % 8) return 1;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(p.a) | reinterpret_cast<uintptr_t>(p.b) |
                          reinterpret_cast<uintptr_t>(p.tiles);
  return bases % 16 ? 1 : 0;
}

template <int MT>
int ring_launch(void (*kernel)(RingArgs), const RingArgs& p, cudaStream_t st) {
  const int smem = max(RING_BYTES + 4 * p.slice_rows * MT, ring_sums_bytes(MT));
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.k_slices, p.n_tiles, (p.M + MT - 1) / MT);
  kernel<<<grid, (ring_warps(MT) + 1) * 32, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// one row of x: MT = 1; more: chunks of RING_M_TILE rows in grid.z
#define RING_LAUNCH(KERNEL)                                                           \
  do {                                                                                \
    const int m_tile_ = p.M <= 1 ? 1 : RING_M_TILE;                                   \
    if (ring_check(p, m_tile_)) return static_cast<int>(cudaErrorInvalidValue);       \
    auto st_ = static_cast<cudaStream_t>(stream);                                     \
    return m_tile_ == 1 ? ring_launch<1>(KERNEL<1>, p, st_)                           \
                        : ring_launch<RING_M_TILE>(KERNEL<RING_M_TILE>, p, st_);      \
  } while (0)

// The entries' arguments (a slice count below 1 leaves slice_rows 0: refused).
RingArgs ring_args(const void* a, long long a_rs, const void* b, const void* tiles,
                   const void* scale, void* out, void* sums, int M, int k2, int n_tiles, int bn,
                   int n_out, int k_slices, int mask16, void* part, void* tickets) {
  return RingArgs{static_cast<const uint16_t*>(a), a_rs, static_cast<const uint16_t*>(b),
                  static_cast<const uint8_t*>(tiles), static_cast<const float*>(scale),
                  static_cast<uint16_t*>(out), static_cast<float*>(sums),
                  static_cast<float*>(part), static_cast<int*>(tickets), M, k2, bn, n_tiles,
                  n_out, k_slices, k_slices > 0 ? ring_slice_rows(k2, k_slices) : 0, mask16};
}

}  // namespace

// S1-v2. xa, xb bf16 [M, k2] contiguous; tiles u8 [n_tiles, k2, bn] (bn a
// multiple of 128, at most 2048); scale fp32 with at least n_out entries; out
// bf16 [M, n_out] contiguous. k_slices: the K slices (an exact cut of k2,
// bench/int4_kernel.py::ring_k_slices); where k_slices > 1, part fp32
// [n_tiles * k_slices * M * (bn + 1)] (the items' partials, then their sums
// of xa + c xb; contents ignored) and tickets int32 [ceil(M / 8) * n_tiles],
// zero, and zero again when the launch has run. Each entry returns
// cudaGetLastError().
extern "C" int teochat_bench_int4_v2(const void* xa, const void* xb, const void* tiles,
                                     const void* scale, void* out, int M, int k2, int n_tiles,
                                     int bn, int n_out, int k_slices, void* part, void* tickets,
                                     void* stream) {
  const RingArgs p = ring_args(xa, k2, xb, tiles, scale, out, nullptr, M, k2, n_tiles, bn, n_out,
                               k_slices, 0, part, tickets);
  RING_LAUNCH(bench_int4_v2_ring_kernel);
}

// S1-v3. As v2, on int8 tiles; mask16 != 0 masks on 16-bit halves.
extern "C" int teochat_bench_int4_v3(const void* xa, const void* xb, const void* tiles,
                                     const void* scale, void* out, int M, int k2, int n_tiles,
                                     int bn, int n_out, int k_slices, int mask16, void* part,
                                     void* tickets, void* stream) {
  const RingArgs p = ring_args(xa, k2, xb, tiles, scale, out, nullptr, M, k2, n_tiles, bn, n_out,
                               k_slices, mask16, part, tickets);
  RING_LAUNCH(bench_int4_v3_ring_kernel);
}

// S1-v5. As v3, the low nibbles masked a word at a time.
extern "C" int teochat_bench_int4_v5(const void* xa, const void* xb, const void* tiles,
                                     const void* scale, void* out, int M, int k2, int n_tiles,
                                     int bn, int n_out, int k_slices, void* part, void* tickets,
                                     void* stream) {
  const RingArgs p = ring_args(xa, k2, xb, tiles, scale, out, nullptr, M, k2, n_tiles, bn, n_out,
                               k_slices, 0, part, tickets);
  RING_LAUNCH(bench_int4_v5_ring_kernel);
}

// S1-v4. x bf16 [M, 2 k2] contiguous; tiles [n_tiles, k2, bn] bytes of two
// signed nibbles, K rows 2i (low) and 2i + 1 (high); the rest as v2.
extern "C" int teochat_bench_int4_v4(const void* x, const void* tiles, const void* scale,
                                     void* out, int M, int k2, int n_tiles, int bn, int n_out,
                                     int k_slices, void* part, void* tickets, void* stream) {
  const RingArgs p = ring_args(x, 2LL * k2, nullptr, tiles, scale, out, nullptr, M, k2, n_tiles,
                               bn, n_out, k_slices, 0, part, tickets);
  RING_LAUNCH(bench_int4_v4_ring_kernel);
}

// S1-dma. x bf16 with row stride x_rs (a multiple of 8), its first k2 columns
// read; tiles u8; out bf16 [M, n_out] = x_lo . float(byte), unscaled, rounded
// once; k_slices, part and tickets as v2's.
extern "C" int teochat_bench_int4_dma(const void* x, long long x_rs, const void* tiles,
                                      void* out, int M, int k2, int n_tiles, int bn, int n_out,
                                      int k_slices, void* part, void* tickets, void* stream) {
  const RingArgs p = ring_args(x, x_rs, nullptr, tiles, nullptr, out, nullptr, M, k2, n_tiles,
                               bn, n_out, k_slices, 0, part, tickets);
  RING_LAUNCH(bench_int4_dma_ring_kernel);
}

// S1-vpu. tiles u8; colsum fp32 [n_tiles * bn]: per column the sum over byte
// rows of (lo - 8) + (hi - 8); k_slices, part and tickets as v2's at M = 1.
extern "C" int teochat_bench_int4_vpu(const void* tiles, void* colsum, int k2, int n_tiles,
                                      int bn, int k_slices, void* part, void* tickets,
                                      void* stream) {
  const RingArgs p = ring_args(nullptr, 0, nullptr, tiles, nullptr, nullptr, colsum, 1, k2,
                               n_tiles, bn, n_tiles * bn, k_slices, 0, part, tickets);
  RING_LAUNCH(bench_int4_vpu_ring_kernel);
}
