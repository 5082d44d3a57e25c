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
//        of the u8 format, padded columns included.
//   dma  no unpack: x_lo . float(byte), no scale: what the bytes and one
//        multiply-add a byte cost.
//
// What bounds them on an H100: at M <= 8 the packed bytes (23 MB for the
// 4096 x 11008 projection, each read once: 6.9 us at 3.35 TB/s), and, as
// measured on the card (PERF.md, section 6, PR 12), ~12 us for any single
// launch that reads them (a plain 16-byte-load stream: 11.6-12.8 us, ~3 us
// of it the launch), before any decode. Two bodies:
//
//   ring_body (v2, v3, v4, v5). A work item is (tile, K slice); the slice count
//   (bench/int4_kernel.py::ring_k_slices, from the card's SM count) makes
//   n_tiles x k_slices fill whole waves of one block an SM (22 x 6 = 132 at
//   tw 512). A K slice of a tile is one contiguous range of bytes, so one
//   thread streams it with 1-D bulk copies of whole stages
//   (RING_STAGE_BYTES: 32 rows at tw 512) into a ring of RING_STAGES, 64 KB
//   an SM in flight (4 stages measured as fast as 3, faster than 2, 6, 8); no tensor
//   map, nothing encoded on the host. The item's slice of x is bulk-copied
//   once beside it. At M = 1, 16 consumer warps read a stage's rows with
//   16-byte loads (a 512-byte row is one warp) and FMA into 16 columns of
//   fp32 a thread; at M > 1, 8 warps take 8 rows of x at once: v3 by FMAs,
//   v2, v4 and v5 on mma.sync m16n8k16 with x's rows as n (v4's nibbles
//   decoded to bf16 under 0x4300; v2's and v5's bytes as the bf16 pair
//   (low nibble, byte) against (xa, xb)). The producer warp, idle once its
//   copies are issued, loads the tile's scales and sums the byte-reuse
//   slice of xa + c xb from shared memory. Each item writes its fp32 partial
//   [M, tw] to a workspace and takes a ticket; the tile's last block sums the
//   partials in slice order, takes the byte-reuse correction once, scales,
//   rounds once to bf16 and resets the ticket, so the same inputs give the
//   same bits on every launch. Beyond
//   the stream, what sets its pace (measured): the merge, ~2 us (three
//   round trips through the L2: partial, ticket, partials), and the
//   consumers, ~7 instructions a byte at M = 1 (two FADD and two FFMA
//   among them): some 60 % of an SM's issue slots over the stream's ~10 us,
//   and the last stages expose ~1.3 us of it.
//   stream_body (dma, vpu): the first design, a block owns a band of
//   columns and all byte rows; a lane reads 4-byte words of 8 consecutive
//   rows and the matching activations with 16-byte loads, the next step's
//   words a step ahead; fp32 accumulators in registers; one reduction at
//   the end.
// Both run M > 8 as row chunks of 8 in the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_async.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace teochat;

constexpr int THREADS = 256;  // 8 warps
constexpr int ROWS = 8;       // consecutive byte rows a thread takes at a time
constexpr uint32_t MAGIC = 0x4B000000u;  // the float 2^23: an integer < 2^23 or-ed in adds to it
constexpr float TWO23 = 8388608.f;

enum Variant { V2, V3, V3_M16, V5, V4, DMA, VPU };

struct Args {  // stream_body's
  const uint16_t* a;     // x_lo (dma); unused (vpu)
  const uint8_t* tiles;  // [n_tiles, k2, tw] bytes
  void* out;             // bf16 [M, n_out]; fp32 [n_tiles * tw] column sums (vpu)
  int M, k2, tw, n_total, n_out;
  long long a_rs;        // row stride of a, in elements
};

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

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

// Lane (rg, cg) of a warp owns 4 columns (one 4-byte word a row) and, in each
// step, 8 consecutive byte rows; the 8 weight words of a step are in flight
// together and nothing synchronizes until the final sum over row groups and
// warps. Block (x, y): columns [x BN, x BN + BN), rows [y MT, y MT + MT) of x.
// red is the block's shared scratch (SCRATCH below).
template <int V, int MT, int BN>
__device__ __forceinline__ void stream_body(const Args& p, float* red) {
  constexpr int LPR = BN / 4;   // lanes across one row of the band
  constexpr int RG = 32 / LPR;  // row groups of a warp
  constexpr int STEP = 8 * RG * ROWS;  // byte rows the block takes in one step
  constexpr bool HAS_A = V != VPU;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane / LPR, cg = lane % LPR;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MT;
  const int k2 = p.k2;
  // tw is a multiple of 128 >= BN: a band never straddles two tiles
  const uint8_t* wbytes =
      p.tiles + static_cast<long long>(n0 / p.tw) * k2 * p.tw + (n0 % p.tw) + cg * 4;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  // k2 is a multiple of 8: a thread's 8 rows are all inside or all outside.
  // The next step's words are loaded before this step's are decoded, so 8
  // loads a thread stay in flight whatever order the compiler gives the rest.
  uint32_t words[ROWS], ahead[ROWS];
  const int r_first = (warp * RG + rg) * ROWS;
#pragma unroll
  for (int u = 0; u < ROWS; ++u)
    ahead[u] = r_first < k2 ? *reinterpret_cast<const uint32_t*>(
                                  wbytes + static_cast<long long>(r_first + u) * p.tw)
                            : 0u;
#pragma unroll(MT <= 2 ? 2 : 1)
  for (int r = r_first; r < k2; r += STEP) {
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      words[u] = ahead[u];
      if (r + STEP < k2)
        ahead[u] = *reinterpret_cast<const uint32_t*>(
            wbytes + static_cast<long long>(r + STEP + u) * p.tw);
    }
    uint4 xa[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      xa[m] = make_uint4(0, 0, 0, 0);
      if (HAS_A && m0 + m < p.M)
        xa[m] = __ldg(reinterpret_cast<const uint4*>(p.a + (m0 + m) * p.a_rs + r));
    }
    float wa[ROWS][4], wb[ROWS][4];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) decode<V>(words[u], wa[u], wb[u]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (V == VPU) {  // no product: the decoded values are summed as they are
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] += wa[u][j] + wb[u][j];
      } else {
        float fa[ROWS];
        unpack8(xa[m], fa);
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(fa[u], wa[u][j], acc[m][j]);
      }
    }
  }

  // sum the row groups of a warp, then the 8 warps through shared memory
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  if (rg == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(warp * MT + m) * BN + cg * 4 + j] = acc[m][j];
  }
  __syncthreads();

  for (int idx = tid; idx < MT * BN; idx += THREADS) {
    const int m = idx / BN, n = n0 + idx % BN;
    float sum = 0.f;
#pragma unroll
    for (int wq = 0; wq < 8; ++wq) sum += red[wq * MT * BN + idx];
    if (V == VPU) {
      static_cast<float*>(p.out)[n] = sum;  // every column that has bytes, padding included
      continue;
    }
    if (m0 + m >= p.M || n >= p.n_out) continue;
    static_cast<uint16_t*>(p.out)[static_cast<long long>(m0 + m) * p.n_out + n] =
        __bfloat16_as_ushort(__float2bfloat16_rn(sum));
  }
}

#define SCRATCH __shared__ float red[8 * MT * BN]

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS) bench_int4_vpu_kernel(Args p) {
  SCRATCH;
  stream_body<VPU, MT, BN>(p, red);
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS) bench_int4_dma_kernel(Args p) {
  SCRATCH;
  stream_body<DMA, MT, BN>(p, red);
}

// ------------------------------------------------ the ring body (v2, v3, v4, v5)

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
  const uint16_t* a;     // v2, v3, v5: xa [M, k2]; v4: x [M, 2 k2] (K rows 2i, 2i + 1: byte row i)
  const uint16_t* b;     // v2, v3, v5: xb [M, k2]; v4: unused
  const uint8_t* tiles;  // [n_tiles, k2, tw] bytes
  const float* scale;    // fp32, at least n_out entries
  uint16_t* out;         // bf16 [M, n_out]
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
// a shuffle).
template <int V, int MT>
__device__ __forceinline__ void ring_producer_tail(const RingArgs& p, const uint8_t* xs,
                                                   int x_row_bytes, int rows, int tile,
                                                   int m_live, RingShared& sh) {
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
// (one m16n8k16 step's 16 k of the mma.sync consumer) in RING_STAGE_BYTES.
__device__ __forceinline__ int ring_stage_rows(int tw) {
  return RING_STAGE_BYTES / tw / RING_ALIGN * RING_ALIGN;
}

// The FMA consumer (M = 1, and v3 at every M). Thread (g, c) = (tid / (tw /
// 16), tid % (tw / 16)) owns bytes [16 c, 16 c + 16) of rows g, g + groups,
// ... of each stage: 16 columns, all MT rows of x, fp32 accumulators in
// registers. Its sums go to red[g][MT][tw]; returns the row groups.
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
          } else {
            fa[m] = bf16_bits(*reinterpret_cast<const uint16_t*>(xs + m * x_row_bytes + 2 * rr));
            fb[m] = bf16_bits(
                *reinterpret_cast<const uint16_t*>(xs + (MT + m) * x_row_bytes + 2 * rr));
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
              acc[m][4 * q + j] = fmaf(fa[m], wa[j], acc[m][4 * q + j]);
              acc[m][4 * q + j] = fmaf(fb[m], wb[j], acc[m][4 * q + j]);
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

// The mma.sync consumer (v2, v4, v5 at M > 1, x's 8 rows as n). A warp owns
// 128-column blocks cb (cb = warp % (tw / 128) and the warps that share it
// take turns over a stage's 8-row groups, or cb = warp, warp + 8 where a tile
// has 8 or more). Lane (g, t) reads 16 bytes, columns [16 g, 16 g + 16) of
// the block, of byte rows t and t + 4 of a group: the A operands of 8
// m16n8k16 products, product j's rows g and g + 8 being columns 16 g + 2 j
// and 16 g + 2 j + 1, its k slots 2t, 2t + 1 and 2t + 8, 2t + 9 a bf16 pair
// of those rows' bytes: v4 the two nibbles (K rows 2 r, 2 r + 1), v2 and v5
// (low nibble, byte). The B operand is x's row g at the same slots: v4 K rows
// 2 r, 2 r + 1 (one 32-bit load), v2 and v5 (xa[r], xb[r]) (two 16-bit loads
// and a prmt). Its sums go to red[slot][8][tw], slot = the warp's turn among
// its block's.
template <int V, int MT, int W>
__device__ __forceinline__ void ring_consume_mma(const RingArgs& p, const uint8_t* smem,
                                                 const uint8_t* xs, int x_row_bytes, int rows,
                                                 RingShared& sh, float* red) {
  constexpr bool NATIVE = V == V4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tw = p.tw;
  const int gq = lane >> 2, t = lane & 3;
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
        const int r0 = rg * RING_ALIGN, r = r_stage + r0 + t;  // r: the row within the slice
        const uint4 w0 = *reinterpret_cast<const uint4*>(col + (r0 + t) * tw);
        const uint4 w1 = *reinterpret_cast<const uint4*>(col + (r0 + t + 4) * tw);
        uint32_t b0, b1;
        if (NATIVE) {
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
// 2 r .. of each row; the byte reuse: xa and xb at r ..) after the ring,
// then the slice's stages of ring_stage_rows(tw) rows into the ring (a
// ragged last stage copies what is left), waiting on a slot's `empty`
// barrier before reusing it; the warp then loads the tile's scales (and the
// byte reuse's row sums) while the consumers take the stages; the sums of
// the warps meet in the ring's memory, in order.
template <int V, int MT, int W>
__device__ __forceinline__ void ring_body(const RingArgs& p, uint8_t* smem, RingShared& sh) {
  constexpr bool NATIVE = V == V4;
  constexpr bool MMA = MT > 1 && V != V3 && V != V3_M16;  // v3 keeps its FMAs at every M
  constexpr int C = W * 32;  // consumer threads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slice = blockIdx.x, tile = blockIdx.y, chunk = blockIdx.z;
  const int m0 = chunk * MT, m_live = min(MT, p.M - m0);
  const int tw = p.tw, k2 = p.k2, slice_rows = p.slice_rows;
  const int r_begin = slice * slice_rows, rows = min(k2 - r_begin, slice_rows);
  // x's slice after the ring: v4 [MT][2 slice_rows] bf16; else xa [MT][slice_rows], then xb
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
      mbar_arrive_expect_tx(x_bar, m_live * x_bytes * (NATIVE ? 1 : 2));
      for (int m = 0; m < m_live; ++m) {
        if (NATIVE) {
          bulk_load_1d(smem_u32(xs + m * x_row_bytes),
                       p.a + (m0 + m) * 2LL * k2 + 2LL * r_begin, x_bytes, x_bar);
        } else {
          bulk_load_1d(smem_u32(xs + m * x_row_bytes), p.a + (m0 + m) * (long long)k2 + r_begin,
                       x_bytes, x_bar);
          bulk_load_1d(smem_u32(xs + (MT + m) * x_row_bytes),
                       p.b + (m0 + m) * (long long)k2 + r_begin, x_bytes, x_bar);
        }
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
    mbar_wait(smem_u32(&sh.bars[2 * RING_STAGES]), 0);
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
    const float corr = NATIVE ? 0.f : 8.f * row_sum;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tile * tw + col + j;
      if (n < p.n_out)
        p.out[static_cast<long long>(m0 + m) * p.n_out + n] =
            __bfloat16_as_ushort(__float2bfloat16_rn((vals[j] - corr) * sh.scale[col + j]));
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
    if (!NATIVE && split && tid < m_live) __stcg(sum_at(slice, tid), sh.corr[tid]);
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
        if (!NATIVE) row_sum += __ldcg(sum_at(sl, m));
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
  // 16-byte aligned bases for the bulk copies (rows and slices keep it)
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

// The band of columns a block owns: 32 columns give the most blocks (N / 32)
// and 32 row groups across K; wider bands (fewer row groups) only once every
// SM would still hold several blocks. `band` != 0 picks it.
int pick_band(int n_total, int band) {
  if (band) return band;
  int bn = 128;
  while (bn > 32 && (n_total + bn - 1) / bn < 4 * 132) bn /= 2;
  return bn;
}

int check(const Args& p, int band) {
  if (p.k2 <= 0 || p.k2 % 8 || p.tw % 128 || p.n_total <= 0) return 1;
  if (band != 0 && band != 32 && band != 64 && band != 128) return 1;
  return 0;
}

int check_product(const Args& p, int band) {
  if (check(p, band) || p.M <= 0 || p.n_out <= 0 || p.n_out > p.n_total) return 1;
  if (p.a_rs % 8) return 1;  // 16-byte activation loads
  return 0;
}

#define LAUNCH_BAND(KERNEL, GRID_Y, ...)                                              \
  do {                                                                                \
    const int bn_ = pick_band(p.n_total, band);                                       \
    const dim3 grid((p.n_total + bn_ - 1) / bn_, GRID_Y);                             \
    if (bn_ == 128)                                                                   \
      KERNEL<128, __VA_ARGS__><<<grid, THREADS, 0, st>>>(p);                          \
    else if (bn_ == 64)                                                               \
      KERNEL<64, __VA_ARGS__><<<grid, THREADS, 0, st>>>(p);                           \
    else                                                                              \
      KERNEL<32, __VA_ARGS__><<<grid, THREADS, 0, st>>>(p);                           \
  } while (0)

// one row of x: MT = 1; more: chunks of 8 rows in grid.y
#define LAUNCH_PRODUCT(KERNEL)                                                        \
  do {                                                                                \
    if (p.M <= 1)                                                                     \
      LAUNCH_BAND(KERNEL, 1, 1);                                                      \
    else                                                                              \
      LAUNCH_BAND(KERNEL, (p.M + 7) / 8, 8);                                          \
  } while (0)

Args product_args(const void* a, const void* tiles, void* out, int M, int k2, int n_tiles,
                  int bn, int n_out, long long a_rs) {
  return Args{static_cast<const uint16_t*>(a), static_cast<const uint8_t*>(tiles), out,
              M, k2, bn, n_tiles * bn, n_out, a_rs};
}

// The byte-reuse entries' arguments (v2, v3, v5).
RingArgs byte_reuse_args(const void* xa, const void* xb, const void* tiles, const void* scale,
                         void* out, int M, int k2, int n_tiles, int bn, int n_out, int k_slices,
                         int mask16, void* part, void* tickets) {
  return RingArgs{static_cast<const uint16_t*>(xa), static_cast<const uint16_t*>(xb),
                  static_cast<const uint8_t*>(tiles), static_cast<const float*>(scale),
                  static_cast<uint16_t*>(out), static_cast<float*>(part),
                  static_cast<int*>(tickets), M, k2, bn, n_tiles, n_out, k_slices,
                  k_slices > 0 ? ring_slice_rows(k2, k_slices) : 0, mask16};
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
  const RingArgs p = byte_reuse_args(xa, xb, tiles, scale, out, M, k2, n_tiles, bn, n_out,
                                     k_slices, 0, part, tickets);
  RING_LAUNCH(bench_int4_v2_ring_kernel);
}

// S1-v3. As v2, on int8 tiles; mask16 != 0 masks on 16-bit halves.
extern "C" int teochat_bench_int4_v3(const void* xa, const void* xb, const void* tiles,
                                     const void* scale, void* out, int M, int k2, int n_tiles,
                                     int bn, int n_out, int k_slices, int mask16, void* part,
                                     void* tickets, void* stream) {
  const RingArgs p = byte_reuse_args(xa, xb, tiles, scale, out, M, k2, n_tiles, bn, n_out,
                                     k_slices, mask16, part, tickets);
  RING_LAUNCH(bench_int4_v3_ring_kernel);
}

// S1-v5. As v3, the low nibbles masked a word at a time.
extern "C" int teochat_bench_int4_v5(const void* xa, const void* xb, const void* tiles,
                                     const void* scale, void* out, int M, int k2, int n_tiles,
                                     int bn, int n_out, int k_slices, void* part, void* tickets,
                                     void* stream) {
  const RingArgs p = byte_reuse_args(xa, xb, tiles, scale, out, M, k2, n_tiles, bn, n_out,
                                     k_slices, 0, part, tickets);
  RING_LAUNCH(bench_int4_v5_ring_kernel);
}

// S1-v4. x bf16 [M, 2 k2] contiguous; tiles [n_tiles, k2, bn] bytes of two
// signed nibbles, K rows 2i (low) and 2i + 1 (high); the rest as v2.
extern "C" int teochat_bench_int4_v4(const void* x, const void* tiles, const void* scale,
                                     void* out, int M, int k2, int n_tiles, int bn, int n_out,
                                     int k_slices, void* part, void* tickets, void* stream) {
  const RingArgs p{static_cast<const uint16_t*>(x), nullptr, static_cast<const uint8_t*>(tiles),
                   static_cast<const float*>(scale), static_cast<uint16_t*>(out),
                   static_cast<float*>(part), static_cast<int*>(tickets), M, k2, bn, n_tiles,
                   n_out, k_slices, k_slices > 0 ? ring_slice_rows(k2, k_slices) : 0, 0};
  RING_LAUNCH(bench_int4_v4_ring_kernel);
}

// S1-dma. x bf16 with row stride x_rs, its first k2 columns are read; tiles u8;
// out bf16 [M, n_out] = x_lo . float(byte), unscaled.
extern "C" int teochat_bench_int4_dma(const void* x, long long x_rs, const void* tiles,
                                      void* out, int M, int k2, int n_tiles, int bn, int n_out,
                                      int band, void* stream) {
  const Args p = product_args(x, tiles, out, M, k2, n_tiles, bn, n_out, x_rs);
  if (check_product(p, band)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  LAUNCH_PRODUCT(bench_int4_dma_kernel);
  return static_cast<int>(cudaGetLastError());
}

// S1-vpu. tiles u8; colsum fp32 [n_tiles * bn]: per column the sum over byte
// rows of (lo - 8) + (hi - 8).
extern "C" int teochat_bench_int4_vpu(const void* tiles, void* colsum, int k2, int n_tiles,
                                      int bn, int band, void* stream) {
  const Args p = product_args(nullptr, tiles, colsum, 1, k2, n_tiles, bn, n_tiles * bn, 0);
  if (check(p, band)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  LAUNCH_BAND(bench_int4_vpu_kernel, 1, 1);
  return static_cast<int>(cudaGetLastError());
}
