// Fused int4-dequantize matmul (w4a16) for Hopper (sm_90a), bf16 activations.
//
// Replaces teochat_tpu/ops/int4_matmul.py::_int4_kernel (K3a, flat bytes),
// ::_int4_tiled_kernel / ::_int4_tiled_kernel_i8 (K3b, tiled bytes) and
// ::_int4_tiled_kernel_stacked / ::_int4_tiled_kernel_stacked_i8 (K3c, the
// layer picked from the stacked buffer). All compute
//
//     y[m, n] = (sum_k x[m, k] * W[k, n]) * scale[n]
//
// with W stored as one byte per two weights: byte [r, n] holds row r in its
// low four bits and row k2 + r in its high four bits (k2 = K / 2 after the
// quantizer's fan-in padding). u8 bytes store both values + 8; v3 int8 bytes
// are the same bits with the top bit flipped (b = (L + 8) + 16 H), so the
// kernels xor 0x80 into a v3 byte and then decode one format. The TPU bodies'
// row-sum correction and xa / xb split save vector operations there and are
// not part of the function; here each value is decoded to L and H directly.
// The product accumulates in fp32, the per-column scale is applied in fp32
// and the result is rounded once to bf16.
//
// Byte addressing covers the three layouts with one rule: column n lives in
// tile n / TW at column n % TW, a tile is k2 rows of TW bytes. Tiled weights
// have TW = 512 and ceil(N / 512) tiles (columns past n_out are padding that
// decodes to garbage and is never written out); a flat weight is one tile of
// TW = N. x is read through its row stride with its true K: elements past K
// (the quantizer's zero rows) read as zero, so callers do not pad x.
//
// Two kernels, picked by M:
//   * M <= 8 (decode): bound by the packed bytes, each read exactly once. A
//     block owns a band of 128 columns and one K slice of the byte rows:
//       - the wrapper picks the slice count from (N, k2) and the card's SM
//         count by what measured fastest on an H100
//         (ops/int4_matmul.py::decode_k_slices): one block an SM where the
//         bands are fewer than the SMs (out and down 4 slices, a 256-wide k
//         or v 32, q|k|v's 96 bands 1), two slices where twice the bands
//         still fit in one wave of three blocks an SM (gate|up), else one
//         (the lm_head);
//       - a loader warp has TMA copy 128 byte rows x 128 columns of
//         weights and the matching x (8 rows, zeros past M and past K) into
//         a ring of 2 stages in shared memory, a stage ahead of the products;
//       - eight consumer warps take two 8-row groups of each stage and turn
//         each into the A operands of 8 m16n8k16 `mma.sync` products with x's
//         8 rows as B: a column's two byte rows are put side by side with
//         one prmt, each nibble pair becomes bf16 with one lop3 under the
//         magic 0x4300 and one hsub2, the v3 flip rides in the high
//         nibbles' lop3 (its constant carries the flipped bit). The
//         tensor cores do the multiply-adds, so M 2-8 cost what M 1 does;
//       - the fp32 sums of the warps meet in shared memory; a split block
//         writes its partial [M, 128] to a workspace and takes a ticket; the
//         band's last block sums the partials in slice order, scales,
//         rounds once to bf16 and resets the ticket. The output is the same
//         bits on every launch, whatever order the blocks ran in; the
//         workspace has a fixed size for the shape, the tickets stay zero
//         between launches and nothing is set on the device per launch, so
//         a CUDA graph can capture the launch.
//     Measured on an H100 (PERF.md, section 6): the register-fed and
//     cp.async-fed versions of the same products were slower at every 7B
//     shape, FMA products (2 M a byte) cost more at M 4-8, and more slices
//     (two blocks an SM or more) were slower at every 7B shape.
//   * M > 8 (prefill): bound by the multiply-accumulates (989 TFLOP/s of
//     bf16 against 3.35 TB/s: at M 768 the products take 5-8x the bytes'
//     time). A block owns a 128 x 128 output tile and walks the byte rows in
//     steps of 64; a step is two m64n128k16 x 4 `wgmma` chains a consumer
//     warpgroup, one for each half of K, both operands in shared memory with
//     the 128-byte swizzle:
//       - A, x: two TMA boxes of 128 rows x 64 columns, at columns r0 and
//         k2 + r0 of the step's byte rows r0 .. r0 + 63 (K-major). TMA reads
//         x through its row stride and gives zeros past K and past M;
//       - B, the weights: two dequant warpgroups read the step's raw bytes
//         straight into registers (8 columns of one byte row a thread,
//         4-byte loads issued a step ahead), turn each nibble into bf16 with
//         the magic number 0x4300 (bf16 128 + v), and write one 16-byte
//         chunk of the low-half tile and one of the high-half tile at chunk
//         c ^ (r % 8) of row r of its 64-column box: the 128-byte swizzle a
//         TMA load would write, read MN-major (`tnspB`) because a byte row
//         is a k row. Byte rows past k2 are written as zeros, so the columns
//         of x past k2 that the low box reads (the high half's values, when
//         k2 % 64 != 0) meet zero weights;
//       - the tiles go round a ring of 3 stages with full / empty mbarriers;
//         the dequant threads fence their stores into the async proxy
//         before they arrive on `full`;
//       - the fp32 accumulator is scaled per column and rounded once to
//         bf16; rows past M and columns past n_out are never written.
//     A row tile's blocks are launched next to each other, so that a weight
//     band is read from memory once and from L2 by the other row tiles.
//     Measured on an H100 (PERF.md, section 6): 128-column bands with two
//     dequant warpgroups beat 256-column ones (one dequant warpgroup: a
//     launch of more than 384 threads leaves ptxas too few registers for an
//     N 256 accumulator) at every 7B projection, M 16 and 768; a loader warp
//     with cp.async beside three dequant warps was slower still.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_async.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace teochat;

struct Weights {
  const uint8_t* bytes;   // first byte of the (layer's) weight
  long long tile_stride;  // bytes from one tile to the next (k2 * TW)
  int tw;                 // tile width = bytes per row
  int n_total;            // tiles * TW: columns that have bytes
  int k2;                 // byte rows
  uint32_t flip;          // 0x80808080 for v3 int8 bytes, 0 for u8
};

__device__ __forceinline__ uint16_t float_to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// bf16 pair (128 + a, 128 + b) as bits, minus (136, 136): a - 8, b - 8 exactly
__device__ __forceinline__ uint32_t minus_136(uint32_t biased) {
  const uint32_t k136 = 0x43084308u;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                             *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&v);
}

// nibbles a, b at bits 0 and 16 -> the bf16 pair (a - 8, b - 8)
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t pair) {
  return minus_136(pair | 0x43004300u);
}

// ------------------------------------------------------------- small M

// The walk, written out in plain PyTorch as
// teochat_torch/ops/int4_matmul.py::int4_decode_schedule, whose constants
// a test holds equal to these. The number of K slices is the wrapper's
// (int4_matmul.py::decode_k_slices); the kernel only cuts k2 by it.
#define TEOCHAT_INT4_DECODE_BN 128   // columns a block: 8 lane groups of 16
#define TEOCHAT_INT4_DECODE_ALIGN 8  // a K slice's byte rows are whole groups of 8

constexpr int DC_BN = TEOCHAT_INT4_DECODE_BN;
constexpr int DC_GROUP = TEOCHAT_INT4_DECODE_ALIGN;  // byte rows of one m16n8k16 step
// Byte rows a stage (two groups of 8 for each consumer warp) and stages of
// the ring: 2 of 128 measured faster than 4 of 64 on an H100 (PERF.md,
// section 6, PR 10), more stages would not fit in static shared memory
constexpr int DC_ROWS = 128;
constexpr int DC_STAGES = 2;
constexpr int DC_WARPS = 8;                          // consumer warps; warp 8 loads
constexpr int DC_THREADS = (DC_WARPS + 1) * 32;
// blocks resident on an SM at once, which the launch bounds hold ptxas to
// (72 registers a thread at most) and the wrapper's split rule counts on
// (int4_matmul.py::DECODE_BLOCKS_PER_SM)
constexpr int DC_BLOCKS_PER_SM = 3;
constexpr int DC_GPW = DC_ROWS / (DC_WARPS * DC_GROUP);  // groups a consumer warp takes a stage
constexpr int DC_XK = 64;                                // k of one box of x: 128 bytes a row
constexpr int DC_M = 8;                              // rows of x an mma takes (its n)
// a stage: the weights' box [DC_ROWS rows][128 bytes], then x's boxes [8
// rows of x][64 k], at k r .. and at k2 + r .., all with the 128-byte swizzle
constexpr int DC_XB = DC_ROWS / DC_XK;  // boxes of x a half a stage
constexpr uint32_t DC_W_BYTES = DC_ROWS * DC_BN;
constexpr uint32_t DC_X_BYTES = DC_M * DC_XK * 2;
constexpr uint32_t DC_STAGE_BYTES = DC_W_BYTES + 2 * DC_XB * DC_X_BYTES;
constexpr uint32_t DC_RED_BYTES = DC_WARPS * DC_M * DC_BN * 4;  // the warps' sums, after the ring
constexpr uint32_t DC_SMEM = DC_STAGES * DC_STAGE_BYTES > DC_RED_BYTES
                                 ? DC_STAGES * DC_STAGE_BYTES
                                 : DC_RED_BYTES;
static_assert(DC_BN == 8 * 16 && DC_GROUP == 8, "lane group g owns 16 columns, lane t 2 rows");
static_assert(DC_GPW * DC_WARPS * DC_GROUP == DC_ROWS && DC_XB * DC_XK == DC_ROWS,
              "whole groups for every consumer warp, whole boxes of x");
static_assert(DC_SMEM + 1024 <= 48 * 1024, "static shared memory");
// each block's shared memory, its alignment and the 1 KB the card reserves
static_assert(DC_BLOCKS_PER_SM * (DC_SMEM + 2 * 1024) <= 228 * 1024,
              "DC_BLOCKS_PER_SM blocks' shared memory on one SM");

// The A fragments of two m16n8k16 tiles from 4 bytes of two byte rows r and
// r + 1 (wr, ws; bytes 2h, 2h + 1 make tile h). Tile h's mma row g is byte
// 2h of this lane's columns, row g + 8 byte 2h + 1; its k slots 2t, 2t + 1
// are the low nibbles of rows r, r + 1 and 2t + 8, 2t + 9 their high
// nibbles. One prmt puts a column's two bytes at bits 0 and 16, one lop3
// masks a nibble of each and puts bf16 128 around it, one hsub2 takes 136
// away. `hi_magic` is 0x43004300 for u8 bytes; for v3 bytes, whose top bit
// (the high nibble's bit 3) is flipped, it also carries that bit, so the
// lop3 ((v & 0xF) ^ magic) flips it back.
__device__ __forceinline__ void decode_tiles(uint32_t wr, uint32_t ws, uint32_t hi_magic,
                                             uint32_t (&a)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t pl = __byte_perm(wr, ws, h ? 0x0602 : 0x0400);  // byte 2h of both rows
    const uint32_t pr = __byte_perm(wr, ws, h ? 0x0703 : 0x0501);  // byte 2h + 1
    a[h][0] = nibbles_to_bf16x2(pl & 0x000F000Fu);
    a[h][1] = nibbles_to_bf16x2(pr & 0x000F000Fu);
    a[h][2] = minus_136(((pl >> 4) & 0x000F000Fu) ^ hi_magic);
    a[h][3] = minus_136(((pr >> 4) & 0x000F000Fu) ^ hi_magic);
  }
}

// byte offset of 16-byte chunk c of row r in a box of 128-byte rows written
// with the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Block (band, slice) owns DC_BN columns and the byte rows of K slice
// `slice`. Warp 8 is the loader: for each stage of DC_ROWS (128) byte rows
// it waits for the ring slot to be free and has TMA copy the weights'
// [128 rows x 128 columns] box and x's four [8 x 64] boxes (two at k r ..
// and two at k2 + r ..) in (zeros past the last column, past K and past
// M), DC_STAGES - 1 stages ahead of the products. A weight whose rows are
// not 16-byte aligned (a flat N % 16 != 0) has its box copied by the
// loader's lanes instead, 4 bytes at a time. Consumer warp w takes groups
// w and w + 8 (rows 8w .. 8w + 7 and 64 + 8w .. 64 + 8w + 7) of each
// stage; its lane (g, t) (g = lane / 4, t = lane % 4) reads 16 bytes
// (columns 16 g .. 16 g + 15) of a group's rows 2t and 2t + 1 and x row g
// at those rows and at k2 + those: its operands of 8 m16n8k16 products,
// one for each pair of its columns; a product's 16 k slots are the group's
// 8 rows' low and high nibbles, its 8 n the rows of x. The fp32
// accumulators of a lane are the same 32 at every M <= 8.
//
// part [bands, n_live, M, DC_BN] fp32 and tickets [bands] (zero before and
// after the launch) are read only when the K is split (n_live > 1): each
// block writes its partial, the last block of a band to take its ticket sums
// the partials in slice order, scales, rounds once and resets the ticket.
__global__ void __launch_bounds__(DC_THREADS, DC_BLOCKS_PER_SM)
int4_decode_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap x_map, Weights w, int w_tma,
                   const float* __restrict__ scale, uint16_t* __restrict__ out,
                   float* __restrict__ part, int* __restrict__ tickets, int M, int n_out,
                   int k_slices) {
  __shared__ __align__(1024) uint8_t smem[DC_SMEM];
  __shared__ __align__(8) uint64_t bars[2 * DC_STAGES];
  __shared__ int sm_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int band = blockIdx.x, slice = blockIdx.y;
  const int k2 = w.k2;
  const int per = (k2 + k_slices - 1) / k_slices;
  const int slice_rows = (per + DC_GROUP - 1) / DC_GROUP * DC_GROUP;
  const int n_live = (k2 + slice_rows - 1) / slice_rows;
  if (slice >= n_live) return;  // the wrapper's rule leaves no such slice
  const int r_begin = slice * slice_rows, r_end = min(k2, r_begin + slice_rows);
  const int n_stages = (r_end - r_begin + DC_ROWS - 1) / DC_ROWS;
  const int n0 = band * DC_BN;
  // this thread's column of the outputs it sums, and its scale, read early
  const int c_out = tid % DC_BN;
  const float sc = tid < DC_WARPS * 32 && n0 + c_out < n_out ? __ldg(scale + n0 + c_out) : 0.f;

  const uint32_t ring = smem_u32(smem);
  auto w_box = [&](int st) { return ring + st * DC_STAGE_BYTES; };
  auto x_box = [&](int st, int half, int b) {
    return w_box(st) + DC_W_BYTES + (half * DC_XB + b) * DC_X_BYTES;
  };
  auto full = [&](int st) { return smem_u32(&bars[st]); };
  auto empty = [&](int st) { return smem_u32(&bars[DC_STAGES + st]); };
  if (tid == 0) {
    for (int st = 0; st < DC_STAGES; ++st) {
      mbar_init(full(st), 1);         // the loader's arrival, and the copies' bytes
      mbar_init(empty(st), DC_WARPS);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc[8][4];  // [column pair j][c0..c3]
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (warp == DC_WARPS) {
    // ------------------------------------------------------------ loader
    const int tile = n0 / w.tw, c0 = n0 % w.tw;
    const uint8_t* wb = w.bytes + tile * w.tile_stride + c0;
    if (lane == 0) {
      tma_prefetch_map(&x_map);
      if (w_tma) tma_prefetch_map(&w_map);
    }
    for (int s = 0; s < n_stages; ++s) {
      const int st = s % DC_STAGES, r0 = r_begin + s * DC_ROWS;
      mbar_wait(empty(st), ((s / DC_STAGES) & 1) ^ 1);  // a fresh slot is free at once
      if (!w_tma) {
        // the box by hand: 4-byte words, zero past k2 and the last column
        for (int i = lane; i < DC_ROWS * (DC_BN / 4); i += 32) {
          const int r = i / (DC_BN / 4), word = i % (DC_BN / 4);
          uint32_t v = 0;
          if (r0 + r < k2 && n0 + 4 * word + 4 <= w.n_total)
            v = __ldg(reinterpret_cast<const uint32_t*>(
                wb + static_cast<long long>(r0 + r) * w.tw + 4 * word));
          *reinterpret_cast<uint32_t*>(smem + st * DC_STAGE_BYTES + swz(r, word / 4) +
                                       4 * (word % 4)) = v;
        }
        __syncwarp();
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full(st), (w_tma ? DC_W_BYTES : 0) + 2 * DC_XB * DC_X_BYTES);
        if (w_tma) tma_load_4d(w_box(st), &w_map, full(st), c0, r0, tile, 0);
        for (int b = 0; b < DC_XB; ++b) {
          tma_load_4d(x_box(st, 0, b), &x_map, full(st), r0 + b * DC_XK, 0, 0, 0);
          tma_load_4d(x_box(st, 1, b), &x_map, full(st), k2 + r0 + b * DC_XK, 0, 0, 0);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    const uint32_t hi_magic = 0x43004300u | ((w.flip >> 4) & 0x00080008u);  // v3: bit 3 of H
    for (int s = 0; s < n_stages; ++s) {
      const int st = s % DC_STAGES;
      mbar_wait(full(st), (s / DC_STAGES) & 1);
#pragma unroll
      for (int b = 0; b < DC_GPW; ++b) {  // group `warp` of each 64-row half of the stage
        const int q = b * DC_WARPS + warp;
        if (r_begin + s * DC_ROWS + q * DC_GROUP >= r_end) break;  // past the slice: nothing
        const int r = q * DC_GROUP + 2 * t;
        const uint8_t* wst = smem + st * DC_STAGE_BYTES;
        const uint4 w0 = *reinterpret_cast<const uint4*>(wst + swz(r, g));
        const uint4 w1 = *reinterpret_cast<const uint4*>(wst + swz(r + 1, g));
        // x row g, k 8q + 2t and + 1 (chunk `warp` of row g of box b), of each half
        const uint32_t xo = DC_W_BYTES + b * DC_X_BYTES + swz(g, warp) + 4 * t;
        const uint32_t xl = *reinterpret_cast<const uint32_t*>(wst + xo);
        const uint32_t xh = *reinterpret_cast<const uint32_t*>(wst + xo + DC_XB * DC_X_BYTES);
        const uint32_t r0w[4] = {w0.x, w0.y, w0.z, w0.w};
        const uint32_t r1w[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          uint32_t a[2][4];
          decode_tiles(r0w[q4], r1w[q4], hi_magic, a);
          mma_16816(acc[2 * q4], a[0], xl, xh);
          mma_16816(acc[2 * q4 + 1], a[1], xl, xh);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
  }
  __syncthreads();  // every stage consumed: the ring's memory becomes the warps' sums

  // the 8 consumer warps' sums in order through shared memory: acc[j] holds
  // columns 16 g + 2 j (c0, c1) and 16 g + 2 j + 1 (c2, c3) of x rows 2t, 2t + 1
  auto red = reinterpret_cast<float(*)[DC_M * DC_BN]>(smem);
  const bool summer = warp < DC_WARPS;
  if (summer) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 16 * g + 2 * j;
      red[warp][(2 * t) * DC_BN + c] = acc[j][0];
      red[warp][(2 * t + 1) * DC_BN + c] = acc[j][1];
      red[warp][(2 * t) * DC_BN + c + 1] = acc[j][2];
      red[warp][(2 * t + 1) * DC_BN + c + 1] = acc[j][3];
    }
  }
  __syncthreads();
  constexpr int PER_THREAD = DC_M * DC_BN / (DC_WARPS * 32);  // outputs tid + 256 i, column c_out
  float sum[PER_THREAD] = {};
  if (summer) {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
#pragma unroll
      for (int wq = 0; wq < DC_WARPS; ++wq) sum[i] += red[wq][tid + i * DC_WARPS * 32];
  }
  auto written = [&](int i) {
    return summer && (tid + i * DC_WARPS * 32) / DC_BN < M && n0 + c_out < n_out;
  };
  auto store = [&](int i, float v) {
    const int m = (tid + i * DC_WARPS * 32) / DC_BN;
    out[static_cast<long long>(m) * n_out + n0 + c_out] = float_to_bf16(v * sc);
  };
  if (n_live == 1) {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      if (written(i)) store(i, sum[i]);
    return;
  }

  // the K is split: this block's partial out, then the band's last block merges
  float* band_part = part + static_cast<long long>(band) * n_live * M * DC_BN;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int idx = tid + i * DC_WARPS * 32;
    if (summer && idx < M * DC_BN)
      band_part[static_cast<long long>(slice) * M * DC_BN + idx] = sum[i];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int taken = atomicAdd(tickets + band, 1);
    sm_last = taken == n_live - 1;
    if (sm_last) tickets[band] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    if (!written(i)) continue;
    const int idx = tid + i * DC_WARPS * 32;
    float v = 0.f;
#pragma unroll 16
    for (int sl = 0; sl < n_live; ++sl)  // slice order: the same sum on every launch
      v += __ldcg(band_part + static_cast<long long>(sl) * M * DC_BN + idx);
    store(i, v);
  }
}

// The M <= 8 kernel's K split, from the wrapper: the slice count, and where
// k_slices > 1 an fp32 workspace of [bands, k_slices, M, DC_BN] (contents
// ignored) and int32 tickets [bands], zero before and after the launch.
struct Split {
  int k_slices;
  float* part;
  int* tickets;
};

int launch_decode(const uint16_t* x, const Weights& w, const float* scale, uint16_t* out, int M,
                  int K, long long x_rs, int n_out, const Split& split, cudaStream_t st) {
  // x as [M rows, K] through its row stride, in boxes of 64 k x 8 rows of x
  // (rows past M and k past K arrive as zeros); a tensor map needs its base
  // 16-byte aligned
  if (reinterpret_cast<uintptr_t>(x) % 16) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map;
  const cuuint64_t x_row = static_cast<cuuint64_t>(x_rs) * 2;
  int err = encode_map_4d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x,
                          {cuuint64_t(K), cuuint64_t(M), 1, 1}, {x_row, x_row * M, x_row * M},
                          {DC_XK, DC_M, 1, 1});
  if (err) return err;
  // the weights as [tiles][k2][TW] bytes, in boxes of DC_ROWS rows x 128 columns;
  // rows that are not 16-byte aligned are copied by the loader's lanes
  const int w_tma = w.tw % 16 == 0 && reinterpret_cast<uintptr_t>(w.bytes) % 16 == 0;
  w_map = x_map;  // unread without w_tma
  if (w_tma) {
    const cuuint64_t tile = static_cast<cuuint64_t>(w.k2) * w.tw;
    const cuuint64_t n_tiles = w.n_total / w.tw;
    err = encode_map_4d(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w.bytes,
                        {cuuint64_t(w.tw), cuuint64_t(w.k2), n_tiles, 1},
                        {cuuint64_t(w.tw), tile, tile * n_tiles}, {DC_BN, DC_ROWS, 1, 1});
    if (err) return err;
  }
  const dim3 grid((n_out + DC_BN - 1) / DC_BN, split.k_slices);
  int4_decode_kernel<<<grid, DC_THREADS, 0, st>>>(w_map, x_map, w, w_tma, scale, out, split.part,
                                                  split.tickets, M, n_out, split.k_slices);
  return 0;
}

// ------------------------------------------------------------- large M

// The tile walk, written out in plain PyTorch as
// teochat_torch/ops/int4_matmul.py::int4_prefill_schedule, whose constants
// a test holds equal to these.
#define TEOCHAT_INT4_BM 128    // rows of x a block: two consumer warpgroups of 64
#define TEOCHAT_INT4_BN 128    // columns a block
#define TEOCHAT_INT4_STEP 64   // byte rows a step: one 64-wide swizzled box of each half

constexpr int LG_BM = TEOCHAT_INT4_BM;
constexpr int LG_BN = TEOCHAT_INT4_BN;
constexpr int LG_STEP = TEOCHAT_INT4_STEP;
constexpr int LG_NWG = 2;  // consumer warpgroups 0 and 1
constexpr int LG_DQ_THREADS = 256;  // warpgroups 2 and 3 dequantize
constexpr int LG_THREADS = LG_NWG * 128 + LG_DQ_THREADS;
// stages of x and weight tiles in flight, 64 KB each: 192 of the 227 KB
// (3 beat 2 at every 7B projection, PERF.md section 6)
constexpr int LG_STAGES = 3;
constexpr int LG_MAX_DEVICES = 64;  // devices whose shared-memory attribute is tracked
constexpr uint32_t LG_X_BYTES = LG_BM * SWIZZLE_ROW_BYTES;      // one half's x tile
constexpr uint32_t LG_BOX_BYTES = LG_STEP * SWIZZLE_ROW_BYTES;  // 64 k rows x 64 columns
constexpr uint32_t LG_W_BYTES = (LG_BN / 64) * LG_BOX_BYTES;    // one half's weight tile
// a stage: x low, x high, W low, W high; every tile 1024-byte aligned
constexpr uint32_t LG_STAGE_BYTES = 2 * LG_X_BYTES + 2 * LG_W_BYTES;
constexpr size_t LG_SMEM = 1024 + LG_STAGES * LG_STAGE_BYTES + 16 * LG_STAGES;
// The block is launched with 128 registers a thread (65,536 / 512);
// setmaxnreg moves the dequant threads' to the consumers, whose accumulator
// is 64 of them: 256 x 152 + 256 x 104 = 512 x 128.
constexpr int LG_CONSUMER_REGS = 152;
constexpr int LG_DEQUANT_REGS = 104;

// 8 u8 bytes (columns 0-3 in b0, 4-7 in b1) -> 8 bf16 weights of the low
// half and 8 of the high half, column 0 in the low bits of .x
__device__ __forceinline__ void dequant8(uint32_t b0, uint32_t b1, uint4& lo, uint4& hi) {
  const uint32_t l0 = b0 & 0x0F0F0F0Fu, l1 = b1 & 0x0F0F0F0Fu;
  const uint32_t h0 = (b0 >> 4) & 0x0F0F0F0Fu, h1 = (b1 >> 4) & 0x0F0F0F0Fu;
  // byte j and byte j + 1 into bits 0-7 and 16-23
  lo = make_uint4(nibbles_to_bf16x2(__byte_perm(l0, 0, 0x4140)),
                  nibbles_to_bf16x2(__byte_perm(l0, 0, 0x4342)),
                  nibbles_to_bf16x2(__byte_perm(l1, 0, 0x4140)),
                  nibbles_to_bf16x2(__byte_perm(l1, 0, 0x4342)));
  hi = make_uint4(nibbles_to_bf16x2(__byte_perm(h0, 0, 0x4140)),
                  nibbles_to_bf16x2(__byte_perm(h0, 0, 0x4342)),
                  nibbles_to_bf16x2(__byte_perm(h1, 0, 0x4140)),
                  nibbles_to_bf16x2(__byte_perm(h1, 0, 0x4342)));
}

__global__ void __launch_bounds__(LG_THREADS, 1)
int4_large_m_kernel(const __grid_constant__ CUtensorMap x_map, Weights w,
                    const float* __restrict__ scale, uint16_t* __restrict__ out,
                    int M, int n_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + LG_STAGES * LG_STAGE_BYTES;
  // stage st's tiles (half 0 low, 1 high) and its two barriers
  auto x_s = [base](int st, int half) { return base + st * LG_STAGE_BYTES + half * LG_X_BYTES; };
  auto w_s = [base](int st, int half) {
    return base + st * LG_STAGE_BYTES + 2 * LG_X_BYTES + half * LG_W_BYTES;
  };
  auto full = [bars](int st) { return bars + 8u * st; };
  auto empty = [bars](int st) { return bars + 8u * (LG_STAGES + st); };

  if (threadIdx.x == 0) {
    for (int st = 0; st < LG_STAGES; ++st) {
      mbar_init(full(st), LG_DQ_THREADS + 1);  // each dequant thread, and the x loads' bytes
      mbar_init(empty(st), LG_NWG * 4);        // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int m0 = blockIdx.x * LG_BM, n0 = blockIdx.y * LG_BN;
  const int k2 = w.k2;
  const int n_steps = (k2 + LG_STEP - 1) / LG_STEP;
  const int wg = threadIdx.x >> 7;

  if (wg >= LG_NWG) {
    // ------------------------------------------------------------- dequant
    setmaxnreg_dec<LG_DEQUANT_REGS>();
    constexpr int CPR = LG_BN / 8;              // 8-column chunks in a row of the band
    constexpr int RPP = LG_DQ_THREADS / CPR;    // rows a pass of the dequant threads
    constexpr int PASSES = LG_STEP / RPP;       // passes a step
    const int t = threadIdx.x - LG_NWG * 128;
    const int c = t % CPR, row0 = t / CPR;  // this thread's chunk, and its first row
    const int cols_here = min(LG_BN, w.tw - n0 % w.tw);  // less only in a flat last band
    const bool ok0 = 8 * c + 4 <= cols_here, ok1 = 8 * c + 8 <= cols_here;
    const uint8_t* wb = w.bytes + (n0 / w.tw) * w.tile_stride + n0 % w.tw + 8 * c;
    // chunk c of row r: box c / 8, 16-byte chunk (c % 8) ^ (r % 8) of the row
    const uint32_t chunk_off = (c / 8) * LG_BOX_BYTES;

    // the next step's bytes, loaded after this step's arrival on `full`
    uint32_t raw[PASSES][2];
    auto load = [&](int s) {
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int r = s * LG_STEP + p * RPP + row0;
        const uint8_t* src = wb + static_cast<long long>(r) * w.tw;
        raw[p][0] = r < k2 && ok0 ? __ldg(reinterpret_cast<const uint32_t*>(src)) : 0u;
        raw[p][1] = r < k2 && ok1 ? __ldg(reinterpret_cast<const uint32_t*>(src + 4)) : 0u;
      }
    };
    if (t == 0) tma_prefetch_map(&x_map);
    load(0);
    for (int s = 0; s < n_steps; ++s) {
      const int st = s % LG_STAGES;
      mbar_wait(empty(st), ((s / LG_STAGES) & 1) ^ 1);  // a fresh stage is free at once
      if (t == 0) {
        mbar_arrive_expect_tx(full(st), 2 * LG_X_BYTES);
        tma_load_4d(x_s(st, 0), &x_map, full(st), s * LG_STEP, m0, 0, 0);
        tma_load_4d(x_s(st, 1), &x_map, full(st), k2 + s * LG_STEP, m0, 0, 0);
      }
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int rr = p * RPP + row0;  // row of the step
        uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;  // rows past k2: zero weights
        if (s * LG_STEP + rr < k2) dequant8(raw[p][0] ^ w.flip, raw[p][1] ^ w.flip, lo, hi);
        const uint32_t off = chunk_off + rr * SWIZZLE_ROW_BYTES + (((c & 7) ^ (rr & 7)) << 4);
        st_shared_v4(w_s(st, 0) + off, lo);
        st_shared_v4(w_s(st, 1) + off, hi);
      }
      fence_proxy_async_shared();
      mbar_arrive(full(st));
      if (s + 1 < n_steps) load(s + 1);
    }
  } else {
    // ------------------------------------------------------------ consumer
    setmaxnreg_inc<LG_CONSUMER_REGS>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const bool idle = m0 + wg * 64 >= M;  // every row of this warpgroup lies past M
    float acc[LG_BN / 2];
#pragma unroll
    for (int i = 0; i < LG_BN / 2; ++i) acc[i] = 0.f;

    for (int s = 0; s < n_steps; ++s) {
      const int st = s % LG_STAGES;
      mbar_wait(full(st), (s / LG_STAGES) & 1);
      if (!idle) {
        wgmma_fence();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint64_t a = smem_desc_k_major(x_s(st, half) + wg * 64 * SWIZZLE_ROW_BYTES);
          const uint64_t b = smem_desc_mn_major(w_s(st, half), LG_BOX_BYTES);
#pragma unroll
          for (int kk = 0; kk < LG_STEP / 16; ++kk)  // 32 bytes along A's row, 16 rows of B
            wgmma_ss_tb(acc, desc_advance(a, kk * 32),
                        desc_advance(b, kk * 16 * SWIZZLE_ROW_BYTES), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done with their stage
      }
      if (s > 0 && lane == 0) mbar_arrive(empty((s - 1) % LG_STAGES));
    }
    wgmma_wait<0>();
    if (idle) return;

    const int gid = lane >> 2, tig = lane & 3;
    const bool pairs = (n_out & 1) == 0;  // 4-byte stores stay aligned
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wg * 64 + warp * 16 + gid + 8 * r;
      if (row >= M) continue;
      uint16_t* orow = out + static_cast<long long>(row) * n_out;
#pragma unroll
      for (int j = 0; j < LG_BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * tig;
        const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
        if (pairs && n + 1 < n_out) {
          const uint32_t packed = float_to_bf16(v0 * __ldg(scale + n)) |
                                  (uint32_t(float_to_bf16(v1 * __ldg(scale + n + 1))) << 16);
          *reinterpret_cast<uint32_t*>(orow + n) = packed;
        } else {
          if (n < n_out) orow[n] = float_to_bf16(v0 * __ldg(scale + n));
          if (n + 1 < n_out) orow[n + 1] = float_to_bf16(v1 * __ldg(scale + n + 1));
        }
      }
    }
  }
}

int launch_large_m(const uint16_t* x, const Weights& w, const float* scale, uint16_t* out,
                   int M, int K, long long x_rs, int n_out, cudaStream_t st) {
  // a tensor map needs a 16-byte-aligned base; a band must not straddle tiles
  if (reinterpret_cast<uintptr_t>(x) % 16 || (w.tile_stride != 0 && w.tw % LG_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  // x as [1, M, 1, K] through its row stride, boxes of 128 rows x 64 columns
  CUtensorMap x_map;
  int rows_first = 0;
  int err = encode_bf16_rows_map(&x_map, &rows_first, x, 1, M, 1, K, x_rs * M, x_rs,
                                 x_rs * M, LG_BM);
  if (err) return err;
  if (!rows_first) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB shared memory is dynamic and has to be asked for; the
  // attribute belongs to the device the launch goes to, so it is set once a
  // device, at the first launch there: a launch captured into a CUDA graph
  // (a decode step at M > 8) then calls nothing but the launch itself
  static bool smem_set[LG_MAX_DEVICES] = {};
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return static_cast<int>(derr);
  if (dev < 0 || dev >= LG_MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    const cudaError_t cerr = cudaFuncSetAttribute(
        int4_large_m_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(LG_SMEM));
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    smem_set[dev] = true;
  }
  const dim3 grid((M + LG_BM - 1) / LG_BM, (n_out + LG_BN - 1) / LG_BN);
  int4_large_m_kernel<<<grid, LG_THREADS, LG_SMEM, st>>>(x_map, w, scale, out, M, n_out);
  return 0;
}

int launch(const void* x, const Weights& w, const void* scale, void* out,
           int M, int K, long long x_rs, int n_out, const Split& split, void* stream) {
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<uint16_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || n_out <= 0 || n_out > w.n_total || w.tw % 4 || K > 2 * w.k2)
    return static_cast<int>(cudaErrorInvalidValue);
  // 8- and 16-byte x loads: rows, both halves of K and the slices must be 8-aligned
  if (K % 8 || w.k2 % 8 || x_rs % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 8 && (split.k_slices < 1 || split.k_slices > w.k2 ||
                 (split.k_slices > 1 && (!split.part || !split.tickets))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 8) {  // DC_M
    const int err = launch_decode(xp, w, sp, op, M, K, x_rs, n_out, split, st);
    if (err) return err;
  } else {
    const int err = launch_large_m(xp, w, sp, op, M, K, x_rs, n_out, st);
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

Weights tiled(const void* tiles, int k2, int n_tiles, int bn, int v3) {
  return Weights{static_cast<const uint8_t*>(tiles), static_cast<long long>(k2) * bn, bn,
                 n_tiles * bn, k2, v3 ? 0x80808080u : 0u};
}

}  // namespace

// Every entry: x bf16 [M, K] with row stride x_rs, K <= 2 k2; out bf16
// [M, n_out] contiguous; for M <= 8, k_slices >= 1 K slices and, where
// k_slices > 1, part fp32 [ceil(n_out / 128) * k_slices * M * 128]
// (contents ignored) and tickets int32 [ceil(n_out / 128)], zero, and zero
// again when the launch has run (both unread where k_slices is 1 or
// M > 8). Returns
// cudaGetLastError() after the launch (0 on success).

// K3a: flat u8 bytes [k2, N]; scale fp32 [N].
extern "C" int teochat_int4_matmul(const void* x, const void* packed, const void* scale,
                                   void* out, int M, int K, int k2, int N, long long x_rs,
                                   int k_slices, void* part, void* tickets, void* stream) {
  const Weights w{static_cast<const uint8_t*>(packed), 0, N, N, k2, 0u};
  const Split split{k_slices, static_cast<float*>(part), static_cast<int*>(tickets)};
  return launch(x, w, scale, out, M, K, x_rs, N, split, stream);
}

// K3b: tiled bytes [n_tiles, k2, bn] (v3 int8 when v3 != 0, else u8);
// scale fp32 with at least n_out entries.
extern "C" int teochat_int4_matmul_tiled(const void* x, const void* tiles, const void* scale,
                                         void* out, int M, int K, int k2, int n_tiles, int bn,
                                         int n_out, long long x_rs, int v3, int k_slices,
                                         void* part, void* tickets, void* stream) {
  if (bn % 128) return static_cast<int>(cudaErrorInvalidValue);  // bands must not straddle tiles
  const Split split{k_slices, static_cast<float*>(part), static_cast<int*>(tickets)};
  return launch(x, tiled(tiles, k2, n_tiles, bn, v3), scale, out, M, K, x_rs, n_out, split,
                stream);
}

// K3c: K3b on layer `layer` of the stacked buffers: tiles [L, n_tiles, k2, bn],
// scale fp32 [L, scale_ls]. Only that layer's bytes are read.
extern "C" int teochat_int4_matmul_tiled_stacked(const void* x, const void* tiles,
                                                 const void* scale, void* out, int M, int K,
                                                 int k2, int n_tiles, int bn, int n_out,
                                                 long long x_rs, int v3, int layer,
                                                 long long scale_ls, int k_slices, void* part,
                                                 void* tickets, void* stream) {
  if (bn % 128 || layer < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long layer_bytes = static_cast<long long>(n_tiles) * k2 * bn;
  const auto* base = static_cast<const uint8_t*>(tiles) + layer * layer_bytes;
  const auto* sc = static_cast<const float*>(scale) + layer * scale_ls;
  const Split split{k_slices, static_cast<float*>(part), static_cast<int*>(tickets)};
  return launch(x, tiled(base, k2, n_tiles, bn, v3), sc, out, M, K, x_rs, n_out, split, stream);
}
