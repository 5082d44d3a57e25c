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
//   * M <= 8 (decode): bound by the packed bytes, each read exactly once.
//     A block owns a band of BN columns and all k2 rows; a lane reads 4-byte
//     words (4 columns of one row) for 8 consecutive rows at a time and the
//     matching x values with one 16-byte load per half of K (x stays in
//     L1 / L2), and the accumulators stay in registers. Nibbles become
//     floats without an integer convert: 0x4B000000 | v is the float 2^23 + v.
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
// Later work: split-K for the narrow projections at batch 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_async.cuh"

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

__device__ __forceinline__ float bf16_to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ uint16_t float_to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// ------------------------------------------------------------- small M

constexpr int SM_THREADS = 256;  // 8 warps
constexpr int SM_ROWS = 8;       // consecutive byte rows a thread takes at a time

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Lane (rg, cg) of a warp owns 4 columns (one 4-byte word a row) and, in each
// step, 8 consecutive rows, so its x values for a step are one 16-byte load
// per half of K and per row of x. x is a few KB shared by every block and
// stays in L1 / L2; the 8 weight words of a step are in flight together and
// nothing synchronizes until the final sum over row groups and warps.
template <int MT, int BN>
__global__ void __launch_bounds__(SM_THREADS)
int4_small_m_kernel(const uint16_t* __restrict__ x, Weights w,
                    const float* __restrict__ scale, uint16_t* __restrict__ out,
                    int M, int K, long long x_rs, int n_out) {
  constexpr int LPR = BN / 4;   // lanes across one row of the band
  constexpr int RG = 32 / LPR;  // row groups of a warp
  constexpr int STEP = 8 * RG * SM_ROWS;  // rows the block takes in one step
  __shared__ float red[8 * MT * BN];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane / LPR, cg = lane % LPR;
  const int n0 = blockIdx.x * BN;
  const int col = (n0 % w.tw) + cg * 4;  // first of this lane's 4 columns
  const bool col_ok = col + 4 <= w.tw;   // the flat layout's ragged last band
  const uint8_t* wb = w.bytes + (n0 / w.tw) * w.tile_stride + col;
  const int k2 = w.k2;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  // k2 and K are multiples of 8: a thread's 8 rows are all inside or all outside
#pragma unroll(MT <= 2 ? 2 : 1)
  for (int r = (warp * RG + rg) * SM_ROWS; r < k2; r += STEP) {
    uint32_t words[SM_ROWS];
#pragma unroll
    for (int u = 0; u < SM_ROWS; ++u)
      words[u] = col_ok ? *reinterpret_cast<const uint32_t*>(
                              wb + static_cast<long long>(r + u) * w.tw)
                        : 0u;
    uint4 xl[MT], xh[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      xl[m] = xh[m] = make_uint4(0, 0, 0, 0);
      if (m < M) {
        const uint16_t* xr = x + m * x_rs;
        if (r < K) xl[m] = __ldg(reinterpret_cast<const uint4*>(xr + r));
        if (k2 + r < K) xh[m] = __ldg(reinterpret_cast<const uint4*>(xr + k2 + r));
      }
    }
    float wl[SM_ROWS][4], wh[SM_ROWS][4];
#pragma unroll
    for (int u = 0; u < SM_ROWS; ++u) {
      const uint32_t b = words[u] ^ w.flip;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // 2^23 + (v + 8) as a float, minus 2^23 + 8: the exact value v
        wl[u][j] = __uint_as_float(0x4B000000u | ((b >> (8 * j)) & 15u)) - 8388616.f;
        wh[u][j] = __uint_as_float(0x4B000000u | ((b >> (8 * j + 4)) & 15u)) - 8388616.f;
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float fl[8], fh[8];
      unpack8(xl[m], fl);
      unpack8(xh[m], fh);
#pragma unroll
      for (int u = 0; u < SM_ROWS; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[m][j] = fmaf(fl[u], wl[u][j], fmaf(fh[u], wh[u][j], acc[m][j]));
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
  for (int idx = tid; idx < MT * BN; idx += SM_THREADS) {
    const int m = idx / BN, n = n0 + idx % BN;
    if (m >= M || n >= n_out) continue;
    float sum = 0.f;
#pragma unroll
    for (int wq = 0; wq < 8; ++wq) sum += red[wq * MT * BN + idx];
    out[static_cast<long long>(m) * n_out + n] = float_to_bf16(sum * scale[n]);
  }
}

template <int MT>
void launch_small_m(const uint16_t* x, const Weights& w, const float* scale, uint16_t* out,
                    int M, int K, long long x_rs, int n_out, cudaStream_t st) {
  // bands of 32 columns give the most blocks (decode has no other
  // parallelism: N / 32 blocks, 128 for a 4096-wide output on 132 SMs);
  // wider bands only once every SM would still hold several blocks
  int bn = 128;
  while (bn > 32 && (w.n_total + bn - 1) / bn < 4 * 132) bn /= 2;
  const int grid = (w.n_total + bn - 1) / bn;
  if (bn == 128)
    int4_small_m_kernel<MT, 128><<<grid, SM_THREADS, 0, st>>>(x, w, scale, out, M, K, x_rs, n_out);
  else if (bn == 64)
    int4_small_m_kernel<MT, 64><<<grid, SM_THREADS, 0, st>>>(x, w, scale, out, M, K, x_rs, n_out);
  else
    int4_small_m_kernel<MT, 32><<<grid, SM_THREADS, 0, st>>>(x, w, scale, out, M, K, x_rs, n_out);
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

// bf16 pair (128 + a, 128 + b) minus (136, 136): the exact values a - 8, b - 8
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t pair) {
  const uint32_t biased = pair | 0x43004300u;
  const uint32_t k136 = 0x43084308u;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                             *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&v);
}

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
  // attribute belongs to the device the launch goes to, so it is set each time
  const cudaError_t cerr = cudaFuncSetAttribute(
      int4_large_m_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(LG_SMEM));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((M + LG_BM - 1) / LG_BM, (n_out + LG_BN - 1) / LG_BN);
  int4_large_m_kernel<<<grid, LG_THREADS, LG_SMEM, st>>>(x_map, w, scale, out, M, n_out);
  return 0;
}

int launch(const void* x, const Weights& w, const void* scale, void* out,
           int M, int K, long long x_rs, int n_out, void* stream) {
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<uint16_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || n_out <= 0 || n_out > w.n_total || w.tw % 4 || K > 2 * w.k2)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte x loads: rows, both halves of K and the steps must be 8-aligned
  if (K % 8 || w.k2 % 8 || x_rs % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 1) {
    launch_small_m<1>(xp, w, sp, op, M, K, x_rs, n_out, st);
  } else if (M <= 2) {
    launch_small_m<2>(xp, w, sp, op, M, K, x_rs, n_out, st);
  } else if (M <= 4) {
    launch_small_m<4>(xp, w, sp, op, M, K, x_rs, n_out, st);
  } else if (M <= 8) {
    launch_small_m<8>(xp, w, sp, op, M, K, x_rs, n_out, st);
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

// K3a: flat u8 bytes [k2, N]; x bf16 [M, K] with row stride x_rs, K <= 2 k2;
// scale fp32 [N]; out bf16 [M, N] contiguous. Returns cudaGetLastError().
extern "C" int teochat_int4_matmul(const void* x, const void* packed, const void* scale,
                                   void* out, int M, int K, int k2, int N, long long x_rs,
                                   void* stream) {
  const Weights w{static_cast<const uint8_t*>(packed), 0, N, N, k2, 0u};
  return launch(x, w, scale, out, M, K, x_rs, N, stream);
}

// K3b: tiled bytes [n_tiles, k2, bn] (v3 int8 when v3 != 0, else u8);
// scale fp32 with at least n_out entries; out bf16 [M, n_out] contiguous.
extern "C" int teochat_int4_matmul_tiled(const void* x, const void* tiles, const void* scale,
                                         void* out, int M, int K, int k2, int n_tiles, int bn,
                                         int n_out, long long x_rs, int v3, void* stream) {
  if (bn % 128) return static_cast<int>(cudaErrorInvalidValue);  // bands must not straddle tiles
  return launch(x, tiled(tiles, k2, n_tiles, bn, v3), scale, out, M, K, x_rs, n_out, stream);
}

// K3c: K3b on layer `layer` of the stacked buffers: tiles [L, n_tiles, k2, bn],
// scale fp32 [L, scale_ls]. Only that layer's bytes are read.
extern "C" int teochat_int4_matmul_tiled_stacked(const void* x, const void* tiles,
                                                 const void* scale, void* out, int M, int K,
                                                 int k2, int n_tiles, int bn, int n_out,
                                                 long long x_rs, int v3, int layer,
                                                 long long scale_ls, void* stream) {
  if (bn % 128 || layer < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long layer_bytes = static_cast<long long>(n_tiles) * k2 * bn;
  const auto* base = static_cast<const uint8_t*>(tiles) + layer * layer_bytes;
  const auto* sc = static_cast<const float*>(scale) + layer * scale_ls;
  return launch(x, tiled(base, k2, n_tiles, bn, v3), sc, out, M, K, x_rs, n_out, stream);
}
