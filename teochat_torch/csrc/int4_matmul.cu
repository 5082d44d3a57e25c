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
//   * M > 8 (prefill): bound by the multiply-accumulates. A block computes a
//     128 x 128 output tile on mma.sync m16n8k16 (bf16 in, fp32 accumulate):
//     per step it dequantizes 32 byte rows into two bf16 tiles in shared
//     memory (low and high halves of K) beside the two matching x tiles.
// Later work: split-K for the narrow projections at batch 1, and a
// wgmma + TMA pipeline for the prefill shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using teochat::load_a;
using teochat::mma_16816;

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

constexpr int LG_THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int LG_BM = 128;
constexpr int LG_BN = 128;
constexpr int LG_KT = 32;            // byte rows per step (32 of each K half)
constexpr int LG_XLD = LG_KT + 8;    // x tile row, in bf16 elements
constexpr int LG_WLD = LG_BN + 8;    // weight tile row, in k-pairs (uint32)

// bf16 pair (128 + a, 128 + b) minus (136, 136): the exact values a - 8, b - 8
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t pair) {
  const uint32_t biased = pair | 0x43004300u;
  const uint32_t k136 = 0x43084308u;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                             *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(LG_THREADS)
int4_large_m_kernel(const uint16_t* __restrict__ x, Weights w,
                    const float* __restrict__ scale, uint16_t* __restrict__ out,
                    int M, int K, long long x_rs, int n_out) {
  // x tiles row-major [BM][KT]; weight tiles [KT / 2][BN] of (k even, k odd)
  // bf16 pairs, which is what one B-fragment register holds
  __shared__ __align__(16) uint16_t xs_lo[LG_BM * LG_XLD];
  __shared__ __align__(16) uint16_t xs_hi[LG_BM * LG_XLD];
  __shared__ __align__(16) uint32_t ws_lo[(LG_KT / 2) * LG_WLD];
  __shared__ __align__(16) uint32_t ws_hi[(LG_KT / 2) * LG_WLD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // warp tile: rows wm*32, cols wn*64
  const int m0 = blockIdx.x * LG_BM;        // neighbours in x share a weight band
  const int n0 = blockIdx.y * LG_BN;
  const int k2 = w.k2;
  const uint8_t* wb = w.bytes + (n0 / w.tw) * w.tile_stride + (n0 % w.tw);
  const int cols_here = min(LG_BN, w.tw - n0 % w.tw);  // ragged only when flat

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int r0 = 0; r0 < k2; r0 += LG_KT) {
    __syncthreads();  // every warp is done with the previous step's tiles
    // x: BM rows x 4 chunks of 8 bf16, for each half of K
    for (int idx = tid; idx < LG_BM * (LG_KT / 8); idx += LG_THREADS) {
      const int row = idx / (LG_KT / 8), c = (idx % (LG_KT / 8)) * 8;
      const int r = r0 + c;  // K, k2 and r are multiples of 8: a chunk is all in or all out
      uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
      if (m0 + row < M && r < k2) {
        const uint16_t* xr = x + (m0 + row) * x_rs;
        if (r < K) lo = *reinterpret_cast<const uint4*>(xr + r);
        if (k2 + r < K) hi = *reinterpret_cast<const uint4*>(xr + k2 + r);
      }
      *reinterpret_cast<uint4*>(&xs_lo[row * LG_XLD + c]) = lo;
      *reinterpret_cast<uint4*>(&xs_hi[row * LG_XLD + c]) = hi;
    }
    // weights: 16 row pairs x 32 words of 4 columns
    for (int idx = tid; idx < (LG_KT / 2) * (LG_BN / 4); idx += LG_THREADS) {
      const int rp = idx / (LG_BN / 4), c = (idx % (LG_BN / 4)) * 4;
      const int r = r0 + 2 * rp;
      uint32_t b0 = 0u, b1 = 0u;
      if (c + 4 <= cols_here) {  // rows past k2 meet x = 0: any bytes will do
        if (r < k2) b0 = *reinterpret_cast<const uint32_t*>(wb + static_cast<long long>(r) * w.tw + c);
        if (r + 1 < k2)
          b1 = *reinterpret_cast<const uint32_t*>(wb + static_cast<long long>(r + 1) * w.tw + c);
      }
      b0 ^= w.flip;
      b1 ^= w.flip;
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte j of row r in bits 0-7, byte j of row r + 1 in bits 16-23
        const uint32_t t = __byte_perm(b0, b1, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
        lo[j] = nibbles_to_bf16x2(t & 0x000F000Fu);
        hi[j] = nibbles_to_bf16x2((t >> 4) & 0x000F000Fu);
      }
      *reinterpret_cast<uint4*>(&ws_lo[rp * LG_WLD + c]) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(&ws_hi[rp * LG_WLD + c]) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint16_t* xs = half ? xs_hi : xs_lo;
      const uint32_t* ws = half ? ws_hi : ws_lo;
#pragma unroll
      for (int kk = 0; kk < LG_KT / 16; ++kk) {
        uint32_t a[2][4];
        load_a(a[0], xs, LG_XLD, wm * 32, kk * 16, gid, tig);
        load_a(a[1], xs, LG_XLD, wm * 32 + 16, kk * 16, gid, tig);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t* p = ws + (kk * 8 + tig) * LG_WLD + wn * 64 + nt * 8 + gid;
          const uint32_t f0 = p[0], f1 = p[4 * LG_WLD];
          mma_16816(acc[0][nt], a[0], f0, f1);
          mma_16816(acc[1][nt], a[1], f0, f1);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + i * 16 + gid + (e >= 2 ? 8 : 0);
        const int n = n0 + wn * 64 + nt * 8 + tig * 2 + (e & 1);
        if (m < M && n < n_out)
          out[static_cast<long long>(m) * n_out + n] = float_to_bf16(acc[i][nt][e] * scale[n]);
      }
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
    const dim3 grid((M + LG_BM - 1) / LG_BM, (w.n_total + LG_BN - 1) / LG_BN);
    int4_large_m_kernel<<<grid, LG_THREADS, 0, st>>>(xp, w, sp, op, M, K, x_rs, n_out);
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
