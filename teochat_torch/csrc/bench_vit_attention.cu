// One-sweep ViT attention variants of the kernel bench, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of scripts/bench_vit_attention.py: _kernel_b
// (:36; [B, S, H, D] read in place, `bh` heads a grid cell, no padding of S)
// and _kernel_c (:76; contiguous [B H, S, D] rows, one head a cell, the caller
// transposes to and from). Both compute softmax(q k^T / sqrt(d)) v with the
// whole score row at once: the maximum and the sum over all keys first, then
// p / l rounded to bf16, then the product with v (fp32 accumulation).
//
// What bounds them on an H100: at the tower's shape (S = 257, D = 64) the
// tensor-core work of the two products and the exponentials, not the bytes
// (q, k, v, o cross device memory once; K and V are re-read by the query
// tiles of a head and hit L2). Against vit_attention.cu (two sweeps over the
// keys, q k^T computed twice) these keep the score row on the SM, so q k^T is
// computed once: a block of 4 warps owns 64 query rows, a warp 16 of them,
// and writes its scaled, masked scores as fp32 into shared memory in the
// layout of its own mma fragments (a thread reads back only what it wrote:
// no bank conflict and no barrier), 2 KB for every 8 keys. Pass 1 computes
// the scores tile by tile and the row maxima; pass 2 exponentiates in place
// and sums; pass 3 feeds bf16(p / l) to the product with V tile by tile. Keys
// past S are masked before the maximum; rows past S are never read or written.
// S is bounded by the SM's shared memory (13 key tiles: S <= 832).
//
// b: grid (query tiles, H / bh, B), the block walks its bh heads, reading
// q, k, v and writing o at a head stride of D elements inside [B, S, H, D].
// c: grid (query tiles, B H), one contiguous [S, D] matrix each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using teochat::MASK_VALUE;
using teochat::load_b_cols;
using teochat::load_b_rows;
using teochat::mma_16816;
using teochat::pack_bf16;

constexpr int D = 64;
constexpr int BQ = 64;  // query rows per block (16 per warp)
constexpr int BK = 64;  // keys per tile
constexpr int NTHREADS = 128;
constexpr int LD = D + 8;  // padded shared row, in bf16 elements
constexpr int MAX_KV_TILES = 13;
constexpr int TILE_CHUNKS = BK * (D / 8) / NTHREADS;  // 16-byte chunks of a tile a thread moves

// A thread's share of one 64-row tile (4 chunks of 16 bytes), from device
// memory into registers; rows past n read as zero.
__device__ __forceinline__ void fetch_tile(uint4 (&pre)[TILE_CHUNKS], const uint16_t* src,
                                           long long rs, int row0, int n, int tid) {
#pragma unroll
  for (int i = 0; i < TILE_CHUNKS; ++i) {
    const int idx = tid + i * NTHREADS, r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    pre[i] = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) pre[i] = *reinterpret_cast<const uint4*>(src + (row0 + r) * rs + c);
  }
}

// ... and from the registers into the shared tile, between two barriers.
__device__ __forceinline__ void store_tile(uint16_t* tile, const uint4 (&pre)[TILE_CHUNKS],
                                           int tid) {
  __syncthreads();  // every warp is done with the tile buffer
#pragma unroll
  for (int i = 0; i < TILE_CHUNKS; ++i) {
    const int idx = tid + i * NTHREADS, r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(tile + r * LD + c) = pre[i];
  }
  __syncthreads();
}

// One head: q rows [row0, row0 + 16) of this warp against all S keys.
// q, k, v, o point at the head's first row; *_ss are row strides in elements.
// Each tile is fetched into registers while the one before it is computed on,
// so the loads' latency hides behind the products. Only the n-tiles of 8 keys
// that hold a key below S are computed, stored and multiplied (S = 257: 33,
// not the 40 of five full tiles).
__device__ __forceinline__ void one_sweep_head(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, uint16_t* __restrict__ o, long long q_ss, long long k_ss,
    long long v_ss, long long o_ss, int S, float scale, float2* sc, uint16_t* tile) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * BQ + warp * 16;
  const int n_kv = (S + BK - 1) / BK, n8 = (S + 7) / 8;
  float2* mine = sc + static_cast<long long>(warp) * n8 * 64 + lane;

  uint4 pre[TILE_CHUNKS];
  fetch_tile(pre, k, k_ss, 0, S, tid);
  uint32_t qf[D / 16][4];
  {
    const int r_lo = row0 + gid, r_hi = row0 + gid + 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
      qf[kk][0] = r_lo < S ? *reinterpret_cast<const uint32_t*>(q + r_lo * q_ss + c) : 0u;
      qf[kk][1] = r_hi < S ? *reinterpret_cast<const uint32_t*>(q + r_hi * q_ss + c) : 0u;
      qf[kk][2] = r_lo < S ? *reinterpret_cast<const uint32_t*>(q + r_lo * q_ss + c + 8) : 0u;
      qf[kk][3] = r_hi < S ? *reinterpret_cast<const uint32_t*>(q + r_hi * q_ss + c + 8) : 0u;
    }
  }

  // pass 1: scores of every key tile, once; the row maxima (rows gid, gid + 8)
  float m_row[2] = {MASK_VALUE, MASK_VALUE};
  for (int j = 0; j < n_kv; ++j) {
    store_tile(tile, pre, tid);
    if (j + 1 < n_kv)
      fetch_tile(pre, k, k_ss, (j + 1) * BK, S, tid);
    else
      fetch_tile(pre, v, v_ss, 0, S, tid);  // the first V tile, behind passes 1 and 2
    const int nt_end = min(BK / 8, n8 - j * (BK / 8));
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      if (nt >= nt_end) break;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, tile, LD, nt * 8, kk * 16, gid, tig);
        mma_16816(s, qf[kk], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BK + nt * 8 + tig * 2 + (e & 1);
        s[e] = col < S ? s[e] * scale : MASK_VALUE;
      }
      m_row[0] = fmaxf(m_row[0], fmaxf(s[0], s[1]));
      m_row[1] = fmaxf(m_row[1], fmaxf(s[2], s[3]));
      mine[(j * (BK / 8) + nt) * 64] = make_float2(s[0], s[1]);
      mine[(j * (BK / 8) + nt) * 64 + 32] = make_float2(s[2], s[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's scores are spread over the 4 lanes of a quad
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
  }

  // pass 2: p = exp(s - m) in place, l = sum p; a masked key underflows to 0
  float l_row[2] = {0.f, 0.f};
  for (int t = 0; t < n8; ++t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 s = mine[t * 64 + r * 32];
      s.x = __expf(s.x - m_row[r]);
      s.y = __expf(s.y - m_row[r]);
      l_row[r] += s.x + s.y;
      mine[t * 64 + r * 32] = s;
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
    inv[r] = 1.f / l_row[r];  // the row's own maximum contributes exp(0) = 1
  }

  // pass 3: o = bf16(p / l) v
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int j = 0; j < n_kv; ++j) {
    store_tile(tile, pre, tid);
    if (j + 1 < n_kv) fetch_tile(pre, v, v_ss, (j + 1) * BK, S, tid);
    const int nt_end = min(BK / 8, n8 - j * (BK / 8));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (2 * kk >= nt_end) break;
      const float2* p0 = mine + (j * (BK / 8) + 2 * kk) * 64;
      const float2 zero = make_float2(0.f, 0.f);
      const bool both = 2 * kk + 1 < nt_end;  // else the step's upper 8 keys are all past S
      const float2 lo0 = p0[0], hi0 = p0[32];
      const float2 lo1 = both ? p0[64] : zero, hi1 = both ? p0[96] : zero;
      const uint32_t a[4] = {pack_bf16(lo0.x * inv[0], lo0.y * inv[0]),
                             pack_bf16(hi0.x * inv[1], hi0.y * inv[1]),
                             pack_bf16(lo1.x * inv[0], lo1.y * inv[0]),
                             pack_bf16(hi1.x * inv[1], hi1.y * inv[1])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, tile, LD, kk * 16, dt * 8, gid, tig);
        mma_16816(acc[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gid + 8 * r;
    if (row >= S) continue;
    uint16_t* orow = o + row * o_ss;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + tig * 2) =
          pack_bf16(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// S2-b: q, k, v, o bf16 [B, S, H, 64]; o contiguous, the others through their
// strides. Block (query tile, head group, frame) walks heads [y bh, y bh + bh).
__global__ void __launch_bounds__(NTHREADS)
bench_vit_attention_b_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                             const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                             int S, int H, int bh,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh, float scale) {
  extern __shared__ __align__(16) float2 scores[];
  __shared__ __align__(16) uint16_t tile[BK * LD];
  const int b = blockIdx.z;
  for (int h = blockIdx.y * bh; h < (blockIdx.y + 1) * bh; ++h)
    one_sweep_head(q + b * q_sb + h * q_sh, k + b * k_sb + h * k_sh, v + b * v_sb + h * v_sh,
                   o + (static_cast<long long>(b) * S * H + h) * D, q_ss, k_ss, v_ss,
                   static_cast<long long>(H) * D, S, scale, scores, tile);
}

// S2-c: q, k, v, o bf16 [B H, S, 64] contiguous. Block (query tile, row of B H).
__global__ void __launch_bounds__(NTHREADS)
bench_vit_attention_c_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                             const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                             int S, float scale) {
  extern __shared__ __align__(16) float2 scores[];
  __shared__ __align__(16) uint16_t tile[BK * LD];
  const long long base = static_cast<long long>(blockIdx.y) * S * D;
  one_sweep_head(q + base, k + base, v + base, o + base, D, D, D, D, S, scale, scores, tile);
}

// bytes of score rows a block needs, or 0 where S does not fit an SM
size_t score_bytes(int S) {
  if (S <= 0 || (S + BK - 1) / BK > MAX_KV_TILES) return 0;
  // per warp and n-tile of 8 keys: 2 row halves x 32 lanes x float2
  return static_cast<size_t>(NTHREADS / 32) * ((S + 7) / 8) * 64 * sizeof(float2);
}

}  // namespace

// S2-b. Returns cudaGetLastError() after the launch; bh must divide H.
extern "C" int teochat_bench_vit_attention_b(const void* q, const void* k, const void* v,
                                             void* o, int B, int S, int H, int D_, int bh,
                                             long long q_sb, long long q_ss, long long q_sh,
                                             long long k_sb, long long k_ss, long long k_sh,
                                             long long v_sb, long long v_ss, long long v_sh,
                                             float scale, void* stream) {
  const size_t smem = score_bytes(S);
  if (D_ != D || B <= 0 || H <= 0 || bh <= 0 || H % bh || smem == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(bench_vit_attention_b_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H / bh, B);
  bench_vit_attention_b_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), S, H, bh,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

// S2-c. q, k, v, o contiguous [BH, S, 64].
extern "C" int teochat_bench_vit_attention_c(const void* q, const void* k, const void* v,
                                             void* o, int BH, int S, int D_, float scale,
                                             void* stream) {
  const size_t smem = score_bytes(S);
  if (D_ != D || BH <= 0 || smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(bench_vit_attention_c_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, BH);
  bench_vit_attention_c_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), S, scale);
  return static_cast<int>(cudaGetLastError());
}
