// One-shot bidirectional attention for the ViT (sm_90a), bf16 in and out.
//
// Replaces teochat_tpu/ops/vit_attention.py::_attn_kernel (K5), driven there
// by _vit_attention_pallas / vit_attention. It computes what that kernel
// computes: scores = q k^T * scale in fp32, keys past the sequence masked,
// an exact softmax (row maximum m over all keys, p = exp(s - m), l = sum p
// in fp32), and o = (bf16(p) v) / l with fp32 accumulation.
//
// What bounds it on an H100: at the tower's shape (S = 257, D = 64) the two
// products, i.e. tensor-core FLOPs, and for a 2-frame request the launch
// itself; q, k, v and o cross device memory once (K and V are re-read by the
// 5 query bands of a head and hit L2). Nothing but o is written: the score
// matrix the plain version materializes never leaves the SM.
//
// Design: one block of 4 warps per (band of 64 query rows, head, frame), 16
// rows a warp, the query fragments in registers. The softmax is exact without
// holding a whole score row: a first sweep over the key tiles computes the
// scores and keeps only each row's maximum; a second sweep computes them
// again, exponentiates against the final maximum and feeds PV, so there is
// no running rescale and any S fits. QK^T is done twice (half of the work
// again), which buys independence from S; K tiles are staged twice, V once.
// q, k, v are read as [B, S, H, 64] through their strides, so the TPU
// wrapper's transposes to [BH, S, D] and its padding of S are not needed:
// the ragged last tile is masked here. o is contiguous [B, S, H, 64].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using teochat::MASK_VALUE;
using teochat::load_b_cols;
using teochat::load_b_rows;
using teochat::load_tile;
using teochat::mma_16816;
using teochat::pack_bf16;

constexpr int D = 64;
constexpr int BQ = 64;  // query rows per block (16 per warp)
constexpr int BK = 64;  // keys per tile
constexpr int NTHREADS = 128;
constexpr int LD = D + 8;  // padded shared row, in bf16 elements

// scores of this warp's 16 rows against the staged key tile, scaled and masked
__device__ __forceinline__ void score_tile(float (&s)[BK / 8][4], const uint32_t (&qf)[D / 16][4],
                                           const uint16_t* ks, int k0, int S, float scale,
                                           int gid, int tig) {
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b0, b1;
      load_b_rows(b0, b1, ks, LD, nt * 8, kk * 16, gid, tig);
      mma_16816(s[nt], qf[kk], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + nt * 8 + tig * 2 + (e & 1);
      s[nt][e] = col < S ? s[nt][e] * scale : MASK_VALUE;
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
vit_attention_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                     int S, int H,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh, float scale) {
  __shared__ __align__(16) uint16_t ks[BK * LD];
  __shared__ __align__(16) uint16_t vs[BK * LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * BQ + warp * 16;

  uint32_t qf[D / 16][4];
  {
    const uint16_t* qb = q + b * q_sb + h * q_sh;
    const int r_lo = row0 + gid, r_hi = row0 + gid + 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
      qf[kk][0] = r_lo < S ? *reinterpret_cast<const uint32_t*>(qb + r_lo * q_ss + c) : 0u;
      qf[kk][1] = r_hi < S ? *reinterpret_cast<const uint32_t*>(qb + r_hi * q_ss + c) : 0u;
      qf[kk][2] = r_lo < S ? *reinterpret_cast<const uint32_t*>(qb + r_lo * q_ss + c + 8) : 0u;
      qf[kk][3] = r_hi < S ? *reinterpret_cast<const uint32_t*>(qb + r_hi * q_ss + c + 8) : 0u;
    }
  }

  const uint16_t* kb = k + b * k_sb + h * k_sh;
  const uint16_t* vb = v + b * v_sb + h * v_sh;
  const int n_kv = (S + BK - 1) / BK;
  float s[BK / 8][4];

  // sweep 1: each row's maximum over all keys (rows gid and gid + 8)
  float m_row[2] = {MASK_VALUE, MASK_VALUE};
  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();
    load_tile<D>(ks, LD, kb, k_ss, j * BK, BK, S, tid, NTHREADS);
    __syncthreads();
    score_tile(s, qf, ks, j * BK, S, scale, gid, tig);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      m_row[0] = fmaxf(m_row[0], fmaxf(s[nt][0], s[nt][1]));
      m_row[1] = fmaxf(m_row[1], fmaxf(s[nt][2], s[nt][3]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's scores are spread over the 4 lanes of a quad
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
  }

  // sweep 2: p = exp(s - m), l = sum p, acc = bf16(p) v
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float l_row[2] = {0.f, 0.f};
  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();
    load_tile<D>(ks, LD, kb, k_ss, j * BK, BK, S, tid, NTHREADS);
    load_tile<D>(vs, LD, vb, v_ss, j * BK, BK, S, tid, NTHREADS);
    __syncthreads();
    score_tile(s, qf, ks, j * BK, S, scale, gid, tig);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked key is MASK_VALUE - m, far below where exp underflows to 0
        s[nt][e] = __expf(s[nt][e] - m_row[e >> 1]);
        l_row[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, vs, LD, kk * 16, dt * 8, gid, tig);
        mma_16816(acc[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
    const int row = row0 + gid + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / l_row[r];  // the row's own maximum contributes exp(0) = 1
    uint16_t* orow = o + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + tig * 2) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
  }
}

}  // namespace

// K5. q, k, v bf16 [B, S, H, 64] read through their strides (last dimension
// contiguous, the others multiples of 8 elements); o bf16 [B, S, H, 64]
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int teochat_vit_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int S, int H, int D_,
                                     long long q_sb, long long q_ss, long long q_sh,
                                     long long k_sb, long long k_ss, long long k_sh,
                                     long long v_sb, long long v_ss, long long v_sh,
                                     float scale, void* stream) {
  if (D_ != D || B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  vit_attention_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), S, H,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  return static_cast<int>(cudaGetLastError());
}
