// Flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces teochat_tpu/ops/flash_attention.py::_flash_kernel (driven there by
// _flash_bhsd / flash_attention; K1, inference) and, with the STATS flag,
// ::_flash_fwd_res_kernel (K4a, the training forward, which also stores each
// row's m and l for the backward in flash_attention_bwd.cu). It computes
// what those kernels compute:
// tiled online-softmax attention with fp32 running max, denominator and
// accumulator; causal kv tiles above the diagonal are skipped and the diagonal
// tile is masked per element; GQA query head h reads kv head h / (H / Hkv);
// a row whose denominator is 0 is written as 0 (the `l == 0` guard).
//
// What bounds it on an H100: at prefill lengths (S >= 512, D = 128) the two
// products QK^T and PV, i.e. tensor-core FLOPs; K and V bytes are re-read once
// per 64-row query tile and mostly hit L2. The design keeps the query tile and
// the output accumulator in registers for the whole kv loop (nothing but the
// final output goes back to device memory) and issues both products on
// mma.sync m16n8k16 bf16 with fp32 accumulation. The score tile is turned
// into the A operand of PV in registers, without a trip through shared memory.
//
// Layout: one block of 4 warps per (query tile of 64 rows, head, batch row);
// each warp owns 16 query rows. The TPU kernel's sequential kv grid axis is
// the loop inside the block. q, k and v are read as [B, S|T, H|Hkv, D]
// through their strides (the last dimension contiguous); o is contiguous
// [B, S, H, D]. Causal masking assumes S == T (a self-attention prefill), as
// the TPU kernel does. Later work: wgmma + TMA, double-buffered kv tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using teochat::MASK_VALUE;
using teochat::mma_16816;
using teochat::pack_bf16;

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // keys per kv tile
constexpr int NTHREADS = 128;

// STATS (K4a, the training forward) also writes each row's running max m
// and denominator l, fp32 [B, H, S], for the backward kernels.
template <int D, bool STATS>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int S, int T, int H, int Hkv,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_st, long long k_sh,
                 long long v_sb, long long v_st, long long v_sh,
                 float scale, int causal) {
  constexpr int LD = D + 8;  // padded shared row, in bf16 elements
  __shared__ __align__(16) uint16_t ks[BK * LD];
  __shared__ __align__(16) uint16_t vs[BK * LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  // causal tiles further down the sequence do the most work: start them first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row0 = qt * BQ + warp * 16;  // this warp's first query row

  // Query fragments for the whole head dimension stay in registers.
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

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows gid and gid + 8
  float l_run[2] = {0.f, 0.f};

  int n_kv = (T + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (qt * BQ + BQ - 1) / BK + 1);

  const uint16_t* kb = k + b * k_sb + hk * k_sh;
  const uint16_t* vb = v + b * v_sb + hk * v_sh;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous tile
    constexpr int CH = D / 8;  // 16-byte chunks per row
    for (int idx = tid; idx < BK * CH; idx += NTHREADS) {
      const int r = idx / CH, c = (idx % CH) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (k0 + r < T) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (k0 + r) * k_st + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (k0 + r) * v_st + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * LD + c]) = kv4;
      *reinterpret_cast<uint4*>(&vs[r * LD + c]) = vv4;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint16_t* kr = &ks[(nt * 8 + gid) * LD + kk * 16 + tig * 2];
        mma_16816(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, then mask (ragged keys and the causal diagonal)
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + gid + (e >= 2 ? 8 : 0);
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        float x = s[nt][e] * scale;
        if (col >= T || (causal && col > row)) x = MASK_VALUE;
        s[nt][e] = x;
      }
    }

    // online softmax; a row's 64 scores are spread over the 4 lanes of a quad
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_next = fmaxf(m_run[r], mx);
      alpha[r] = __expf(m_run[r] - m_next);
      m_run[r] = m_next;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        s[nt][2 * r] = __expf(s[nt][2 * r] - m_next);
        s[nt][2 * r + 1] = __expf(s[nt][2 * r + 1] - m_next);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[r] = alpha[r] * l_run[r] + sum;
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // acc += P V: the C fragments of two neighbouring key tiles are exactly
    // the A fragment of one 16-deep step of the second product
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const uint16_t* vr = &vs[(kk * 16 + tig * 2) * LD + dt * 8 + gid];
        const uint32_t b0 = uint32_t(vr[0]) | (uint32_t(vr[LD]) << 16);
        const uint32_t b1 = uint32_t(vr[8 * LD]) | (uint32_t(vr[9 * LD]) << 16);
        mma_16816(acc[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gid + 8 * r;
    if (row >= S) continue;
    if (STATS && tig == 0) {  // m and l are the same on the 4 lanes of a quad
      const long long idx = (static_cast<long long>(b) * H + h) * S + row;
      m_out[idx] = m_run[r];
      l_out[idx] = l_run[r];
    }
    const float inv = l_run[r] == 0.f ? 1.f : 1.f / l_run[r];
    uint16_t* orow = o + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + tig * 2) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
  }
}

template <bool STATS>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* m, float* l,
               int B, int S, int T, int H, int Hkv, int D,
               long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_st, long long k_sh,
               long long v_sb, long long v_st, long long v_sh,
               float scale, int causal, void* stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  auto* op = static_cast<uint16_t*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    flash_fwd_kernel<128, STATS><<<grid, NTHREADS, 0, st>>>(
        qp, kp, vp, op, m, l, S, T, H, Hkv, q_sb, q_ss, q_sh, k_sb, k_st, k_sh,
        v_sb, v_st, v_sh, scale, causal);
  } else if (D == 64) {
    flash_fwd_kernel<64, STATS><<<grid, NTHREADS, 0, st>>>(
        qp, kp, vp, op, m, l, S, T, H, Hkv, q_sb, q_ss, q_sh, k_sb, k_st, k_sh,
        v_sb, v_st, v_sh, scale, causal);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1, the inference forward. Returns cudaGetLastError() after the launch.
extern "C" int teochat_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int S, int T, int H, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, int causal, void* stream) {
  return launch_fwd<false>(q, k, v, o, nullptr, nullptr, B, S, T, H, Hkv, D,
                           q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                           scale, causal, stream);
}

// K4a, the training forward: K1 plus m and l (fp32 [B, H, S], contiguous).
// Replaces teochat_tpu/ops/flash_attention.py::_flash_fwd_res_kernel, whose
// statistics are padded to 128 lanes for the TPU's tiling; here one float a row.
extern "C" int teochat_flash_attention_fwd_res(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    int B, int S, int T, int H, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, int causal, void* stream) {
  return launch_fwd<true>(q, k, v, o, static_cast<float*>(m), static_cast<float*>(l),
                          B, S, T, H, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_st, k_sh,
                          v_sb, v_st, v_sh, scale, causal, stream);
}
