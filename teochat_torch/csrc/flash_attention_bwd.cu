// Flash-attention backward for Hopper (sm_90a): K4b (dK, dV) and K4c (dQ).
//
// Replaces teochat_tpu/ops/flash_attention.py::_bwd_dkv_kernel and
// ::_bwd_dq_kernel (driven there by _flash_bwd under the custom_vjp
// flash_attention_trainable). Both recompute the probabilities from the
// forward's per-row statistics (K4a in flash_attention.cu) instead of storing
// them:
//   s  = (q k^T) * scale, causal mask -0.7 * FLT_MAX (not -inf)
//   p  = exp(s - m) * l_inv,  l_inv = 1 where l == 0
//   ds = p * (dp - di),  dp = dO v^T,  di = rowsum(o * dO) (computed before)
//   dV = sum p^T dO,  dK = sum ds^T q * scale,  dQ = sum ds k * scale
//
// What bounds them on an H100: at training lengths (S = 1024, D = 128) the
// four products per tile pair (two to rebuild p and dp, two to accumulate),
// i.e. tensor-core FLOPs; q, k, v and dO are re-read from L2 once per tile
// pair. Both kernels issue every product on mma.sync m16n8k16 (bf16 in, fp32
// accumulation), keep the gradient accumulators in registers for the whole
// loop, and turn p and ds into A operands in registers (mma_bf16.cuh). p and
// ds are rounded to bf16 before their products; the TPU kernels multiply them
// in fp32.
//
// K4b: one block of 4 warps per (kv tile of 64 keys, kv head, batch row); each
// warp owns 16 keys. The Pallas grid walks (group member, q tile) pairs in
// order so one VMEM scratch sums the GQA group's gradient; here that walk is
// the loop inside the block, over the q heads of the group and the q tiles at
// or below the diagonal. dK and dV stay in registers: no atomics, so the
// result does not depend on scheduling. The kv tile stays in shared memory;
// each step stages a 32-row q and dO tile and its m, 1/l and di.
//
// K4c: one block of 4 warps per (q tile of 64 rows, q head, batch row); each
// warp owns 16 rows, whose q and dO fragments stay in registers while the
// loop walks kv tiles of 32 keys up to the diagonal.
//
// Layout: q and dO are read as [B, S, H, D] and k, v as [B, T, Hkv, D]
// through their strides (last dimension contiguous, 16-byte aligned rows);
// m, l and di are fp32 [B, H, S]; dq, dk and dv are written contiguous in the
// inputs' shapes. Causal masking assumes S == T. Later work: wgmma + TMA,
// a pipelined tile ring, di folded into a preamble.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using namespace teochat;

constexpr int NTHREADS = 128;
constexpr int BKV = 64;   // K4b: keys per block (16 per warp)
constexpr int BQS = 32;   // K4b: q rows staged per step
constexpr int BQD = 64;   // K4c: q rows per block (16 per warp)
constexpr int BKS = 32;   // K4c: keys per kv step

struct Strides {
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
};

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * BKV + 2 * BQS) * (D + 8) * 2 + 3 * BQS * 4;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ di, uint16_t* __restrict__ dk,
                     uint16_t* __restrict__ dv, int S, int T, int H, int Hkv,
                     Strides st, float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ks = smem;               // [BKV][LD]
  uint16_t* vs = ks + BKV * LD;      // [BKV][LD]
  uint16_t* qs = vs + BKV * LD;      // [BQS][LD]
  uint16_t* dos = qs + BQS * LD;     // [BQS][LD]
  float* ms = reinterpret_cast<float*>(dos + BQS * LD);  // [BQS]
  float* linvs = ms + BQS;
  float* dis = linvs + BQS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * BKV;  // tile 0 has the most q tiles: it starts first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int wr = warp * 16;  // this warp's first key inside the tile

  load_tile<D>(ks, LD, k + b * st.k_sb + hk * st.k_sh, st.k_st, k0, BKV, T, tid, NTHREADS);
  load_tile<D>(vs, LD, v + b * st.v_sb + hk * st.v_sh, st.v_st, k0, BKV, T, tid, NTHREADS);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  }

  const int nq = (S + BQS - 1) / BQS;
  const int qt0 = causal ? k0 / BQS : 0;  // q tiles wholly above the diagonal are skipped
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const uint16_t* qb = q + b * st.q_sb + h * st.q_sh;
    const uint16_t* ob = dout + b * st.o_sb + h * st.o_sh;
    const long long row_base = (static_cast<long long>(b) * H + h) * S;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQS;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D>(qs, LD, qb, st.q_ss, q0, BQS, S, tid, NTHREADS);
      load_tile<D>(dos, LD, ob, st.o_ss, q0, BQS, S, tid, NTHREADS);
      for (int i = tid; i < BQS; i += NTHREADS) {
        // rows past S: q = dO = 0 and di = 0, so they add exactly nothing
        float mm = 0.f, ll = 1.f, dd = 0.f;
        if (q0 + i < S) {
          mm = m[row_base + q0 + i];
          ll = l[row_base + q0 + i];
          dd = di[row_base + q0 + i];
        }
        ms[i] = mm;
        linvs[i] = ll == 0.f ? 1.f : 1.f / ll;
        dis[i] = dd;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQS queries
      float pt[BQS / 8][4], dst[BQS / 8][4];
#pragma unroll
      for (int nt = 0; nt < BQS / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[nt][e] = dst[nt][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, ks, LD, wr, kk * 16, gid, tig);
        load_a(av, vs, LD, wr, kk * 16, gid, tig);
#pragma unroll
        for (int nt = 0; nt < BQS / 8; ++nt) {
          uint32_t b0, b1;
          load_b_rows(b0, b1, qs, LD, nt * 8, kk * 16, gid, tig);
          mma_16816(pt[nt], ak, b0, b1);
          load_b_rows(b0, b1, dos, LD, nt * 8, kk * 16, gid, tig);
          mma_16816(dst[nt], av, b0, b1);
        }
      }

      // p^T and ds^T, element by element
#pragma unroll
      for (int nt = 0; nt < BQS / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + wr + gid + (e >= 2 ? 8 : 0);
          const int qi = nt * 8 + tig * 2 + (e & 1);
          float s = pt[nt][e] * scale;
          if (key >= T || (causal && key > q0 + qi)) s = MASK_VALUE;
          const float p = __expf(s - ms[qi]) * linvs[qi];
          pt[nt][e] = p;
          dst[nt][e] = p * (dst[nt][e] - dis[qi]);
        }
      }

      // dV += P^T dO and dK += dS^T Q: the queries are the reduction axis
#pragma unroll
      for (int kk = 0; kk < BQS / 16; ++kk) {
        uint32_t ap[4], ads[4];
        c_to_a(ap, pt[2 * kk], pt[2 * kk + 1]);
        c_to_a(ads, dst[2 * kk], dst[2 * kk + 1]);
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          uint32_t b0, b1;
          load_b_cols(b0, b1, dos, LD, kk * 16, dt * 8, gid, tig);
          mma_16816(dv_acc[dt], ap, b0, b1);
          load_b_cols(b0, b1, qs, LD, kk * 16, dt * 8, gid, tig);
          mma_16816(dk_acc[dt], ads, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wr + gid + 8 * r;
    if (key >= T) continue;
    const long long off = ((static_cast<long long>(b) * T + key) * Hkv + hk) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int c = dt * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(dk + off + c) =
          pack_bf16(dk_acc[dt][2 * r] * scale, dk_acc[dt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + c) =
          pack_bf16(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ di, uint16_t* __restrict__ dq,
                    int S, int T, int H, int Hkv, Strides st, float scale, int causal) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) uint16_t ks[BKS * LD];
  __shared__ __align__(16) uint16_t vs[BKS * LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // causal tiles further down the sequence do the most work: start them first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row0 = qt * BQD + warp * 16;

  // q and dO fragments of this warp's 16 rows stay in registers
  uint32_t qf[D / 16][4], of[D / 16][4];
  {
    const uint16_t* qb = q + b * st.q_sb + h * st.q_sh;
    const uint16_t* ob = dout + b * st.o_sb + h * st.o_sh;
    const int r_lo = row0 + gid, r_hi = row0 + gid + 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
      qf[kk][0] = r_lo < S ? ld32(qb + r_lo * st.q_ss + c) : 0u;
      qf[kk][1] = r_hi < S ? ld32(qb + r_hi * st.q_ss + c) : 0u;
      qf[kk][2] = r_lo < S ? ld32(qb + r_lo * st.q_ss + c + 8) : 0u;
      qf[kk][3] = r_hi < S ? ld32(qb + r_hi * st.q_ss + c + 8) : 0u;
      of[kk][0] = r_lo < S ? ld32(ob + r_lo * st.o_ss + c) : 0u;
      of[kk][1] = r_hi < S ? ld32(ob + r_hi * st.o_ss + c) : 0u;
      of[kk][2] = r_lo < S ? ld32(ob + r_lo * st.o_ss + c + 8) : 0u;
      of[kk][3] = r_hi < S ? ld32(ob + r_hi * st.o_ss + c + 8) : 0u;
    }
  }
  // rows gid and gid + 8; rows past S take m = 0, 1/l = 1, di = 0 (dO is 0)
  float m_r[2], linv_r[2], di_r[2];
  const long long row_base = (static_cast<long long>(b) * H + h) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gid + 8 * r;
    m_r[r] = 0.f;
    linv_r[r] = 1.f;
    di_r[r] = 0.f;
    if (row < S) {
      const float ll = l[row_base + row];
      m_r[r] = m[row_base + row];
      linv_r[r] = ll == 0.f ? 1.f : 1.f / ll;
      di_r[r] = di[row_base + row];
    }
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    dq_acc[dt][0] = dq_acc[dt][1] = dq_acc[dt][2] = dq_acc[dt][3] = 0.f;

  int n_kv = (T + BKS - 1) / BKS;
  if (causal) n_kv = min(n_kv, (qt * BQD + BQD - 1) / BKS + 1);
  const uint16_t* kb = k + b * st.k_sb + hk * st.k_sh;
  const uint16_t* vb = v + b * st.v_sb + hk * st.v_sh;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BKS;
    __syncthreads();  // every warp is done with the previous kv tile
    load_tile<D>(ks, LD, kb, st.k_st, k0, BKS, T, tid, NTHREADS);
    load_tile<D>(vs, LD, vb, st.v_st, k0, BKS, T, tid, NTHREADS);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for 16 rows x BKS keys
    float s[BKS / 8][4], dp[BKS / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKS / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, ks, LD, nt * 8, kk * 16, gid, tig);
        mma_16816(s[nt], qf[kk], b0, b1);
        load_b_rows(b0, b1, vs, LD, nt * 8, kk * 16, gid, tig);
        mma_16816(dp[nt], of[kk], b0, b1);
      }
    }

    // ds = p * (dp - di), in place of s
#pragma unroll
    for (int nt = 0; nt < BKS / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = row0 + gid + 8 * r;
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        float x = s[nt][e] * scale;
        if (col >= T || (causal && col > row)) x = MASK_VALUE;
        const float p = __expf(x - m_r[r]) * linv_r[r];
        s[nt][e] = p * (dp[nt][e] - di_r[r]);
      }
    }

    // dQ += dS K: the keys are the reduction axis
#pragma unroll
    for (int kk = 0; kk < BKS / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, ks, LD, kk * 16, dt * 8, gid, tig);
        mma_16816(dq_acc[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gid + 8 * r;
    if (row >= S) continue;
    uint16_t* out = dq + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8 + tig * 2) =
          pack_bf16(dq_acc[dt][2 * r] * scale, dq_acc[dt][2 * r + 1] * scale);
  }
}

template <int D>
int launch_dkv(const uint16_t* q, const uint16_t* k, const uint16_t* v, const uint16_t* dout,
               const float* m, const float* l, const float* di, uint16_t* dk, uint16_t* dv,
               int B, int S, int T, int H, int Hkv, const Strides& st, float scale,
               int causal, cudaStream_t stream) {
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BKV - 1) / BKV, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      q, k, v, dout, m, l, di, dk, dv, S, T, H, Hkv, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const uint16_t* q, const uint16_t* k, const uint16_t* v, const uint16_t* dout,
              const float* m, const float* l, const float* di, uint16_t* dq,
              int B, int S, int T, int H, int Hkv, const Strides& st, float scale,
              int causal, cudaStream_t stream) {
  const dim3 grid((S + BQD - 1) / BQD, H, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, 0, stream>>>(
      q, k, v, dout, m, l, di, dq, S, T, H, Hkv, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The two backward entries take the same arguments: q, k, v, dO (bf16,
// strided), m, l, di (fp32 [B, H, S]), the outputs, sizes, strides, scale,
// causal and the stream. Each returns cudaGetLastError() after its launch.
#define TEOCHAT_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout, const void *m, \
      const void *l, const void *di, int B, int S, int T, int H, int Hkv,       \
      int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,    \
      long long k_st, long long k_sh, long long v_sb, long long v_st,           \
      long long v_sh, long long o_sb, long long o_ss, long long o_sh,           \
      float scale, int causal, void *stream

// K4b: dK and dV, contiguous [B, T, Hkv, D].
extern "C" int teochat_flash_attention_bwd_dkv(TEOCHAT_BWD_ARGS, void* dk, void* dv) {
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh};
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* op = static_cast<const uint16_t*>(dout);
  const auto* mp = static_cast<const float*>(m);
  const auto* lp = static_cast<const float*>(l);
  const auto* dp = static_cast<const float*>(di);
  auto* dkp = static_cast<uint16_t*>(dk);
  auto* dvp = static_cast<uint16_t*>(dv);
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dkv<128>(qp, kp, vp, op, mp, lp, dp, dkp, dvp, B, S, T, H, Hkv, st,
                           scale, causal, s);
  if (D == 64)
    return launch_dkv<64>(qp, kp, vp, op, mp, lp, dp, dkp, dvp, B, S, T, H, Hkv, st,
                          scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4c: dQ, contiguous [B, S, H, D].
extern "C" int teochat_flash_attention_bwd_dq(TEOCHAT_BWD_ARGS, void* dq) {
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh};
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* op = static_cast<const uint16_t*>(dout);
  const auto* mp = static_cast<const float*>(m);
  const auto* lp = static_cast<const float*>(l);
  const auto* dp = static_cast<const float*>(di);
  auto* dqp = static_cast<uint16_t*>(dq);
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dq<128>(qp, kp, vp, op, mp, lp, dp, dqp, B, S, T, H, Hkv, st, scale,
                          causal, s);
  if (D == 64)
    return launch_dq<64>(qp, kp, vp, op, mp, lp, dp, dqp, B, S, T, H, Hkv, st, scale,
                         causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
