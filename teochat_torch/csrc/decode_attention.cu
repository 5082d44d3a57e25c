// Decode attention for Hopper (sm_90a): one query per row against the KV
// cache, bf16 in and out, the cache split across blocks (flash-decoding).
//
// Replaces teochat_tpu/ops/decode_attention.py::_decode_kernel (driven there
// by _decode_pallas / decode_attention). It computes what that kernel
// computes: for each row b and query head h, softmax(q . k[t] * scale) over
// the live slots t < lengths[b], applied to v, with fp32 statistics; the
// G = H / Hkv query heads of a group share the kv head's reads. Slots past a
// row's length are never read; a row with no live slot is written as 0.
//
// What bounds it on an H100: the bytes of the cache. Each live slot costs
// 2 * D * 2 bytes of K and V a kv head and is used by only G query heads,
// about G / 2 operations a byte, far below the card's ridge: no tensor
// cores. What the design does about it:
// - the slots are split into chunks of CHUNK, one block a (chunk, group of
//   query heads, row): at batch 1 with 32 kv heads and 580 live slots that
//   is 320 blocks with work on 132 SMs, where one block a (kv head, row)
//   kept 32 SMs busy. The grid is sized from T, never from `lengths`, which
//   stays on the device (a decode step captured in a CUDA graph reads no
//   length on the host): a block whose chunk starts at or past its row's
//   length leaves at once;
// - a block issues every 16-byte load of its chunk's K and V (D / 8 lanes a
//   slot, all slots of the chunk at once) before its first dot product, so
//   the chunk's bytes are in flight together rather than one memory latency
//   a slot;
// - each block writes its partial (row maximum m, sum l and unnormalized
//   accumulator, fp32) to a workspace, then takes a ticket; the last block
//   of a (row, head group) to arrive merges the partials in chunk order,
//   writes o and resets the ticket for the next call. One launch a layer,
//   and the same output on every run whatever order the blocks ran in.
// The cache is the layer slab of the [L, B, T, Hkv, D] buffer, read in place
// through its strides. The workspace has a fixed size for (B, H, T) and the
// tickets stay zero between calls, so a graph can capture the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

// Slots a block; chip_probe.py builds this file with other values to time them.
#ifndef TEOCHAT_DECODE_CHUNK
#define TEOCHAT_DECODE_CHUNK 64
#endif

namespace {

constexpr int CHUNK = TEOCHAT_DECODE_CHUNK;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_G = 8;  // query heads a block: a group of 16 runs as two blocks of 8

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Two softmax states (m, l, acc) as one: each scaled to the larger maximum.
// `ca`, `cb` are the factors; both 0 where neither state saw a live slot.
__device__ __forceinline__ void merge_factors(float m_a, float m_b, float& m, float& ca,
                                              float& cb) {
  m = fmaxf(m_a, m_b);
  ca = m == -INFINITY ? 0.f : __expf(m_a - m);
  cb = m == -INFINITY ? 0.f : __expf(m_b - m);
}

// part_ml [B, H, n_chunks, 2] (m, l) and part_acc [B, H, n_chunks, D]: each
// chunk's partial; tickets [B, H / G]: zero before and after every launch.
template <int D, int G>
__global__ void __launch_bounds__(NTHREADS)
decode_split_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const int* __restrict__ lengths,
                    uint16_t* __restrict__ o, float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int* __restrict__ tickets,
                    int T, int H, int Hkv,
                    long long q_sb, long long q_sh,
                    long long k_sb, long long k_sh, long long k_st,
                    long long v_sb, long long v_sh, long long v_st, float scale) {
  constexpr int LPK = D / 8;                      // lanes a slot, 16 bytes each
  constexpr int SPW = 32 / LPK;                   // slots a warp at a time
  constexpr int NS = CHUNK / (NWARPS * SPW);      // slots a thread
  static_assert(NS * NWARPS * SPW == CHUNK, "a chunk is whole waves of the block's slots");
  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];
  __shared__ float sm_acc[NWARPS][G][D];
  __shared__ int sm_last;

  const int chunk = blockIdx.x, n_chunks = gridDim.x, b = blockIdx.z;
  const int hq0 = blockIdx.y * G, hk = hq0 / (H / Hkv);
  const int len = min(max(lengths[b], 0), T);
  // chunks with a live slot; chunk 0 takes part even at length 0, so that
  // the row is written (as 0)
  const int n_live = max((len + CHUNK - 1) / CHUNK, 1);
  if (chunk >= n_live) return;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPK, dl = lane % LPK;
  const int t0 = chunk * CHUNK + warp * SPW + sub;  // this thread's slots: t0 + i NWARPS SPW

  // every load of the chunk first
  uint4 kr[NS], vr[NS];
  const uint16_t* kb = k + b * k_sb + hk * k_sh + dl * 8;
  const uint16_t* vb = v + b * v_sb + hk * v_sh + dl * 8;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int t = t0 + i * NWARPS * SPW;
    kr[i] = vr[i] = make_uint4(0, 0, 0, 0);
    if (t < len) {
      kr[i] = *reinterpret_cast<const uint4*>(kb + t * k_st);
      vr[i] = *reinterpret_cast<const uint4*>(vb + t * v_st);
    }
  }

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float qf[8];
    unpack8(*reinterpret_cast<const uint4*>(q + b * q_sb + (hq0 + g) * q_sh + dl * 8), qf);
    float s[NS];
    m[g] = -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float kf[8];
      unpack8(kr[i], kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(qf[e], kf[e], dot);
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const bool live = t0 + i * NWARPS * SPW < len;
      s[i] = live ? dot * scale : -INFINITY;
      m[g] = fmaxf(m[g], s[i]);
    }
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p = s[i] == -INFINITY ? 0.f : __expf(s[i] - m[g]);
      float vf[8];
      unpack8(vr[i], vf);
      l[g] += p;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
    }
  }

  // merge the slot groups of this warp (partners hold the same elements of D)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx, a, c;
      merge_factors(m[g], __shfl_xor_sync(0xffffffffu, m[g], off), mx, a, c);
      l[g] = l[g] * a + __shfl_xor_sync(0xffffffffu, l[g], off) * c;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * c;
      m[g] = mx;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e) sm_acc[warp][g][dl * 8 + e] = acc[g][e];
      if (dl == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // the block's partial: the warps merged in order
  for (int idx = threadIdx.x; idx < G * D; idx += NTHREADS) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float c = __expf(sm_m[w][g] - mx);
        lsum += sm_l[w][g] * c;
        a += sm_acc[w][g][d] * c;
      }
    }
    const long long row = (static_cast<long long>(b) * H + hq0 + g) * n_chunks + chunk;
    part_acc[row * D + d] = a;
    if (d == 0) {
      part_ml[2 * row] = mx;
      part_ml[2 * row + 1] = lsum;
    }
  }

  // the last of the row's live chunks to get here merges them all
  __threadfence();
  __syncthreads();
  int* ticket = tickets + b * (H / G) + blockIdx.y;
  if (threadIdx.x == 0) {
    const int taken = atomicAdd(ticket, 1);
    sm_last = taken == n_live - 1;
    if (sm_last) *ticket = 0;  // ready for the next call
  }
  __syncthreads();
  if (!sm_last) return;
  __threadfence();

  for (int idx = threadIdx.x; idx < G * D; idx += NTHREADS) {
    const int g = idx / D, d = idx % D;
    const long long row0 = (static_cast<long long>(b) * H + hq0 + g) * n_chunks;
    float mx = -INFINITY;
    for (int c = 0; c < n_live; ++c) mx = fmaxf(mx, __ldcg(part_ml + 2 * (row0 + c)));
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
      for (int c = 0; c < n_live; ++c) {
        const float f = __expf(__ldcg(part_ml + 2 * (row0 + c)) - mx);
        lsum += __ldcg(part_ml + 2 * (row0 + c) + 1) * f;
        a += __ldcg(part_acc + (row0 + c) * D + d) * f;
      }
    }
    const float out = lsum == 0.f ? 0.f : a / lsum;
    const __nv_bfloat16 ob = __float2bfloat16_rn(out);
    o[(static_cast<long long>(b) * H + hq0 + g) * D + d] = *reinterpret_cast<const uint16_t*>(&ob);
  }
}

template <int D>
int launch_d(int G, dim3 grid, cudaStream_t st, const uint16_t* q, const uint16_t* k,
             const uint16_t* v, const int* lens, uint16_t* o, float* part_ml, float* part_acc,
             int* tickets, int T, int H, int Hkv, long long q_sb, long long q_sh,
             long long k_sb, long long k_sh, long long k_st, long long v_sb, long long v_sh,
             long long v_st, float scale) {
#define TEOCHAT_DECODE_LAUNCH(GV)                                                            \
  decode_split_kernel<D, GV><<<grid, NTHREADS, 0, st>>>(                                     \
      q, k, v, lens, o, part_ml, part_acc, tickets, T, H, Hkv, q_sb, q_sh, k_sb, k_sh, k_st, \
      v_sb, v_sh, v_st, scale)
  switch (G) {
    case 1: TEOCHAT_DECODE_LAUNCH(1); break;
    case 2: TEOCHAT_DECODE_LAUNCH(2); break;
    case 4: TEOCHAT_DECODE_LAUNCH(4); break;
    case 8: TEOCHAT_DECODE_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TEOCHAT_DECODE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, H, D] (strides q_sb, q_sh); k, v: [B, Hkv, T, D] views through
// strides; lengths: [B] int32 on the device; o: contiguous [B, H, D];
// part_ml: fp32 [B, H, ceil(T / CHUNK), 2], part_acc: fp32 [B, H,
// ceil(T / CHUNK), D], contents ignored; tickets: int32 [B, H / min(H / Hkv,
// 8)], zero, and zero again when the launch has run. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int teochat_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* part_ml, void* part_acc, void* tickets,
    int B, int H, int Hkv, int T, int D,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int group = H / Hkv;
  const int G = group > MAX_G ? MAX_G : group;  // heads a block
  if (group % G) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + CHUNK - 1) / CHUNK, H / G, B);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<uint16_t*>(o);
  auto* ml = static_cast<float*>(part_ml);
  auto* pa = static_cast<float*>(part_acc);
  auto* tk = static_cast<int*>(tickets);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_d<128>(G, grid, st, qp, kp, vp, lp, op, ml, pa, tk, T, H, Hkv, q_sb, q_sh,
                         k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale);
  if (D == 64)
    return launch_d<64>(G, grid, st, qp, kp, vp, lp, op, ml, pa, tk, T, H, Hkv, q_sb, q_sh,
                        k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
