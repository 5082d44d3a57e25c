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

// ---------------------------------------------------------------- K2m
//
// The multi-query form of this kernel: S queries a row against the cache,
// query (b, s) over the slots t < lengths[b, s]. It computes what the JAX
// package's cached path computes with XLA's masked attention when S > 1
// (teochat_tpu/models/llama.py:316-336, the mask `slot <= q_slot & kv_mask`
// with a kv_mask that is a prefix of each row; the wrapper turns both into
// `lengths`): a session's suffix prefill over its committed conversation.
// There is no Pallas kernel for it on the TPU.
//
// What bounds it: at the suffix's sizes each K and V row of the cache is
// used by every query of the suffix, so a block that holds many queries
// reads each row once for all of them. A block takes one (row, tile of
// queries, group of query heads sharing one kv head): MQ_PAIRS (query,
// head) pairs, MQ_PAIRS / G queries of G heads. It walks the row's slots
// in chunks of MQ_SLOTS up to the tile's largest length, with an online
// softmax in fp32: each chunk of K and V is loaded once into shared memory
// for the whole tile. Each warp holds MQ_WARP_PAIRS pairs: a lane scores
// one slot of the chunk against each of them (q in fp32 in shared memory,
// read as broadcasts; K rows padded by 16 bytes so a quarter warp's 16-byte
// reads fall in distinct banks), then owns D / 32 elements of each pair's
// accumulator for P V. No workspace and no tickets: the work of a pair
// never leaves its block. FMAs, not tensor cores: a simple kernel first.
// A query of length 0 is written as 0.

constexpr int MQ_SLOTS = 32;       // slots a chunk: one a lane
constexpr int MQ_WARP_PAIRS = 8;   // (query, head) pairs a warp
constexpr int MQ_PAIRS = NWARPS * MQ_WARP_PAIRS;  // pairs a block

template <int D, int G>
__global__ void __launch_bounds__(NTHREADS)
decode_multi_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const int* __restrict__ lengths,
                    uint16_t* __restrict__ o, int S, int T, int H, int Hkv,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_sh, long long k_st,
                    long long v_sb, long long v_sh, long long v_st, float scale) {
  constexpr int QT = MQ_PAIRS / G;  // queries a block
  constexpr int DE = D / 32;        // accumulator elements a lane
  constexpr int KP = D + 8;         // a K row in shared memory, padded
  static_assert(MQ_PAIRS % G == 0 && D % 64 == 0, "whole queries a block, D 64 or 128");
  __shared__ __align__(16) uint16_t sk[MQ_SLOTS][KP];
  __shared__ __align__(16) uint16_t sv[MQ_SLOTS][D];
  __shared__ __align__(16) float sq[MQ_PAIRS][D];
  __shared__ __align__(16) float sp[NWARPS][MQ_WARP_PAIRS][MQ_SLOTS];
  __shared__ int slen[MQ_PAIRS];
  __shared__ int smax;

  const int b = blockIdx.z, s0 = blockIdx.x * QT, hq0 = blockIdx.y * G;
  const int hk = hq0 / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the tile's queries in fp32 and their lengths (pair p: query p / G, head p % G)
  for (int idx = tid; idx < MQ_PAIRS * (D / 8); idx += NTHREADS) {
    const int p = idx / (D / 8), c = idx % (D / 8), s = s0 + p / G;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (s < S)
      unpack8(*reinterpret_cast<const uint4*>(q + b * q_sb + s * q_ss + (hq0 + p % G) * q_sh +
                                              c * 8), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sq[p][c * 8 + e] = f[e];
  }
  if (tid < MQ_PAIRS) {
    const int s = s0 + tid / G;
    slen[tid] = s < S ? min(max(lengths[static_cast<long long>(b) * S + s], 0), T) : 0;
  }
  __syncthreads();
  if (warp == 0) {
    int mx = slen[lane];  // MQ_PAIRS == 32
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) smax = mx;
  }
  __syncthreads();
  const int max_len = smax;

  float m[MQ_WARP_PAIRS], l[MQ_WARP_PAIRS], acc[MQ_WARP_PAIRS][DE];
  int len[MQ_WARP_PAIRS];
#pragma unroll
  for (int pr = 0; pr < MQ_WARP_PAIRS; ++pr) {
    m[pr] = -INFINITY;
    l[pr] = 0.f;
    len[pr] = slen[warp * MQ_WARP_PAIRS + pr];
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[pr][e] = 0.f;
  }

  const uint16_t* kb = k + b * k_sb + hk * k_sh;
  const uint16_t* vb = v + b * v_sb + hk * v_sh;
  for (int c0 = 0; c0 < max_len; c0 += MQ_SLOTS) {
    // the chunk's K and V, zeros past the tile's largest length
    for (int idx = tid; idx < MQ_SLOTS * (D / 8); idx += NTHREADS) {
      const int j = idx / (D / 8), c = idx % (D / 8), t = c0 + j;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (t < max_len) {
        kr = *reinterpret_cast<const uint4*>(kb + t * k_st + c * 8);
        vr = *reinterpret_cast<const uint4*>(vb + t * v_st + c * 8);
      }
      *reinterpret_cast<uint4*>(&sk[j][c * 8]) = kr;
      *reinterpret_cast<uint4*>(&sv[j][c * 8]) = vr;
    }
    __syncthreads();

    // scores: this lane's slot against each of the warp's pairs
    float sc[MQ_WARP_PAIRS];
#pragma unroll
    for (int pr = 0; pr < MQ_WARP_PAIRS; ++pr) sc[pr] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D / 8; ++c) {
      float kf[8];
      unpack8(*reinterpret_cast<const uint4*>(&sk[lane][c * 8]), kf);
#pragma unroll
      for (int pr = 0; pr < MQ_WARP_PAIRS; ++pr) {
        const float4 qa = *reinterpret_cast<const float4*>(&sq[warp * MQ_WARP_PAIRS + pr][c * 8]);
        const float4 qb = *reinterpret_cast<const float4*>(&sq[warp * MQ_WARP_PAIRS + pr][c * 8 + 4]);
        float d = sc[pr];
        d = fmaf(qa.x, kf[0], d);
        d = fmaf(qa.y, kf[1], d);
        d = fmaf(qa.z, kf[2], d);
        d = fmaf(qa.w, kf[3], d);
        d = fmaf(qb.x, kf[4], d);
        d = fmaf(qb.y, kf[5], d);
        d = fmaf(qb.z, kf[6], d);
        d = fmaf(qb.w, kf[7], d);
        sc[pr] = d;
      }
    }

    // the online softmax: each pair's maximum over the warp, this lane's p
    const int t = c0 + lane;
#pragma unroll
    for (int pr = 0; pr < MQ_WARP_PAIRS; ++pr) {
      const float s = t < len[pr] ? sc[pr] * scale : -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float m_new, alpha, unused;
      merge_factors(m[pr], mx, m_new, alpha, unused);  // alpha 0 while nothing is live
      const float p = s == -INFINITY ? 0.f : __expf(s - m_new);
      l[pr] = l[pr] * alpha + p;
#pragma unroll
      for (int e = 0; e < DE; ++e) acc[pr][e] *= alpha;
      m[pr] = m_new;
      sp[warp][pr][lane] = p;
    }
    __syncwarp();

    // P V: this lane's D / 32 elements of each pair's accumulator
#pragma unroll 2
    for (int j = 0; j < MQ_SLOTS; j += 4) {
      float vf[4][DE];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if constexpr (DE == 4) {
          const uint2 u = *reinterpret_cast<const uint2*>(&sv[j + jj][lane * 4]);
          vf[jj][0] = __uint_as_float(u.x << 16);
          vf[jj][1] = __uint_as_float(u.x & 0xffff0000u);
          vf[jj][2] = __uint_as_float(u.y << 16);
          vf[jj][3] = __uint_as_float(u.y & 0xffff0000u);
        } else {
          const uint32_t u = *reinterpret_cast<const uint32_t*>(&sv[j + jj][lane * 2]);
          vf[jj][0] = __uint_as_float(u << 16);
          vf[jj][1] = __uint_as_float(u & 0xffff0000u);
        }
      }
#pragma unroll
      for (int pr = 0; pr < MQ_WARP_PAIRS; ++pr) {
        const float4 p4 = *reinterpret_cast<const float4*>(&sp[warp][pr][j]);
#pragma unroll
        for (int e = 0; e < DE; ++e) {
          float a = acc[pr][e];
          a = fmaf(p4.x, vf[0][e], a);
          a = fmaf(p4.y, vf[1][e], a);
          a = fmaf(p4.z, vf[2][e], a);
          a = fmaf(p4.w, vf[3][e], a);
          acc[pr][e] = a;
        }
      }
    }
    __syncthreads();  // the next chunk overwrites sk, sv and sp
  }

  // each pair's sum over the warp, then o = acc / l (0 where no slot is live)
#pragma unroll
  for (int pr = 0; pr < MQ_WARP_PAIRS; ++pr) {
    float lsum = l[pr];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    const int p = warp * MQ_WARP_PAIRS + pr, s = s0 + p / G;
    if (s >= S) continue;
    uint16_t* op = o + ((static_cast<long long>(b) * S + s) * H + hq0 + p % G) * D + lane * DE;
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      const float out = lsum == 0.f ? 0.f : acc[pr][e] / lsum;
      const __nv_bfloat16 ob = __float2bfloat16_rn(out);
      op[e] = *reinterpret_cast<const uint16_t*>(&ob);
    }
  }
}

template <int D>
int launch_multi_d(int G, dim3 grid, cudaStream_t st, const uint16_t* q, const uint16_t* k,
                   const uint16_t* v, const int* lens, uint16_t* o, int S, int T, int H,
                   int Hkv, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                   long long k_sh, long long k_st, long long v_sb, long long v_sh,
                   long long v_st, float scale) {
#define TEOCHAT_MULTI_LAUNCH(GV)                                                              \
  decode_multi_kernel<D, GV><<<grid, NTHREADS, 0, st>>>(q, k, v, lens, o, S, T, H, Hkv, q_sb, \
                                                        q_ss, q_sh, k_sb, k_sh, k_st, v_sb,    \
                                                        v_sh, v_st, scale)
  switch (G) {
    case 1: TEOCHAT_MULTI_LAUNCH(1); break;
    case 2: TEOCHAT_MULTI_LAUNCH(2); break;
    case 4: TEOCHAT_MULTI_LAUNCH(4); break;
    case 8: TEOCHAT_MULTI_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TEOCHAT_MULTI_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2m. q: [B, S, H, D] (strides q_sb, q_ss, q_sh); k, v: [B, Hkv, T, D]
// views through strides; lengths: [B, S] int32, contiguous, on the device;
// o: contiguous [B, S, H, D]. Returns cudaGetLastError() after the launch.
extern "C" int teochat_decode_attention_multi(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    int B, int S, int H, int Hkv, int T, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv || T <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int group = H / Hkv;
  const int G = group > MAX_G ? MAX_G : group;  // heads a block
  if (group % G) return static_cast<int>(cudaErrorInvalidValue);
  const int qt = MQ_PAIRS / G;
  const dim3 grid((S + qt - 1) / qt, H / G, B);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<uint16_t*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_multi_d<128>(G, grid, st, qp, kp, vp, lp, op, S, T, H, Hkv, q_sb, q_ss, q_sh,
                               k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale);
  if (D == 64)
    return launch_multi_d<64>(G, grid, st, qp, kp, vp, lp, op, S, T, H, Hkv, q_sb, q_ss, q_sh,
                              k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
