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
//
// The cache is bf16 or fp8 e4m3 (the JAX package's kv_dtype
// "float8_e4m3fn", which halves its bytes; JAX upcasts the slab to the
// query's dtype before its masked attention, teochat_tpu/models/llama.py:309).
// Both kernels are templated on the cache's element type and read an e4m3
// slab in place, at half the bytes: each element becomes a float by
// cvt.rn.f16x2.e4m3x2 and cvt.f32.f16, both exact, so the products see the
// floats of `slab.to(bfloat16)` and an e4m3 launch gives the same bits as
// the bf16 kernel on the upcast slab.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper_async.cuh"
#include "mma_bf16.cuh"

// Slots a block; chip_probe.py builds this file with other values to time them.
#ifndef TEOCHAT_DECODE_CHUNK
#define TEOCHAT_DECODE_CHUNK 64
#endif

namespace {

constexpr int CHUNK = TEOCHAT_DECODE_CHUNK;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_G = 8;  // query heads a block: a group of 16 runs as two blocks of 8

// 8 bf16 (16 bytes) to floats
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Two e4m3 (the first in the low byte) to floats, exactly: e4m3 -> f16 -> f32.
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t pair) {
  uint32_t h2;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h2) : "h"(static_cast<uint16_t>(pair & 0xffffu)));
  float lo, hi;
  asm("cvt.f32.f16 %0, %1;\n" : "=f"(lo) : "h"(static_cast<uint16_t>(h2 & 0xffffu)));
  asm("cvt.f32.f16 %0, %1;\n" : "=f"(hi) : "h"(static_cast<uint16_t>(h2 >> 16)));
  return make_float2(lo, hi);
}

// 8 e4m3 (8 bytes) to floats
__device__ __forceinline__ void unpack8(const uint2& u, float (&f)[8]) {
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 a = e4m3x2_to_float2(w[i]), c = e4m3x2_to_float2(w[i] >> 16);
    f[4 * i] = a.x;
    f[4 * i + 1] = a.y;
    f[4 * i + 2] = c.x;
    f[4 * i + 3] = c.y;
  }
}

// Four e4m3 to four bf16 (two bf16x2 words), exactly: a float of at most
// four significant bits is its bf16's upper half.
__device__ __forceinline__ uint2 e4m3x4_to_bf16x4(uint32_t w) {
  const float2 a = e4m3x2_to_float2(w), c = e4m3x2_to_float2(w >> 16);
  return make_uint2((__float_as_uint(a.x) >> 16) | (__float_as_uint(a.y) & 0xffff0000u),
                    (__float_as_uint(c.x) >> 16) | (__float_as_uint(c.y) & 0xffff0000u));
}

// The cache's element: uint16_t (bf16) or uint8_t (e4m3); a lane's 8 of them
template <typename KV>
using Lane8 = std::conditional_t<sizeof(KV) == 2, uint4, uint2>;

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
// KV: the cache's element, uint16_t (bf16, a lane loads 16 bytes) or uint8_t
// (e4m3, 8 bytes); the lane layout and the arithmetic are the same.
template <int D, int G, typename KV>
__global__ void __launch_bounds__(NTHREADS)
decode_split_kernel(const uint16_t* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const int* __restrict__ lengths,
                    uint16_t* __restrict__ o, float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int* __restrict__ tickets,
                    int T, int H, int Hkv,
                    long long q_sb, long long q_sh,
                    long long k_sb, long long k_sh, long long k_st,
                    long long v_sb, long long v_sh, long long v_st, float scale) {
  constexpr int LPK = D / 8;                      // lanes a slot, 8 elements each
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
  using Lane = Lane8<KV>;
  Lane kr[NS], vr[NS];
  const KV* kb = k + b * k_sb + hk * k_sh + dl * 8;
  const KV* vb = v + b * v_sb + hk * v_sh + dl * 8;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int t = t0 + i * NWARPS * SPW;
    kr[i] = vr[i] = Lane{};
    if (t < len) {
      kr[i] = *reinterpret_cast<const Lane*>(kb + t * k_st);
      vr[i] = *reinterpret_cast<const Lane*>(vb + t * v_st);
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

template <int D, typename KV>
int launch_d(int G, dim3 grid, cudaStream_t st, const uint16_t* q, const KV* k,
             const KV* v, const int* lens, uint16_t* o, float* part_ml, float* part_acc,
             int* tickets, int T, int H, int Hkv, long long q_sb, long long q_sh,
             long long k_sb, long long k_sh, long long k_st, long long v_sb, long long v_sh,
             long long v_st, float scale) {
#define TEOCHAT_DECODE_LAUNCH(GV)                                                            \
  decode_split_kernel<D, GV, KV><<<grid, NTHREADS, 0, st>>>(                                 \
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
// `lengths`): a session's suffix prefill over its committed conversation,
// or a speculative verify block of S = k + 1 queries. There is no Pallas
// kernel for it on the TPU.
//
// What bounds it: at a verify block's few queries, the bytes of the cache
// (each K and V row is read for S * G (query, head) rows only); at a long
// suffix (S 512 and up), the products Q K^T and P V. What the design does:
// - rows are (query, head) pairs: the G query heads of one kv head times
//   the queries, so every K and V byte is shared across the group. A warp
//   owns 16 rows of an `mma.sync` m16n8k16 tile (bf16 in, fp32
//   accumulation); a block of four warps takes RW row groups of 16 rows,
//   and the 4 / RW warps of a row group each take their share of every
//   chunk's slots, so that a tile of 16 rows (S * G <= 16, a verify block)
//   keeps all four warps' tensor cores busy. The scores stay in registers:
//   the row maximum by quad shuffles, the scale folded into the exponent
//   (base 2), P packed to bf16 as the A operand of P V in place. A warp
//   that holds its rows whole writes o from its registers; the warps of a
//   shared row group merge through shared memory, four elements a thread;
// - each block walks its slots in chunks of MQ_CHUNK through a ring of
//   MQ_STAGES stages in shared memory filled by `cp.async` (16 bytes a
//   thread, rows padded by 16 bytes, so `ldmatrix` reads them without bank
//   conflicts): the next chunks' bytes are in flight while this chunk's
//   products run. Slots at or past the tile's longest length are never
//   read (zeros land in their place), and the per-slot mask is applied only
//   on chunks that reach past the tile's shortest length;
// - when the row tiles alone leave the card idle (few queries), the slots
//   are split across blocks as K2 splits them: the count comes from the
//   shapes (ops/decode_attention.py::multi_plan, from B, S, H, Hkv, T and
//   the SM count), never from `lengths`, which stay on the device. A block
//   whose slots start at or past its tile's longest length leaves at once;
//   each other block writes its (m, l, acc) partials to an fp32 workspace,
//   and the last of the tile's blocks to take a ticket merges them in split
//   order, in the same launch, and resets the ticket: one launch a call and
//   the same bits on every call. Where only the first split has a live slot,
//   its block writes o itself. Splits are taken only while the tiles are
//   fewer than the SMs (about one block an SM), so the workspace stays
//   below SMs tiles of partials whatever S and T are.
// A query of length 0 is written as 0.
// An e4m3 cache: the ring holds the chunks as they lie (16-byte pieces of 16
// elements, rows unpadded, half a bf16 stage's bytes); once a stage has
// landed the block converts it into one bf16 tile in the padded layout
// above, and the `ldmatrix` / `mma.sync` code runs on that tile unchanged.

constexpr int MQ_CHUNK = 64;   // cache slots a chunk of the ring
constexpr int MQ_STAGES = 3;   // chunks a block has in flight or in use
constexpr int MQ_WARPS = NWARPS;  // RW row groups of 16 rows x MQ_WARPS / RW slot shares
constexpr int MQ_MAX_SPLITS = 16;  // slot splits a tile, at most
constexpr int MQ_MAX_DEVICES = 64;  // devices whose shared-memory attribute is tracked

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global `src` to shared `dst`; only `src_bytes` (16 or 0) are
// read, the rest of the 16 written as zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and register i holds its fragment (row lane / 4,
// columns 2 (lane % 4), +1; `_t`: transposed, rows 2 (lane % 4), +1 of
// column lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// bf16: the ring, K then V a stage, rows padded. e4m3: the ring, rows as
// they lie, then the one bf16 tile (K then V, rows padded) converted from it
template <int D, typename KV>
__host__ __device__ constexpr int multi_smem_bytes() {
  return sizeof(KV) == 2 ? MQ_STAGES * 2 * MQ_CHUNK * (D + 8) * 2
                         : MQ_STAGES * 2 * MQ_CHUNK * D + 2 * MQ_CHUNK * (D + 8) * 2;
}

// Row r of a kv head's rows is query r / group, head hk * group + r % group.
// part_ml [tiles, splits, ROWS, 2] (m, l) and part_acc [tiles, splits, ROWS,
// D], tickets [tiles]: used only where two or more of a tile's splits have a
// live slot. A tile is (b, hk, tile of
// ROWS rows), numbered (b * Hkv + hk) * row_tiles + tile.
template <int D, int RW, typename KV>
__global__ void __launch_bounds__(NTHREADS)
decode_multi_kernel(const uint16_t* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const int* __restrict__ lengths,
                    uint16_t* __restrict__ o, float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int* __restrict__ tickets,
                    int S, int T, int H, int Hkv, int splits, int split_chunks,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_sh, long long k_st,
                    long long v_sb, long long v_sh, long long v_st, float scale_log2) {
  using namespace teochat;
  constexpr int SW = MQ_WARPS / RW;    // warps that share a row group
  constexpr int ROWS = 16 * RW;        // (query, head) rows a block
  constexpr int NS = MQ_CHUNK / SW;    // slots a warp takes of each chunk
  constexpr int NT = NS / 8;           // n-tiles of Q K^T
  constexpr int LD = D + 8;            // a bf16 K or V row the products read, padded
  constexpr int RD = D + 8;            // a row of fp32 partials in the epilogue
  constexpr bool FP8 = sizeof(KV) == 1;
  constexpr int RL = FP8 ? D : LD;     // a row of the ring, elements: e4m3 rows unpadded
  constexpr int RSTAGE = 2 * MQ_CHUNK * RL * sizeof(KV);  // bytes of a ring stage: K, then V
  static_assert(NS % 16 == 0 && D % 64 == 0, "whole k-steps of P V; D 64 or 128");
  static_assert(SW * ROWS * RD * 4 <= multi_smem_bytes<D, KV>(), "the epilogue fits in the ring");
  extern __shared__ __align__(16) uint16_t ring[];
  __shared__ float red_m[SW * ROWS], red_l[SW * ROWS];
  __shared__ float s_f[MQ_MAX_SPLITS][ROWS], s_l[ROWS];  // the split merge's factors and sums
  __shared__ int s_max, s_min, s_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, mi = lane >> 3;
  const int wr = warp / SW, ws = warp % SW;  // the warp's row group and slot share
  const int row_tiles = gridDim.x / splits;
  const int split = blockIdx.x / row_tiles, tile = blockIdx.x % row_tiles;  // split-major
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv, n_rows = S * group, r0 = tile * ROWS;
  const long long tile_id = (static_cast<long long>(b) * Hkv + hk) * row_tiles + tile;
  const int* blen = lengths + static_cast<long long>(b) * S;

  // the tile's longest and shortest length
  if (tid == 0) {
    s_max = 0;
    s_min = T;
  }
  __syncthreads();
  if (tid < ROWS && r0 + tid < n_rows) {
    const int len = min(max(blen[(r0 + tid) / group], 0), T);
    atomicMax(&s_max, len);
    atomicMin(&s_min, len);
  }
  __syncthreads();
  const int max_len = s_max, min_len = s_min;
  const int split_slots = split_chunks * MQ_CHUNK;
  // splits with a slot below the longest length; split 0 takes part even at
  // length 0, so that the tile is written (as 0)
  const int n_live = max((max_len + split_slots - 1) / split_slots, 1);
  if (split >= n_live) return;
  const int c_begin = split * split_chunks;
  const int n = min(split_chunks, (max_len + MQ_CHUNK - 1) / MQ_CHUNK - c_begin);

  // this thread's rows (gid and gid + 8 of the warp's 16): lengths, q fragments
  int len[2];
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + wr * 16 + gid + 8 * i;
    const bool ok = r < n_rows;
    len[i] = ok ? min(max(blen[r / group], 0), T) : 0;
    const uint16_t* qr = q + b * q_sb + (r / group) * q_ss + (hk * group + r % group) * q_sh;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][i] = ok ? ld32(qr + kk * 16 + 2 * tig) : 0u;
      qa[kk][2 + i] = ok ? ld32(qr + kk * 16 + 8 + 2 * tig) : 0u;
    }
  }

  // this thread's share of every chunk: 16-byte piece c16 of slots j0, j0 + PASS_ROWS, ...
  constexpr int EPP = 16 / sizeof(KV);          // elements a 16-byte piece
  constexpr int PASS_ROWS = NTHREADS / (D / EPP);  // slots the block copies a pass
  const int j0 = tid / (D / EPP), c16 = tid % (D / EPP);
  const KV* kb = k + b * k_sb + hk * k_sh + c16 * EPP;
  const KV* vb = v + b * v_sb + hk * v_sh + c16 * EPP;
  const uint32_t ring_u32 = smem_u32(ring), s_off = j0 * RL * sizeof(KV) + c16 * 16;
  auto load_chunk = [&](int c, int stage) {  // slots past the longest length as zeros
    const uint32_t sk = ring_u32 + stage * RSTAGE + s_off, sv = sk + RSTAGE / 2;
    const int t0 = c * MQ_CHUNK + j0;
    const KV* kc = kb + t0 * k_st;
    const KV* vc = vb + t0 * v_st;
#pragma unroll
    for (int pass = 0; pass < MQ_CHUNK / PASS_ROWS; ++pass) {
      const bool live = t0 + pass * PASS_ROWS < max_len;
      const uint32_t off = pass * PASS_ROWS * RL * sizeof(KV);
      cp_async16(sk + off, live ? kc + pass * PASS_ROWS * k_st : kb, live ? 16u : 0u);
      cp_async16(sv + off, live ? vc + pass * PASS_ROWS * v_st : vb, live ? 16u : 0u);
    }
  };

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

#pragma unroll
  for (int i = 0; i < MQ_STAGES - 1; ++i) {
    if (i < n) load_chunk(c_begin + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<MQ_STAGES - 2>();  // chunk i has landed (this thread's part of it) ...
    __syncthreads();                 // ... everyone's, and chunk i - 1's stage is free
    if (i + MQ_STAGES - 1 < n) load_chunk(c_begin + i + MQ_STAGES - 1, (i + MQ_STAGES - 1) % MQ_STAGES);
    cp_async_commit();
    const int c = c_begin + i;
    uint32_t tile = ring_u32 + (i % MQ_STAGES) * RSTAGE;  // K then V, bf16 rows of LD
    if constexpr (FP8) {  // the stage into the bf16 tile after the ring; its last
                          // readers, chunk i - 1's products, have passed the barrier
      const uint8_t* src = reinterpret_cast<const uint8_t*>(ring) + (i % MQ_STAGES) * RSTAGE;
      uint16_t* dst = reinterpret_cast<uint16_t*>(reinterpret_cast<uint8_t*>(ring) + MQ_STAGES * RSTAGE);
      for (int it = tid; it < 2 * MQ_CHUNK * (D / 16); it += NTHREADS) {
        const int row = it / (D / 16), col = (it % (D / 16)) * 16;  // 16 elements an item
        const uint4 u = *reinterpret_cast<const uint4*>(src + row * D + col);
        const uint2 a = e4m3x4_to_bf16x4(u.x), b2 = e4m3x4_to_bf16x4(u.y);
        const uint2 c2 = e4m3x4_to_bf16x4(u.z), d2 = e4m3x4_to_bf16x4(u.w);
        *reinterpret_cast<uint4*>(dst + row * LD + col) = make_uint4(a.x, a.y, b2.x, b2.y);
        *reinterpret_cast<uint4*>(dst + row * LD + col + 8) = make_uint4(c2.x, c2.y, d2.x, d2.y);
      }
      __syncthreads();
      tile = ring_u32 + MQ_STAGES * RSTAGE;
    }
    const uint32_t sk = tile + ws * NS * LD * 2;  // this warp's slots
    const uint32_t sv = sk + MQ_CHUNK * LD * 2;

    // S = Q K^T: two n-tiles of 8 slots a `ldmatrix` x4
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bk[4];  // matrix mi: slots nt * 8 + (mi / 2) * 8 + ..., columns kk * 16 + (mi % 2) * 8
        ldsm_x4(bk, sk + ((nt * 8 + (mi >> 1) * 8 + (lane & 7)) * LD + kk * 16 + (mi & 1) * 8) * 2);
        mma_16816(sc[nt], qa[kk], bk[0], bk[1]);
        mma_16816(sc[nt + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // the online softmax in base 2, the mask only where a length ends in the chunk
    const int t0 = c * MQ_CHUNK + ws * NS;
    const bool masked = c * MQ_CHUNK + MQ_CHUNK > min_len;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * scale_log2;
        if (masked && t0 + nt * 8 + 2 * tig + (e & 1) >= len[e >> 1]) x = -INFINITY;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
      const float m_new = fmaxf(m[i2], mx[i2]);
      alpha[i2] = m_new == -INFINITY ? 1.f : ex2(m[i2] - m_new);  // 0 while nothing was live
      mu[i2] = m_new == -INFINITY ? 0.f : m_new;
      m[i2] = m_new;
      l[i2] *= alpha[i2];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(sc[nt][e] - mu[e >> 1]);
        sc[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // acc += P V: P from the score registers, V by `ldmatrix` x4 transposed
#pragma unroll
    for (int ks = 0; ks < NS / 16; ++ks) {
      uint32_t pa[4];
      c_to_a(pa, sc[2 * ks], sc[2 * ks + 1]);
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t bv[4];  // matrix mi: slots ks * 16 + (mi % 2) * 8 + ..., columns nd * 8 + (mi / 2) * 8
        ldsm_x4_t(bv, sv + ((ks * 16 + (mi & 1) * 8 + (lane & 7)) * LD + nd * 8 + (mi >> 1) * 8) * 2);
        mma_16816(acc[nd], pa, bv[0], bv[1]);
        mma_16816(acc[nd + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (SW == 1 && n_live == 1) {  // a warp has its rows whole: o from the registers
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + wr * 16 + gid + 8 * i;
      if (r >= n_rows) continue;
      uint16_t* orow =
          o + ((static_cast<long long>(b) * S + r / group) * H + hk * group + r % group) * D;
      const bool none = l[i] == 0.f;  // a row without a live slot is 0
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * tig) =
            pack_bf16(none ? 0.f : acc[nd][2 * i] / l[i], none ? 0.f : acc[nd][2 * i + 1] / l[i]);
    }
    return;
  }

  // the warps of a row group merged in order, through the ring's memory
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = ws * ROWS + wr * 16 + gid + 8 * i;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(red + row * RD + nd * 8 + 2 * tig) =
          make_float2(acc[nd][2 * i], acc[nd][2 * i + 1]);
    if (tig == 0) {
      red_m[row] = m[i];
      red_l[row] = l[i];
    }
  }
  __syncthreads();

  // o, or this split's partials, four elements of a row an item
  const int live_rows = min(ROWS, n_rows - r0);
  auto write_o4 = [&](int row, int d, const float4& a, float lsum) {
    const int r = r0 + row;
    const bool none = lsum == 0.f;  // a row without a live slot is 0
    const uint2 ob = make_uint2(pack_bf16(none ? 0.f : a.x / lsum, none ? 0.f : a.y / lsum),
                                pack_bf16(none ? 0.f : a.z / lsum, none ? 0.f : a.w / lsum));
    *reinterpret_cast<uint2*>(
        o + ((static_cast<long long>(b) * S + r / group) * H + hk * group + r % group) * D + d) = ob;
  };
  for (int it = tid; it < live_rows * (D / 4); it += NTHREADS) {
    const int row = it / (D / 4), d = (it % (D / 4)) * 4;
    float mxw = -INFINITY;
#pragma unroll
    for (int w = 0; w < SW; ++w) mxw = fmaxf(mxw, red_m[w * ROWS + row]);
    float lsum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mxw != -INFINITY) {
#pragma unroll
      for (int w = 0; w < SW; ++w) {
        const float f = ex2(red_m[w * ROWS + row] - mxw);
        const float4 x = *reinterpret_cast<const float4*>(red + (w * ROWS + row) * RD + d);
        lsum += red_l[w * ROWS + row] * f;
        a.x += x.x * f;
        a.y += x.y * f;
        a.z += x.z * f;
        a.w += x.w * f;
      }
    }
    if (n_live == 1) {  // the tile's only live split: o directly
      write_o4(row, d, a, lsum);
    } else {
      const long long pr = (tile_id * splits + split) * ROWS + row;
      *reinterpret_cast<float4*>(part_acc + pr * D + d) = a;
      if (d == 0) {
        part_ml[2 * pr] = mxw;
        part_ml[2 * pr + 1] = lsum;
      }
    }
  }
  if (n_live == 1) return;

  // the last of the tile's live splits to get here merges them all, in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int taken = atomicAdd(tickets + tile_id, 1);
    s_last = taken == n_live - 1;
    if (s_last) tickets[tile_id] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long p0 = tile_id * splits * ROWS;
  if (tid < live_rows) {  // each row's factors, once
    float ms[MQ_MAX_SPLITS], mxs = -INFINITY;
#pragma unroll
    for (int j = 0; j < MQ_MAX_SPLITS; ++j) {
      ms[j] = j < n_live ? __ldcg(part_ml + 2 * (p0 + j * ROWS + tid)) : -INFINITY;
      mxs = fmaxf(mxs, ms[j]);
    }
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < MQ_MAX_SPLITS; ++j) {
      const float f = mxs == -INFINITY ? 0.f : ex2(ms[j] - mxs);
      if (j < n_live) lsum += __ldcg(part_ml + 2 * (p0 + j * ROWS + tid) + 1) * f;
      s_f[j][tid] = f;
    }
    s_l[tid] = lsum;
  }
  __syncthreads();
  for (int it = tid; it < live_rows * (D / 4); it += NTHREADS) {
    const int row = it / (D / 4), d = (it % (D / 4)) * 4;
    float4 part[MQ_MAX_SPLITS];  // every split's load in flight at once, then summed in order
#pragma unroll
    for (int j = 0; j < MQ_MAX_SPLITS; ++j)
      part[j] = j < n_live ? __ldcg(reinterpret_cast<const float4*>(
                                 part_acc + (p0 + j * ROWS + row) * D + d))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < MQ_MAX_SPLITS; ++j) {
      const float f = s_f[j][row];
      a.x += part[j].x * f;
      a.y += part[j].y * f;
      a.z += part[j].z * f;
      a.w += part[j].w * f;
    }
    write_o4(row, d, a, s_l[row]);
  }
}

template <int D, int RW, typename KV>
int launch_multi(dim3 grid, cudaStream_t st, const uint16_t* q, const KV* k,
                 const KV* v, const int* lens, uint16_t* o, float* part_ml,
                 float* part_acc, int* tickets, int S, int T, int H, int Hkv, int splits,
                 int split_chunks, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_sh, long long k_st, long long v_sb, long long v_sh,
                 long long v_st, float scale_log2) {
  // above 48 KB shared memory is dynamic and has to be asked for: once a
  // device, since the attribute belongs to the device the launch goes to
  static bool smem_set[MQ_MAX_DEVICES] = {};
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return static_cast<int>(derr);
  if (dev < 0 || dev >= MQ_MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(decode_multi_kernel<D, RW, KV>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 multi_smem_bytes<D, KV>());
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  decode_multi_kernel<D, RW, KV><<<grid, NTHREADS, multi_smem_bytes<D, KV>(), st>>>(
      q, k, v, lens, o, part_ml, part_acc, tickets, S, T, H, Hkv, splits, split_chunks, q_sb,
      q_ss, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename KV>
int launch_multi_d(int row_warps, dim3 grid, cudaStream_t st, const uint16_t* q,
                   const KV* k, const KV* v, const int* lens, uint16_t* o,
                   float* part_ml, float* part_acc, int* tickets, int S, int T, int H, int Hkv,
                   int splits, int split_chunks, long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_sh, long long k_st, long long v_sb,
                   long long v_sh, long long v_st, float scale_log2) {
#define TEOCHAT_MULTI_LAUNCH(RWV)                                                              \
  return launch_multi<D, RWV, KV>(grid, st, q, k, v, lens, o, part_ml, part_acc, tickets, S, \
                                  T, H, Hkv, splits, split_chunks, q_sb, q_ss, q_sh, k_sb,   \
                                  k_sh, k_st, v_sb, v_sh, v_st, scale_log2)
  switch (row_warps) {
    case 1: TEOCHAT_MULTI_LAUNCH(1);
    case 2: TEOCHAT_MULTI_LAUNCH(2);
    case 4: TEOCHAT_MULTI_LAUNCH(4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TEOCHAT_MULTI_LAUNCH
}

// K2m's launch for a cache of element KV (the C entries below).
template <typename KV>
int multi_entry(const void* q, const void* k, const void* v, const void* lengths, void* o,
                void* part_ml, void* part_acc, void* tickets,
                int B, int S, int H, int Hkv, int T, int D, int row_warps, int splits,
                int split_chunks, long long q_sb, long long q_ss, long long q_sh,
                long long k_sb, long long k_sh, long long k_st,
                long long v_sb, long long v_sh, long long v_st, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv || T <= 0 || S <= 0 || B <= 0 ||
      (row_warps != 1 && row_warps != 2 && row_warps != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (T + MQ_CHUNK - 1) / MQ_CHUNK;
  // the splits cover every chunk, and each split has one
  if (splits < 1 || splits > MQ_MAX_SPLITS || split_chunks < 1 ||
      static_cast<long long>(splits) * split_chunks < n_chunks ||
      (splits - 1) * split_chunks >= n_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1 && (part_ml == nullptr || part_acc == nullptr || tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(S) * (H / Hkv), tile_rows = 16LL * row_warps;
  const long long blocks_x = (rows + tile_rows - 1) / tile_rows * splits;
  if (blocks_x > 0x7fffffffLL || Hkv > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_x), Hkv, B);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const KV*>(k);
  const auto* vp = static_cast<const KV*>(v);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<uint16_t*>(o);
  auto* ml = static_cast<float*>(part_ml);
  auto* pa = static_cast<float*>(part_acc);
  auto* tk = static_cast<int*>(tickets);
  auto st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  if (D == 128)
    return launch_multi_d<128, KV>(row_warps, grid, st, qp, kp, vp, lp, op, ml, pa, tk, S, T,
                                   H, Hkv, splits, split_chunks, q_sb, q_ss, q_sh, k_sb, k_sh,
                                   k_st, v_sb, v_sh, v_st, scale_log2);
  if (D == 64)
    return launch_multi_d<64, KV>(row_warps, grid, st, qp, kp, vp, lp, op, ml, pa, tk, S, T, H,
                                  Hkv, splits, split_chunks, q_sb, q_ss, q_sh, k_sb, k_sh,
                                  k_st, v_sb, v_sh, v_st, scale_log2);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2's launch for a cache of element KV (the C entries below).
template <typename KV>
int decode_entry(const void* q, const void* k, const void* v, const void* lengths, void* o,
                 void* part_ml, void* part_acc, void* tickets, int B, int H, int Hkv, int T,
                 int D, long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                 long long k_st, long long v_sb, long long v_sh, long long v_st, float scale,
                 void* stream) {
  if (Hkv <= 0 || H % Hkv || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int group = H / Hkv;
  const int G = group > MAX_G ? MAX_G : group;  // heads a block
  if (group % G) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + CHUNK - 1) / CHUNK, H / G, B);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const KV*>(k);
  const auto* vp = static_cast<const KV*>(v);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<uint16_t*>(o);
  auto* ml = static_cast<float*>(part_ml);
  auto* pa = static_cast<float*>(part_acc);
  auto* tk = static_cast<int*>(tickets);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_d<128, KV>(G, grid, st, qp, kp, vp, lp, op, ml, pa, tk, T, H, Hkv, q_sb, q_sh,
                             k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale);
  if (D == 64)
    return launch_d<64, KV>(G, grid, st, qp, kp, vp, lp, op, ml, pa, tk, T, H, Hkv, q_sb, q_sh,
                            k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K2m. q: [B, S, H, D] bf16 (strides q_sb, q_ss, q_sh); k, v: [B, Hkv, T, D]
// views through strides, bf16 (`_e4m3`: e4m3); lengths: [B, S] int32,
// contiguous, on the device;
// o: contiguous [B, S, H, D]. A block takes 16 * row_warps (query, head)
// rows of one kv head and split_chunks chunks of MQ_CHUNK slots (split s:
// chunks s * split_chunks ...); the grid is (splits * row tiles, Hkv, B),
// split-major, so that the first split's blocks, which hold the most live
// slots, spread over the SMs; row tiles = ceil(S * H / Hkv / (16 *
// row_warps)). Where splits > 1:
// part_ml fp32 [B * Hkv * row tiles, splits, 16 * row_warps, 2], part_acc
// fp32 [..., D], contents ignored; tickets int32 [B * Hkv * row tiles],
// zero, and zero again when the launch has run (unread where splits is 1).
// Returns cudaGetLastError() after the launch.
extern "C" int teochat_decode_attention_multi(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* part_ml, void* part_acc, void* tickets,
    int B, int S, int H, int Hkv, int T, int D, int row_warps, int splits, int split_chunks,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    float scale, void* stream) {
  return multi_entry<uint16_t>(q, k, v, lengths, o, part_ml, part_acc, tickets, B, S, H, Hkv,
                               T, D, row_warps, splits, split_chunks, q_sb, q_ss, q_sh, k_sb,
                               k_sh, k_st, v_sb, v_sh, v_st, scale, stream);
}

extern "C" int teochat_decode_attention_multi_e4m3(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* part_ml, void* part_acc, void* tickets,
    int B, int S, int H, int Hkv, int T, int D, int row_warps, int splits, int split_chunks,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    float scale, void* stream) {
  return multi_entry<uint8_t>(q, k, v, lengths, o, part_ml, part_acc, tickets, B, S, H, Hkv,
                              T, D, row_warps, splits, split_chunks, q_sb, q_ss, q_sh, k_sb,
                              k_sh, k_st, v_sb, v_sh, v_st, scale, stream);
}

// K2. q: [B, H, D] bf16 (strides q_sb, q_sh); k, v: [B, Hkv, T, D] views
// through strides, bf16 (`_e4m3`: e4m3); lengths: [B] int32 on the device;
// o: contiguous [B, H, D];
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
  return decode_entry<uint16_t>(q, k, v, lengths, o, part_ml, part_acc, tickets, B, H, Hkv, T,
                                D, q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale,
                                stream);
}

extern "C" int teochat_decode_attention_e4m3(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* part_ml, void* part_acc, void* tickets,
    int B, int H, int Hkv, int T, int D,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    float scale, void* stream) {
  return decode_entry<uint8_t>(q, k, v, lengths, o, part_ml, part_acc, tickets, B, H, Hkv, T,
                               D, q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale,
                               stream);
}
