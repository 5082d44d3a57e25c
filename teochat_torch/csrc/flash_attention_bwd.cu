// Flash-attention backward for Hopper (sm_90a): di, K4b (dK, dV) and K4c (dQ).
//
// Replaces teochat_tpu/ops/flash_attention.py::_bwd_dkv_kernel and
// ::_bwd_dq_kernel (driven there by _flash_bwd under the custom_vjp
// flash_attention_trainable). Both recompute the probabilities from the
// forward's per-row statistics (K4a in flash_attention.cu) instead of storing
// them:
//   s  = (q k^T) * scale, masked scores -0.7 * FLT_MAX (not -inf)
//   p  = exp(s - m) * l_inv,  l_inv = 1 where l == 0
//   ds = p * (dp - di),  dp = dO v^T,  di = rowsum(o * dO)
//   dV = sum p^T dO,  dK = sum ds^T q * scale,  dQ = sum ds k * scale
// di is a reduction the JAX package computes outside its kernels; here a
// small preamble kernel computes it (8 or 16 lanes a row), so that no fp32
// copy of o and dO is ever made.
//
// What bounds K4b and K4c on an H100: at training lengths (S = 1024,
// D = 128) the four (K4b) or three (K4c) products a tile pair, that is
// tensor-core operations; the bytes of their inputs and outputs alone would
// take a fifth of that time or less. Only `wgmma` reaches the tensor cores'
// full rate, and it reads its B operand from shared memory. There is one
// exponential a score against four or three products, so the softmax part
// weighs a third of what it does in the forward. The design follows the
// forward's (hopper_async.cuh has the pieces):
// - one block an SM, which walks over many work items: two consumer
//   warpgroups and one producer warp; `setmaxnreg` hands the producer's
//   registers to the consumers, which keep every accumulator in registers;
// - the tiles a block owns stay resident in shared memory, the tiles it
//   walks arrive through a ring of stages, each one TMA load a 64-column box
//   written with the 128-byte swizzle, its arrival counted on the stage's
//   `full` mbarrier; a consumer warp arrives on the stage's `empty` barrier
//   after the last product that reads it. The next item's resident tiles
//   have barriers of their own, so they arrive while this item is written
//   out. TMA fills rows past the tensor's end with zeros: no load is guarded;
// - the two products that rebuild p and dp read both operands from shared
//   memory (K-major: the reduction runs along D); p and ds are made in the
//   score registers, rounded to bf16 (the TPU kernels multiply them in fp32)
//   and packed as the register A operand of the accumulating products, whose
//   B operand is a tile read MN-major (`tnspB`) as it was loaded: no
//   transposed copy, and no score ever visits shared memory;
// - a work item pairs a long causal tile with a short one, so that every
//   item costs the same and handing them out in turn balances the SMs;
// - the two consumer warpgroups run free: each starts the accumulating
//   products of one step and the score products of the next as one batch and
//   waits for it, and runs its exponentials while the other's batch has the
//   tensor cores. Taking turns as in the forward (a pair of named barriers)
//   only costs time here, with three or four products for one exponential a
//   score (K4c 0.147 ms against 0.125 on an H100 at B4 S1024 H32 D128), and
//   is not kept. Waiting for the score products alone, so that a
//   warpgroup's exponentials run under its own accumulating products, made
//   ptxas put a wait after every `wgmma` and spill: not kept either.
//
// K4c (dQ): a block owns DQ_BQ = 128 query rows of one head, 64 a
// warpgroup; Q and dO stay resident, K and V tiles of DQ_BK = 64 keys come
// through the ring up to the diagonal (tiles of 128 keys spill and are
// slower). S = Q K^T, dP = dO V^T, then dQ += dS K with the K tile read
// MN-major. Each thread keeps the softmax offset (m and l in one number, see
// `softmax_offset`) and the di of its two rows in registers.
//
// K4b (dK, dV): the transposed form, which needs no transpose of P: a block
// owns DKV_BK = 128 keys of one kv head, 64 a warpgroup; K and V stay
// resident, Q and dO tiles of DKV_BQ = 64 rows come through the ring, for
// each q head of the kv head's group in turn and each q tile at or below the
// diagonal. S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q
// with the dO and Q tiles read MN-major. dK and dV are 128 registers a
// thread, so a score tile takes DKV_SUB = 32 rows of the stage at a time
// (`wgmma` at N = 32: 16 + 16 registers): with 64-row score tiles ptxas
// spilled the packed operands and put a wait after every `wgmma`. The
// statistics are now one a column: the producer warp writes the tile's
// softmax offsets and di into the stage beside the TMA loads. The Pallas
// grid walks (group member, q tile) pairs in order so that one VMEM scratch
// sums the GQA group's gradient; here that walk is the loop inside the block
// and the sum stays in registers: no atomics, so the result does not depend
// on scheduling.
//
// Layout: q and dO are read as [B, S, H, D] and k, v as [B, T, Hkv, D]
// through their strides (the last dimension contiguous, the others multiples
// of 8 elements, the base aligned to 16 bytes: what a tensor map takes);
// m, l and di are fp32 [B, H, S]; dq, dk and dv are written contiguous in the
// inputs' shapes. Keys past T are masked; rows past S are computed on zeros
// and add exactly nothing. Causal masking assumes S == T.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper_async.cuh"
#include "mma_bf16.cuh"

// K4c's kv tile and the rings' depth; chip_probe.py builds this file with
// other values to time them.
#ifndef TEOCHAT_FLASH_BWD_DQ_BK
#define TEOCHAT_FLASH_BWD_DQ_BK 64
#endif
#ifndef TEOCHAT_FLASH_BWD_STAGES
#define TEOCHAT_FLASH_BWD_STAGES 3
#endif

namespace {

using namespace teochat;

constexpr int DKV_BK = 128;  // K4b: keys a block owns
constexpr int DKV_BQ = 64;   // K4b: query rows a ring stage
constexpr int DKV_SUB = 32;  // K4b: query rows a score tile (see the kernel's note)
constexpr int PARTS = DKV_BQ / DKV_SUB;
constexpr int DQ_BQ = 128;   // K4c: query rows a block owns
constexpr int DQ_BK = TEOCHAT_FLASH_BWD_DQ_BK;  // K4c: keys a ring stage
constexpr int STAGES = TEOCHAT_FLASH_BWD_STAGES;
constexpr int NWG = 2;  // consumer warpgroups, 64 rows of the owned tile each
constexpr int NTHREADS = (NWG + 1) * 128;
static_assert(DKV_BK == NWG * 64 && DQ_BQ == NWG * 64, "a block owns two warpgroups' 64 rows");
static_assert(DKV_BQ % DKV_SUB == 0, "a ring stage is whole score tiles");
static_assert(DQ_BK == 64 || DQ_BK == 128, "a kv tile is one or two 64-key wgmma widths");
// registers a thread after setmaxnreg: (2 consumers + producer) * 128 threads
// may take the 64,512 the block was launched with (168 each), no more: the
// registers beyond that are never handed out, and `setmaxnreg.inc` waits for
// them. K4b's producer is a whole warp that also loads the statistics and
// spills below ~46 registers; K4c's is one thread
constexpr int DKV_CONSUMER_REGS = 224, DKV_PRODUCER_REGS = 56;
constexpr int DQ_CONSUMER_REGS = 240, DQ_PRODUCER_REGS = 24;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p = exp(s - m) / l = 2^(s scale log2(e) - offset), offset = m log2(e) +
// log2(l): a row's maximum and denominator in one number, so that p costs one
// multiply-add and one exponential. 1 / l = 1 where l == 0.
__device__ __forceinline__ float softmax_offset(float m, float l) {
  return l == 0.f ? m * LOG2E : fmaf(m, LOG2E, log2f(l));
}

__device__ __forceinline__ void st_shared_f32(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}

__device__ __forceinline__ float2 ld_shared_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// The box of `map` that starts at column d0 of row `row` of head `head`.
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int rows_first, int d0, int row, int head, int b) {
  tma_load_4d(dst, map, bar, d0, rows_first ? row : head, rows_first ? head : row, b);
}

// `order` says for q (bit 0), k (bit 1), v (bit 2) and dO (bit 3) whether the
// tensor map has rows before heads.
struct Maps {
  CUtensorMap q, k, v, dout;
  int order;
};

// ---------------------------------------------------------------- di

// di[b, h, s] = sum_d o[b, s, h, d] * dO[b, s, h, d] in fp32, both tensors
// contiguous: D / 8 lanes a row, each with one 16-byte load from either
// tensor, so a warp reads whole rows one after the other.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_di_kernel(const uint16_t* __restrict__ o, const uint16_t* __restrict__ dout,
                    float* __restrict__ di, long long rows, int S, int H) {
  constexpr int LANES = D / 8;  // lanes a row: 8 or 16
  const long long r = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / LANES;
  const int part = threadIdx.x % LANES;
  float sum = 0.f;
  if (r < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + r * D + part * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + r * D + part * 8);
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the upper half of its fp32
      sum = fmaf(__uint_as_float(aw[i] << 16), __uint_as_float(bw[i] << 16), sum);
      sum = fmaf(__uint_as_float(aw[i] & 0xffff0000u), __uint_as_float(bw[i] & 0xffff0000u), sum);
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0 && r < rows) {
    const long long bs = r / H;  // r = (b * S + s) * H + h
    const int h = static_cast<int>(r % H), s = static_cast<int>(bs % S);
    di[((bs / S) * H + h) * S + s] = sum;
  }
}

// ---------------------------------------------------------------- K4c: dQ

template <int D>
constexpr size_t dq_smem_bytes() {
  // 1024 to align the tiles, Q and dO, the K and V rings, the barriers
  return 1024 + size_t(2 * DQ_BQ + 2 * STAGES * DQ_BK) * D * 2 + 8 * (2 + 2 * STAGES);
}

// One query tile of one head: its first row and the kv tiles it walks.
struct DqTile {
  int b, h, q0, n_kv;
};

// The query tiles a block works through, in order. A work item is one head's
// causal tiles qt and n_qt - 1 - qt together (every item then walks the same
// number of keys), or one tile of a non-causal call. Items that follow each
// other belong to the same head or its neighbour and run at the same time on
// neighbouring SMs, which keeps K and V in the L2 while they are needed.
struct DqWalk {
  int n_qt, per_head, n_items, H, T, causal;
  int item, half;

  __device__ DqWalk(int S, int T_, int H_, int B, int causal_)
      : n_qt((S + DQ_BQ - 1) / DQ_BQ), H(H_), T(T_), causal(causal_), item(blockIdx.x), half(0) {
    per_head = causal ? (n_qt + 1) / 2 : n_qt;
    n_items = per_head * H * B;
  }

  __device__ bool next(DqTile& t) {
    if (item >= n_items) return false;
    const int bh = item / per_head, pi = item % per_head;
    const int far = n_qt - 1 - pi;  // the long tile first
    const int qt = !causal ? pi : half == 0 ? far : pi;
    t.b = bh / H, t.h = bh % H, t.q0 = qt * DQ_BQ;
    t.n_kv = (T + DQ_BK - 1) / DQ_BK;
    if (causal) t.n_kv = min(t.n_kv, (t.q0 + DQ_BQ - 1) / DQ_BK + 1);
    if (causal && half == 0 && far != pi) {
      half = 1;
    } else {
      half = 0, item += gridDim.x;
    }
    return true;
  }
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ Maps maps, const float* __restrict__ m,
                    const float* __restrict__ l, const float* __restrict__ di,
                    uint16_t* __restrict__ dq, int B, int S, int T, int H, int Hkv, float scale,
                    int causal) {
  constexpr int BOXES = D / 64;  // 64-column boxes a row
  constexpr uint32_t Q_BOX = DQ_BQ * SWIZZLE_ROW_BYTES, KV_BOX = DQ_BK * SWIZZLE_ROW_BYTES;
  constexpr uint32_t Q_BYTES = BOXES * Q_BOX, KV_BYTES = BOXES * KV_BOX;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + Q_BYTES;
  const uint32_t k_s = do_s + Q_BYTES;
  const uint32_t v_s = k_s + STAGES * KV_BYTES;
  const uint32_t q_full = v_s + STAGES * KV_BYTES, q_empty = q_full + 8;
  auto kv_full = [q_full](int stage) { return q_full + 8u * (2 + stage); };
  auto kv_empty = [q_full](int stage) { return q_full + 8u * (2 + STAGES + stage); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);         // the producer's arrival, with the bytes to come
    mbar_init(q_empty, NWG * 4);  // one arrival a consumer warp
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(kv_full(st), 1);
      mbar_init(kv_empty(st), NWG * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  DqWalk walk(S, T, H, B, causal);
  DqTile tile;
  // tiles and kv tiles this block has started: they number the barriers'
  // phases, the same on the producer's and the consumers' side
  int n_tiles = 0, n_kv_tiles = 0;

  const int wg = threadIdx.x >> 7;
  if (wg == NWG) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<DQ_PRODUCER_REGS>();
    if (threadIdx.x != NWG * 128) return;
    tma_prefetch_map(&maps.q);
    tma_prefetch_map(&maps.k);
    tma_prefetch_map(&maps.v);
    tma_prefetch_map(&maps.dout);
    while (walk.next(tile)) {
      const int hk = tile.h / (H / Hkv);
      // a fresh buffer is free at once; a used one when its readers have arrived
      mbar_wait(q_empty, (n_tiles & 1) ^ 1);
      mbar_arrive_expect_tx(q_full, 2 * Q_BYTES);
#pragma unroll
      for (int c = 0; c < BOXES; ++c) {
        load_rows(q_s + c * Q_BOX, &maps.q, q_full, maps.order & 1, c * 64, tile.q0, tile.h,
                  tile.b);
        load_rows(do_s + c * Q_BOX, &maps.dout, q_full, maps.order & 8, c * 64, tile.q0, tile.h,
                  tile.b);
      }
      for (int j = 0; j < tile.n_kv; ++j, ++n_kv_tiles) {
        const int st = n_kv_tiles % STAGES;
        mbar_wait(kv_empty(st), ((n_kv_tiles / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(kv_full(st), 2 * KV_BYTES);
#pragma unroll
        for (int c = 0; c < BOXES; ++c) {
          load_rows(k_s + st * KV_BYTES + c * KV_BOX, &maps.k, kv_full(st), maps.order & 2,
                    c * 64, j * DQ_BK, hk, tile.b);
          load_rows(v_s + st * KV_BYTES + c * KV_BOX, &maps.v, kv_full(st), maps.order & 4,
                    c * 64, j * DQ_BK, hk, tile.b);
        }
      }
      ++n_tiles;
    }
  } else {
    // ------------------------------------------------------------ consumer
    setmaxnreg_inc<DQ_CONSUMER_REGS>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;  // fragment coordinates
    const float c2 = scale * LOG2E;             // scores in base-2 units
    const uint64_t q_desc = smem_desc_k_major(q_s + wg * 64 * SWIZZLE_ROW_BYTES);
    const uint64_t do_desc = smem_desc_k_major(do_s + wg * 64 * SWIZZLE_ROW_BYTES);

    float s[DQ_BK / 2], dp[DQ_BK / 2];
    // S = Q K^T and dP = dO V^T for this warpgroup's 64 rows x the keys of kv
    // tile `n` of the block's count; the last one of a query tile frees Q and dO
    auto scores = [&](int n, bool last) {
      const int st = n % STAGES;
      mbar_wait(kv_full(st), (n / STAGES) & 1);
      const uint64_t k_desc = smem_desc_k_major(k_s + st * KV_BYTES);
      const uint64_t v_desc = smem_desc_k_major(v_s + st * KV_BYTES);
      wgmma_fence();
      wgmma_ss_first(s, q_desc, k_desc);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk % 4) * 32;  // four 16-deep steps a 64-column box
        wgmma_ss(s, desc_advance(q_desc, (kk / 4) * Q_BOX + in_box),
                 desc_advance(k_desc, (kk / 4) * KV_BOX + in_box), 1);
      }
      wgmma_ss_first(dp, do_desc, v_desc);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk % 4) * 32;
        wgmma_ss(dp, desc_advance(do_desc, (kk / 4) * Q_BOX + in_box),
                 desc_advance(v_desc, (kk / 4) * KV_BOX + in_box), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (last && lane == 0) mbar_arrive(q_empty);
    };

    while (walk.next(tile)) {
      const int row_lo = tile.q0 + wg * 64 + warp * 16 + gid;  // this thread's rows: row_lo, + 8
      // p = exp(s - m) / l = 2^(s c2 - ml2): the row's maximum and denominator
      // in one base-2 offset. Rows past S take m = 0, 1 / l = 1, di = 0 (their
      // q and dO are zeros)
      float ml2[2] = {0.f, 0.f}, di_r[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_lo + 8 * r;
        if (row < S) {
          const long long idx = (static_cast<long long>(tile.b) * H + tile.h) * S + row;
          ml2[r] = softmax_offset(m[idx], l[idx]);
          di_r[r] = di[idx];
        }
      }
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      mbar_wait(q_full, n_tiles & 1);
      mbar_wait(kv_full(n_kv_tiles % STAGES), (n_kv_tiles / STAGES) & 1);
      scores(n_kv_tiles, tile.n_kv == 1);

      for (int j = 0; j < tile.n_kv; ++j, ++n_kv_tiles) {
        const int k0 = j * DQ_BK;
        // scores into base-2 units, less the row's offset
#pragma unroll
        for (int i = 0; i < DQ_BK / 2; ++i) s[i] = fmaf(s[i], c2, -ml2[(i >> 1) & 1]);
        // mask (ragged keys and the causal diagonal) where the tile needs it
        if (k0 + DQ_BK > T || (causal && k0 + DQ_BK - 1 > row_lo - gid)) {
#pragma unroll
          for (int i = 0; i < DQ_BK / 2; ++i) {
            const int row = row_lo + ((i >> 1) & 1) * 8;
            const int col = k0 + (i >> 2) * 8 + tig * 2 + (i & 1);
            if (col >= T || (causal && col > row)) s[i] = MASK_VALUE;
          }
        }
        // ds = p (dp - di), in place of s
#pragma unroll
        for (int i = 0; i < DQ_BK / 2; ++i) {
          const int r = (i >> 1) & 1;
          s[i] = exp2_fast(s[i]) * (dp[i] - di_r[r]);
        }
        // dS as the A operand of dS K: registers 8 kk .. 8 kk + 7 are step kk
        uint32_t a[DQ_BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < DQ_BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);

        // dQ += dS K (K read MN-major from the tile as it was
        // loaded), then the next tile's scores
        const int st = n_kv_tiles % STAGES;
        const uint64_t k_desc = smem_desc_mn_major(k_s + st * KV_BYTES, KV_BOX);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQ_BK / 16; ++kk)
          wgmma_rs_tb(acc, a[kk], desc_advance(k_desc, kk * 16 * SWIZZLE_ROW_BYTES), 1);
        wgmma_commit();
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(kv_empty(st));
        if (j + 1 < tile.n_kv) scores(n_kv_tiles + 1, j + 2 == tile.n_kv);
      }
      ++n_tiles;

      // the other warpgroup and the loads go on while this one writes its rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_lo + 8 * r;
        if (row >= S) continue;
        uint16_t* out = dq + ((static_cast<long long>(tile.b) * S + row) * H + tile.h) * D;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<uint32_t*>(out + dt * 8 + tig * 2) =
              pack_bf16(acc[4 * dt + 2 * r] * scale, acc[4 * dt + 2 * r + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------- K4b: dK, dV

template <int D>
constexpr size_t dkv_smem_bytes() {
  // 1024 to align the tiles, K and V, the Q and dO rings, the statistics'
  // ring (softmax offset and di a row), the barriers
  return 1024 + size_t(2 * DKV_BK + 2 * STAGES * DKV_BQ) * D * 2 + STAGES * 2 * DKV_BQ * 4 +
         8 * (2 + 2 * STAGES);
}

// One kv tile of one kv head: its first key and the q tiles each head of the
// group walks, [qt0, n_qt).
struct DkvTile {
  int b, hk, k0, qt0;
};

// The kv tiles a block works through. A work item is one kv head's causal
// tiles j and n_kt - 1 - j together (tile j walks the q tiles from its
// diagonal down, so the pair always walks the same number), or one tile of a
// non-causal call.
struct DkvWalk {
  int item, half;  // the rest is worked out from the sizes each time: fewer registers held

  __device__ DkvWalk() : item(blockIdx.x), half(0) {}

  __device__ bool next(DkvTile& t, int T, int Hkv, int B, int causal) {
    const int n_kt = (T + DKV_BK - 1) / DKV_BK;
    const int per_head = causal ? (n_kt + 1) / 2 : n_kt;
    if (item >= per_head * Hkv * B) return false;
    const int bh = item / per_head, pi = item % per_head;
    const int far = n_kt - 1 - pi;
    const int kt = !causal ? pi : half == 0 ? pi : far;  // the long tile first
    t.b = bh / Hkv, t.hk = bh % Hkv, t.k0 = kt * DKV_BK;
    t.qt0 = causal ? t.k0 / DKV_BQ : 0;  // q tiles wholly above the diagonal are skipped
    if (causal && half == 0 && far != pi) {
      half = 1;
    } else {
      half = 0, item += gridDim.x;
    }
    return true;
  }
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ Maps maps, const float* __restrict__ m,
                     const float* __restrict__ l, const float* __restrict__ di,
                     uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int B, int S, int T,
                     int H, int Hkv, float scale, int causal) {
  constexpr int BOXES = D / 64;
  constexpr uint32_t KV_BOX = DKV_BK * SWIZZLE_ROW_BYTES, Q_BOX = DKV_BQ * SWIZZLE_ROW_BYTES;
  constexpr uint32_t KV_BYTES = BOXES * KV_BOX, Q_BYTES = BOXES * Q_BOX;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + KV_BYTES;
  const uint32_t q_s = v_s + KV_BYTES;
  const uint32_t do_s = q_s + STAGES * Q_BYTES;
  const uint32_t stat_s = do_s + STAGES * Q_BYTES;
  // the statistics are written and read with ordinary loads and stores
  const uint32_t kv_full = stat_s + STAGES * 2 * DKV_BQ * 4, kv_empty = kv_full + 8;
  auto q_full = [kv_full](int stage) { return kv_full + 8u * (2 + stage); };
  auto q_empty = [kv_full](int stage) { return kv_full + 8u * (2 + STAGES + stage); };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, NWG * 4);  // one arrival a consumer warp
    for (int st = 0; st < STAGES; ++st) {
      // the lane that announces the loads, then every lane after its statistics
      mbar_init(q_full(st), 33);
      mbar_init(q_empty(st), NWG * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  DkvWalk walk;
  DkvTile tile;
  const int G = H / Hkv, n_qt = (S + DKV_BQ - 1) / DKV_BQ;
  int n_tiles = 0, n_steps = 0;  // they number the barriers' phases on both sides

  const int wg = threadIdx.x >> 7;
  if (wg == NWG) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<DKV_PRODUCER_REGS>();
    if (threadIdx.x >= NWG * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      tma_prefetch_map(&maps.q);
      tma_prefetch_map(&maps.k);
      tma_prefetch_map(&maps.v);
      tma_prefetch_map(&maps.dout);
    }
    while (walk.next(tile, T, Hkv, B, causal)) {
      if (lane == 0) {
        mbar_wait(kv_empty, (n_tiles & 1) ^ 1);
        mbar_arrive_expect_tx(kv_full, 2 * KV_BYTES);
#pragma unroll
        for (int c = 0; c < BOXES; ++c) {
          load_rows(k_s + c * KV_BOX, &maps.k, kv_full, maps.order & 2, c * 64, tile.k0, tile.hk,
                    tile.b);
          load_rows(v_s + c * KV_BOX, &maps.v, kv_full, maps.order & 4, c * 64, tile.k0, tile.hk,
                    tile.b);
        }
      }
      for (int g = 0; g < G; ++g) {
        const int h = tile.hk * G + g;
        const long long row_base = (static_cast<long long>(tile.b) * H + h) * S;
        for (int qt = tile.qt0; qt < n_qt; ++qt, ++n_steps) {
          const int st = n_steps % STAGES, q0 = qt * DKV_BQ;
          mbar_wait(q_empty(st), ((n_steps / STAGES) & 1) ^ 1);
          if (lane == 0) {  // the tiles first: their latency is the longer
            mbar_arrive_expect_tx(q_full(st), 2 * Q_BYTES);
#pragma unroll
            for (int c = 0; c < BOXES; ++c) {
              load_rows(q_s + st * Q_BYTES + c * Q_BOX, &maps.q, q_full(st), maps.order & 1,
                        c * 64, q0, h, tile.b);
              load_rows(do_s + st * Q_BYTES + c * Q_BOX, &maps.dout, q_full(st), maps.order & 8,
                        c * 64, q0, h, tile.b);
            }
          }
          const uint32_t stat = stat_s + st * 2 * DKV_BQ * 4;
          for (int i = lane; i < DKV_BQ; i += 32) {
            // rows past S: q = dO = 0 and di = 0, so they add exactly nothing
            float off = 0.f, dd = 0.f;
            if (q0 + i < S) {
              off = softmax_offset(m[row_base + q0 + i], l[row_base + q0 + i]);
              dd = di[row_base + q0 + i];
            }
            st_shared_f32(stat + 4 * i, off);
            st_shared_f32(stat + 4 * (DKV_BQ + i), dd);
          }
          mbar_arrive(q_full(st));
        }
      }
      ++n_tiles;
    }
  } else {
    // ------------------------------------------------------------ consumer
    setmaxnreg_inc<DKV_CONSUMER_REGS>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;  // fragment coordinates
    const float c2 = scale * LOG2E;             // scores in base-2 units
    const uint64_t k_desc = smem_desc_k_major(k_s + wg * 64 * SWIZZLE_ROW_BYTES);
    const uint64_t v_desc = smem_desc_k_major(v_s + wg * 64 * SWIZZLE_ROW_BYTES);

    float st_[DKV_SUB / 2], dpt[DKV_SUB / 2];
    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys x the
    // DKV_SUB rows of part `part` of step `n` of the block's count; the last
    // one of a kv tile frees K and V
    auto scores = [&](int n, int part) {
      const int st = n % STAGES;
      if (part == 0) mbar_wait(q_full(st), (n / STAGES) & 1);
      const uint32_t rows = part * DKV_SUB * SWIZZLE_ROW_BYTES;
      const uint64_t q_desc = smem_desc_k_major(q_s + st * Q_BYTES + rows);
      const uint64_t do_desc = smem_desc_k_major(do_s + st * Q_BYTES + rows);
      wgmma_ss_first(st_, k_desc, q_desc);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk % 4) * 32;  // four 16-deep steps a 64-column box
        wgmma_ss(st_, desc_advance(k_desc, (kk / 4) * KV_BOX + in_box),
                 desc_advance(q_desc, (kk / 4) * Q_BOX + in_box), 1);
      }
      wgmma_ss_first(dpt, v_desc, do_desc);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk % 4) * 32;
        wgmma_ss(dpt, desc_advance(v_desc, (kk / 4) * KV_BOX + in_box),
                 desc_advance(do_desc, (kk / 4) * Q_BOX + in_box), 1);
      }
    };

    while (walk.next(tile, T, Hkv, B, causal)) {
      const int key_lo = tile.k0 + wg * 64 + warp * 16 + gid;  // this thread's keys: key_lo, + 8
      float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      const int per_head = n_qt - tile.qt0, steps = G * per_head;

      mbar_wait(kv_full, n_tiles & 1);
      mbar_wait(q_full(n_steps % STAGES), (n_steps / STAGES) & 1);
      wgmma_fence();
      scores(n_steps, 0);
      wgmma_commit();
      wgmma_wait<0>();

      for (int i_step = 0; i_step < steps; ++i_step, ++n_steps) {
        const int st = n_steps % STAGES;
#pragma unroll
        for (int part = 0; part < PARTS; ++part) {
          const int q0 = (tile.qt0 + i_step % per_head) * DKV_BQ + part * DKV_SUB;
          const uint32_t stat = stat_s + (st * 2 * DKV_BQ + part * DKV_SUB) * 4;
          // p^T and ds^T: a column is a query row, with its own softmax offset
          // and di; each 16 columns are packed as the A operand of step kk
          // (registers 8 kk .. 8 kk + 7)
          const bool edge = key_lo - gid + 15 >= T || (causal && key_lo - gid + 15 > q0);
          uint32_t ap[DKV_SUB / 16][4], ads[DKV_SUB / 16][4];
#pragma unroll
          for (int kk = 0; kk < DKV_SUB / 16; ++kk) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int nt = 2 * kk + half, c = nt * 8 + tig * 2;
              const float2 off = ld_shared_f32x2(stat + 4 * c);
              const float2 dd = ld_shared_f32x2(stat + 4 * (DKV_BQ + c));
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = 4 * nt + e;
                float x = fmaf(st_[i], c2, -((e & 1) ? off.y : off.x));
                if (edge) {  // ragged keys and the causal diagonal
                  const int key = key_lo + (e >> 1) * 8, row = q0 + c + (e & 1);
                  if (key >= T || (causal && key > row)) x = MASK_VALUE;
                }
                st_[i] = exp2_fast(x);
                dpt[i] = st_[i] * (dpt[i] - ((e & 1) ? dd.y : dd.x));
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ap[kk][e] = pack_bf16(st_[8 * kk + 2 * e], st_[8 * kk + 2 * e + 1]);
              ads[kk][e] = pack_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
            }
          }

          // dV += P^T dO and dK += dS^T Q (dO and Q read MN-major
          // from the tiles as they were loaded), then the next part's scores
          const uint32_t rows = part * DKV_SUB * SWIZZLE_ROW_BYTES;
          const uint64_t do_desc = smem_desc_mn_major(do_s + st * Q_BYTES + rows, Q_BOX);
          const uint64_t q_desc = smem_desc_mn_major(q_s + st * Q_BYTES + rows, Q_BOX);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DKV_SUB / 16; ++kk)
            wgmma_rs_tb(dv_acc, ap[kk], desc_advance(do_desc, kk * 16 * SWIZZLE_ROW_BYTES), 1);
#pragma unroll
          for (int kk = 0; kk < DKV_SUB / 16; ++kk)
            wgmma_rs_tb(dk_acc, ads[kk], desc_advance(q_desc, kk * 16 * SWIZZLE_ROW_BYTES), 1);
          const bool last_part = part + 1 == PARTS;
          if (!last_part) {
            scores(n_steps, part + 1);
          } else if (i_step + 1 < steps) {
            scores(n_steps + 1, 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          if (last_part && lane == 0) {
            mbar_arrive(q_empty(st));
            if (i_step + 1 == steps) mbar_arrive(kv_empty);  // K and V were last read above
          }
        }
      }
      ++n_tiles;

      // the other warpgroup and the loads go on while this one writes its keys
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key_lo + 8 * r;
        if (key >= T) continue;
        const long long off = ((static_cast<long long>(tile.b) * T + key) * Hkv + tile.hk) * D;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const int c = dt * 8 + tig * 2;
          *reinterpret_cast<uint32_t*>(dk + off + c) =
              pack_bf16(dk_acc[4 * dt + 2 * r] * scale, dk_acc[4 * dt + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + off + c) =
              pack_bf16(dv_acc[4 * dt + 2 * r], dv_acc[4 * dt + 2 * r + 1]);
        }
      }
    }
  }
}

static_assert(dq_smem_bytes<128>() <= 227 * 1024 && dkv_smem_bytes<128>() <= 227 * 1024,
              "the tiles and rings fit an SM's shared memory");

// ---------------------------------------------------------------- launches

// What both entries are given; see TEOCHAT_BWD_ARGS below.
struct Call {
  const void *q, *k, *v, *dout;
  const float *m, *l, *di;
  int B, S, T, H, Hkv, D;
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh;
  float scale;
  int causal;
  cudaStream_t stream;
};

// The four tensor maps of a call (nothing is kept between calls): q and dO
// in boxes of `q_rows` rows, k and v in boxes of `kv_rows`.
int encode_maps(Maps* maps, const Call& c, int q_rows, int kv_rows) {
  int qf, kf, vf, of;
  int err = encode_bf16_rows_map(&maps->q, &qf, c.q, c.B, c.S, c.H, c.D, c.q_sb, c.q_ss, c.q_sh,
                                 q_rows);
  if (!err)
    err = encode_bf16_rows_map(&maps->k, &kf, c.k, c.B, c.T, c.Hkv, c.D, c.k_sb, c.k_st, c.k_sh,
                               kv_rows);
  if (!err)
    err = encode_bf16_rows_map(&maps->v, &vf, c.v, c.B, c.T, c.Hkv, c.D, c.v_sb, c.v_st, c.v_sh,
                               kv_rows);
  if (!err)
    err = encode_bf16_rows_map(&maps->dout, &of, c.dout, c.B, c.S, c.H, c.D, c.o_sb, c.o_ss,
                               c.o_sh, q_rows);
  if (!err) maps->order = qf | (kf << 1) | (vf << 2) | (of << 3);
  return err;
}

// One block an SM, each walking its share of the items. Above 48 KB shared
// memory is dynamic and has to be asked for; the attribute belongs to the
// device the launch goes to, so it is set each time.
template <typename Kernel>
int prepare(Kernel kernel, size_t smem, long long items, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *blocks = static_cast<int>(items < sms ? items : sms);
  return static_cast<int>(err);
}

template <int D>
int launch_dkv(const Call& c, uint16_t* dk, uint16_t* dv) {
  Maps maps;
  int blocks, err = encode_maps(&maps, c, DKV_BQ, DKV_BK);
  const long long n_kt = (c.T + DKV_BK - 1) / DKV_BK;
  const long long items = (c.causal ? (n_kt + 1) / 2 : n_kt) * c.Hkv * c.B;
  if (!err) err = prepare(flash_bwd_dkv_kernel<D>, dkv_smem_bytes<D>(), items, &blocks);
  if (err) return err;
  flash_bwd_dkv_kernel<D><<<blocks, NTHREADS, dkv_smem_bytes<D>(), c.stream>>>(
      maps, c.m, c.l, c.di, dk, dv, c.B, c.S, c.T, c.H, c.Hkv, c.scale, c.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Call& c, uint16_t* dq) {
  Maps maps;
  int blocks, err = encode_maps(&maps, c, DQ_BQ, DQ_BK);
  const long long n_qt = (c.S + DQ_BQ - 1) / DQ_BQ;
  const long long items = (c.causal ? (n_qt + 1) / 2 : n_qt) * c.H * c.B;
  if (!err) err = prepare(flash_bwd_dq_kernel<D>, dq_smem_bytes<D>(), items, &blocks);
  if (err) return err;
  flash_bwd_dq_kernel<D><<<blocks, NTHREADS, dq_smem_bytes<D>(), c.stream>>>(
      maps, c.m, c.l, c.di, dq, c.B, c.S, c.T, c.H, c.Hkv, c.scale, c.causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The two backward entries take the same arguments: q, k, v, dO (bf16,
// strided), m, l, di (fp32 [B, H, S]), sizes, strides, scale, causal and the
// stream, then the outputs. Each returns 0, or the error of the tensor maps'
// encoding or of the launch.
#define TEOCHAT_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout, const void *m, \
      const void *l, const void *di, int B, int S, int T, int H, int Hkv,       \
      int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,    \
      long long k_st, long long k_sh, long long v_sb, long long v_st,           \
      long long v_sh, long long o_sb, long long o_ss, long long o_sh,           \
      float scale, int causal, void *stream

#define TEOCHAT_BWD_CALL                                                                  \
  Call {                                                                                  \
    q, k, v, dout, static_cast<const float*>(m), static_cast<const float*>(l),            \
        static_cast<const float*>(di), B, S, T, H, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_st,  \
        k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh, scale, causal,                          \
        static_cast<cudaStream_t>(stream)                                                 \
  }

// K4b: dK and dV, contiguous [B, T, Hkv, D].
extern "C" int teochat_flash_attention_bwd_dkv(TEOCHAT_BWD_ARGS, void* dk, void* dv) {
  const Call c = TEOCHAT_BWD_CALL;
  auto* dkp = static_cast<uint16_t*>(dk);
  auto* dvp = static_cast<uint16_t*>(dv);
  if (D == 128) return launch_dkv<128>(c, dkp, dvp);
  if (D == 64) return launch_dkv<64>(c, dkp, dvp);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4c: dQ, contiguous [B, S, H, D].
extern "C" int teochat_flash_attention_bwd_dq(TEOCHAT_BWD_ARGS, void* dq) {
  const Call c = TEOCHAT_BWD_CALL;
  if (D == 128) return launch_dq<128>(c, static_cast<uint16_t*>(dq));
  if (D == 64) return launch_dq<64>(c, static_cast<uint16_t*>(dq));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The preamble: di = rowsum(o * dO), fp32 [B, H, S], from contiguous bf16
// o and dO [B, S, H, D].
extern "C" int teochat_flash_attention_bwd_di(const void* o, const void* dout, void* di, int B,
                                              int S, int H, int D, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * S * H;
  const long long per_block = 256 / (D / 8);  // rows a block of 256 threads takes
  const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  const auto* op = static_cast<const uint16_t*>(o);
  const auto* dp = static_cast<const uint16_t*>(dout);
  auto* out = static_cast<float*>(di);
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    flash_bwd_di_kernel<128><<<blocks, 256, 0, s>>>(op, dp, out, rows, S, H);
  else
    flash_bwd_di_kernel<64><<<blocks, 256, 0, s>>>(op, dp, out, rows, S, H);
  return static_cast<int>(cudaGetLastError());
}
