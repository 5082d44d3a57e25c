// One-sweep ViT attention variants of the kernel bench, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of scripts/bench_vit_attention.py: _kernel_b
// (:36; [B, S, H, D] read in place, `bh` heads a grid cell, no padding of S)
// and _kernel_c (:76; contiguous [B H, S, D] rows, one head a cell, the caller
// transposes to and from). Both compute, for every (frame, head): scores
// s = q k^T * scale in fp32 with keys at index >= S masked, each row's
// maximum m over all its keys, p = exp(s - m), l = sum p in fp32, and
// o = bf16(p / l) v with an fp32 accumulator, written in bf16. p / l is
// rounded before the product with v: that is where these differ from K5
// (vit_attention.cu), which rounds p and divides after. Head dim 64,
// 1 <= S <= MAX_SEQ.
//
// What bounds them on an H100: at the bench's shape ([32, 257, 16, 64]) the
// bytes of q, k, v and o (one read and one write each) take about twice as
// long as the two products on the tensor cores, and the exponentials (one a
// score) about as long as the products. So every score is computed on the
// tensor cores and kept on the SM, the loads run ahead of the arithmetic,
// and one persistent block an SM keeps the card full.
//
// Design (K5's, from hopper_async.cuh's pieces; one kernel behind both
// entries, which differ only in their tensor maps):
// - keys come in windows of WINDOW = 272 (256 + 16: S = 257 in one window).
//   A window's scores are two `wgmma` products, Q K^T at N 256 and at N 16,
//   whose 136 fp32 registers a thread hold its rows' whole window;
// - S <= 272, one sweep: mask the keys past S, take each row's maximum over
//   the quad's four lanes, exponentiate in base 2 (the scale rides on the
//   exponent's multiply-add), sum, multiply by 1 / l and pack to bf16 as the
//   register A operand of P V against V read MN-major (`tnspB`). No score
//   leaves the registers and the epilogue only rounds o;
// - 272 < S <= MAX_SEQ, two sweeps: the first runs Q K^T over every window
//   for m and l (l rescaled online as a per-row scalar: 2^(m_old - m_new)),
//   the second recomputes each window's scores and runs bf16(p / l) V. The
//   accumulator is never rescaled: the function has no such step;
// - one producer warp loads, by TMA with the 128-byte swizzle, each query
//   tile (64 rows a consumer warpgroup) and each window's K and V (two
//   boxes of 136 rows) into rings of STAGES windows with `full` and `empty`
//   mbarriers. K and V are separate rings, since the first sweep reads K
//   alone. TMA fills rows past S with zeros, so no load is guarded, and no
//   thread writes the shared memory that `wgmma` reads;
// - persistent blocks, one an SM, walk work items in turn. An item is
//   (frame, group of `bh` heads, pair of query tiles): the block walks its
//   `bh` heads in order and the rings load head h + 1's Q, K and V while
//   head h computes. S2-c's flat [B H, S, 64] rows are B H frames of one
//   head (bh 1). The two consumer warpgroups take the pair's two tiles; a
//   warpgroup whose whole tile lies past S only keeps the barriers' count.
// Nothing is atomic and no sum depends on timing: a second call gives the
// same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper_async.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace teochat;

constexpr int D = 64;
constexpr int TILE_Q = 64;                    // query rows a consumer warpgroup
constexpr int KEYS_A = 256;                   // the window's two products (wgmma N)
constexpr int KEYS_B = 16;
constexpr int WINDOW = KEYS_A + KEYS_B;       // keys a window
constexpr int MAX_SEQ = 832;                  // the bench's gate: up to four windows
constexpr int KV_BOX_ROWS = WINDOW / 2;       // a TMA box: at most 256 rows
constexpr uint32_t Q_BYTES = TILE_Q * SWIZZLE_ROW_BYTES;
constexpr uint32_t WINDOW_BYTES = WINDOW * SWIZZLE_ROW_BYTES;
constexpr uint32_t KV_BOX_BYTES = KV_BOX_ROWS * SWIZZLE_ROW_BYTES;
static_assert(KV_BOX_BYTES % SWIZZLE_ATOM_BYTES == 0, "a box keeps the swizzle's 1024-byte period");
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NS = WINDOW / 2;  // score registers a thread: 64 rows x 272 keys / 128 threads

enum Barrier { K_FULL = 0, V_FULL = 1, K_EMPTY = 2, V_EMPTY = 3 };

constexpr int NWG = 2;                      // consumer warpgroups a block
constexpr int STAGES = 2;                   // windows in flight, in each ring
constexpr int NTHREADS = (NWG + 1) * 128;   // the producer is a warpgroup's slot
// 384 threads launch with 168 registers each; setmaxnreg moves the
// producer's to the consumers: 256 x 240 + 128 x 24 = 384 x 168.
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
constexpr size_t SMEM = 1024 + NWG * Q_BYTES + 2 * STAGES * WINDOW_BYTES + 8 * (2 + 4 * STAGES);
static_assert(SMEM <= 232448, "the rings fit an SM's shared memory");

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The box of `map` that starts at row `row` of head `head` of frame `b`.
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int rows_first, int row, int head, int b) {
  tma_load_4d(dst, map, bar, 0, rows_first ? row : head, rows_first ? head : row, b);
}

// Window w of head `head` of frame `b` (two boxes) into the ring slot at
// `dst`, once the slot's readers have freed it (`empty`'s phase of parity
// `parity`; a fresh slot is free at once); its bytes count on `full`.
__device__ __forceinline__ void load_window(const CUtensorMap* map, int rows_first, uint32_t dst,
                                            uint32_t full, uint32_t empty, uint32_t parity,
                                            int w, int head, int b) {
  mbar_wait(empty, parity);
  mbar_arrive_expect_tx(full, WINDOW_BYTES);
#pragma unroll
  for (int c = 0; c < 2; ++c)
    load_rows(dst + c * KV_BOX_BYTES, map, full, rows_first, w * WINDOW + c * KV_BOX_ROWS, head, b);
}

// Register i of a window's scores: sa (keys 0-255) then sb (keys 256-271).
// Its key is 8 (i / 4) + 2 tig + (i % 2) into the window, whichever array it is in.
#define TEOCHAT_S2_S(i) ((i) < 2 * KEYS_A / 4 ? sa[(i)] : sb[(i) - 2 * KEYS_A / 4])

// The window's raw scores Q K^T (keys 0-255 into sa, 256-271 into sb), with
// keys past S set to MASK_VALUE (TMA read them as zeros).
__device__ __forceinline__ void window_scores(float (&sa)[2 * KEYS_A / 4],
                                              float (&sb)[2 * KEYS_B / 4], uint64_t q_desc,
                                              uint32_t k_tile, int k0, int S, int tig) {
  const uint64_t k_desc = smem_desc_k_major(k_tile);
  const uint64_t kb_desc = desc_advance(k_desc, KEYS_A * SWIZZLE_ROW_BYTES);
  wgmma_fence();
  wgmma_ss_first(sa, q_desc, k_desc);
  wgmma_ss_first(sb, q_desc, kb_desc);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {  // a 16-deep step is 32 bytes into the row
    wgmma_ss(sa, desc_advance(q_desc, kk * 32), desc_advance(k_desc, kk * 32), 1);
    wgmma_ss(sb, desc_advance(q_desc, kk * 32), desc_advance(kb_desc, kk * 32), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  if (k0 + WINDOW > S) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (k0 + 8 * (i >> 2) + 2 * tig + (i & 1) >= S) TEOCHAT_S2_S(i) = MASK_VALUE;
  }
}

// One window's share of the softmax's statistics, for the thread's rows r
// (gid and gid + 8): m[r] becomes the maximum of m[r] and the window's
// scores, in base-2 units (c2 = scale log2 e > 0, so the maximum of the raw
// scores scales to it), l[r] is rescaled to it and takes this thread's
// 2^(s c2 - m), which are left in place of the scores. A row's keys are
// spread over the 4 lanes of a quad; l stays this thread's share.
__device__ __forceinline__ void window_stats(float (&sa)[2 * KEYS_A / 4],
                                             float (&sb)[2 * KEYS_B / 4], float c2,
                                             float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};  // four chains, not one
#pragma unroll
    for (int nt = 0; nt < NS / 4; ++nt)
      mx[nt & 3] = fmaxf(mx[nt & 3], fmaxf(TEOCHAT_S2_S(4 * nt + 2 * r),
                                           TEOCHAT_S2_S(4 * nt + 2 * r + 1)));
    float top = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
    const float m_next = fmaxf(m[r], top * c2);
    const float alpha = exp2_fast(m[r] - m_next);  // 0 in the first window
    m[r] = m_next;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NS / 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = TEOCHAT_S2_S(4 * nt + 2 * r + e);
        x = exp2_fast(fmaf(x, c2, -m_next));
        sum[nt & 3] += x;
      }
    }
    l[r] = alpha * l[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
  }
}

// `order` says for q (bit 0), k (bit 1) and v (bit 2) whether the map has
// rows before heads. o is contiguous [B, S, H, 64].
__global__ void __launch_bounds__(NTHREADS, 1)
bench_vit_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, int order,
                           uint16_t* __restrict__ o, int B, int S, int H, int bh, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + NWG * Q_BYTES;
  const uint32_t v_s = k_s + STAGES * WINDOW_BYTES;
  const uint32_t q_full = v_s + STAGES * WINDOW_BYTES, q_empty = q_full + 8;
  auto bar = [q_full](Barrier kind, int stage) {
    return q_full + 8u * (2 + kind * STAGES + stage);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);         // the producer's arrival, with the bytes to come
    mbar_init(q_empty, NWG * 4);  // one arrival a consumer warp
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar(K_FULL, st), 1);
      mbar_init(bar(V_FULL, st), 1);
      mbar_init(bar(K_EMPTY, st), NWG * 4);
      mbar_init(bar(V_EMPTY, st), NWG * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // work items: (frame, group of bh heads, pair of query tiles), the pairs of
  // a group next to each other, handed out to the blocks in turn
  const int n_qt = (S + NWG * TILE_Q - 1) / (NWG * TILE_Q);
  const int n_groups = H / bh;
  const int n_items = n_qt * n_groups * B;
  const int n_win = (S + WINDOW - 1) / WINDOW;
  const bool two_sweeps = n_win > 1;
  // the barriers' phases, counted alike on both sides: heads walked, K and V
  // windows taken
  int n_heads = 0, n_k = 0, n_v = 0;

  const int wg = threadIdx.x >> 7;
  if (wg == NWG) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != NWG * 128) return;
    tma_prefetch_map(&q_map);
    tma_prefetch_map(&k_map);
    tma_prefetch_map(&v_map);
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int qt = item % n_qt, g = (item / n_qt) % n_groups, b = item / n_qt / n_groups;
      for (int h = g * bh; h < (g + 1) * bh; ++h, ++n_heads) {
        mbar_wait(q_empty, (n_heads & 1) ^ 1);
        mbar_arrive_expect_tx(q_full, NWG * Q_BYTES);
#pragma unroll
        for (int c = 0; c < NWG; ++c)
          load_rows(q_s + c * Q_BYTES, &q_map, q_full, order & 1, (qt * NWG + c) * TILE_Q, h, b);
        // K alone for the first sweep, then K and V window by window
        for (int w = two_sweeps ? -n_win : 0; w < n_win; ++w, ++n_k) {
          const int wk = w < 0 ? w + n_win : w, st = n_k % STAGES;
          load_window(&k_map, order & 2, k_s + st * WINDOW_BYTES, bar(K_FULL, st),
                      bar(K_EMPTY, st), ((n_k / STAGES) & 1) ^ 1, wk, h, b);
          if (w < 0) continue;
          const int sv = n_v % STAGES;
          load_window(&v_map, order & 4, v_s + sv * WINDOW_BYTES, bar(V_FULL, sv),
                      bar(V_EMPTY, sv), ((n_v / STAGES) & 1) ^ 1, w, h, b);
          ++n_v;
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumer
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;  // fragment coordinates
    const float c2 = scale * LOG2E;             // scores in base-2 units
    const uint64_t q_desc = smem_desc_k_major(q_s + wg * Q_BYTES);

    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int qt = item % n_qt, g = (item / n_qt) % n_groups, b = item / n_qt / n_groups;
      const int tile0 = (qt * NWG + wg) * TILE_Q;
      const int row_lo = tile0 + warp * 16 + gid;  // this thread's rows: row_lo, + 8
      const bool idle = tile0 >= S;                // the whole tile lies past S
      for (int h = g * bh; h < (g + 1) * bh; ++h, ++n_heads) {
        mbar_wait(q_full, n_heads & 1);
        if (idle) {  // keep the count: wait for each window, then free it, in the producer's order
          for (int w = two_sweeps ? -n_win : 0; w < n_win; ++w, ++n_k) {
            const int st = n_k % STAGES;
            mbar_wait(bar(K_FULL, st), (n_k / STAGES) & 1);
            if (lane == 0) {
              mbar_arrive(bar(K_EMPTY, st));
              if (w + 1 == n_win) mbar_arrive(q_empty);
            }
            if (w < 0) continue;
            const int sv = n_v % STAGES;
            mbar_wait(bar(V_FULL, sv), (n_v / STAGES) & 1);
            if (lane == 0) mbar_arrive(bar(V_EMPTY, sv));
            ++n_v;
          }
          continue;
        }

        float sa[2 * KEYS_A / 4], sb[2 * KEYS_B / 4];
        float m[2] = {-INFINITY, -INFINITY};  // base-2 units
        float l[2] = {0.f, 0.f};              // this thread's share of the row's sum
        // first sweep (two-sweep sequences only): m and l over every window
        if (two_sweeps) {
          for (int w = 0; w < n_win; ++w, ++n_k) {
            const int st = n_k % STAGES;
            mbar_wait(bar(K_FULL, st), (n_k / STAGES) & 1);
            window_scores(sa, sb, q_desc, k_s + st * WINDOW_BYTES, w * WINDOW, S, tig);
            if (lane == 0) mbar_arrive(bar(K_EMPTY, st));
            window_stats(sa, sb, c2, m, l);
          }
        }

        float acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        float inv[2];
        for (int w = 0; w < n_win; ++w, ++n_k, ++n_v) {
          const int st = n_k % STAGES, sv = n_v % STAGES;
          mbar_wait(bar(K_FULL, st), (n_k / STAGES) & 1);
          window_scores(sa, sb, q_desc, k_s + st * WINDOW_BYTES, w * WINDOW, S, tig);
          if (lane == 0) {
            mbar_arrive(bar(K_EMPTY, st));
            if (w + 1 == n_win) mbar_arrive(q_empty);
          }
          if (two_sweeps) {  // p = 2^(s c2 - m) with the row's final m
#pragma unroll
            for (int i = 0; i < NS; ++i)
              TEOCHAT_S2_S(i) = exp2_fast(fmaf(TEOCHAT_S2_S(i), c2, -m[(i >> 1) & 1]));
          } else {  // one window: its statistics are the row's, p left in place
            window_stats(sa, sb, c2, m, l);
          }
          if (w == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float sum = l[r];
              sum += __shfl_xor_sync(0xffffffffu, sum, 1);
              sum += __shfl_xor_sync(0xffffffffu, sum, 2);
              inv[r] = 1.f / sum;  // the row's own maximum contributes 2^0 = 1
            }
          }

          // bf16(p / l) as the A operand of P V: registers 8 kk .. 8 kk + 7 are step kk
          uint32_t p[WINDOW / 16][4];
#pragma unroll
          for (int kk = 0; kk < WINDOW / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[kk][e] = pack_bf16(TEOCHAT_S2_S(8 * kk + 2 * e) * inv[e & 1],
                                   TEOCHAT_S2_S(8 * kk + 2 * e + 1) * inv[e & 1]);

          // acc += P V, V read MN-major from the window as it was loaded
          mbar_wait(bar(V_FULL, sv), (n_v / STAGES) & 1);
          const uint64_t v_desc = smem_desc_mn_major(v_s + sv * WINDOW_BYTES, WINDOW_BYTES);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < WINDOW / 16; ++kk)
            wgmma_rs_tb(acc, p[kk], desc_advance(v_desc, kk * 16 * SWIZZLE_ROW_BYTES), 1);
          wgmma_commit();
          wgmma_wait<0>();
          if (lane == 0) mbar_arrive(bar(V_EMPTY, sv));
        }

        // the other warpgroup and the loads go on while this one writes its rows
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_lo + 8 * r;
          if (row >= S) continue;
          uint16_t* orow = o + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt)
            *reinterpret_cast<uint32_t*>(orow + dt * 8 + tig * 2) =
                pack_bf16(acc[4 * dt + 2 * r], acc[4 * dt + 2 * r + 1]);
        }
      }
    }
  }
}

#undef TEOCHAT_S2_S

// q, k, v bf16 [B, S, H, 64] read through their strides (in elements; last
// dimension contiguous, the others multiples of 8, the base 16-byte aligned:
// what a tensor map takes); o bf16 [B, S, H, 64] contiguous. Returns 0, the
// error of the maps' encoding, or cudaGetLastError() after the launch.
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int bh,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh, float scale,
           void* stream) {
  if (B <= 0 || S <= 0 || S > MAX_SEQ || H <= 0 || bh <= 0 || H % bh || !(scale > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  int q_rows_first, k_rows_first, v_rows_first;
  int err = encode_bf16_rows_map(&q_map, &q_rows_first, q, B, S, H, D, q_sb, q_ss, q_sh, TILE_Q);
  if (!err) err = encode_bf16_rows_map(&k_map, &k_rows_first, k, B, S, H, D, k_sb, k_ss, k_sh, KV_BOX_ROWS);
  if (!err) err = encode_bf16_rows_map(&v_map, &v_rows_first, v, B, S, H, D, v_sb, v_ss, v_sh, KV_BOX_ROWS);
  if (err) return err;
  const int order = q_rows_first | (k_rows_first << 1) | (v_rows_first << 2);
  int device = 0, sms = 0;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess) cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // above 48 KB shared memory is dynamic and has to be asked for; the
  // attribute belongs to the device the launch goes to, so it is set each time
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(bench_vit_attention_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const long long items =
      static_cast<long long>((S + NWG * TILE_Q - 1) / (NWG * TILE_Q)) * (H / bh) * B;
  const int blocks = static_cast<int>(items < sms ? items : sms);  // one block an SM
  bench_vit_attention_kernel<<<blocks, NTHREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, order, static_cast<uint16_t*>(o), B, S, H, bh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S2-b: [B, S, H, 64], `bh` heads a work item; bh must divide H.
extern "C" int teochat_bench_vit_attention_b(const void* q, const void* k, const void* v,
                                             void* o, int B, int S, int H, int D_, int bh,
                                             long long q_sb, long long q_ss, long long q_sh,
                                             long long k_sb, long long k_ss, long long k_sh,
                                             long long v_sb, long long v_ss, long long v_sh,
                                             float scale, void* stream) {
  if (D_ != D) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, o, B, S, H, bh, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                scale, stream);
}

// S2-c: q, k, v, o contiguous [BH, S, 64], read as BH frames of one head.
extern "C" int teochat_bench_vit_attention_c(const void* q, const void* k, const void* v,
                                             void* o, int BH, int S, int D_, float scale,
                                             void* stream) {
  if (D_ != D) return static_cast<int>(cudaErrorInvalidValue);
  const long long sb = static_cast<long long>(S) * D;
  return launch(q, k, v, o, BH, S, 1, 1, sb, D, D, sb, D, D, sb, D, D, scale, stream);
}
