// One-shot bidirectional attention for the ViT (sm_90a), bf16 in and out.
//
// Replaces teochat_tpu/ops/vit_attention.py::_attn_kernel (K5), driven there
// by _vit_attention_pallas / vit_attention. It computes what that kernel
// computes: scores s = q k^T * scale in fp32 with keys past the sequence
// masked, each row's maximum m over all its keys, p = exp(s - m), l = sum p
// in fp32, and o = (bf16(p) v) / l with an fp32 accumulator. Head dim 64,
// 64 <= S <= 1024 (the gate of ops/vit_attention.py).
//
// What bounds it on an H100: at the tower's shape (S = 257, D = 64) the
// bytes of q, k, v and o (one read and one write each) take about as long
// as the two products on the tensor cores, and the exponentials (one a
// score; an SM does 16 a clock) take as long again. So every score is
// computed once, the products run on `wgmma`, the loads run ahead of the
// arithmetic, and enough blocks are in flight to fill the card.
//
// Design (hopper_async.cuh has the pieces):
// - keys come in windows of WINDOW = 272 (256 + 16: S = 257 in one window,
//   6 % of it padding). A window's scores are two products, Q K^T at N 256
//   and at N 16, whose 136 fp32 registers a thread hold a 64-row query
//   tile's whole key row: up to S = 272 the softmax is exact, with no
//   rescale, as the TPU kernel's. A longer sequence (a 336-pixel tower's
//   577, or the gate's 1024) walks several windows with one online rescale
//   of the accumulator between them;
// - one producer warp loads, by TMA with the 128-byte swizzle that `wgmma`
//   reads without bank conflicts, each query tile (64 rows a consumer
//   warpgroup) and each window's K and V (two boxes of 136 rows each)
//   through a ring of stages with `full` and `empty` mbarriers; q, k and v
//   are read as [B, S, H, 64] through their strides (a tensor map each), and
//   TMA fills rows past S with zeros, so no load is guarded;
// - a consumer warpgroup multiplies Q (shared memory) by K (K-major), masks
//   the keys past S, takes each row's maximum over the quad's four lanes,
//   exponentiates in base 2 (the scale rides on the exponent's multiply-add),
//   packs P to bf16 as the register A operand of P V, and multiplies by V
//   read MN-major (`tnspB`) from the window as it was loaded: 17 steps of 16
//   keys. Nothing but o leaves the SM;
// - persistent blocks, one an SM, walk work items in turn: a work item is
//   one head of one frame and two consecutive query tiles, one for each of
//   the block's two consumer warpgroups, which share each window's K and V;
//   a ring of two windows lets the next item's loads run while this one
//   computes. One consumer warpgroup a block (a 2-frame request's 32 (frame,
//   head) pairs then make 160 items, not 96) was slower at every shape
//   timed, the 2-frame one included (PERF.md, section 6).
// o is contiguous [B, S, H, 64]; rows past S are computed on zeros and
// written nowhere, and a warpgroup whose whole tile lies past S only keeps
// the barriers' count.

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
constexpr int KV_BOX_ROWS = WINDOW / 2;       // a TMA box: at most 256 rows
constexpr uint32_t Q_BYTES = TILE_Q * SWIZZLE_ROW_BYTES;
constexpr uint32_t WINDOW_BYTES = WINDOW * SWIZZLE_ROW_BYTES;
constexpr uint32_t KV_BOX_BYTES = KV_BOX_ROWS * SWIZZLE_ROW_BYTES;
static_assert(KV_BOX_BYTES % SWIZZLE_ATOM_BYTES == 0, "a box keeps the swizzle's 1024-byte period");
constexpr float LOG2E = 1.4426950408889634f;

enum Barrier { K_FULL = 0, V_FULL = 1, K_EMPTY = 2, V_EMPTY = 3 };

constexpr int NWG = 2;                      // consumer warpgroups a block
constexpr int STAGES = 2;                   // windows in flight
constexpr int NTHREADS = (NWG + 1) * 128;   // the producer is a warpgroup's slot
// The block is launched with 168 registers a thread (65,536 / 384, rounded
// down to 8); setmaxnreg moves the producer's to the consumers:
// 256 x 240 + 128 x 24 = 384 x 168.
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
constexpr size_t SMEM = 1024 + NWG * Q_BYTES + 2 * STAGES * WINDOW_BYTES + 8 * (2 + 4 * STAGES);

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

// Register i of the window's scores: sa (keys 0-255) then sb (keys 256-271).
// Its key is 8 (i / 4) + 2 tig + (i % 2) into the window, whichever array it is in.
#define TEOCHAT_VIT_S(i) ((i) < 2 * KEYS_A / 4 ? sa[(i)] : sb[(i) - 2 * KEYS_A / 4])

// `order` says for q (bit 0), k (bit 1) and v (bit 2) whether the map has
// rows before heads.
__global__ void __launch_bounds__(NTHREADS, 1)
vit_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, int order,
                     uint16_t* __restrict__ o, int B, int S, int H, float scale) {
  constexpr int NS = WINDOW / 2;  // score registers a thread: 64 rows x 272 keys / 128 threads

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

  // work items: two query tiles of one (frame, head), the tiles of a head
  // next to each other, handed out to the blocks in turn
  const int n_qt = (S + NWG * TILE_Q - 1) / (NWG * TILE_Q);
  const int n_items = n_qt * H * B;
  const int n_win = (S + WINDOW - 1) / WINDOW;
  int n_items_done = 0, n_windows = 0;  // the barriers' phases, counted alike on both sides

  const int wg = threadIdx.x >> 7;
  if (wg == NWG) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != NWG * 128) return;
    tma_prefetch_map(&q_map);
    tma_prefetch_map(&k_map);
    tma_prefetch_map(&v_map);
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n_items_done) {
      const int qt = item % n_qt, bh = item / n_qt, b = bh / H, h = bh % H;
      // a fresh buffer is free at once; a used one when its readers have arrived
      mbar_wait(q_empty, (n_items_done & 1) ^ 1);
      mbar_arrive_expect_tx(q_full, NWG * Q_BYTES);
#pragma unroll
      for (int c = 0; c < NWG; ++c)
        load_rows(q_s + c * Q_BYTES, &q_map, q_full, order & 1, (qt * NWG + c) * TILE_Q, h, b);
      for (int w = 0; w < n_win; ++w, ++n_windows) {
        const int st = n_windows % STAGES;
        const uint32_t reuse = ((n_windows / STAGES) & 1) ^ 1;
        mbar_wait(bar(K_EMPTY, st), reuse);
        mbar_arrive_expect_tx(bar(K_FULL, st), WINDOW_BYTES);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          load_rows(k_s + st * WINDOW_BYTES + c * KV_BOX_BYTES, &k_map, bar(K_FULL, st),
                    order & 2, w * WINDOW + c * KV_BOX_ROWS, h, b);
        mbar_wait(bar(V_EMPTY, st), reuse);
        mbar_arrive_expect_tx(bar(V_FULL, st), WINDOW_BYTES);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          load_rows(v_s + st * WINDOW_BYTES + c * KV_BOX_BYTES, &v_map, bar(V_FULL, st),
                    order & 4, w * WINDOW + c * KV_BOX_ROWS, h, b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumer
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;  // fragment coordinates
    const float c2 = scale * LOG2E;             // scores in base-2 units
    const uint64_t q_desc = smem_desc_k_major(q_s + wg * Q_BYTES);

    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n_items_done) {
      const int qt = item % n_qt, bh = item / n_qt, b = bh / H, h = bh % H;
      const int tile0 = (qt * NWG + wg) * TILE_Q;
      const int row_lo = tile0 + warp * 16 + gid;  // this thread's rows: row_lo, + 8
      const bool idle = tile0 >= S;                // the whole tile lies past S
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};  // base-2 units
      float l_run[2] = {0.f, 0.f};              // this thread's share of the row's sum

      mbar_wait(q_full, n_items_done & 1);
      for (int w = 0; w < n_win; ++w, ++n_windows) {
        const int st = n_windows % STAGES;
        const uint32_t parity = (n_windows / STAGES) & 1;
        const bool last = w + 1 == n_win;
        mbar_wait(bar(K_FULL, st), parity);
        if (idle) {  // keep the count: wait for each stage, then free it
          mbar_wait(bar(V_FULL, st), parity);
          if (lane == 0) {
            mbar_arrive(bar(K_EMPTY, st));
            mbar_arrive(bar(V_EMPTY, st));
            if (last) mbar_arrive(q_empty);
          }
          continue;
        }

        // S = Q K^T over the window: keys 0-255 into sa, 256-271 into sb
        float sa[2 * KEYS_A / 4], sb[2 * KEYS_B / 4];
        const uint64_t k_desc = smem_desc_k_major(k_s + st * WINDOW_BYTES);
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
        if (lane == 0) {
          mbar_arrive(bar(K_EMPTY, st));
          if (last) mbar_arrive(q_empty);
        }

        // keys past S score MASK_VALUE (TMA read them as zeros)
        const int k0 = w * WINDOW;
        if (k0 + WINDOW > S) {
#pragma unroll
          for (int i = 0; i < NS; ++i)
            if (k0 + 8 * (i >> 2) + 2 * tig + (i & 1) >= S) TEOCHAT_VIT_S(i) = MASK_VALUE;
        }
        // p = 2^(s c2 - m), the maximum taken over the raw scores; that needs
        // c2 > 0, and any other scale is multiplied in first. A masked score
        // times c2 stays far below any real one (or overflows to -inf).
        float mul = c2;
        if (!(c2 > 0.f)) {
#pragma unroll
          for (int i = 0; i < NS; ++i)
            TEOCHAT_VIT_S(i) = TEOCHAT_VIT_S(i) == MASK_VALUE ? MASK_VALUE : TEOCHAT_VIT_S(i) * c2;
          mul = 1.f;
        }

        // the window's softmax; a row's keys are spread over the 4 lanes of a quad
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};  // four chains, not one
#pragma unroll
          for (int nt = 0; nt < NS / 4; ++nt)
            mx[nt & 3] = fmaxf(mx[nt & 3], fmaxf(TEOCHAT_VIT_S(4 * nt + 2 * r),
                                                 TEOCHAT_VIT_S(4 * nt + 2 * r + 1)));
          float top = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
          top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
          top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
          const float m_next = fmaxf(m_run[r], top * mul);
          alpha[r] = exp2_fast(m_run[r] - m_next);  // 0 in the first window
          m_run[r] = m_next;
          float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int nt = 0; nt < NS / 4; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = TEOCHAT_VIT_S(4 * nt + 2 * r + e);
              x = exp2_fast(fmaf(x, mul, -m_next));
              sum[nt & 3] += x;
            }
          }
          l_run[r] = alpha[r] * l_run[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
        }
        if (w > 0) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        }

        // P as the A operand of P V: registers 8 kk .. 8 kk + 7 are step kk
        uint32_t p[WINDOW / 16][4];
#pragma unroll
        for (int kk = 0; kk < WINDOW / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[kk][e] = pack_bf16(TEOCHAT_VIT_S(8 * kk + 2 * e), TEOCHAT_VIT_S(8 * kk + 2 * e + 1));

        // acc += P V, V read MN-major from the window as it was loaded
        mbar_wait(bar(V_FULL, st), parity);
        const uint64_t v_desc = smem_desc_mn_major(v_s + st * WINDOW_BYTES, WINDOW_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WINDOW / 16; ++kk)
          wgmma_rs_tb(acc, p[kk], desc_advance(v_desc, kk * 16 * SWIZZLE_ROW_BYTES), 1);
        wgmma_commit();
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(bar(V_EMPTY, st));
      }
      if (idle) continue;

      // the other warpgroup and the loads go on while this one writes its rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int row = row_lo + 8 * r;
        if (row >= S) continue;
        const float inv = 1.f / l;  // the row's own maximum contributes 2^0 = 1
        uint16_t* orow = o + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<uint32_t*>(orow + dt * 8 + tig * 2) =
              pack_bf16(acc[4 * dt + 2 * r] * inv, acc[4 * dt + 2 * r + 1] * inv);
      }
    }
  }
}

#undef TEOCHAT_VIT_S

}  // namespace

// K5. q, k, v bf16 [B, S, H, 64] read through their strides (last dimension
// contiguous, the others multiples of 8 elements, the base 16-byte aligned:
// what a tensor map takes); o bf16 [B, S, H, 64] contiguous. The tensor maps
// are encoded on every call from the pointers and strides given. Returns 0,
// the error of the maps' encoding, or cudaGetLastError() after the launch.
extern "C" int teochat_vit_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int S, int H, int D_,
                                     long long q_sb, long long q_ss, long long q_sh,
                                     long long k_sb, long long k_ss, long long k_sh,
                                     long long v_sb, long long v_ss, long long v_sh,
                                     float scale, void* stream) {
  if (D_ != D || B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
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
    cerr = cudaFuncSetAttribute(vit_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(SMEM));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const long long items = static_cast<long long>((S + NWG * TILE_Q - 1) / (NWG * TILE_Q)) * H * B;
  const int blocks = static_cast<int>(items < sms ? items : sms);  // one block an SM
  vit_attention_kernel<<<blocks, NTHREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, order, static_cast<uint16_t*>(o), B, S, H, scale);
  return static_cast<int>(cudaGetLastError());
}
