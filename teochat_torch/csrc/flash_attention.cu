// Flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces teochat_tpu/ops/flash_attention.py::_flash_kernel (driven there by
// _flash_bhsd / flash_attention; K1, inference) and, with the STATS flag,
// ::_flash_fwd_res_kernel (K4a, the training forward, which also stores each
// row's m and l for the backward in flash_attention_bwd.cu). It computes
// what those kernels compute:
// tiled online-softmax attention with fp32 running max, denominator and
// accumulator; P is rounded to bf16 before P V; causal kv tiles above the
// diagonal are skipped and the diagonal tile is masked per element; GQA query
// head h reads kv head h / (H / Hkv); a row whose denominator is 0 is written
// as 0 (the `l == 0` guard). With the BIAS flag (the `has_bias_k` branch
// of both TPU kernels: ALiBi, the MPT backend) a key-separable fp32 table
// bias [H, T] is added to each scaled score by query head and key before the
// causal mask, and the row maximum is taken over the biased scores.
//
// What bounds it on an H100: at prefill and training lengths (S >= 512,
// D = 128) the two products Q K^T and P V, that is tensor-core operations;
// the bytes of q, k, v and o alone would take a sixth of that time or less.
// Only `wgmma` reaches the tensor cores' full rate, and it reads its B
// operand from shared memory. Next in line is the softmax: an SM does 16
// exponentials a clock against 2,048 tensor-core multiply-adds, so at
// D = 128 the exponentials of a tile take half as long as its products, and
// they have to run while the tensor cores are busy, not in between. The
// design (hopper_async.cuh has the pieces):
// - one block an SM, which walks over many query tiles of BQ = 128 rows:
//   two consumer warpgroups of 64 rows each, and one producer warp. K and V
//   are read once for every 128 query rows. A work item pairs a long causal
//   tile with a short one, so every item costs the same and handing them out
//   in turn balances the SMs; neighbouring SMs work on the same head, which
//   keeps its K and V in the L2;
// - the producer loads a tile's Q and walks its kv tiles of BK = 128 keys
//   through a ring of two stages: one TMA load a 64-column box, written
//   with the 128-byte swizzle that `wgmma` reads without bank conflicts,
//   its arrival counted on the stage's `full` mbarrier. K and V have
//   barriers of their own, and so has Q, so the next tile's Q, K and V
//   arrive while the consumers finish this one and write it out: a block's
//   start-up is paid once, not once a tile. `setmaxnreg` hands the
//   producer's registers to the consumers. TMA fills rows past the tensor's
//   end with zeros, so no load is guarded;
// - a consumer multiplies Q (shared memory) by K (shared memory, K-major)
//   into 64 score registers a thread, runs the softmax there in base 2 (the
//   scale rides on the exponent's multiply-add; row maximum over the quad by
//   shuffles; the denominator is kept as a per-thread partial sum until the
//   end, since a row's rescale factor is the same on the quad's four
//   lanes), packs P to bf16 as the register A operand of the second
//   product, and multiplies by V read MN-major (`tnspB`) from the tile as it
//   was loaded: no transposed copy, and the score tile never visits shared
//   memory. After each product it arrives on the stage's `empty` barrier,
//   which the producer waits on before it overwrites the stage;
// - the two consumer warpgroups take turns at the tensor cores (a pair of
//   named barriers): a turn is P V of one kv tile and Q K^T of the next, and
//   while one warpgroup has the turn the other runs its softmax. Left to
//   themselves they would wait for the same stage, multiply together and
//   then both leave the tensor cores idle for a softmax.
//
// q, k and v are read as [B, S|T, H|Hkv, D] through their strides (the last
// dimension contiguous, the others multiples of 8 elements, the base aligned
// to 16 bytes: what a tensor map takes), with no copy; o is contiguous
// [B, S, H, D], m and l fp32 [B, H, S]. Keys past T score MASK_VALUE; rows
// past S are computed on zeros and written nowhere. Causal masking assumes
// S == T (a self-attention prefill), as the TPU kernel does.
//
// The bias branch. MPT sizes its table to the KV cache (T_max slots), so a
// prefill's biases are large negative numbers (-slope (T_max - 1 - key), down
// to ~-3,400 for the first head at 4,096 slots, where an fp32 ulp is ~2.4e-4).
// Softmax does not move when a row's scores shift together, so each head's
// table is taken relative to its last key's bias, bref = bias[h, T - 1]:
// the scores then lie within slope x T of 0, where a base-2 score's
// roundings are ~10x finer, and bref comes back only into m (K4a's statistic).
// The table is read as given: rows `bias_sh` floats apart (a cache-sized
// table's first T columns, read in place), by plain cached global loads, each
// thread loading the 2 x BK / 8 columns of its score fragment once a kv tile,
// where it applies them to both of its rows; a key at or past T reads 0 (TMA's
// zero fill covers K and V there, not the table). A score becomes
// s c2 + (bias - bref) log2(e) in one fma, is masked after that, and the
// softmax runs on it with a unit multiplier. The bias-free instantiations
// compile as before.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper_async.cuh"
#include "mma_bf16.cuh"

// The tile sizes and the ring's depth; chip_probe.py builds this file with
// other values to time them.
#ifndef TEOCHAT_FLASH_BQ
#define TEOCHAT_FLASH_BQ 128
#endif
#ifndef TEOCHAT_FLASH_BK
#define TEOCHAT_FLASH_BK 128
#endif
#ifndef TEOCHAT_FLASH_STAGES
#define TEOCHAT_FLASH_STAGES 2
#endif

namespace {

using namespace teochat;

constexpr int BQ = TEOCHAT_FLASH_BQ;  // query rows per block: 64 a consumer warpgroup
constexpr int BK = TEOCHAT_FLASH_BK;  // keys per kv tile
constexpr int NWG = BQ / 64;          // consumer warpgroups
constexpr int STAGES = TEOCHAT_FLASH_STAGES;  // kv tiles in flight
constexpr int NTHREADS = (NWG + 1) * 128;
static_assert(BQ == 64 || BQ == 128, "one or two consumer warpgroups");
static_assert(BK == 64 || BK == 128, "a kv tile is one or two 64-key wgmma widths");
// registers a thread after setmaxnreg: (consumers + producer) * 128 threads
// must fit the SM's 65,536, with two blocks an SM where one warpgroup consumes
constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 216;
constexpr int PRODUCER_REGS = NWG == 2 ? 24 : 40;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

enum Barrier { K_FULL = 0, V_FULL = 1, K_EMPTY = 2, V_EMPTY = 3 };
constexpr uint32_t N_BARRIERS = 2 + 4 * STAGES;  // Q's two, then four a stage

template <int D>
constexpr size_t smem_bytes() {
  // 1024 to align the tiles, Q, the K and V rings, the barriers
  return 1024 + size_t(BQ + 2 * STAGES * BK) * D * 2 + 8 * N_BARRIERS;
}

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The box of `map` that starts at column d0 of row `row` of head `head`.
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int rows_first, int d0, int row, int head, int b) {
  tma_load_4d(dst, map, bar, d0, rows_first ? row : head, rows_first ? head : row, b);
}

// One query tile of one head: its first row and the kv tiles it walks.
struct Tile {
  int b, h, q0, n_kv;
};

// The query tiles a block works through, in order. A work item is one head's
// causal tiles qt and n_qt - 1 - qt together (every item then walks
// n_qt + 1 kv tiles, so handing items out in turn balances the SMs), or one
// tile of a non-causal call. Items that follow each other belong to the
// same head or its neighbour and run at the same time on neighbouring SMs,
// which keeps K and V in the L2 while they are needed.
struct TileWalk {
  int n_qt, per_head, n_items, H, T, causal;
  int item, half;

  __device__ TileWalk(int S, int T_, int H_, int B, int causal_)
      : n_qt((S + BQ - 1) / BQ), H(H_), T(T_), causal(causal_), item(blockIdx.x), half(0) {
    per_head = causal ? (n_qt + 1) / 2 : n_qt;
    n_items = per_head * H * B;
  }

  __device__ bool next(Tile& t) {
    if (item >= n_items) return false;
    const int bh = item / per_head, pi = item % per_head;
    const int far = n_qt - 1 - pi;  // the long tile first
    const int qt = !causal ? pi : half == 0 ? far : pi;
    t.b = bh / H, t.h = bh % H, t.q0 = qt * BQ;
    t.n_kv = (T + BK - 1) / BK;
    if (causal) t.n_kv = min(t.n_kv, (t.q0 + BQ - 1) / BK + 1);
    if (causal && half == 0 && far != pi) {
      half = 1;
    } else {
      half = 0, item += gridDim.x;
    }
    return true;
  }
};

// STATS (K4a, the training forward) also writes each row's running max m
// and denominator l, fp32 [B, H, S], for the backward kernels. `order` says
// for q (bit 0), k (bit 1) and v (bit 2) whether the map has rows before heads.
// BIAS adds bias[h * bias_sh + key] to each scaled score (unread otherwise).
template <int D, bool STATS, bool BIAS>
__global__ void __launch_bounds__(NTHREADS, NWG == 1 ? 2 : 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, int order,
                 uint16_t* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                 const float* __restrict__ bias, long long bias_sh,
                 int B, int S, int T, int H, int Hkv, float scale, int causal) {
  constexpr int BOXES = D / 64;  // 64-column boxes a row
  constexpr uint32_t Q_BOX = BQ * SWIZZLE_ROW_BYTES, KV_BOX = BK * SWIZZLE_ROW_BYTES;
  constexpr uint32_t Q_BYTES = BOXES * Q_BOX, KV_BYTES = BOXES * KV_BOX;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + Q_BYTES;
  const uint32_t v_s = k_s + STAGES * KV_BYTES;
  const uint32_t q_full = v_s + STAGES * KV_BYTES, q_empty = q_full + 8;
  auto bar = [q_full](Barrier kind, int stage) {
    return q_full + 8u * (2 + kind * STAGES + stage);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);  // the producer's arrival, with the bytes to come
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

  TileWalk walk(S, T, H, B, causal);
  Tile tile;
  // tiles and kv tiles this block has started: they number the barriers'
  // phases, the same on the producer's and the consumers' side
  int n_tiles = 0, n_kv_tiles = 0;

  const int wg = threadIdx.x >> 7;
  if (wg == NWG) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != NWG * 128) return;
    tma_prefetch_map(&q_map);
    tma_prefetch_map(&k_map);
    tma_prefetch_map(&v_map);
    while (walk.next(tile)) {
      const int hk = tile.h / (H / Hkv);
      // a fresh buffer is free at once; a used one when its readers have arrived
      mbar_wait(q_empty, (n_tiles & 1) ^ 1);
      mbar_arrive_expect_tx(q_full, Q_BYTES);
#pragma unroll
      for (int c = 0; c < BOXES; ++c)
        load_rows(q_s + c * Q_BOX, &q_map, q_full, order & 1, c * 64, tile.q0, tile.h, tile.b);
      for (int j = 0; j < tile.n_kv; ++j, ++n_kv_tiles) {
        const int st = n_kv_tiles % STAGES;
        const uint32_t reuse = ((n_kv_tiles / STAGES) & 1) ^ 1;
        mbar_wait(bar(K_EMPTY, st), reuse);
        mbar_arrive_expect_tx(bar(K_FULL, st), KV_BYTES);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          load_rows(k_s + st * KV_BYTES + c * KV_BOX, &k_map, bar(K_FULL, st), order & 2, c * 64,
                    j * BK, hk, tile.b);
        mbar_wait(bar(V_EMPTY, st), reuse);
        mbar_arrive_expect_tx(bar(V_FULL, st), KV_BYTES);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          load_rows(v_s + st * KV_BYTES + c * KV_BOX, &v_map, bar(V_FULL, st), order & 4, c * 64,
                    j * BK, hk, tile.b);
      }
      ++n_tiles;
    }
  } else {
    // ------------------------------------------------------------ consumer
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;  // fragment coordinates
    const float c2 = scale * LOG2E;             // scores in base-2 units
    const uint64_t q_desc = smem_desc_k_major(q_s + wg * 64 * SWIZZLE_ROW_BYTES);

    // The two warpgroups take turns at the tensor cores: one multiplies
    // while the other runs its softmax. A warpgroup waits for its turn on
    // its own named barrier and ends it by arriving on the other's; the
    // second warpgroup gives the first its opening turn.
    constexpr int TURN = 1;  // named barriers TURN and TURN + 1
    auto take_turn = [wg] { if (NWG == 2) named_bar_sync(TURN + wg, 256); };
    auto pass_turn = [wg] { if (NWG == 2) named_bar_arrive(TURN + (wg ^ 1), 256); };
    if (NWG == 2 && wg == 1) named_bar_arrive(TURN, 256);

    float s[BK / 2];
    // S = Q K^T for this warpgroup's 64 rows x the BK keys of kv tile `n`
    // of the block's count; the last one of a query tile frees Q as well
    auto scores = [&](int n, bool last) {
      const int st = n % STAGES;
      mbar_wait(bar(K_FULL, st), (n / STAGES) & 1);
      const uint64_t k_desc = smem_desc_k_major(k_s + st * KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk % 4) * 32;  // four 16-deep steps a 64-column box
        wgmma_ss(s, desc_advance(q_desc, (kk / 4) * Q_BOX + in_box),
                 desc_advance(k_desc, (kk / 4) * KV_BOX + in_box), kk != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) {
        mbar_arrive(bar(K_EMPTY, st));
        if (last) mbar_arrive(q_empty);
      }
    };

    while (walk.next(tile)) {
      const int row_lo = tile.q0 + wg * 64 + warp * 16 + gid;  // this thread's rows: row_lo, + 8
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};  // base-2 units
      float l_run[2] = {0.f, 0.f};              // this thread's share of the row's sum
      // the head's reference bias (see the note at the top); 0 without a bias
      const float* brow = BIAS ? bias + tile.h * bias_sh : nullptr;
      const float bref = BIAS && T > 0 ? __ldg(brow + T - 1) : 0.f;

      mbar_wait(q_full, n_tiles & 1);
      mbar_wait(bar(K_FULL, n_kv_tiles % STAGES), (n_kv_tiles / STAGES) & 1);
      take_turn();
      scores(n_kv_tiles, tile.n_kv == 1);
      pass_turn();

      for (int j = 0; j < tile.n_kv; ++j, ++n_kv_tiles) {
        const int k0 = j * BK;
        if constexpr (BIAS) {
          // s c2 + (bias - bref) log2(e): a thread's keys are
          // k0 + 8 nt + 2 tig + e, the same for its two rows, so each bias
          // is loaded once a tile
#pragma unroll
          for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + nt * 8 + tig * 2 + e;
              const float bl = col < T ? (__ldg(brow + col) - bref) * LOG2E : 0.f;
              s[4 * nt + e] = fmaf(s[4 * nt + e], c2, bl);
              s[4 * nt + 2 + e] = fmaf(s[4 * nt + 2 + e], c2, bl);
            }
          }
        }
        // mask (ragged keys and the causal diagonal) where the tile needs it
        if (k0 + BK > T || (causal && k0 + BK - 1 > row_lo - gid)) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int row = row_lo + ((i >> 1) & 1) * 8;
            const int col = k0 + (i >> 2) * 8 + tig * 2 + (i & 1);
            if (col >= T || (causal && col > row)) s[i] = MASK_VALUE;
          }
        }
        // The scale into base-2 units rides on the exponent's multiply-add:
        // p = 2^(s c2 - m), the row maximum taken over the raw scores. That
        // needs c2 > 0; any other scale is multiplied in first. A masked score
        // is MASK_VALUE before the scale: times c2 it stays far below any
        // real score (or overflows to -inf, which masks as well).
        float mul = c2;
        if (BIAS) {
          mul = 1.f;  // the scale is in the scores already
        } else if (!(c2 > 0.f)) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) s[i] = s[i] == MASK_VALUE ? MASK_VALUE : s[i] * c2;
          mul = 1.f;
        }

        // online softmax; a row's BK scores are spread over the 4 lanes of a quad
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};  // four chains, not one
#pragma unroll
          for (int nt = 0; nt < BK / 8; ++nt)
            mx[nt & 3] = fmaxf(mx[nt & 3], fmaxf(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]));
          float top = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
          top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
          top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
          const float m_next = fmaxf(m_run[r], top * mul);
          alpha[r] = exp2_fast(m_run[r] - m_next);
          m_run[r] = m_next;
          float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int nt = 0; nt < BK / 8; ++nt) {
            s[4 * nt + 2 * r] = exp2_fast(fmaf(s[4 * nt + 2 * r], mul, -m_next));
            s[4 * nt + 2 * r + 1] = exp2_fast(fmaf(s[4 * nt + 2 * r + 1], mul, -m_next));
            sum[nt & 3] += s[4 * nt + 2 * r] + s[4 * nt + 2 * r + 1];
          }
          l_run[r] = alpha[r] * l_run[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
        }

        // P as the A operand of P V: registers 8 kk .. 8 kk + 7 are step kk
        uint32_t p[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

        // this turn: acc += P V (V read MN-major from the tile as it was
        // loaded), then the next tile's scores
        const int st = n_kv_tiles % STAGES;
        mbar_wait(bar(V_FULL, st), (n_kv_tiles / STAGES) & 1);
        take_turn();
        const uint64_t v_desc = smem_desc_mn_major(v_s + st * KV_BYTES, KV_BOX);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_tb(acc, p[kk], desc_advance(v_desc, kk * 16 * SWIZZLE_ROW_BYTES), 1);
        wgmma_commit();
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(bar(V_EMPTY, st));
        if (j + 1 < tile.n_kv) scores(n_kv_tiles + 1, j + 2 == tile.n_kv);
        pass_turn();
      }
      ++n_tiles;

      // the other warpgroup and the loads go on while this one writes its rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int row = row_lo + 8 * r;
        if (row >= S) continue;
        if (STATS && tig == 0) {  // m and l are the same on the 4 lanes of a quad
          const long long idx = (static_cast<long long>(tile.b) * H + tile.h) * S + row;
          m_out[idx] = m_run[r] * LN2 + bref;  // back to natural units: p = exp(s - m)
          l_out[idx] = l;
        }
        const float inv = l == 0.f ? 1.f : 1.f / l;
        uint16_t* orow = o + ((static_cast<long long>(tile.b) * S + row) * H + tile.h) * D;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<uint32_t*>(orow + dt * 8 + tig * 2) =
              pack_bf16(acc[4 * dt + 2 * r] * inv, acc[4 * dt + 2 * r + 1] * inv);
      }
    }
  }
}

template <int D, bool STATS, bool BIAS>
int launch_kernel(const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map,
                  int order, void* o, float* m, float* l, const float* bias, long long bias_sh,
                  int B, int S, int T, int H, int Hkv, float scale, int causal, void* stream) {
  // above 48 KB shared memory is dynamic and has to be asked for; the
  // attribute belongs to the device the launch goes to, so it is set each time
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, STATS, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<D>()));
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block an SM (two where one warpgroup consumes), each walking its share of the items
  const long long n_qt = (S + BQ - 1) / BQ;
  const long long items = (causal ? (n_qt + 1) / 2 : n_qt) * H * B;
  const int blocks = static_cast<int>(items < sms * (3 - NWG) ? items : sms * (3 - NWG));
  flash_fwd_kernel<D, STATS, BIAS><<<blocks, NTHREADS, smem_bytes<D>(),
                                     static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, order, static_cast<uint16_t*>(o), m, l, bias, bias_sh, B, S, T, H,
      Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Encodes the three tensor maps from the pointers and strides of this call
// (nothing is kept between calls), then launches: the BIAS instantiation
// where a table is given, else the bias-free one.
template <bool STATS>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* m, float* l,
               const float* bias, long long bias_sh, int B, int S, int T, int H, int Hkv, int D,
               long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_st, long long k_sh,
               long long v_sb, long long v_st, long long v_sh,
               float scale, int causal, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  int q_rows_first, k_rows_first, v_rows_first;
  int err = encode_bf16_rows_map(&q_map, &q_rows_first, q, B, S, H, D, q_sb, q_ss, q_sh, BQ);
  if (!err) err = encode_bf16_rows_map(&k_map, &k_rows_first, k, B, T, Hkv, D, k_sb, k_st, k_sh, BK);
  if (!err) err = encode_bf16_rows_map(&v_map, &v_rows_first, v, B, T, Hkv, D, v_sb, v_st, v_sh, BK);
  if (err) return err;
  const int order = q_rows_first | (k_rows_first << 1) | (v_rows_first << 2);
  auto go = [&](auto kernel) {
    return kernel(q_map, k_map, v_map, order, o, m, l, bias, bias_sh, B, S, T, H, Hkv, scale,
                  causal, stream);
  };
  if (D == 128) return bias ? go(launch_kernel<128, STATS, true>) : go(launch_kernel<128, STATS, false>);
  return bias ? go(launch_kernel<64, STATS, true>) : go(launch_kernel<64, STATS, false>);
}

}  // namespace

// K1, the inference forward. `bias` is the key-separable table
// (`has_bias_k`): fp32 [H, T], rows bias_sh floats apart, each row
// contiguous; null (and bias_sh 0) for none. Returns 0, or the error of the
// tensor maps' encoding or of the launch.
extern "C" int teochat_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    int B, int S, int T, int H, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long bias_sh,
    float scale, int causal, void* stream) {
  return launch_fwd<false>(q, k, v, o, nullptr, nullptr, static_cast<const float*>(bias),
                           bias_sh, B, S, T, H, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_st, k_sh,
                           v_sb, v_st, v_sh, scale, causal, stream);
}

// K4a, the training forward: K1 plus m and l (fp32 [B, H, S], contiguous),
// of the biased scores where a bias is given.
// Replaces teochat_tpu/ops/flash_attention.py::_flash_fwd_res_kernel, whose
// statistics are padded to 128 lanes for the TPU's tiling; here one float a row.
extern "C" int teochat_flash_attention_fwd_res(
    const void* q, const void* k, const void* v, void* o, void* m, void* l, const void* bias,
    int B, int S, int T, int H, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long bias_sh,
    float scale, int causal, void* stream) {
  return launch_fwd<true>(q, k, v, o, static_cast<float*>(m), static_cast<float*>(l),
                          static_cast<const float*>(bias), bias_sh, B, S, T, H, Hkv, D,
                          q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                          scale, causal, stream);
}
