// The int4 unpack variants of the kernel bench, for Hopper (sm_90a).
//
// Replaces the six TPU kernels of scripts/bench_int4_kernel.py: _v2_kernel
// (:55), _v3_kernel (:135), _v4_kernel (:219), _v5_kernel (:281), _vpu_kernel
// (:342) and _dma_kernel (:383). Each computes, for a few rows of x, a product
// with a weight stored as 4-bit values in [n_tiles, byte rows, bn] tiles; they
// differ in which machine operations turn a byte into multiplicands:
//
//   v2   u8 byte p = (L+8) + 16 (H+8), L from row r and H from row k2 + r.
//        y = (xa . (p & 15) + xb . p - 8 (sum xa + 17 sum xb)) * scale with
//        xb = bf16(x_hi / 16), xa = bf16(x_lo - xb): the high nibble is never
//        extracted. One prmt puts the byte under 2^23 (widen and convert in
//        one), one mask on that word gives the low nibble, two subtractions.
//   v3   int8 byte b = (L+8) + 16 H: y = (xa . (b & 15) + xb . b
//        - 8 sum (xa + xb)) * scale. The signed byte is read by flipping its
//        top bit (one xor a word) and subtracting 2^23 + 128. The mask runs
//        on the widened 32-bit value, or (mask16) on the word's two 16-bit
//        halves before the widening.
//   v5   v3 with the low nibbles of four bytes masked by one & 0x0F0F0F0F on
//        the word, then widened by a prmt each.
//   v4   native 4-bit storage: a byte holds the signed values of K rows 2i
//        (low nibble) and 2i + 1 (high). Sign-extend (bfe.s32), convert,
//        multiply: no bias, no xa / xb.
//   vpu  unpack only: per column the sum over byte rows of (lo - 8) + (hi - 8)
//        of the u8 format, padded columns included.
//   dma  no unpack: x_lo . float(byte), no scale: what the bytes and one
//        multiply-add a byte cost.
//
// What bounds them on an H100: at M <= 8 the packed bytes (23 MB for the
// 4096 x 11008 projection, each read once) and, before that, the vector
// operations a byte costs; the products are FMAs in registers, so a variant
// is its decode. All share the byte-streaming skeleton of int4_matmul.cu's
// small-M kernel (a block owns a band of columns and all byte rows; a lane
// reads 4-byte words of 8 consecutive rows and the matching activations with
// 16-byte loads; fp32 accumulators in registers; one reduction at the end),
// with the next step's words loaded a step ahead, so their times differ by
// the decode alone. The row-sum correction is taken
// once a block after the loop. M > 8 runs as row chunks of 8 in grid.y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int ROWS = 8;       // consecutive byte rows a thread takes at a time
constexpr uint32_t MAGIC = 0x4B000000u;  // the float 2^23: an integer < 2^23 or-ed in adds to it
constexpr float TWO23 = 8388608.f;

enum Variant { V2, V3, V3_M16, V5, V4, DMA, VPU };

struct Args {
  const uint16_t* a;     // xa [M, k2]; x_lo (dma); x [M, 2 k2] (v4); unused (vpu)
  const uint16_t* b;     // xb [M, k2] (v2, v3, v5); unused otherwise
  const uint8_t* tiles;  // [n_tiles, k2, tw] bytes
  const float* scale;    // fp32, at least n_out entries (v2-v5)
  void* out;             // bf16 [M, n_out]; fp32 [n_tiles * tw] column sums (vpu)
  int M, k2, tw, n_total, n_out;
  long long a_rs, b_rs;  // row strides of a and b, in elements
  int mask16;            // v3: mask on 16-bit halves instead of the 32-bit value
};

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// byte j of w as the low mantissa bits of 2^23: widen and convert in one prmt
__device__ __forceinline__ uint32_t under_magic(uint32_t w, int j) {
  return __byte_perm(w, MAGIC, 0x7440 | j);
}

__device__ __forceinline__ int bfe_s32(uint32_t w, int pos, int len) {
  int r;
  asm("bfe.s32 %0, %1, %2, %3;" : "=r"(r) : "r"(w), "r"(pos), "r"(len));
  return r;
}

// One 4-byte word (4 columns of one byte row) -> the two multiplicands of each
// column: wa meets the first activation operand, wb the second.
template <int V>
__device__ __forceinline__ void decode(uint32_t w, float (&wa)[4], float (&wb)[4]) {
  if (V == V2 || V == DMA) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t t = under_magic(w, j);
      if (V == DMA) {
        wa[j] = __uint_as_float(t) - TWO23;
        wb[j] = 0.f;
      } else {
        wa[j] = __uint_as_float(t & 0xFFFFFF0Fu) - TWO23;
        wb[j] = __uint_as_float(t) - TWO23;
      }
    }
  } else if (V == V3 || V == V3_M16 || V == V5) {
    const uint32_t s = w ^ 0x80808080u;  // b + 128 in every byte
    uint32_t lo_src[4];
    if (V == V3) {  // mask at 32 bits, after the widening
#pragma unroll
      for (int j = 0; j < 4; ++j) lo_src[j] = under_magic(s, j) & 0xFFFFFF0Fu;
    } else if (V == V3_M16) {  // mask on the two 16-bit halves, then widen
      const uint32_t h[2] = {static_cast<uint16_t>(static_cast<uint16_t>(w) & 0x0F0Fu),
                             static_cast<uint16_t>(static_cast<uint16_t>(w >> 16) & 0x0F0Fu)};
#pragma unroll
      for (int j = 0; j < 4; ++j) lo_src[j] = under_magic(h[j >> 1], j & 1);
    } else {  // v5: one mask a word, then widen
      const uint32_t m = w & 0x0F0F0F0Fu;
#pragma unroll
      for (int j = 0; j < 4; ++j) lo_src[j] = under_magic(m, j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wa[j] = __uint_as_float(lo_src[j]) - TWO23;
      wb[j] = __uint_as_float(under_magic(s, j)) - (TWO23 + 128.f);
    }
  } else if (V == V4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wa[j] = __int2float_rn(bfe_s32(w, 8 * j, 4));
      wb[j] = __int2float_rn(bfe_s32(w, 8 * j + 4, 4));
    }
  } else {  // VPU: both nibbles as K3 decodes them; only their sum is used
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wa[j] = __uint_as_float(MAGIC | ((w >> (8 * j)) & 15u)) - (TWO23 + 8.f);
      wb[j] = __uint_as_float(MAGIC | ((w >> (8 * j + 4)) & 15u)) - (TWO23 + 8.f);
    }
  }
}

// Lane (rg, cg) of a warp owns 4 columns (one 4-byte word a row) and, in each
// step, 8 consecutive byte rows; the 8 weight words of a step are in flight
// together and nothing synchronizes until the final sum over row groups and
// warps. Block (x, y): columns [x BN, x BN + BN), rows [y MT, y MT + MT) of x.
// red and corr_s are the block's shared scratch (SCRATCH below).
template <int V, int MT, int BN>
__device__ __forceinline__ void stream_body(const Args& p, float* red, float* corr_s) {
  constexpr int LPR = BN / 4;   // lanes across one row of the band
  constexpr int RG = 32 / LPR;  // row groups of a warp
  constexpr int STEP = 8 * RG * ROWS;  // byte rows the block takes in one step
  constexpr bool HAS_A = V != VPU;
  constexpr bool HAS_B = V == V2 || V == V3 || V == V3_M16 || V == V5 || V == V4;
  constexpr bool CORR = V == V2 || V == V3 || V == V3_M16 || V == V5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane / LPR, cg = lane % LPR;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MT;
  const int k2 = p.k2;
  // tw is a multiple of 128 >= BN: a band never straddles two tiles
  const uint8_t* wbytes =
      p.tiles + static_cast<long long>(n0 / p.tw) * k2 * p.tw + (n0 % p.tw) + cg * 4;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  // k2 is a multiple of 8: a thread's 8 rows are all inside or all outside.
  // The next step's words are loaded before this step's are decoded, so 8
  // loads a thread stay in flight whatever order the compiler gives the rest.
  uint32_t words[ROWS], ahead[ROWS];
  const int r_first = (warp * RG + rg) * ROWS;
#pragma unroll
  for (int u = 0; u < ROWS; ++u)
    ahead[u] = r_first < k2 ? *reinterpret_cast<const uint32_t*>(
                                  wbytes + static_cast<long long>(r_first + u) * p.tw)
                            : 0u;
#pragma unroll(MT <= 2 ? 2 : 1)
  for (int r = r_first; r < k2; r += STEP) {
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      words[u] = ahead[u];
      if (r + STEP < k2)
        ahead[u] = *reinterpret_cast<const uint32_t*>(
            wbytes + static_cast<long long>(r + STEP + u) * p.tw);
    }
    uint4 xa[MT], xb[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      xa[m] = xb[m] = make_uint4(0, 0, 0, 0);
      if (HAS_A && m0 + m < p.M) {
        if (V == V4) {  // K rows 2r .. 2r + 15 of x, interleaved low / high nibble
          const uint16_t* xr = p.a + (m0 + m) * p.a_rs + 2 * r;
          xa[m] = __ldg(reinterpret_cast<const uint4*>(xr));
          xb[m] = __ldg(reinterpret_cast<const uint4*>(xr + 8));
        } else {
          xa[m] = __ldg(reinterpret_cast<const uint4*>(p.a + (m0 + m) * p.a_rs + r));
          if (HAS_B) xb[m] = __ldg(reinterpret_cast<const uint4*>(p.b + (m0 + m) * p.b_rs + r));
        }
      }
    }
    float wa[ROWS][4], wb[ROWS][4];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) decode<V>(words[u], wa[u], wb[u]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (V == VPU) {  // no product: the decoded values are summed as they are
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] += wa[u][j] + wb[u][j];
      } else {
        float g[16], fa[ROWS], fb[ROWS];
        unpack8(xa[m], g);
        unpack8(xb[m], g + 8);
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          fa[u] = V == V4 ? g[2 * u] : g[u];
          fb[u] = V == V4 ? g[2 * u + 1] : g[8 + u];
        }
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[m][j] = fmaf(fa[u], wa[u][j], acc[m][j]);
            if (HAS_B) acc[m][j] = fmaf(fb[u], wb[u][j], acc[m][j]);
          }
      }
    }
  }

  // sum the row groups of a warp, then the 8 warps through shared memory
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  if (rg == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(warp * MT + m) * BN + cg * 4 + j] = acc[m][j];
  }

  // the correction, once a block: sum over k2 of xa + c xb, c = 17 (v2) or 1
  if (CORR) {
    constexpr float C = V == V2 ? 17.f : 1.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float s = 0.f;
      if (m0 + m < p.M) {
        for (int i = tid * 8; i < k2; i += THREADS * 8) {
          float fa[8], fb[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(p.a + (m0 + m) * p.a_rs + i)), fa);
          unpack8(__ldg(reinterpret_cast<const uint4*>(p.b + (m0 + m) * p.b_rs + i)), fb);
#pragma unroll
          for (int u = 0; u < 8; ++u) s += fa[u] + C * fb[u];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) corr_s[warp * MT + m] = s;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < MT * BN; idx += THREADS) {
    const int m = idx / BN, n = n0 + idx % BN;
    float sum = 0.f;
#pragma unroll
    for (int wq = 0; wq < 8; ++wq) sum += red[wq * MT * BN + idx];
    if (V == VPU) {
      static_cast<float*>(p.out)[n] = sum;  // every column that has bytes, padding included
      continue;
    }
    if (m0 + m >= p.M || n >= p.n_out) continue;
    if (CORR) {
      float c = 0.f;
#pragma unroll
      for (int wq = 0; wq < 8; ++wq) c += corr_s[wq * MT + m];
      sum -= 8.f * c;
    }
    if (V != DMA) sum *= p.scale[n];
    static_cast<uint16_t*>(p.out)[static_cast<long long>(m0 + m) * p.n_out + n] =
        __bfloat16_as_ushort(__float2bfloat16_rn(sum));
  }
}

#define SCRATCH                          \
  __shared__ float red[8 * MT * BN];     \
  __shared__ float corr_s[8 * MT]

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS) bench_int4_v2_kernel(Args p) {
  SCRATCH;
  stream_body<V2, MT, BN>(p, red, corr_s);
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS) bench_int4_v3_kernel(Args p) {
  SCRATCH;
  // the two mask widths are one kernel: the flag is uniform over the grid
  if (p.mask16)
    stream_body<V3_M16, MT, BN>(p, red, corr_s);
  else
    stream_body<V3, MT, BN>(p, red, corr_s);
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS) bench_int4_v4_kernel(Args p) {
  SCRATCH;
  stream_body<V4, MT, BN>(p, red, corr_s);
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS) bench_int4_v5_kernel(Args p) {
  SCRATCH;
  stream_body<V5, MT, BN>(p, red, corr_s);
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS) bench_int4_vpu_kernel(Args p) {
  SCRATCH;
  stream_body<VPU, MT, BN>(p, red, corr_s);
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS) bench_int4_dma_kernel(Args p) {
  SCRATCH;
  stream_body<DMA, MT, BN>(p, red, corr_s);
}

// The band of columns a block owns: 32 columns give the most blocks (N / 32)
// and 32 row groups across K; wider bands (fewer row groups) only once every
// SM would still hold several blocks. `band` != 0 picks it (the tile sweep).
int pick_band(int n_total, int band) {
  if (band) return band;
  int bn = 128;
  while (bn > 32 && (n_total + bn - 1) / bn < 4 * 132) bn /= 2;
  return bn;
}

int check(const Args& p, int band) {
  if (p.k2 <= 0 || p.k2 % 8 || p.tw % 128 || p.n_total <= 0) return 1;
  if (band != 0 && band != 32 && band != 64 && band != 128) return 1;
  return 0;
}

int check_product(const Args& p, int band) {
  if (check(p, band) || p.M <= 0 || p.n_out <= 0 || p.n_out > p.n_total) return 1;
  if (p.a_rs % 8 || p.b_rs % 8) return 1;  // 16-byte activation loads
  return 0;
}

#define LAUNCH_BAND(KERNEL, GRID_Y, ...)                                              \
  do {                                                                                \
    const int bn_ = pick_band(p.n_total, band);                                       \
    const dim3 grid((p.n_total + bn_ - 1) / bn_, GRID_Y);                             \
    if (bn_ == 128)                                                                   \
      KERNEL<128, __VA_ARGS__><<<grid, THREADS, 0, st>>>(p);                          \
    else if (bn_ == 64)                                                               \
      KERNEL<64, __VA_ARGS__><<<grid, THREADS, 0, st>>>(p);                           \
    else                                                                              \
      KERNEL<32, __VA_ARGS__><<<grid, THREADS, 0, st>>>(p);                           \
  } while (0)

// one row of x: MT = 1; more: chunks of 8 rows in grid.y
#define LAUNCH_PRODUCT(KERNEL)                                                        \
  do {                                                                                \
    if (p.M <= 1)                                                                     \
      LAUNCH_BAND(KERNEL, 1, 1);                                                      \
    else                                                                              \
      LAUNCH_BAND(KERNEL, (p.M + 7) / 8, 8);                                          \
  } while (0)

Args product_args(const void* a, const void* b, const void* tiles, const void* scale, void* out,
                  int M, int k2, int n_tiles, int bn, int n_out, long long a_rs, long long b_rs) {
  return Args{static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
              static_cast<const uint8_t*>(tiles), static_cast<const float*>(scale), out,
              M, k2, bn, n_tiles * bn, n_out, a_rs, b_rs, 0};
}

}  // namespace

// S1-v2. xa, xb bf16 [M, k2] contiguous; tiles u8 [n_tiles, k2, bn]; scale fp32
// with at least n_out entries; out bf16 [M, n_out] contiguous. band: 0 (auto),
// 32, 64 or 128 columns a block. Each entry returns cudaGetLastError().
extern "C" int teochat_bench_int4_v2(const void* xa, const void* xb, const void* tiles,
                                     const void* scale, void* out, int M, int k2, int n_tiles,
                                     int bn, int n_out, int band, void* stream) {
  const Args p = product_args(xa, xb, tiles, scale, out, M, k2, n_tiles, bn, n_out, k2, k2);
  if (check_product(p, band)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  LAUNCH_PRODUCT(bench_int4_v2_kernel);
  return static_cast<int>(cudaGetLastError());
}

// S1-v3. As v2 on int8 tiles; mask16 != 0 masks on 16-bit halves.
extern "C" int teochat_bench_int4_v3(const void* xa, const void* xb, const void* tiles,
                                     const void* scale, void* out, int M, int k2, int n_tiles,
                                     int bn, int n_out, int band, int mask16, void* stream) {
  Args p = product_args(xa, xb, tiles, scale, out, M, k2, n_tiles, bn, n_out, k2, k2);
  p.mask16 = mask16;
  if (check_product(p, band)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  LAUNCH_PRODUCT(bench_int4_v3_kernel);
  return static_cast<int>(cudaGetLastError());
}

// S1-v5. As v3 (int8 tiles), the low nibbles masked a word at a time.
extern "C" int teochat_bench_int4_v5(const void* xa, const void* xb, const void* tiles,
                                     const void* scale, void* out, int M, int k2, int n_tiles,
                                     int bn, int n_out, int band, void* stream) {
  const Args p = product_args(xa, xb, tiles, scale, out, M, k2, n_tiles, bn, n_out, k2, k2);
  if (check_product(p, band)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  LAUNCH_PRODUCT(bench_int4_v5_kernel);
  return static_cast<int>(cudaGetLastError());
}

// S1-v4. x bf16 [M, 2 k2] contiguous; tiles [n_tiles, k2, bn] bytes of two
// signed nibbles, K rows 2i (low) and 2i + 1 (high).
extern "C" int teochat_bench_int4_v4(const void* x, const void* tiles, const void* scale,
                                     void* out, int M, int k2, int n_tiles, int bn, int n_out,
                                     int band, void* stream) {
  const Args p = product_args(x, nullptr, tiles, scale, out, M, k2, n_tiles, bn, n_out,
                              2LL * k2, 0);
  if (check_product(p, band)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  LAUNCH_PRODUCT(bench_int4_v4_kernel);
  return static_cast<int>(cudaGetLastError());
}

// S1-dma. x bf16 with row stride x_rs, its first k2 columns are read; tiles u8;
// out bf16 [M, n_out] = x_lo . float(byte), unscaled.
extern "C" int teochat_bench_int4_dma(const void* x, long long x_rs, const void* tiles,
                                      void* out, int M, int k2, int n_tiles, int bn, int n_out,
                                      int band, void* stream) {
  const Args p = product_args(x, nullptr, tiles, nullptr, out, M, k2, n_tiles, bn, n_out,
                              x_rs, 0);
  if (check_product(p, band)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  LAUNCH_PRODUCT(bench_int4_dma_kernel);
  return static_cast<int>(cudaGetLastError());
}

// S1-vpu. tiles u8; colsum fp32 [n_tiles * bn]: per column the sum over byte
// rows of (lo - 8) + (hi - 8).
extern "C" int teochat_bench_int4_vpu(const void* tiles, void* colsum, int k2, int n_tiles,
                                      int bn, int band, void* stream) {
  const Args p = product_args(nullptr, nullptr, tiles, nullptr, colsum, 1, k2, n_tiles, bn,
                              n_tiles * bn, 0, 0);
  if (check(p, band)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  LAUNCH_BAND(bench_int4_vpu_kernel, 1, 1);
  return static_cast<int>(cudaGetLastError());
}
