// Decode attention for Hopper (sm_90a): one query per row against the KV
// cache, bf16 in and out.
//
// Replaces teochat_tpu/ops/decode_attention.py::_decode_kernel (driven there
// by _decode_pallas / decode_attention). It computes what that kernel
// computes: for each row b and query head h, softmax(q . k[t] * scale) over
// the live slots t < lengths[b], applied to v, with an fp32 online softmax;
// the G = H / Hkv query heads of a group share the kv head's reads. Slots past
// a row's length are never read; a row with no live slot is written as 0.
//
// What bounds it on an H100: the bytes of the cache. Each live slot costs
// 2 * D * 2 bytes of K and V per kv head and is used by only G query heads,
// so the arithmetic intensity is about G / 2 FLOP per byte, far below the
// card's ridge. The design reads every live K and V row exactly once, with
// 16-byte loads (8 bf16 per lane, D / 8 lanes per slot), keeps the G queries
// and accumulators in registers, and reads the layer slab of the
// [L, B, T, Hkv, D] cache in place through its strides (no copy per step).
//
// Layout: one block of 8 warps per (kv head, batch row). Each group of
// D / 8 lanes walks its own subset of the slots with a private online-softmax
// state; the states are merged with shuffles inside a warp, then across warps
// in shared memory. At B = 1, Hkv = 32 this fills 32 of 132 SMs: splitting T
// across blocks (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int D, int G>
__global__ void __launch_bounds__(NTHREADS)
decode_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, const int* __restrict__ lengths,
              uint16_t* __restrict__ o, int T, int H,
              long long q_sb, long long q_sh,
              long long k_sb, long long k_sh, long long k_st,
              long long v_sb, long long v_sh, long long v_st, float scale) {
  constexpr int LPK = D / 8;     // lanes per slot
  constexpr int KPW = 32 / LPK;  // slots per warp per step
  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];
  __shared__ float sm_acc[NWARPS][G][D];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPK, dl = lane % LPK;
  const int len = min(max(lengths[b], 0), T);

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
    unpack8(*reinterpret_cast<const uint4*>(q + b * q_sb + (hk * G + g) * q_sh + dl * 8), qf[g]);

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  const uint16_t* kb = k + b * k_sb + hk * k_sh + dl * 8;
  const uint16_t* vb = v + b * v_sb + hk * v_sh + dl * 8;
  // the loop bound is uniform across the warp, so every lane takes part in
  // the shuffles; lanes whose slot is past the length only skip the update
  for (int t0 = warp * KPW; t0 < len; t0 += NWARPS * KPW) {
    const int t = t0 + sub;
    const bool live = t < len;
    float kf[8], vf[8];
    if (live) {
      unpack8(*reinterpret_cast<const uint4*>(kb + t * k_st), kf);
      unpack8(*reinterpret_cast<const uint4*>(vb + t * v_st), vf);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot += qf[g][i] * kf[i];
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (live) {
        const float s = dot * scale;
        const float m_next = fmaxf(m[g], s);
        const float alpha = __expf(m[g] - m_next);
        const float p = __expf(s - m_next);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = acc[g][i] * alpha + p * vf[i];
        m[g] = m_next;
      }
    }
  }

  // merge the slot groups of this warp (partners hold the same dims)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], m_o);
      const float a = mx == -INFINITY ? 0.f : __expf(m[g] - mx);
      const float c = mx == -INFINITY ? 0.f : __expf(m_o - mx);
      l[g] = l[g] * a + l_o * c;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + acc_o * c;
      }
      m[g] = mx;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sm_acc[warp][g][dl * 8 + i] = acc[g][i];
      if (dl == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge across warps and write
  for (int idx = threadIdx.x; idx < G * D; idx += NTHREADS) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, out = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float c = __expf(sm_m[w][g] - mx);
        lsum += sm_l[w][g] * c;
        out += sm_acc[w][g][d] * c;
      }
    }
    out *= lsum == 0.f ? 1.f : 1.f / lsum;
    const __nv_bfloat16 ob = __float2bfloat16_rn(out);
    o[(static_cast<long long>(b) * H + hk * G + g) * D + d] =
        *reinterpret_cast<const uint16_t*>(&ob);
  }
}

template <int D>
int launch_d(int G, dim3 grid, cudaStream_t st, const uint16_t* q, const uint16_t* k,
             const uint16_t* v, const int* lens, uint16_t* o, int T, int H,
             long long q_sb, long long q_sh, long long k_sb, long long k_sh,
             long long k_st, long long v_sb, long long v_sh, long long v_st,
             float scale) {
#define TEOCHAT_DECODE_LAUNCH(GV)                                            \
  decode_kernel<D, GV><<<grid, NTHREADS, 0, st>>>(                           \
      q, k, v, lens, o, T, H, q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, \
      scale)
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
// strides; lengths: [B] int32 on the device; o: contiguous [B, H, D].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int teochat_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    int B, int H, int Hkv, int T, int D,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    float scale, void* stream) {
  const dim3 grid(Hkv, B);
  const int G = H / Hkv;
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<uint16_t*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_d<128>(G, grid, st, qp, kp, vp, lp, op, T, H, q_sb, q_sh,
                         k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale);
  if (D == 64)
    return launch_d<64>(G, grid, st, qp, kp, vp, lp, op, T, H, q_sb, q_sh,
                        k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
