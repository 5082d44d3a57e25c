// bf16 tensor-core helpers shared by the flash-attention kernels (sm_90a).
//
// One warp issues mma.sync m16n8k16 (bf16 inputs, fp32 accumulation). With
// gid = lane / 4 and tig = lane % 4, the fragments hold:
//   A (16 x 16, row-major):  a0 (gid, 2tig..+1)  a1 (gid+8, 2tig..+1)
//                            a2 (gid, 2tig+8..+9) a3 (gid+8, 2tig+8..+9)
//   B (16 x 8):              b0 (k = 2tig..+1, n = gid)  b1 (k = 2tig+8..+9, n = gid)
//   C (16 x 8, fp32):        c0 (gid, 2tig) c1 (gid, 2tig+1) c2 (gid+8, 2tig) c3 (gid+8, 2tig+1)
// The C fragments of two neighbouring n-tiles are, once packed to bf16, the A
// fragment of one 16-deep step: a score tile becomes the A operand of the
// next product without a trip through shared memory.
//
// Shared-memory tiles are row-major bf16 (uint16_t) with a padded row of `ld`
// elements; the loaders below read one warp's fragment from such a tile.

#pragma once

#include <cuda_bf16.h>

#include <cfloat>
#include <cstdint>

namespace teochat {

constexpr float MASK_VALUE = -0.7f * FLT_MAX;  // teochat_tpu/ops/flash_attention.py:29

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma.sync m16n8k8: A (16 x 8) a0 (gid, 2tig..+1) a1 (gid+8, 2tig..+1), B (8 x 8)
// b0 (k = 2tig..+1, n = gid), C as m16n8k16's.
__device__ __forceinline__ void mma_1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Two floats -> one register of two bf16; `lo` sits in the low half, which
// the mma fragment reads as the lower column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 16) of tile x.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* x, int ld,
                                       int r0, int c0, int gid, int tig) {
  const uint16_t* p = x + (r0 + gid) * ld + c0 + tig * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B = X^T for X stored as [n][k]: n-tile at row n0, k-step at column k0
// (the keys of Q K^T, or the values of dO V^T).
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1, const uint16_t* x,
                                            int ld, int n0, int k0, int gid, int tig) {
  const uint16_t* p = x + (n0 + gid) * ld + k0 + tig * 2;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B = X for X stored as [k][n]: k-step at row k0, n-tile at column n0
// (V in P V, dO in P^T dO, K in dS K).
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1, const uint16_t* x,
                                            int ld, int k0, int n0, int gid, int tig) {
  const uint16_t* p = x + (k0 + tig * 2) * ld + n0 + gid;
  b0 = uint32_t(p[0]) | (uint32_t(p[ld]) << 16);
  b1 = uint32_t(p[8 * ld]) | (uint32_t(p[9 * ld]) << 16);
}

// The A fragment of k-step kk from the fp32 C fragments of n-tiles 2kk, 2kk+1.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copy rows [row0, row0 + rows) of a strided bf16 [N, D] matrix (row stride
// `rs`, 16-byte aligned rows) into a shared tile; rows past n are zero.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* dst, int ld, const uint16_t* src,
                                          long long rs, int row0, int rows, int n,
                                          int tid, int nthreads) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < rows * CH; idx += nthreads) {
    const int r = idx / CH, c = (idx % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

}  // namespace teochat
