// Hopper's asynchronous machinery for the attention and int4 kernels (sm_90a): the
// warpgroup product `wgmma`, `mbarrier`s, bulk tensor (TMA) loads, and the
// host side of a tensor map. Kept apart from the kernels so that each of
// them (the forward in flash_attention.cu first) builds on the same pieces.
//
// wgmma. Four warps (a warpgroup, 128 threads) multiply a 64-row A tile by
// a B tile read from shared memory; the sum stays in registers. Thread t of
// the warpgroup (warp w = t / 32, gid = lane / 4, tig = lane % 4) holds of a
// 64 x N fp32 result, in register i: row 16 w + gid + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 tig + (i % 2) -- four registers for each 8 columns,
// laid out as the C fragment of mma.sync m16n8. An A operand held in
// registers is, for each 16-deep step, the A fragment of mma.sync m16n8k16,
// so registers 8 kk .. 8 kk + 7 of a score tile, packed two by two to bf16,
// are the A operand of step kk of the next product.
//
// Shared-memory operands are bf16 tiles as a TMA load with the 128-byte
// swizzle writes them: rows of 64 elements (128 bytes) one after the other,
// the 16-byte chunks of row r permuted by r % 8, the tile's base aligned to
// 1024 bytes. A tile wider than 64 elements is several such boxes. A
// descriptor names the swizzle, a start address and two strides:
// - K-major (the reduction runs along a row: Q and K in Q K^T): 8 rows are
//   1024 bytes apart (the stride offset); a 16-deep step k is 32 k bytes
//   into the row, and step 4 starts the next box;
// - MN-major (the reduction runs down the rows: V in P V, `tnspB`): 8 rows
//   of the reduction are 1024 bytes apart (the stride offset), 64 columns
//   are one box apart (the leading offset); a 16-deep step is 16 rows =
//   2048 bytes further down.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace teochat {

// ------------------------------------------------------------------ wgmma

constexpr uint32_t SWIZZLE_ROW_BYTES = 128;   // one row of a 64-wide bf16 box
constexpr uint32_t SWIZZLE_ATOM_BYTES = 1024;  // 8 such rows: the swizzle's period

// Descriptor of a 128-byte-swizzled tile at shared address `addr` (bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t leading_bytes,
                                              uint32_t stride_bytes) {
  return uint64_t((addr & 0x3FFFFu) >> 4) | (uint64_t(leading_bytes >> 4) << 16) |
         (uint64_t(stride_bytes >> 4) << 32) | (uint64_t(1) << 62);
}

// K-major operand; the leading offset is not read under a swizzle.
__device__ __forceinline__ uint64_t smem_desc_k_major(uint32_t addr) {
  return smem_desc(addr, 16, SWIZZLE_ATOM_BYTES);
}

// MN-major operand whose 64-column boxes lie `box_bytes` apart.
__device__ __forceinline__ uint64_t smem_desc_mn_major(uint32_t addr, uint32_t box_bytes) {
  return smem_desc(addr, box_bytes, SWIZZLE_ATOM_BYTES);
}

// A descriptor moved `bytes` further into shared memory.
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// Orders ordinary register and shared-memory accesses before the next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The operand lists of one `wgmma`: the result's registers as the template
// names them, and as constraints ("+f" read and written, "=f" written only).
#define TEOCHAT_WGMMA_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define TEOCHAT_WGMMA_R16 TEOCHAT_WGMMA_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define TEOCHAT_WGMMA_R32 \
  TEOCHAT_WGMMA_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define TEOCHAT_WGMMA_R64                                                                     \
  TEOCHAT_WGMMA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
                    "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "   \
                    "%60, %61, %62, %63"
#define TEOCHAT_WGMMA_R128                                                                     \
  TEOCHAT_WGMMA_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "  \
                    "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "   \
                    "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "   \
                    "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, " \
                    "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define TEOCHAT_WGMMA_D8(c, d, i) \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define TEOCHAT_WGMMA_D16(c, d, i) TEOCHAT_WGMMA_D8(c, d, i), TEOCHAT_WGMMA_D8(c, d, i + 8)
#define TEOCHAT_WGMMA_D32(c, d, i) TEOCHAT_WGMMA_D16(c, d, i), TEOCHAT_WGMMA_D16(c, d, i + 16)
#define TEOCHAT_WGMMA_D64(c, d, i) TEOCHAT_WGMMA_D32(c, d, i), TEOCHAT_WGMMA_D32(c, d, i + 32)
#define TEOCHAT_WGMMA_D128(c, d, i) TEOCHAT_WGMMA_D64(c, d, i), TEOCHAT_WGMMA_D64(c, d, i + 64)

// One m64nNk16 bf16 product into fp32. SHAPE is the instruction's shape, REGS
// and OUTS the result's lists above, A, B and P the template's names of the
// operands and of the accumulate flag, TAIL the scales and transposes
// ("1, 1, 0, 0": both operands K-major; "1, 1, 0, 1": A K-major, B
// MN-major; "1, 1, 1": A in registers, B MN-major); the inputs follow in the
// template's order.
#define TEOCHAT_WGMMA(SHAPE, REGS, A, B, P, TAIL, OUTS, ...)                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                             \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32.bf16.bf16 {" REGS "}, " A ", " \
               B ", p, " TAIL ";\n}\n"                                                    \
               : OUTS                                                                     \
               : __VA_ARGS__)

// D[64 x N] (+)= A[64 x 16] B[16 x N], A and B in shared memory, both
// K-major; N = 16 or 256 (the ViT attention's 272-key window), 32 (for a
// score tile that has to leave registers to two 64 x 128 accumulators), 64
// or 128 by the size of d.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  TEOCHAT_WGMMA("m64n16k16", TEOCHAT_WGMMA_R8, "%8", "%9", "%10", "1, 1, 0, 0",
                TEOCHAT_WGMMA_D8("+f", d, 0), "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  TEOCHAT_WGMMA("m64n32k16", TEOCHAT_WGMMA_R16, "%16", "%17", "%18", "1, 1, 0, 0",
                TEOCHAT_WGMMA_D16("+f", d, 0), "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  TEOCHAT_WGMMA("m64n64k16", TEOCHAT_WGMMA_R32, "%32", "%33", "%34", "1, 1, 0, 0",
                TEOCHAT_WGMMA_D32("+f", d, 0), "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  TEOCHAT_WGMMA("m64n128k16", TEOCHAT_WGMMA_R64, "%64", "%65", "%66", "1, 1, 0, 0",
                TEOCHAT_WGMMA_D64("+f", d, 0), "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  TEOCHAT_WGMMA("m64n256k16", TEOCHAT_WGMMA_R128, "%128", "%129", "%130", "1, 1, 0, 0",
                TEOCHAT_WGMMA_D128("+f", d, 0), "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The first step of such a product: D = A B. D is written and not read, which
// also tells the compiler that its old values are dead (after `wgmma_ss` with
// accumulate = 0 it has to keep them).
__device__ __forceinline__ void wgmma_ss_first(float (&d)[8], uint64_t desc_a, uint64_t desc_b) {
  TEOCHAT_WGMMA("m64n16k16", TEOCHAT_WGMMA_R8, "%8", "%9", "%10", "1, 1, 0, 0",
                TEOCHAT_WGMMA_D8("=f", d, 0), "l"(desc_a), "l"(desc_b), "r"(0));
}
__device__ __forceinline__ void wgmma_ss_first(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  TEOCHAT_WGMMA("m64n32k16", TEOCHAT_WGMMA_R16, "%16", "%17", "%18", "1, 1, 0, 0",
                TEOCHAT_WGMMA_D16("=f", d, 0), "l"(desc_a), "l"(desc_b), "r"(0));
}
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  TEOCHAT_WGMMA("m64n64k16", TEOCHAT_WGMMA_R32, "%32", "%33", "%34", "1, 1, 0, 0",
                TEOCHAT_WGMMA_D32("=f", d, 0), "l"(desc_a), "l"(desc_b), "r"(0));
}
__device__ __forceinline__ void wgmma_ss_first(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  TEOCHAT_WGMMA("m64n128k16", TEOCHAT_WGMMA_R64, "%64", "%65", "%66", "1, 1, 0, 0",
                TEOCHAT_WGMMA_D64("=f", d, 0), "l"(desc_a), "l"(desc_b), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_first(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  TEOCHAT_WGMMA("m64n256k16", TEOCHAT_WGMMA_R128, "%128", "%129", "%130", "1, 1, 0, 0",
                TEOCHAT_WGMMA_D128("=f", d, 0), "l"(desc_a), "l"(desc_b), "r"(0));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], A in registers, B in shared memory
// MN-major; N = 64 or 128.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
  TEOCHAT_WGMMA("m64n64k16", TEOCHAT_WGMMA_R32, "{%32, %33, %34, %35}", "%36", "%37", "1, 1, 1",
                TEOCHAT_WGMMA_D32("+f", d, 0), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
  TEOCHAT_WGMMA("m64n128k16", TEOCHAT_WGMMA_R64, "{%64, %65, %66, %67}", "%68", "%69", "1, 1, 1",
                TEOCHAT_WGMMA_D64("+f", d, 0), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                "l"(desc_b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both in shared memory, A K-major
// and B MN-major (`tnspB`: the int4 product's dequantized weights, whose
// rows are the reduction).
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  TEOCHAT_WGMMA("m64n128k16", TEOCHAT_WGMMA_R64, "%64", "%65", "%66", "1, 1, 0, 1",
                TEOCHAT_WGMMA_D64("+f", d, 0), "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Give registers back to (dec) or take them from (inc) the SM's pool, for the
// whole warpgroup. Only inside one if / else on the warpgroup's role, or the
// compiler ignores it (warning C7508).
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Named barriers (1-15; 0 is __syncthreads) over `threads` threads: `sync`
// waits until that many have arrived, `arrive` counts in without waiting.
// Two warpgroups pass a turn back and forth with a pair of them.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------------- mbarrier
// All addresses are 32-bit shared-memory addresses (`smem_u32`).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 16-byte store to shared memory by an ordinary thread.
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Makes this thread's ordinary shared-memory stores visible to the async
// proxy (`wgmma`, TMA); between the stores and the mbarrier arrival that
// hands the tile over. Without it the tensor cores may read stale bytes.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// After the inits, before any thread or the TMA unit uses the barriers.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also announces `bytes` of bulk copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of parity `parity` is over. A barrier
// starts in phase 0, so a wait for parity 1 on a fresh barrier returns at
// once. A wait that never ends (a lost arrival) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins == (1u << 22)) __trap();
  }
}

// -------------------------------------------------------------------- TMA

// Load the box at coordinates (c0, c1, c2, c3) of a rank-4 tensor map into
// shared memory at `dst`; its bytes are counted on barrier `bar`. Elements
// outside the tensor arrive as zeros and count all the same.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Copy `bytes` contiguous bytes from global `src` to shared memory at `dst`;
// they are counted on barrier `bar`. A bulk copy needs no tensor map: both
// addresses 16-byte aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_load_1d(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ------------------------------------------------------- tensor map (host)

constexpr int TENSOR_MAP_ERROR = 100000;  // added to a CUresult, to tell it from a cudaError_t

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or 0 and a cudaError_t in *err
inline EncodeTiled tensor_map_encoder(int* err) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                         cudaEnableDefault, &found);
#else
  const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                cudaEnableDefault, &found);
#endif
  *err = e != cudaSuccess ? static_cast<int>(e)
         : found != cudaDriverEntryPointSuccess || fn == nullptr
             ? static_cast<int>(cudaErrorSymbolNotFound)
             : 0;
  return *err ? nullptr : reinterpret_cast<EncodeTiled>(fn);
}

// A bf16 [B, N, H, D] tensor read through its strides (in elements; the last
// dimension contiguous) as boxes of `box_rows` rows x 64 columns of one head
// of one batch row, written with the 128-byte swizzle. The map's dimensions
// are (D, H, N, B), or (D, N, H, B) where a head's stride is the larger, so
// that the strides ascend; `*rows_first` says which, and the kernel orders
// its coordinates by it. libcuda's encoder is reached through the
// runtime's entry-point lookup, so nothing links against it. Returns 0, a cudaError_t, or
// TENSOR_MAP_ERROR + CUresult.
inline int encode_bf16_rows_map(CUtensorMap* map, int* rows_first, const void* base,
                                int batch, int rows, int heads, int head_dim,
                                long long stride_b, long long stride_n, long long stride_h,
                                int box_rows) {
  int err = 0;
  const EncodeTiled fn = tensor_map_encoder(&err);
  if (err) return err;

  *rows_first = stride_n < stride_h;
  const int r = *rows_first ? 1 : 2, h = *rows_first ? 2 : 1;  // where rows and heads go
  cuuint64_t dims[4] = {cuuint64_t(head_dim), 0, 0, cuuint64_t(batch)};
  cuuint64_t strides[4] = {2, 0, 0, cuuint64_t(stride_b) * 2};  // bytes; [0] is implied
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  dims[r] = cuuint64_t(rows), strides[r] = cuuint64_t(stride_n) * 2, box[r] = cuuint32_t(box_rows);
  dims[h] = cuuint64_t(heads), strides[h] = cuuint64_t(stride_h) * 2;
  // a dimension of one element is never stepped over: give it the stride a
  // dense tensor would have, whatever the view carries
  for (int i = 1; i < 4; ++i)
    if (dims[i] == 1) strides[i] = strides[i - 1] * dims[i - 1];
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides + 1, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + static_cast<int>(res);
}

// A rank-4 tensor of `type` (dims innermost first; strides in bytes of
// dims 1-3, multiples of 16; the base 16-byte aligned) read in boxes of
// `box`, written with the 128-byte swizzle (the box's inner extent at most
// 128 bytes); elements outside the tensor arrive as zeros. A dimension of
// one element gets the stride a dense tensor would have. Returns 0, a
// cudaError_t, or TENSOR_MAP_ERROR + CUresult.
inline int encode_map_4d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                         const cuuint64_t (&dims)[4], cuuint64_t const (&strides)[3],
                         const cuuint32_t (&box)[4]) {
  int err = 0;
  const EncodeTiled fn = tensor_map_encoder(&err);
  if (err) return err;
  const cuuint64_t elem = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) st[i] = (i ? st[i - 1] : elem) * dims[i];
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, type, 4, const_cast<void*>(base), dims, st, box, elem_strides,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + static_cast<int>(res);
}

}  // namespace teochat
