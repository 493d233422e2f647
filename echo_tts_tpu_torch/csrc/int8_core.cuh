// The s8 side of the Hopper core (sm_90a): what the int8 GEMM (K4,
// int8_gemm.cu) adds to attention_core.cuh, whose mbarrier, descriptor,
// fence and setmaxnreg wrappers it reuses unchanged.
//
//   * wgmma m64nNk32 s32 += s8 . s8 with both operands K-major in shared
//     memory (8-bit wgmma has no transpose), N = 64, 128, 256;
//   * TMA: a 2-D tiled copy of an (rows, K) int8 matrix into a 128-byte
//     swizzled shared tile, completion counted in bytes on an mbarrier, and
//     a 2-D tiled store of a swizzled shared box to a bf16, fp32 or int32
//     matrix; the host side encodes the tensor maps through the driver
//     entry point, so the library needs no link to libcuda.
//
// Layout. An int8 tile row of 128 bytes is one 128-byte swizzle row: the
// 16-byte chunk c of row r lies at chunk position c ^ (r % 8) of a tile that
// starts on a 1024-byte boundary, which is what TMA's SWIZZLE_128B writes and
// what attention_core.cuh's descriptor (`wgmma_desc(addr, 16, 1024)`)
// describes. A k32 slice of s8 is 32 bytes, as a k16 slice of bf16 is, so
// slice kk of a stage is the descriptor of the tile's address + 32 kk,
// exactly as in the bf16 products. The s32 accumulator of one warpgroup has
// the fp32 accumulator's layout: thread t (warp w = t / 32 % 4, lane l)
// holds d[4 j + e] at row 16 w + l / 4 + 8 (e / 2), column 8 j + 2 (l % 4)
// + (e % 2).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace int8_core {

using attn_core::wgmma_desc;

// the descriptor of a K-major s8 tile (128-byte rows, 128-byte swizzle)
__device__ __forceinline__ uint64_t s8_desc(uint32_t addr) { return wgmma_desc(addr, 16, 1024); }

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define INT8_R8(d, o)                                                                  \
  "+r"(d[o + 0]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]), "+r"(d[o + 4]),      \
      "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])

// d (64 x 64) s32 (+)= A (64 x 32) . B (64 x 32)^T, one k32 slice, both s8
// K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : INT8_R8(d, 0), INT8_R8(d, 8), INT8_R8(d, 16), INT8_R8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) s32 (+)= A (64 x 32) . B (128 x 32)^T, one k32 slice, both s8
// K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : INT8_R8(d, 0), INT8_R8(d, 8), INT8_R8(d, 16), INT8_R8(d, 24),
        INT8_R8(d, 32), INT8_R8(d, 40), INT8_R8(d, 48), INT8_R8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256) s32 (+)= A (64 x 32) . B (256 x 32)^T, one k32 slice, both s8
// K-major in shared memory
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : INT8_R8(d, 0), INT8_R8(d, 8), INT8_R8(d, 16), INT8_R8(d, 24),
        INT8_R8(d, 32), INT8_R8(d, 40), INT8_R8(d, 48), INT8_R8(d, 56),
        INT8_R8(d, 64), INT8_R8(d, 72), INT8_R8(d, 80), INT8_R8(d, 88),
        INT8_R8(d, 96), INT8_R8(d, 104), INT8_R8(d, 112), INT8_R8(d, 120)
      : "l"(da), "l"(db), "r"(accumulate));
}

// one k32 slice for a warpgroup's N columns
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 128 || N == 256, "s8 wgmma width");
  if constexpr (N == 64) wgmma_m64n64k32_s8(d, da, db, accumulate);
  if constexpr (N == 128) wgmma_m64n128k32_s8(d, da, db, accumulate);
  if constexpr (N == 256) wgmma_m64n256k32_s8(d, da, db, accumulate);
}

// ------------------------------------------------------------------- TMA

// one arrival on `bar` that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// the box of `map` at (column c0 in bytes, row c1) into shared memory at
// `dst` (1024-byte aligned); rows and columns past the matrix are zero and
// still count their bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded; null if the
// driver has none
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of a row-major (rows, cols) matrix of `type` (elements of
// `elem` bytes; rows 16-byte aligned) in boxes of box_rows x 128 bytes,
// 128-byte swizzle; a load reads zeros past its edges, a store writes
// nothing there
inline cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem,
                                 const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a row-major (rows, k) int8 matrix (k a multiple of 16) in boxes of
// box_rows x 128 bytes of K
inline cudaError_t s8_tensor_map(CUtensorMap* map, const void* ptr, int rows, int k,
                                 int box_rows) {
  return tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, rows, k, box_rows);
}

// the shared box at `src` (1024-byte aligned, 128-byte swizzle) to `map` at
// (column c0, row c1), clipped at the matrix's edges; one thread issues it
// after a fence_proxy_async of every thread that wrote the box
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// returns once at most N committed bulk stores of this thread still read
// shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

}  // namespace int8_core
