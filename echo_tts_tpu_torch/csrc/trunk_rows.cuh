// Shared by the trunk layer's row kernels K6-K8 (trunk_rows.cu) and their
// backward kernels (trunk_rows_bwd.cu): the shapes they take and the bf16
// packing, eight values a 16-byte chunk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace trunk_rows {

constexpr int K6_THREADS = 128;
constexpr int K6_D = 2048;                     // the trunk's width, every configuration's
constexpr int K6_CPT = K6_D / 8 / K6_THREADS;  // 16-byte chunks a thread
constexpr int K7_THREADS = 256;
constexpr int K7_DH = 128;
constexpr int K8_THREADS = 256;

__device__ __forceinline__ void unpack8(const uint4 c, float (&v)[8]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// eight floats rounded to bf16 (to nearest, ties to even) as one chunk
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

// whether every pointer is 16-byte aligned (null ones are not read)
inline bool aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace trunk_rows
