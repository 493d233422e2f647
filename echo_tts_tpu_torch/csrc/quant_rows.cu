// Kernel K5: dynamic per-row int8 quantization of the trunk's activations,
// sm_90a.
//
// Computes echo_tts_tpu/models/quant.py:quant_rows, which XLA fuses into the
// int8 dot after it (the JAX package has no Pallas kernel here). For h
// (M, D) in bf16 or fp32, per row:
//   s = max(amax |h|, 1e-8) / 127        (fp32)
//   q = clip(rint(h / s), -127, 127)     (int8, round half to even)
// The division is IEEE (no reciprocal; the build has no fast math) and rintf
// rounds half to even as jnp.round does, so codes and scales equal the plain
// version's bit for bit.
//
// Bound. Bytes: each row is read once and its D codes and one scale written,
// M·D·(2 or 4) + M·D + 4·M bytes at 3.35 TB/s; a few operations an element,
// far below any compute limit.
//
// Design. One warp a row, four rows a block. A lane reads 16-byte chunks
// (8 bf16 or 4 fp32 values), neighbouring lanes on neighbouring chunks; the
// amax is a warp shuffle reduction; the row is then read a second time (from
// L1/L2: a row is at most a few tens of KB) to write the codes, 8 or 4 bytes
// a store. Keeping the row in registers instead would need D at compile time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // rows a block

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the fp32 values of one 16-byte chunk
template <bool BF16>
__device__ __forceinline__ void unpack(const uint4 c, float (&v)[BF16 ? 8 : 4]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
  }
}

__device__ __forceinline__ uint32_t code(float x, float s) {
  const float r = fminf(fmaxf(rintf(x / s), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(r))));
}

template <bool BF16>
__global__ void __launch_bounds__(WARPS * 32)
quant_rows_kernel(const void* __restrict__ h, int8_t* __restrict__ q, float* __restrict__ s,
                  int M, int D) {
  constexpr int PER = BF16 ? 8 : 4;  // values a chunk
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= M) return;
  const int chunks = D / PER;
  const uint4* src = reinterpret_cast<const uint4*>(static_cast<const char*>(h) +
                                                    (size_t)row * D * (BF16 ? 2 : 4));
  float amax = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    float v[PER];
    unpack<BF16>(__ldg(src + c), v);
#pragma unroll
    for (int i = 0; i < PER; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  amax = warp_max(amax);
  const float sc = fmaxf(amax, 1e-8f) / 127.f;
  if (lane == 0) s[row] = sc;
  int8_t* dst = q + (size_t)row * D;
  for (int c = lane; c < chunks; c += 32) {
    float v[PER];
    unpack<BF16>(__ldg(src + c), v);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) lo |= code(v[i], sc) << (8 * i);
    if constexpr (BF16) {
#pragma unroll
      for (int i = 0; i < 4; ++i) hi |= code(v[4 + i], sc) << (8 * i);
      *reinterpret_cast<uint2*>(dst + (size_t)c * 8) = make_uint2(lo, hi);
    } else {
      *reinterpret_cast<uint32_t*>(dst + (size_t)c * 4) = lo;
    }
  }
}

}  // namespace

// h (M, D) contiguous, bf16 (bf16 != 0) or fp32, 16-byte aligned, D a
// multiple of 8; q (M, D) int8; s (M,) fp32.
extern "C" int quant_rows(const void* h, void* q, void* s, int M, int D, int bf16, void* stream) {
  if (M < 1 || D < 8 || D % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + WARPS - 1) / WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    quant_rows_kernel<true><<<grid, WARPS * 32, 0, st>>>(h, static_cast<int8_t*>(q),
                                                         static_cast<float*>(s), M, D);
  else
    quant_rows_kernel<false><<<grid, WARPS * 32, 0, st>>>(h, static_cast<int8_t*>(q),
                                                          static_cast<float*>(s), M, D);
  return (int)cudaGetLastError();
}
