// A bare check of attention_core.cuh, sm_90a: one warpgroup computes
//   s = a . b^T              (64 x 64 fp32; a (64 x 128), b (64 x 128) bf16, or
//                             b^T (128 x 64) when b_transposed)
//   o = bf16(s * p_scale) . v   (64 x 128 fp32; v (64 x 128) bf16)
// through the same tile loaders, descriptors and products the attention
// kernels use: B from swizzled shared memory (K-major, or MN-major through
// the transpose flag), A from swizzled shared memory or as register
// fragments loaded from global memory, then the score accumulator re-laid as
// the register A operand against V read MN-major. It replaces no TPU kernel and
// is on no model path: ops/attention_core.py holds its results against
// torch.matmul before the attention kernels are trusted.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_core.cuh"

using namespace attn_core;

namespace {

constexpr int SMEM_BYTES = 1024 + 3 * TILE_BYTES;

template <bool K_T, bool A_REGS>
__global__ void __launch_bounds__(WG_THREADS)
core_check_kernel(const bf16* a, const bf16* b, const bf16* v, float* s_out, float* o_out,
                  float p_scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_smem = base, b_smem = base + TILE_BYTES, v_smem = base + 2 * TILE_BYTES;
  const int tid = threadIdx.x, lane = tid % 32;
  load_rows_async<64, WG_THREADS>(a_smem, a, HEAD_D, 64, tid);
  if (K_T) load_cols<WG_THREADS>(b_smem, b, TILE_KEYS, TILE_KEYS, tid, true);
  else load_rows_async<64, WG_THREADS>(b_smem, b, HEAD_D, 64, tid);
  load_rows_async<64, WG_THREADS>(v_smem, v, HEAD_D, 64, tid);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  const int row = 16 * (tid / 32) + lane / 4;
  float sc[32];
  if (A_REGS) {
    uint32_t af[32];
    load_q_frags(af, a, HEAD_D, 64, row, lane);
    fence_regs(af);
    qk_product<K_T>(sc, af, b_smem);
  } else {
    qk_product_ss<K_T>(sc, a_smem, HALF_TILE_BYTES, b_smem);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);

  uint32_t pa[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    s_out[row * 64 + col] = sc[4 * j];
    s_out[row * 64 + col + 1] = sc[4 * j + 1];
    s_out[(row + 8) * 64 + col] = sc[4 * j + 2];
    s_out[(row + 8) * 64 + col + 1] = sc[4 * j + 3];
    pa[2 * j] = pack_bf16(sc[4 * j] * p_scale, sc[4 * j + 1] * p_scale);
    pa[2 * j + 1] = pack_bf16(sc[4 * j + 2] * p_scale, sc[4 * j + 3] * p_scale);
  }
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  fence_regs(pa);
  fence_regs(o);
  pv_product(o, pa, v_smem);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    o_out[row * 128 + col] = o[4 * j];
    o_out[row * 128 + col + 1] = o[4 * j + 1];
    o_out[(row + 8) * 128 + col] = o[4 * j + 2];
    o_out[(row + 8) * 128 + col + 1] = o[4 * j + 3];
  }
}

}  // namespace

// a, v: contiguous (64, 128) bf16; b: contiguous (64, 128), or (128, 64) when
// b_transposed; s_out (64, 64) and o_out (64, 128) fp32
extern "C" int attention_core_check(const void* a, const void* b, const void* v, void* s_out,
                                    void* o_out, float p_scale, int b_transposed,
                                    int a_from_registers, void* stream) {
  auto kernel = b_transposed
                    ? (a_from_registers ? core_check_kernel<true, true>
                                        : core_check_kernel<true, false>)
                    : (a_from_registers ? core_check_kernel<false, true>
                                        : core_check_kernel<false, false>);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, WG_THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<const bf16*>(v),
      static_cast<float*>(s_out), static_cast<float*>(o_out), p_scale);
  return (int)cudaGetLastError();
}
