// A bare check of conv_core.cuh, sm_90a: one warpgroup computes the
// tap-shifted product of a dilated causal convolution on one tile,
//   out (64 x N) = sum_j y[row0 + j d .. row0 + j d + 63, :] . W[j]   (fp32)
// with y (R x 64) bf16 staged once as a strip window (fill_window), the
// seven (64 x N) weight tiles pre-packed as strip tiles and streamed through
// a two-stage ring by cp.async.bulk (ring_fill), and each tap's A operand the
// window's descriptor moved down j d rows (ring_product): the pieces K2 and
// K2v-cl are made of. It replaces no TPU kernel and is on no model path:
// ops/conv_core.py holds it against torch.matmul at d = 1, 3, 9 and at a row
// offset that is no multiple of 8, for N = 48, 64, 96, 128 and 192, before
// the residual-unit kernels are trusted.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_core.cuh"

using namespace conv_core;

namespace {

constexpr int K = 64;
constexpr int STAGES = 2;

template <int N>
__global__ void __launch_bounds__(WG_THREADS + 32)
conv_core_check_kernel(const bf16* y, const bf16* w_packed, float* out, int rows, int row0,
                       int d) {
  constexpr int STAGE_BYTES = K * N * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 127u) & ~127u;
  const uint32_t bars = ring + WeightRing<STAGES, STAGE_BYTES>::BAR_OFFSET;
  const uint32_t win = ring + WeightRing<STAGES, STAGE_BYTES>::BYTES;
  const int win_rows = rows | 1;
  if (threadIdx.x == 0) weight_ring_init<STAGES>(bars, 4);
  __syncthreads();

  if (threadIdx.x >= WG_THREADS) {  // the producer warp: one thread copies
    if (threadIdx.x == WG_THREADS) {
      RingPos pos = {0, 0u};
      for (int j = 0; j < 7; ++j)
        ring_fill<STAGES, STAGE_BYTES>(ring, bars, pos, w_packed + j * K * N);
    }
    return;
  }
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  fill_window<K>(win, win_rows, y, rows, 0, rows, [](float (&)[8], int) {}, tid, WG_THREADS);
  fence_proxy_async();
  named_sync(1, WG_THREADS);

  float acc[N / 2];
  RingPos pos = {0, 0u};
  ring_product<K, N, STAGES, STAGE_BYTES>(
      acc, 7,
      [&](int j, int kk) {
        return strip_desc(win + strip_off(win_rows, row0 + j * d, 16 * kk),
                          win_rows * CORE_ROW);
      },
      ring, bars, 0, pos, lane);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[frag_row(warp, lane, e) * N + frag_col(lane, j, e)] = acc[4 * j + e];
}

template <int N>
int launch(const void* y, const void* w, void* out, int rows, int row0, int d,
           cudaStream_t s) {
  const int smem = 128 + WeightRing<STAGES, K * N * 2>::BYTES + (rows | 1) * K * 2;
  auto kernel = conv_core_check_kernel<N>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, WG_THREADS + 32, smem, s>>>(static_cast<const bf16*>(y),
                                          static_cast<const bf16*>(w), static_cast<float*>(out),
                                          rows, row0, d);
  return (int)cudaGetLastError();
}

}  // namespace

// y: contiguous (rows, 64) bf16, rows >= row0 + 64 + 6 d; w_packed: the seven
// (64 x N) tiles of W (7, 64, N) in strip order (ops/conv_core.py:pack_tiles);
// out: (64, N) fp32. N in {48, 64, 96, 128, 192}.
extern "C" int conv_core_check(const void* y, const void* w_packed, void* out, int rows,
                               int row0, int d, int n, void* stream) {
  if (row0 < 0 || d < 1 || rows < row0 + 64 + 6 * d || rows > 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 48: return launch<48>(y, w_packed, out, rows, row0, d, s);
    case 64: return launch<64>(y, w_packed, out, rows, row0, d, s);
    case 96: return launch<96>(y, w_packed, out, rows, row0, d, s);
    case 128: return launch<128>(y, w_packed, out, rows, row0, d, s);
    case 192: return launch<192>(y, w_packed, out, rows, row0, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
