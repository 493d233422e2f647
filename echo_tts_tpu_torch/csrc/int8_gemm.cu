// Kernel K4: the int8 GEMM of the W8A8 trunk with its dequantize epilogue,
// sm_90a.
//
// Computes echo_tts_tpu/models/quant.py:qdot, an int8 x int8 -> int32
// dot_general that XLA fuses with the dequantize (the JAX package has no
// Pallas kernel here):
//   out[m, n] = out_t(float(sum_k a[m, k] w[n, k]) * (s_row[m] * s_col[n]))
// a (M, K) int8 activation rows, w (N, K) int8 weight stored K-major (the
// port's quantized leaf), s_row (M,) and s_col (N,) fp32; out bf16, fp32,
// or the raw int32 sums. The sums are exact and the scale product is taken
// before the multiply, as JAX does, so the result equals the plain version
// bit for bit.
//
// Bound. 2·M·N·K operations at 1979 TOP/s (int8, dense) against M·K + N·K
// bytes in, M·N·2 out: at the one-shot CFG forward's M = 1920 it is bound by
// operations (2.7 ms for the 8 projections of 24 layers); at a stream
// block's M = 192 by the weight bytes (0.41 ms a forward at 3.35 TB/s).
//
// Design (a simple kernel that is right; a TMA ring, warp specialisation and
// a persistent grid are later work). A block computes a 128 x 128 tile of
// out with 8 warps, each a 64 x 32 tile as 4 x 4 mma.sync.m16n8k32 s8
// products (s32 accumulators in registers). 8-bit tensor-core operands must
// be K-major, which both a and w are as they lie, so each fragment register
// is 4 consecutive bytes of one row: a plain 32-bit shared-memory load. K
// steps 64 bytes at a time through a 3-stage ring of cp.async copies (16
// bytes a thread a copy, zero filled past M, N and K); tile rows are padded
// to 80 bytes, which puts the 32 lanes of a fragment load on 32 different
// banks. Ragged M and N are masked in the epilogue; K must be a multiple of
// 16 (whole 16-byte copies).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // tile of out; bytes of K a stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;                // 8 warps: 2 along M x 4 along N
constexpr int LDS = BK + 16;                // bytes a shared-memory tile row
constexpr int TILE_BYTES = BM * LDS;        // one A or B tile of a stage
constexpr int SMEM_BYTES = STAGES * 2 * TILE_BYTES;
constexpr int CHUNKS = BM * BK / 16 / THREADS;  // 16-byte copies a thread a tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global memory, zero filled when src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + 128) x bytes [k0, k0 + 64) of a row-major (rows, K) int8
// matrix into a padded shared tile
__device__ __forceinline__ void load_tile(int8_t* tile, const int8_t* g, int rows, int K, int r0,
                                          int k0, int tid) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / (BK / 16), col = (c % (BK / 16)) * 16;
    const bool ok = r0 + r < rows && k0 + col < K;
    const int8_t* src = ok ? g + (size_t)(r0 + r) * K + k0 + col : g;
    cp_async16(smem_u32(tile + r * LDS + col), src, ok ? 16 : 0);
  }
}

template <int OUT>  // 0 bf16, 1 fp32, 2 int32 sums
__global__ void __launch_bounds__(THREADS, 2)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                 const float* __restrict__ s_row, const float* __restrict__ s_col,
                 void* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, thread in group
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ktiles) {
      int8_t* base = smem + st * 2 * TILE_BYTES;
      load_tile(base, a, M, K, m0, st * BK, tid);
      load_tile(base + TILE_BYTES, w, N, K, n0, st * BK, tid);
    }
    cp_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile kt is in; every warp is done with the stage refilled below
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) {
      int8_t* base = smem + (nk % STAGES) * 2 * TILE_BYTES;
      load_tile(base, a, M, K, m0, nk * BK, tid);
      load_tile(base + TILE_BYTES, w, N, K, n0, nk * BK, tid);
    }
    cp_commit();
    const int8_t* as = smem + (kt % STAGES) * 2 * TILE_BYTES;
    const int8_t* bs = as + TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = as + (wm * 64 + i * 16 + g) * LDS + kk + 4 * t;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * LDS);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = bs + (wn * 32 + j * 8 + g) * LDS + kk + 4 * t;
        bf[j][0] = lds32(p);
        bf[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_wait<0>();

  // accumulator e of (i, j): row wm*64 + 16 i + g + 8 (e / 2), column
  // wn*32 + 8 j + 2 t + (e % 2)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + g + 8 * half;
      if (m >= M) continue;
      const float sr = OUT == 2 ? 0.f : s_row[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + j * 8 + 2 * t + e;
          if (n >= N) continue;
          const int v = acc[i][j][2 * half + e];
          const size_t at = (size_t)m * N + n;
          if constexpr (OUT == 2) {
            static_cast<int*>(out)[at] = v;
          } else {
            const float r = __fmul_rn(__int2float_rn(v), __fmul_rn(sr, s_col[n]));
            if constexpr (OUT == 0)
              static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(r);
            else
              static_cast<float*>(out)[at] = r;
          }
        }
      }
    }
  }
}

template <int OUT>
cudaError_t launch(const int8_t* a, const int8_t* w, const float* s_row, const float* s_col,
                   void* out, int M, int N, int K, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemm_kernel<OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<OUT><<<grid, THREADS, SMEM_BYTES, st>>>(a, w, s_row, s_col, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// a (M, K) and w (N, K) int8 row-major, 16-byte aligned, K a multiple of
// 16; s_row (M,), s_col (N,) fp32; out (M, N): out_code 0 bf16, 1 fp32,
// 2 int32 sums.
extern "C" int int8_gemm(const void* a, const void* w, const void* s_row, const void* s_col,
                         void* out, int M, int N, int K, int out_code, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sr = static_cast<const float*>(s_row);
  const float* sc = static_cast<const float*>(s_col);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_code) {
    case 0: return (int)launch<0>(ap, wp, sr, sc, out, M, N, K, st);
    case 1: return (int)launch<1>(ap, wp, sr, sc, out, M, N, K, st);
    case 2: return (int)launch<2>(ap, wp, sr, sc, out, M, N, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
