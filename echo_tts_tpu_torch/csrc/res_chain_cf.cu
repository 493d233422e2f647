// Kernel K2v-cf: the fused three-unit residual chain on channels-first
// (B, C, T) bf16, sm_90a.
//
// Replaces scripts/bench_conv_kernel_variants.py:_kernel_cf (called from
// res_chain_cf): the chain of res_chain_variants.cu with time as the
// contiguous axis, a 128-column halo, the pad columns re-zeroed by multiply,
// and the snake exact (sinf) or the stand-in z*a. Its output equals K2v-cl's
// on the transposed input.
//
// Bound. As K2v-cl: 3 * 2*T*C*C*8 FLOPs over one read and one write of T*C
// bf16, tensor-core operations.
//
// Design and its cost. The products are W^T . y: the A operand is a weight
// block read column-major straight from L2, the B operand a (channels x time)
// block of y in shared memory. On the TPU a tap shift along time is a lane
// shift; here WMMA wants every operand block 32-byte aligned, and a shift by
// 1, 3 or 9 columns is not. So each tap first copies the shifted 64-column
// group of y into an aligned staging block (zeros before the window), then
// multiplies from it: seven copies and fourteen block-wide barriers per group
// and unit. Six warps each own C/6 output channels; the window (tile_t + 128
// columns) of x and y stays in shared memory, which bounds tile_t to 96 at
// C=192 (the halo is then recomputed 2.3 times) and 400 at C=96. Columns no
// output depends on are skipped, as in K2v-cl.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int NW = 6;
constexpr int NTHREADS = NW * 32;
constexpr int HALO = 128;
constexpr int G = 64;          // time columns per group
constexpr int NG = G / 16;
constexpr int LDG = G + 16;    // bf16 row stride of the staging / z block
constexpr int NU = 3;
constexpr int SMEM_LIMIT = 232448;

struct CfParams {
  const bf16* x;
  bf16* out;
  const bf16* w7;   // (3, 7, C, C) as [unit][tap][in][out]
  const bf16* w1;   // (3, C, C) as [unit][in][out]
  const float* a1;  // (3, C) each
  const float* inv1;
  const float* a2;
  const float* inv2;
  const float* b7;
  const float* b1;
  int B, T, tile_t, use_sin;
  int dil[NU], first[NU];
};

__device__ __forceinline__ float snake(float v, float a, float inv, int use_sin) {
  if (!use_sin) return v * a;
  const float s = sinf(a * v);
  return v + inv * (s * s);
}

inline int cf_smem_bytes(int c, int tile_t) {
  const int ldt = tile_t + HALO + 16;
  return 2 * (2 * c * ldt + c * LDG) + NW * 256 * 4;
}

template <int C>
__global__ void __launch_bounds__(NTHREADS)
res_chain_cf_kernel(const CfParams p) {
  constexpr int MF = C / 96;  // 16-channel fragments per warp
  constexpr int CW = C / NW;
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = p.tile_t + HALO;
  const int LDT = W + 16;
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* Y = X + C * LDT;
  bf16* YS = Y + C * LDT;  // the shifted group of a tap, then the z group
  float* patches = reinterpret_cast<float*>(YS + C * LDG);

  const int t0 = blockIdx.x * p.tile_t;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cbase = warp * CW;
  float* patch = patches + warp * 256;
  const int prow = lane / 2, pcol = (lane & 1) * 8;
  const bf16* xin = p.x + (long long)b * C * p.T;

  // window columns: t = t0 - HALO + wc; columns outside [0, T) are zero
  for (int i = threadIdx.x; i < C * W; i += NTHREADS) {
    const int c = i / W, wc = i % W, t = t0 - HALO + wc;
    X[c * LDT + wc] = (t >= 0 && t < p.T) ? xin[(long long)c * p.T + t] : __float2bfloat16(0.f);
  }
  __syncthreads();

  for (int u = 0; u < NU; ++u) {
    const int d = p.dil[u];
    const float* a1 = p.a1 + u * C;
    const float* inv1 = p.inv1 + u * C;
    const float* a2 = p.a2 + u * C;
    const float* inv2 = p.inv2 + u * C;
    const float* b7 = p.b7 + u * C;
    const float* b1 = p.b1 + u * C;
    const bf16* w7 = p.w7 + (long long)u * 7 * C * C;
    const bf16* w1 = p.w1 + (long long)u * C * C;

    for (int i = threadIdx.x; i < C * W; i += NTHREADS) {
      const int c = i / W, wc = i % W;
      Y[c * LDT + wc] = __float2bfloat16(
          snake(__bfloat162float(X[c * LDT + wc]), a1[c], inv1[c], p.use_sin));
    }
    __syncthreads();

    for (int gs = p.first[u]; gs < W; gs += G) {
      const int ng_now = min(NG, (W - gs) / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][NG];
#pragma unroll
      for (int m = 0; m < MF; ++m)
#pragma unroll
        for (int n = 0; n < NG; ++n) wmma::fill_fragment(acc[m][n], 0.f);

      for (int j = 0; j < 7; ++j) {
        const int shift = (6 - j) * d;
        for (int i = threadIdx.x; i < C * G; i += NTHREADS) {
          const int c = i / G, tt = i % G, wc = gs + tt - shift;
          YS[c * LDG + tt] = (wc >= 0 && gs + tt < W) ? Y[c * LDT + wc] : __float2bfloat16(0.f);
        }
        __syncthreads();
        const bf16* wj = w7 + (long long)j * C * C;
        for (int kk = 0; kk < C / 16; ++kk) {
          // A = W7[j]^T: element (out, in) at wj[in * C + out]
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[MF];
#pragma unroll
          for (int m = 0; m < MF; ++m)
            wmma::load_matrix_sync(fa[m], wj + (long long)kk * 16 * C + cbase + m * 16, C);
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            if (n < ng_now) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
              wmma::load_matrix_sync(fb, YS + kk * 16 * LDG + n * 16, LDG);
#pragma unroll
              for (int m = 0; m < MF; ++m) wmma::mma_sync(acc[m][n], fa[m], fb, acc[m][n]);
            }
          }
        }
        __syncthreads();  // the next tap, or z, overwrites the staging block
      }

      // z = snake2(conv7 + b7) -> bf16, this warp's channels of the group
#pragma unroll
      for (int m = 0; m < MF; ++m) {
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          if (n < ng_now) {
            wmma::store_matrix_sync(patch, acc[m][n], 16, wmma::mem_row_major);
            __syncwarp();
            const int ch = cbase + m * 16 + prow;
            bf16 v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] = __float2bfloat16(snake(patch[prow * 16 + pcol + e] + b7[ch], a2[ch],
                                            inv2[ch], p.use_sin));
            *reinterpret_cast<uint4*>(YS + ch * LDG + n * 16 + pcol) =
                *reinterpret_cast<uint4*>(v);
            __syncwarp();
          }
        }
      }
      __syncthreads();

      // 1x1 product, bias and residual into x
#pragma unroll
      for (int m = 0; m < MF; ++m)
#pragma unroll
        for (int n = 0; n < NG; ++n) wmma::fill_fragment(acc[m][n], 0.f);
      for (int kk = 0; kk < C / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[MF];
#pragma unroll
        for (int m = 0; m < MF; ++m)
          wmma::load_matrix_sync(fa[m], w1 + (long long)kk * 16 * C + cbase + m * 16, C);
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          if (n < ng_now) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, YS + kk * 16 * LDG + n * 16, LDG);
#pragma unroll
            for (int m = 0; m < MF; ++m) wmma::mma_sync(acc[m][n], fa[m], fb, acc[m][n]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MF; ++m) {
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          if (n < ng_now) {
            wmma::store_matrix_sync(patch, acc[m][n], 16, wmma::mem_row_major);
            __syncwarp();
            const int ch = cbase + m * 16 + prow;
            const int wc = gs + n * 16 + pcol;
            bf16* xp = X + ch * LDT + wc;
            bf16 v[8];
            *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(xp);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float o = __bfloat162float(__float2bfloat16(
                  __bfloat162float(v[e]) + (patch[prow * 16 + pcol + e] + b1[ch])));
              // columns before the sequence are the pad: multiply by 0 / 1
              v[e] = __float2bfloat16(o * (t0 - HALO + wc + e >= 0 ? 1.f : 0.f));
            }
            *reinterpret_cast<uint4*>(xp) = *reinterpret_cast<uint4*>(v);
            __syncwarp();
          }
        }
      }
      __syncthreads();
    }
  }

  bf16* xout = p.out + (long long)b * C * p.T;
  for (int i = threadIdx.x; i < C * p.tile_t; i += NTHREADS) {
    const int c = i / p.tile_t, tr = i % p.tile_t, t = t0 + tr;
    if (t < p.T) xout[(long long)c * p.T + t] = X[c * LDT + HALO + tr];
  }
}

template <int C>
int launch(const CfParams& p, int smem, cudaStream_t s) {
  auto kernel = res_chain_cf_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_LIMIT);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.T + p.tile_t - 1) / p.tile_t, p.B);
  kernel<<<grid, NTHREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, C, T) bf16 contiguous, C in {96, 192}; weights and vectors as
// res_chain_var_fwd takes them. tile_t: output columns per block, a multiple
// of 16.
extern "C" int res_chain_cf_fwd(const void* x, void* out, const void* w7, const void* w1,
                                const void* a1, const void* inv1, const void* a2,
                                const void* inv2, const void* b7, const void* b1, int B, int T,
                                int C, int tile_t, int use_sin, void* stream) {
  if ((C != 96 && C != 192) || B < 1 || T < 1 || tile_t < 16 || tile_t % 16)
    return (int)cudaErrorInvalidValue;
  const int smem = cf_smem_bytes(C, tile_t);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  CfParams p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.w7 = static_cast<const bf16*>(w7);
  p.w1 = static_cast<const bf16*>(w1);
  p.a1 = static_cast<const float*>(a1);
  p.inv1 = static_cast<const float*>(inv1);
  p.a2 = static_cast<const float*>(a2);
  p.inv2 = static_cast<const float*>(inv2);
  p.b7 = static_cast<const float*>(b7);
  p.b1 = static_cast<const float*>(b1);
  p.B = B; p.T = T; p.tile_t = tile_t; p.use_sin = use_sin;
  const int dil[NU] = {1, 3, 9};
  int need = HALO;  // first window column that unit u's successors read
  for (int u = NU - 1; u >= 0; --u) {
    p.dil[u] = dil[u];
    p.first[u] = need / 16 * 16;
    need -= 6 * dil[u];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return C == 192 ? launch<192>(p, smem, s) : launch<96>(p, smem, s);
}

extern "C" int res_chain_cf_smem_bytes(int C, int tile_t) { return cf_smem_bytes(C, tile_t); }
