// Kernel K2s: the fused three-unit residual chain of the S1-DAC decoder tail
// in one launch with the chain's snake modes, channels-last (B, T, C) bf16,
// sm_90a. First design (WMMA). The template carries more flags than K2s
// sets (the chain variants' snake modes, live_mode, tap_offsets, packed
// taps); K2s fixes them, and only its seven-tap instantiations are built.
//
// K2s replaces the three bodies of scripts/bench_conv_variants.py:make_kernel
// (which the script runs through echo_tts_tpu/ops/pallas_conv.py:
// fused_res_chain_cl). It is the chain
//     x <- x + conv1x1(snake(conv7_dilated_causal(snake(x)) + b7)) + b1
// for dilations (1, 3, 9), rows before the sequence start standing for each
// conv's causal zero pad, with the snake exact (sinf), identity, or the
// range-reduced Taylor cosine of _snake_poly; the pad rows are re-zeroed by
// select, all seven taps read at their offsets.
//
// Bound. 3 * 2*T*C*C*8 FLOPs over one read and one write of T*C bf16: 12*C
// FLOP per byte, 1152 at C=96 and 2304 at C=192, above the 295 FLOP/byte
// ridge: tensor-core operations.
//
// Design and its cost. A block of six warps holds the window (tile_t + 80
// rows) twice in shared memory, x and y = snake1(x), with 64 zero rows above
// y for the causal pad, so a tap shift is a row offset of the A operand (rows
// are padded to C + 16 elements to keep every shifted row 32-byte aligned for
// WMMA, at the price of 4-way bank conflicts). Each warp owns C/6 output
// channels and walks the window in groups of 16*MG rows, accumulators in
// register fragments; the conv7 weights (1.55 MB for three units at C=192)
// cannot stay in shared memory and every group streams them from L2 as WMMA B
// operands. snake2 goes through a per-warp fp32 patch into a bf16 z group in
// shared memory, the 1x1 product reads it, and its epilogue adds bias and
// residual into x in place. Shared memory bounds the tile: at C=192 x and y
// take 416 bytes a row, so tile_t <= 96; at C=96 tile_t up to 320. Rows that
// no output row depends on are skipped (unit u starts at the first 16-row
// strip its successors need), which changes no result.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

enum { SNAKE_SIN = 0, SNAKE_SIN2 = 1, SNAKE_LINEAR = 2, SNAKE_IDENTITY = 3, SNAKE_COS = 4 };
enum { LIVE_WHERE = 0, LIVE_MULT = 1, LIVE_OFF = 2 };

namespace {

constexpr int NW = 6;         // warps per block; each owns C/6 output channels
constexpr int NTHREADS = NW * 32;
constexpr int HALO = 80;      // receptive extent 6*(1+3+9) = 78, rounded to 16
constexpr int PADR = 64;      // zero rows above y (largest tap shift is 54)
constexpr int NU = 3;
constexpr int SMEM_LIMIT = 232448;

struct ChainParams {
  const bf16* x;
  bf16* out;
  const bf16* w7;    // (3, 7, C, C) as [unit][tap][in][out]
  const bf16* w1;    // (3, C, C) as [unit][in][out]
  const float* a1;   // (3, C) each: snake alphas, their 1/(a + 1e-9), biases
  const float* inv1;
  const float* a2;
  const float* inv2;
  const float* b7;
  const float* b1;
  int B, T, tile_t, snake, snake_bf16, live_mode, tap_offsets;
  int dil[NU], first[NU];
};

__device__ __forceinline__ float rb(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float sin2_poly(float t) {
  // sin^2(t) = z P(z), z = f^2, f = t/pi - round(t/pi) (round half to even)
  const float r = t * 0.3183098861837907f;
  const float f = r - rintf(r);
  const float z = f * f;
  float p = 0.7419801209608292f;
  p = p * z + -3.9130777124895926f;
  p = p * z + 13.206610352068088f;
  p = p * z + -30.12175436025362f;
  p = p * z + 42.72838511692447f;
  p = p * z + -32.469696645585955f;
  p = p * z + 9.869604400158666f;
  return z * p;
}

__device__ __forceinline__ float snake_cos_poly(float v, float a) {
  // v + (1 - cos(2 a v)) / (2 (a + 1e-9)), Taylor cosine after range reduction
  const float z = (2.0f * a) * v;
  const float n = rintf(z * 0.15915494309189535f);
  const float r = z - n * 6.283185307179586f;
  const float u = r * r;
  float c = -1.0f / 87178291200.0f;
  c = c * u + 1.0f / 479001600.0f;
  c = c * u + -1.0f / 3628800.0f;
  c = c * u + 1.0f / 40320.0f;
  c = c * u + -1.0f / 720.0f;
  c = c * u + 1.0f / 24.0f;
  c = c * u + -0.5f;
  const float cosr = c * u + 1.0f;
  return v + (1.0f - cosr) * (0.5f / (a + 1e-9f));
}

__device__ __forceinline__ float snake(float v, float a, float inv, int mode, int b16) {
  switch (mode) {
    case SNAKE_SIN:
      if (b16) {  // every operation rounded to bf16, as bf16 arithmetic does
        v = rb(v);
        const float s = rb(sinf(rb(a * v)));
        return rb(v + rb(inv * rb(s * s)));
      } else {
        const float s = sinf(a * v);
        return v + inv * (s * s);
      }
    case SNAKE_SIN2:
      return v + inv * sin2_poly(a * v);
    case SNAKE_LINEAR:
      return b16 ? rb(rb(v) * a) : v * a;
    case SNAKE_COS:
      return snake_cos_poly(v, a);
    default:
      return v;
  }
}

inline int chain_smem_bytes(int c, int tile_t, bool pack) {
  const int ld = c + 16, w = tile_t + HALO, g = 16 * (pack ? 2 : 8);
  const int zp = pack ? g * (7 * c + 16) : g * ld;
  return 2 * (w * ld + (PADR + w) * ld + zp) + NW * 256 * 4;
}

template <int C, int MG, bool PACK>
__global__ void __launch_bounds__(NTHREADS)
res_chain_cl_kernel(const ChainParams p) {
  constexpr int LD = C + 16;     // bf16 row stride of x, y, z
  constexpr int NF = C / 96;     // 16-channel fragments per warp
  constexpr int CW = C / NW;     // channels per warp
  constexpr int G = 16 * MG;     // rows per group
  constexpr int LDPK = 7 * C + 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = p.tile_t + HALO;
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* Y = X + W * LD;
  bf16* ZP = Y + (PADR + W) * LD;  // z group; under PACK also the packed taps
  float* patches = reinterpret_cast<float*>(ZP + (PACK ? G * LDPK : G * LD));

  const int t0 = blockIdx.x * p.tile_t;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cbase = warp * CW;
  float* patch = patches + warp * 256;
  const int prow = lane / 2, pcol = (lane & 1) * 8;
  const bf16* xin = p.x + (long long)b * p.T * C;
  constexpr int VEC = C / 8;

  // window rows: t = t0 - HALO + wr; rows outside [0, T) are zero
  for (int i = threadIdx.x; i < W * VEC; i += NTHREADS) {
    const int wr = i / VEC, c = (i % VEC) * 8, t = t0 - HALO + wr;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t >= 0 && t < p.T) val = *reinterpret_cast<const uint4*>(xin + (long long)t * C + c);
    *reinterpret_cast<uint4*>(X + wr * LD + c) = val;
  }
  for (int i = threadIdx.x; i < PADR * LD / 8; i += NTHREADS)
    reinterpret_cast<uint4*>(Y)[i] = make_uint4(0, 0, 0, 0);
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

    // y = snake1(x) over the whole window
    for (int i = threadIdx.x; i < W * VEC; i += NTHREADS) {
      const int wr = i / VEC, c = (i % VEC) * 8;
      bf16 v[8];
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(X + wr * LD + c);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = __float2bfloat16(snake(__bfloat162float(v[e]), a1[c + e], inv1[c + e],
                                      p.snake, p.snake_bf16));
      *reinterpret_cast<uint4*>(Y + (PADR + wr) * LD + c) = *reinterpret_cast<uint4*>(v);
    }
    __syncthreads();

    for (int gs = p.first[u]; gs < W; gs += G) {
      const int mg_now = min(MG, (W - gs) / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MG][NF];
#pragma unroll
      for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[m][n], 0.f);

      if (PACK) {
        // the seven shifted groups side by side: one product of depth 7*C
        for (int i = threadIdx.x; i < G * 7 * VEC; i += NTHREADS) {
          const int row = i / (7 * VEC), rest = i % (7 * VEC);
          const int j = rest / VEC, c = (rest % VEC) * 8;
          const int shift = (6 - j) * d;  // the packed form ignores tap_offsets
          uint4 val = make_uint4(0, 0, 0, 0);
          if (gs + row < W)
            val = *reinterpret_cast<const uint4*>(Y + (PADR + gs + row - shift) * LD + c);
          *reinterpret_cast<uint4*>(ZP + row * LDPK + j * C + c) = val;
        }
        __syncthreads();
        for (int kk = 0; kk < 7 * C / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[NF];
#pragma unroll
          for (int n = 0; n < NF; ++n)
            wmma::load_matrix_sync(fb[n], w7 + (long long)kk * 16 * C + cbase + n * 16, C);
#pragma unroll
          for (int m = 0; m < MG; ++m) {
            if (m < mg_now) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
              wmma::load_matrix_sync(fa, ZP + m * 16 * LDPK + kk * 16, LDPK);
#pragma unroll
              for (int n = 0; n < NF; ++n) wmma::mma_sync(acc[m][n], fa, fb[n], acc[m][n]);
            }
          }
        }
        __syncthreads();  // z overwrites the packed taps
      } else {
        for (int j = 0; j < 7; ++j) {
          const int shift = p.tap_offsets ? (6 - j) * d : 6 * d;
          const bf16* ybase = Y + (PADR + gs - shift) * LD;
          const bf16* wj = w7 + (long long)j * C * C;
          for (int kk = 0; kk < C / 16; ++kk) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[NF];
#pragma unroll
            for (int n = 0; n < NF; ++n)
              wmma::load_matrix_sync(fb[n], wj + (long long)kk * 16 * C + cbase + n * 16, C);
#pragma unroll
            for (int m = 0; m < MG; ++m) {
              if (m < mg_now) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
                wmma::load_matrix_sync(fa, ybase + m * 16 * LD + kk * 16, LD);
#pragma unroll
                for (int n = 0; n < NF; ++n) wmma::mma_sync(acc[m][n], fa, fb[n], acc[m][n]);
              }
            }
          }
        }
      }

      // z = snake2(conv7 + b7) -> bf16, this warp's channels of the group
#pragma unroll
      for (int m = 0; m < MG; ++m) {
        if (m < mg_now) {
#pragma unroll
          for (int n = 0; n < NF; ++n) {
            wmma::store_matrix_sync(patch, acc[m][n], 16, wmma::mem_row_major);
            __syncwarp();
            const int ch = cbase + n * 16 + pcol;
            bf16 v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] = __float2bfloat16(snake(patch[prow * 16 + pcol + e] + b7[ch + e], a2[ch + e],
                                            inv2[ch + e], p.snake, p.snake_bf16));
            *reinterpret_cast<uint4*>(ZP + (m * 16 + prow) * LD + ch) =
                *reinterpret_cast<uint4*>(v);
            __syncwarp();
          }
        }
      }
      __syncthreads();

      // 1x1 product, bias and residual into x
#pragma unroll
      for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[m][n], 0.f);
      for (int kk = 0; kk < C / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[NF];
#pragma unroll
        for (int n = 0; n < NF; ++n)
          wmma::load_matrix_sync(fb[n], w1 + (long long)kk * 16 * C + cbase + n * 16, C);
#pragma unroll
        for (int m = 0; m < MG; ++m) {
          if (m < mg_now) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::load_matrix_sync(fa, ZP + m * 16 * LD + kk * 16, LD);
#pragma unroll
            for (int n = 0; n < NF; ++n) wmma::mma_sync(acc[m][n], fa, fb[n], acc[m][n]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MG; ++m) {
        if (m < mg_now) {
#pragma unroll
          for (int n = 0; n < NF; ++n) {
            wmma::store_matrix_sync(patch, acc[m][n], 16, wmma::mem_row_major);
            __syncwarp();
            const int ch = cbase + n * 16 + pcol;
            const int wr = gs + m * 16 + prow;
            const bool live = t0 - HALO + wr >= 0;  // rows before the sequence are the pad
            bf16* xp = X + wr * LD + ch;
            bf16 v[8];
            *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(xp);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              bf16 o = __float2bfloat16(__bfloat162float(v[e]) + (patch[prow * 16 + pcol + e] +
                                                                  b1[ch + e]));
              if (p.live_mode == LIVE_WHERE) o = live ? o : __float2bfloat16(0.f);
              else if (p.live_mode == LIVE_MULT)
                o = __float2bfloat16(__bfloat162float(o) * (live ? 1.f : 0.f));
              v[e] = o;
            }
            *reinterpret_cast<uint4*>(xp) = *reinterpret_cast<uint4*>(v);
            __syncwarp();
          }
        }
      }
      __syncthreads();
    }
  }

  bf16* xout = p.out + (long long)b * p.T * C;
  for (int i = threadIdx.x; i < p.tile_t * VEC; i += NTHREADS) {
    const int tr = i / VEC, c = (i % VEC) * 8, t = t0 + tr;
    if (t < p.T)
      *reinterpret_cast<uint4*>(xout + (long long)t * C + c) =
          *reinterpret_cast<const uint4*>(X + (HALO + tr) * LD + c);
  }
}

template <int C, int MG, bool PACK>
int launch(const ChainParams& p, int smem, cudaStream_t s) {
  auto kernel = res_chain_cl_kernel<C, MG, PACK>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_LIMIT);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.T + p.tile_t - 1) / p.tile_t, p.B);
  kernel<<<grid, NTHREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

int run_chain(const void* x, void* out, const void* w7, const void* w1, const void* a1,
              const void* inv1, const void* a2, const void* inv2, const void* b7,
              const void* b1, int B, int T, int C, int tile_t, int snake, int snake_bf16,
              int live_mode, int tap_offsets, void* stream) {
  if ((C != 96 && C != 192) || B < 1 || T < 1 || tile_t < 16 || tile_t % 16 ||
      snake < 0 || snake > SNAKE_COS || live_mode < 0 || live_mode > LIVE_OFF)
    return (int)cudaErrorInvalidValue;
  const int smem = chain_smem_bytes(C, tile_t, false);  // K2s stages no packed taps
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  ChainParams p;
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
  p.B = B; p.T = T; p.tile_t = tile_t; p.snake = snake; p.snake_bf16 = snake_bf16;
  p.live_mode = live_mode; p.tap_offsets = tap_offsets;
  const int dil[NU] = {1, 3, 9};
  int need = HALO;  // first window row that unit u's successors read
  for (int u = NU - 1; u >= 0; --u) {
    p.dil[u] = dil[u];
    p.first[u] = need / 16 * 16;
    need -= 6 * dil[u];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return C == 192 ? launch<192, 8, false>(p, smem, s) : launch<96, 8, false>(p, smem, s);
}

}  // namespace

// x, out: (B, T, C) bf16 contiguous, C in {96, 192}; w7: (3, 7, C, C) bf16 as
// [unit][tap][in][out]; w1: (3, C, C) bf16 as [unit][in][out]; a1, inv1, a2,
// inv2, b7, b1: (3, C) fp32. tile_t: output rows per block, a multiple of 16.
// K2s: K2's chain (pad rows re-zeroed by select, seven taps) with the snake
// exact (sinf), none (identity) or poly (Taylor cosine); same operands.
extern "C" int res_chain_snake_fwd(const void* x, void* out, const void* w7, const void* w1,
                                   const void* a1, const void* inv1, const void* a2,
                                   const void* inv2, const void* b7, const void* b1, int B,
                                   int T, int C, int tile_t, int snake, void* stream) {
  if (snake != SNAKE_SIN && snake != SNAKE_IDENTITY && snake != SNAKE_COS)
    return (int)cudaErrorInvalidValue;
  return run_chain(x, out, w7, w1, a1, inv1, a2, inv2, b7, b1, B, T, C, tile_t, snake, 0,
                   LIVE_WHERE, 1, stream);
}

extern "C" int res_chain_snake_smem_bytes(int C, int tile_t) {
  return chain_smem_bytes(C, tile_t, false);
}
