// Kernels K6, K7 and K8: the DiT trunk layer's fp32 elementwise islands,
// sm_90a.
//
// The JAX package leaves these islands to XLA, which fuses them into its
// loops (echo_tts_tpu/core/layers.py:modulate_rms and rms_norm,
// core/rope.py:apply_rope_half_heads, the gates and SwiGLU of
// models/dit.py); it has no Pallas kernel here. In eager PyTorch each is a
// chain of six to eight full-size passes (casts up and back, a square, a
// mean, broadcast products, strided RoPE lanes with a stack and a cat), so
// the chain moves about six times the bytes the work needs. Each kernel here
// reads its bf16 operands once, works in fp32 registers and writes bf16 once.
//
//   K6 trunk_residual_modulate, D = 2048: x <- x + bf16(gate * y) (optional),
//      then h = bf16(x * rsqrt(mean(x^2) + eps) * (1 + scale) + shift), or
//      h = bf16(x * rsqrt(mean(x^2) + eps) * w) (the final out_norm, always
//      after the last layer's residual); x is updated in place, h written.
//      gate, shift and scale are (B, D), one row a batch row, indexed by
//      row: nothing broadcast is materialised.
//   K7 trunk_qk_norm_rope: per head of q and of k (one launch for both), the
//      RMS-norm with the (H, Dh) weight, rounded to bf16, then the rotation
//      of adjacent lane pairs on the heads below n_rot (half-head RoPE over
//      the local heads of a tp rank), tables (S, Dh/2) shared or
//      (B, S, Dh/2) one a row; in place, in the (G, B, S, H, Dh) layout K1
//      reads.
//   K8 trunk_gated_product: out = a * bf16(sigmoid(b)) (the attention gate)
//      or bf16(silu(a)) * b (SwiGLU), one template; out may be a.
//
// Every rounding point of the eager chain is kept: bf16 where it casts
// (gate * y before the residual add, the normed q/k before RoPE, sigmoid and
// silu before their products, every output), fp32 everywhere else, each
// product and sum rounded on its own (__fmul_rn / __fadd_rn: the compiler
// never contracts them into an FMA, which the eager chain, one kernel an op,
// cannot do either). rsqrtf and expf are the functions PyTorch's kernels call
// (the build has no fast math). The one difference is the order of the sum
// of squares inside a row or a head.
//
// Bound. Bytes, a few operations an element: K6 reads x (and y) and writes
// x (when y is given) and h, 2·D·(2 or 4) bytes a row plus the (B, D)
// operands once; K7 reads and writes q and k, 8·Dh bytes a head; K8 reads
// two operands and writes one, 6 bytes an element; all at 3.35 TB/s.
//
// Design. K6: D = 2048 alone (the width of every configuration; any other
// takes the plain chain), one warp group (128 threads) a row, the row held
// in registers (two 16-byte chunks a thread), every load of a thread issued
// before the first arithmetic, one butterfly sum a warp and the four warps' parts met in
// shared memory in a fixed order. K7: 16 lanes a head of Dh = 128 (one
// 16-byte chunk a lane: eight values, four pairs, the pairs' cos and sin one
// float4 each), the sum of squares a 16-lane butterfly, 16 heads a block;
// blockIdx.y picks q or k. K8: one 16-byte chunk a thread (the trunk's
// widths, 2048 and 5888, are multiples of 8).
#include "trunk_rows.cuh"

using namespace trunk_rows;

namespace {

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// x (M, K6_D), rows in (..., B, S) order, so row r belongs to batch row
// (r / S) % B; y (M, K6_D) and gate (B, K6_D) when RES, x + gate * y then
// written to xo (x itself, in place, outside autograd); MOD: mul = scale
// (B, K6_D), add = shift (B, K6_D); else mul = w (K6_D,). h (M, K6_D).
template <bool RES, bool MOD>
__global__ void __launch_bounds__(K6_THREADS)
    trunk_residual_modulate_kernel(const uint16_t* x, uint16_t* xo,
                                   const uint16_t* __restrict__ y,
                                   const uint16_t* __restrict__ gate,
                                   const uint16_t* __restrict__ mul,
                                   const uint16_t* __restrict__ add, uint16_t* __restrict__ h,
                                   int S, int B, float eps) {
  __shared__ float part[K6_THREADS / 32];
  const int row = blockIdx.x;
  const int b = (row / S) % B;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * K6_D);
  uint4* xw = reinterpret_cast<uint4*>(xo + static_cast<size_t>(row) * K6_D);

  uint4 xc[K6_CPT], yc[K6_CPT], gc[K6_CPT];
#pragma unroll
  for (int i = 0; i < K6_CPT; ++i) {
    const int c = threadIdx.x + i * K6_THREADS;
    xc[i] = xr[c];
    if constexpr (RES) {
      yc[i] = __ldg(reinterpret_cast<const uint4*>(y + static_cast<size_t>(row) * K6_D) + c);
      gc[i] = __ldg(reinterpret_cast<const uint4*>(gate + static_cast<size_t>(b) * K6_D) + c);
    }
  }
  // the modulation's operands, in flight during the reduction
  uint4 mc[K6_CPT], ac[K6_CPT];
  const size_t mb = MOD ? static_cast<size_t>(b) * K6_D : 0;
  const uint4* mrow = reinterpret_cast<const uint4*>(mul + mb);
  const uint4* arow = reinterpret_cast<const uint4*>(add + mb);
#pragma unroll
  for (int i = 0; i < K6_CPT; ++i) {
    const int c = threadIdx.x + i * K6_THREADS;
    mc[i] = __ldg(mrow + c);
    if constexpr (MOD) ac[i] = __ldg(arow + c);
  }

  float v[K6_CPT][8];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < K6_CPT; ++i) {
    unpack8(xc[i], v[i]);
    if constexpr (RES) {
      float yv[8], gv[8];
      unpack8(yc[i], yv);
      unpack8(gc[i], gv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[i][j] = round_bf16(__fadd_rn(v[i][j], round_bf16(__fmul_rn(gv[j], yv[j]))));
      xw[threadIdx.x + i * K6_THREADS] = pack8(v[i]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(v[i][j], v[i][j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = part[0];
#pragma unroll
  for (int w = 1; w < K6_THREADS / 32; ++w) total = __fadd_rn(total, part[w]);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(K6_D)), eps));

  uint4* hr = reinterpret_cast<uint4*>(h + static_cast<size_t>(row) * K6_D);
#pragma unroll
  for (int i = 0; i < K6_CPT; ++i) {
    float mv[8], o[8];
    unpack8(mc[i], mv);
    if constexpr (MOD) {
      float av[8];
      unpack8(ac[i], av);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], r), __fadd_rn(mv[j], 1.f)), av[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = __fmul_rn(__fmul_rn(v[i][j], r), mv[j]);
    }
    hr[threadIdx.x + i * K6_THREADS] = pack8(o);
  }
}

template <bool RES, bool MOD>
cudaError_t launch_k6(const void* x, void* xo, const void* y, const void* gate, const void* mul,
                      const void* add, void* h, int M, int S, int B, float eps, cudaStream_t st) {
  trunk_residual_modulate_kernel<RES, MOD><<<M, K6_THREADS, 0, st>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(xo), static_cast<const uint16_t*>(y),
      static_cast<const uint16_t*>(gate), static_cast<const uint16_t*>(mul),
      static_cast<const uint16_t*>(add), static_cast<uint16_t*>(h), S, B, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

// q, k (n_heads, 128) bf16 heads in (..., B, S, H) order, the results
// written to qo, ko (q and k themselves, in place, outside autograd); qw, kw
// (H, 128) bf16; cos, sin fp32 (S, 64), or (B, S, 64) when ROWS; heads
// h % H < n_rot are rotated.
template <bool ROWS>
__global__ void __launch_bounds__(K7_THREADS)
    trunk_qk_norm_rope_kernel(const uint16_t* q, const uint16_t* k, uint16_t* qo, uint16_t* ko,
                              const uint16_t* __restrict__ qw, const uint16_t* __restrict__ kw,
                              const float* __restrict__ cos, const float* __restrict__ sin,
                              int n_heads, int H, int S, int B, int n_rot, float eps) {
  const uint16_t* t = blockIdx.y ? k : q;
  uint16_t* to = blockIdx.y ? ko : qo;
  const uint16_t* w = blockIdx.y ? kw : qw;
  const int head = blockIdx.x * (K7_THREADS / 16) + (threadIdx.x >> 4);
  const int lane = threadIdx.x & 15;
  const bool valid = head < n_heads;
  const int hl = valid ? head % H : 0;
  const size_t at = static_cast<size_t>(valid ? head : 0) * K7_DH;
  const uint4 c = valid ? reinterpret_cast<const uint4*>(t + at)[lane] : make_uint4(0u, 0u, 0u, 0u);
  const uint4 wc = __ldg(reinterpret_cast<const uint4*>(w + hl * K7_DH) + lane);
  const bool rot = valid && hl < n_rot;
  float4 cc = make_float4(0.f, 0.f, 0.f, 0.f), sc = cc;
  if (rot) {
    const int row = head / H;
    const int s = row % S;
    const size_t trow = ROWS ? static_cast<size_t>((row / S) % B) * S + s : static_cast<size_t>(s);
    cc = __ldg(reinterpret_cast<const float4*>(cos + trow * (K7_DH / 2)) + lane);
    sc = __ldg(reinterpret_cast<const float4*>(sin + trow * (K7_DH / 2)) + lane);
  }

  float v[8], wv[8];
  unpack8(c, v);
  unpack8(wc, wv);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(K7_DH)), eps));
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = round_bf16(__fmul_rn(__fmul_rn(v[j], r), wv[j]));
  if (rot) {
    const float cs[4] = {cc.x, cc.y, cc.z, cc.w}, sn[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xr = v[2 * i], xi = v[2 * i + 1];
      v[2 * i] = __fsub_rn(__fmul_rn(xr, cs[i]), __fmul_rn(xi, sn[i]));
      v[2 * i + 1] = __fadd_rn(__fmul_rn(xr, sn[i]), __fmul_rn(xi, cs[i]));
    }
  }
  if (valid) reinterpret_cast<uint4*>(to + at)[lane] = pack8(v);
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

// ACT 0: a * bf16(sigmoid(b)); ACT 1: bf16(silu(a)) * b; as PyTorch's
// kernels compute sigmoid (1 / (1 + exp(-x))) and silu (x / (1 + exp(-x)))
template <int ACT>
__device__ __forceinline__ float gated(float a, float b) {
  if constexpr (ACT == 0) {
    return __fmul_rn(a, round_bf16(__fdiv_rn(1.f, __fadd_rn(1.f, expf(-b)))));
  } else {
    return __fmul_rn(round_bf16(__fdiv_rn(a, __fadd_rn(1.f, expf(-a)))), b);
  }
}

// out may be a (in place): each thread reads its elements before it writes them
template <int ACT>
__global__ void __launch_bounds__(K8_THREADS)
    trunk_gated_product_kernel(uint16_t* out, const uint16_t* a, const uint16_t* __restrict__ b,
                               long long n) {
  const long long c = static_cast<long long>(blockIdx.x) * K8_THREADS + threadIdx.x;
  if (c >= n / 8) return;
  const uint4 ac = reinterpret_cast<const uint4*>(a)[c];
  const uint4 bc = __ldg(reinterpret_cast<const uint4*>(b) + c);
  float av[8], bv[8];
  unpack8(ac, av);
  unpack8(bc, bv);
#pragma unroll
  for (int j = 0; j < 8; ++j) av[j] = gated<ACT>(av[j], bv[j]);
  reinterpret_cast<uint4*>(out)[c] = pack8(av);
}

}  // namespace

// K6. x, y, h (M, 2048) bf16 contiguous, 16-byte aligned, rows in
// (..., B, S) order. With y (and gate (B, 2048)) x + gate * y is written to
// xo, or to x in place where xo is null; with add, mul = scale (B, 2048) and
// add = shift (B, 2048); without, mul = the norm's weight (2048,), and y is
// required (the trunk's out_norm always takes the last layer's MLP
// residual).
extern "C" int trunk_residual_modulate(void* x, const void* y, const void* gate, const void* mul,
                                       const void* add, void* h, void* xo, int M, int D, int S,
                                       int B, float eps, void* stream) {
  const bool res = y != nullptr, mod = add != nullptr;
  if (!xo) xo = x;
  if (M < 1 || D != K6_D || S < 1 || B < 1 || !x || !mul || !h || (res && !gate) ||
      !(res || mod) || !aligned({x, y, gate, mul, add, h, xo}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (res && mod)
    return (int)launch_k6<true, true>(x, xo, y, gate, mul, add, h, M, S, B, eps, st);
  if (res) return (int)launch_k6<true, false>(x, xo, y, gate, mul, add, h, M, S, B, eps, st);
  return (int)launch_k6<false, true>(x, xo, y, gate, mul, add, h, M, S, B, eps, st);
}

// K7. q, k (n_heads, 128) bf16 contiguous, 16-byte aligned, heads in
// (..., B, S, H) order; the results written to qo, ko, or to q and k in
// place where those are null; qw, kw (H, 128) bf16; cos, sin fp32 (S, 64)
// or, with rows, (B, S, 64); n_rot heads of each position rotated (cos and
// sin may be null when n_rot is 0).
extern "C" int trunk_qk_norm_rope(void* q, void* k, void* qo, void* ko, const void* qw,
                                  const void* kw, const void* cos, const void* sin, int n_heads,
                                  int H, int S, int B, int n_rot, int rows, float eps,
                                  void* stream) {
  if (!qo) qo = q;
  if (!ko) ko = k;
  if (n_heads < 1 || H < 1 || S < 1 || B < 1 || n_rot < 0 || (n_rot > 0 && (!cos || !sin)) ||
      !aligned({q, k, qo, ko, qw, kw, cos, sin}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_heads + K7_THREADS / 16 - 1) / (K7_THREADS / 16), 2);
  const uint16_t *qp = static_cast<const uint16_t*>(q), *kp = static_cast<const uint16_t*>(k);
  uint16_t *qop = static_cast<uint16_t*>(qo), *kop = static_cast<uint16_t*>(ko);
  const uint16_t *qwp = static_cast<const uint16_t*>(qw), *kwp = static_cast<const uint16_t*>(kw);
  const float *cp = static_cast<const float*>(cos), *sp = static_cast<const float*>(sin);
  if (rows)
    trunk_qk_norm_rope_kernel<true><<<grid, K7_THREADS, 0, st>>>(qp, kp, qop, kop, qwp, kwp, cp,
                                                                 sp, n_heads, H, S, B, n_rot, eps);
  else
    trunk_qk_norm_rope_kernel<false><<<grid, K7_THREADS, 0, st>>>(qp, kp, qop, kop, qwp, kwp, cp,
                                                                  sp, n_heads, H, S, B, n_rot, eps);
  return (int)cudaGetLastError();
}

// K8. out, a, b (n,) bf16 contiguous, 16-byte aligned, n a multiple of 8;
// out may be a. act 0: a * sigmoid(b); act 1: silu(a) * b.
extern "C" int trunk_gated_product(void* out, const void* a, const void* b, long long n, int act,
                                   void* stream) {
  if (n < 1 || n % 8 || act < 0 || act > 1 || !aligned({out, a, b}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n / 8 + K8_THREADS - 1) / K8_THREADS);
  uint16_t* op = static_cast<uint16_t*>(out);
  const uint16_t *ap = static_cast<const uint16_t*>(a), *bp = static_cast<const uint16_t*>(b);
  if (act == 0)
    trunk_gated_product_kernel<0><<<blocks, K8_THREADS, 0, st>>>(op, ap, bp, n);
  else
    trunk_gated_product_kernel<1><<<blocks, K8_THREADS, 0, st>>>(op, ap, bp, n);
  return (int)cudaGetLastError();
}
