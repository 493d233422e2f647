// The backward kernels of K6, K7 and K8 (trunk_rows.cu): the gradients of
// the DiT trunk layer's fp32 elementwise islands under autograd, sm_90a.
//
// The JAX package differentiates these islands through XLA's fused loops;
// it has no Pallas kernel here. In eager PyTorch autograd walks each island's
// chain backwards op by op (the casts, the broadcast products, the square
// and mean of the norm, RoPE's strided lanes), a dozen or more full-size
// passes a chain. Each kernel here reads its bf16 operands once, works in
// fp32 registers and writes bf16 once.
//
//   K6 bwd (trunk_residual_modulate_bwd): x' = x + gate * y is the residual
//      sum the forward wrote, h = x' * r * (1 + scale) + shift with
//      r = rsqrt(mean(x'^2) + eps) (or h = x' * r * w, the out_norm). From
//      h's gradient dh and x''s own gradient from its later uses dxi:
//      dn = dh * (1 + scale) (or dh * w), and as autograd of the chain
//      computes it, dx' = bf16(bf16(dn * r + (dv / D) * (2 x')) + dxi) with
//      dv = (-0.5 * sum(dn * x')) * r^3; the residual passes dx' to x as it
//      is and gate * dx' to y.
//   K7 bwd (trunk_qk_norm_rope_bwd): per head of q and of k, the inverse
//      rotation of a rotated head's gradient (d xr = g_r c + g_i s,
//      d xi = g_i c - g_r s), rounded to bf16 where the forward's normed
//      head was, then the weighted RMS-norm's backward over the head's 128
//      lanes from the forward's input.
//   K8 bwd (trunk_gated_product_bwd): out = a * s, s = bf16(sigmoid(b)):
//      da = dout * s, db = ((ds * (1 - s)) * s) with ds = bf16(dout * a), as
//      PyTorch's CUDA sigmoid_backward computes it in bf16, each of 1 - s
//      and the two products rounded; out = g * b, g = bf16(silu(a)):
//      db = dout * g, da = (bf16(dout * b) * sig) * (1 + a * (1 - sig)), as
//      its silu_backward computes it in fp32 (whose kernel the compiler
//      contracts into one FMA).
//
// Every rounding point of autograd over the plain chain is kept: bf16 where
// a forward op cast (the gradient of each cast's input is rounded to its
// dtype, and gradients of one tensor are summed in its dtype), fp32
// elsewhere, each product and sum rounded on its own (__fmul_rn,
// __fadd_rn). The one difference is the order of each row's or head's two
// sums (of x'^2, recomputed, and of dn * x').
//
// Bound. Bytes: K6 bwd reads x', dh and dxi and writes dx' and gate * dx',
// 10 bytes an element (8 without dxi, the out_norm); K7 bwd reads the
// forward's input and the gradient and writes one gradient, 6 bytes an
// element; K8 bwd reads three operands and writes two, 10 bytes an element;
// all at 3.35 TB/s.
//
// Design: the forward kernels' layouts. K6: one warp group a row of 2048,
// the row in registers, every load issued before the first arithmetic, both
// sums in one butterfly, the four warps' parts met in shared memory in a
// fixed order. K7: 16 lanes a head (one 16-byte chunk a lane), both sums one
// 16-lane butterfly, 16 heads a block, blockIdx.y picks q or k. K8: one
// 16-byte chunk a thread.
#include "trunk_rows.cuh"

using namespace trunk_rows;

namespace {

// ---------------------------------------------------------------------------
// K6 bwd
// ---------------------------------------------------------------------------

// xp, dh (M, K6_D), rows in (..., B, S) order; dxi (M, K6_D) when DXI; MOD:
// mul = scale (B, K6_D), else the norm's weight (K6_D,); gate (B, K6_D) and
// dy when GATE. dx (M, K6_D).
template <bool MOD, bool DXI, bool GATE>
__global__ void __launch_bounds__(K6_THREADS)
    trunk_residual_modulate_bwd_kernel(const uint16_t* __restrict__ xp,
                                       const uint16_t* __restrict__ dh,
                                       const uint16_t* __restrict__ dxi,
                                       const uint16_t* __restrict__ mul,
                                       const uint16_t* __restrict__ gate,
                                       uint16_t* __restrict__ dx, uint16_t* __restrict__ dy,
                                       int S, int B, float eps) {
  __shared__ float part[2][K6_THREADS / 32];
  const int row = blockIdx.x;
  const int b = (row / S) % B;
  const size_t at = static_cast<size_t>(row) * K6_D;
  const uint4* xr = reinterpret_cast<const uint4*>(xp + at);
  const uint4* dr = reinterpret_cast<const uint4*>(dh + at);
  const uint4* ir = reinterpret_cast<const uint4*>(dxi + at);
  const uint4* mr =
      reinterpret_cast<const uint4*>(mul + (MOD ? static_cast<size_t>(b) * K6_D : 0));
  const uint4* gr = reinterpret_cast<const uint4*>(gate + static_cast<size_t>(b) * K6_D);

  uint4 xc[K6_CPT], dc[K6_CPT], mc[K6_CPT], ic[K6_CPT], gc[K6_CPT];
#pragma unroll
  for (int i = 0; i < K6_CPT; ++i) {
    const int c = threadIdx.x + i * K6_THREADS;
    xc[i] = __ldg(xr + c);
    dc[i] = __ldg(dr + c);
    mc[i] = __ldg(mr + c);
    if constexpr (DXI) ic[i] = __ldg(ir + c);
    if constexpr (GATE) gc[i] = __ldg(gr + c);
  }

  float x[K6_CPT][8], dn[K6_CPT][8];
  float ss = 0.f, sd = 0.f;
#pragma unroll
  for (int i = 0; i < K6_CPT; ++i) {
    float dv[8], mv[8];
    unpack8(xc[i], x[i]);
    unpack8(dc[i], dv);
    unpack8(mc[i], mv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dn[i][j] = __fmul_rn(dv[j], MOD ? __fadd_rn(mv[j], 1.f) : mv[j]);
      ss = __fadd_rn(ss, __fmul_rn(x[i][j], x[i][j]));
      sd = __fadd_rn(sd, __fmul_rn(dn[i][j], x[i][j]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    sd = __fadd_rn(sd, __shfl_xor_sync(0xffffffffu, sd, off));
  }
  if ((threadIdx.x & 31) == 0) {
    part[0][threadIdx.x >> 5] = ss;
    part[1][threadIdx.x >> 5] = sd;
  }
  __syncthreads();
  float tss = part[0][0], tsd = part[1][0];
#pragma unroll
  for (int w = 1; w < K6_THREADS / 32; ++w) {
    tss = __fadd_rn(tss, part[0][w]);
    tsd = __fadd_rn(tsd, part[1][w]);
  }
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(tss, static_cast<float>(K6_D)), eps));
  const float c = __fdiv_rn(__fmul_rn(__fmul_rn(-0.5f, tsd), __fmul_rn(__fmul_rn(r, r), r)),
                            static_cast<float>(K6_D));

  uint4* dxr = reinterpret_cast<uint4*>(dx + at);
  uint4* dyr = reinterpret_cast<uint4*>(dy + at);
#pragma unroll
  for (int i = 0; i < K6_CPT; ++i) {
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = round_bf16(__fadd_rn(__fmul_rn(dn[i][j], r), __fmul_rn(c, __fmul_rn(2.f, x[i][j]))));
    if constexpr (DXI) {
      float iv[8];
      unpack8(ic[i], iv);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = round_bf16(__fadd_rn(o[j], iv[j]));
    }
    const int cc = threadIdx.x + i * K6_THREADS;
    dxr[cc] = pack8(o);
    if constexpr (GATE) {
      float gv[8];
      unpack8(gc[i], gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) gv[j] = __fmul_rn(gv[j], o[j]);
      dyr[cc] = pack8(gv);
    }
  }
}

template <bool MOD, bool DXI, bool GATE>
cudaError_t launch_k6_bwd(const void* xp, const void* dh, const void* dxi, const void* mul,
                          const void* gate, void* dx, void* dy, int M, int S, int B, float eps,
                          cudaStream_t st) {
  trunk_residual_modulate_bwd_kernel<MOD, DXI, GATE><<<M, K6_THREADS, 0, st>>>(
      static_cast<const uint16_t*>(xp), static_cast<const uint16_t*>(dh),
      static_cast<const uint16_t*>(dxi), static_cast<const uint16_t*>(mul),
      static_cast<const uint16_t*>(gate), static_cast<uint16_t*>(dx), static_cast<uint16_t*>(dy),
      S, B, eps);
  return cudaGetLastError();
}

template <bool MOD>
cudaError_t k6_bwd(const void* xp, const void* dh, const void* dxi, const void* mul,
                   const void* gate, void* dx, void* dy, int M, int S, int B, float eps,
                   cudaStream_t st) {
  if (dxi && gate)
    return launch_k6_bwd<MOD, true, true>(xp, dh, dxi, mul, gate, dx, dy, M, S, B, eps, st);
  if (dxi)
    return launch_k6_bwd<MOD, true, false>(xp, dh, dxi, mul, gate, dx, dy, M, S, B, eps, st);
  if (gate)
    return launch_k6_bwd<MOD, false, true>(xp, dh, dxi, mul, gate, dx, dy, M, S, B, eps, st);
  return launch_k6_bwd<MOD, false, false>(xp, dh, dxi, mul, gate, dx, dy, M, S, B, eps, st);
}

// ---------------------------------------------------------------------------
// K7 bwd
// ---------------------------------------------------------------------------

// q, k: the forward's inputs; dq, dk: the gradients of its outputs; dqi, dki
// <- the gradients of its inputs; all (n_heads, 128) bf16 heads in
// (..., B, S, H) order. qw, kw (H, 128); cos, sin (S, 64) or, when ROWS,
// (B, S, 64); heads h % H < n_rot were rotated.
template <bool ROWS>
__global__ void __launch_bounds__(K7_THREADS)
    trunk_qk_norm_rope_bwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                                  const uint16_t* __restrict__ dq, const uint16_t* __restrict__ dk,
                                  uint16_t* __restrict__ dqi, uint16_t* __restrict__ dki,
                                  const uint16_t* __restrict__ qw, const uint16_t* __restrict__ kw,
                                  const float* __restrict__ cos, const float* __restrict__ sin,
                                  int n_heads, int H, int S, int B, int n_rot, float eps) {
  const uint16_t* t = blockIdx.y ? k : q;
  const uint16_t* g = blockIdx.y ? dk : dq;
  uint16_t* out = blockIdx.y ? dki : dqi;
  const uint16_t* w = blockIdx.y ? kw : qw;
  const int head = blockIdx.x * (K7_THREADS / 16) + (threadIdx.x >> 4);
  const int lane = threadIdx.x & 15;
  const bool valid = head < n_heads;
  const int hl = valid ? head % H : 0;
  const size_t at = static_cast<size_t>(valid ? head : 0) * K7_DH;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4 xc = valid ? __ldg(reinterpret_cast<const uint4*>(t + at) + lane) : zero;
  const uint4 gc = valid ? __ldg(reinterpret_cast<const uint4*>(g + at) + lane) : zero;
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

  float x[8], d[8], wv[8];
  unpack8(xc, x);
  unpack8(gc, d);
  unpack8(wc, wv);
  if (rot) {
    const float cs[4] = {cc.x, cc.y, cc.z, cc.w}, sn[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float gr = d[2 * i], gi = d[2 * i + 1];
      d[2 * i] = round_bf16(__fadd_rn(__fmul_rn(gr, cs[i]), __fmul_rn(gi, sn[i])));
      d[2 * i + 1] = round_bf16(__fsub_rn(__fmul_rn(gi, cs[i]), __fmul_rn(gr, sn[i])));
    }
  }
  float ss = 0.f, sd = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    d[j] = __fmul_rn(d[j], wv[j]);
    ss = __fadd_rn(ss, __fmul_rn(x[j], x[j]));
    sd = __fadd_rn(sd, __fmul_rn(d[j], x[j]));
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    sd = __fadd_rn(sd, __shfl_xor_sync(0xffffffffu, sd, off));
  }
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(K7_DH)), eps));
  const float c = __fdiv_rn(__fmul_rn(__fmul_rn(-0.5f, sd), __fmul_rn(__fmul_rn(r, r), r)),
                            static_cast<float>(K7_DH));
#pragma unroll
  for (int j = 0; j < 8; ++j)
    d[j] = __fadd_rn(__fmul_rn(d[j], r), __fmul_rn(c, __fmul_rn(2.f, x[j])));
  if (valid) reinterpret_cast<uint4*>(out + at)[lane] = pack8(d);
}

// ---------------------------------------------------------------------------
// K8 bwd
// ---------------------------------------------------------------------------

template <int ACT>
__global__ void __launch_bounds__(K8_THREADS)
    trunk_gated_product_bwd_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                                   const uint16_t* __restrict__ dout, uint16_t* __restrict__ da,
                                   uint16_t* __restrict__ db, long long n) {
  const long long c = static_cast<long long>(blockIdx.x) * K8_THREADS + threadIdx.x;
  if (c >= n / 8) return;
  const uint4 ac = __ldg(reinterpret_cast<const uint4*>(a) + c);
  const uint4 bc = __ldg(reinterpret_cast<const uint4*>(b) + c);
  const uint4 oc = __ldg(reinterpret_cast<const uint4*>(dout) + c);
  float av[8], bv[8], ov[8], ga[8], gb[8];
  unpack8(ac, av);
  unpack8(bc, bv);
  unpack8(oc, ov);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if constexpr (ACT == 0) {
      const float s = round_bf16(__fdiv_rn(1.f, __fadd_rn(1.f, expf(-bv[j]))));
      const float ds = round_bf16(__fmul_rn(ov[j], av[j]));
      ga[j] = __fmul_rn(ov[j], s);
      gb[j] = __fmul_rn(round_bf16(__fmul_rn(ds, round_bf16(__fsub_rn(1.f, s)))), s);
    } else {
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-av[j])));
      const float g = round_bf16(__fdiv_rn(av[j], __fadd_rn(1.f, expf(-av[j]))));
      const float dg = round_bf16(__fmul_rn(ov[j], bv[j]));
      gb[j] = __fmul_rn(ov[j], g);
      ga[j] = __fmul_rn(__fmul_rn(dg, sig), __fmaf_rn(av[j], __fsub_rn(1.f, sig), 1.f));
    }
  }
  reinterpret_cast<uint4*>(da)[c] = pack8(ga);
  reinterpret_cast<uint4*>(db)[c] = pack8(gb);
}

}  // namespace

// K6 bwd. xp, dh, dx (M, 2048) bf16 contiguous, 16-byte aligned, rows in
// (..., B, S) order; dxi like them or null (x' has no later use); mod: mul =
// scale (B, 2048), else the norm's weight (2048,); gate (B, 2048) and dy
// (M, 2048), or both null.
extern "C" int trunk_residual_modulate_bwd(const void* xp, const void* dh, const void* dxi,
                                           const void* mul, int mod, const void* gate, void* dx,
                                           void* dy, int M, int D, int S, int B, float eps,
                                           void* stream) {
  if (M < 1 || D != K6_D || S < 1 || B < 1 || !xp || !dh || !mul || !dx || (!gate != !dy) ||
      !aligned({xp, dh, dxi, mul, gate, dx, dy}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(mod ? k6_bwd<true>(xp, dh, dxi, mul, gate, dx, dy, M, S, B, eps, st)
                   : k6_bwd<false>(xp, dh, dxi, mul, gate, dx, dy, M, S, B, eps, st));
}

// K7 bwd. q, k (the forward's inputs), dq, dk (its outputs' gradients), dqi,
// dki (its inputs' gradients): (n_heads, 128) bf16 contiguous, 16-byte
// aligned, heads in (..., B, S, H) order; qw, kw (H, 128) bf16; cos, sin as
// the forward took them.
extern "C" int trunk_qk_norm_rope_bwd(const void* q, const void* k, const void* dq,
                                      const void* dk, void* dqi, void* dki, const void* qw,
                                      const void* kw, const void* cos, const void* sin,
                                      int n_heads, int H, int S, int B, int n_rot, int rows,
                                      float eps, void* stream) {
  if (n_heads < 1 || H < 1 || S < 1 || B < 1 || n_rot < 0 || (n_rot > 0 && (!cos || !sin)) ||
      !aligned({q, k, dq, dk, dqi, dki, qw, kw, cos, sin}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_heads + K7_THREADS / 16 - 1) / (K7_THREADS / 16), 2);
  const auto bf = [](const void* p) { return static_cast<const uint16_t*>(p); };
  const float *cp = static_cast<const float*>(cos), *sp = static_cast<const float*>(sin);
  uint16_t *dqp = static_cast<uint16_t*>(dqi), *dkp = static_cast<uint16_t*>(dki);
  if (rows)
    trunk_qk_norm_rope_bwd_kernel<true><<<grid, K7_THREADS, 0, st>>>(
        bf(q), bf(k), bf(dq), bf(dk), dqp, dkp, bf(qw), bf(kw), cp, sp, n_heads, H, S, B, n_rot,
        eps);
  else
    trunk_qk_norm_rope_bwd_kernel<false><<<grid, K7_THREADS, 0, st>>>(
        bf(q), bf(k), bf(dq), bf(dk), dqp, dkp, bf(qw), bf(kw), cp, sp, n_heads, H, S, B, n_rot,
        eps);
  return (int)cudaGetLastError();
}

// K8 bwd. a, b, dout, da, db (n,) bf16 contiguous, 16-byte aligned, n a
// multiple of 8. act 0: out = a * sigmoid(b); act 1: out = silu(a) * b.
extern "C" int trunk_gated_product_bwd(const void* a, const void* b, const void* dout, void* da,
                                       void* db, long long n, int act, void* stream) {
  if (n < 1 || n % 8 || act < 0 || act > 1 || !aligned({a, b, dout, da, db}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n / 8 + K8_THREADS - 1) / K8_THREADS);
  const auto bf = [](const void* p) { return static_cast<const uint16_t*>(p); };
  uint16_t *dap = static_cast<uint16_t*>(da), *dbp = static_cast<uint16_t*>(db);
  if (act == 0)
    trunk_gated_product_bwd_kernel<0><<<blocks, K8_THREADS, 0, st>>>(bf(a), bf(b), bf(dout), dap,
                                                                     dbp, n);
  else
    trunk_gated_product_bwd_kernel<1><<<blocks, K8_THREADS, 0, st>>>(bf(a), bf(b), bf(dout), dap,
                                                                     dbp, n);
  return (int)cudaGetLastError();
}
