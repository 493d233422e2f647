// Kernel K3: backward of the segmented joint attention, sm_90a.
//
// Replaces echo_tts_tpu/ops/pallas_attention.py:_bwd_kernel (called from
// joint_attention_grouped_pallas_bwd). For each (branch g, batch b, head h),
// with p the softmax over [q.k_self^T*c | q.k_seg^T*c*s_seg + bias_seg ...]
// (c = 1/sqrt(D)) and dO the output cotangent:
//
//   dp_self = dO.v_self^T,  dp_seg = s_seg * dO.v_seg^T
//   r       = sum over all keys of dp*p
//   dl      = p * (dp - r)
//   dq      = dl_self.k_self*c + sum_seg dl_seg.k_seg*c*s_seg
//   dk_self = dl_self^T.q*c,  dv_self = p_self^T.dO           (per branch g)
//   dk_seg  = sum_g dl_seg^T.q*c*s_seg,  dv_seg = sum_g s_seg*p_seg^T.dO
//
// bf16 in and out, fp32 softmax and accumulation; dl and p are rounded to
// bf16 before their products, as the Pallas kernel does (here with c*s_seg
// folded into dl before the rounding).
//
// Bound. The five products cost 10*S*T*D FLOPs per (g, b, h) (T = all keys);
// at the training shape (G=1, B=8, H=16, S=640, T=640+768+160, D=128) that
// is 164 GFLOP against ~60 MB of inputs and outputs: ~2.7k FLOP per byte,
// far above the H100's ~295 FLOP/byte ridge, so it is bound by tensor-core
// operations (989 TFLOP/s bf16: ~0.166 ms). This design recomputes q.k^T
// and dO.v^T once in each of its two passes, 14*S*T*D in all.
//
// Design. The Pallas kernel holds the S x T logits of every branch in VMEM,
// one program per (b, h); that does not fit 227 KB of shared memory. This
// is the flash-attention-2 backward instead, split so that every output
// tile has exactly one owner and no atomics are needed:
//   0. a pre-pass, one warp per query row, computes r = rowsum(dO*O) from
//      the forward output O (equal to sum(dp*p) up to O's bf16 rounding);
//      the per-row log-sum-exp comes from kernel K1's optional output, so
//      p = exp2(l*log2(e) - lse2) needs no second softmax pass;
//   1. dq pass: one block of 8 warps per (g, b, h, 64-row q tile); the q and
//      dO tiles stay in shared memory while 64-key tiles of K and V stream
//      through, self keys first, then each segment from its own K/V/bias;
//      dq accumulates in WMMA fragments held in registers;
//   2. dk/dv pass: one block per (b, h, 64-key tile) of the self keys of
//      each branch and of each segment; a self-key block loops over the q
//      tiles of its own branch, a segment-key block over every branch and
//      every q tile, so the sum over branches stays inside one block; dk and
//      dv accumulate in register fragments.
// Keys past a segment's end (T=1, T=700) and query rows past S are masked
// inside the kernel; nothing is padded on the host. Products use WMMA bf16
// 16x16x16 tiles with fp32 accumulation; wgmma/TMA and pipelining are left
// for the kernel redesign. Shared memory: 110.5 KiB (dq pass, two blocks
// fit on an SM) and 119.5 KiB (dk/dv pass, one block per SM) of dynamic
// shared memory; the fp32 score tile doubles as the output staging tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// one context segment with its gradient outputs, as the wrapper passes it
struct SegB {
  const bf16* k;
  const bf16* v;
  const float* bias;
  bf16* dk;
  bf16* dv;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
  long long bias_sg, bias_sb;
  int t;
  float scale;
};

namespace {

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NW = 8;
constexpr int NT = NW * 32;
constexpr int LDH = D + 8;   // bf16 row stride of the Q, dO, K, V tiles
constexpr int LDS = BK + 4;  // fp32 scores / dp
constexpr int LDP = BK + 8;  // bf16 p and ds
constexpr int LDO = D + 4;   // fp32 staging of a 64 x D output tile
constexpr int MAX_SEG = 3;
constexpr int EPT = BQ * BK / NT;  // score elements per thread (16)

constexpr size_t TILE_H = sizeof(bf16) * BQ * LDH;
constexpr size_t TILE_P = sizeof(bf16) * BQ * LDP;
constexpr size_t STAGE = sizeof(float) * BQ * LDO;
constexpr size_t ROWS = sizeof(float) * 2 * BQ;
constexpr size_t SMEM_DQ = 4 * TILE_H + TILE_P + STAGE + ROWS;
constexpr size_t SMEM_DKDV = 4 * TILE_H + 2 * TILE_P + STAGE + ROWS;

struct Params {
  const bf16* q;
  const bf16* ks;
  const bf16* vs;
  const bf16* dout;
  const bf16* o;
  const float* lse;  // (G, B, H, S) base-2 log-sum-exp from kernel K1
  float* r;          // (G, B, H, S) rowsum(dO*O), written by the pre-pass
  bf16* dq;
  bf16* dks;
  bf16* dvs;
  // element strides of (g, b, h, s) for q, k_self, v_self, dO, O, dq,
  // dk_self, dv_self
  long long st[8][4];
  int G, B, H, S, S_kv, nseg;
  float scale2;  // log2(e)/sqrt(D), K1's base-2 logit scale
  float scale;   // 1/sqrt(D)
  SegB seg[MAX_SEG];
};

enum { Q = 0, KS, VS, DO, O, DQ, DKS, DVS };

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__device__ __forceinline__ long long row_off(const long long* s, int g, int b, int h) {
  return g * s[0] + b * s[1] + h * s[2];
}

// rows [0, n) of a 64 x D tile from global rows `stride` elements apart;
// rows >= n are zero
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride, int n) {
  constexpr int VEC = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < BQ * VEC; i += NT) {
    const int r = i / VEC, c = (i % VEC) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// lse and r of rows [row0, row0 + n) of one (g, b, h); zero past n
__device__ __forceinline__ void load_rows(float* lse_s, float* r_s, const Params& p,
                                          long long row0, int n) {
  if (threadIdx.x < BQ) {
    const int i = threadIdx.x;
    lse_s[i] = i < n ? p.lse[row0 + i] : 0.f;
    r_s[i] = i < n ? p.r[row0 + i] : 0.f;
  }
}

// C (64 x 64 fp32, ld LDS) = A . Bm^T for 64 x D bf16 tiles; each warp does
// two of the sixteen 16 x 16 output tiles
__device__ __forceinline__ void mm_abt(float* C, const bf16* A, const bf16* Bm) {
  const int warp = threadIdx.x / 32;
  for (int t = 2 * warp; t < 2 * warp + 2; ++t) {
    const int i = t / 4, j = t % 4;
    Acc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, A + i * 16 * LDH + kk * 16, LDH);
      wmma::load_matrix_sync(fb, Bm + j * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(C + i * 16 * LDS + j * 16, acc, LDS, wmma::mem_row_major);
  }
}

// p for this thread's 16 scores (row tid/4, columns (tid%4)*16 ...): zero
// past the valid rows/keys; the bias of key k0+col is added in base 2 as
// kernel K1 adds it
__device__ __forceinline__ void softmax_p(float* pv, const float* Sf, const float* lse_s,
                                          const float* bias, int k0, int nq, int nk,
                                          float lscale) {
  const int row = threadIdx.x / 4, c0 = (threadIdx.x % 4) * EPT;
  const float lse = lse_s[row];
#pragma unroll
  for (int c = 0; c < EPT; ++c) {
    const int col = c0 + c;
    float v = 0.f;
    if (row < nq && col < nk) {
      float l = Sf[row * LDS + col] * lscale;
      if (bias) l += bias[k0 + col];
      v = exp2f(l - lse);
    }
    pv[c] = v;
  }
}

// ds = p * (dp*vscale - r) * dscale into DS (bf16), dp read from Sf
__device__ __forceinline__ void grad_logits(bf16* DS, const float* pv, const float* Sf,
                                            const float* r_s, float vscale, float dscale) {
  const int row = threadIdx.x / 4, c0 = (threadIdx.x % 4) * EPT;
  const float r = r_s[row];
#pragma unroll
  for (int c = 0; c < EPT; ++c) {
    const int col = c0 + c;
    const float dp = Sf[row * LDS + col] * vscale;
    DS[row * LDP + col] = __float2bfloat16(pv[c] * (dp - r) * dscale);
  }
}

// write 4 accumulator fragments per warp (warp w: rows (w%4)*16, columns
// (w/4)*64 ...) times `mul` as bf16 rows [0, n) at dst (row stride `stride`)
__device__ __forceinline__ void store_out(float* stage, Acc* acc, bf16* dst, long long stride,
                                          int n, float mul) {
  const int warp = threadIdx.x / 32;
  const int i = warp % 4, j0 = (warp / 4) * 4;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    wmma::store_matrix_sync(stage + i * 16 * LDO + (j0 + jj) * 16, acc[jj], LDO,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BQ * D / 2; e += NT) {
    const int r = e / (D / 2), c = (e % (D / 2)) * 2;
    if (r < n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + r * stride + c) =
          __floats2bfloat162_rn(stage[r * LDO + c] * mul, stage[r * LDO + c + 1] * mul);
    }
  }
  __syncthreads();
}

// one key source of a (g, b, h): self keys (src 0) or segment src-1
struct Src {
  const bf16* k;
  const bf16* v;
  long long kst, vst;
  const float* bias;  // of branch g, batch b; null for self keys
  int t;
  float lscale, vscale, dscale;
};

__device__ __forceinline__ Src source(const Params& p, int src, int g, int b, int h) {
  Src s;
  if (src == 0) {
    s.k = p.ks + row_off(p.st[KS], g, b, h);
    s.v = p.vs + row_off(p.st[VS], g, b, h);
    s.kst = p.st[KS][3];
    s.vst = p.st[VS][3];
    s.bias = nullptr;
    s.t = p.S_kv;
    s.lscale = p.scale2;
    s.vscale = 1.f;
    s.dscale = p.scale;
  } else {
    const SegB& sg = p.seg[src - 1];
    s.k = sg.k + b * sg.k_sb + h * sg.k_sh;
    s.v = sg.v + b * sg.v_sb + h * sg.v_sh;
    s.kst = sg.k_st;
    s.vst = sg.v_st;
    s.bias = sg.bias + g * sg.bias_sg + b * sg.bias_sb;
    s.t = sg.t;
    s.lscale = p.scale2 * sg.scale;
    s.vscale = sg.scale;
    s.dscale = p.scale * sg.scale;
  }
  return s;
}

// pre-pass: r = rowsum(dO * O), one warp per (g, b, h, s) row
__global__ void __launch_bounds__(NT) rowdot_kernel(const Params p) {
  const long long row = (long long)blockIdx.x * NW + threadIdx.x / 32;
  const long long rows = (long long)p.G * p.B * p.H * p.S;
  if (row >= rows) return;
  const int s = (int)(row % p.S);
  long long rest = row / p.S;
  const int h = (int)(rest % p.H);
  rest /= p.H;
  const int b = (int)(rest % p.B);
  const int g = (int)(rest / p.B);
  const int lane = threadIdx.x % 32;
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(
      p.dout + row_off(p.st[DO], g, b, h) + s * p.st[DO][3] + lane * 4);
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(
      p.o + row_off(p.st[O], g, b, h) + s * p.st[O][3] + lane * 4);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 a = __bfloat1622float2(d2[i]);
    const float2 c = __bfloat1622float2(o2[i]);
    acc += a.x * c.x + a.y * c.y;
  }
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.r[row] = acc;
}

__global__ void __launch_bounds__(NT) dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * LDH;
  bf16* Ks = dOs + BQ * LDH;
  bf16* Vs = Ks + BK * LDH;
  bf16* DSb = Vs + BK * LDH;
  float* Sf = reinterpret_cast<float*>(DSb + BQ * LDP);
  float* lse_s = Sf + BQ * LDO;
  float* r_s = lse_s + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int g = blockIdx.z / p.B;
  const int b = blockIdx.z % p.B;
  const int nq = min(BQ, p.S - q0);
  const int warp = threadIdx.x / 32;
  const int wi = warp % 4, wj0 = (warp / 4) * 4;

  load_tile(Qs, p.q + row_off(p.st[Q], g, b, h) + q0 * p.st[Q][3], p.st[Q][3], nq);
  load_tile(dOs, p.dout + row_off(p.st[DO], g, b, h) + q0 * p.st[DO][3], p.st[DO][3], nq);
  load_rows(lse_s, r_s, p, (((long long)g * p.B + b) * p.H + h) * p.S + q0, nq);

  Acc acc[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) wmma::fill_fragment(acc[jj], 0.f);
  float pv[EPT];

  for (int src = 0; src <= p.nseg; ++src) {
    const Src s = source(p, src, g, b, h);
    for (int k0 = 0; k0 < s.t; k0 += BK) {
      const int nk = min(BK, s.t - k0);
      load_tile(Ks, s.k + k0 * s.kst, s.kst, nk);
      load_tile(Vs, s.v + k0 * s.vst, s.vst, nk);
      __syncthreads();
      mm_abt(Sf, Qs, Ks);
      __syncthreads();
      softmax_p(pv, Sf, lse_s, s.bias, k0, nq, nk, s.lscale);
      __syncthreads();
      mm_abt(Sf, dOs, Vs);
      __syncthreads();
      grad_logits(DSb, pv, Sf, r_s, s.vscale, s.dscale);
      __syncthreads();
      // dq += ds . K for this warp's 16 rows x 64 columns
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, DSb + wi * 16 * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(fb, Ks + kk * 16 * LDH + (wj0 + jj) * 16, LDH);
          wmma::mma_sync(acc[jj], fa, fb, acc[jj]);
        }
      }
      __syncthreads();  // K/V and DS are overwritten next
    }
  }
  store_out(Sf, acc, p.dq + row_off(p.st[DQ], g, b, h) + q0 * p.st[DQ][3], p.st[DQ][3], nq, 1.f);
}

__global__ void __launch_bounds__(NT) dkdv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * LDH;
  bf16* Qs = Vs + BK * LDH;
  bf16* dOs = Qs + BQ * LDH;
  bf16* Pb = dOs + BQ * LDH;
  bf16* DSb = Pb + BQ * LDP;
  float* Sf = reinterpret_cast<float*>(DSb + BQ * LDP);
  float* lse_s = Sf + BQ * LDO;
  float* r_s = lse_s + BQ;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int wi = warp % 4, wj0 = (warp / 4) * 4;

  // which key tile: [self tiles of branch 0 | ... | branch G-1 | segment 0 | ...]
  int tile = blockIdx.x;
  const int n_self = (p.S_kv + BK - 1) / BK;
  int src = 0, g_lo, g_hi;
  if (tile < p.G * n_self) {
    g_lo = tile / n_self;
    g_hi = g_lo + 1;
    tile %= n_self;
  } else {
    tile -= p.G * n_self;
    src = 1;
    while (src < p.nseg && tile >= (p.seg[src - 1].t + BK - 1) / BK) {
      tile -= (p.seg[src - 1].t + BK - 1) / BK;
      ++src;
    }
    g_lo = 0;
    g_hi = p.G;
  }
  const int k0 = tile * BK;
  const Src s0 = source(p, src, g_lo, b, h);
  const int nk = min(BK, s0.t - k0);
  if (nk <= 0) return;
  load_tile(Ks, s0.k + k0 * s0.kst, s0.kst, nk);
  load_tile(Vs, s0.v + k0 * s0.vst, s0.vst, nk);

  Acc dk[4], dv[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    wmma::fill_fragment(dk[jj], 0.f);
    wmma::fill_fragment(dv[jj], 0.f);
  }
  float pv[EPT];

  for (int g = g_lo; g < g_hi; ++g) {
    const Src s = source(p, src, g, b, h);
    for (int q0 = 0; q0 < p.S; q0 += BQ) {
      const int nq = min(BQ, p.S - q0);
      load_tile(Qs, p.q + row_off(p.st[Q], g, b, h) + q0 * p.st[Q][3], p.st[Q][3], nq);
      load_tile(dOs, p.dout + row_off(p.st[DO], g, b, h) + q0 * p.st[DO][3], p.st[DO][3], nq);
      load_rows(lse_s, r_s, p, (((long long)g * p.B + b) * p.H + h) * p.S + q0, nq);
      __syncthreads();
      mm_abt(Sf, Qs, Ks);
      __syncthreads();
      softmax_p(pv, Sf, lse_s, s.bias, k0, nq, nk, s.lscale);
      {
        const int row = threadIdx.x / 4, c0 = (threadIdx.x % 4) * EPT;
#pragma unroll
        for (int c = 0; c < EPT; ++c) Pb[row * LDP + c0 + c] = __float2bfloat16(pv[c]);
      }
      __syncthreads();
      mm_abt(Sf, dOs, Vs);
      __syncthreads();
      grad_logits(DSb, pv, Sf, r_s, s.vscale, s.dscale);
      __syncthreads();
      // dv += p^T . dO and dk += ds^T . q for this warp's 16 keys x 64
      // columns (p and ds read transposed: col_major A)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, Pb + kk * 16 * LDP + wi * 16, LDP);
          wmma::load_matrix_sync(fb, dOs + kk * 16 * LDH + (wj0 + jj) * 16, LDH);
          wmma::mma_sync(dv[jj], fa, fb, dv[jj]);
          wmma::load_matrix_sync(fa, DSb + kk * 16 * LDP + wi * 16, LDP);
          wmma::load_matrix_sync(fb, Qs + kk * 16 * LDH + (wj0 + jj) * 16, LDH);
          wmma::mma_sync(dk[jj], fa, fb, dk[jj]);
        }
      }
      __syncthreads();  // Q, dO, P and DS are overwritten next
    }
  }

  bf16 *dkp, *dvp;
  long long dkst, dvst;
  if (src == 0) {
    dkp = p.dks + row_off(p.st[DKS], g_lo, b, h);
    dvp = p.dvs + row_off(p.st[DVS], g_lo, b, h);
    dkst = p.st[DKS][3];
    dvst = p.st[DVS][3];
  } else {
    const SegB& sg = p.seg[src - 1];
    dkp = sg.dk + b * sg.dk_sb + h * sg.dk_sh;
    dvp = sg.dv + b * sg.dv_sb + h * sg.dv_sh;
    dkst = sg.dk_st;
    dvst = sg.dv_st;
  }
  store_out(Sf, dk, dkp + k0 * dkst, dkst, nk, 1.f);
  store_out(Sf, dv, dvp + k0 * dvst, dvst, nk, s0.vscale);
}

cudaError_t configure(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int joint_attention_bwd(
    const void* q, const void* ks, const void* vs, const void* dout, const void* o,
    const void* lse, void* r, void* dq, void* dks, void* dvs, const long long* strides,
    int G, int B, int H, int S, int S_kv, const SegB* segs, int nseg, float scale2,
    float scale, void* stream) {
  if (nseg < 0 || nseg > MAX_SEG || S < 1 || S_kv < 1 || G < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.ks = static_cast<const bf16*>(ks);
  p.vs = static_cast<const bf16*>(vs);
  p.dout = static_cast<const bf16*>(dout);
  p.o = static_cast<const bf16*>(o);
  p.lse = static_cast<const float*>(lse);
  p.r = static_cast<float*>(r);
  p.dq = static_cast<bf16*>(dq);
  p.dks = static_cast<bf16*>(dks);
  p.dvs = static_cast<bf16*>(dvs);
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 4; ++j) p.st[i][j] = strides[4 * i + j];
  p.G = G; p.B = B; p.H = H; p.S = S; p.S_kv = S_kv; p.nseg = nseg;
  p.scale2 = scale2;
  p.scale = scale;
  int n_tiles = G * ((S_kv + BK - 1) / BK);
  for (int i = 0; i < MAX_SEG; ++i) {
    p.seg[i] = i < nseg ? segs[i] : SegB{};
    if (i < nseg) {
      if (segs[i].t < 1) return (int)cudaErrorInvalidValue;
      n_tiles += (segs[i].t + BK - 1) / BK;
    }
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t e = configure((const void*)dq_kernel, SMEM_DQ);
    if (e == cudaSuccess) e = configure((const void*)dkdv_kernel, SMEM_DKDV);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)G * B * H * S;
  rowdot_kernel<<<(unsigned)((rows + NW - 1) / NW), NT, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_kernel<<<dim3((S + BQ - 1) / BQ, H, G * B), NT, SMEM_DQ, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_kernel<<<dim3(n_tiles, H, B), NT, SMEM_DKDV, st>>>(p);
  return (int)cudaGetLastError();
}
