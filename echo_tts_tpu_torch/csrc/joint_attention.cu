// Kernel K1: segmented joint attention for the DiT trunk, sm_90a.
//
// Replaces echo_tts_tpu/ops/pallas_attention.py:_kernel (called from
// joint_attention_grouped_pallas). For each (branch g, batch b, head h) and
// query row it computes softmax over [q.k_self^T*c | q.k_seg^T*c*s_seg +
// bias_seg ...] and out = P_self.v_self + sum_seg s_seg.P_seg.v_seg, with
// fp32 softmax and accumulation, bf16 in and out (c = log2(e)/sqrt(D): the
// softmax runs in base 2).
//
// Bound. At the main-path shapes (S=640 queries, H=16, D=128, ~640 self +
// 768 text + up to 1600 speaker keys) one call does ~4*S*T*D FLOPs per
// (g, b, h) against one read of q, k, v and one write of out: ~2.7k FLOP per
// byte, far above the H100's ~295 FLOP/byte ridge, so it is bound by tensor
// core operations (989 TFLOP/s bf16).
//
// Design. The Pallas kernel keeps whole segments (S x ~3k fp32 logits) in
// VMEM; that does not fit 227 KB of shared memory. This kernel streams keys
// instead, flash style: one block of 4 warps per (g, b, h, 64-row q tile);
// the q tile stays in shared memory while 64-key tiles of K and V stream
// through, first the self keys (always visible unless self_len, so the
// running max is finite before any fully masked segment arrives), then each
// segment in turn, read straight from its own K/V/bias (no concatenated
// copy). A running max and sum per row rescale an fp32 accumulator kept in
// shared memory; s_seg is folded into P before the P.V product. Keys past a
// segment's end (T=1 included) are excluded in the kernel, not padded on the
// host. Products use WMMA bf16 16x16x16 tiles with fp32 accumulation
// (mma.sync on sm_90a); wgmma/TMA pipelining is left for a later version.
//
// Training. When `lse` is not null the kernel also writes each query row's
// base-2 log-sum-exp, m + log2(sum), as fp32 (G, B, H, S) contiguous; the
// backward kernel K3 (joint_attention_bwd.cu) rebuilds p = exp2(l - lse)
// from it without a second softmax pass. Inference passes null.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// one context segment, as the wrapper passes it (outside the anonymous
// namespace: the C entry point takes it)
struct Seg {
  const bf16* k;
  const bf16* v;
  const float* bias;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long bias_sg, bias_sb;
  int t;
  float scale;
};

namespace {

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 128;
constexpr int LDH = D + 8;   // bf16 row stride of the Q, K, V tiles
constexpr int LDS = BK + 4;  // fp32 scores
constexpr int LDP = BK + 8;  // bf16 probabilities
constexpr int LDO = D + 4;   // fp32 output accumulator
constexpr int MAX_SEG = 3;
constexpr float NEG = -1e30f;

constexpr size_t SMEM_BYTES = sizeof(bf16) * (BQ * LDH + 2 * BK * LDH + BQ * LDP)
                            + sizeof(float) * (BQ * LDS + BQ * LDO);

struct Params {
  const bf16* q;
  const bf16* ks;
  const bf16* vs;
  bf16* out;
  long long q_s[4], ks_s[4], vs_s[4], o_s[4];  // element strides of (g, b, h, s)
  const int* self_len;
  float* lse;  // (G, B, H, S) base-2 log-sum-exp, or null
  int G, B, H, S, S_kv, nseg;
  float scale;
  Seg seg[MAX_SEG];
};

// rows [0, n) of a (rows x D) tile from global rows `stride` elements apart;
// rows >= n are zero
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride,
                                          int n, int rows) {
  constexpr int VEC = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * VEC; i += NTHREADS) {
    int r = i / VEC, c = (i % VEC) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

__global__ void __launch_bounds__(NTHREADS)
joint_attention_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LDH;
  bf16* Vs = Ks + BK * LDH;
  bf16* Ps = Vs + BK * LDH;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * LDP);
  float* Os = Ss + BQ * LDS;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int g = blockIdx.z / p.B;
  const int b = blockIdx.z % p.B;
  const int nq = min(BQ, p.S - q0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile(Qs, p.q + g * p.q_s[0] + b * p.q_s[1] + h * p.q_s[2] + q0 * p.q_s[3],
            p.q_s[3], nq, BQ);
  for (int i = threadIdx.x; i < BQ * LDO; i += NTHREADS) Os[i] = 0.f;

  // each lane owns half of one query row: row r, key columns [c0, c0+32),
  // accumulator columns [2*c0, 2*c0+64)
  const int r = warp * 16 + lane / 2;
  const int c0 = (lane & 1) * 32;
  float m_run = -INFINITY, l_run = 0.f;
  const int self_lim = p.self_len ? min(p.self_len[b], p.S_kv) : p.S_kv;
  __syncthreads();

  for (int src = 0; src <= p.nseg; ++src) {
    const bf16 *kb, *vb;
    long long kst, vst;
    const float* bias = nullptr;
    int t_len;
    float lscale = p.scale, vscale = 1.f;
    if (src == 0) {
      kb = p.ks + g * p.ks_s[0] + b * p.ks_s[1] + h * p.ks_s[2];
      vb = p.vs + g * p.vs_s[0] + b * p.vs_s[1] + h * p.vs_s[2];
      kst = p.ks_s[3];
      vst = p.vs_s[3];
      t_len = p.S_kv;
    } else {
      const Seg& sg = p.seg[src - 1];
      kb = sg.k + b * sg.k_sb + h * sg.k_sh;
      vb = sg.v + b * sg.v_sb + h * sg.v_sh;
      kst = sg.k_st;
      vst = sg.v_st;
      bias = sg.bias + g * sg.bias_sg + b * sg.bias_sb;
      t_len = sg.t;
      lscale = p.scale * sg.scale;
      vscale = sg.scale;
    }
    for (int k0 = 0; k0 < t_len; k0 += BK) {
      const int nk = min(BK, t_len - k0);
      load_tile(Ks, kb + k0 * kst, kst, nk, BK);
      load_tile(Vs, vb + k0 * vst, vst, nk, BK);
      __syncthreads();

      // scores: this warp's 16 query rows x 64 keys
      for (int j = 0; j < BK / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Qs + warp * 16 * LDH + kk * 16, LDH);
          wmma::load_matrix_sync(fb, Ks + j * 16 * LDH + kk * 16, LDH);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Ss + warp * 16 * LDS + j * 16, acc, LDS, wmma::mem_row_major);
      }
      __syncwarp();

      // online softmax over this tile
      float vals[32];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int col = c0 + c;
        float l = -INFINITY;  // past the segment's end: excluded
        if (col < nk) {
          l = Ss[r * LDS + col] * lscale;
          if (bias) l += bias[k0 + col];
          else if (k0 + col >= self_lim) l += NEG;
        }
        vals[c] = l;
        mx = fmaxf(mx, l);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);  // finite: key 0 of the tile exists
      const float corr = exp2f(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float e = exp2f(vals[c] - m_new);
        sum += e;
        Ps[r * LDP + c0 + c] = __float2bfloat16(e * vscale);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_run = l_run * corr + sum;
      m_run = m_new;
      for (int c = 0; c < 64; ++c) Os[r * LDO + 2 * c0 + c] *= corr;
      __syncwarp();

      // accumulator += P . V for this warp's 16 rows
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, Os + warp * 16 * LDO + j * 16, LDO, wmma::mem_row_major);
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, Ps + warp * 16 * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(fb, Vs + kk * 16 * LDH + j * 16, LDH);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Os + warp * 16 * LDO + j * 16, acc, LDO, wmma::mem_row_major);
      }
      __syncthreads();  // K/V tiles are overwritten next
    }
  }

  if (p.lse && r < nq && c0 == 0)
    p.lse[(((long long)g * p.B + b) * p.H + h) * p.S + q0 + r] = m_run + log2f(l_run);
  if (r < nq) {
    const float inv = 1.f / l_run;
    bf16* o = p.out + g * p.o_s[0] + b * p.o_s[1] + h * p.o_s[2] + (q0 + r) * p.o_s[3];
    for (int c = 0; c < 64; c += 2) {
      const int col = 2 * c0 + c;
      __nv_bfloat162 v2 = __floats2bfloat162_rn(Os[r * LDO + col] * inv,
                                                Os[r * LDO + col + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(o + col) = v2;
    }
  }
}

}  // namespace

extern "C" int joint_attention_fwd(
    const void* q, const void* ks, const void* vs, void* out,
    const long long* q_s, const long long* ks_s, const long long* vs_s,
    const long long* o_s, const void* self_len, void* lse, int G, int B, int H, int S,
    int S_kv, const Seg* segs, int nseg, float scale, void* stream) {
  if (nseg < 0 || nseg > MAX_SEG || S < 1 || S_kv < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.ks = static_cast<const bf16*>(ks);
  p.vs = static_cast<const bf16*>(vs);
  p.out = static_cast<bf16*>(out);
  for (int i = 0; i < 4; ++i) {
    p.q_s[i] = q_s[i];
    p.ks_s[i] = ks_s[i];
    p.vs_s[i] = vs_s[i];
    p.o_s[i] = o_s[i];
  }
  p.self_len = static_cast<const int*>(self_len);
  p.lse = static_cast<float*>(lse);
  p.G = G; p.B = B; p.H = H; p.S = S; p.S_kv = S_kv; p.nseg = nseg;
  p.scale = scale;
  for (int i = 0; i < MAX_SEG; ++i) p.seg[i] = i < nseg ? segs[i] : Seg{};
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(joint_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((S + BQ - 1) / BQ, H, G * B);
  joint_attention_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
