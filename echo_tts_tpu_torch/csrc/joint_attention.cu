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
// core operations (989 TFLOP/s bf16), which only wgmma reaches.
//
// Design (on attention_core.cuh). The Pallas kernel keeps whole segments
// (S x ~3k fp32 logits) in VMEM; that does not fit 227 KB of shared memory,
// so keys stream, flash style. A block is NWG consumer warpgroups (tq = 64 NWG
// query rows) and one producer warpgroup for one (g, b, h, q tile):
//   * the producer fills a ring of K/V stages (64 keys each, 128-byte
//     swizzled) with 16-byte cp.async copies whose completion arrives on the
//     stage's "full" mbarriers; it waits on a stage's "empty" barrier before
//     refilling it. No tensor map: strides are plain kernel arguments, so
//     seq-major and head-major inputs, sliced branches and out= views cost
//     the host nothing extra. Self keys come first (so the running max is
//     finite before a fully masked segment arrives), then each segment in
//     turn from its own K/V/bias;
//   * a consumer warpgroup owns 64 query rows and holds them as wgmma A
//     fragments in registers for the whole kernel (32 registers a thread,
//     loaded once from global memory: q costs no shared-memory bandwidth).
//     S = Q.K^T reads its B operand from the (T, D) key tile, which is
//     K-major as it lies; the scores stay in registers, where scale, bias,
//     the ragged edge and the online softmax are applied (row max across the
//     four threads of a row by shuffles); the exponentials, times s_seg, are
//     cast to bf16 in place and are the register A operand of O += P.V,
//     whose B operand is the (T, D) value tile read MN-major through the
//     descriptor's transpose flag. The (64 x 128) fp32 output accumulator
//     never leaves registers; its rescale is a register multiply, skipped
//     while no row's maximum moves. The bias of a tile is loaded once per
//     warp and handed out by shuffles;
//   * the two products of a warpgroup overlap its softmax: the scores of
//     tile i+1 are started before P(i).V(i), and the softmax of tile i+1 runs
//     while P(i).V(i) is on the tensor cores;
//   * setmaxnreg moves registers from the producers (24 each: a thread of
//     the loader keeps one pointer and one step) to the consumers (240), so
//     that scores, weights, output and q fragments of both products in flight
//     fit: with fewer the assembler serialises the wgmma. One producer warp
//     instead of four was tried and lost: it could not keep the ring full,
//     and the card hands out registers by warpgroup, so it freed none.
// Keys past a segment's end (T=1 included) are excluded in the kernel (zero
// filled by the copy, logits set to -inf), rows past S are not written.
//
// Training. When `lse` is not null the kernel also writes each query row's
// base-2 log-sum-exp, m + log2(sum), as fp32 (G, B, H, S) contiguous; the
// backward kernel K3 (joint_attention_bwd.cu) rebuilds p = exp2(l - lse)
// from it without a second softmax pass. Inference passes null.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_core.cuh"

using namespace attn_core;

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

constexpr int MAX_SEG = 3;
constexpr float NEG = -1e30f;

struct Params {
  const bf16* q;
  const bf16* ks;
  const bf16* vs;
  bf16* out;
  long long q_s[4], ks_s[4], vs_s[4], o_s[4];  // element strides of (g, b, h, s)
  const int* self_len;
  float* lse;  // (G, B, H, S) base-2 log-sum-exp, or null
  int G, B, H, S, S_kv, nseg;
  int hg;  // heads a block walks through, one after the other (a divisor of H)
  float scale;
  Seg seg[MAX_SEG];
};

// the keys of source `src` (0 = self, then the segments) for (g, b, h)
struct Source {
  const bf16* k;
  const bf16* v;
  const float* bias;  // null for the self keys
  long long k_st, v_st;
  int t;
  float lscale, vscale;
};

__device__ __forceinline__ Source source_of(const Params& p, int src, int g, int b, int h) {
  Source s;
  if (src == 0) {
    s.k = p.ks + g * p.ks_s[0] + b * p.ks_s[1] + h * p.ks_s[2];
    s.v = p.vs + g * p.vs_s[0] + b * p.vs_s[1] + h * p.vs_s[2];
    s.bias = nullptr;
    s.k_st = p.ks_s[3];
    s.v_st = p.vs_s[3];
    s.t = p.S_kv;
    s.lscale = p.scale;
    s.vscale = 1.f;
  } else {
    const Seg& sg = p.seg[src - 1];
    s.k = sg.k + b * sg.k_sb + h * sg.k_sh;
    s.v = sg.v + b * sg.v_sb + h * sg.v_sh;
    s.bias = sg.bias + g * sg.bias_sg + b * sg.bias_sb;
    s.k_st = sg.k_st;
    s.v_st = sg.v_st;
    s.t = sg.t;
    s.lscale = p.scale * sg.scale;
    s.vscale = sg.scale;
  }
  return s;
}

// a consumer thread's softmax state for its two rows (lo: `row`, hi: `row + 8`)
struct Rows {
  float m_lo, m_hi;        // running max
  float l_lo, l_hi;        // this thread's share of the running sum
  float corr_lo, corr_hi;  // what the last step scales the output by
};

// this tile's bias: elements lane and lane + 32 (0 for the self keys and past
// the segment's end)
__device__ __forceinline__ void load_bias(const Source& s, int k0, int nk, int lane, float& b_lo,
                                          float& b_hi) {
  b_lo = b_hi = 0.f;
  if (s.bias == nullptr) return;
  if (lane < nk) b_lo = s.bias[k0 + lane];
  if (lane + 32 < nk) b_hi = s.bias[k0 + 32 + lane];
}

// One tile's online-softmax step on the score accumulator: sc becomes the
// logits (scores * lscale + bias, self keys past self_lim pushed down by
// -1e30, keys past the segment's end -inf), the running max and this thread's
// share of the running sum are updated, sc becomes exp2(logit - max) * vscale
// (the weights of P.V), and r.corr_* is the factor the output accumulated so
// far is to be scaled by.
__device__ __forceinline__ void process_tile(float (&sc)[32], const Source& s, int k0, int nk,
                                             int self_lim, float b_lo, float b_hi, int lane,
                                             Rows& r) {
  if (s.bias != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float add = tile_vec_at(b_lo, b_hi, j, e, lane);
        sc[4 * j + e] = fmaf(sc[4 * j + e], s.lscale, add);
        sc[4 * j + 2 + e] = fmaf(sc[4 * j + 2 + e], s.lscale, add);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= s.lscale;
    if (k0 + TILE_KEYS > self_lim) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (k0 + 8 * j + 2 * (lane & 3) + e >= self_lim) {
            sc[4 * j + e] += NEG;
            sc[4 * j + 2 + e] += NEG;
          }
        }
      }
    }
  }
  if (nk < TILE_KEYS) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + 2 * (lane & 3) + e >= nk) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
  float mx_lo, mx_hi;
  row_max(sc, mx_lo, mx_hi);
  // finite: key 0 of the tile exists and a bias of -1e30 is finite
  const float mn_lo = fmaxf(r.m_lo, mx_lo);
  const float mn_hi = fmaxf(r.m_hi, mx_hi);
  r.corr_lo = fast_exp2(r.m_lo - mn_lo);
  r.corr_hi = fast_exp2(r.m_hi - mn_hi);
  r.m_lo = mn_lo;
  r.m_hi = mn_hi;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[4 * j] = fast_exp2(sc[4 * j] - mn_lo);
    sc[4 * j + 1] = fast_exp2(sc[4 * j + 1] - mn_lo);
    sc[4 * j + 2] = fast_exp2(sc[4 * j + 2] - mn_hi);
    sc[4 * j + 3] = fast_exp2(sc[4 * j + 3] - mn_hi);
  }
  float sum_lo, sum_hi;
  row_sum(sc, sum_lo, sum_hi);
  r.l_lo = r.l_lo * r.corr_lo + sum_lo;
  r.l_hi = r.l_hi * r.corr_hi + sum_hi;
  if (s.vscale != 1.f) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= s.vscale;
  }
}

template <int NWG>
__global__ void __launch_bounds__(Ring<NWG>::THREADS, Ring<NWG>::MIN_BLOCKS)
joint_attention_kernel(const __grid_constant__ Params p) {
  using C = Ring<NWG>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t stage0 = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_k = stage0 + C::BAR_OFFSET;  // [STAGES]
  const uint32_t full_v = full_k + 8 * STAGES;     // [STAGES]
  const uint32_t empty = full_v + 8 * STAGES;      // [STAGES]

  const int q0 = blockIdx.x * (NWG * 64);
  const int h0 = blockIdx.y * p.hg;
  const int g = blockIdx.z / p.B;
  const int b = blockIdx.z % p.B;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) ring_init<NWG>(full_k);
  __syncthreads();

  if (wg == NWG) {
    // ------------------------------------------------------------ producer
    reg_dealloc<C::PRODUCER_REGS>();
    const int tid = threadIdx.x - NWG * WG_THREADS;
    int stage = 0;
    uint32_t phase = 0;
    for (int hj = 0; hj < p.hg; ++hj) {
      for (int src = 0; src <= p.nseg; ++src) {
        const Source s = source_of(p, src, g, b, h0 + hj);
        for (int k0 = 0; k0 < s.t; k0 += TILE_KEYS) {
          const int nk = min(TILE_KEYS, s.t - k0);
          const uint32_t k_smem = stage0 + stage * C::STAGE_BYTES;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          load_rows_async<TILE_KEYS, WG_THREADS>(k_smem, s.k + k0 * s.k_st, s.k_st, nk, tid);
          cp_async_arrive(full_k + 8 * stage);
          load_rows_async<TILE_KEYS, WG_THREADS>(k_smem + TILE_BYTES, s.v + k0 * s.v_st, s.v_st,
                                                 nk, tid);
          cp_async_arrive(full_v + 8 * stage);
          ring_advance<STAGES>(stage, phase);
        }
      }
    }
    cp_async_wait_all();
  } else {
    // ------------------------------------------------------------ consumer
    reg_alloc<C::CONSUMER_REGS>();
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % WG_THREADS) / 32;
    const int row = 16 * warp + lane / 4;  // and row + 8, of this group's 64
    const int s0 = q0 + wg * 64;           // this group's first query row
    const int n_rows = p.S - s0;           // rows of it that exist (may be <= 0)
    const int self_lim = p.self_len ? min(p.self_len[b], p.S_kv) : p.S_kv;
    int n_tiles = (p.S_kv + TILE_KEYS - 1) / TILE_KEYS;
    for (int i = 0; i < p.nseg; ++i) n_tiles += (p.seg[i].t + TILE_KEYS - 1) / TILE_KEYS;

    // A block walks through p.hg heads (the model path passes 1). The loop
    // is also what keeps this kernel within its registers: as straight-line
    // code the assembler spilled and serialised the wgmma (ptxas C7512); under
    // a loop whose trip count it cannot see it does neither.
    Walk w = {0, 0, 0, 0u};  // the ring runs on across heads
    for (int hj = 0; hj < p.hg; ++hj) {
      const int h = h0 + hj;
      uint32_t qf[32], pa[16];
      float o[64], sc[32];
      load_q_frags(qf, p.q + g * p.q_s[0] + b * p.q_s[1] + h * p.q_s[2] + s0 * p.q_s[3], p.q_s[3],
                   n_rows, row, lane);
      fence_regs(qf);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      Rows r = {-INFINITY, -INFINITY, 0.f, 0.f, 1.f, 1.f};

      // The tile whose P.V runs is one behind the tile whose scores are made:
      // start S(i+1) = Q.K(i+1)^T, start O += P(i).V(i), wait for S(i+1), softmax
      // of tile i+1 while P(i).V(i) runs, wait for it, then touch O and P.
      w.src = 0;
      w.k0 = 0;
      Source s = source_of(p, 0, g, b, h);
      qk_start<false>(sc, qf, stage0 + w.stage * C::STAGE_BYTES, full_k + 8 * w.stage, w.phase);
      wgmma_wait<0>();
      fence_regs(sc);
      process_tile(sc, s, 0, min(TILE_KEYS, s.t), self_lim, 0.f, 0.f, lane, r);
      // every trip starts the same wgmma groups (the last tile is peeled off),
      // so the assembler can follow them and does not serialise the products
      for (int it = 1; it < n_tiles; ++it) {
        pack_weights(pa, sc);
        rescale_rows(o, r.corr_lo, r.corr_hi);
        Walk n = w;  // the next tile
        n.k0 += TILE_KEYS;
        if (n.k0 >= s.t) {
          ++n.src;
          n.k0 = 0;
          s = source_of(p, n.src, g, b, h);
        }
        ring_advance<STAGES>(n.stage, n.phase);
        const int nk = min(TILE_KEYS, s.t - n.k0);
        float b_lo, b_hi;  // in flight during the products
        load_bias(s, n.k0, nk, lane, b_lo, b_hi);
        qk_start<false>(sc, qf, stage0 + n.stage * C::STAGE_BYTES, full_k + 8 * n.stage, n.phase);
        pv_start(o, pa, stage0 + w.stage * C::STAGE_BYTES + TILE_BYTES, full_v + 8 * w.stage,
                 w.phase);
        wgmma_wait<1>();  // the scores are there; P.V may still run
        fence_regs(sc);
        process_tile(sc, s, n.k0, nk, self_lim, b_lo, b_hi, lane, r);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty + 8 * w.stage);
        w = n;
      }
      pack_weights(pa, sc);
      rescale_rows(o, r.corr_lo, r.corr_hi);
      pv_start(o, pa, stage0 + w.stage * C::STAGE_BYTES + TILE_BYTES, full_v + 8 * w.stage,
               w.phase);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty + 8 * w.stage);
      ring_advance<STAGES>(w.stage, w.phase);

      const float l_lo = quad_sum(r.l_lo), l_hi = quad_sum(r.l_hi);
      if (p.lse != nullptr && (lane & 3) == 0) {
        float* lse = p.lse + (((long long)g * p.B + b) * p.H + h) * p.S + s0;
        if (row < n_rows) lse[row] = r.m_lo + log2f(l_lo);
        if (row + 8 < n_rows) lse[row + 8] = r.m_hi + log2f(l_hi);
      }
      store_rows(p.out + g * p.o_s[0] + b * p.o_s[1] + h * p.o_s[2] + s0 * p.o_s[3], p.o_s[3], o,
                 1.f / l_lo, 1.f / l_hi, row, n_rows, lane);
    }
  }
}

template <int NWG>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Ring<NWG>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(joint_attention_kernel<NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((p.S + NWG * 64 - 1) / (NWG * 64), p.H / p.hg, p.G * p.B);
  joint_attention_kernel<NWG><<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// tq: query rows a block takes, 64 (one consumer warpgroup) or 128 (two)
extern "C" int joint_attention_fwd(
    const void* q, const void* ks, const void* vs, void* out,
    const long long* q_s, const long long* ks_s, const long long* vs_s,
    const long long* o_s, const void* self_len, void* lse, int G, int B, int H, int S,
    int S_kv, const Seg* segs, int nseg, float scale, int tq, void* stream) {
  if (nseg < 0 || nseg > MAX_SEG || S < 1 || S_kv < 1 || (tq != 64 && tq != 128))
    return (int)cudaErrorInvalidValue;
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
  p.hg = 1;
  p.scale = scale;
  for (int i = 0; i < MAX_SEG; ++i) p.seg[i] = i < nseg ? segs[i] : Seg{};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(tq == 64 ? launch<1>(p, st) : launch<2>(p, st));
}
