// Kernel K1v: the measurement variants of segmented joint attention, sm_90a.
//
// Replaces scripts/bench_attention_variants.py:_kernel_var (called from
// attention_var). It is kernel K1 (joint_attention.cu) without the per-segment
// KV scale and without self_len, under the flags the script probes:
//   probe      full  normalised weights p/sum cast to bf16, then P.V (two
//                    passes over the keys: the (tq, ~3k) logits the Pallas
//                    body holds in VMEM do not fit 227 KB of shared memory,
//                    so pass 1 finds each row's max and denominator and pass
//                    2 rebuilds the logits, normalises, casts and multiplies);
//              fold  raw exponentials cast to bf16, P.V, the (tq, D) output
//                    normalised once: one pass with an online softmax, which
//                    is what K1 does;
//              dots  no softmax: weights = bf16(logit * 1e-9), products only;
//              noav  softmax without P.V: the first D columns of each
//                    block's normalised weights are summed (pass 1 as full,
//                    pass 2 over the first D keys of each block only);
//   mask_mode  where (uint8 select), bias (fp32 0/-1e30 added), arith (fp32
//              0/1, (m-1)*1e30 added), none;
//   use_exp2   base-2 exponent with log2(e) folded into the scale, or exp;
//   tq         64 or 128 query rows per block: one or two consumer warpgroups;
//   hg         heads a block walks through, one after the other;
//   k_t        keys stored (..., D, T): a (D x 64) key tile is MN-major for
//              q.k^T and is read through the descriptor's transpose flag;
//   g_inner    block order: the branch index fastest (consecutive blocks
//              share segment K/V, which then comes from L2), or slowest.
//
// Bound. 4*S*T*D FLOPs per (g, b, h) over one read of q, k, v and one write
// of out: far above the 295 FLOP/byte ridge, so tensor-core operations.
//
// Design. K1's, on the same core (attention_core.cuh): a producer warp
// streams a ring of 64-key K/V stages into 128-byte swizzled shared memory
// with cp.async, completion on mbarriers; each consumer warpgroup owns 64
// query rows, held as wgmma A fragments in registers, computes S = Q.K^T
// against the key tile in shared memory, keeps scores, weights and the
// (64 x 128) output in registers, and feeds the weights to O += P.V as the
// register A operand, V read MN-major. In a pass that multiplies by V the
// scores of tile i+1 are started before P(i).V(i) and processed while it runs.
// A tile's mask row is loaded once per warp and handed out by shuffles. Self
// keys first (so the running max is finite before a fully masked segment),
// then each segment from its own arrays; keys past a segment's end get no
// weight. The two-pass `full` pays the q.k^T product twice; that is the price
// of exact normalised weights without the VMEM. In pass 1, and under `noav`,
// no V tile is loaded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_core.cuh"

using namespace attn_core;

enum { PROBE_FULL = 0, PROBE_DOTS = 1, PROBE_NOAV = 2, PROBE_FOLD = 3 };
enum { MASK_WHERE = 0, MASK_BIAS = 1, MASK_ARITH = 2, MASK_NONE = 3 };

// one context segment; k is (B, H, T, D), or (B, H, D, T) under k_t
struct VarSeg {
  const bf16* k;
  const bf16* v;
  const void* mask;  // (G, B, T): uint8 for MASK_WHERE, else fp32
  long long k_sb, k_sh, k_sr;  // k_sr: stride of k's second-to-last axis
  long long v_sb, v_sh, v_st;
  long long m_sg, m_sb;
  int t;
};

namespace {

constexpr int MAX_SEG = 2;
constexpr float NEG = -1e30f;

struct Params {
  const bf16* q;
  const bf16* ks;
  const bf16* vs;
  bf16* out;
  long long q_s[4], ks_s[4], vs_s[4], o_s[4];  // strides of (g, b, h, second-to-last)
  int G, B, H, S, nseg, hg, mask_mode, use_exp2, g_inner;
  float scale;
  VarSeg seg[MAX_SEG];
};

// the keys of source `src` (0 = self, then the segments) for (g, b, h)
struct Source {
  const bf16* k;
  const bf16* v;
  const void* mask;  // null for the self keys and under MASK_NONE
  long long k_sr, v_st;
  int t;
};

__device__ __forceinline__ Source source_of(const Params& p, int src, int g, int b, int h) {
  Source s;
  s.mask = nullptr;
  if (src == 0) {
    s.k = p.ks + g * p.ks_s[0] + b * p.ks_s[1] + h * p.ks_s[2];
    s.v = p.vs + g * p.vs_s[0] + b * p.vs_s[1] + h * p.vs_s[2];
    s.k_sr = p.ks_s[3];
    s.v_st = p.vs_s[3];
    s.t = p.S;
  } else {
    const VarSeg& sg = p.seg[src - 1];
    s.k = sg.k + b * sg.k_sb + h * sg.k_sh;
    s.v = sg.v + b * sg.v_sb + h * sg.v_sh;
    s.k_sr = sg.k_sr;
    s.v_st = sg.v_st;
    s.t = sg.t;
    if (p.mask_mode == MASK_WHERE)
      s.mask = static_cast<const unsigned char*>(sg.mask) + g * sg.m_sg + b * sg.m_sb;
    else if (p.mask_mode != MASK_NONE)
      s.mask = static_cast<const float*>(sg.mask) + g * sg.m_sg + b * sg.m_sb;
  }
  return s;
}

// what a tile's scores become, once they are logits
enum { DO_STATS = 0, DO_FOLD = 1, DO_NORM = 2, DO_DOTS = 3 };

// a consumer thread's softmax state for its two rows (lo: `row`, hi: `row + 8`)
struct Rows {
  float m_lo, m_hi;        // running max
  float l_lo, l_hi;        // this thread's share of the running sum
  float inv_lo, inv_hi;    // 1 / sum, once pass 1 is over
  float corr_lo, corr_hi;  // what the last fold step scales the output by
};

struct Flags {
  int mask_mode;
  bool use_exp2;
  float scale;
};

// keys a pass walks of a source of t keys: noav's second pass needs only the
// first D of each block
template <int PROBE>
__device__ __forceinline__ int keys_walked(int t, int pass) {
  return (PROBE == PROBE_NOAV && pass == 1) ? min(t, HEAD_D) : t;
}

// this tile's mask row: elements lane and lane + 32 as floats (a value that
// changes nothing past the segment's end and for the self keys)
__device__ __forceinline__ void load_mask(const Source& s, const Flags& f, int k0, int nk, int lane,
                                          float& mk_lo, float& mk_hi) {
  mk_lo = mk_hi = f.mask_mode == MASK_BIAS ? 0.f : 1.f;
  if (s.mask == nullptr) return;
  if (f.mask_mode == MASK_WHERE) {
    const unsigned char* mk = static_cast<const unsigned char*>(s.mask) + k0;
    if (lane < nk) mk_lo = mk[lane] ? 1.f : 0.f;
    if (lane + 32 < nk) mk_hi = mk[lane + 32] ? 1.f : 0.f;
  } else {
    const float* mk = static_cast<const float*>(s.mask) + k0;
    if (lane < nk) mk_lo = mk[lane];
    if (lane + 32 < nk) mk_hi = mk[lane + 32];
  }
}

// scores -> logits of this thread's two rows (scale, the mask in its mode, keys
// past the end excluded), then what KIND makes of them:
//   DO_STATS  running max and sum (sc is left as the exponentials, unused);
//   DO_FOLD   running max and sum, sc = exp(logit - max), r.corr_* set;
//   DO_NORM   sc = exp(logit - max) / sum with the finished max and sum;
//   DO_DOTS   sc = logit * 1e-9.
template <int KIND>
__device__ __forceinline__ void process_tile(float (&sc)[32], const Source& s, const Flags& f,
                                             int nk, float mk_lo, float mk_hi, int lane,
                                             Rows& r) {
  // exp(x - m) = exp2((x - m) * k): k = 1 when the logits are in base 2
  const float k = f.use_exp2 ? 1.f : 1.4426950408889634f;
  if (s.mask == nullptr) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= f.scale;
  } else if (f.mask_mode == MASK_WHERE) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool keep = tile_vec_at(mk_lo, mk_hi, j, e, lane) != 0.f;
        sc[4 * j + e] = keep ? sc[4 * j + e] * f.scale : NEG;
        sc[4 * j + 2 + e] = keep ? sc[4 * j + 2 + e] * f.scale : NEG;
      }
    }
  } else {
    const bool arith = f.mask_mode == MASK_ARITH;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float add = tile_vec_at(mk_lo, mk_hi, j, e, lane);
        if (arith) add = (add - 1.f) * 1e30f;
        sc[4 * j + e] = fmaf(sc[4 * j + e], f.scale, add);
        sc[4 * j + 2 + e] = fmaf(sc[4 * j + 2 + e], f.scale, add);
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
  if (KIND == DO_DOTS) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = sc[i] == -INFINITY ? 0.f : sc[i] * 1e-9f;
  } else if (KIND == DO_NORM) {
    const float km_lo = r.m_lo * k, km_hi = r.m_hi * k;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = exp2_scaled(sc[4 * j], k, km_lo) * r.inv_lo;
      sc[4 * j + 1] = exp2_scaled(sc[4 * j + 1], k, km_lo) * r.inv_lo;
      sc[4 * j + 2] = exp2_scaled(sc[4 * j + 2], k, km_hi) * r.inv_hi;
      sc[4 * j + 3] = exp2_scaled(sc[4 * j + 3], k, km_hi) * r.inv_hi;
    }
  } else {
    float mx_lo, mx_hi;
    row_max(sc, mx_lo, mx_hi);
    // finite: self keys come first
    const float mn_lo = fmaxf(r.m_lo, mx_lo);
    const float mn_hi = fmaxf(r.m_hi, mx_hi);
    r.corr_lo = fast_exp2((r.m_lo - mn_lo) * k);
    r.corr_hi = fast_exp2((r.m_hi - mn_hi) * k);
    r.m_lo = mn_lo;
    r.m_hi = mn_hi;
    const float km_lo = mn_lo * k, km_hi = mn_hi * k;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = exp2_scaled(sc[4 * j], k, km_lo);
      sc[4 * j + 1] = exp2_scaled(sc[4 * j + 1], k, km_lo);
      sc[4 * j + 2] = exp2_scaled(sc[4 * j + 2], k, km_hi);
      sc[4 * j + 3] = exp2_scaled(sc[4 * j + 3], k, km_hi);
    }
    float sum_lo, sum_hi;
    row_sum(sc, sum_lo, sum_hi);
    r.l_lo = r.l_lo * r.corr_lo + sum_lo;
    r.l_hi = r.l_hi * r.corr_hi + sum_hi;
  }
}

template <int NWG, bool K_T, int PROBE>
__global__ void __launch_bounds__(Ring<NWG>::THREADS, Ring<NWG>::MIN_BLOCKS)
attention_var_kernel(const __grid_constant__ Params p) {
  using C = Ring<NWG>;
  constexpr int STAGES = C::STAGES;
  constexpr int TQ = NWG * 64;
  constexpr bool TWO_PASS = PROBE == PROBE_FULL || PROBE == PROBE_NOAV;
  constexpr bool WITH_PV = PROBE != PROBE_NOAV;
  // what the pass that multiplies by V makes of a tile
  constexpr int PV_KIND = PROBE == PROBE_FOLD ? DO_FOLD : PROBE == PROBE_DOTS ? DO_DOTS : DO_NORM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t stage0 = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_k = stage0 + C::BAR_OFFSET;  // [STAGES]
  const uint32_t full_v = full_k + 8 * STAGES;     // [STAGES]
  const uint32_t empty = full_v + 8 * STAGES;      // [STAGES]

  // block -> (g, b, head group, q tile)
  const int n_qt = (p.S + TQ - 1) / TQ;
  const int n_hg = p.H / p.hg;
  int idx = blockIdx.x, g, b, hgi, qt;
  if (p.g_inner) {
    g = idx % p.G; idx /= p.G;
    qt = idx % n_qt; idx /= n_qt;
    hgi = idx % n_hg; b = idx / n_hg;
  } else {
    qt = idx % n_qt; idx /= n_qt;
    hgi = idx % n_hg; idx /= n_hg;
    b = idx % p.B; g = idx / p.B;
  }
  const int q0 = qt * TQ;
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
      const int h = hgi * p.hg + hj;
      for (int pass = 0; pass < (TWO_PASS ? 2 : 1); ++pass) {
        const bool with_v = WITH_PV && !(TWO_PASS && pass == 0);
        for (int src = 0; src <= p.nseg; ++src) {
          const Source s = source_of(p, src, g, b, h);
          const int t_walk = keys_walked<PROBE>(s.t, pass);
          const bool vec = !K_T || (s.k_sr % 8 == 0 &&
                                    reinterpret_cast<unsigned long long>(s.k) % 16 == 0);
          for (int k0 = 0; k0 < t_walk; k0 += TILE_KEYS) {
            const int nk = min(TILE_KEYS, s.t - k0);
            const uint32_t k_smem = stage0 + stage * C::STAGE_BYTES;
            mbar_wait(empty + 8 * stage, phase ^ 1);
            if (K_T) load_cols<WG_THREADS>(k_smem, s.k + k0, s.k_sr, nk, tid, vec);
            else
              load_rows_async<TILE_KEYS, WG_THREADS>(k_smem, s.k + k0 * s.k_sr, s.k_sr, nk, tid);
            tile_arrive(full_k + 8 * stage, vec);
            if (with_v) {
              load_rows_async<TILE_KEYS, WG_THREADS>(k_smem + TILE_BYTES, s.v + k0 * s.v_st,
                                                     s.v_st, nk, tid);
              cp_async_arrive(full_v + 8 * stage);
            } else {
              mbar_arrive(full_v + 8 * stage);  // nothing to load: keep the phases in step
            }
            ring_advance<STAGES>(stage, phase);
          }
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
    const Flags f = {p.mask_mode, p.use_exp2 != 0, p.scale};

    Walk w = {0, 0, 0, 0u};  // the ring runs on across passes and heads
    for (int hj = 0; hj < p.hg; ++hj) {
      const int h = hgi * p.hg + hj;
      uint32_t qf[32];
      load_q_frags(qf, p.q + g * p.q_s[0] + b * p.q_s[1] + h * p.q_s[2] + s0 * p.q_s[3],
                   p.q_s[3], n_rows, row, lane);
      fence_regs(qf);
      float o[64], sc[32];
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      Rows r = {-INFINITY, -INFINITY, 0.f, 0.f, 1.f, 1.f, 1.f, 1.f};

      for (int pass = 0; pass < (TWO_PASS ? 2 : 1); ++pass) {
        if (TWO_PASS && pass == 1) {
          r.inv_lo = 1.f / quad_sum(r.l_lo);
          r.inv_hi = 1.f / quad_sum(r.l_hi);
        }
        w.src = 0;
        w.k0 = 0;
        Source s = source_of(p, 0, g, b, h);
        if (!WITH_PV || (TWO_PASS && pass == 0)) {
          // no P.V in this pass: scores, then what the pass takes from them
          while (true) {
            const int nk = min(TILE_KEYS, s.t - w.k0);
            float mk_lo, mk_hi;
            load_mask(s, f, w.k0, nk, lane, mk_lo, mk_hi);
            qk_start<K_T>(sc, qf, stage0 + w.stage * C::STAGE_BYTES, full_k + 8 * w.stage,
                          w.phase);
            wgmma_wait<0>();
            fence_regs(sc);
            if (lane == 0) mbar_arrive(empty + 8 * w.stage);
            if (pass == 0) {
              process_tile<DO_STATS>(sc, s, f, nk, mk_lo, mk_hi, lane, r);
            } else {
              // noav: output column = key index within the block (k0 is 0 or 64)
              process_tile<DO_NORM>(sc, s, f, nk, mk_lo, mk_hi, lane, r);
              if (w.k0 == 0) {
#pragma unroll
                for (int i = 0; i < 32; ++i) o[i] += sc[i];
              } else {
#pragma unroll
                for (int i = 0; i < 32; ++i) o[32 + i] += sc[i];
              }
            }
            ring_advance<STAGES>(w.stage, w.phase);
            w.k0 += TILE_KEYS;
            if (w.k0 >= keys_walked<PROBE>(s.t, pass)) {
              if (++w.src > p.nseg) break;
              w.k0 = 0;
              s = source_of(p, w.src, g, b, h);
            }
          }
        } else {
          // The tile whose P.V runs is one behind the tile whose scores are
          // made: start S(i+1), start O += P(i).V(i), wait for S(i+1), process
          // tile i+1 while P(i).V(i) runs, wait for it, then touch O and P.
          uint32_t pa[16];
          qk_start<K_T>(sc, qf, stage0 + w.stage * C::STAGE_BYTES, full_k + 8 * w.stage, w.phase);
          wgmma_wait<0>();
          fence_regs(sc);
          // self keys: no mask
          process_tile<PV_KIND>(sc, s, f, min(TILE_KEYS, s.t), 0.f, 0.f, lane, r);
          int n_tiles = (p.S + TILE_KEYS - 1) / TILE_KEYS;
          for (int i = 0; i < p.nseg; ++i) n_tiles += (p.seg[i].t + TILE_KEYS - 1) / TILE_KEYS;
          // every trip starts the same wgmma groups (the last tile is peeled
          // off), so the assembler can follow them and does not serialise them
          for (int it = 1; it < n_tiles; ++it) {
            pack_weights(pa, sc);
            if (PV_KIND == DO_FOLD) rescale_rows(o, r.corr_lo, r.corr_hi);
            Walk n = w;  // the next tile
            n.k0 += TILE_KEYS;
            if (n.k0 >= s.t) {
              ++n.src;
              n.k0 = 0;
              s = source_of(p, n.src, g, b, h);
            }
            ring_advance<STAGES>(n.stage, n.phase);
            const int nk = min(TILE_KEYS, s.t - n.k0);
            float mk_lo, mk_hi;
            load_mask(s, f, n.k0, nk, lane, mk_lo, mk_hi);
            qk_start<K_T>(sc, qf, stage0 + n.stage * C::STAGE_BYTES, full_k + 8 * n.stage,
                          n.phase);
            pv_start(o, pa, stage0 + w.stage * C::STAGE_BYTES + TILE_BYTES, full_v + 8 * w.stage,
                     w.phase);
            wgmma_wait<1>();  // the scores are there; P.V may still run
            fence_regs(sc);
            process_tile<PV_KIND>(sc, s, f, nk, mk_lo, mk_hi, lane, r);
            wgmma_wait<0>();
            fence_regs(o);
            if (lane == 0) mbar_arrive(empty + 8 * w.stage);
            w = n;
          }
          pack_weights(pa, sc);
          if (PV_KIND == DO_FOLD) rescale_rows(o, r.corr_lo, r.corr_hi);
          pv_start(o, pa, stage0 + w.stage * C::STAGE_BYTES + TILE_BYTES, full_v + 8 * w.stage,
                   w.phase);
          wgmma_wait<0>();
          fence_regs(o);
          if (lane == 0) mbar_arrive(empty + 8 * w.stage);
          ring_advance<STAGES>(w.stage, w.phase);
        }
      }

      const bool fold = PROBE == PROBE_FOLD;  // full and noav carry normalised weights already
      store_rows(p.out + g * p.o_s[0] + b * p.o_s[1] + h * p.o_s[2] + s0 * p.o_s[3], p.o_s[3],
                 o, fold ? 1.f / quad_sum(r.l_lo) : 1.f, fold ? 1.f / quad_sum(r.l_hi) : 1.f, row,
                 n_rows, lane);
    }
  }
}

template <int NWG, bool K_T, int PROBE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Ring<NWG>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(attention_var_kernel<NWG, K_T, PROBE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int n_qt = (p.S + NWG * 64 - 1) / (NWG * 64);
  const int blocks = p.G * p.B * (p.H / p.hg) * n_qt;
  attention_var_kernel<NWG, K_T, PROBE><<<blocks, C::THREADS, C::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <int NWG, bool K_T>
cudaError_t launch_probe(const Params& p, int probe, cudaStream_t stream) {
  switch (probe) {
    case PROBE_FULL: return launch<NWG, K_T, PROBE_FULL>(p, stream);
    case PROBE_DOTS: return launch<NWG, K_T, PROBE_DOTS>(p, stream);
    case PROBE_NOAV: return launch<NWG, K_T, PROBE_NOAV>(p, stream);
    default: return launch<NWG, K_T, PROBE_FOLD>(p, stream);
  }
}

}  // namespace

// q, ks, vs, out: (G, B, H, S, D) bf16 with the element strides of (g, b, h,
// second-to-last axis) in *_s and a contiguous last axis; under k_t, ks is
// (G, B, H, D, S). scale already carries log2(e) when use_exp2 is set.
extern "C" int attention_var_fwd(
    const void* q, const void* ks, const void* vs, void* out,
    const long long* q_s, const long long* ks_s, const long long* vs_s,
    const long long* o_s, int G, int B, int H, int S, const VarSeg* segs, int nseg,
    float scale, int tq, int hg, int probe, int mask_mode, int use_exp2, int k_t,
    int g_inner, void* stream) {
  if (nseg < 0 || nseg > MAX_SEG || S < 1 || (tq != 64 && tq != 128) || hg < 1 || H % hg ||
      probe < 0 || probe > PROBE_FOLD || mask_mode < 0 || mask_mode > MASK_NONE)
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
  p.G = G; p.B = B; p.H = H; p.S = S; p.nseg = nseg; p.hg = hg;
  p.mask_mode = mask_mode; p.use_exp2 = use_exp2; p.g_inner = g_inner;
  p.scale = scale;
  for (int i = 0; i < MAX_SEG; ++i) p.seg[i] = i < nseg ? segs[i] : VarSeg{};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tq == 64)
    return (int)(k_t ? launch_probe<1, true>(p, probe, st) : launch_probe<1, false>(p, probe, st));
  return (int)(k_t ? launch_probe<2, true>(p, probe, st) : launch_probe<2, false>(p, probe, st));
}
