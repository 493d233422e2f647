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
// folded into dl before the rounding). Every output tile has one owner, so
// there are no atomics, and a segment's dk/dv is summed over the branches
// inside one block, as the Pallas kernel's seg_acc sums it.
//
// Bound. The five products cost 10*S*T*D FLOPs per (g, b, h) (T = all keys);
// at the training shape (G=1, B=8, H=16, S=640, T=640+768+160, D=128) that
// is 164 GFLOP against ~60 MB of inputs and outputs: ~2.7k FLOP per byte,
// far above the H100's ~295 FLOP/byte ridge, so it is bound by tensor-core
// operations (989 TFLOP/s bf16: ~0.166 ms), which only wgmma reaches.
//
// Design (on attention_core.cuh, the core of K1). The Pallas kernel holds the
// S x T logits of every branch in VMEM, one program per (b, h); that does not
// fit 227 KB of shared memory. Two launches instead, each a block of two
// consumer warpgroups (64 rows each) and one producer warpgroup that streams
// 64-row tiles through the ring of K1 (Ring<2>: four stages of two tiles,
// 16-byte cp.async copies completed on mbarriers, 128-byte swizzle):
//   A. dq pass, one block per (g, b, h, 128 query rows). A consumer holds
//      its rows of q and dO as wgmma A fragments in registers for the whole
//      pass; its prologue computes r = rowsum(dO*O) from the forward output O
//      (equal to sum(dp*p) up to O's bf16 rounding) and writes it for pass B.
//      K/V tiles stream as in K1, self keys first, then each segment from its
//      own K/V/bias. Per tile: S = Q.K^T; p = exp2(S*c2 + bias - lse) with
//      lse, K1's base-2 log-sum-exp, so no second softmax pass; dP = dO.V^T;
//      dS = p*(dP*s - r)*c*s as bf16 A fragments; dq += dS.K with K read
//      MN-major (the P.V form of K1). dq stays in registers.
//   B. dk/dv pass, one block per (b, h, 128 keys) of one source: the self
//      keys of branch g, or a segment. The K and V rows of the block stay in
//      shared memory as A operands; the producer streams (q, dO) tile pairs
//      of 64 query rows, the branch's own for self keys, every branch's for a
//      segment (the sum over g stays in the block). Everything is computed
//      transposed, keys as rows: S^T = K.q^T and dP^T = V.dO^T (the q.k^T form
//      with A from shared memory), P^T and dS^T from those accumulators with
//      lse and r per column (one load a warp, handed out by shuffles) and the
//      key's bias per row; then dV += P^T.dO and dK += dS^T.q, both in the
//      P.V form, so no tile is ever stored transposed and no new wgmma form
//      is needed. dk and dv stay in registers (64 + 64 a thread); dv is scaled
//      by s_seg at the store.
// Each trip of a pass overlaps the exponentials of tile i+1 with the
// accumulating product(s) of tile i: S(i+1) is issued, then the products of
// tile i, and p(i+1) is computed while those run; dP(i+1) follows once they
// are done. A consumer thus keeps at most 192 registers of fragments and
// accumulators live (q 32, dO 32, S 32, dP 32, dq 64 in pass A; dk 64, dv 64,
// S 32, dP 32 in pass B) under its 240 (setmaxnreg; the producers keep 24).
// In both passes the whole consumer body, from zeroing the accumulators to
// storing them, sits under a loop over a block's heads (hg, 1 at run time),
// as in K1: with only its inner loops under one, pass B spilled kilobytes and
// ptxas serialised its wgmma (C7512), several times slower. Both passes
// recompute q.k^T and dO.v^T: 14*S*T*D of tensor work against the bound's
// 10*S*T*D.
//
// Keys past a source's end (T=1, T=700) get p = 0 in pass A and are not
// written in pass B; query rows past S get p = 0 in pass B and are not
// written in pass A. Nothing is padded on the host.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_core.cuh"

using namespace attn_core;

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

constexpr int MAX_SEG = 3;
constexpr int NWG = 2;  // consumer warpgroups a block
using R = Ring<NWG>;
constexpr int STAGES = R::STAGES;
constexpr int BLOCK_ROWS = NWG * 64;  // query rows (pass A) or keys (pass B) of a block
constexpr int RES_BYTES = NWG * 2 * TILE_BYTES;  // pass B: the block's K and V tiles
constexpr int SMEM_A = R::SMEM_BYTES;
constexpr int SMEM_B = R::SMEM_BYTES + RES_BYTES + 16;  // + the K/V barriers

struct Params {
  const bf16* q;
  const bf16* ks;
  const bf16* vs;
  const bf16* dout;
  const bf16* o;
  const float* lse;  // (G, B, H, S) base-2 log-sum-exp from kernel K1
  float* r;          // (G, B, H, S) rowsum(dO*O), written by pass A
  bf16* dq;
  bf16* dks;
  bf16* dvs;
  // element strides of (g, b, h, s) for q, k_self, v_self, dO, O, dq,
  // dk_self, dv_self
  long long st[8][4];
  int G, B, H, S, S_kv, nseg;
  int hg;        // heads a block walks through, one after the other (a divisor of H)
  float scale2;  // log2(e)/sqrt(D), K1's base-2 logit scale
  float scale;   // 1/sqrt(D)
  SegB seg[MAX_SEG];
};

enum { Q = 0, KS, VS, DO, O, DQ, DKS, DVS };

__device__ __forceinline__ long long row_off(const long long* s, int g, int b, int h) {
  return g * s[0] + b * s[1] + h * s[2];
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

__device__ __forceinline__ long long lse_row0(const Params& p, int g, int b, int h) {
  return (((long long)g * p.B + b) * p.H + h) * p.S;
}

// x[i0 + lane] and x[i0 + 32 + lane], zero at or past n: a per-tile vector
// as tile_vec_at hands it out
__device__ __forceinline__ void load_vec(float (&v)[2], const float* x, int i0, int n, int lane) {
  v[0] = i0 + lane < n ? x[i0 + lane] : 0.f;
  v[1] = i0 + 32 + lane < n ? x[i0 + 32 + lane] : 0.f;
}

// an address the assembler cannot see through: the shared-memory
// descriptors of a resident tile, built from it inside a loop, are otherwise
// hoisted out of the loop and hold 32 registers for its whole length (pass B
// then spills about four times the bytes)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ float dot_bf16x2(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  return fmaf(x.x, y.x, x.y * y.y);
}

// r = rowsum(dO*O) of this thread's two rows: dof holds its share of dO as A
// fragments (load_q_frags), O is read at the same columns; the four threads
// of a row hold its 128 columns between them
__device__ __forceinline__ void row_dot(const uint32_t (&dof)[32], const bf16* o, long long stride,
                                        int n_rows, int row, int lane, float& r_lo, float& r_hi) {
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(o + row * stride) + (lane & 3);
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(o + (row + 8) * stride) + (lane & 3);
  float a = 0.f, c = 0.f;
  if (row < n_rows) {
#pragma unroll
    for (int kk = 0; kk < HEAD_D / 16; ++kk) {
      a += dot_bf16x2(dof[4 * kk], lo[8 * kk]);
      a += dot_bf16x2(dof[4 * kk + 2], lo[8 * kk + 4]);
    }
  }
  if (row + 8 < n_rows) {
#pragma unroll
    for (int kk = 0; kk < HEAD_D / 16; ++kk) {
      c += dot_bf16x2(dof[4 * kk + 1], hi[8 * kk]);
      c += dot_bf16x2(dof[4 * kk + 3], hi[8 * kk + 4]);
    }
  }
  r_lo = quad_sum(a);
  r_hi = quad_sum(c);
}

// ------------------------------------------------------------------ pass A

// the scores of one tile (rows: queries, columns: keys) become p =
// exp2(s*lscale + bias - lse); keys at or past nk get 0
__device__ __forceinline__ void probs_rows(float (&sc)[32], const Src& s, const float (&bias)[2],
                                           float nl_lo, float nl_hi, int nk, int lane) {
  if (s.bias != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float add = tile_vec_at(bias[0], bias[1], j, e, lane);
        sc[4 * j + e] = fast_exp2(fmaf(sc[4 * j + e], s.lscale, add + nl_lo));
        sc[4 * j + 2 + e] = fast_exp2(fmaf(sc[4 * j + 2 + e], s.lscale, add + nl_hi));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = fast_exp2(fmaf(sc[4 * j], s.lscale, nl_lo));
      sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], s.lscale, nl_lo));
      sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], s.lscale, nl_hi));
      sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], s.lscale, nl_hi));
    }
  }
  if (nk < TILE_KEYS) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + 2 * (lane & 3) + e >= nk) sc[4 * j + e] = sc[4 * j + 2 + e] = 0.f;
      }
    }
  }
}

// p becomes dS = p * (dP*vscale - r) * dscale, r per row
__device__ __forceinline__ void grads_rows(float (&sc)[32], const float (&dp)[32], const Src& s,
                                           float r_lo, float r_hi) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * j + e] *= fmaf(dp[4 * j + e], s.vscale, -r_lo) * s.dscale;
      sc[4 * j + 2 + e] *= fmaf(dp[4 * j + 2 + e], s.vscale, -r_hi) * s.dscale;
    }
  }
}

// acc += A (bf16 fragments) . B, B a (64 x 128) two-half tile read MN-major
// (the P.V form); issued and committed, wgmma_wait follows
__device__ __forceinline__ void acc_start(float (&acc)[64], uint32_t (&a)[16], uint32_t b) {
  fence_regs(a);
  fence_regs(acc);
  pv_product(acc, a, b);
  wgmma_commit();
}

__global__ void __launch_bounds__(R::THREADS, 1) dq_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t stage0 = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_k = stage0 + R::BAR_OFFSET;  // [STAGES]
  const uint32_t full_v = full_k + 8 * STAGES;     // [STAGES]
  const uint32_t empty = full_v + 8 * STAGES;      // [STAGES]

  const int q0 = blockIdx.x * BLOCK_ROWS;
  const int h0 = blockIdx.y * p.hg;
  const int g = blockIdx.z / p.B;
  const int b = blockIdx.z % p.B;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) ring_init<NWG>(full_k);
  __syncthreads();

  if (wg == NWG) {
    // ------------------------------------------------------------ producer
    reg_dealloc<R::PRODUCER_REGS>();
    const int tid = threadIdx.x - NWG * WG_THREADS;
    int stage = 0;
    uint32_t phase = 0;
    for (int hj = 0; hj < p.hg; ++hj) {
      for (int src = 0; src <= p.nseg; ++src) {
        const Src s = source(p, src, g, b, h0 + hj);
        for (int k0 = 0; k0 < s.t; k0 += TILE_KEYS) {
          const int nk = min(TILE_KEYS, s.t - k0);
          const uint32_t k_smem = stage0 + stage * R::STAGE_BYTES;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          load_rows_async<TILE_KEYS, WG_THREADS>(k_smem, s.k + k0 * s.kst, s.kst, nk, tid);
          cp_async_arrive(full_k + 8 * stage);
          load_rows_async<TILE_KEYS, WG_THREADS>(k_smem + TILE_BYTES, s.v + k0 * s.vst, s.vst, nk,
                                                 tid);
          cp_async_arrive(full_v + 8 * stage);
          ring_advance<STAGES>(stage, phase);
        }
      }
    }
    cp_async_wait_all();
  } else {
    // ------------------------------------------------------------ consumer
    reg_alloc<R::CONSUMER_REGS>();
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % WG_THREADS) / 32;
    const int row = 16 * warp + lane / 4;  // and row + 8, of this group's 64
    const int s0 = q0 + wg * 64;           // this group's first query row
    const int n_rows = p.S - s0;           // rows of it that exist (may be <= 0)
    int n_tiles = (p.S_kv + TILE_KEYS - 1) / TILE_KEYS;
    for (int i = 0; i < p.nseg; ++i) n_tiles += (p.seg[i].t + TILE_KEYS - 1) / TILE_KEYS;

    // the loop over a block's heads (the wrapper passes one) keeps the body
    // under a loop whose trip count the assembler cannot see, as in K1: as
    // straight-line code such a body spilled and serialised its wgmma
    Walk w = {0, 0, 0, 0u};  // the ring runs on across heads
    for (int hj = 0; hj < p.hg; ++hj) {
      const int h = h0 + hj;
      uint32_t qf[32], dof[32], da[16];
      float sc[32], dp[32], dq[64];
      load_q_frags(qf, p.q + row_off(p.st[Q], g, b, h) + s0 * p.st[Q][3], p.st[Q][3], n_rows, row,
                   lane);
      load_q_frags(dof, p.dout + row_off(p.st[DO], g, b, h) + s0 * p.st[DO][3], p.st[DO][3],
                   n_rows, row, lane);
      float r_lo, r_hi;
      row_dot(dof, p.o + row_off(p.st[O], g, b, h) + s0 * p.st[O][3], p.st[O][3], n_rows, row,
              lane, r_lo, r_hi);
      const long long rows0 = lse_row0(p, g, b, h) + s0;
      if ((lane & 3) == 0) {
        if (row < n_rows) p.r[rows0 + row] = r_lo;
        if (row + 8 < n_rows) p.r[rows0 + row + 8] = r_hi;
      }
      const float nl_lo = row < n_rows ? -p.lse[rows0 + row] : 0.f;
      const float nl_hi = row + 8 < n_rows ? -p.lse[rows0 + row + 8] : 0.f;
      fence_regs(qf);
      fence_regs(dof);
#pragma unroll
      for (int i = 0; i < 64; ++i) dq[i] = 0.f;

      // tile 0: p, dP, dS
      w.src = 0;
      w.k0 = 0;
      Src s = source(p, 0, g, b, h);
      qk_start<false>(sc, qf, stage0 + w.stage * R::STAGE_BYTES, full_k + 8 * w.stage, w.phase);
      wgmma_wait<0>();
      fence_regs(sc);
      const float no_bias[2] = {0.f, 0.f};
      probs_rows(sc, s, no_bias, nl_lo, nl_hi, min(TILE_KEYS, s.t), lane);
      qk_start<false>(dp, dof, stage0 + w.stage * R::STAGE_BYTES + TILE_BYTES, full_v + 8 * w.stage,
                      w.phase);
      wgmma_wait<0>();
      fence_regs(dp);
      grads_rows(sc, dp, s, r_lo, r_hi);
      // Each trip: S(i+1) = Q.K(i+1)^T and dq += dS(i).K(i) are issued, p(i+1)
      // is made while dq's product runs, then dP(i+1) = dO.V(i+1)^T and
      // dS(i+1). Every trip issues the same wgmma groups (the last tile is
      // peeled off).
      for (int it = 1; it < n_tiles; ++it) {
        pack_weights(da, sc);
        Walk n = w;  // the next tile
        n.k0 += TILE_KEYS;
        if (n.k0 >= s.t) {
          ++n.src;
          n.k0 = 0;
          s = source(p, n.src, g, b, h);
        }
        ring_advance<STAGES>(n.stage, n.phase);
        const int nk = min(TILE_KEYS, s.t - n.k0);
        float bias[2] = {0.f, 0.f};  // in flight during the products
        if (s.bias != nullptr) load_vec(bias, s.bias + n.k0, 0, nk, lane);
        const uint32_t k_next = stage0 + n.stage * R::STAGE_BYTES;
        qk_start<false>(sc, qf, k_next, full_k + 8 * n.stage, n.phase);
        acc_start(dq, da, stage0 + w.stage * R::STAGE_BYTES);
        wgmma_wait<1>();  // the scores are there; dq's product may still run
        fence_regs(sc);
        probs_rows(sc, s, bias, nl_lo, nl_hi, nk, lane);
        wgmma_wait<0>();
        fence_regs(dq);
        if (lane == 0) mbar_arrive(empty + 8 * w.stage);
        qk_start<false>(dp, dof, k_next + TILE_BYTES, full_v + 8 * n.stage, n.phase);
        wgmma_wait<0>();
        fence_regs(dp);
        grads_rows(sc, dp, s, r_lo, r_hi);
        w = n;
      }
      pack_weights(da, sc);
      acc_start(dq, da, stage0 + w.stage * R::STAGE_BYTES);
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(empty + 8 * w.stage);
      ring_advance<STAGES>(w.stage, w.phase);

      store_rows(p.dq + row_off(p.st[DQ], g, b, h) + s0 * p.st[DQ][3], p.st[DQ][3], dq, 1.f, 1.f,
                 row, n_rows, lane);
    }
  }
}

// ------------------------------------------------------------------ pass B

// S^T of one tile (rows: keys, columns: queries) becomes P^T =
// exp2(s*lscale + bias_row - lse_col), lse per column as tile_vec_at hands
// it out; query columns at or past nq get 0
__device__ __forceinline__ void probs_cols(float (&st)[32], float lscale, float bias_lo,
                                           float bias_hi, const float (&lse)[2], int nq,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float l = tile_vec_at(lse[0], lse[1], j, e, lane);
      st[4 * j + e] = fast_exp2(fmaf(st[4 * j + e], lscale, bias_lo - l));
      st[4 * j + 2 + e] = fast_exp2(fmaf(st[4 * j + 2 + e], lscale, bias_hi - l));
    }
  }
  if (nq < 64) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + 2 * (lane & 3) + e >= nq) st[4 * j + e] = st[4 * j + 2 + e] = 0.f;
      }
    }
  }
}

// dP^T becomes dS^T = P^T * (dP^T*vscale - r_col) * dscale
__device__ __forceinline__ void grads_cols(float (&dpt)[32], const float (&pt)[32], const Src& s,
                                           const float (&rv)[2], int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float r = tile_vec_at(rv[0], rv[1], j, e, lane);
      dpt[4 * j + e] = pt[4 * j + e] * (fmaf(dpt[4 * j + e], s.vscale, -r) * s.dscale);
      dpt[4 * j + 2 + e] = pt[4 * j + 2 + e] * (fmaf(dpt[4 * j + 2 + e], s.vscale, -r) * s.dscale);
    }
  }
}

// waits for the tile behind `full` and starts s = A.B^T with A this group's
// resident (64 x 128) K or V tile and B a (64 x 128) q or dO tile of the ring
__device__ __forceinline__ void kq_start(float (&s)[32], uint32_t a, uint32_t b, uint32_t full,
                                         uint32_t phase) {
  mbar_wait(full, phase);
  fence_proxy_async();
  qk_product_ss<false>(s, a, HALF_TILE_BYTES, b);
  wgmma_commit();
}

// dV += P^T.dO and dK += dS^T.q on the ring stage at `qd` (q tile, then dO
// tile), as one wgmma group
__device__ __forceinline__ void dkdv_start(float (&dv)[64], uint32_t (&pa)[16], float (&dk)[64],
                                           uint32_t (&da)[16], uint32_t qd) {
  fence_regs(pa);
  fence_regs(da);
  fence_regs(dv);
  fence_regs(dk);
  pv_product(dv, pa, qd + TILE_BYTES);
  pv_product(dk, da, qd);
  wgmma_commit();
}

__global__ void __launch_bounds__(R::THREADS, 1) dkdv_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t res = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [NWG] x (K tile, V tile)
  const uint32_t stage0 = res + RES_BYTES;                       // the ring: (q tile, dO tile)
  const uint32_t full_q = stage0 + R::BAR_OFFSET;                // [STAGES]
  const uint32_t full_do = full_q + 8 * STAGES;                  // [STAGES]
  const uint32_t empty = full_do + 8 * STAGES;                   // [STAGES]
  const uint32_t full_kv = empty + 8 * STAGES;  // the K/V tiles have landed
  const uint32_t empty_kv = full_kv + 8;         // and are done with

  const int h0 = blockIdx.y * p.hg;
  const int b = blockIdx.z;
  const int wg = threadIdx.x / WG_THREADS;

  // which key tile: [self tiles of branch 0 | ... | branch G-1 | segment 0 | ...]
  int tile = blockIdx.x;
  const int n_self = (p.S_kv + BLOCK_ROWS - 1) / BLOCK_ROWS;
  int src = 0, g_lo, g_hi;
  if (tile < p.G * n_self) {
    g_lo = tile / n_self;
    g_hi = g_lo + 1;
    tile %= n_self;
  } else {
    tile -= p.G * n_self;
    src = 1;
    while (src < p.nseg && tile >= (p.seg[src - 1].t + BLOCK_ROWS - 1) / BLOCK_ROWS) {
      tile -= (p.seg[src - 1].t + BLOCK_ROWS - 1) / BLOCK_ROWS;
      ++src;
    }
    g_lo = 0;
    g_hi = p.G;
  }
  const int k0 = tile * BLOCK_ROWS;
  const int t_src = src == 0 ? p.S_kv : p.seg[src - 1].t;
  const int n_q = (p.S + 63) / 64;

  if (threadIdx.x == 0) {
    ring_init<NWG>(full_q);
    mbar_init(full_kv, WG_THREADS);
    mbar_init(empty_kv, NWG * 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {
    // ------------------------------------------------------------ producer
    reg_dealloc<R::PRODUCER_REGS>();
    const int tid = threadIdx.x - NWG * WG_THREADS;
    int stage = 0;
    uint32_t phase = 0;
    for (int hj = 0; hj < p.hg; ++hj) {
      const int h = h0 + hj;
      const Src s0 = source(p, src, g_lo, b, h);
      mbar_wait(empty_kv, (hj & 1) ^ 1);  // the previous head's K/V are done with
#pragma unroll
      for (int i = 0; i < NWG; ++i) {
        const int n = s0.t - (k0 + 64 * i);  // a group past the end gets zero rows
        const int kr = n > 0 ? k0 + 64 * i : 0;
        const uint32_t kv = res + i * 2 * TILE_BYTES;
        load_rows_async<64, WG_THREADS>(kv, s0.k + kr * s0.kst, s0.kst, n, tid);
        load_rows_async<64, WG_THREADS>(kv + TILE_BYTES, s0.v + kr * s0.vst, s0.vst, n, tid);
      }
      cp_async_arrive(full_kv);
      for (int g = g_lo; g < g_hi; ++g) {
        const bf16* qg = p.q + row_off(p.st[Q], g, b, h);
        const bf16* dog = p.dout + row_off(p.st[DO], g, b, h);
        for (int q0 = 0; q0 < p.S; q0 += 64) {
          const int nq = min(64, p.S - q0);
          const uint32_t q_smem = stage0 + stage * R::STAGE_BYTES;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          load_rows_async<64, WG_THREADS>(q_smem, qg + q0 * p.st[Q][3], p.st[Q][3], nq, tid);
          cp_async_arrive(full_q + 8 * stage);
          load_rows_async<64, WG_THREADS>(q_smem + TILE_BYTES, dog + q0 * p.st[DO][3],
                                          p.st[DO][3], nq, tid);
          cp_async_arrive(full_do + 8 * stage);
          ring_advance<STAGES>(stage, phase);
        }
      }
    }
    cp_async_wait_all();
  } else {
    // ------------------------------------------------------------ consumer
    reg_alloc<R::CONSUMER_REGS>();
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % WG_THREADS) / 32;
    const int row = 16 * warp + lane / 4;  // key rows row and row + 8 of this group's 64
    const int kw = k0 + 64 * wg;           // this group's first key
    const int n_keys = t_src - kw;         // keys of it that exist (may be <= 0)
    const uint32_t kt = res + wg * 2 * TILE_BYTES, vt = kt + TILE_BYTES;
    int stage = 0;
    uint32_t phase = 0;
    // A block walks through p.hg heads (the wrapper passes 1); as in pass A,
    // the loop keeps the whole body, from the accumulators' zeroing to their
    // store, under a loop whose trip count the assembler cannot see
    for (int hj = 0; hj < p.hg; ++hj) {
      const int h = h0 + hj;
      float dk[64], dv[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(full_kv, hj & 1);
      fence_proxy_async();
      // a segment's keys walk every branch, self keys only their own
      for (int g = g_lo; g < g_hi; ++g) {
        const Src s = source(p, src, g, b, h);
        const float bias_lo = s.bias != nullptr && row < n_keys ? s.bias[kw + row] : 0.f;
        const float bias_hi = s.bias != nullptr && row + 8 < n_keys ? s.bias[kw + row + 8] : 0.f;
        const float* lse = p.lse + lse_row0(p, g, b, h);
        const float* rr = p.r + lse_row0(p, g, b, h);
        uint32_t pa[16], da[16];
        float st[32], dpt[32];
        float lv[2], rv[2];  // lse and r of the q tile's 64 rows

        // q tile 0: P^T, dP^T, dS^T
        load_vec(lv, lse, 0, p.S, lane);
        load_vec(rv, rr, 0, p.S, lane);
        kq_start(st, opaque(kt), stage0 + stage * R::STAGE_BYTES, full_q + 8 * stage, phase);
        wgmma_wait<0>();
        fence_regs(st);
        probs_cols(st, s.lscale, bias_lo, bias_hi, lv, min(64, p.S), lane);
        kq_start(dpt, opaque(vt), stage0 + stage * R::STAGE_BYTES + TILE_BYTES,
                 full_do + 8 * stage, phase);
        wgmma_wait<0>();
        fence_regs(dpt);
        grads_cols(dpt, st, s, rv, lane);
        // Each trip: S^T(i+1) = K.q(i+1)^T, then dV += P^T(i).dO(i) and dK +=
        // dS^T(i).q(i) are issued, P^T(i+1) is made while the two accumulate,
        // then dP^T(i+1) = V.dO(i+1)^T and dS^T(i+1)
        for (int qt = 1; qt < n_q; ++qt) {
          pack_weights(pa, st);
          pack_weights(da, dpt);
          const int cur = stage;
          ring_advance<STAGES>(stage, phase);
          const int q0 = 64 * qt;
          load_vec(lv, lse, q0, p.S, lane);  // in flight during the products
          load_vec(rv, rr, q0, p.S, lane);
          const uint32_t cur_q = stage0 + cur * R::STAGE_BYTES;
          const uint32_t next_q = stage0 + stage * R::STAGE_BYTES;
          kq_start(st, opaque(kt), next_q, full_q + 8 * stage, phase);
          dkdv_start(dv, pa, dk, da, cur_q);
          wgmma_wait<1>();  // S^T is there; dV and dK may still run
          fence_regs(st);
          probs_cols(st, s.lscale, bias_lo, bias_hi, lv, min(64, p.S - q0), lane);
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
          if (lane == 0) mbar_arrive(empty + 8 * cur);
          kq_start(dpt, opaque(vt), next_q + TILE_BYTES, full_do + 8 * stage, phase);
          wgmma_wait<0>();
          fence_regs(dpt);
          grads_cols(dpt, st, s, rv, lane);
        }
        pack_weights(pa, st);
        pack_weights(da, dpt);
        dkdv_start(dv, pa, dk, da, stage0 + stage * R::STAGE_BYTES);
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        if (lane == 0) mbar_arrive(empty + 8 * stage);
        ring_advance<STAGES>(stage, phase);
      }
      if (lane == 0) mbar_arrive(empty_kv);  // this head's K/V are done with

      bf16 *dkp, *dvp;
      long long dkst, dvst;
      float vscale = 1.f;
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
        vscale = sg.scale;
      }
      store_rows(dkp + kw * dkst, dkst, dk, 1.f, 1.f, row, n_keys, lane);
      store_rows(dvp + kw * dvst, dvst, dv, vscale, vscale, row, n_keys, lane);
    }
  }
}

template <typename K>
cudaError_t configure(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  p.hg = 1;
  p.scale2 = scale2;
  p.scale = scale;
  int n_tiles = G * ((S_kv + BLOCK_ROWS - 1) / BLOCK_ROWS);
  for (int i = 0; i < MAX_SEG; ++i) {
    p.seg[i] = i < nseg ? segs[i] : SegB{};
    if (i < nseg) {
      if (segs[i].t < 1) return (int)cudaErrorInvalidValue;
      n_tiles += (segs[i].t + BLOCK_ROWS - 1) / BLOCK_ROWS;
    }
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t e = configure(dq_kernel, SMEM_A);
    if (e == cudaSuccess) e = configure(dkdv_kernel, SMEM_B);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dq_kernel<<<dim3((S + BLOCK_ROWS - 1) / BLOCK_ROWS, H / p.hg, G * B), R::THREADS, SMEM_A, st>>>(
      p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_kernel<<<dim3(n_tiles, H / p.hg, B), R::THREADS, SMEM_B, st>>>(p);
  return (int)cudaGetLastError();
}
