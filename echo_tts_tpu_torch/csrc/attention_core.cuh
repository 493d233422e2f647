// The shared Hopper core of the attention kernels (sm_90a): thin device
// wrappers and tile helpers that know nothing of any one kernel's parameters.
//
//   * mbarrier: init, arrive, parity wait, the fences around them;
//   * cp.async: 16-byte copies with zero fill by a group of loader threads
//     (a producer warpgroup), completion reported to an mbarrier
//     (cp.async.mbarrier.arrive.noinc), so a copy needs no tensor map and
//     takes any 16-byte aligned row stride;
//   * the 128-byte swizzle: a (rows x 64) bf16 tile has 128-byte rows and the
//     16-byte chunk c of row r lies at chunk position c ^ (r % 8); tiles start
//     on 1024-byte boundaries;
//   * wgmma: shared-memory matrix descriptors for that layout, fence / commit /
//     wait, m64n64k16 with A from shared memory or from registers (B K-major
//     or MN-major through the transpose flag) and m64n128k16 with A from
//     registers and B MN-major, bf16 in and fp32 out;
//   * the geometry of a block's K/V ring (Ring) and a walk over it (Walk);
//   * register-fragment helpers: where a thread's accumulator elements lie,
//     row max / sum across the four threads that share a row, a per-tile
//     vector (bias, mask) loaded once per warp and handed out by shuffles,
//     accumulator -> bf16 A-fragment conversion, the output store.
//
// Layouts. A (64 x N) fp32 accumulator of one warpgroup: thread t (warp w =
// t / 32 of the group, lane l) holds d[4 j + e], j < N / 8: row 16 w + l / 4
// + 8 (e / 2), column 8 j + 2 (l % 4) + (e % 2). The bf16 A fragment of a
// k16 slice kk of a (64 x 64) tile is the four registers pack(d[8 kk + 0],
// d[8 kk + 1]), pack(d[8 kk + 2], d[8 kk + 3]), pack(d[8 kk + 4], d[8 kk +
// 5]), pack(d[8 kk + 6], d[8 kk + 7]): the accumulator of S = Q.K^T becomes
// the A operand of P.V with no shuffle.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_core {

typedef __nv_bfloat16 bf16;

constexpr int WG_THREADS = 128;       // one warpgroup
constexpr int TILE_KEYS = 64;         // keys per K/V tile
constexpr int HEAD_D = 128;           // head width
constexpr int TILE_BYTES = TILE_KEYS * HEAD_D * 2;  // one K or V tile
constexpr int HALF_TILE_BYTES = TILE_BYTES / 2;     // one 64-column half of it

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// after the inits, before any thread uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// returns once the barrier's phase of this parity has completed. A wait of
// more than ~2^32 cycles (seconds) is a lost arrival: trap, so that a fault
// in a pipeline shows as an error and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

// orders shared-memory writes of the generic proxy (st.shared, cp.async)
// before reads of the async proxy (wgmma operands)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- cp.async

// 16 bytes global -> shared; the first src_bytes (0..16) are read, the rest
// of the 16 are zero. Both addresses are 16-byte aligned.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread started so far has
// landed; the arrival is part of the barrier's initial count
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------- swizzled tiles in flight

// byte offset of the 16-byte chunk `c` (0..7) of row `r` in a 128-byte-row tile
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// A (ROWS x 128) bf16 tile from global rows `stride` elements apart, by NT
// loader threads (tid 0..NT-1, NT a multiple of 16): two (ROWS x 64)
// swizzled halves, the second ROWS * 128 bytes after the first. Rows >= n are
// zero. The caller reports completion with cp_async_arrive.
template <int ROWS, int NT>
__device__ __forceinline__ void load_rows_async(uint32_t dst, const bf16* src, long long stride,
                                                int n, int tid) {
  // a thread keeps its 16-byte column c and walks down the rows, NT / 16
  // apart: one pointer and one step, so a producer needs few registers
  const int c = tid & 15;
  const uint32_t d = dst + (c >> 3) * (ROWS * 128);
  const long long step = (NT / 16) * stride;
  const bf16* s = src + (tid >> 4) * stride + c * 8;
#pragma unroll 2
  for (int r = tid >> 4; r < ROWS; r += NT / 16, s += step) {
    const bool live = r < n;
    cp_async_16(d + swz128(r, c & 7), live ? s : src, live ? 16 : 0);
  }
}

// A (128 x 64) tile of transposed keys: row d, columns [0, n) of a (128, T)
// array whose rows are `stride` elements apart; columns >= n are zero. One
// swizzled (128 x 64) tile. With `vec` (stride a multiple of 8 elements, src
// 16-byte aligned) the copies are asynchronous; otherwise the threads load
// element by element and store synchronously. Completion: tile_arrive(bar, vec).
template <int NT>
__device__ __forceinline__ void load_cols(uint32_t dst, const bf16* src, long long stride, int n,
                                          int tid, bool vec) {
  const int c = tid & 7;  // this thread's 8-key chunk, in every row it copies
  const int valid = min(max(n - 8 * c, 0), 8);
  const long long step = (NT / 8) * stride;
  const bf16* s = src + (tid >> 3) * stride + 8 * c;
#pragma unroll 2
  for (int d = tid >> 3; d < HEAD_D; d += NT / 8, s += step) {
    const uint32_t a = dst + swz128(d, c);
    if (vec) {
      cp_async_16(a, valid ? s : src, 2 * valid);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const unsigned short lo = 2 * x < valid ? __bfloat16_as_ushort(s[2 * x]) : 0;
        const unsigned short hi = 2 * x + 1 < valid ? __bfloat16_as_ushort(s[2 * x + 1]) : 0;
        w[x] = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(w[0]), "r"(w[1]),
                   "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// this thread's arrival for a tile it helped to fill: asynchronous copies
// arrive when they land, synchronous stores arrive now
__device__ __forceinline__ void tile_arrive(uint32_t bar, bool async_copies) {
  if (async_copies) {
    cp_async_arrive(bar);
  } else {
    fence_proxy_async();
    mbar_arrive(bar);
  }
}

// ------------------------------------------------ the K/V ring of a block

// A block: NWG consumer warpgroups of 64 query rows each, then one producer
// warpgroup that fills a ring of STAGES stages (a 64-key K tile, then its V
// tile) and three mbarriers a stage (K full, V full, stage empty). NWG = 1
// leaves room for two blocks an SM, NWG = 2 shares each K/V tile between two
// consumer warpgroups.
template <int NWG>
struct Ring {
  static constexpr int STAGES = NWG == 1 ? 3 : 4;
  static constexpr int THREADS = (NWG + 1) * WG_THREADS;
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
  // setmaxnreg: 128 PRODUCER_REGS + NWG 128 CONSUMER_REGS = the registers at entry
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NWG == 1 ? 232 : 240;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
  // 1024 bytes of slack to align the tiles, then the barriers
  static constexpr int SMEM_BYTES = 1024 + BAR_OFFSET + 8 * 3 * STAGES;
};

// where a walk over the key sources' tiles stands: source, first key of the
// tile, and the ring stage and phase parity that hold it
struct Walk {
  int src, k0, stage;
  uint32_t phase;
};

// the barriers of a ring at `bars`: K full [STAGES], V full [STAGES] (one
// arrival a producer thread), stage empty [STAGES] (one arrival a consumer
// warp). One thread calls it; a __syncthreads follows.
template <int NWG>
__device__ __forceinline__ void ring_init(uint32_t bars) {
  constexpr int STAGES = Ring<NWG>::STAGES;
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(bars + 8 * s, WG_THREADS);
    mbar_init(bars + 8 * (STAGES + s), WG_THREADS);
    mbar_init(bars + 8 * (2 * STAGES + s), NWG * 4);
  }
  mbar_init_fence();
}

template <int STAGES>
__device__ __forceinline__ void ring_advance(int& stage, uint32_t& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// ------------------------------------------------------------------- wgmma

// shared-memory matrix descriptor, 128-byte swizzle. K-major operand: sbo =
// bytes between 8-row groups (1024), lbo unused. MN-major operand (transpose
// flag set): lbo = bytes between 64-element chunks along M/N, sbo = bytes
// between 8-row groups along K (1024).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across a
// wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ATTN_F8(d, o)                                                                  \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),      \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x 64) (+)= A (64 x 16, K-major, shared) . B (16 x 64, shared);
// TRANS_B = 0: B K-major (rows of B^T are contiguous in k), 1: MN-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : ATTN_F8(d, 0), ATTN_F8(d, 8), ATTN_F8(d, 16), ATTN_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// the same product with A as a bf16 fragment in registers
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : ATTN_F8(d, 0), ATTN_F8(d, 8), ATTN_F8(d, 16), ATTN_F8(d, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 128) += A (64 x 16, bf16 fragment in registers) . B (16 x 128,
// MN-major in shared memory: row k holds 128 contiguous columns)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ATTN_F8(d, 0), ATTN_F8(d, 8), ATTN_F8(d, 16), ATTN_F8(d, 24), ATTN_F8(d, 32),
        ATTN_F8(d, 40), ATTN_F8(d, 48), ATTN_F8(d, 56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// the descriptor of k16 slice kk of a key tile: a (64 x 128) two-half tile of
// keys (K_T = false, K-major), or a (128 x 64) tile of transposed keys (K_T =
// true, MN-major)
template <bool K_T>
__device__ __forceinline__ uint64_t key_desc(uint32_t k, int kk) {
  return K_T ? wgmma_desc(k + kk * 2048, TILE_BYTES, 1024)
             : wgmma_desc(k + (kk >> 2) * HALF_TILE_BYTES + (kk & 3) * 32, 16, 1024);
}

// s (64 x 64) = Q (64 x 128) . K^T for one warpgroup, Q from shared memory:
// the warpgroup's 64 rows in a two-half swizzled tile whose halves are q_half
// bytes apart. Asynchronous: wgmma_commit / wgmma_wait follow.
template <bool K_T>
__device__ __forceinline__ void qk_product_ss(float (&s)[32], uint32_t q, uint32_t q_half,
                                              uint32_t k) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HEAD_D / 16; ++kk)
    wgmma_m64n64k16_ss<K_T ? 1 : 0>(
        s, wgmma_desc(q + (kk >> 2) * q_half + (kk & 3) * 32, 16, 1024), key_desc<K_T>(k, kk),
        kk > 0);
}

// the same with Q as A fragments in registers (qf[4 kk + i], from
// load_q_frags): no shared-memory traffic for Q. Asynchronous.
template <bool K_T>
__device__ __forceinline__ void qk_product(float (&s)[32], const uint32_t (&qf)[32],
                                           uint32_t k) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HEAD_D / 16; ++kk)
    wgmma_m64n64k16_rs<K_T ? 1 : 0>(s, qf[4 * kk], qf[4 * kk + 1], qf[4 * kk + 2],
                                    qf[4 * kk + 3], key_desc<K_T>(k, kk), kk > 0);
}

// o (64 x 128) += P (64 x 64, bf16 A fragments pa[4 kk + i]) . V, v a
// (64 x 128) two-half tile of values. Asynchronous.
__device__ __forceinline__ void pv_product(float (&o)[64], uint32_t (&pa)[16], uint32_t v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TILE_KEYS / 16; ++kk)
    wgmma_m64n128k16_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                        wgmma_desc(v + kk * 2048, HALF_TILE_BYTES, 1024));
}

// waits for the V tile behind `full_v` and starts o += P.V on it (pa and o
// may have been written just before). Asynchronous: wgmma_wait follows.
__device__ __forceinline__ void pv_start(float (&o)[64], uint32_t (&pa)[16], uint32_t v,
                                         uint32_t full_v, uint32_t phase) {
  mbar_wait(full_v, phase);
  fence_proxy_async();
  fence_regs(pa);
  fence_regs(o);
  pv_product(o, pa, v);
  wgmma_commit();
}

// waits for the key tile behind `full_k` and starts s = Q.K^T on it
template <bool K_T>
__device__ __forceinline__ void qk_start(float (&s)[32], const uint32_t (&qf)[32], uint32_t k,
                                         uint32_t full_k, uint32_t phase) {
  mbar_wait(full_k, phase);
  fence_proxy_async();
  qk_product<K_T>(s, qf, k);
  wgmma_commit();
}

// ------------------------------------------------- register-fragment helpers

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the largest score of each of a thread's two rows (lo: elements 4 j + {0, 1},
// hi: 4 j + {2, 3}), over the four threads of the row; two chains a row, so
// that the few warps of an SM do not wait on one long dependent chain
__device__ __forceinline__ void row_max(const float (&sc)[32], float& mx_lo, float& mx_hi) {
  float a_lo = fmaxf(sc[0], sc[1]), b_lo = fmaxf(sc[4], sc[5]);
  float a_hi = fmaxf(sc[2], sc[3]), b_hi = fmaxf(sc[6], sc[7]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    a_lo = fmaxf(a_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
    b_lo = fmaxf(b_lo, fmaxf(sc[4 * j + 4], sc[4 * j + 5]));
    a_hi = fmaxf(a_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    b_hi = fmaxf(b_hi, fmaxf(sc[4 * j + 6], sc[4 * j + 7]));
  }
  mx_lo = quad_max(fmaxf(a_lo, b_lo));
  mx_hi = quad_max(fmaxf(a_hi, b_hi));
}

// this thread's share of the two rows' sums, again on two chains a row
__device__ __forceinline__ void row_sum(const float (&sc)[32], float& sum_lo, float& sum_hi) {
  float a_lo = sc[0] + sc[1], b_lo = sc[4] + sc[5];
  float a_hi = sc[2] + sc[3], b_hi = sc[6] + sc[7];
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    a_lo += sc[4 * j] + sc[4 * j + 1];
    b_lo += sc[4 * j + 4] + sc[4 * j + 5];
    a_hi += sc[4 * j + 2] + sc[4 * j + 3];
    b_hi += sc[4 * j + 6] + sc[4 * j + 7];
  }
  sum_lo = a_lo + b_lo;
  sum_hi = a_hi + b_hi;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp2((x - m) * k) as one multiply-add and one ex2: k = 1 for logits in base
// 2, log2(e) for logits in base e; km = m * k
__device__ __forceinline__ float exp2_scaled(float x, float k, float km) {
  return fast_exp2(fmaf(x, k, -km));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the weights in a score accumulator as the bf16 A fragments of P.V
__device__ __forceinline__ void pack_weights(uint32_t (&pa)[16], const float (&sc)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

// the output accumulator's two rows scaled after a new running maximum;
// skipped while no row of the warp moved (every lane of the warp calls it)
__device__ __forceinline__ void rescale_rows(float (&o)[64], float corr_lo, float corr_hi) {
  if (__any_sync(0xffffffffu, corr_lo != 1.f || corr_hi != 1.f)) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[4 * j] *= corr_lo;
      o[4 * j + 1] *= corr_lo;
      o[4 * j + 2] *= corr_hi;
      o[4 * j + 3] *= corr_hi;
    }
  }
}

// A per-tile vector of 64 values (a bias or a mask row): each lane holds
// elements `lane` and `lane + 32`; the value of accumulator column 8 j + 2
// (lane % 4) + e comes by one shuffle. Every lane of the warp calls it.
__device__ __forceinline__ float tile_vec_at(float v_lo, float v_hi, int j, int e, int lane) {
  return __shfl_sync(0xffffffffu, j < 4 ? v_lo : v_hi, (8 * (j & 3) + 2 * (lane & 3) + e) & 31);
}

// One warpgroup's 64 x 128 bf16 rows (`stride` elements apart in global
// memory) as the A fragments of the eight k16 slices, qf[4 kk + i]; rows >=
// n_rows are zero. `row` = 16 * warp + lane / 4. Rows are 4-byte aligned.
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[32], const bf16* q, long long stride,
                                             int n_rows, int row, int lane) {
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(q + row * stride) + (lane & 3);
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(q + (row + 8) * stride) + (lane & 3);
#pragma unroll
  for (int kk = 0; kk < HEAD_D / 16; ++kk) {
    qf[4 * kk] = row < n_rows ? lo[8 * kk] : 0u;
    qf[4 * kk + 1] = row + 8 < n_rows ? hi[8 * kk] : 0u;
    qf[4 * kk + 2] = row < n_rows ? lo[8 * kk + 4] : 0u;
    qf[4 * kk + 3] = row + 8 < n_rows ? hi[8 * kk + 4] : 0u;
  }
}

// the (64 x 128) accumulator of one warpgroup, rows scaled by inv_lo (row
// `row`) and inv_hi (row `row + 8`), as bf16 to out rows `stride` elements
// apart; rows >= n_rows are not written. `row` = 16 * warp + lane / 4.
__device__ __forceinline__ void store_rows(bf16* out, long long stride, const float (&o)[64],
                                           float inv_lo, float inv_hi, int row, int n_rows,
                                           int lane) {
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < HEAD_D / 8; ++j) {
    if (row < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + row * stride + 8 * j + c0) =
          __floats2bfloat162_rn(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    if (row + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * stride + 8 * j + c0) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
  }
}

// register rebalancing between the producer and the consumer warpgroups
template <int REGS>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

}  // namespace attn_core
