// The shared Hopper core of the residual-unit kernels (sm_90a): K2
// (res_chain.cu) and K2v-cl (res_chain_variants.cu) are built on it, and
// conv_core_check.cu holds it against torch.matmul on one bare tile. It
// includes attention_core.cuh and reuses its mbarrier, fence, wgmma
// descriptor/commit/wait and m64n64 wrappers; what is new here is what a
// causal dilated convolution needs:
//
//   * the strip layout. An operand of R rows and K channels (bf16) is kept as
//     K / 8 strips, each R rows x 16 bytes (8 channels) with consecutive rows
//     16 bytes apart: element (r, k) lies at (k / 8) * R * 16 + r * 16 +
//     (k % 8) * 2. That is wgmma's no-swizzle ("interleave") K-major layout
//     with the 8-row core matrices 128 bytes apart (SBO) and the K-adjacent
//     ones R * 16 bytes apart (LBO), and a row offset s is just s * 16 bytes
//     on the start address. So a tap of a dilated causal conv, which reads
//     the window s = j * d rows further down, is a shifted descriptor of the
//     one staged window: any s, no copy, no swizzle phase to keep (a
//     128-byte-swizzled tile repeats every 8 rows, so an offset that is no
//     multiple of 8 would need the descriptor's base-offset field). A core
//     matrix is 128 contiguous bytes at any 16-byte aligned start, so the
//     reads are free of bank conflicts; R odd keeps the threads that fill a
//     window row by row (eight 16-byte stores to eight strips) off each
//     other's banks too;
//   * m64nNk16 products with both operands in shared memory for N = 48, 64,
//     96, 128 and 192, chosen by the accumulator's size (N / 2 floats);
//   * weights as pre-packed strip tiles, one contiguous block each, copied
//     by one thread with cp.async.bulk (no tensor map) and completed on the
//     stage's mbarrier by its byte count; a ring of such stages that a
//     product walks (ring_product), releasing each stage once the products
//     that read it have retired;
//   * the window fill: rows of a channels-last (T, C) bf16 input, zero
//     outside [0, T), through an elementwise function of 8 channels at a
//     time (snake1), into a strip window;
//   * snake v + sin^2(a v) / (a + 1e-9), sin^2 by the Pallas kernels'
//     range-reduced degree-6 polynomial (_sin2), in fp32;
//   * where an m64nN accumulator element lies (frag_row, frag_col), and a
//     bf16 pair store into a strip tile.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace conv_core {

using namespace attn_core;

constexpr int CORE_ROW = 16;  // bytes a strip row takes (8 bf16 channels)

// -------------------------------------------------------------- strip layout

// descriptor of a K-major strip operand at `addr` (16-byte aligned) whose
// strips are `strip_bytes` apart: no swizzle (layout type 0), LBO = the
// strip stride (K direction), SBO = 128 (the next 8 rows)
__device__ __forceinline__ uint64_t strip_desc(uint32_t addr, uint32_t strip_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(strip_bytes >> 4) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

// byte offset of (row, channel) in a strip tile of `rows` rows
__device__ __forceinline__ uint32_t strip_off(int rows, int row, int ch) {
  return static_cast<uint32_t>((ch >> 3) * rows * CORE_ROW + row * CORE_ROW + (ch & 7) * 2);
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// ------------------------------------------------------------ wgmma, N / 2 floats

// d (64 x 64) (+)= A (64 x 16) . B (16 x 64), both K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  wgmma_m64n64k16_ss<0>(d, da, db, accumulate);
}

// d (64 x 48) (+)= A (64 x 16) . B (16 x 48), both K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[24], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : ATTN_F8(d, 0), ATTN_F8(d, 8), ATTN_F8(d, 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 96) (+)= A (64 x 16) . B (16 x 96), both K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[48], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : ATTN_F8(d, 0), ATTN_F8(d, 8), ATTN_F8(d, 16), ATTN_F8(d, 24), ATTN_F8(d, 32), ATTN_F8(d, 40)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) (+)= A (64 x 16) . B (16 x 128), both K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ATTN_F8(d, 0), ATTN_F8(d, 8), ATTN_F8(d, 16), ATTN_F8(d, 24), ATTN_F8(d, 32), ATTN_F8(d, 40), ATTN_F8(d, 48), ATTN_F8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 192) (+)= A (64 x 16) . B (16 x 192), both K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[96], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : ATTN_F8(d, 0), ATTN_F8(d, 8), ATTN_F8(d, 16), ATTN_F8(d, 24), ATTN_F8(d, 32), ATTN_F8(d, 40), ATTN_F8(d, 48), ATTN_F8(d, 56), ATTN_F8(d, 64), ATTN_F8(d, 72), ATTN_F8(d, 80), ATTN_F8(d, 88)
      : "l"(da), "l"(db), "r"(accumulate));
}

// ------------------------------------------------------- bulk copies, the ring

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes global -> shared, both 16-byte
// aligned, completed on `bar` by their count (mbar_expect_tx first)
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// v, hidden from the compiler: an address built from it inside a loop is
// not hoisted out of the loop (where it would hold registers throughout,
// the wgmma products' included)
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// barrier `id` (1..15) among the first `threads` threads of the block
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A weight ring: STAGES stages of STAGE_BYTES, then full[STAGES] (one
// arrival with the stage's bytes) and empty[STAGES] (one arrival a consumer
// warp) mbarriers.
template <int STAGES, int STAGE_BYTES>
struct WeightRing {
  static constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFFSET + 16 * STAGES;
};

// where a walk over the ring stands
struct RingPos {
  int stage;
  uint32_t phase;
};

template <int STAGES>
__device__ __forceinline__ void weight_ring_init(uint32_t bars, int consumer_warps) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(bars + 8 * s, 1);
    mbar_init(bars + 8 * (STAGES + s), consumer_warps);
  }
  mbar_init_fence();
}

// the producer's side: waits for the stage at `pos` to be free and starts
// the copy of `src` into it (one thread)
template <int STAGES, int STAGE_BYTES>
__device__ __forceinline__ void ring_fill(uint32_t ring, uint32_t bars, RingPos& pos,
                                          const void* src) {
  mbar_wait(bars + 8 * (STAGES + pos.stage), pos.phase ^ 1);
  mbar_expect_tx(bars + 8 * pos.stage, STAGE_BYTES);
  bulk_copy(ring + pos.stage * STAGE_BYTES, src, STAGE_BYTES, bars + 8 * pos.stage);
  ring_advance<STAGES>(pos.stage, pos.phase);
}

// acc (+)= the product over `n_items` ring stages: item `it` is KC / 16 k16
// slices whose A descriptors a_desc(it, kk) gives; B is the stage, a (KC x NB)
// strip tile, from column b_col on. With `fresh` acc starts from zero (the
// first product does not accumulate), else it adds to acc. One commit group
// an item, one group in flight while
// the next is issued; a stage is released (one arrival a warp) once the
// products that read it have retired. Every consumer warp of the block walks
// every item.
template <int KC, int NB, int STAGES, int STAGE_BYTES, int NA, class ADesc>
__device__ __forceinline__ void ring_product(float (&acc)[NA], int n_items, ADesc a_desc,
                                             uint32_t ring, uint32_t bars, int b_col,
                                             RingPos& pos, int lane, bool fresh = true) {
  int prev = 0;
  fence_regs(acc);
  for (int it = 0; it < n_items; ++it) {
    mbar_wait(bars + 8 * pos.stage, pos.phase);
    const uint32_t b = ring + pos.stage * STAGE_BYTES + b_col * CORE_ROW;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      mma_ss(acc, a_desc(it, kk), strip_desc(b + 2 * kk * NB * CORE_ROW, NB * CORE_ROW),
             (it | kk) != 0 || !fresh);
    wgmma_commit();
    wgmma_wait<1>();
    if (it > 0 && lane == 0) mbar_arrive(bars + 8 * (STAGES + prev));
    prev = pos.stage;
    ring_advance<STAGES>(pos.stage, pos.phase);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (n_items > 0 && lane == 0) mbar_arrive(bars + 8 * (STAGES + prev));
}

// --------------------------------------------------------------- elementwise

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

// v + sin^2(a v) / (a + 1e-9), inv = 1 / (a + 1e-9)
__device__ __forceinline__ float snake(float v, float a, float inv) {
  return v + inv * sin2_poly(a * v);
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  return u;
}

// Rows t_first .. t_first + n_rows - 1 of x (T rows of C bf16 channels, row
// stride C) as the strip window at `win` (win_rows rows): rows outside
// [0, T) are zero (the causal pad), the others go through f(v, c0), which
// maps the 8 channels c0 .. c0 + 7 of one row in place. `nt` threads, this
// one `tid`. Each thread has FILL_LOADS 16-byte loads in flight before it
// computes: a window comes from device memory, and one load at a time per
// thread leaves most of its bandwidth unused. x may have been written by
// this kernel (the loads are coherent).
constexpr int FILL_LOADS = 4;

template <int C, class F>
__device__ __forceinline__ void fill_window(uint32_t win, int win_rows, const bf16* x, int T,
                                            int t_first, int n_rows, F f, int tid, int nt) {
  constexpr int V = C / 8;
  const int n = n_rows * V;
  for (int i0 = tid; i0 < n; i0 += FILL_LOADS * nt) {
    uint4 raw[FILL_LOADS];
#pragma unroll
    for (int u = 0; u < FILL_LOADS; ++u) {
      const int i = i0 + u * nt, r = i / V, t = t_first + r;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (i < n && t >= 0 && t < T)
        raw[u] = *reinterpret_cast<const uint4*>(x + static_cast<long long>(t) * C +
                                                 8 * (i - r * V));
    }
#pragma unroll
    for (int u = 0; u < FILL_LOADS; ++u) {
      const int i = i0 + u * nt, r = i / V, c8 = i - r * V, t = t_first + r;
      if (i < n) {
        uint4 v4 = raw[u];
        if (t >= 0 && t < T) {
          float v[8];
          unpack8(raw[u], v);
          f(v, 8 * c8);
          v4 = pack8(v);
        }
        st_shared_v4(win + c8 * win_rows * CORE_ROW + r * CORE_ROW, v4);
      }
    }
  }
}

// ------------------------------------------------- accumulator element places

// accumulator element 4 j + e of an m64nN tile of one warpgroup lies in row
// frag_row (of the 64) and column frag_col (of the N)
__device__ __forceinline__ int frag_row(int warp, int lane, int e) {
  return 16 * warp + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int lane, int j, int e) {
  return 8 * j + 2 * (lane & 3) + (e & 1);
}

}  // namespace conv_core
