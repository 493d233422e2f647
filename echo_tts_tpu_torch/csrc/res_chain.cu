// Kernel K2: one causal residual unit of the S1-DAC conv stacks in one
// launch, sm_90a, channels-last (B, T, C) bf16, on conv_core.cuh.
//
// Replaces echo_tts_tpu/ops/pallas_conv.py:_res_chain_kernel (called from
// fused_res_chain_cl / res_units_cl). A unit is
//     y = bf16(snake1(x))
//     acc = b7 + sum_j shift_{(6-j) d}(y) . W7[j]            (fp32)
//     z = bf16(snake2(acc))
//     out = bf16(x + z . W1 + b1), rows t < zero_below[b] set to 0,
// snake(v) = v + sin^2(a v)/(a + 1e-9) in fp32 with the Pallas kernel's
// sin^2 polynomial, y zero before row 0 (the causal pad: snake(0) = 0). These
// are the Pallas kernel's rounding points. A chain is one launch a unit.
//
// Bound. 16 T C^2 FLOPs a unit (seven conv7 taps and the 1x1) over one read
// of x and one write of out, 2 T C bf16 each: 4 C FLOP per byte, 256..3072
// at C = 64..768. From C = 96 on that is above the card's ~295 FLOP/byte
// ridge: tensor-core operations bound the unit.
//
// Design. A persistent block walks tiles of BM time rows. Two consumer
// warpgroups and a producer (a warpgroup whose registers go to the
// consumers through setmaxnreg; a single warp at C = 64, where two blocks
// share an SM):
//   * the consumers stage the tile's window, rows t0 - 6d .. t0 + BM - 1 of
//     snake1(x) over all C channels, in the strip layout: snake1 runs once
//     per (row, channel) and tile, and each of the seven taps reads the same
//     window through a descriptor moved down j d rows (any d, no copy);
//   * the conv7 weights stream from L2 through a ring of (KC x NB) strip
//     tiles, pre-packed by the wrapper and copied by one producer thread
//     with cp.async.bulk; both consumer warpgroups read every tile, so a
//     pass over the weights serves BM = 128 rows (BM = 64 at C >= 384, where
//     the window takes the shared memory: there the two warpgroups split the
//     columns instead of the rows);
//   * the products are wgmma m64nNk16 with both operands in shared memory
//     and fp32 accumulators in registers; snake2 runs on the accumulator and
//     z goes as bf16 into a strip tile in shared memory, the A operand of the
//     1x1 product, whose epilogue adds bias and residual and re-zeroes the
//     rows below zero_below; the residual rows come in (from L2, where the
//     window fill left them) and the out tile leaves as 16-byte rows through
//     a strip tile in the window's place. x goes through device memory twice
//     a unit (in, out) instead of five times (x, scratch y out and in, x,
//     out);
//   * at C = 768 window and z do not fit together: z goes to a (B, T, C)
//     scratch in device memory (31.5 MB at T = 20,480) and comes back into
//     the window's place for the 1x1: still one launch;
//   * the consumer body sits under the tile loop, the shape in which the
//     assembler keeps wgmma asynchronous (no C7512/C7514), and the
//     epilogues' addresses are made opaque inside it (hoisted out of the
//     loop they held registers through the products: spills, and C7512).
// Per width (rows BM, columns a pass NB, weight tile KC x NB, ring stages,
// blocks an SM), each the fastest of the tilings timed on an H100:
//   C  64: 128,  64, 64 x  64, 4, 2     C 256: 128, 128, 64 x 128, 3, 1
//   C  96: 128,  96, 96 x  96, 4, 1     C 384:  64, 384, 32 x 384, 3, 1
//   C 128: 128, 128, 64 x 128, 4, 1     C 512:  64, 256, 16 x 256, 4, 1
//   C 192: 128, 192, 64 x 192, 3, 1     C 768:  64, 256, 16 x 256, 5, 1 (z in device memory)
// What holds it back (PERF.md): at BM = 64 a tile reads 64 FLOP per byte of
// weights from L2; at C <= 128 the window fill and the snakes on the CUDA
// cores run between the products, not under them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "conv_core.cuh"

using namespace conv_core;

namespace {

constexpr int SMEM_LIMIT = 232448;

struct UnitParams {
  const bf16* x;
  bf16* out;
  bf16* z;          // (B, T, C) scratch at C = 768, else null
  const bf16* w7;   // strip tiles [pass][tap][k chunk]
  const bf16* w1;   // strip tiles [pass][k chunk]
  const float* b7;  // (C,) each
  const float* a1;
  const float* inv1;
  const float* a2;
  const float* inv2;
  const float* b1;
  const int* zero_below;  // (B,) or null
  int T, d, tiles_per_b, n_tiles;
};

template <int C_, int WG_M_, int NCH_, int KC_, int STAGES_, bool Z_GLOBAL_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int C = C_, WG_M = WG_M_, WG_N = 2 / WG_M_, NCH = NCH_, KC = KC_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr bool Z_GLOBAL = Z_GLOBAL_;
  static constexpr int BM = 64 * WG_M;       // rows a tile
  static constexpr int NB = NCH * WG_N;      // columns a pass
  static constexpr int PASSES = C / NB;
  static constexpr int KCH = C / KC;         // k chunks of one tap
  static constexpr int STAGE_BYTES = KC * NB * 2;
  static constexpr int ZR = BM + 1;          // rows of the z strip tile (odd)
  // one block an SM: a producer warpgroup that gives its registers to the
  // consumers (setmaxnreg: 128 x 24 + 256 x 240 = the 168 a thread the block
  // has at entry); two: a producer warp, and no rebalancing (112 a thread)
  static constexpr bool REBALANCE = MIN_BLOCKS == 1;
  static constexpr int THREADS = 2 * WG_THREADS + (REBALANCE ? WG_THREADS : 32);
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static_assert(C % NB == 0 && C % KC == 0 && KC % 16 == 0 && NCH % 8 == 0, "tiling");
  using Ring = WeightRing<STAGES, STAGE_BYTES>;
  static int win_rows(int d) { return (BM + 6 * d) | 1; }
  static int smem_bytes(int d) {
    return 128 + Ring::BYTES + win_rows(d) * C * 2 + (Z_GLOBAL ? 0 : ZR * C * 2);
  }
};

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

template <class K>
__global__ void __launch_bounds__(K::THREADS, K::MIN_BLOCKS)
res_unit_kernel(const __grid_constant__ UnitParams p) {
  constexpr int C = K::C, BM = K::BM, NCH = K::NCH, NB = K::NB, KC = K::KC, KCH = K::KCH;
  constexpr int PASSES = K::PASSES, STAGES = K::STAGES, SB = K::STAGE_BYTES, ZR = K::ZR;
  constexpr int XR = BM + 1;  // rows of the residual/out strip tile (odd)
  constexpr int CONSUMERS = 2 * WG_THREADS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 127u) & ~127u;
  const uint32_t bars = ring + K::Ring::BAR_OFFSET;
  const uint32_t win = ring + K::Ring::BYTES;
  const int d = p.d;
  const int wr = (BM + 6 * d) | 1;
  const uint32_t zs = K::Z_GLOBAL ? win : win + wr * C * 2;
  if (threadIdx.x == 0) weight_ring_init<STAGES>(bars, CONSUMERS / 32);
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    if (K::REBALANCE) reg_dealloc<K::PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG_THREADS) {
      RingPos pos = {0, 0u};
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        for (int it = 0; it < PASSES * 7 * KCH; ++it)
          ring_fill<STAGES, SB>(ring, bars, pos, p.w7 + static_cast<long long>(it) * (SB / 2));
        for (int it = 0; it < PASSES * KCH; ++it)
          ring_fill<STAGES, SB>(ring, bars, pos, p.w1 + static_cast<long long>(it) * (SB / 2));
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  if (K::REBALANCE) reg_alloc<K::CONSUMER_REGS>();
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid / 32) % 4;
  const int wm = wg / K::WG_N, wn = wg % K::WG_N;
  const int r0 = 64 * wm;  // this warpgroup's rows of a tile
  RingPos pos = {0, 0u};
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int b = tile / p.tiles_per_b;
    const int t0 = (tile - b * p.tiles_per_b) * BM;
    const long long xb = static_cast<long long>(b) * p.T * C;
    named_sync(1, CONSUMERS);  // the last tile's window and z are read
    fill_window<C>(
        win, wr, p.x + xb, p.T, t0 - 6 * d, BM + 6 * d,
        [&](float (&v)[8], int c0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(p.a1 + c0) + h);
            const float4 iv = __ldg(reinterpret_cast<const float4*>(p.inv1 + c0) + h);
            v[4 * h] = snake(v[4 * h], a.x, iv.x);
            v[4 * h + 1] = snake(v[4 * h + 1], a.y, iv.y);
            v[4 * h + 2] = snake(v[4 * h + 2], a.z, iv.z);
            v[4 * h + 3] = snake(v[4 * h + 3], a.w, iv.w);
          }
        },
        tid, CONSUMERS);
    fence_proxy_async();
    named_sync(1, CONSUMERS);

    // conv7 and snake2, pass by pass over the output columns
    for (int pass = 0; pass < PASSES; ++pass) {
      float acc[NCH / 2];
      ring_product<KC, NB, STAGES, SB>(
          acc, 7 * KCH,
          [&](int it, int kk) {
            const int j = it / KCH;
            return strip_desc(win + strip_off(wr, r0 + j * d, (it - j * KCH) * KC + 16 * kk),
                              wr * CORE_ROW);
          },
          ring, bars, wn * NCH, pos, lane);
      // opaque: the epilogue's addresses are made here, not hoisted out of
      // the tile loop to hold registers through the products
      const int col0 = opaque(pass * NB + wn * NCH + frag_col(lane, 0, 0));
#pragma unroll
      for (int j = 0; j < NCH / 8; ++j) {
        const int col = col0 + 8 * j;
        const float2 bb = ldg2(p.b7 + col), aa = ldg2(p.a2 + col), iv = ldg2(p.inv2 + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + frag_row(warp, lane, 2 * h);
          const uint32_t zz = pack_bf16(snake(acc[4 * j + 2 * h] + bb.x, aa.x, iv.x),
                                        snake(acc[4 * j + 2 * h + 1] + bb.y, aa.y, iv.y));
          if (K::Z_GLOBAL) {
            if (t0 + row < p.T)
              *reinterpret_cast<uint32_t*>(p.z + xb + static_cast<long long>(t0 + row) * C +
                                           col) = zz;
          } else {
            st_shared_b32(zs + strip_off(ZR, row, col), zz);
          }
        }
      }
    }
    if (K::Z_GLOBAL) {
      named_sync(1, CONSUMERS);  // z written, the window no longer read
      fill_window<C>(zs, ZR, p.z + xb, p.T, t0, BM, [](float (&)[8], int) {}, tid, CONSUMERS);
    }
    fence_proxy_async();
    named_sync(1, CONSUMERS);  // z whole (both warpgroups' columns), the window read
    if (!K::Z_GLOBAL) {
      // the residual, rows t0 .. t0 + BM - 1 of x, read coalesced into the
      // window's place: the epilogue adds it there and the tile leaves in
      // 16-byte rows (C = 768 has no room: there the epilogue reads x and
      // writes out from and to device memory directly)
      fill_window<C>(win, XR, p.x + xb, p.T, t0, BM, [](float (&)[8], int) {}, tid, CONSUMERS);
      named_sync(1, CONSUMERS);
    }

    // 1x1, bias, residual, re-zero
    const int zb = p.zero_below != nullptr ? p.zero_below[b] : 0;
    for (int pass = 0; pass < PASSES; ++pass) {
      float acc[NCH / 2];
      ring_product<KC, NB, STAGES, SB>(
          acc, KCH,
          [&](int kc, int kk) {
            return strip_desc(zs + strip_off(ZR, r0, kc * KC + 16 * kk), ZR * CORE_ROW);
          },
          ring, bars, wn * NCH, pos, lane);
      const int col0 = opaque(pass * NB + wn * NCH + frag_col(lane, 0, 0));
#pragma unroll
      for (int j = 0; j < NCH / 8; ++j) {
        const int col = col0 + 8 * j;
        const float2 bb = ldg2(p.b1 + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + frag_row(warp, lane, 2 * h), t = t0 + row;
          const bool dead = t < zb;
          if (K::Z_GLOBAL) {
            if (t < p.T) {
              const long long off = xb + static_cast<long long>(t) * C + col;
              const float2 xr =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + off));
              *reinterpret_cast<uint32_t*>(p.out + off) =
                  pack_bf16(dead ? 0.f : xr.x + (acc[4 * j + 2 * h] + bb.x),
                            dead ? 0.f : xr.y + (acc[4 * j + 2 * h + 1] + bb.y));
            }
          } else {
            const uint32_t a = win + strip_off(XR, row, col);
            uint32_t xv = ld_shared_b32(a);
            const float2 xr = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&xv));
            st_shared_b32(a, pack_bf16(dead ? 0.f : xr.x + (acc[4 * j + 2 * h] + bb.x),
                                       dead ? 0.f : xr.y + (acc[4 * j + 2 * h + 1] + bb.y)));
          }
        }
      }
    }
    if (!K::Z_GLOBAL) {
      named_sync(1, CONSUMERS);  // the out tile is whole
      for (int i = tid; i < BM * (C / 8); i += CONSUMERS) {
        const int r = i / (C / 8), c0 = 8 * (i - r * (C / 8));
        if (t0 + r < p.T)
          *reinterpret_cast<uint4*>(p.out + xb + static_cast<long long>(t0 + r) * C + c0) =
              ld_shared_v4(win + strip_off(XR, r, c0));
      }
    }
  }
}

template <class K>
int launch(UnitParams p, int B, cudaStream_t s) {
  static bool configured = false;
  static int sms = 0;
  auto kernel = res_unit_kernel<K>;
  if (!configured) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    int dev;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    configured = true;
  }
  const int smem = K::smem_bytes(p.d);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K::THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  p.tiles_per_b = (p.T + K::BM - 1) / K::BM;
  p.n_tiles = B * p.tiles_per_b;
  const int grid = std::min(p.n_tiles, sms * std::max(per_sm, 1));
  kernel<<<grid, K::THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// the tiling of width C: k chunk, columns a pass, z in device memory
template <class K>
bool tiles_are(int kc, int nb, int z_scratch) {
  return kc == K::KC && nb == K::NB && (z_scratch != 0) == K::Z_GLOBAL;
}

}  // namespace

// x, out: (B, T, C) bf16 contiguous, 16-byte aligned; w7: the conv7 weights
// (7, C, C) as [tap][in][out] cut into (kc x nb) strip tiles in the order
// [pass][tap][k chunk], w1: the 1x1 weights (1, C, C) cut the same way
// (ops/conv_core.py:pack_tiles); b7, a1, inv1, a2, inv2, b1: (C,) fp32;
// zero_below: (B,) int32 or null; z: (B, T, C) bf16 scratch where the width
// takes it (z_scratch), else null. kc, nb and z_scratch must be the width's
// tiling (ops/res_chain.py:UNIT_TILES). C in {64, 96, 128, 192, 256, 384,
// 512, 768}.
extern "C" int res_unit_fwd(const void* x, const void* w7, const void* b7, const void* a1,
                            const void* inv1, const void* a2, const void* inv2, const void* w1,
                            const void* b1, const void* zero_below, void* z, void* out, int B,
                            int T, int C, int dilation, int kc, int nb, int z_scratch,
                            void* stream) {
  if (T < 1 || B < 1 || dilation < 1 || (z_scratch != 0) != (z != nullptr))
    return (int)cudaErrorInvalidValue;
  UnitParams p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.z = static_cast<bf16*>(z);
  p.w7 = static_cast<const bf16*>(w7);
  p.w1 = static_cast<const bf16*>(w1);
  p.b7 = static_cast<const float*>(b7);
  p.a1 = static_cast<const float*>(a1);
  p.inv1 = static_cast<const float*>(inv1);
  p.a2 = static_cast<const float*>(a2);
  p.inv2 = static_cast<const float*>(inv2);
  p.b1 = static_cast<const float*>(b1);
  p.zero_below = static_cast<const int*>(zero_below);
  p.T = T;
  p.d = dilation;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K2_TILING(c, ...)                                                  \
  if (C == c && tiles_are<Cfg<c, __VA_ARGS__>>(kc, nb, z_scratch))         \
    return launch<Cfg<c, __VA_ARGS__>>(p, B, s);
  K2_TILING(64, 2, 64, 64, 4, false, 2)
  K2_TILING(96, 2, 96, 96, 4, false, 1)
  K2_TILING(128, 2, 128, 64, 4, false, 1)
  K2_TILING(192, 2, 192, 64, 3, false, 1)
  K2_TILING(256, 2, 128, 64, 3, false, 1)
  K2_TILING(384, 1, 192, 32, 3, false, 1)
  K2_TILING(512, 1, 128, 16, 4, false, 1)
  K2_TILING(768, 1, 128, 16, 5, true, 1)
#undef K2_TILING
  return (int)cudaErrorInvalidValue;
}
