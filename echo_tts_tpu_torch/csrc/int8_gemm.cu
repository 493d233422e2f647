// Kernel K4: the int8 GEMM of the W8A8 trunk with its dequantize epilogue,
// sm_90a.
//
// Computes echo_tts_tpu/models/quant.py:qdot, an int8 x int8 -> int32
// dot_general that XLA fuses with the dequantize (the JAX package has no
// Pallas kernel here):
//   out[m, n] = out_t(float(sum_k a[m, k] w[n, k]) * (s_row[m] * s_col[n]))
// a (M, K) int8 activation rows, w (N, K) int8 weight stored K-major (the
// port's quantized leaf), s_row (M,) and s_col (N,) fp32; out bf16, fp32,
// or the raw int32 sums. The sums are exact and the scale product is taken
// before the multiply, as JAX does, so the result equals the plain version
// bit for bit. One launch takes up to four weights that share the
// activation (q/k/v/gate, w1/w3, a context's k/v): each keeps its own
// scales and output, and the launch walks the column tiles of all of them.
//
// Bound. 2·M·N·K operations at 1979 TOP/s (int8, dense) against M·K + N·K
// bytes in, M·N·2 out: at the one-shot CFG forward's M = 1920 it is bound by
// operations (0.111 ms for the eight projections of a layer); at a stream
// block's M = 192 by the weight bytes (57 MB a layer, 0.017 ms at 3.35 TB/s).
//
// Design. A persistent grid (one block an SM, at most as many blocks as
// tiles) walks the output tiles, the row tile fastest so that the blocks in
// flight share weight tiles in L2. A block is two consumer warpgroups and
// one producer warpgroup, whose one thread keeps a ring of STAGES shared
// stages full by TMA: a stage is 128 bytes of K of the BM activation rows
// and of the BN weight rows, both as they lie (K-major, 128-byte swizzle),
// zero past M, N and K. Full and empty mbarriers pair each stage; the ring
// runs on across tiles, so the next tile's copies overlap this tile's
// epilogue. Each consumer warpgroup issues four wgmma m64nWNk32 s8 a stage
// (WN = BN, its own 64 rows, when BM = 128; BN / 2, its own half of the
// columns over the shared 64 rows, when BM = 64) with s32 accumulators in
// registers, keeps one stage's products in flight and releases the stage
// before. setmaxnreg gives the consumers 232 registers and the producer 40.
// The epilogue dequantizes from the accumulators (row and column scales from
// L1) into swizzled shared boxes that TMA stores while the warpgroup goes on
// (outputs whose rows are not 16-byte aligned are copied out by the threads
// instead); the stores are clipped at ragged M and N. Tile shapes (BM, BN):
// code 0 (128, 256), 1 (128, 128), 2 (64, 256), 3 (64, 128); the launch
// picks one from M (`pick_tile`), or takes the caller's.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>
#include <type_traits>

#include "int8_core.cuh"

using namespace attn_core;
using namespace int8_core;

namespace {

constexpr int MAX_GROUPS = 4;  // weights a launch
constexpr int BK = 128;        // bytes of K a stage: one swizzle row
constexpr int THREADS = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// The epilogue of a consumer warpgroup's 64 rows goes through its own 16 KB
// of shared memory. By TMA (rows of the output 16-byte aligned): two
// 128-byte-swizzled boxes of 64 rows x 128 bytes in turn, each stored by one
// thread while the next is written. Otherwise 32 columns at a time (rows
// 144 bytes apart: a warp's writes fall on 32 banks), copied out 16 bytes a
// thread.
constexpr int EPI_BOX = 64 * 128, EPI_BYTES = 2 * EPI_BOX;
constexpr int EPI_COLS = 32, EPI_PITCH = EPI_COLS * 4 + 16;

struct Params {
  CUtensorMap a_map;              // (M, K) activation codes, boxes of BM x 128
  CUtensorMap w_map[MAX_GROUPS];  // (N_g, K) weight codes, boxes of BN x 128
  CUtensorMap out_map[MAX_GROUPS];  // (M, N_g) outputs, boxes of 64 x 128 bytes (TMA stores)
  const float* s_row;
  const float* s_col[MAX_GROUPS];
  void* out[MAX_GROUPS];
  int n[MAX_GROUPS];
  int tile0[MAX_GROUPS + 1];  // first column tile of each weight; tile0[groups]: all of them
  int groups, M, ktiles, mtiles, tiles;
};

template <int BM, int BN>
struct Tile {
  static constexpr int WN = BM == 128 ? BN : BN / 2;  // columns a consumer warpgroup
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = 196 * 1024 / STAGE_BYTES < 8 ? 196 * 1024 / STAGE_BYTES : 8;
  // 1024 bytes of slack to align the stages, the two epilogue buffers, then
  // full[STAGES], empty[STAGES]
  static constexpr int EPI_OFFSET = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFFSET = EPI_OFFSET + 2 * EPI_BYTES;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFFSET + 16 * STAGES;
  static_assert(SMEM_BYTES <= 232448, "more shared memory than a block has");
};

// a per-weight value by the weight's index, with constant indices only (a
// run-time index into a kernel parameter would copy it to local memory)
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[MAX_GROUPS], int g) {
  return g == 0 ? v[0] : g == 1 ? v[1] : g == 2 ? v[2] : v[3];
}

__device__ __forceinline__ const CUtensorMap* map_of(const CUtensorMap (&m)[MAX_GROUPS], int g) {
  return g == 0 ? &m[0] : g == 1 ? &m[1] : g == 2 ? &m[2] : &m[3];
}

// tile t: weight g, first row m0, first column n0 of that weight's output
template <int BM, int BN>
__device__ __forceinline__ void tile_at(const Params& p, int t, int& g, int& m0, int& n0) {
  const int nt = t / p.mtiles;
  g = 0;
#pragma unroll
  for (int i = 1; i < MAX_GROUPS; ++i)
    if (i < p.groups && nt >= p.tile0[i]) g = i;
  m0 = (t - nt * p.mtiles) * BM;
  n0 = (nt - (g == 0 ? 0 : g == 1 ? p.tile0[1] : g == 2 ? p.tile0[2] : p.tile0[3])) * BN;
}

template <int BM, int BN>
__device__ __forceinline__ void produce(const Params& p, uint32_t base, uint32_t bars) {
  using T = Tile<BM, BN>;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    int g, m0, n0;
    tile_at<BM, BN>(p, t, g, m0, n0);
    const CUtensorMap* wm = map_of(p.w_map, g);
    for (int kt = 0; kt < p.ktiles; ++kt) {
      mbar_wait(bars + 8 * (T::STAGES + stage), phase ^ 1);
      const uint32_t full = bars + 8 * stage, s = base + stage * T::STAGE_BYTES;
      mbar_expect_tx(full, T::STAGE_BYTES);
      tma_load_2d(s, &p.a_map, full, kt * BK, m0);
      tma_load_2d(s + T::A_BYTES, wm, full, kt * BK, n0);
      ring_advance<T::STAGES>(stage, phase);
    }
  }
}

__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// One consumer warpgroup's 64 x (R / 2 x 2) accumulators, dequantized (or
// raw), into weight g's output at rows m_wg.., columns n_wg..; masked at
// ragged M and N. Each pass of EPI_COLS columns: the threads write their
// values into the warpgroup's buffer `epi` in the accumulator layout, then
// copy the buffer out in 16-byte pieces (element by element where a piece
// crosses N or the rows are not 16-byte aligned). `bar` names the
// warpgroup's barrier.
template <int OUT, int R>
__device__ __forceinline__ void store_tile(const Params& p, int g, const int (&acc)[R], int m_wg,
                                           int n_wg, uint32_t epi, int bar) {
  using O = typename std::conditional<OUT == 0, __nv_bfloat16,
                                      typename std::conditional<OUT == 1, float, int>::type>::type;
  constexpr int ES = sizeof(O), PER = 16 / ES;  // bytes an element, elements a piece
  constexpr int PIECES = EPI_COLS * ES / 16;    // pieces a buffer row
  const int N = pick(p.n, g);
  const float* sc = pick(p.s_col, g);
  O* out = static_cast<O*>(pick(p.out, g));
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
  const bool vec = N % PER == 0;
  float sr[2] = {0.f, 0.f};
  if constexpr (OUT != 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (m_wg + r + 8 * h < p.M) sr[h] = __ldg(p.s_row + m_wg + r + 8 * h);
  }
#pragma unroll
  for (int pass = 0; pass < R / 4 / (EPI_COLS / 8); ++pass) {
#pragma unroll
    for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
      const int j = pass * (EPI_COLS / 8) + jj, n = n_wg + 8 * j + c;
      float s_c[2] = {0.f, 0.f};
      if constexpr (OUT != 2) {
        if (n < N) s_c[0] = __ldg(sc + n);
        if (n + 1 < N) s_c[1] = __ldg(sc + n + 1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bits[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = acc[4 * j + 2 * h + e];
          if constexpr (OUT == 2) {
            bits[e] = static_cast<uint32_t>(v);
          } else {
            const float x = __fmul_rn(__int2float_rn(v), __fmul_rn(sr[h], s_c[e]));
            bits[e] = OUT == 0 ? static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)))
                               : __float_as_uint(x);
          }
        }
        const uint32_t at = epi + (r + 8 * h) * EPI_PITCH + (8 * jj + c) * ES;
        if constexpr (ES == 2)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(bits[0] | (bits[1] << 16))
                       : "memory");
        else
          asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(at), "r"(bits[0]), "r"(bits[1])
                       : "memory");
      }
    }
    wg_sync(bar);
    for (int i = t; i < 64 * PIECES; i += 128) {
      const int rr = i / PIECES, m = m_wg + rr;
      const int n = n_wg + pass * EPI_COLS + (i % PIECES) * PER;
      if (m >= p.M || n >= N) continue;
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(epi + rr * EPI_PITCH + (i % PIECES) * 16));
      O* o = out + static_cast<size_t>(m) * N + n;
      if (vec && n + PER <= N) {
        *reinterpret_cast<uint4*>(o) = v;
      } else {
        const O* e = reinterpret_cast<const O*>(&v);
        for (int k = 0; k < PER && n + k < N; ++k) o[k] = e[k];
      }
    }
    wg_sync(bar);
  }
}

// The same through TMA stores: per box of 64 rows x 128 bytes (64 bf16 or
// 32 fp32/int32 columns), the threads write their values into one of the
// warpgroup's two swizzled boxes (`box` counts the boxes used so far), and
// thread 0 of the warpgroup stores it and goes on; before a box is written
// again, the store that last read it has finished reading.
template <int OUT, int R>
__device__ __forceinline__ void store_tile_tma(const Params& p, int g, const int (&acc)[R],
                                               int m_wg, int n_wg, uint32_t epi, int bar,
                                               int& box) {
  constexpr int ES = OUT == 0 ? 2 : 4, COLS = 128 / ES, JP = COLS / 8;  // j's a box
  const int N = pick(p.n, g);
  const float* sc = pick(p.s_col, g);
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
  float sr[2] = {0.f, 0.f};
  if constexpr (OUT != 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (m_wg + r + 8 * h < p.M) sr[h] = __ldg(p.s_row + m_wg + r + 8 * h);
  }
#pragma unroll
  for (int pass = 0; pass < R / 4 / JP; ++pass, ++box) {
    const uint32_t buf = epi + (box & 1) * EPI_BOX;
    if (t == 0) bulk_wait_read<1>();
    wg_sync(bar);
#pragma unroll
    for (int jj = 0; jj < JP; ++jj) {
      const int j = pass * JP + jj, n = n_wg + 8 * j + c;
      float s_c[2] = {0.f, 0.f};
      if constexpr (OUT != 2) {
        if (n < N) s_c[0] = __ldg(sc + n);
        if (n + 1 < N) s_c[1] = __ldg(sc + n + 1);
      }
      const int byte = (8 * jj + c) * ES;  // in the box's row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bits[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = acc[4 * j + 2 * h + e];
          if constexpr (OUT == 2) {
            bits[e] = static_cast<uint32_t>(v);
          } else {
            const float x = __fmul_rn(__int2float_rn(v), __fmul_rn(sr[h], s_c[e]));
            bits[e] = OUT == 0 ? static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)))
                               : __float_as_uint(x);
          }
        }
        const int rr = r + 8 * h;
        const uint32_t at = buf + rr * 128 + ((((byte >> 4) ^ rr) & 7) << 4) + (byte & 15);
        if constexpr (ES == 2)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(bits[0] | (bits[1] << 16))
                       : "memory");
        else
          asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(at), "r"(bits[0]), "r"(bits[1])
                       : "memory");
      }
    }
    fence_proxy_async();
    wg_sync(bar);
    if (t == 0) {
      tma_store_2d(map_of(p.out_map, g), buf, n_wg + pass * COLS, m_wg);
      bulk_commit();
    }
  }
}

template <int BM, int BN, int OUT, bool TMA_OUT>
__device__ __forceinline__ void consume(const Params& p, uint32_t base, uint32_t bars, int tid) {
  using T = Tile<BM, BN>;
  constexpr int WN = T::WN, R = WN / 2;
  const int wg = tid / 128, lane = tid % 32;
  const uint32_t a_off = BM == 128 ? wg * 64 * BK : 0;
  const uint32_t b_off = T::A_BYTES + (BM == 128 ? 0 : wg * WN * BK);
  const int row_off = BM == 128 ? wg * 64 : 0, col_off = BM == 128 ? 0 : wg * WN;
  const uint32_t epi = base + T::EPI_OFFSET + wg * EPI_BYTES;
  int stage = 0, box = 0;
  uint32_t phase = 0;
  // the whole body, from zeroing the accumulators to storing them, under the
  // loop over tiles: ptxas keeps the accumulators in registers across it
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    int g, m0, n0;
    tile_at<BM, BN>(p, t, g, m0, n0);
    int acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    fence_regs(acc);
    int prev = -1;
    for (int kt = 0; kt < p.ktiles; ++kt) {
      mbar_wait(bars + 8 * stage, phase);
      const uint32_t s = base + stage * T::STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8<WN>(acc, s8_desc(s + a_off + kk * 32), s8_desc(s + b_off + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the stage before is read: release it
      if (prev >= 0 && lane == 0) mbar_arrive(bars + 8 * (T::STAGES + prev));
      prev = stage;
      ring_advance<T::STAGES>(stage, phase);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(bars + 8 * (T::STAGES + prev));
    if constexpr (TMA_OUT)
      store_tile_tma<OUT, R>(p, g, acc, m0 + row_off, n0 + col_off, epi, 1 + wg, box);
    else
      store_tile<OUT, R>(p, g, acc, m0 + row_off, n0 + col_off, epi, 1 + wg);
  }
  if (TMA_OUT && tid % 128 == 0) bulk_wait_read<0>();
}

template <int BM, int BN, int OUT, bool TMA_OUT>
__global__ void __launch_bounds__(THREADS, 1) int8_gemm_kernel(const __grid_constant__ Params p) {
  using T = Tile<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + T::BAR_OFFSET;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                   // the producer's expect_tx
      mbar_init(bars + 8 * (T::STAGES + s), 8);     // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= 256) {
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 256) produce<BM, BN>(p, base, bars);
  } else {
    reg_alloc<CONSUMER_REGS>();
    consume<BM, BN, OUT, TMA_OUT>(p, base, bars, tid);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <int BM, int BN, int OUT, bool TMA_OUT>
cudaError_t launch(Params& p, const void* a, const void* const* w, int K, cudaStream_t st) {
  using T = Tile<BM, BN>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemm_kernel<BM, BN, OUT, TMA_OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  constexpr CUtensorMapDataType OUT_TYPE = OUT == 0   ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : OUT == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                      : CU_TENSOR_MAP_DATA_TYPE_INT32;
  cudaError_t e = s8_tensor_map(&p.a_map, a, p.M, K, BM);
  p.mtiles = (p.M + BM - 1) / BM;
  p.tile0[0] = 0;
  for (int g = 0; g < MAX_GROUPS; ++g) {
    if (g < p.groups) {
      if (e == cudaSuccess) e = s8_tensor_map(&p.w_map[g], w[g], p.n[g], K, BN);
      if (TMA_OUT && e == cudaSuccess)
        e = tensor_map_2d(&p.out_map[g], OUT_TYPE, OUT == 0 ? 2 : 4, p.out[g], p.M, p.n[g], 64);
      p.tile0[g + 1] = p.tile0[g] + (p.n[g] + BN - 1) / BN;
    } else {
      p.w_map[g] = p.w_map[0];
      p.out_map[g] = p.out_map[0];
      p.tile0[g + 1] = p.tile0[g];
    }
  }
  if (e != cudaSuccess) return e;
  p.tiles = p.mtiles * p.tile0[p.groups];
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  int8_gemm_kernel<BM, BN, OUT, TMA_OUT><<<grid, THREADS, T::SMEM_BYTES, st>>>(p);
  return cudaGetLastError();
}

// TMA stores where every output's rows are 16-byte aligned
template <int BM, int BN, int OUT>
cudaError_t launch_out(Params& p, const void* a, const void* const* w, int K, cudaStream_t st) {
  bool aligned = true;
  for (int g = 0; g < p.groups; ++g) aligned = aligned && p.n[g] * (OUT == 0 ? 2 : 4) % 16 == 0;
  return aligned ? launch<BM, BN, OUT, true>(p, a, w, K, st)
                 : launch<BM, BN, OUT, false>(p, a, w, K, st);
}

template <int OUT>
cudaError_t launch_tile(int tile, Params& p, const void* a, const void* const* w, int K,
                        cudaStream_t st) {
  switch (tile) {
    case 0: return launch_out<128, 256, OUT>(p, a, w, K, st);
    case 1: return launch_out<128, 128, OUT>(p, a, w, K, st);
    case 2: return launch_out<64, 256, OUT>(p, a, w, K, st);
    case 3: return launch_out<64, 128, OUT>(p, a, w, K, st);
    default: return cudaErrorInvalidValue;
  }
}

// the tile shape for M rows, as measured on an H100 at the trunk's M
// (chip_smoke.py phase 8): 128 x 256 from the one-shot CFG forward's 1920
// rows up, 128 x 128 for a 192-latent stream block's 576 and the 640 outside
// the CFG window, 64 x 128 below (64 and 192: bound by the weights' bytes,
// where the most tiles fill the most SMs)
int pick_tile(int M) {
  if (M >= 1024) return 0;
  if (M >= 384) return 1;
  return 3;
}

// ------------------------------------------- a bare check of the s8 core

// out (64 x N) int32 = a (64 x 128) . b (N x 128)^T on one warpgroup: the
// tiles copied into swizzled shared memory by the threads (USE_TMA false) or
// by two TMA boxes (true), then four k32 slices of wgmma s8
template <int N, bool USE_TMA>
__global__ void __launch_bounds__(128)
int8_core_check_kernel(const int8_t* a, const int8_t* b, int* out,
                       const __grid_constant__ CUtensorMap a_map,
                       const __grid_constant__ CUtensorMap b_map) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_s = base, b_s = base + 64 * BK, bar = b_s + N * BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if constexpr (USE_TMA) {
    if (tid == 0) {
      mbar_init(bar, 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(bar, (64 + N) * BK);
      tma_load_2d(a_s, &a_map, bar, 0, 0);
      tma_load_2d(b_s, &b_map, bar, 0, 0);
    }
    mbar_wait(bar, 0);
  } else {
    for (int c = tid; c < (64 + N) * 8; c += 128) {
      const int r = c / 8, ch = c % 8;
      const uint4 v = r < 64 ? reinterpret_cast<const uint4*>(a)[c]
                             : reinterpret_cast<const uint4*>(b)[c - 64 * 8];
      const uint32_t dst = (r < 64 ? a_s : b_s) + swz128(r < 64 ? r : r - 64, ch);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
                   "r"(v.z), "r"(v.w)
                   : "memory");
    }
    fence_proxy_async();
    __syncthreads();
  }
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk)
    wgmma_s8<N>(acc, s8_desc(a_s + kk * 32), s8_desc(b_s + kk * 32), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int row = 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    out[row * N + col] = acc[4 * j];
    out[row * N + col + 1] = acc[4 * j + 1];
    out[(row + 8) * N + col] = acc[4 * j + 2];
    out[(row + 8) * N + col + 1] = acc[4 * j + 3];
  }
}

template <int N, bool USE_TMA>
cudaError_t core_check(const int8_t* a, const int8_t* b, int* out, cudaStream_t st) {
  constexpr int SMEM = 1024 + (64 + N) * BK + 8;
  CUtensorMap a_map, b_map;
  cudaError_t e = s8_tensor_map(&a_map, a, 64, BK, 64);
  if (e == cudaSuccess) e = s8_tensor_map(&b_map, b, N, BK, N);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(int8_core_check_kernel<N, USE_TMA>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  int8_core_check_kernel<N, USE_TMA><<<1, 128, SMEM, st>>>(a, b, out, a_map, b_map);
  return cudaGetLastError();
}

}  // namespace

// a (M, K) int8 row-major, 16-byte aligned, K a multiple of 16; s_row (M,)
// fp32; `groups` (1..4) weights w_g (n_g, K) int8 row-major, 16-byte
// aligned, with s_col_g (n_g,) fp32 and out_g (M, n_g): out_code 0 bf16,
// 1 fp32, 2 int32 sums. tile: -1 picks the tile shape, 0..3 takes that one.
// Unused weight slots are ignored.
extern "C" int int8_gemm(const void* a, const void* s_row, int M, int K, int groups,
                         const void* w0, const void* w1, const void* w2, const void* w3,
                         const void* c0, const void* c1, const void* c2, const void* c3,
                         void* o0, void* o1, void* o2, void* o3, int n0, int n1, int n2, int n3,
                         int out_code, int tile, void* stream) {
  const void* const w[MAX_GROUPS] = {w0, w1, w2, w3};
  const void* const c[MAX_GROUPS] = {c0, c1, c2, c3};
  void* const o[MAX_GROUPS] = {o0, o1, o2, o3};
  const int n[MAX_GROUPS] = {n0, n1, n2, n3};
  if (M < 1 || K < 16 || K % 16 || groups < 1 || groups > MAX_GROUPS || tile < -1 || tile > 3)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.s_row = static_cast<const float*>(s_row);
  p.groups = groups;
  p.M = M;
  p.ktiles = (K + BK - 1) / BK;
  for (int g = 0; g < MAX_GROUPS; ++g) {
    const bool used = g < groups;
    if (used && n[g] < 1) return (int)cudaErrorInvalidValue;
    p.s_col[g] = static_cast<const float*>(used ? c[g] : c[0]);
    p.out[g] = used ? o[g] : o[0];
    p.n[g] = used ? n[g] : n[0];
  }
  const int t = tile >= 0 ? tile : pick_tile(M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_code) {
    case 0: return (int)launch_tile<0>(t, p, a, w, K, st);
    case 1: return (int)launch_tile<1>(t, p, a, w, K, st);
    case 2: return (int)launch_tile<2>(t, p, a, w, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the bare check of int8_core.cuh: out (64, n) int32 = a (64, 128) . b (n,
// 128)^T, n 64, 128 or 256, the tiles copied by the threads or by TMA
extern "C" int int8_core_check(const void* a, const void* b, void* out, int n, int use_tma,
                               void* stream) {
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* bp = static_cast<const int8_t*>(b);
  int* op = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n * 2 + (use_tma ? 1 : 0)) {
    case 128: return (int)core_check<64, false>(ap, bp, op, st);
    case 129: return (int)core_check<64, true>(ap, bp, op, st);
    case 256: return (int)core_check<128, false>(ap, bp, op, st);
    case 257: return (int)core_check<128, true>(ap, bp, op, st);
    case 512: return (int)core_check<256, false>(ap, bp, op, st);
    case 513: return (int)core_check<256, true>(ap, bp, op, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// microseconds of host time to encode one tensor map of a (rows, k) int8
// matrix at `a` (K4 encodes one for the activation and one a weight on every
// call), the mean of `reps`; negative if the encoding fails
extern "C" double int8_tensor_map_us(const void* a, int rows, int k, int reps) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (s8_tensor_map(&map, a, rows, k, 128) != cudaSuccess) return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
}
