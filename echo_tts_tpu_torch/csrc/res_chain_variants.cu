// Kernels K2v-cl, K2v-cf and K2s: the fused three-unit residual chain of the
// S1-DAC decoder tail in one launch, (B, T, C) channels-last or (B, C, T)
// channels-first bf16, C = 96 or 192, sm_90a, on conv_core.cuh (the wgmma
// core of K2, res_chain.cu).
//
// Replaces scripts/bench_conv_kernel_variants.py:_kernel (K2v-cl, called from
// res_chain), :_kernel_cf (K2v-cf, called from res_chain_cf) and the three
// bodies of scripts/bench_conv_variants.py:make_kernel (K2s). They are one
// chain
//     x <- x + conv1x1(snake(conv7_dilated_causal(snake(x)) + b7)) + b1
// for dilations (1, 3, 9), rows before the sequence start standing for each
// conv's causal zero pad, with the measurement flags: the snake (sinf, K2's
// sin^2 polynomial, the stand-in z*a, the identity, or the Taylor cosine of
// bench_conv_variants.py:_snake_poly; sinf and z*a also with bf16 rounding
// after every operation), live_mode (re-zero the pad rows by select, by
// multiply, or not at all), tap_offsets (every tap at offset 0: wrong math,
// one row offset for all taps), pack_taps, tile_t, and the layout of x and
// out. K2v-cf is the channels-first layout with the snake sinf or z*a and
// the multiply re-zero; K2s is channels-last with the select re-zero.
//
// Bound. 3 * 16*T*C*C FLOPs over one read and one write of T*C bf16: 12*C
// FLOP per byte, 1152 at C=96 and 2304 at C=192, above the 295 FLOP/byte
// ridge: tensor-core operations.
//
// Design. A persistent block (one an SM) walks time tiles of tile_t rows.
// Its window is the tile plus an 80-row halo (the chain's receptive extent,
// 78, rounded up), held in shared memory as a strip tile x, updated in place
// unit by unit; y = snake1(x) over the window is staged once a unit as a
// second strip tile with 8 zero rows above it (the causal pad the first
// rows need). Two consumer warpgroups take each 64-row m-tile of a unit
// together, each half of the output columns (m64n96 at C=192, m64n48 at
// C=96); a tap is the y window's descriptor moved to its row (conv_core.cuh:
// no staged copy); the weights of the three units stream as pre-packed strip
// tiles through one ring (cp.async.bulk, one producer thread); snake2 goes
// from the accumulator into a 64-row z strip tile, the 1x1 product reads it,
// and its epilogue adds bias and residual into x. A unit starts at the first
// 16-row strip any later unit needs (rows no output depends on are skipped,
// which changes no result) and computes whole 64-row m-tiles from there.
// pack_taps keeps its meaning, the seven shifted row groups of a 32-channel
// chunk staged side by side and multiplied as one product of depth 7*32:
// on this core that is only a copy more. Shared memory bounds the tile:
// tile_t <= 96 at C=192 (48 with pack_taps), <= 384 at C=96 (304). The
// snake is a template parameter: seven instantiations a width, every snake
// channels-last, sin and z*a channels-first.
//
// Channels first. On the TPU a tap of the channels-first chain is a lane
// shift; a wgmma operand kept time-major cannot take a shift of 1, 3 or 9
// rows (its core matrix is 8 rows of 16 bytes, a descriptor moves in
// 16-byte steps). So the layout is changed once on the way in and once on
// the way out, and everything between is the channels-last chain: a thread
// loads 8 channels x 8 time steps (eight 16-byte loads, one a channel row),
// transposes them in registers (byte permutes) and writes eight strip rows
// of the window, the same strip layout fill_window writes; the out tile goes
// back the same way in reverse. The window starts at a multiple of 8, so
// when T % 8 == 0 an 8-step group lies wholly inside or outside [0, T) and
// every channel row is 16-byte aligned; otherwise (a row then starts at
// c*T*2 bytes, no multiple of 4) the group is loaded and stored one bf16 at
// a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "conv_core.cuh"

using namespace conv_core;

enum { SNAKE_SIN = 0, SNAKE_SIN2 = 1, SNAKE_LINEAR = 2, SNAKE_IDENTITY = 3, SNAKE_COS = 4 };
enum { LIVE_WHERE = 0, LIVE_MULT = 1, LIVE_OFF = 2 };

namespace {

constexpr int NU = 3;
constexpr int HALO = 80;  // receptive extent 6*(1+3+9) = 78, rounded to 16
constexpr int PADR = 8;   // zero rows above y: unit u reads down to first[u] - 6 d_u >= -6
constexpr int KC = 32;    // input channels a weight tile
constexpr int ZR = 65;    // rows of the z strip tile (64, odd)
constexpr int PR = 65;    // rows of the packed-taps tile
constexpr int SMEM_LIMIT = 232448;

struct ChainParams {
  const bf16* x;
  bf16* out;
  const bf16* w;  // per unit: 7 * C/KC conv7 tiles [tap][k chunk], then C/KC 1x1 tiles
  const float* a1;  // (3, C) each: snake alphas, their 1/(a + 1e-9), biases
  const float* inv1;
  const float* a2;
  const float* inv2;
  const float* b7;
  const float* b1;
  int T, tile_t, snake_bf16, live_mode, tap_offsets, pack, tiles_per_b, n_tiles;
  int dil[NU], first[NU];
};

template <int C_>
struct ChainCfg {
  static constexpr int C = C_;
  static constexpr int NCH = C / 2;  // columns a warpgroup
  static constexpr int KCH = C / KC;
  static constexpr int STAGES = C == 192 ? 3 : 4;
  static constexpr int STAGE_BYTES = KC * C * 2;
  static constexpr int TILE_ELEMS = KC * C;
  static constexpr int UNIT_TILES = 8 * KCH;  // 7 KCH conv7 + KCH 1x1
  static constexpr int THREADS = 3 * WG_THREADS;
  using Ring = WeightRing<STAGES, STAGE_BYTES>;
  static __host__ __device__ int rows_x(int tile_t) { return (tile_t + HALO) | 1; }
  static __host__ __device__ int rows_y(int tile_t) { return (PADR + tile_t + HALO + 64) | 1; }
  static int smem_bytes(int tile_t, bool pack) {
    return 128 + Ring::BYTES + (rows_x(tile_t) + rows_y(tile_t) + ZR) * C * 2 +
           (pack ? PR * 7 * KC * 2 : 0);
  }
};

__device__ __forceinline__ float rb(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16(v));
}

// x + (1 - cos(2 a x)) * (0.5 * inv) with the Taylor cosine of
// scripts/bench_conv_variants.py:_snake_poly after its reduction of 2 a x to
// [-pi, pi] (round half to even), fp32
__device__ __forceinline__ float snake_cos(float v, float a, float inv) {
  const float z = (2.0f * a) * v;
  const float r = z - rintf(z * 0.15915494309189535f) * 6.283185307179586f;
  const float u = r * r;
  float c = -1.0f / 87178291200.0f;
  c = c * u + 1.0f / 479001600.0f;
  c = c * u + -1.0f / 3628800.0f;
  c = c * u + 1.0f / 40320.0f;
  c = c * u + -1.0f / 720.0f;
  c = c * u + 1.0f / 24.0f;
  c = c * u + -0.5f;
  const float cosr = c * u + 1.0f;
  return v + (1.0f - cosr) * (0.5f * inv);
}

// the snake of code S (a template parameter: a switch over the five codes in
// the epilogues cost every mode 11-23 % of its time on the card)
template <int S>
__device__ __forceinline__ float var_snake(float v, float a, float inv, int b16) {
  if constexpr (S == SNAKE_SIN) {
    if (b16) {  // every operation rounded to bf16, as bf16 arithmetic does
      v = rb(v);
      const float s = rb(sinf(rb(a * v)));
      return rb(v + rb(inv * rb(s * s)));
    }
    const float s = sinf(a * v);
    return v + inv * (s * s);
  } else if constexpr (S == SNAKE_SIN2) {
    return snake(v, a, inv);
  } else if constexpr (S == SNAKE_LINEAR) {
    return b16 ? rb(rb(v) * a) : v * a;
  } else if constexpr (S == SNAKE_COS) {
    return snake_cos(v, a, inv);
  } else {
    return v;
  }
}

// 8 x 8 bf16 transposed: out[r] holds element r of in[0] .. in[7]
__device__ __forceinline__ void transpose8(const uint4 (&in)[8], uint4 (&out)[8]) {
  uint32_t a[8][4];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k][0] = in[k].x;
    a[k][1] = in[k].y;
    a[k][2] = in[k].z;
    a[k][3] = in[k].w;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    uint32_t o[4];
#pragma unroll
    for (int w = 0; w < 4; ++w)
      o[w] = __byte_perm(a[2 * w][r >> 1], a[2 * w + 1][r >> 1], (r & 1) ? 0x7632 : 0x5410);
    out[r] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// elements t .. t + 7 of the bf16 row `row` (T long), zero outside [0, T),
// one at a time (no alignment needed)
__device__ __forceinline__ uint4 load8_narrow(const bf16* row, int t, int T) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ta = t + 2 * e, tb = ta + 1;
    w[e] = (ta >= 0 && ta < T ? h[ta] : 0u) | (tb >= 0 && tb < T ? uint32_t(h[tb]) << 16 : 0u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// v's 8 elements into row[t .. t + 7], those past T left out, one at a time
__device__ __forceinline__ void store8_narrow(bf16* row, int t, int T, uint4 v) {
  unsigned short* h = reinterpret_cast<unsigned short*>(row);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (t + e < T) h[t + e] = static_cast<unsigned short>(w[e >> 1] >> (16 * (e & 1)));
}

// Rows t_first .. t_first + n_rows - 1 of channels-first x (C rows of T bf16)
// as the strip window at `win` (win_rows rows), rows outside [0, T) zero: what
// fill_window writes from channels-last x. t_first and n_rows are multiples
// of 8; a thread takes a group of 8 rows of one strip (8 channels), one
// strip after another along the warp, so the eight 16-byte stores of a phase
// land in eight strips, off each other's banks (win_rows odd).
template <int C>
__device__ __forceinline__ void fill_window_cf(uint32_t win, int win_rows, const bf16* x, int T,
                                               int t_first, int n_rows, int tid, int nt) {
  constexpr int NS = C / 8;
  const bool wide = T % 8 == 0;
  for (int i = tid; i < n_rows / 8 * NS; i += nt) {
    const int g = i / NS, s = i - g * NS, t = t_first + 8 * g;
    const bf16* rows = x + static_cast<long long>(8 * s) * T;
    uint4 in[8];
    if (wide) {
      const bool inside = t >= 0 && t < T;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        in[k] = inside ? *reinterpret_cast<const uint4*>(rows + static_cast<long long>(k) * T + t)
                       : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) in[k] = load8_narrow(rows + static_cast<long long>(k) * T, t, T);
    }
    uint4 tr[8];
    transpose8(in, tr);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      st_shared_v4(win + s * win_rows * CORE_ROW + (8 * g + r) * CORE_ROW, tr[r]);
  }
}

// Window rows r0 .. r0 + n_rows - 1 (times t0 ..) of the strip window at
// `win` into channels-first out (C rows of T), times from T on left out: the
// reverse of fill_window_cf. n_rows and t0 are multiples of 8.
template <int C>
__device__ __forceinline__ void store_window_cf(bf16* out, int T, int t0, uint32_t win,
                                                int win_rows, int r0, int n_rows, int tid,
                                                int nt) {
  constexpr int NS = C / 8;
  const bool wide = T % 8 == 0;
  for (int i = tid; i < n_rows / 8 * NS; i += nt) {
    const int g = i / NS, s = i - g * NS, t = t0 + 8 * g;
    if (t >= T) continue;
    uint4 in[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      in[r] = ld_shared_v4(win + s * win_rows * CORE_ROW + (r0 + 8 * g + r) * CORE_ROW);
    uint4 tr[8];
    transpose8(in, tr);
    bf16* rows = out + static_cast<long long>(8 * s) * T;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (wide)
        *reinterpret_cast<uint4*>(rows + static_cast<long long>(k) * T + t) = tr[k];
      else
        store8_narrow(rows + static_cast<long long>(k) * T, t, T, tr[k]);
    }
  }
}

// the chain on x laid out channels-first (CF) or channels-last, snake S
template <int C, bool CF, int S>
__device__ __forceinline__ void chain_body(const ChainParams& p) {
  using K = ChainCfg<C>;
  constexpr int NCH = K::NCH, KCH = K::KCH, STAGES = K::STAGES, SB = K::STAGE_BYTES;
  constexpr int CONSUMERS = 2 * WG_THREADS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 127u) & ~127u;
  const uint32_t bars = ring + K::Ring::BAR_OFFSET;
  const int W = p.tile_t + HALO;
  const int rx = K::rows_x(p.tile_t), ry = K::rows_y(p.tile_t);
  const uint32_t X = ring + K::Ring::BYTES;
  const uint32_t Y = X + rx * C * 2;
  const uint32_t Z = Y + ry * C * 2;
  const uint32_t P = Z + ZR * C * 2;  // packed taps (pack_taps only)
  if (threadIdx.x == 0) weight_ring_init<STAGES>(bars, CONSUMERS / 32);
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    reg_dealloc<24>();
    if (threadIdx.x == 2 * WG_THREADS) {
      RingPos pos = {0, 0u};
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        for (int u = 0; u < NU; ++u) {
          const bf16* wu = p.w + static_cast<long long>(u) * K::UNIT_TILES * K::TILE_ELEMS;
          for (int mt = 0; mt < (W - p.first[u] + 63) / 64; ++mt) {
            for (int it = 0; it < 7 * KCH; ++it) {
              // packed taps walk chunk by chunk, tap by tap
              const int tile_i = p.pack ? (it % 7) * KCH + it / 7 : it;
              ring_fill<STAGES, SB>(ring, bars, pos, wu + tile_i * K::TILE_ELEMS);
            }
            for (int kc = 0; kc < KCH; ++kc)
              ring_fill<STAGES, SB>(ring, bars, pos, wu + (7 * KCH + kc) * K::TILE_ELEMS);
          }
        }
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  reg_alloc<240>();  // 128 x 24 + 256 x 240: the 168 a thread of one block an SM
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid / 32) % 4;
  constexpr int V = C / 8;
  for (int i = tid; i < PADR * V; i += CONSUMERS)
    st_shared_v4(Y + strip_off(ry, i / V, 8 * (i % V)), make_uint4(0, 0, 0, 0));
  RingPos pos = {0, 0u};
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int b = tile / p.tiles_per_b;
    const int t0 = (tile - b * p.tiles_per_b) * p.tile_t;
    const int tw = t0 - HALO;  // time of window row 0
    const long long xb = static_cast<long long>(b) * p.T * C;
    named_sync(1, CONSUMERS);  // the last tile's x is written out
    if constexpr (CF)
      fill_window_cf<C>(X, rx, p.x + xb, p.T, tw, W, tid, CONSUMERS);
    else
      fill_window<C>(X, rx, p.x + xb, p.T, tw, W, [](float (&)[8], int) {}, tid, CONSUMERS);
    for (int u = 0; u < NU; ++u) {
      const int d = p.dil[u];
      const float* a1 = p.a1 + u * C;
      const float* inv1 = p.inv1 + u * C;
      const float* a2 = p.a2 + u * C;
      const float* inv2 = p.inv2 + u * C;
      const float* b7 = p.b7 + u * C;
      const float* b1 = p.b1 + u * C;
      named_sync(1, CONSUMERS);  // x is whole
      // y = snake1(x) over the window
      for (int i = tid; i < W * V; i += CONSUMERS) {
        const int r = i / V, c0 = 8 * (i - r * V);
        float v[8];
        unpack8(ld_shared_v4(X + strip_off(rx, r, c0)), v);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = var_snake<S>(v[e], __ldg(a1 + c0 + e), __ldg(inv1 + c0 + e), p.snake_bf16);
        st_shared_v4(Y + strip_off(ry, PADR + r, c0), pack8(v));
      }
      fence_proxy_async();
      named_sync(1, CONSUMERS);

      for (int mt = 0; mt < (W - p.first[u] + 63) / 64; ++mt) {  // 64-row m-tiles
        const int r0 = p.first[u] + 64 * mt;  // window row of the m-tile's row 0
        const int ylo = PADR + r0 - 6 * d;   // y row of tap 0 (offset 0)
        float acc[NCH / 2];
        if (p.pack) {
          for (int kc = 0; kc < KCH; ++kc) {
            named_sync(1, CONSUMERS);  // the last chunk's products are done
            for (int i = tid; i < 64 * 7 * (KC / 8); i += CONSUMERS) {
              const int r = i / (7 * (KC / 8)), s = i - r * (7 * (KC / 8));
              const int j = s / (KC / 8), c = kc * KC + 8 * (s - j * (KC / 8));
              st_shared_v4(P + strip_off(PR, r, 8 * s),
                           ld_shared_v4(Y + strip_off(ry, ylo + r + j * d, c)));
            }
            fence_proxy_async();
            named_sync(1, CONSUMERS);
            ring_product<KC, C, STAGES, SB>(
                acc, 7,
                [&](int j, int kk) {
                  return strip_desc(P + strip_off(PR, 0, j * KC + 16 * kk), PR * CORE_ROW);
                },
                ring, bars, wg * NCH, pos, lane, kc == 0);
          }
        } else {
          const int step = p.tap_offsets ? d : 0;
          ring_product<KC, C, STAGES, SB>(
              acc, 7 * KCH,
              [&](int it, int kk) {
                const int j = it / KCH;
                return strip_desc(Y + strip_off(ry, ylo + j * step, (it - j * KCH) * KC + 16 * kk),
                                  ry * CORE_ROW);
              },
              ring, bars, wg * NCH, pos, lane);
        }
        // z = snake2(conv7 + b7) -> bf16; opaque: the epilogue's addresses
        // are made here, not hoisted to hold registers through the products
        const int col0 = opaque(wg * NCH + frag_col(lane, 0, 0));
#pragma unroll
        for (int j = 0; j < NCH / 8; ++j) {
          const int col = col0 + 8 * j;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float z[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              z[e] = var_snake<S>(acc[4 * j + 2 * h + e] + __ldg(b7 + col + e),
                                  __ldg(a2 + col + e), __ldg(inv2 + col + e), p.snake_bf16);
            st_shared_b32(Z + strip_off(ZR, frag_row(warp, lane, 2 * h), col),
                          pack_bf16(z[0], z[1]));
          }
        }
        fence_proxy_async();
        named_sync(1, CONSUMERS);  // z has both warpgroups' columns
        ring_product<KC, C, STAGES, SB>(
            acc, KCH,
            [&](int kc, int kk) {
              return strip_desc(Z + strip_off(ZR, 0, kc * KC + 16 * kk), ZR * CORE_ROW);
            },
            ring, bars, wg * NCH, pos, lane);
        // x += z . W1 + b1, pad rows re-zeroed as live_mode says
        const int col1 = opaque(wg * NCH + frag_col(lane, 0, 0));
#pragma unroll
        for (int j = 0; j < NCH / 8; ++j) {
          const int col = col1 + 8 * j;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int wr = r0 + frag_row(warp, lane, 2 * h);
            if (wr < W) {
              const uint32_t a = X + strip_off(rx, wr, col);
              uint32_t old = ld_shared_b32(a);
              const float2 xo = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&old));
              const bool live = tw + wr >= 0;
              float o[2] = {xo.x + (acc[4 * j + 2 * h] + __ldg(b1 + col)),
                            xo.y + (acc[4 * j + 2 * h + 1] + __ldg(b1 + col + 1))};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (p.live_mode == LIVE_WHERE) o[e] = live ? o[e] : 0.f;
                else if (p.live_mode == LIVE_MULT) o[e] = rb(o[e]) * (live ? 1.f : 0.f);
              }
              st_shared_b32(a, pack_bf16(o[0], o[1]));
            }
          }
        }
        named_sync(1, CONSUMERS);  // z is read; the next m-tile may write it
      }
    }
    named_sync(1, CONSUMERS);
    bf16* xout = p.out + xb;
    if constexpr (CF) {
      store_window_cf<C>(xout, p.T, t0, X, rx, HALO, p.tile_t, tid, CONSUMERS);
    } else {
      for (int i = tid; i < p.tile_t * V; i += CONSUMERS) {
        const int r = i / V, c0 = 8 * (i - r * V), t = t0 + r;
        if (t < p.T)
          *reinterpret_cast<uint4*>(xout + static_cast<long long>(t) * C + c0) =
              ld_shared_v4(X + strip_off(rx, HALO + r, c0));
      }
    }
  }
}

// K2v-cl and K2s
template <int C, int S>
__global__ void __launch_bounds__(ChainCfg<C>::THREADS, 1)
res_chain_cl_kernel(const __grid_constant__ ChainParams p) {
  chain_body<C, false, S>(p);
}

// K2v-cf: its own name, so that a profile tells it apart
template <int C, int S>
__global__ void __launch_bounds__(ChainCfg<C>::THREADS, 1)
res_chain_cf_kernel(const __grid_constant__ ChainParams p) {
  chain_body<C, true, S>(p);
}

template <int C, bool CF, int S>
int launch(ChainParams p, int B, cudaStream_t s) {
  using K = ChainCfg<C>;
  static bool configured = false;
  static int sms = 0;
  void (*kernel)(ChainParams);
  if constexpr (CF)
    kernel = res_chain_cf_kernel<C, S>;
  else
    kernel = res_chain_cl_kernel<C, S>;
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
  const int smem = K::smem_bytes(p.tile_t, p.pack != 0);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  p.tiles_per_b = (p.T + p.tile_t - 1) / p.tile_t;
  p.n_tiles = B * p.tiles_per_b;
  kernel<<<std::min(p.n_tiles, sms), K::THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// the instantiation of `snake`: every code channels-last, sin and z*a (all
// that _kernel_cf offers) channels-first
template <int C, bool CF>
int launch_snake(ChainParams p, int B, int snake, cudaStream_t s) {
  switch (snake) {
    case SNAKE_SIN: return launch<C, CF, SNAKE_SIN>(p, B, s);
    case SNAKE_LINEAR: return launch<C, CF, SNAKE_LINEAR>(p, B, s);
  }
  if constexpr (!CF) {
    switch (snake) {
      case SNAKE_SIN2: return launch<C, CF, SNAKE_SIN2>(p, B, s);
      case SNAKE_IDENTITY: return launch<C, CF, SNAKE_IDENTITY>(p, B, s);
      case SNAKE_COS: return launch<C, CF, SNAKE_COS>(p, B, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

int smem_bytes(int C, int tile_t, bool pack) {
  return C == 192 ? ChainCfg<192>::smem_bytes(tile_t, pack) : ChainCfg<96>::smem_bytes(tile_t, pack);
}

}  // namespace

// x, out: (B, T, C) bf16 contiguous, or (B, C, T) with channels_first; C in
// {96, 192}; w: per unit the seven
// conv7 taps (7, C, C) as [tap][in][out] cut into (32 x C) strip tiles
// [tap][k chunk], then the 1x1 weights (1, C, C) cut the same way
// (ops/conv_core.py:pack_tiles), units one after another; a1, inv1, a2, inv2,
// b7, b1: (3, C) fp32. tile_t: output rows per block, a multiple of 16.
// snake and live_mode: the codes of the enums above (channels first: snake
// SNAKE_SIN or SNAKE_LINEAR).
extern "C" int res_chain_var_fwd(const void* x, void* out, const void* w, const void* a1,
                                 const void* inv1, const void* a2, const void* inv2,
                                 const void* b7, const void* b1, int B, int T, int C, int tile_t,
                                 int snake, int snake_bf16, int live_mode, int tap_offsets,
                                 int pack, int channels_first, void* stream) {
  if ((C != 96 && C != 192) || B < 1 || T < 1 || tile_t < 16 || tile_t % 16 || snake < 0 ||
      snake > SNAKE_COS || live_mode < 0 || live_mode > LIVE_OFF)
    return (int)cudaErrorInvalidValue;
  ChainParams p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.w = static_cast<const bf16*>(w);
  p.a1 = static_cast<const float*>(a1);
  p.inv1 = static_cast<const float*>(inv1);
  p.a2 = static_cast<const float*>(a2);
  p.inv2 = static_cast<const float*>(inv2);
  p.b7 = static_cast<const float*>(b7);
  p.b1 = static_cast<const float*>(b1);
  p.T = T; p.tile_t = tile_t; p.snake_bf16 = snake_bf16;
  p.live_mode = live_mode; p.tap_offsets = tap_offsets; p.pack = pack;
  const int dil[NU] = {1, 3, 9};
  int need = HALO;  // first window row that unit u's successors read
  for (int u = NU - 1; u >= 0; --u) {
    p.dil[u] = dil[u];
    p.first[u] = need / 16 * 16;
    need -= 6 * dil[u];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels_first)
    return C == 192 ? launch_snake<192, true>(p, B, snake, s)
                    : launch_snake<96, true>(p, B, snake, s);
  return C == 192 ? launch_snake<192, false>(p, B, snake, s)
                  : launch_snake<96, false>(p, B, snake, s);
}

extern "C" int res_chain_var_smem_bytes(int C, int tile_t, int pack) {
  return smem_bytes(C, tile_t, pack != 0);
}
