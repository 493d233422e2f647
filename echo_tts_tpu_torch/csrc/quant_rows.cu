// Kernel K5: dynamic per-row int8 quantization of the trunk's activations,
// sm_90a.
//
// Computes echo_tts_tpu/models/quant.py:quant_rows, which XLA fuses into the
// int8 dot after it (the JAX package has no Pallas kernel here). For h
// (M, D) in bf16 or fp32, per row:
//   s = max(amax |h|, 1e-8) / 127        (fp32)
//   q = clip(rint(h / s), -127, 127)     (int8, round half to even)
// The division is IEEE (no reciprocal; the build has no fast math) and rintf
// rounds half to even as jnp.round does, so codes and scales equal the plain
// version's bit for bit.
//
// Bound. Bytes: each row is read once and its D codes and one scale written,
// M·D·(2 or 4) + M·D + 4·M bytes at 3.35 TB/s; a few operations an element,
// far below any compute limit.
//
// Design. A row is read once and held in registers: WPR warps share a row,
// each lane holding at most CPL 16-byte chunks (neighbouring lanes on
// neighbouring chunks), all loads in flight at once. WPR is the least of 1,
// 2, 4, 8 that leaves a lane at most four chunks (eight warps an fp32 row of
// 5888, six chunks a lane): short chains a lane and many rows in flight an
// SM. The amax is taken on the bits: |x| is x's bits without the sign, and
// non-negative floats order as their bits do, so a two-lane integer max
// (__vmaxu2) takes two bf16 values an instruction, one warp reduction
// (redux.sync) finishes a warp's part, and the parts of a row meet in shared
// memory. A code is rint(x / s) with the quotient rounded first; x · (1 / s)
// lies within 3 · 2^-24 · 127 < 1e-4 of that quotient, so wherever x · (1 /
// s) is farther than 1e-4 from a half-integer both round to the same
// integer, and only there is the IEEE division skipped. The codes go out 8
// (bf16) or 4 (fp32) bytes a store. (CPL, WPR) are template arguments, with
// an instance for each width the trunk and the encoders quantize (D = 1280,
// 2048, 3328, 5888) in both types; a block is eight warps. A row of another
// width (a multiple of 8) with no instance takes the CPL = 0 one: one warp a
// row, which reads the row twice, for the amax and then for the codes (the
// second read from L1/L2).
//
// Two more modes serve tensor parallelism, where a row is split over the tp
// ranks and its scale must be the whole row's: quant_rows_scale writes the
// scales alone (the ranks then take the max of theirs), and quant_rows_at
// the codes at given scales, each element's code as above. quant_rows_scale
// runs one warp a row, reading it once (M·D·(2 or 4) bytes). quant_rows_at
// (M·D·(2 or 4) + M·D bytes) takes the main mode's register layout: WPR
// warps a row, CPL chunks a lane, every load of a lane issued before its
// first store, so that a lane's chunks are one round trip to memory and not
// CPL dependent ones; it needs no reduction, so the warps of a row never
// meet. Its instances cover every row of at most 1024 chunks, the local
// widths of the row-sharded products at tp = 2 and 4 among them (the
// trunk's wo and w2: 1024, 2944, 512, 1472; the encoders': 640, 1664, 320,
// 832) in both types; a longer row takes one warp a row with one chunk in
// flight a lane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // eight warps

// the fp32 values of one 16-byte chunk
template <bool BF16>
__device__ __forceinline__ void unpack(const uint4 c, float (&v)[BF16 ? 8 : 4]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
  }
}

// the running maximum of |x| over one chunk, as bits: bf16 two values a
// word (the larger half holds the maximum), fp32 one
template <bool BF16>
__device__ __forceinline__ uint32_t abs_max_bits(const uint4 c, uint32_t m) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m = BF16 ? __vmaxu2(m, w[i] & 0x7fff7fffu) : max(m, w[i] & 0x7fffffffu);
  return m;
}

// the amax of a lane's running maximum over the warp, as a float
template <bool BF16>
__device__ __forceinline__ float warp_amax(uint32_t m) {
  if constexpr (BF16) m = max(m & 0xffffu, m >> 16) << 16;
  return __uint_as_float(__reduce_max_sync(0xffffffffu, m));
}

// rint(x / s) (the quotient rounded to fp32 first, half to even) clipped to
// +-127, with r = 1 / s: x * r is within 1e-4 of the quotient (see above),
// so the division runs only where x * r is that close to a half-integer
__device__ __forceinline__ uint32_t code(float x, float s, float r) {
  const float t = x * r;
  float c = rintf(t);
  if (!(fabsf(fabsf(t - c) - 0.5f) > 1e-4f)) c = rintf(x / s);
  c = fminf(fmaxf(c, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(c))));
}

// the codes of chunk c of a row at dst
template <bool BF16>
__device__ __forceinline__ void store_codes(int8_t* dst, int c, const uint4 chunk, float s,
                                            float r) {
  float v[BF16 ? 8 : 4];
  unpack<BF16>(chunk, v);
  uint32_t lo = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) lo |= code(v[i], s, r) << (8 * i);
  if constexpr (BF16) {
    uint32_t hi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) hi |= code(v[4 + i], s, r) << (8 * i);
    *reinterpret_cast<uint2*>(dst + static_cast<size_t>(c) * 8) = make_uint2(lo, hi);
  } else {
    *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(c) * 4) = lo;
  }
}

// CPL > 0: rows of chunks <= CPL * 32 * WPR 16-byte chunks held in
// registers, WPR warps a row; CPL = 0: one warp a row of any D, read twice
template <bool BF16, int CPL, int WPR>
__global__ void __launch_bounds__(THREADS)
quant_rows_kernel(const void* __restrict__ h, int8_t* __restrict__ q, float* __restrict__ s,
                  int M, int D) {
  constexpr int PER = BF16 ? 8 : 4;  // values a chunk
  constexpr int ROWS = THREADS / 32 / WPR, LANES = 32 * WPR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + warp / WPR, part = warp % WPR;
  const bool live = row < M;
  const int chunks = D / PER;
  const uint4* src = reinterpret_cast<const uint4*>(static_cast<const char*>(h) +
                                                    static_cast<size_t>(live ? row : 0) * D *
                                                        (BF16 ? 2 : 4));
  int8_t* dst = q + static_cast<size_t>(row) * D;
  if constexpr (CPL == 0) {
    if (!live) return;
    uint32_t m = 0;
    for (int c = lane; c < chunks; c += 32) m = abs_max_bits<BF16>(__ldg(src + c), m);
    const float sc = fmaxf(warp_amax<BF16>(m), 1e-8f) / 127.f, r = 1.f / sc;
    if (lane == 0) s[row] = sc;
    for (int c = lane; c < chunks; c += 32) store_codes<BF16>(dst, c, __ldg(src + c), sc, r);
  } else {
    uint4 c[CPL];
    const int first = part * 32 + lane;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      c[i] = live && first + i * LANES < chunks ? __ldg(src + first + i * LANES)
                                                : make_uint4(0u, 0u, 0u, 0u);
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < CPL; ++i) m = abs_max_bits<BF16>(c[i], m);
    float amax = warp_amax<BF16>(m);
    if constexpr (WPR > 1) {
      __shared__ float part_max[THREADS / 32];
      if (lane == 0) part_max[warp] = amax;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < WPR; ++w) amax = fmaxf(amax, part_max[warp - part + w]);
    }
    if (!live) return;
    const float sc = fmaxf(amax, 1e-8f) / 127.f, r = 1.f / sc;
    if (part == 0 && lane == 0) s[row] = sc;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (first + i * LANES < chunks) store_codes<BF16>(dst, first + i * LANES, c[i], sc, r);
  }
}

// one warp a row: its scale alone
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
quant_rows_scale_kernel(const void* __restrict__ h, float* __restrict__ s, int M, int D) {
  constexpr int PER = BF16 ? 8 : 4;
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const uint4* src = reinterpret_cast<const uint4*>(static_cast<const char*>(h) +
                                                    static_cast<size_t>(row) * D * (BF16 ? 2 : 4));
  uint32_t m = 0;
  for (int c = lane; c < D / PER; c += 32) m = abs_max_bits<BF16>(__ldg(src + c), m);
  const float sc = fmaxf(warp_amax<BF16>(m), 1e-8f) / 127.f;
  if (lane == 0) s[row] = sc;
}

// the codes at the given scales. CPL > 0: WPR warps a row, each lane
// holding at most CPL 16-byte chunks, all loaded before the first store;
// CPL = 0: one warp a row of any D, a chunk at a time
template <bool BF16, int CPL, int WPR>
__global__ void __launch_bounds__(THREADS)
quant_rows_at_kernel(const void* __restrict__ h, const float* __restrict__ s,
                     int8_t* __restrict__ q, int M, int D) {
  constexpr int PER = BF16 ? 8 : 4;
  constexpr int ROWS = THREADS / 32 / (CPL ? WPR : 1), LANES = 32 * WPR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + warp / (CPL ? WPR : 1);
  if (row >= M) return;
  const int chunks = D / PER;
  const uint4* src = reinterpret_cast<const uint4*>(static_cast<const char*>(h) +
                                                    static_cast<size_t>(row) * D * (BF16 ? 2 : 4));
  int8_t* dst = q + static_cast<size_t>(row) * D;
  if constexpr (CPL == 0) {
    const float sc = s[row], r = 1.f / sc;
    for (int c = lane; c < chunks; c += 32) store_codes<BF16>(dst, c, __ldg(src + c), sc, r);
  } else {
    const int first = (warp % WPR) * 32 + lane;
    uint4 c[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      c[i] = first + i * LANES < chunks ? __ldg(src + first + i * LANES)
                                        : make_uint4(0u, 0u, 0u, 0u);
    const float sc = __ldg(s + row), r = 1.f / sc;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (first + i * LANES < chunks) store_codes<BF16>(dst, first + i * LANES, c[i], sc, r);
  }
}

template <bool BF16, int CPL, int WPR>
cudaError_t launch(const void* h, void* q, void* s, int M, int D, cudaStream_t st) {
  constexpr int ROWS = THREADS / 32 / WPR;
  quant_rows_kernel<BF16, CPL, WPR><<<(M + ROWS - 1) / ROWS, THREADS, 0, st>>>(
      h, static_cast<int8_t*>(q), static_cast<float*>(s), M, D);
  return cudaGetLastError();
}

// warps a row and chunks a lane for rows of `chunks` chunks: the least WPR
// of 1, 2, 4, 8 that leaves at most four chunks a lane
void split(int chunks, int& wpr, int& cpl) {
  for (wpr = 1; wpr < 8 && chunks > 4 * 32 * wpr; wpr *= 2) {
  }
  cpl = (chunks + 32 * wpr - 1) / (32 * wpr);
}

// (CPL, WPR) instances: bf16 D = 1280, 2048 | 3328 | 5888 give (3, 2),
// (4, 2) | (4, 4) | (3, 8); fp32 (3, 4), (4, 4) | (4, 8) | (6, 8)
template <bool BF16>
cudaError_t dispatch(const void* h, void* q, void* s, int M, int D, cudaStream_t st) {
  int wpr, cpl;
  split(D / (BF16 ? 8 : 4), wpr, cpl);
  switch (cpl * 16 + wpr) {
    case 3 * 16 + 2: if constexpr (BF16) return launch<BF16, 3, 2>(h, q, s, M, D, st); break;
    case 4 * 16 + 2: if constexpr (BF16) return launch<BF16, 4, 2>(h, q, s, M, D, st); break;
    case 3 * 16 + 8: if constexpr (BF16) return launch<BF16, 3, 8>(h, q, s, M, D, st); break;
    case 3 * 16 + 4: if constexpr (!BF16) return launch<BF16, 3, 4>(h, q, s, M, D, st); break;
    case 6 * 16 + 8: if constexpr (!BF16) return launch<BF16, 6, 8>(h, q, s, M, D, st); break;
    case 4 * 16 + 4: return launch<BF16, 4, 4>(h, q, s, M, D, st);
    case 4 * 16 + 8: if constexpr (!BF16) return launch<BF16, 4, 8>(h, q, s, M, D, st); break;
    default: break;
  }
  return launch<BF16, 0, 1>(h, q, s, M, D, st);
}

}  // namespace

// h (M, D) contiguous, bf16 (bf16 != 0) or fp32, 16-byte aligned, D a
// multiple of 8; q (M, D) int8; s (M,) fp32.
extern "C" int quant_rows(const void* h, void* q, void* s, int M, int D, int bf16, void* stream) {
  if (M < 1 || D < 8 || D % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? dispatch<true>(h, q, s, M, D, st) : dispatch<false>(h, q, s, M, D, st));
}


// the scales alone: h (M, D) as above, s (M,) fp32
extern "C" int quant_rows_scale(const void* h, void* s, int M, int D, int bf16, void* stream) {
  if (M < 1 || D < 8 || D % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (M + THREADS / 32 - 1) / (THREADS / 32);
  if (bf16)
    quant_rows_scale_kernel<true><<<blocks, THREADS, 0, st>>>(h, static_cast<float*>(s), M, D);
  else
    quant_rows_scale_kernel<false><<<blocks, THREADS, 0, st>>>(h, static_cast<float*>(s), M, D);
  return (int)cudaGetLastError();
}

namespace {

template <bool BF16, int CPL, int WPR>
cudaError_t launch_at(const void* h, const float* s, int8_t* q, int M, int D, cudaStream_t st) {
  constexpr int ROWS = THREADS / 32 / (CPL ? WPR : 1);
  quant_rows_at_kernel<BF16, CPL, WPR><<<(M + ROWS - 1) / ROWS, THREADS, 0, st>>>(h, s, q, M, D);
  return cudaGetLastError();
}

// (CPL, WPR) instances of the codes mode: every split() of a row of at most
// 1024 chunks (bf16 D <= 8192, fp32 D <= 4096). The tp widths: bf16 D =
// 1024, 2944 | 512, 1472 | 640, 1664 | 320, 832 give (4, 1), (3, 4) | (2, 1),
// (3, 2) | (3, 1), (4, 2) | (2, 1), (4, 1); fp32 (4, 2), (3, 8) | (4, 1),
// (3, 4) | (3, 2), (4, 4) | (3, 1), (4, 2)
template <bool BF16>
cudaError_t dispatch_at(const void* h, const float* s, int8_t* q, int M, int D, cudaStream_t st) {
  int wpr, cpl;
  split(D / (BF16 ? 8 : 4), wpr, cpl);
  switch (cpl * 16 + wpr) {
    case 1 * 16 + 1: return launch_at<BF16, 1, 1>(h, s, q, M, D, st);
    case 2 * 16 + 1: return launch_at<BF16, 2, 1>(h, s, q, M, D, st);
    case 3 * 16 + 1: return launch_at<BF16, 3, 1>(h, s, q, M, D, st);
    case 4 * 16 + 1: return launch_at<BF16, 4, 1>(h, s, q, M, D, st);
    case 3 * 16 + 2: return launch_at<BF16, 3, 2>(h, s, q, M, D, st);
    case 4 * 16 + 2: return launch_at<BF16, 4, 2>(h, s, q, M, D, st);
    case 3 * 16 + 4: return launch_at<BF16, 3, 4>(h, s, q, M, D, st);
    case 4 * 16 + 4: return launch_at<BF16, 4, 4>(h, s, q, M, D, st);
    case 3 * 16 + 8: return launch_at<BF16, 3, 8>(h, s, q, M, D, st);
    case 4 * 16 + 8: return launch_at<BF16, 4, 8>(h, s, q, M, D, st);
    default: break;
  }
  return launch_at<BF16, 0, 1>(h, s, q, M, D, st);
}

}  // namespace

// the codes at given scales: h (M, D) as above, s (M,) fp32, q (M, D) int8
extern "C" int quant_rows_at(const void* h, const void* s, void* q, int M, int D, int bf16,
                             void* stream) {
  if (M < 1 || D < 8 || D % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  int8_t* qc = static_cast<int8_t*>(q);
  return (int)(bf16 ? dispatch_at<true>(h, sc, qc, M, D, st)
                    : dispatch_at<false>(h, sc, qc, M, D, st));
}
