// Polyphase resampler core (upfirdn) — host-side audio preprocessing.
//
// A copy of echo_tts_tpu/native/resample.cc, built for the PyTorch port by
// echo_tts_tpu_torch/native/build.py. The reference leans on
// torchaudio.functional.resample / torchcodec decode for speaker-reference
// audio; that work is host CPU, off the device's hot path. This is the
// native equivalent: a cache-friendly
// polyphase FIR with per-phase precomputed taps, OpenMP-free (the server
// already parallelizes across requests), exposed through ctypes.
//
// Contract (matches scipy.signal.upfirdn semantics for 1-D input):
//   y[j] = sum_t h[phase_j + t*up] * x[off_j - t]
// with phase_j = (j*down) % up, off_j = (j*down) / up, zero padding
// outside [0, n_in). Output length n_out = ceil((n_in*T_h_eff...)),
// computed by the Python wrapper exactly as scipy does.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// in: n_in samples; h: taps (length n_h); out: n_out samples.
// Returns 0 on success.
int upfirdn_f32(const float* in, int64_t n_in,
                const float* h, int64_t n_h,
                int up, int down,
                float* out, int64_t n_out) {
  if (up <= 0 || down <= 0 || n_in < 0 || n_h <= 0) return 1;

  // Precompute per-phase tap lists: phase p uses h[p], h[p+up], h[p+2*up]...
  const int64_t taps_per_phase = (n_h + up - 1) / up;
  std::vector<float> poly(static_cast<size_t>(up) * taps_per_phase, 0.0f);
  for (int64_t k = 0; k < n_h; ++k) {
    const int64_t p = k % up;
    const int64_t t = k / up;
    poly[static_cast<size_t>(p) * taps_per_phase + t] = h[k];
  }

  for (int64_t j = 0; j < n_out; ++j) {
    const int64_t num = j * static_cast<int64_t>(down);
    const int64_t phase = num % up;
    const int64_t off = num / up;
    const float* taps = &poly[static_cast<size_t>(phase) * taps_per_phase];

    // x index runs off, off-1, ..., off-taps_per_phase+1; clip to [0, n_in)
    int64_t t_lo = 0;
    int64_t t_hi = taps_per_phase;  // exclusive
    if (off >= n_in) t_lo = off - n_in + 1;
    if (off - (t_hi - 1) < 0) t_hi = off + 1;

    double acc = 0.0;
    const float* xp = in + (off - t_lo);
    for (int64_t t = t_lo; t < t_hi; ++t, --xp) {
      acc += static_cast<double>(taps[t]) * static_cast<double>(*xp);
    }
    out[j] = static_cast<float>(acc);
  }
  return 0;
}

// Mono mix + peak normalize (>1 only), the reference's load_audio transform
// (reference: inference.py:141-149). in: (ch, n) row-major; out: (n,).
int mono_mix_normalize_f32(const float* in, int64_t ch, int64_t n, float* out) {
  if (ch <= 0 || n < 0) return 1;
  const double inv_ch = 1.0 / static_cast<double>(ch);
  float peak = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    double acc = 0.0;
    for (int64_t c = 0; c < ch; ++c) acc += in[c * n + i];
    const float v = static_cast<float>(acc * inv_ch);
    out[i] = v;
    const float a = v < 0 ? -v : v;
    if (a > peak) peak = a;
  }
  if (peak > 1.0f) {
    const float inv = 1.0f / peak;
    for (int64_t i = 0; i < n; ++i) out[i] *= inv;
  }
  return 0;
}

}  // extern "C"
