"""scipy-compatible `resample_poly` on the native upfirdn core (counterpart
of echo_tts_tpu/native/resample_py.py).

The filter is scipy.signal.resample_poly's default design, made in numpy:
a windowed sinc with a Kaiser(5.0) window, 10*max(up, down) half-taps and
the cutoff at 1/max(up, down). Each function raises when the library cannot
be built or a call fails (`pipeline/audio_io.py:resample` catches that and
uses scipy).
"""
from __future__ import annotations

import ctypes
from math import gcd

import numpy as np

from echo_tts_tpu_torch.native.build import load

_FLOAT_P = ctypes.POINTER(ctypes.c_float)


def _design_filter(up: int, down: int) -> np.ndarray:
    max_rate = max(up, down)
    f_c = 1.0 / max_rate          # relative to Nyquist
    half_len = 10 * max_rate      # scipy's default
    n = 2 * half_len + 1
    t = np.arange(n, dtype=np.float64) - half_len
    h = f_c * np.sinc(f_c * t)
    h *= np.kaiser(n, 5.0)
    h /= h.sum()  # firwin's unity DC gain
    h *= up       # the upsampling gain
    return h.astype(np.float32)


def upfirdn_native(x: np.ndarray, h: np.ndarray, up: int, down: int) -> np.ndarray:
    """scipy.signal.upfirdn of a 1-D signal, float32."""
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    h = np.ascontiguousarray(h, dtype=np.float32)
    n_out = -(-((len(x) - 1) * up + len(h)) // down)  # scipy's output length
    out = np.empty(n_out, dtype=np.float32)
    rc = lib.upfirdn_f32(x.ctypes.data_as(_FLOAT_P), len(x), h.ctypes.data_as(_FLOAT_P),
                         len(h), up, down, out.ctypes.data_as(_FLOAT_P), n_out)
    if rc != 0:
        raise RuntimeError(f"upfirdn_f32 failed ({rc})")
    return out


def resample_native(audio: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    """scipy.signal.resample_poly-compatible rate conversion on the last
    axis, float32."""
    if sr_from == sr_to:
        return np.asarray(audio, dtype=np.float32)
    g = gcd(sr_from, sr_to)
    up, down = sr_to // g, sr_from // g
    h = _design_filter(up, down)
    half_len = (len(h) - 1) // 2

    # scipy's alignment: zero-prepad h so the delay removal index is integral
    n_pre_pad = (down - half_len % down) % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h = np.concatenate([np.zeros(n_pre_pad, np.float32), h])

    flat = np.asarray(audio, dtype=np.float32).reshape(-1, audio.shape[-1])
    n_in = audio.shape[-1]
    n_out = -(-n_in * up // down)

    def out_len(n_h):
        return -(-((n_in - 1) * up + n_h) // down)

    # grow the post-pad until the upfirdn output covers the removal window
    n_post_pad = 0
    while out_len(len(h) + n_post_pad) < n_out + n_pre_remove:
        n_post_pad += down
    if n_post_pad:
        h = np.concatenate([h, np.zeros(n_post_pad, np.float32)])

    outs = [upfirdn_native(row, h, up, down)[n_pre_remove:n_pre_remove + n_out]
            for row in flat]
    return np.stack(outs).reshape(*audio.shape[:-1], n_out)


def mono_mix_normalize_native(audio: np.ndarray) -> np.ndarray:
    """(channels, samples) -> (1, samples): the channel mean, divided by its
    peak when the peak exceeds 1."""
    lib = load()
    x = np.ascontiguousarray(audio, dtype=np.float32)
    ch, n = x.shape
    out = np.empty(n, dtype=np.float32)
    rc = lib.mono_mix_normalize_f32(x.ctypes.data_as(_FLOAT_P), ch, n,
                                    out.ctypes.data_as(_FLOAT_P))
    if rc != 0:
        raise RuntimeError(f"mono_mix_normalize_f32 failed ({rc})")
    return out[None]
