"""Host-side audio I/O: WAV read/write, resampling and decoding (counterpart
of echo_tts_tpu/pipeline/audio_io.py).

Stdlib WAV codec and scipy's polyphase resampler (kaiser 5.0). The JAX
package's native upfirdn and libmpg123 routes are not ported yet: every
resample goes through scipy, and an .mp3 goes to `decode_with_ffmpeg`, as
the JAX package falls back when libmpg123 is absent.
"""
from __future__ import annotations

import shutil
import subprocess
import wave
from math import gcd
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 (channels, samples) in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    return x.reshape(-1, ch).T.copy(), sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 44100) -> None:
    """audio: (channels, samples) or (samples,) float in [-1, 1] -> 16-bit PCM."""
    a = np.asarray(audio, dtype=np.float32)
    if a.ndim == 1:
        a = a[None]
    a = np.clip(a, -1.0, 1.0)
    pcm = (a.T * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(a.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def resample(audio: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    """Polyphase resampling on the last axis: scipy.signal.resample_poly with
    a kaiser(5.0) window, the design the JAX package's native core matches."""
    if sr_from == sr_to:
        return audio
    from scipy.signal import resample_poly

    g = gcd(sr_from, sr_to)
    return resample_poly(audio, sr_to // g, sr_from // g, axis=-1,
                         window=("kaiser", 5.0)).astype(np.float32)


def decode_with_ffmpeg(path: str, max_duration: float) -> Tuple[np.ndarray, int]:
    """Compressed-format decode through the ffmpeg command line when it is
    installed; mono float32 at 44.1 kHz."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            f"cannot decode {path!r}: only WAV is decoded natively and no "
            "ffmpeg binary is on PATH (install ffmpeg for mp3/flac/ogg)")
    sr = 44100
    cmd = ["ffmpeg", "-v", "error", "-t", str(max_duration), "-i", path,
           "-f", "f32le", "-ac", "1", "-ar", str(sr), "-"]
    raw = subprocess.run(cmd, check=True, capture_output=True).stdout
    return np.frombuffer(raw, dtype=np.float32).reshape(1, -1).copy(), sr


def load_audio(path: str, max_duration: float = 300.0,
               target_sr: int = 44100) -> np.ndarray:
    """Decode, truncate to max_duration, mix to mono, resample to 44.1 kHz,
    peak-normalise only if the peak exceeds 1. Returns (1, samples) float32.
    WAV is decoded here; every other format (.mp3 included, until the
    libmpg123 route is ported) goes through ffmpeg."""
    if path.lower().endswith(".wav"):
        x, sr = read_wav(path)
    else:
        x, sr = decode_with_ffmpeg(path, max_duration)
    x = x[:, : int(max_duration * sr)]
    x = x.mean(axis=0, keepdims=True)
    x = resample(x, sr, target_sr)
    peak = np.abs(x).max(initial=0.0)
    if peak > 1.0:
        x = x / peak
    return x.astype(np.float32)
