"""MP3 decode and encode on the system libmpg123 / libmp3lame through ctypes
(counterpart of echo_tts_tpu/native/mp3_py.py).

Host CPU work, off the device. Both libraries are optional, as in the JAX
package: a loader that finds no library returns None, `decode_mp3` then
returns None (`pipeline/audio_io.py:load_audio` tries ffmpeg next) and
`encode_mp3` returns False (the server sends WAV instead). Each library is
loaded and, for libmpg123, initialised exactly once, under a lock, however
many threads (the dataset's decode workers, the server's request threads)
reach it first at the same time.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional, Tuple

import numpy as np

# mpg123 constants (mpg123.h)
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_MONO = 1
_MPG123_STEREO = 2
_MP3_RATES = (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000)

_mpg123 = None
_lame = None
# double-checked init lock: the dataset's decode threads can race the first
# decode, and mpg123_init must run exactly once before any handle exists
_init_lock = threading.Lock()


def _load_mpg123():
    global _mpg123
    if _mpg123 is not None:
        return _mpg123 or None
    with _init_lock:
        return _load_mpg123_locked()


def _load_mpg123_locked():
    global _mpg123
    if _mpg123 is not None:
        return _mpg123 or None
    try:
        name = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
        lib = ctypes.CDLL(name)
        lib.mpg123_init.restype = ctypes.c_int
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.restype = ctypes.c_int
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_format_none.restype = ctypes.c_int
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.restype = ctypes.c_int
        lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_int, ctypes.c_int]
        lib.mpg123_getformat.restype = ctypes.c_int
        lib.mpg123_getformat.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_long),
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_read.restype = ctypes.c_int
        lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_size_t)]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_init()
        _mpg123 = lib
    except OSError:
        _mpg123 = False
    return _mpg123 or None


def _load_lame():
    global _lame
    if _lame is not None:
        return _lame or None
    with _init_lock:
        return _load_lame_locked()


def _load_lame_locked():
    global _lame
    if _lame is not None:
        return _lame or None
    try:
        name = ctypes.util.find_library("mp3lame") or "libmp3lame.so.0"
        lib = ctypes.CDLL(name)
        lib.lame_init.restype = ctypes.c_void_p
        for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
                   "lame_set_brate", "lame_set_quality", "lame_set_mode"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lame_init_params.restype = ctypes.c_int
        lib.lame_init_params.argtypes = [ctypes.c_void_p]
        lib.lame_encode_buffer_ieee_float.restype = ctypes.c_int
        lib.lame_encode_buffer_ieee_float.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        lib.lame_encode_flush.restype = ctypes.c_int
        lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int]
        lib.lame_close.argtypes = [ctypes.c_void_p]
        _lame = lib
    except OSError:
        _lame = False
    return _lame or None


def mp3_available() -> bool:
    return _load_mpg123() is not None


def mp3_encode_available() -> bool:
    return _load_lame() is not None


def decode_mp3(path: str, max_duration: Optional[float] = None
               ) -> Optional[Tuple[np.ndarray, int]]:
    """Decode an MP3 file -> (float32 (channels, samples) in [-1, 1], rate).

    Returns None when libmpg123 is unavailable; raises on decode errors.
    `max_duration` stops reading once that many seconds are decoded.
    """
    lib = _load_mpg123()
    if lib is None:
        return None
    err = ctypes.c_int(0)
    mh = lib.mpg123_new(None, ctypes.byref(err))
    if not mh:
        raise RuntimeError(f"mpg123_new failed (code {err.value})")
    try:
        if lib.mpg123_open(mh, path.encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123 cannot open {path!r}")
        # accept float32 output at any MPEG rate, mono or stereo
        lib.mpg123_format_none(mh)
        for r in _MP3_RATES:
            lib.mpg123_format(mh, r, _MPG123_MONO | _MPG123_STEREO,
                              _MPG123_ENC_FLOAT_32)
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        lib.mpg123_getformat(mh, ctypes.byref(rate), ctypes.byref(channels),
                             ctypes.byref(enc))
        buf = ctypes.create_string_buffer(1 << 20)
        done = ctypes.c_size_t(0)
        chunks = []
        total = 0
        limit = None
        while True:
            rc = lib.mpg123_read(mh, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(buf.raw[: done.value],
                                            dtype=np.float32).copy())
                total += chunks[-1].size
            if rc == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(mh, ctypes.byref(rate),
                                     ctypes.byref(channels), ctypes.byref(enc))
                continue
            if rc == _MPG123_DONE:
                break
            if rc != _MPG123_OK:
                raise RuntimeError(f"mpg123_read error {rc} on {path!r}")
            if limit is None and max_duration is not None and rate.value:
                limit = int(max_duration * rate.value) * max(channels.value, 1)
            if limit is not None and total >= limit:
                break
        if not chunks:
            raise RuntimeError(f"no audio decoded from {path!r}")
        x = np.concatenate(chunks)
        ch = max(channels.value, 1)
        x = x[: (x.size // ch) * ch].reshape(-1, ch).T
        if max_duration is not None and rate.value:
            x = x[:, : int(max_duration * rate.value)]
        return x.copy(), int(rate.value)
    finally:
        lib.mpg123_close(mh)
        lib.mpg123_delete(mh)


def encode_mp3(path: str, audio: np.ndarray, sample_rate: int = 44100,
               bitrate_kbps: int = 192) -> bool:
    """Encode (channels, samples) or (samples,) float32 in [-1, 1] to MP3.

    Returns False when libmp3lame is unavailable (the caller falls back to
    WAV); True on success.
    """
    lib = _load_lame()
    if lib is None:
        return False
    a = np.ascontiguousarray(np.asarray(audio, np.float32))
    if a.ndim == 1:
        a = a[None]
    if a.shape[0] > 2:
        raise ValueError(f"mp3 supports <=2 channels, got {a.shape[0]}")
    n = a.shape[1]
    gfp = lib.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, int(sample_rate))
        lib.lame_set_num_channels(gfp, a.shape[0])
        lib.lame_set_brate(gfp, int(bitrate_kbps))
        lib.lame_set_quality(gfp, 2)
        if a.shape[0] == 1:
            lib.lame_set_mode(gfp, 3)  # MONO
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError("lame_init_params failed")
        left = a[0]
        right = a[1] if a.shape[0] == 2 else a[0]
        out = ctypes.create_string_buffer(int(1.25 * n) + 7200)
        fptr = ctypes.POINTER(ctypes.c_float)
        nw = lib.lame_encode_buffer_ieee_float(
            gfp, left.ctypes.data_as(fptr), right.ctypes.data_as(fptr), n,
            out, len(out))
        if nw < 0:
            raise RuntimeError(f"lame_encode_buffer failed ({nw})")
        data = out.raw[:nw]
        nf = lib.lame_encode_flush(gfp, out, len(out))
        if nf < 0:
            raise RuntimeError(f"lame_encode_flush failed ({nf})")
        data += out.raw[:nf]
        with open(path, "wb") as f:
            f.write(data)
        return True
    finally:
        lib.lame_close(gfp)
