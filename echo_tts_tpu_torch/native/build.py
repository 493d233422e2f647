"""Build and load the native resampler (counterpart of
echo_tts_tpu/native/build.py).

`resample.cc` is compiled at first use with
`g++ -O3 -march=native -shared -fPIC` into
`build/echo_tts_tpu_torch/libecho_native-<hash>.so` at the repo root, the
hash taken over the source, the flags and the host CPU's model and flags
(`-march=native` code does not move between machines), so an edited source
or another CPU rebuilds (as `ops/_build.py` keys the CUDA sources). The JAX package's own
`libecho_native.so` is never loaded. A failed build raises with the
compiler's output; there is no fall back here (`pipeline/audio_io.py`
decides what a caller without a compiler gets).

    python -m echo_tts_tpu_torch.native.build    # build, print the path
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "resample.cc"
BUILD_DIR = _DIR.parent.parent / "build" / "echo_tts_tpu_torch"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_identity() -> bytes:
    """The host CPU's model name and feature flags, what -march=native
    compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        return platform.processor().encode()


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode() + _cpu_identity())
    return BUILD_DIR / f"libecho_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile resample.cc unless its hashed library exists; its path."""
    with _lock:
        out = lib_path()
        if out.exists():
            return out
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native resampler cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.upfirdn_f32.restype = ctypes.c_int
    lib.upfirdn_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.mono_mix_normalize_f32.restype = ctypes.c_int
    lib.mono_mix_normalize_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return _lib


if __name__ == "__main__":
    print(build())
