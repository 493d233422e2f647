"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled at first use
into `build/echo_tts_tpu_torch/lib<name>-<hash>.so` at the repo root
(`-gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC -I csrc`).
The file name carries a hash of the source and of every `csrc/*.cuh` it
includes (directly or through another header), so an edited source or header
rebuilds. `BUILD_SECONDS` records what each nvcc run of this process took.
A failed build raises; there is no fall back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "echo_tts_tpu_torch"
KERNELS = ("joint_attention", "joint_attention_bwd", "res_chain",
           "joint_attention_variants", "res_chain_variants", "attention_core_check",
           "conv_core_check", "int8_gemm", "quant_rows", "trunk_rows", "trunk_rows_bwd")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}  # nvcc wall seconds per source built by this process
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def local_includes(path: Path) -> List[str]:
    """The names in a source's `#include "..."` lines."""
    return _INCLUDE.findall(path.read_text())


def source_files(name: str) -> List[Path]:
    """`csrc/<name>.cu` and every file of `csrc/` it includes with quotes,
    directly or through another header, in a fixed order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc for inc in local_includes(path)]
    return [seen[0]] + sorted(seen[1:])


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compile(name: str) -> Path:
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every kernel source in parallel (one nvcc each)."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        paths = list(ex.map(_compile, names))
    return dict(zip(names, paths))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            _LIBS[name] = lib
        return lib
