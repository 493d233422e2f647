"""Kernel K4: the int8 GEMM of the W8A8 trunk, with the dequantize epilogue.

Counterpart of `echo_tts_tpu/models/quant.py:qdot` (an int8 x int8 -> int32
`dot_general` that XLA fuses with its dequantize; the JAX package has no
Pallas kernel here). For int8 rows a (M, K) with fp32 scales s_row (M,) and
a quantized weight stored K-major, w (N, K) with fp32 scales s_col (N,):

    out[m, n] = out_dtype(float(sum_k a[m, k] · w[n, k]) · (s_row[m] · s_col[n]))

The int32 sum is exact and the scale product is taken first, as JAX does, so
the kernel equals the plain version bit for bit. `out_dtype` is bfloat16 or
float32; int32 returns the raw sums (the check of the sums on the card).

`int8_gemm` runs the hand-written CUDA kernel (`csrc/int8_gemm.cu`) for
CUDA tensors and `int8_gemm_plain` for CPU tensors; anything the kernel does
not take raises. `int8_gemm_grouped` takes up to `MAX_GROUPS` weights that
share the activation in one launch (each with its own scales and output);
its plain version is the plain GEMM in a loop. `int8_gemm.launches` counts
kernel launches of both. `core_products_s8` runs the kernel's `wgmma` s8
core bare on one tile (`chip_smoke.py` phase 3).
"""
from __future__ import annotations

import ctypes

import torch

_OUT_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.int32: 2}
MAX_GROUPS = 4
# the kernel's tile shapes (rows, columns) by code; None lets it pick by M
TILES = ((128, 256), (128, 128), (64, 256), (64, 128))


def int8_gemm_plain(a: torch.Tensor, s_row: torch.Tensor, w: torch.Tensor,
                    s_col: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The same function in torch ops. The sums are exact: int32 on the CPU;
    float64 on a card (whose matmul takes no integers), exact while
    K·127² < 2⁵³."""
    if a.device.type == "cpu":
        acc = a.int() @ w.int().t()
    else:
        acc = (a.double() @ w.double().t()).to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    return (acc.float() * (s_row.float()[:, None] * s_col.float()[None, :])).to(out_dtype)


def int8_gemm_grouped_plain(a: torch.Tensor, s_row: torch.Tensor, ws: list,
                            out_dtype: torch.dtype) -> list:
    """The grouped product in torch ops: the plain GEMM once a weight."""
    return [int8_gemm_plain(a, s_row, w, s_col, out_dtype) for w, s_col in ws]


_FN = None
_CHECK_FN = None


def _fn():
    global _FN
    if _FN is None:
        from echo_tts_tpu_torch.ops import _build

        f = _build.load("int8_gemm").int8_gemm
        vp, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, vp, i, i, i] + [vp] * 12 + [i] * 4 + [i, i, vp]
        f.restype = i
        _FN = f
    return _FN


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, index: int) -> None:
    """x on the card `index`, of `dtype` and `shape`, contiguous and 16-byte
    aligned (cheap accessors only: this runs for every tensor of a call)."""
    if x.get_device() != index:
        raise ValueError(f"{name} is on {x.device}, expected cuda:{index}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} for the CUDA kernel, got {x.dtype}")
    if x.shape != shape or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned {shape}, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")


def _check_group(a: torch.Tensor, ws: list) -> None:
    """What any device refuses: no weights, more than one launch takes, an
    operand that is not 2-D, a weight whose K is not the activation's."""
    if not 1 <= len(ws) <= MAX_GROUPS:
        raise ValueError(f"int8_gemm_grouped takes 1 to {MAX_GROUPS} weights, got {len(ws)}")
    for w, _ in ws:
        if w.dim() != 2 or a.dim() != 2 or w.shape[1] != a.shape[1]:
            raise ValueError(f"a (M, K) and every w (N, K) must be 2-D with one K, got "
                             f"{tuple(a.shape)} and {tuple(w.shape)}")


def _int8_gemm_cuda(a, s_row, ws, out_dtype, tile):
    _check_group(a, ws)
    dev, index = a.device, a.get_device()
    m, k = a.shape
    if k < 16 or k % 16 or any(w.shape[0] < 1 for w, _ in ws):
        raise ValueError(f"the kernel takes K a multiple of 16 and N >= 1, got (M, K, N) = "
                         f"({m}, {k}, {[w.shape[0] for w, _ in ws]})")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"out_dtype must be bfloat16, float32 or int32, got {out_dtype}")
    if tile is not None and tile not in TILES:
        raise ValueError(f"tile must be None or one of {TILES}, got {tile}")
    _check("a", a, torch.int8, (m, k), index)
    _check("s_row", s_row, torch.float32, (m,), index)
    for w, s_col in ws:
        n = w.shape[0]
        _check("w", w, torch.int8, (n, k), index)
        _check("s_col", s_col, torch.float32, (n,), index)
    outs = [torch.empty((m, w.shape[0]), dtype=out_dtype, device=dev) for w, _ in ws]
    pad = MAX_GROUPS - len(ws)
    wp = [w.data_ptr() for w, _ in ws] + [None] * pad
    sp = [s.data_ptr() for _, s in ws] + [None] * pad
    op = [o.data_ptr() for o in outs] + [None] * pad
    ns = [w.shape[0] for w, _ in ws] + [0] * pad
    err = _fn()(a.data_ptr(), s_row.data_ptr(), m, k, len(ws), *wp, *sp, *op, *ns,
                _OUT_CODE[out_dtype], -1 if tile is None else TILES.index(tile),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_gemm kernel launch failed: CUDA error {err}")
    int8_gemm.launches += 1
    return outs


def _on_cuda(a: torch.Tensor) -> bool:
    if a.is_cuda:
        return True
    if a.device.type != "cpu":
        raise ValueError(f"unsupported device {a.device}")
    return False


def int8_gemm(a: torch.Tensor, s_row: torch.Tensor, w: torch.Tensor, s_col: torch.Tensor,
              out_dtype: torch.dtype, tile=None) -> torch.Tensor:
    """a (M, K) int8, s_row (M,) fp32, w (N, K) int8, s_col (N,) fp32 ->
    (M, N) in out_dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise. `tile` (one of TILES) overrides the
    kernel's choice of tile shape; the result is the same bits."""
    if not _on_cuda(a):
        return int8_gemm_plain(a, s_row, w, s_col, out_dtype)
    return _int8_gemm_cuda(a, s_row, [(w, s_col)], out_dtype, tile)[0]


def int8_gemm_grouped(a: torch.Tensor, s_row: torch.Tensor, ws: list,
                      out_dtype: torch.dtype, tile=None) -> list:
    """a (M, K) int8 and s_row (M,) against 1..MAX_GROUPS weights `ws`, a
    list of (w (N_i, K) int8, s_col (N_i,) fp32) -> [(M, N_i)] in
    out_dtype, each its own tensor, in one launch on a card."""
    ws = list(ws)
    if not _on_cuda(a):
        _check_group(a, ws)
        return int8_gemm_grouped_plain(a, s_row, ws, out_dtype)
    return _int8_gemm_cuda(a, s_row, ws, out_dtype, tile)


int8_gemm.launches = 0


def core_products_s8(a: torch.Tensor, b: torch.Tensor, use_tma: bool) -> torch.Tensor:
    """a (64, 128) int8 . b (N, 128)ᵀ -> (64, N) int32, N in 64/128/256,
    from four k32 slices of the kernel's `wgmma` s8 on one warpgroup, the
    tiles copied into swizzled shared memory by the threads or by TMA. On
    no model path; needs a CUDA card."""
    global _CHECK_FN
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"core_products_s8 needs CUDA tensors, got {dev}")
    n = b.shape[0]
    for name, x, shape in (("a", a, (64, 128)), ("b", b, (n, 128))):
        if (x.device != dev or x.dtype != torch.int8 or tuple(x.shape) != shape
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous int8 {shape} on {dev}")
    if n not in (64, 128, 256):
        raise ValueError(f"N must be 64, 128 or 256, got {n}")
    if _CHECK_FN is None:
        from echo_tts_tpu_torch.ops import _build

        f = _build.load("int8_gemm").int8_core_check
        vp = ctypes.c_void_p
        f.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int, vp]
        f.restype = ctypes.c_int
        _CHECK_FN = f
    out = torch.empty((64, n), dtype=torch.int32, device=dev)
    err = _CHECK_FN(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, int(bool(use_tma)),
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_core_check launch failed: CUDA error {err}")
    return out


def tensor_map_us(a: torch.Tensor, reps: int = 1000) -> float:
    """Host microseconds to encode one TMA tensor map of the (rows, K) int8
    matrix a, as K4 does for its activation and each weight on every call
    (the mean of `reps`, timed inside the library)."""
    from echo_tts_tpu_torch.ops import _build

    f = _build.load("int8_gemm").int8_tensor_map_us
    f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    f.restype = ctypes.c_double
    us = f(a.data_ptr(), a.shape[0], a.shape[1], reps)
    if us < 0:
        raise RuntimeError("cuTensorMapEncodeTiled failed")
    return us
