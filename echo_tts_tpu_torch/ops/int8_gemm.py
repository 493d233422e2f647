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
not take raises. `int8_gemm.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

_OUT_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.int32: 2}


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


_FN = None


def _fn():
    global _FN
    if _FN is None:
        from echo_tts_tpu_torch.ops import _build

        f = _build.load("int8_gemm").int8_gemm
        vp, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
        f.restype = i
        _FN = f
    return _FN


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} for the CUDA kernel, got {x.dtype}")
    if tuple(x.shape) != shape or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned {shape}, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")


def _int8_gemm_cuda(a, s_row, w, s_col, out_dtype):
    dev = a.device
    if a.dim() != 2 or w.dim() != 2:
        raise ValueError(f"a (M, K) and w (N, K) must be 2-D, got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = a.shape
    n = w.shape[0]
    if k < 16 or k % 16 or n < 1:
        raise ValueError(f"the kernel takes K a multiple of 16 and N >= 1, got (M, K, N) = "
                         f"({m}, {k}, {n})")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"out_dtype must be bfloat16, float32 or int32, got {out_dtype}")
    _check("a", a, torch.int8, (m, k), dev)
    _check("w", w, torch.int8, (n, k), dev)
    _check("s_row", s_row, torch.float32, (m,), dev)
    _check("s_col", s_col, torch.float32, (n,), dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    err = _fn()(a.data_ptr(), w.data_ptr(), s_row.data_ptr(), s_col.data_ptr(), out.data_ptr(),
                m, n, k, _OUT_CODE[out_dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_gemm kernel launch failed: CUDA error {err}")
    int8_gemm.launches += 1
    return out


def int8_gemm(a: torch.Tensor, s_row: torch.Tensor, w: torch.Tensor, s_col: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """a (M, K) int8, s_row (M,) fp32, w (N, K) int8, s_col (N,) fp32 ->
    (M, N) in out_dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if a.device.type == "cpu":
        return int8_gemm_plain(a, s_row, w, s_col, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    return _int8_gemm_cuda(a, s_row, w, s_col, out_dtype)


int8_gemm.launches = 0
