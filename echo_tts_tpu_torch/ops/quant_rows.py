"""Kernel K5: dynamic per-row int8 quantization of the trunk's activations.

Counterpart of `echo_tts_tpu/models/quant.py:quant_rows`, which XLA fuses
into the int8 dot that follows it; the JAX package has no Pallas kernel here.
For h (…, D) in bf16 or fp32, cast to fp32, per row:

    s = max(amax |h|, 1e-8) / 127            (fp32)
    q = clip(round_half_even(h / s), -127, 127)   (int8)

`quant_rows` runs the hand-written CUDA kernel (`csrc/quant_rows.cu`) for
CUDA tensors and `quant_rows_plain` for CPU tensors; anything the kernel
does not take raises. `quant_rows.launches` counts kernel launches. The
kernel's codes are `rintf` of the IEEE quotient (the build has no fast
math): it multiplies by 1 / s, which lies within 1e-4 of the quotient, and
divides only where that product is so close to a half-integer that the two
could round apart; so its codes and scales equal the plain version's bit
for bit. Rows of the widths the trunk and the encoders
quantize (`one_read`: D = 1280, 2048, 3328, 5888) are read once and held in
registers; any other D (a multiple of 8) is read twice.
"""
from __future__ import annotations

import ctypes

import torch

# the kernel's (chunks a lane, warps a row) instances that hold a row in
# registers: D = 1280, 2048, 3328, 5888 in each type
ONE_READ = {torch.bfloat16: {(3, 2), (4, 2), (4, 4), (3, 8)},
            torch.float32: {(3, 4), (4, 4), (4, 8), (6, 8)}}


def one_read(d: int, dtype: torch.dtype) -> bool:
    """Whether the kernel reads rows of width d once (held in registers):
    the least of 1, 2, 4, 8 warps a row that leaves a lane at most four
    16-byte chunks, and an instance for that split."""
    if d < 8 or d % 8 or dtype not in ONE_READ:
        return False
    chunks = d * dtype.itemsize // 16
    wpr = 1
    while wpr < 8 and chunks > 4 * 32 * wpr:
        wpr *= 2
    return (-(-chunks // (32 * wpr)), wpr) in ONE_READ[dtype]


def quant_rows_plain(h: torch.Tensor):
    """(…, D) -> (int8 (…, D), fp32 scale (…, 1)) in torch ops, fp32."""
    hf = h.float()
    s = torch.clamp_min(hf.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0
    q = torch.clamp(torch.round(hf / s), -127, 127).to(torch.int8)
    return q, s


_FN = None


def _fn():
    global _FN
    if _FN is None:
        from echo_tts_tpu_torch.ops import _build

        f = _build.load("quant_rows").quant_rows
        vp, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, vp, vp, i, i, i, vp]
        f.restype = i
        _FN = f
    return _FN


def _quant_rows_cuda(h: torch.Tensor):
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"h must be bfloat16 or float32 for the CUDA kernel, got {h.dtype}")
    if h.dim() < 1 or h.shape[-1] < 1 or h.shape[-1] % 8:
        raise ValueError(f"the kernel takes (…, D) with D a multiple of 8, got shape "
                         f"{tuple(h.shape)}")
    d = h.shape[-1]
    x = h.reshape(-1, d).contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the kernel takes a 16-byte aligned h")
    m = x.shape[0]
    q = torch.empty(x.shape, dtype=torch.int8, device=h.device)
    s = torch.empty((m,), dtype=torch.float32, device=h.device)
    err = _fn()(x.data_ptr(), q.data_ptr(), s.data_ptr(), m, d, int(h.dtype == torch.bfloat16),
                torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_rows kernel launch failed: CUDA error {err}")
    quant_rows.launches += 1
    return q.reshape(h.shape), s.reshape(*h.shape[:-1], 1)


def quant_rows(h: torch.Tensor):
    """(…, D) -> (int8 codes (…, D), fp32 scales (…, 1)). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise. No
    gradient: int8 is inference only."""
    if not h.is_cuda:
        if h.device.type != "cpu":
            raise ValueError(f"unsupported device {h.device}")
        return quant_rows_plain(h)
    if torch.is_grad_enabled() and h.requires_grad:
        raise RuntimeError("quant_rows: kernel K5 has no backward (int8 is inference only); "
                           "call it under torch.no_grad()")
    return _quant_rows_cuda(h)


quant_rows.launches = 0
