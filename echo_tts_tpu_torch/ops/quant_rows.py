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

Two more modes serve the row-sharded products of tensor parallelism, where
a row's amax must be taken over the whole K that the tp ranks share
(`models/quant.py:mm` with a group): `quant_rows_scale` gives the scales
alone, and `quant_rows_at` the codes at given scales (the max of the ranks'
scales is the scale of the whole row, since max(·, 1e-8) / 127 is
monotone). Each equals its part of `quant_rows_plain` bit for bit;
`quant_rows_scale.launches` and `quant_rows_at.launches` count them.
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


def quant_rows_scale_plain(h: torch.Tensor) -> torch.Tensor:
    """(…, D) -> fp32 scales (…, 1), as `quant_rows_plain` computes them."""
    return torch.clamp_min(h.float().abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0


def quant_rows_at_plain(h: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(…, D) at fp32 scales (…, 1) -> int8 codes, as `quant_rows_plain`
    computes them from its own scales."""
    return torch.clamp(torch.round(h.float() / s), -127, 127).to(torch.int8)


_FNS = {}


def _fn(name: str = "quant_rows"):
    """The kernel's C entry: quant_rows (h, q, s), quant_rows_scale (h, s)
    or quant_rows_at (h, s, q), each then (M, D, bf16, stream)."""
    if name not in _FNS:
        from echo_tts_tpu_torch.ops import _build

        f = getattr(_build.load("quant_rows"), name)
        vp, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp] * (3 if name != "quant_rows_scale" else 2) + [i, i, i, vp]
        f.restype = i
        _FNS[name] = f
    return _FNS[name]


def _rows(h: torch.Tensor) -> torch.Tensor:
    """h as the kernel's contiguous (M, D) rows, or raise."""
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"h must be bfloat16 or float32 for the CUDA kernel, got {h.dtype}")
    if h.dim() < 1 or h.shape[-1] < 1 or h.shape[-1] % 8:
        raise ValueError(f"the kernel takes (…, D) with D a multiple of 8, got shape "
                         f"{tuple(h.shape)}")
    x = h.reshape(-1, h.shape[-1]).contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the kernel takes a 16-byte aligned h")
    return x


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _quant_rows_cuda(h: torch.Tensor):
    x = _rows(h)
    m, d = x.shape
    q = torch.empty(x.shape, dtype=torch.int8, device=h.device)
    s = torch.empty((m,), dtype=torch.float32, device=h.device)
    err = _fn()(x.data_ptr(), q.data_ptr(), s.data_ptr(), m, d, int(h.dtype == torch.bfloat16),
                torch.cuda.current_stream(h.device).cuda_stream)
    _check_launch(err, "quant_rows")
    quant_rows.launches += 1
    return q.reshape(h.shape), s.reshape(*h.shape[:-1], 1)


def _on_cuda(h: torch.Tensor) -> bool:
    if h.is_cuda:
        if torch.is_grad_enabled() and h.requires_grad:
            raise RuntimeError("quant_rows: kernel K5 has no backward (int8 is inference "
                               "only); call it under torch.no_grad()")
        return True
    if h.device.type != "cpu":
        raise ValueError(f"unsupported device {h.device}")
    return False


def quant_rows(h: torch.Tensor):
    """(…, D) -> (int8 codes (…, D), fp32 scales (…, 1)). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise. No
    gradient: int8 is inference only."""
    if not _on_cuda(h):
        return quant_rows_plain(h)
    return _quant_rows_cuda(h)


def quant_rows_scale(h: torch.Tensor) -> torch.Tensor:
    """(…, D) -> fp32 scales (…, 1), max(amax |h|, 1e-8) / 127 a row: K5's
    scale-only mode on a card, the plain version on the CPU."""
    if not _on_cuda(h):
        return quant_rows_scale_plain(h)
    x = _rows(h)
    m, d = x.shape
    s = torch.empty((m,), dtype=torch.float32, device=h.device)
    err = _fn("quant_rows_scale")(x.data_ptr(), s.data_ptr(), m, d,
                                  int(h.dtype == torch.bfloat16),
                                  torch.cuda.current_stream(h.device).cuda_stream)
    _check_launch(err, "quant_rows_scale")
    quant_rows_scale.launches += 1
    return s.reshape(*h.shape[:-1], 1)


def quant_rows_at(h: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(…, D) at given fp32 scales s (…, 1) -> int8 codes
    clip(round_half_even(h / s), -127, 127): K5's codes-at-a-scale mode on a
    card, the plain version on the CPU."""
    if not _on_cuda(h):
        return quant_rows_at_plain(h, s)
    x = _rows(h)
    m, d = x.shape
    if s.dtype != torch.float32 or s.numel() != m or s.device != h.device:
        raise ValueError(f"s must be fp32 with one scale a row ({m}) on {h.device}, got "
                         f"{s.dtype} {tuple(s.shape)} on {s.device}")
    sc = s.reshape(m).contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=h.device)
    err = _fn("quant_rows_at")(x.data_ptr(), sc.data_ptr(), q.data_ptr(), m, d,
                               int(h.dtype == torch.bfloat16),
                               torch.cuda.current_stream(h.device).cuda_stream)
    _check_launch(err, "quant_rows_at")
    quant_rows_at.launches += 1
    return q.reshape(h.shape)


quant_rows.launches = 0
quant_rows_scale.launches = 0
quant_rows_at.launches = 0
