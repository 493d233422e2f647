"""Kernel K2: the causal residual-unit chain of the S1-DAC conv stacks.

Counterpart of `echo_tts_tpu/ops/pallas_conv.py` (`fused_res_chain_cl`,
`res_units_cl`, `chain_ctx`, `_sin2`) and of the channels-last helpers of
`echo_tts_tpu/models/s1dac.py` (`_snake_cl`, `_causal_conv_shifted_cl`,
`_residual_unit_cl`).

A unit is `x + conv1x1(snake(conv7_dilated_causal(snake(x))))` on
channels-last (B, T, C); a chain runs units with dilations (1, 3, 9). Rows
`t < zero_below` (a scalar or one value per batch row) stand for the causal
zero pad and are re-zeroed after every unit.

`res_units_cl` runs the hand-written CUDA kernel (`csrc/res_chain.cu`, two
launches per unit) for CUDA tensors and the plain PyTorch version for CPU
tensors; anything the kernel does not take raises. `res_units_cl.launches`
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

# sin²(t) as a range-reduced polynomial: r = t/π, f = r - round(r),
# z = f², sin²(t) = z·P(z) with a degree-6 least-squares P (max |err| 2.3e-10)
_INV_PI = 0.3183098861837907
_SIN2_P = (9.869604400158666, -32.469696645585955, 42.72838511692447,
           -30.12175436025362, 13.206610352068088, -3.9130777124895926,
           0.7419801209608292)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _sin2(t: torch.Tensor) -> torch.Tensor:
    """fp32 sin² by the polynomial; torch.round rounds half to even, as
    jnp.round does."""
    r = t * _INV_PI
    f = r - torch.round(r)
    z = f * f
    p = torch.full_like(z, _SIN2_P[-1])
    for c in _SIN2_P[-2::-1]:
        p = p * z + c
    return z * p


def snake_cl(x_cl: torch.Tensor, alpha_flat: torch.Tensor) -> torch.Tensor:
    """Channels-last snake x + sin²(αx)/(α+1e-9): fp32 inside, x's dtype out."""
    xf = x_cl.float()
    af = alpha_flat.float()
    return (xf + (1.0 / (af + 1e-9)) * _sin2(af * xf)).to(x_cl.dtype)


def causal_conv_shifted_cl(x_cl: torch.Tensor, w: torch.Tensor, b, *,
                           kernel_size: int, dilation: int) -> torch.Tensor:
    """Stride-1 causal conv on channels-last (B, T, C) as kernel_size
    accumulated shifted matmuls. w: (O, I, K) torch layout."""
    k_eff = (kernel_size - 1) * dilation + 1
    xp = torch.nn.functional.pad(x_cl, (0, 0, k_eff - 1, 0))
    wt = w.permute(2, 1, 0)  # (K, I, O)
    t = x_cl.shape[1]
    out = None
    for j in range(kernel_size):
        o = xp[:, j * dilation:j * dilation + t] @ wt[j]
        out = o if out is None else out + o
    if b is not None:
        out = out + b
    return out


def residual_unit_cl(x_cl: torch.Tensor, p: dict, *, dilation: int) -> torch.Tensor:
    """x + conv1x1(snake(conv7(snake(x)))), rounded to x's dtype where the
    Pallas kernel rounds (`_res_chain_kernel`): after snake1, after snake2
    and after the residual sum; taps, biases and snake2 run in fp32."""
    def f32(t):
        return None if t is None else t.float()

    dtype = x_cl.dtype
    y = snake_cl(x_cl, p["snake1"].reshape(-1)).float()
    y = causal_conv_shifted_cl(y, f32(p["conv1"]["w"]), f32(p["conv1"].get("b")),
                               kernel_size=7, dilation=dilation)
    y = snake_cl(y, p["snake2"].reshape(-1)).to(dtype).float()
    y = causal_conv_shifted_cl(y, f32(p["conv2"]["w"]), f32(p["conv2"].get("b")),
                               kernel_size=1, dilation=1)
    return (x_cl.float() + y).to(dtype)


def chain_ctx(dilations: Sequence[int] = (1, 3, 9), kernel_size: int = 7) -> int:
    """Left-context rows a residual-unit chain needs for exact streaming
    (the Pallas kernel's halo: receptive extent rounded up to 16)."""
    return _round_up(sum((kernel_size - 1) * d for d in dilations), 16)


def _zero_below_rows(zero_below, b: int, device) -> Optional[torch.Tensor]:
    if zero_below is None:
        return None
    zb = torch.as_tensor(zero_below, dtype=torch.int32, device=device).reshape(-1)
    return zb.expand(b).contiguous()


def res_chain_plain(x: torch.Tensor, units: Sequence[dict],
                    dilations: Sequence[int] = (1, 3, 9),
                    zero_below=None) -> torch.Tensor:
    """Per unit: snake, shifted-matmul conv, residual, then rows
    t < zero_below re-zeroed."""
    zb = _zero_below_rows(zero_below, x.shape[0], x.device)
    dead = None
    if zb is not None:
        dead = torch.arange(x.shape[1], device=x.device)[None, :, None] < zb[:, None, None]
    for u, d in zip(units, dilations, strict=True):
        x = residual_unit_cl(x, u, dilation=d)
        if dead is not None:
            x = x.masked_fill(dead, 0)
    return x


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------

_FN = None


def _fn():
    global _FN
    if _FN is None:
        from echo_tts_tpu_torch.ops import _build

        f = _build.load("res_chain").res_unit_fwd
        vp, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp] * 12 + [i, i, i, i, vp]
        f.restype = i
        _FN = f
    return _FN


def _unit_operands(u: dict, c: int, device):
    """Kernel-layout operands of one unit: conv7 (O, I, 7) -> (7, I, O) and
    conv1x1 (O, I, 1) -> (I, O) in bf16; alphas, their 1/(α+1e-9) and the
    biases in fp32."""
    w7 = u["conv1"]["w"]
    w1 = u["conv2"]["w"]
    if tuple(w7.shape) != (c, c, 7) or tuple(w1.shape) != (c, c, 1):
        raise ValueError(f"unit weights must be ({c}, {c}, 7) and ({c}, {c}, 1), "
                         f"got {tuple(w7.shape)} and {tuple(w1.shape)}")

    def vec(t):
        t = torch.zeros(c, device=device) if t is None else t
        return t.reshape(-1).to(device=device, dtype=torch.float32).contiguous()

    a1, a2 = vec(u["snake1"]), vec(u["snake2"])
    return (w7.permute(2, 1, 0).to(torch.bfloat16).contiguous(),
            vec(u["conv1"].get("b")), a1, 1.0 / (a1 + 1e-9), a2, 1.0 / (a2 + 1e-9),
            w1[:, :, 0].t().to(torch.bfloat16).contiguous(), vec(u["conv2"].get("b")))


def _res_chain_cuda(x, units, dilations, zero_below):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16 for the CUDA kernel, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, T, C), got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    b, t, c = x.shape
    if c % 32 or t < 1 or x.data_ptr() % 16:
        raise ValueError(f"the kernel needs C % 32 == 0, T >= 1 and a 16-byte "
                         f"aligned x, got (B, T, C) = {tuple(x.shape)}")
    zb = _zero_below_rows(zero_below, b, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for u, d in zip(units, dilations, strict=True):
        ops = _unit_operands(u, c, x.device)
        y = torch.empty_like(x)
        out = torch.empty_like(x)
        w7, b7, a1, inv1, a2, inv2, w1, b1 = ops
        err = _fn()(x.data_ptr(), w7.data_ptr(), b7.data_ptr(), a1.data_ptr(),
                    inv1.data_ptr(), a2.data_ptr(), inv2.data_ptr(), w1.data_ptr(),
                    b1.data_ptr(), None if zb is None else zb.data_ptr(),
                    y.data_ptr(), out.data_ptr(), b, t, c, int(d), stream)
        if err != 0:
            raise RuntimeError(f"res_chain kernel launch failed: CUDA error {err}")
        res_units_cl.launches += 2
        x = out
    return x


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def res_units_cl(x: torch.Tensor, units: Sequence[dict],
                 dilations: Sequence[int] = (1, 3, 9), *,
                 zero_below=None) -> torch.Tensor:
    """Apply a chain of causal residual units to channels-last x (B, T, C).
    units: {snake1 (1,C,1), conv1 {w (O,I,7), b}, snake2, conv2 {w (O,I,1),
    b}} per unit. zero_below: None, an int, or (B,) ints. CPU tensors take
    the plain version; CUDA tensors launch the kernel (two launches per
    unit) or raise. The kernel writes its output outside autograd, so with
    grad mode on it refuses inputs that require grad."""
    if x.device.type == "cpu":
        return res_chain_plain(x, units, dilations, zero_below)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            w.requires_grad for u in units for w in _leaves(u))):
        raise RuntimeError("res_units_cl: kernel K2 has no backward (the JAX package's "
                           "Pallas chain has none either); call it under torch.no_grad() "
                           "with inputs that do not require grad")
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _res_chain_cuda(x, units, dilations, zero_below)


res_units_cl.launches = 0
