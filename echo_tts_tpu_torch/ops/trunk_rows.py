"""Kernels K6, K7 and K8: the DiT trunk layer's fp32 elementwise islands.

The JAX package leaves these to XLA, which fuses them into its loops; it has
no Pallas kernel here. In eager PyTorch each island is a chain of full-size
passes (casts up and back, a square, a mean, broadcast products, RoPE's
strided lanes with a stack and a cat); each kernel here
(`csrc/trunk_rows.cu`) reads its bf16 operands once, works in fp32
registers and writes bf16 once, with every rounding point of the chain kept:
its result equals the chain's but for the order of a row's or a head's sum of
squares.

* K6 `residual_modulate`: x <- x + gate * y (optional, in place), then
  h = modulate_rms(x, shift, scale); `residual_norm`: the same residual, then
  rms_norm(x, w) (the trunk's out_norm).
* K7 `qk_norm_rope`: the per-head RMS-norm of q and of k with their (H, Dh)
  weights, then half-head RoPE (the global first half of the heads, the
  local heads of a tp rank carrying their offset), in place, one launch.
* K8 `sigmoid_gate` (a * sigmoid(b)) and `swiglu` (silu(a) * b), of a
  multiple of 8 elements, in place into a unless given an `out`.

Beside each is its plain chain (`*_plain`), the functions of `core/layers.py`
and `core/rope.py` the trunk called before: the reference and the path of
every forward the kernels do not take. `ops_for` makes that choice once a
forward (`models/dit.py:_dit_forward_grouped`): `FUSED` for a bf16 forward on
a card outside autograd at the widths the kernels take (D = 2048, the width
of every configuration, and head_dim 128), `PLAIN` otherwise (training under autograd: the kernels
have no backward; the CPU; fp32). A wrapper given what its kernel does not
take raises; `<wrapper>.launches` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from echo_tts_tpu_torch.core.layers import modulate_rms, rms_norm
from echo_tts_tpu_torch.core.rope import apply_rope_half_heads

HEAD_DIM = 128  # K7's head width
WIDTH = 2048    # K6's row: the model width of every configuration


# ---------------------------------------------------------------------------
# The plain chains
# ---------------------------------------------------------------------------


def residual_modulate_plain(x, y, gate, shift, scale, eps: float, out=None):
    """(x + gate * y, modulate_rms of it); y None: (x, modulate_rms(x)). The
    chain makes its own tensors: `out` (the kernel's h) is not used."""
    if y is not None:
        x = x + gate * y
    return x, modulate_rms(x, shift, scale, eps)


def residual_norm_plain(x, y, gate, weight, eps: float, out=None):
    """rms_norm(x + gate * y, weight); `out` is not used."""
    if y is not None:
        x = x + gate * y
    return rms_norm(x, weight, eps)


def qk_norm_rope_plain(q, k, q_weight, k_weight, cos, sin, head_offset: int,
                       total_heads: int, eps: float):
    """q, k (..., S, H, Dh): each RMS-normed with its (H, Dh) weight, then
    rotated on the global first half of the heads."""
    return tuple(apply_rope_half_heads(rms_norm(t, w, eps), cos, sin, head_offset, total_heads)
                 for t, w in ((q, q_weight), (k, k_weight)))


def sigmoid_gate_plain(a, b):
    return a * torch.sigmoid(b)


def swiglu_plain(a, b):
    return F.silu(a) * b


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_FNS = {}
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ARGTYPES = {
    "trunk_residual_modulate": [_P] * 6 + [_I] * 4 + [_F, _P],
    "trunk_qk_norm_rope": [_P] * 6 + [_I] * 6 + [_F, _P],
    "trunk_gated_product": [_P, _P, _P, _L, _I, _P],
}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        from echo_tts_tpu_torch.ops import _build

        fn = getattr(_build.load("trunk_rows"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


_BF16, _FP32 = torch.bfloat16, torch.float32


def _stream(dev: int) -> int:
    return torch._C._cuda_getCurrentRawStream(dev)


def _bad(t: torch.Tensor, dtype, dev: int, n: int) -> bool:
    """Whether t is not what a kernel reads: n contiguous elements of dtype
    on card dev. A few integer tests, as the wrappers run once a layer and
    an island; the kernels' C entries refuse a pointer that is not 16-byte
    aligned."""
    return t.dtype is not dtype or t.get_device() != dev or t.numel() != n or not t.is_contiguous()


def _refuse(dev: int, dtype, named: list) -> ValueError:
    """The error naming the first of `named` ((what, tensor, elements), a
    tensor None for one not given) that `_bad` refuses."""
    for what, t, n in named:
        if t is not None and _bad(t, dtype, dev, n):
            return ValueError(f"{what} must be {n} contiguous {dtype} elements on cuda:{dev}, "
                              f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                              f"{'' if t.is_contiguous() else ', not contiguous'}")
    return ValueError("unsupported operands")


def _check(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} (1: an operand "
                           f"not 16-byte aligned, or a size the kernel does not take)")


def _k6(x, y, gate, mul, add, eps: float, out, name: str):
    """K6's launch: x (..., B, S, D); gate, add and a modulation's mul
    (B, 1, D), a norm's mul (D,); h into `out` (like x) or a new tensor."""
    shape, dev = x.shape, x.get_device()
    if len(shape) < 3 or shape[-1] != WIDTH or dev < 0:
        raise ValueError(f"x must be a CUDA (..., B, S, {WIDTH}), got {tuple(shape)} on "
                         f"{x.device}")
    if (y is None) != (gate is None) or (y is None and add is None):
        raise ValueError("y and gate go together, and the norm mode takes them")
    b, s, d = shape[-3], shape[-2], shape[-1]
    n, bd = x.numel(), b * d
    md = bd if add is not None else d
    if (_bad(x, _BF16, dev, n) or _bad(mul, _BF16, dev, md)
            or (y is not None and (_bad(y, _BF16, dev, n) or _bad(gate, _BF16, dev, bd)))
            or (add is not None and _bad(add, _BF16, dev, bd))
            or (out is not None and (_bad(out, _BF16, dev, n) or out.data_ptr() == x.data_ptr()))):
        raise _refuse(dev, _BF16, [("x", x, n), ("y", y, n), ("gate", gate, bd),
                                   ("scale" if add is not None else "weight", mul, md),
                                   ("shift", add, bd), ("out (not x)", out, n)])
    h = torch.empty_like(x) if out is None else out
    res = y is not None
    _check(_fn("trunk_residual_modulate")(
        x.data_ptr(), y.data_ptr() if res else None, gate.data_ptr() if res else None,
        mul.data_ptr(), add.data_ptr() if add is not None else None, h.data_ptr(), n // d, d,
        s, b, eps, _stream(dev)), name)
    return h


def residual_modulate(x, y, gate, shift, scale, eps: float, out=None):
    """K6: x (..., B, S, D) bf16; y like x and gate (B, 1, D), or both None;
    shift, scale (B, 1, D). x <- x + gate * y in place (when y is given);
    returns (x, h) with h = modulate_rms(x, shift, scale, eps), written into
    `out` where one is given (a buffer like x, not x: the trunk reuses one a
    forward, which spares the allocation its share of the host's time)."""
    h = _k6(x, y, gate, scale, shift, eps, out, "trunk_residual_modulate")
    residual_modulate.launches += 1
    return x, h


def residual_norm(x, y, gate, weight, eps: float, out=None):
    """K6's norm mode: rms_norm(x + gate * y, weight) with weight (D,), into
    `out` where one is given; x is updated in place. y and gate are required:
    the trunk's out_norm always follows the last layer's MLP residual."""
    h = _k6(x, y, gate, weight, None, eps, out, "trunk_residual_norm")
    residual_norm.launches += 1
    return h


def _n_rot(heads: int, head_offset: int, total_heads: int) -> int:
    """How many of a rank's heads half-head RoPE rotates (as
    `core/rope.py:apply_rope_half_heads` counts them)."""
    return max(0, min(heads, total_heads // 2 - head_offset))


def qk_norm_rope(q, k, q_weight, k_weight, cos, sin, head_offset: int, total_heads: int,
                 eps: float):
    """K7: q, k (..., B, S, H, 128) bf16, RMS-normed with their (H, 128)
    weights and rotated on the global first half of the heads by the fp32
    tables cos, sin, (S, 64) or (B, S, 64); in place. Returns (q, k)."""
    shape, dev = q.shape, q.get_device()
    if len(shape) < 4 or shape[-1] != HEAD_DIM or dev < 0:
        raise ValueError(f"q must be a CUDA (..., B, S, H, {HEAD_DIM}), got {tuple(shape)} on "
                         f"{q.device}")
    b, s, h = shape[-4], shape[-3], shape[-2]
    n, hw = q.numel(), h * HEAD_DIM
    n_rot = _n_rot(h, head_offset, total_heads)
    rows = cos.dim() == 3
    tab = (b * s if rows else s) * (HEAD_DIM // 2)
    if (_bad(q, _BF16, dev, n) or _bad(k, _BF16, dev, n) or _bad(q_weight, _BF16, dev, hw)
            or _bad(k_weight, _BF16, dev, hw)):
        raise _refuse(dev, _BF16, [("q", q, n), ("k", k, n), ("q_weight", q_weight, hw),
                                   ("k_weight", k_weight, hw)])
    if n_rot and (_bad(cos, _FP32, dev, tab) or _bad(sin, _FP32, dev, tab)):
        raise _refuse(dev, _FP32, [("cos", cos, tab), ("sin", sin, tab)])
    _check(_fn("trunk_qk_norm_rope")(q.data_ptr(), k.data_ptr(), q_weight.data_ptr(),
                                     k_weight.data_ptr(), cos.data_ptr() if n_rot else None,
                                     sin.data_ptr() if n_rot else None, n // HEAD_DIM, h, s, b,
                                     n_rot, int(rows), eps, _stream(dev)),
           "trunk_qk_norm_rope")
    qk_norm_rope.launches += 1
    return q, k


def _k8(a, b, out, act: int, name: str):
    dev, n = a.get_device(), a.numel()
    out = a if out is None else out
    if n % 8 or dev < 0:
        raise ValueError(f"a must be CUDA bf16 of a multiple of 8 elements, got {tuple(a.shape)} "
                         f"on {a.device}")
    if _bad(a, _BF16, dev, n) or _bad(b, _BF16, dev, n) or _bad(out, _BF16, dev, n):
        raise _refuse(dev, _BF16, [("a", a, n), ("b", b, n), ("out", out, n)])
    if n:
        _check(_fn("trunk_gated_product")(out.data_ptr(), a.data_ptr(), b.data_ptr(), n, act,
                                          _stream(dev)), name)
    return out


def sigmoid_gate(a, b, out=None):
    """K8: a * sigmoid(b), bf16, into `out` (default: in place into a)."""
    out = _k8(a, b, out, 0, "trunk_sigmoid_gate")
    sigmoid_gate.launches += 1
    return out


def swiglu(a, b, out=None):
    """K8: silu(a) * b, bf16, into `out` (default: in place into a)."""
    out = _k8(a, b, out, 1, "trunk_swiglu")
    swiglu.launches += 1
    return out


for _w in (residual_modulate, residual_norm, qk_norm_rope, sigmoid_gate, swiglu):
    _w.launches = 0


# ---------------------------------------------------------------------------
# The choice
# ---------------------------------------------------------------------------


class TrunkOps(NamedTuple):
    """The trunk layer's islands, as kernels or as plain chains."""
    fused: bool
    residual_modulate: object
    residual_norm: object
    qk_norm_rope: object
    sigmoid_gate: object
    swiglu: object


PLAIN = TrunkOps(False, residual_modulate_plain, residual_norm_plain, qk_norm_rope_plain,
                 sigmoid_gate_plain, swiglu_plain)
FUSED = TrunkOps(True, residual_modulate, residual_norm, qk_norm_rope, sigmoid_gate, swiglu)


def ops_for(x: torch.Tensor, width: int, head_dim: int) -> TrunkOps:
    """FUSED for a forward on x that the kernels take: x on a card, bf16,
    autograd off, the model width WIDTH and heads of HEAD_DIM; PLAIN for any
    other."""
    if (x.is_cuda and x.dtype == torch.bfloat16 and not torch.is_grad_enabled()
            and width == WIDTH and head_dim == HEAD_DIM):
        return FUSED
    return PLAIN
