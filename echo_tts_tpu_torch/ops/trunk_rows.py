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

Under autograd each island is a `torch.autograd.Function` (`*_trainable`)
whose forward runs its kernel out of place (its inputs are saved for the
backward) and whose backward is a kernel of `csrc/trunk_rows_bwd.cu`
(`*_bwd`), built at the first training step, never for serving: each reads
the saved bf16 operands and the incoming gradient once, works in fp32 and
writes bf16 once, with the rounding points of autograd over the plain chain
(`*_bwd_plain`: the same formulas in plain PyTorch, the backward on the CPU).

Beside each is its plain chain (`*_plain`), the functions of `core/layers.py`
and `core/rope.py` the trunk called before: the reference and the path of
every forward the kernels do not take. `ops_for` makes that choice once a
forward (`models/dit.py:_dit_forward_grouped`), for forwards on a card in
bf16 at the widths the kernels take (D = 2048, the width of every
configuration, and head_dim 128): `FUSED` outside autograd, `TRAINABLE`
under it when no operand the kernels do not differentiate (the modulation's
shift, scale and gates, the norms' weights) requires grad, as in LoRA
training (an autograd Function handed such an operand raises); `PLAIN` for
any other forward (full-parameter training, the CPU, fp32). A wrapper given
what its kernel does not take raises;
`<wrapper>.launches` counts launches (a training forward's in the forward
wrappers' counts).
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
# The plain chains' backward, as autograd computes it
# ---------------------------------------------------------------------------


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in the chain's fp32 (float64 stays float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _rms_bwd(xf: torch.Tensor, dn: torch.Tensor, eps: float) -> torch.Tensor:
    """The gradient of x from that of n = x * rsqrt(mean(x^2) + eps), both in
    the chain's precision, as autograd takes it through the chain: the
    product's direct term plus rsqrt's (-0.5 * grad * r^3), the mean's 1 / D
    and the square's 2 x."""
    r = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    dv = (-0.5 * (dn * xf).sum(dim=-1, keepdim=True)) * r.pow(3)
    return dn * r + (dv / xf.shape[-1]) * (2.0 * xf)


def residual_modulate_bwd_plain(xp, dh, dxi, gate, mul, mod: bool, eps: float):
    """(dx', dy) of `residual_modulate_plain` (`mod`: mul = scale) or of
    `residual_norm_plain` (mul = the weight), from the residual sum xp =
    x + gate * y, h's gradient dh and xp's own from its later uses, dxi (or
    None); dx' is also x's gradient, dy = gate * dx' (None without a gate)."""
    dn = _wide(dh) * (_wide(mul) + 1.0 if mod else _wide(mul))
    d = _rms_bwd(_wide(xp), dn, eps).to(xp.dtype)
    if dxi is not None:
        d = d + dxi
    return d, (None if gate is None else d * gate)


def _tables(cos, sin):
    """RoPE's (S, Dh/2) or (B, S, Dh/2) tables broadcast over the heads."""
    if cos.dim() == 2:
        return cos[:, None, :], sin[:, None, :]
    return cos[:, :, None, :], sin[:, :, None, :]


def qk_norm_rope_bwd_plain(q, k, dq, dk, q_weight, k_weight, cos, sin, head_offset: int,
                           total_heads: int, eps: float):
    """(dq, dk) of q and k, the inputs of `qk_norm_rope_plain`, from the
    gradients dq, dk of its outputs: the rotation's transpose on the rotated
    heads, rounded where the normed heads were, then the weighted norm's
    backward."""
    n_rot = _n_rot(q.shape[-2], head_offset, total_heads)
    out = []
    for t, g, w in ((q, dq, q_weight), (k, dk, k_weight)):
        gf = _wide(g)
        if n_rot:
            c, s = _tables(_wide(cos), _wide(sin))
            gr, gi = gf[..., :n_rot, 0::2], gf[..., :n_rot, 1::2]
            rot = torch.stack([gr * c + gi * s, gi * c - gr * s], dim=-1).flatten(-2)
            gf = torch.cat([_wide(rot.to(t.dtype)), gf[..., n_rot:, :]], dim=-2)
        out.append(_rms_bwd(_wide(t), gf * _wide(w), eps).to(t.dtype))
    return tuple(out)


def sigmoid_gate_bwd_plain(a, b, dout):
    """(da, db) of a * sigmoid(b): PyTorch's sigmoid_backward on the rounded
    sigmoid, op by op in b's dtype as its CUDA kernel computes it (each of
    1 - s and the two products rounded to bf16; its CPU kernel keeps them in
    fp32)."""
    s = torch.sigmoid(b)
    return dout * s, (dout * a) * (1.0 - s) * s


def swiglu_bwd_plain(a, b, dout):
    """(da, db) of silu(a) * b: PyTorch's silu_backward from a."""
    af = _wide(a)
    sig = 1.0 / (1.0 + torch.exp(-af))
    da = (_wide(dout * b) * sig) * (1.0 + af * (1.0 - sig))
    return da.to(a.dtype), dout * F.silu(a)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_FNS = {}
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ARGTYPES = {
    "trunk_residual_modulate": [_P] * 7 + [_I] * 4 + [_F, _P],
    "trunk_qk_norm_rope": [_P] * 8 + [_I] * 6 + [_F, _P],
    "trunk_gated_product": [_P, _P, _P, _L, _I, _P],
    "trunk_residual_modulate_bwd": [_P] * 4 + [_I] + [_P] * 3 + [_I] * 4 + [_F, _P],
    "trunk_qk_norm_rope_bwd": [_P] * 10 + [_I] * 6 + [_F, _P],
    "trunk_gated_product_bwd": [_P] * 5 + [_L, _I, _P],
}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        from echo_tts_tpu_torch.ops import _build

        fn = getattr(_build.load("trunk_rows_bwd" if name.endswith("_bwd") else "trunk_rows"),
                     name)
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


def _k6(x, y, gate, mul, add, eps: float, out, name: str, xo=None):
    """K6's launch: x (..., B, S, D); gate, add and a modulation's mul
    (B, 1, D), a norm's mul (D,); h into `out` (like x) or a new tensor;
    x + gate * y into `xo` (like x), or into x where xo is None."""
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
            or (out is not None and (_bad(out, _BF16, dev, n) or out.data_ptr() == x.data_ptr()))
            or (xo is not None and _bad(xo, _BF16, dev, n))):
        raise _refuse(dev, _BF16, [("x", x, n), ("y", y, n), ("gate", gate, bd),
                                   ("scale" if add is not None else "weight", mul, md),
                                   ("shift", add, bd), ("out (not x)", out, n), ("xo", xo, n)])
    h = torch.empty_like(x) if out is None else out
    res = y is not None
    _check(_fn("trunk_residual_modulate")(
        x.data_ptr(), y.data_ptr() if res else None, gate.data_ptr() if res else None,
        mul.data_ptr(), add.data_ptr() if add is not None else None, h.data_ptr(),
        xo.data_ptr() if xo is not None else None, n // d, d, s, b, eps, _stream(dev)), name)
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


def _k7_args(q, k, q_weight, k_weight, cos, sin, head_offset: int, total_heads: int):
    """The checked shape arguments of a K7 launch (forward or backward):
    (heads in all, H, S, B, heads rotated, tables one a row)."""
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
    return n // HEAD_DIM, h, s, b, n_rot, int(rows)


def _tables_ptrs(cos, sin, n_rot: int):
    return (cos.data_ptr(), sin.data_ptr()) if n_rot else (None, None)


def _k7(q, k, q_weight, k_weight, cos, sin, head_offset: int, total_heads: int, eps: float,
        qo=None, ko=None):
    """K7's launch: the results into qo, ko (like q), or into q, k in place."""
    args = _k7_args(q, k, q_weight, k_weight, cos, sin, head_offset, total_heads)
    _check(_fn("trunk_qk_norm_rope")(
        q.data_ptr(), k.data_ptr(), None if qo is None else qo.data_ptr(),
        None if ko is None else ko.data_ptr(), q_weight.data_ptr(), k_weight.data_ptr(),
        *_tables_ptrs(cos, sin, args[4]), *args, eps, _stream(q.get_device())),
        "trunk_qk_norm_rope")
    qk_norm_rope.launches += 1
    return (q, k) if qo is None else (qo, ko)


def qk_norm_rope(q, k, q_weight, k_weight, cos, sin, head_offset: int, total_heads: int,
                 eps: float):
    """K7: q, k (..., B, S, H, 128) bf16, RMS-normed with their (H, 128)
    weights and rotated on the global first half of the heads by the fp32
    tables cos, sin, (S, 64) or (B, S, 64); in place. Returns (q, k)."""
    return _k7(q, k, q_weight, k_weight, cos, sin, head_offset, total_heads, eps)


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


# ---------------------------------------------------------------------------
# The backward kernels
# ---------------------------------------------------------------------------


def residual_modulate_bwd(xp, dh, dxi, gate, mul, mod: bool, eps: float):
    """K6 bwd: the arguments and results of `residual_modulate_bwd_plain`
    (xp, dh, dxi (..., B, S, 2048) bf16; gate (B, 1, 2048); mul the scale
    (B, 1, 2048) when `mod`, else the norm's weight (2048,))."""
    shape, dev = xp.shape, xp.get_device()
    if len(shape) < 3 or shape[-1] != WIDTH or dev < 0:
        raise ValueError(f"xp must be a CUDA (..., B, S, {WIDTH}), got {tuple(shape)} on "
                         f"{xp.device}")
    b, s, d = shape[-3], shape[-2], shape[-1]
    n, bd = xp.numel(), b * d
    md = bd if mod else d
    if (_bad(xp, _BF16, dev, n) or _bad(dh, _BF16, dev, n) or _bad(mul, _BF16, dev, md)
            or (dxi is not None and _bad(dxi, _BF16, dev, n))
            or (gate is not None and _bad(gate, _BF16, dev, bd))):
        raise _refuse(dev, _BF16, [("xp", xp, n), ("dh", dh, n), ("dxi", dxi, n),
                                   ("scale" if mod else "weight", mul, md), ("gate", gate, bd)])
    dx = torch.empty_like(xp)
    dy = None if gate is None else torch.empty_like(xp)
    _check(_fn("trunk_residual_modulate_bwd")(
        xp.data_ptr(), dh.data_ptr(), None if dxi is None else dxi.data_ptr(), mul.data_ptr(),
        int(mod), None if gate is None else gate.data_ptr(), dx.data_ptr(),
        None if dy is None else dy.data_ptr(), n // d, d, s, b, eps, _stream(dev)),
        "trunk_residual_modulate_bwd")
    residual_modulate_bwd.launches += 1
    return dx, dy


def qk_norm_rope_bwd(q, k, dq, dk, q_weight, k_weight, cos, sin, head_offset: int,
                     total_heads: int, eps: float):
    """K7 bwd: the arguments and results of `qk_norm_rope_bwd_plain`, with
    the shapes K7 takes; dq, dk like q."""
    args = _k7_args(q, k, q_weight, k_weight, cos, sin, head_offset, total_heads)
    dev, n = q.get_device(), q.numel()
    if _bad(dq, _BF16, dev, n) or _bad(dk, _BF16, dev, n):
        raise _refuse(dev, _BF16, [("dq", dq, n), ("dk", dk, n)])
    dqi, dki = torch.empty_like(q), torch.empty_like(k)
    _check(_fn("trunk_qk_norm_rope_bwd")(
        q.data_ptr(), k.data_ptr(), dq.data_ptr(), dk.data_ptr(), dqi.data_ptr(), dki.data_ptr(),
        q_weight.data_ptr(), k_weight.data_ptr(), *_tables_ptrs(cos, sin, args[4]), *args, eps,
        _stream(dev)), "trunk_qk_norm_rope_bwd")
    qk_norm_rope_bwd.launches += 1
    return dqi, dki


def _k8_bwd(a, b, dout, act: int):
    dev, n = a.get_device(), a.numel()
    if n % 8 or dev < 0:
        raise ValueError(f"a must be CUDA bf16 of a multiple of 8 elements, got {tuple(a.shape)} "
                         f"on {a.device}")
    if _bad(a, _BF16, dev, n) or _bad(b, _BF16, dev, n) or _bad(dout, _BF16, dev, n):
        raise _refuse(dev, _BF16, [("a", a, n), ("b", b, n), ("dout", dout, n)])
    da, db = torch.empty_like(a), torch.empty_like(b)
    if n:
        _check(_fn("trunk_gated_product_bwd")(a.data_ptr(), b.data_ptr(), dout.data_ptr(),
                                              da.data_ptr(), db.data_ptr(), n, act,
                                              _stream(dev)), "trunk_gated_product_bwd")
    return da, db


def sigmoid_gate_bwd(a, b, dout):
    """K8 bwd: (da, db) of a * sigmoid(b), bf16."""
    out = _k8_bwd(a, b, dout, 0)
    sigmoid_gate_bwd.launches += 1
    return out


def swiglu_bwd(a, b, dout):
    """K8 bwd: (da, db) of silu(a) * b, bf16."""
    out = _k8_bwd(a, b, dout, 1)
    swiglu_bwd.launches += 1
    return out


for _w in (residual_modulate, residual_norm, qk_norm_rope, sigmoid_gate, swiglu,
           residual_modulate_bwd, qk_norm_rope_bwd, sigmoid_gate_bwd, swiglu_bwd):
    _w.launches = 0


# ---------------------------------------------------------------------------
# Under autograd
# ---------------------------------------------------------------------------


def _frozen(ctx, names: dict) -> None:
    """Refuse an operand that requires grad where the backward kernels give
    it none ({input index: name})."""
    trained = [name for i, name in names.items() if ctx.needs_input_grad[i]]
    if trained:
        raise ValueError(f"the trunk-row backward kernels do not differentiate "
                         f"{', '.join(trained)}; run the plain chain (`PLAIN`) to train them")


class _ResidualModulate(torch.autograd.Function):
    """K6 under autograd, out of place: (x + gate * y, h), or h alone
    without y; `add` None is the norm mode (mul the weight). The backward is
    K6 bwd on the card, the plain formulas on the CPU."""

    @staticmethod
    def forward(ctx, x, y, gate, mul, add, eps):
        _frozen(ctx, {2: "gate", 3: "scale" if add is not None else "weight", 4: "shift"})
        ctx.set_materialize_grads(False)
        res, mod = y is not None, add is not None
        if x.is_cuda:
            xo = torch.empty_like(x) if res else x
            h = _k6(x, y, gate, mul, add, eps, None,
                    "trunk_residual_modulate" if mod else "trunk_residual_norm",
                    xo if res else None)
            (residual_modulate if mod else residual_norm).launches += 1
        else:
            xo = x + gate * y if res else x
            h = modulate_rms(xo, add, mul, eps) if mod else rms_norm(xo, mul, eps)
        ctx.save_for_backward(xo, gate, mul)
        ctx.res, ctx.mod, ctx.eps = res, mod, eps
        return (xo, h) if res else h

    @staticmethod
    def backward(ctx, *grads):
        xp, gate, mul = ctx.saved_tensors
        dxi, dh = grads if ctx.res else (None, grads[0])
        dh = torch.zeros_like(xp) if dh is None else dh.contiguous()
        gate = gate if ctx.needs_input_grad[1] else None
        bwd = residual_modulate_bwd if xp.is_cuda else residual_modulate_bwd_plain
        dx, dy = bwd(xp, dh, None if dxi is None else dxi.contiguous(), gate, mul, ctx.mod,
                     ctx.eps)
        return dx, dy, None, None, None, None


class _QKNormRope(torch.autograd.Function):
    """K7 under autograd, into new tensors; the backward is K7 bwd on the
    card, the plain formulas on the CPU."""

    @staticmethod
    def forward(ctx, q, k, q_weight, k_weight, cos, sin, head_offset, total_heads, eps):
        _frozen(ctx, {2: "q_weight", 3: "k_weight", 4: "cos", 5: "sin"})
        ctx.set_materialize_grads(False)
        if q.is_cuda:
            qo, ko = _k7(q, k, q_weight, k_weight, cos, sin, head_offset, total_heads, eps,
                         torch.empty_like(q), torch.empty_like(k))
        else:
            qo, ko = qk_norm_rope_plain(q, k, q_weight, k_weight, cos, sin, head_offset,
                                        total_heads, eps)
        ctx.save_for_backward(q, k, q_weight, k_weight, cos, sin)
        ctx.meta = (head_offset, total_heads, eps)
        return qo, ko

    @staticmethod
    def backward(ctx, dq, dk):
        q, k, qw, kw, cos, sin = ctx.saved_tensors
        dq = torch.zeros_like(q) if dq is None else dq.contiguous()
        dk = torch.zeros_like(k) if dk is None else dk.contiguous()
        bwd = qk_norm_rope_bwd if q.is_cuda else qk_norm_rope_bwd_plain
        dqi, dki = bwd(q, k, dq, dk, qw, kw, cos, sin, *ctx.meta)
        return (dqi, dki) + (None,) * 7


class _GatedProduct(torch.autograd.Function):
    """K8 under autograd (act 0: a * sigmoid(b); 1: silu(a) * b), into a new
    tensor; the backward is K8 bwd on the card, the plain formulas on the
    CPU."""

    @staticmethod
    def forward(ctx, a, b, act):
        fwd = sigmoid_gate if act == 0 else swiglu
        if a.is_cuda:
            out = _k8(a, b, torch.empty_like(a), act, "trunk_" + fwd.__name__)
            fwd.launches += 1
        else:
            out = (sigmoid_gate_plain if act == 0 else swiglu_plain)(a, b)
        ctx.save_for_backward(a, b)
        ctx.act = act
        return out

    @staticmethod
    def backward(ctx, dout):
        a, b = ctx.saved_tensors
        if a.is_cuda:
            bwd = sigmoid_gate_bwd if ctx.act == 0 else swiglu_bwd
        else:
            bwd = sigmoid_gate_bwd_plain if ctx.act == 0 else swiglu_bwd_plain
        da, db = bwd(a, b, dout.contiguous())
        return da, db, None


def residual_modulate_trainable(x, y, gate, shift, scale, eps: float, out=None):
    """`residual_modulate` under autograd: (x + gate * y, h) in new tensors
    (`out` is not used)."""
    if y is None:
        return x, _ResidualModulate.apply(x, None, None, scale, shift, eps)
    return _ResidualModulate.apply(x, y, gate, scale, shift, eps)


def residual_norm_trainable(x, y, gate, weight, eps: float, out=None):
    """`residual_norm` under autograd: rms_norm(x + gate * y, weight) in a
    new tensor."""
    if y is None:
        raise ValueError("y and gate go together, and the norm mode takes them")
    return _ResidualModulate.apply(x, y, gate, weight, None, eps)[1]


def qk_norm_rope_trainable(q, k, q_weight, k_weight, cos, sin, head_offset: int,
                           total_heads: int, eps: float):
    """`qk_norm_rope` under autograd, into new tensors."""
    return _QKNormRope.apply(q, k, q_weight, k_weight, cos, sin, head_offset, total_heads, eps)


def sigmoid_gate_trainable(a, b):
    return _GatedProduct.apply(a, b, 0)


def swiglu_trainable(a, b):
    return _GatedProduct.apply(a, b, 1)


# ---------------------------------------------------------------------------
# The choice
# ---------------------------------------------------------------------------


class TrunkOps(NamedTuple):
    """The trunk layer's islands, as kernels or as plain chains. `fused`: a
    layer leaves its MLP residual to the next layer's first K6 (and the
    last to the out_norm); `h_buffer`: K6 writes h into one buffer a
    forward."""
    fused: bool
    residual_modulate: object
    residual_norm: object
    qk_norm_rope: object
    sigmoid_gate: object
    swiglu: object
    h_buffer: bool = False


PLAIN = TrunkOps(False, residual_modulate_plain, residual_norm_plain, qk_norm_rope_plain,
                 sigmoid_gate_plain, swiglu_plain)
FUSED = TrunkOps(True, residual_modulate, residual_norm, qk_norm_rope, sigmoid_gate, swiglu,
                 h_buffer=True)
TRAINABLE = TrunkOps(True, residual_modulate_trainable, residual_norm_trainable,
                     qk_norm_rope_trainable, sigmoid_gate_trainable, swiglu_trainable)


def ops_for(x: torch.Tensor, width: int, head_dim: int, frozen=()) -> TrunkOps:
    """For a forward on x that the kernels take (x on a card, bf16, the
    model width WIDTH and heads of HEAD_DIM): FUSED outside autograd, and
    under autograd TRAINABLE where none of `frozen` (the operands the
    kernels do not differentiate: the modulation's shift, scale and gates,
    the norms' weights) requires grad. PLAIN for any other."""
    if not (x.is_cuda and x.dtype == torch.bfloat16 and width == WIDTH
            and head_dim == HEAD_DIM):
        return PLAIN
    if not torch.is_grad_enabled():
        return FUSED
    if any(not isinstance(t, torch.Tensor) or t.requires_grad for t in frozen):
        return PLAIN
    return TRAINABLE
