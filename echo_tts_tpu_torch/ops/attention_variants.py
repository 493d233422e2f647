"""Kernel K1v: the measurement variants of segmented joint attention.

Counterpart of `scripts/bench_attention_variants.py:attention_var` (body
`_kernel_var`): kernel K1 without the per-segment KV scale and without
`self_len`, under the flags whose cost the script measures. q, k_self,
v_self are head-major (G, B, H, S, D); each segment is (k (B, H, T, D),
v (B, H, T, D), mask (G, B, T) bool, True = visible), shared by the branches.

Flags that change the function:

* `probe`: "full" multiplies the normalised weights p/Σp, cast to v's dtype,
  by V; "fold" multiplies the raw exponentials and normalises the (S, D)
  output once (what K1's online softmax computes); "dots" skips the softmax
  and multiplies (logit·1e-9) cast to v's dtype by V: it isolates the two
  products, and its output means nothing (under mask_mode="bias" a masked key
  contributes -1e30·1e-9 = -1e21, finite in bf16 but useless for a relative
  error: compare it under mask_mode="none"); "noav" skips P·V and returns the
  sum over the blocks (self, each segment) of the first D columns of their
  normalised weights, so every block needs at least D keys.
* `mask_mode`: "where", "bias" and "arith" give the same result by a select,
  an added fp32 0/-1e30, or an added (m-1)·1e30 of an fp32 0/1; "none"
  ignores the masks. A mask may be passed already in its mode's form (uint8
  for "where", fp32 for "bias"/"arith") to keep the conversion out of a timing.
* `k_t`: the keys are given transposed, k_self (G, B, H, D, S) and segment k
  (B, H, D, T).

Flags that only choose the schedule of the CUDA kernel
(`csrc/joint_attention_variants.cu`, on the `wgmma` core it shares with K1,
`csrc/attention_core.cuh`): `tq`, query rows per block, 64 or 128 = one or two
consumer warpgroups beside the producer warpgroup (the script's 320 and 640
do not fit a block's registers and 227 KB of shared memory); `hg`, heads a
block walks through, any divisor of H; `use_exp2`, the base of the exponent
(results agree to rounding); `block_order`, "g_inner" (consecutive blocks
differ in the branch and share segment K/V, the TPU grid's order) or
"g_outer".

`attention_var` launches the kernel for CUDA tensors (bf16, D = 128, at most
two segments) and runs `attention_var_plain` for CPU tensors; anything the
kernel does not take raises. `attention_var.launches` counts launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

_NEG = -1e30
_LOG2E = 1.4426950408889634
HEAD_DIM = 128
MAX_SEGMENTS = 2
PROBES = ("full", "dots", "noav", "fold")
MASK_MODES = ("where", "bias", "arith", "none")
BLOCK_ORDERS = ("g_inner", "g_outer")


def _check_flags(tq, mask_mode, hg, probe, block_order, h):
    if probe not in PROBES:
        raise ValueError(f"probe must be one of {PROBES}, got {probe!r}")
    if mask_mode not in MASK_MODES:
        raise ValueError(f"mask_mode must be one of {MASK_MODES}, got {mask_mode!r}")
    if block_order not in BLOCK_ORDERS:
        raise ValueError(f"block_order must be one of {BLOCK_ORDERS}, got {block_order!r}")
    if int(tq) < 1 or int(hg) < 1 or h % int(hg):
        raise ValueError(f"tq must be positive and hg must divide H={h}, got tq={tq}, hg={hg}")


def mask_operand(mask: torch.Tensor, mask_mode: str) -> torch.Tensor:
    """A (G, B, T) mask in the form `mask_mode` reads: uint8 1/0 for "where",
    fp32 0/-1e30 for "bias", fp32 1/0 for "arith" (and for "none", which
    never reads it). A mask that is not bool is taken to be in that form."""
    if mask.dtype != torch.bool:
        want = torch.uint8 if mask_mode == "where" else torch.float32
        if mask.dtype != want:
            raise TypeError(f"a mask for mask_mode={mask_mode!r} must be bool or {want}, "
                            f"got {mask.dtype}")
        return mask
    if mask_mode == "where":
        return mask.to(torch.uint8)
    if mask_mode == "bias":
        return torch.where(mask, 0.0, _NEG).float()
    return mask.float()


def attention_var_plain(q, k_self, v_self, segments: Sequence, *, tq: int,
                        mask_mode: str = "where", use_exp2: bool = False, hg: int = 1,
                        probe: str = "full", k_t: bool = False,
                        block_order: str = "g_inner") -> torch.Tensor:
    """The arithmetic of `_kernel_var` in PyTorch: fp32 logits and softmax,
    weights cast to v's dtype where the Pallas body casts them, fp32
    accumulation, output in v's dtype."""
    g, b, h, s, d = q.shape
    _check_flags(tq, mask_mode, hg, probe, block_order, h)
    eff = (1.0 / math.sqrt(d)) * (_LOG2E if use_exp2 else 1.0)
    qf = q.float()
    wdt = v_self.dtype

    def qk(k, eq):
        kf = k.float()
        return torch.einsum(eq, qf, kf.transpose(-1, -2) if k_t else kf) * eff

    logits = [qk(k_self, "gbhsd,gbhtd->gbhst")]
    values = [v_self.float()]
    for k, v, mask in segments:
        l = qk(k, "gbhsd,bhtd->gbhst")
        m = mask_operand(mask, mask_mode)[:, :, None, None, :]
        if mask_mode == "where":
            l = torch.where(m.bool(), l, torch.full_like(l, _NEG))
        elif mask_mode == "bias":
            l = l + m
        elif mask_mode == "arith":
            l = l + (m - 1.0) * 1e30
        logits.append(l)
        values.append(v.float()[None])

    def pv(weights):
        out = None
        for w, v in zip(weights, values):
            o = torch.einsum("gbhst,gbhtd->gbhsd", w.to(wdt).float(), v.expand(g, *v.shape[1:]))
            out = o if out is None else out + o
        return out

    if probe == "dots":
        return pv([l * 1e-9 for l in logits]).to(wdt)
    m_row = torch.stack([l.amax(-1, keepdim=True) for l in logits]).amax(0)
    efn = torch.exp2 if use_exp2 else torch.exp
    exps = [efn(l - m_row) for l in logits]
    inv = 1.0 / sum(e.sum(-1, keepdim=True) for e in exps)
    if probe == "noav":
        if any(e.shape[-1] < d for e in exps):
            raise ValueError(f"probe='noav' needs at least {d} keys in every block")
        return sum((e * inv)[..., :d] for e in exps).to(wdt)
    if probe == "fold":
        return (pv(exps) * inv).to(wdt)
    return pv([e * inv for e in exps]).to(wdt)


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------


class _VarSeg(ctypes.Structure):
    _fields_ = [("k", ctypes.c_void_p), ("v", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("k_sb", ctypes.c_longlong), ("k_sh", ctypes.c_longlong),
                ("k_sr", ctypes.c_longlong),
                ("v_sb", ctypes.c_longlong), ("v_sh", ctypes.c_longlong),
                ("v_st", ctypes.c_longlong),
                ("m_sg", ctypes.c_longlong), ("m_sb", ctypes.c_longlong),
                ("t", ctypes.c_int)]


_FN = None


def _fn():
    global _FN
    if _FN is None:
        from echo_tts_tpu_torch.ops import _build

        f = _build.load("joint_attention_variants").attention_var_fwd
        vp, i = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.c_longlong * 4
        f.argtypes = [vp, vp, vp, vp, strides, strides, strides, strides, i, i, i, i,
                      ctypes.POINTER(_VarSeg), i, ctypes.c_float, i, i, i, i, i, i, i, vp]
        f.restype = i
        _FN = f
    return _FN


def _check_bf16(name: str, x: torch.Tensor, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 for the CUDA kernel, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if (x.shape[-1] > 1 and x.stride(-1) != 1) or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous last axis and a 16-byte aligned start, "
                         f"got strides {x.stride()}")


def _attention_var_cuda(q, k_self, v_self, segments, tq, mask_mode, use_exp2, hg, probe, k_t,
                        block_order, out=None):
    dev = q.device
    if q.dim() != 5:
        raise ValueError(f"q must be (G, B, H, S, D), got shape {tuple(q.shape)}")
    g, b, h, s, d = q.shape
    _check_flags(tq, mask_mode, hg, probe, block_order, h)
    if d != HEAD_DIM or tq not in (64, 128):
        raise ValueError(f"the kernel takes D={HEAD_DIM} and tq 64 or 128, got D={d}, tq={tq}")
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"at most {MAX_SEGMENTS} segments, got {len(segments)}")
    _check_bf16("q", q, (g, b, h, s, d), dev)
    _check_bf16("k_self", k_self, (g, b, h, d, s) if k_t else (g, b, h, s, d), dev)
    _check_bf16("v_self", v_self, (g, b, h, s, d), dev)
    for name, x in (("q", q), ("v_self", v_self)) + (() if k_t else (("k_self", k_self),)):
        if any(st % 8 for st in x.stride()[:-1]):
            raise ValueError(f"{name} strides must be multiples of 8 elements, got {x.stride()}")
    if out is None:
        out = torch.empty((g, b, h, s, d), dtype=torch.bfloat16, device=dev)
    _check_bf16("out", out, (g, b, h, s, d), dev)
    if probe == "noav" and (s < d or any(sg[1].shape[2] < d for sg in segments)):
        raise ValueError(f"probe='noav' needs at least {d} keys in every block")

    segs = (_VarSeg * MAX_SEGMENTS)()
    keep = []  # tensors that must outlive the launch
    for i, (k, v, mask) in enumerate(segments):
        t = v.shape[2] if v.dim() == 4 else -1
        if t < 1:
            raise ValueError(f"segment {i} v must be (B, H, T >= 1, D), got {tuple(v.shape)}")
        _check_bf16(f"segment {i} k", k, (b, h, d, t) if k_t else (b, h, t, d), dev)
        _check_bf16(f"segment {i} v", v, (b, h, t, d), dev)
        if any(st % 8 for st in v.stride()[:-1]) or (
                not k_t and any(st % 8 for st in k.stride()[:-1])):
            raise ValueError(f"segment {i} strides must be multiples of 8 elements")
        m = mask_operand(mask, mask_mode)
        if tuple(m.shape) != (g, b, t) or m.device != dev or m.stride(-1) != 1:
            raise ValueError(f"segment {i} mask must be ({g}, {b}, {t}) on {dev} with a "
                             f"contiguous last axis, got {tuple(m.shape)}")
        keep.append(m)
        segs[i] = _VarSeg(k.data_ptr(), v.data_ptr(), m.data_ptr(),
                          k.stride(0), k.stride(1), k.stride(2),
                          v.stride(0), v.stride(1), v.stride(2),
                          m.stride(0), m.stride(1), t)

    def st(x):
        return (ctypes.c_longlong * 4)(*x.stride()[:4])

    scale = (_LOG2E if use_exp2 else 1.0) / math.sqrt(d)
    err = _fn()(q.data_ptr(), k_self.data_ptr(), v_self.data_ptr(), out.data_ptr(),
                st(q), st(k_self), st(v_self), st(out), g, b, h, s, segs, len(segments),
                scale, int(tq), int(hg), PROBES.index(probe), MASK_MODES.index(mask_mode),
                int(bool(use_exp2)), int(bool(k_t)), int(block_order == "g_inner"),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_var kernel launch failed: CUDA error {err}")
    attention_var.launches += 1
    return out


def attention_var(q, k_self, v_self, segments: Sequence, *, tq: int,
                  mask_mode: str = "where", use_exp2: bool = False, hg: int = 1,
                  probe: str = "full", k_t: bool = False,
                  block_order: str = "g_inner") -> torch.Tensor:
    """One variant of the joint attention (see the module's docstring for
    the flags). CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise. The kernel writes outside autograd, so with grad mode on
    it refuses inputs that require grad."""
    if q.device.type == "cpu":
        return attention_var_plain(q, k_self, v_self, segments, tq=tq, mask_mode=mask_mode,
                                   use_exp2=use_exp2, hg=hg, probe=probe, k_t=k_t,
                                   block_order=block_order)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k_self, v_self, *(t for sg in segments for t in sg[:2]))):
        raise RuntimeError("attention_var: kernel K1v has no backward (the measurement script's "
                           "Pallas kernel has none either); call it under torch.no_grad() with "
                           "inputs that do not require grad")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _attention_var_cuda(q, k_self, v_self, segments, tq, mask_mode, use_exp2, hg, probe,
                               k_t, block_order)


attention_var.launches = 0
