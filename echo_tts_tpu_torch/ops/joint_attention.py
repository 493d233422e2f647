"""Kernel K1: segmented joint attention of the DiT trunk.

Counterpart of `echo_tts_tpu/ops/pallas_attention.py:joint_attention_grouped_pallas`
(body `_kernel`) and of the XLA einsum path of
`echo_tts_tpu/models/dit.py:_joint_attention_grouped`.

For each CFG branch g, batch row b, head h and query row:

    logits = [q·k_selfᵀ·c | q·k_segᵀ·c·s_seg + bias_seg ...]   (c = 1/sqrt(D))
    out    = softmax(logits) · [v_self | s_seg·v_seg ...]

Self keys are visible unless `self_len` (B,) bounds them per row. Each
context segment keeps its own K, V (B, H, T, D), mask (G, B, T) and scalar
scale (the "force speaker" multiplier; None = 1). Every branch shares the
segment KV.

`joint_attention` runs the hand-written CUDA kernel (`csrc/joint_attention.cu`,
on the Hopper core `csrc/attention_core.cuh`: `wgmma` products with register
accumulators over a `cp.async`/`mbarrier` ring of K/V tiles) for CUDA tensors
and the plain PyTorch version for CPU tensors; anything the kernel does not
take raises. `joint_attention.launches` counts kernel
launches. It writes outside autograd, so on CUDA it refuses inputs that
require grad while grad mode is on.

Training goes through `joint_attention_trainable`, the counterpart of
`echo_tts_tpu/ops/pallas_attention.py:_make_trainable_attention`: a
`torch.autograd.Function` whose forward is K1 (which then also writes each
row's log-sum-exp) and whose backward is kernel K3
(`csrc/joint_attention_bwd.cu`, counterpart of `_bwd_kernel`). On CPU
tensors the two directions are `joint_attention_plain` and
`joint_attention_bwd_plain`. `joint_attention_bwd.launches` counts K3.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

_NEG = -1e30
_LOG2E = 1.4426950408889634
HEAD_DIM = 128      # the kernel's head width
MAX_SEGMENTS = 3
# query rows a block of K1 takes: 64 = one consumer warpgroup and two blocks
# on an SM, 128 = two consumer warpgroups that share each K/V tile. 128 read
# 5-9 % faster at the one-branch, the three-branch and the training shape
# (chip_smoke.py phase 8 times both on an H100).
TQ = 128


def _to_head_major(x: torch.Tensor, layout: str) -> torch.Tensor:
    """(G, B, S, H, D) seq-major -> (G, B, H, S, D) view; head-major as is."""
    if layout == "sm":
        return x.transpose(2, 3)
    if layout != "hm":
        raise ValueError(f"layout must be 'hm' or 'sm', got {layout!r}")
    return x


def _self_bias(self_len, t_self: int, device) -> Optional[torch.Tensor]:
    if self_len is None:
        return None
    sl = torch.as_tensor(self_len, dtype=torch.int32, device=device).reshape(-1)
    keep = torch.arange(t_self, device=device)[None, :] < sl[:, None]
    return torch.where(keep, 0.0, _NEG).float()  # (B, T)


def joint_attention_plain(q, k_self, v_self, segments, layout: str = "hm",
                          self_len=None) -> torch.Tensor:
    """The einsum-softmax of `models/dit.py:_joint_attention_grouped`'s XLA
    branch: fp32 logits and softmax, weights cast to v's dtype, fp32
    accumulation. Masks may be bool (True = visible) or fp32 additive
    biases. Returns q's layout in v's dtype."""
    qh = _to_head_major(q, layout).float()
    kh = _to_head_major(k_self, layout).float()
    vh = _to_head_major(v_self, layout)
    d = qh.shape[-1]
    s_self = kh.shape[3]
    c = 1.0 / math.sqrt(d)
    l_self = torch.einsum("gbhsd,gbhtd->gbhst", qh, kh) * c
    sb = _self_bias(self_len, s_self, q.device)
    if sb is not None:
        l_self = l_self + sb[None, :, None, None, :]
    logits = [l_self]
    for k, v, mask, s_kv in segments:
        l = torch.einsum("gbhsd,bhtd->gbhst", qh, k.float()) * c
        if s_kv is not None:
            l = l * s_kv
        if mask.dtype == torch.bool:
            l = l.masked_fill(~mask[:, :, None, None, :], _NEG)
        else:
            l = l + mask.float()[:, :, None, None, :]
        logits.append(l)
    w = torch.softmax(torch.cat(logits, dim=-1), dim=-1).to(vh.dtype).float()
    out = torch.einsum("gbhst,gbhtd->gbhsd", w[..., :s_self], vh.float())
    off = s_self
    for k, v, mask, s_kv in segments:
        t = k.shape[2]
        o = torch.einsum("gbhst,bhtd->gbhsd", w[..., off:off + t], v.float())
        if s_kv is not None:
            o = o * s_kv
        out = out + o
        off += t
    out = out.to(vh.dtype)
    return out.transpose(2, 3) if layout == "sm" else out


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------


class _Seg(ctypes.Structure):
    _fields_ = [("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("bias", ctypes.c_void_p),
                ("k_sb", ctypes.c_longlong), ("k_sh", ctypes.c_longlong),
                ("k_st", ctypes.c_longlong),
                ("v_sb", ctypes.c_longlong), ("v_sh", ctypes.c_longlong),
                ("v_st", ctypes.c_longlong),
                ("bias_sg", ctypes.c_longlong), ("bias_sb", ctypes.c_longlong),
                ("t", ctypes.c_int), ("scale", ctypes.c_float)]


_FN = None


def _fn():
    global _FN
    if _FN is None:
        from echo_tts_tpu_torch.ops import _build

        f = _build.load("joint_attention").joint_attention_fwd
        vp, i = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.c_longlong * 4
        f.argtypes = [vp, vp, vp, vp, strides, strides, strides, strides,
                      vp, vp, i, i, i, i, i, ctypes.POINTER(_Seg), i,
                      ctypes.c_float, i, vp]
        f.restype = i
        _FN = f
    return _FN


def _check_bf16_rows(name: str, x: torch.Tensor, device, ndim: Optional[int] = None):
    """What the kernels ask of a bf16 operand; returns its (shape, strides).
    On the hot path of every launch: it reads each property once."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 for the CUDA kernel, got {x.dtype}")
    shape, strides = x.shape, x.stride()
    if ndim is not None and len(shape) != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(shape)}")
    if shape[-1] != HEAD_DIM or strides[-1] != 1:
        raise ValueError(f"{name} needs a contiguous last axis of {HEAD_DIM}, "
                         f"got shape {tuple(shape)} strides {strides}")
    outer = 0
    for st in strides[:-1]:
        outer |= st
    if x.data_ptr() % 16 or outer % 8:
        raise ValueError(f"{name} must be 16-byte aligned with strides that "
                         f"are multiples of 8 elements")
    return shape, strides


def _head_major_meta(name: str, x: torch.Tensor, layout: str, device):
    """Shape and element strides of x seen as (G, B, H, S, D), without making
    the view: seq-major swaps axes 2 and 3."""
    shape, st = _check_bf16_rows(name, x, device, 5)
    if layout == "sm":
        return (shape[0], shape[1], shape[3], shape[2], shape[4]), (st[0], st[1], st[3], st[2])
    if layout != "hm":
        raise ValueError(f"layout must be 'hm' or 'sm', got {layout!r}")
    return tuple(shape), st[:4]


def _bias_of(mask: torch.Tensor) -> torch.Tensor:
    if mask.dtype == torch.bool:
        return torch.where(mask, 0.0, _NEG).float()
    if mask.dtype != torch.float32:
        raise TypeError(f"segment mask must be bool or float32, got {mask.dtype}")
    return mask


def _joint_attention_cuda(q, k_self, v_self, segments, layout, self_len, out, lse=None,
                          tq=None):
    """K1. `lse`, when given, receives each query row's base-2 log-sum-exp
    as fp32 (G, B, H, S) contiguous. `tq` (64 or 128, default `TQ`) only
    chooses the schedule."""
    dev = q.device
    q_shape, q_st = _head_major_meta("q", q, layout, dev)
    k_shape, k_st = _head_major_meta("k_self", k_self, layout, dev)
    v_shape, v_st = _head_major_meta("v_self", v_self, layout, dev)
    g, b, h, s, _ = q_shape
    s_kv = k_shape[3]
    if k_shape[:3] != (g, b, h) or v_shape != k_shape:
        raise ValueError(f"k_self/v_self shapes {k_shape}/{v_shape} (head-major) "
                         f"do not match q {q_shape}")
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"at most {MAX_SEGMENTS} segments, got {len(segments)}")
    if out is None:
        out = torch.empty_like(q)
    o_shape, o_st = _head_major_meta("out", out, layout, dev)
    if o_shape != q_shape:
        raise ValueError(f"out shape {tuple(out.shape)} does not match q {tuple(q.shape)}")

    segs = (_Seg * MAX_SEGMENTS)()
    keep = []  # tensors that must outlive the launch
    for i, (k, v, mask, scale) in enumerate(segments):
        ks, kst = _check_bf16_rows(f"segment {i} k", k, dev)
        vs, vst = _check_bf16_rows(f"segment {i} v", v, dev)
        if len(ks) != 4 or ks[:2] != (b, h) or vs != ks:
            raise ValueError(f"segment {i} k/v must be (B, H, T, {HEAD_DIM}), "
                             f"got {tuple(ks)}/{tuple(vs)}")
        t = ks[2]
        if t < 1:
            raise ValueError(f"segment {i} is empty")
        bias = _bias_of(mask)
        bst = bias.stride()
        if bias.shape != (g, b, t) or bias.device != dev or bst[-1] != 1:
            raise ValueError(f"segment {i} mask must be ({g}, {b}, {t}) on {dev} "
                             f"with a contiguous last axis, got {tuple(bias.shape)}")
        keep.append(bias)
        segs[i] = _Seg(k.data_ptr(), v.data_ptr(), bias.data_ptr(), kst[0], kst[1], kst[2],
                       vst[0], vst[1], vst[2], bst[0], bst[1],
                       t, 1.0 if scale is None else float(scale))
    sl_ptr = None
    if self_len is not None:
        sl = torch.as_tensor(self_len, dtype=torch.int32, device=dev).reshape(-1).contiguous()
        if sl.numel() != b:
            raise ValueError(f"self_len must have {b} entries, got {sl.numel()}")
        keep.append(sl)
        sl_ptr = sl.data_ptr()
    if lse is not None and (lse.dtype != torch.float32 or lse.device != dev
                            or lse.shape != (g, b, h, s) or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 ({g}, {b}, {h}, {s}) on {dev}")

    strides = ctypes.c_longlong * 4
    err = _fn()(q.data_ptr(), k_self.data_ptr(), v_self.data_ptr(), out.data_ptr(),
                strides(*q_st), strides(*k_st), strides(*v_st), strides(*o_st), sl_ptr,
                None if lse is None else lse.data_ptr(), g, b, h, s, s_kv, segs, len(segments),
                _LOG2E / math.sqrt(HEAD_DIM), TQ if tq is None else int(tq),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"joint_attention kernel launch failed: CUDA error {err}")
    joint_attention.launches += 1
    return out


def joint_attention(q, k_self, v_self, segments: Sequence, layout: str = "hm",
                    self_len=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segmented joint attention; `q`, `k_self`, `v_self` are (G, B, H, S, D)
    head-major (layout="hm") or (G, B, S, H, D) seq-major (layout="sm").
    segments: list of (k (B, H, T, D), v, mask (G, B, T) bool or fp32 bias,
    scale float or None). `out`, when given, is written in place (q's
    layout and dtype). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise; with grad mode on they must not require grad
    (training calls `joint_attention_trainable`)."""
    if q.device.type == "cpu":
        res = joint_attention_plain(q, k_self, v_self, segments, layout, self_len)
        if out is None:
            return res
        out.copy_(res)
        return out
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k_self, v_self, *(t for sg in segments for t in sg[:3]))):
        raise RuntimeError("joint_attention: kernel K1 writes outside autograd, so gradients "
                           "would be lost; train through joint_attention_trainable, or call "
                           "this under torch.no_grad()")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _joint_attention_cuda(q, k_self, v_self, segments, layout, self_len, out)


joint_attention.launches = 0


# ---------------------------------------------------------------------------
# Backward: plain version and kernel K3
# ---------------------------------------------------------------------------


def joint_attention_bwd_plain(q, k_self, v_self, segments, do, layout: str = "hm"):
    """The math of `echo_tts_tpu/ops/pallas_attention.py:_bwd_kernel`, written
    out: fp32 logits and softmax over [self | segments] recomputed; dp per
    segment scaled by s_seg; r = sum(dp*p); dl = p*(dp - r); dl and p cast
    to q's dtype before their products (fp32 accumulation); dq; dk_self and
    dv_self per branch; dk and dv per segment summed over the branches and
    scaled by s_seg. segments as in `joint_attention` (bool masks or fp32
    additive biases). Returns (dq, dk_self, dv_self, [dk_i, dv_i, ...]) in
    q's layout; dq/dk_self/dv_self in q's dtype, dk_i/dv_i in k's."""
    in_dt = q.dtype
    qh = _to_head_major(q, layout).float()
    kh = _to_head_major(k_self, layout).float()
    vh = _to_head_major(v_self, layout).float()
    doh = _to_head_major(do, layout).float()
    c = 1.0 / math.sqrt(qh.shape[-1])
    s_self = kh.shape[3]
    scales = [1.0 if sc is None else float(sc) for _, _, _, sc in segments]
    logits = [torch.einsum("gbhsd,gbhtd->gbhst", qh, kh) * c]
    for (k, _, mask, _), sc in zip(segments, scales):
        l = torch.einsum("gbhsd,bhtd->gbhst", qh, k.float()) * c * sc
        logits.append(l + _bias_of(mask)[:, :, None, None, :])
    p = torch.softmax(torch.cat(logits, dim=-1), dim=-1)
    dp = [torch.einsum("gbhsd,gbhtd->gbhst", doh, vh)]
    dp += [torch.einsum("gbhsd,bhtd->gbhst", doh, v.float()) * sc
           for (_, v, _, _), sc in zip(segments, scales)]
    dp = torch.cat(dp, dim=-1)
    r = (dp * p).sum(dim=-1, keepdim=True)
    dl = (p * (dp - r)).to(in_dt).float()
    pc = p.to(in_dt).float()
    do_c = doh.to(in_dt).float()

    def out_layout(x):
        return x.transpose(2, 3) if layout == "sm" else x

    dq = torch.einsum("gbhst,gbhtd->gbhsd", dl[..., :s_self], kh) * c
    dks = torch.einsum("gbhst,gbhsd->gbhtd", dl[..., :s_self], qh) * c
    dvs = torch.einsum("gbhst,gbhsd->gbhtd", pc[..., :s_self], do_c)
    dsegs, off = [], s_self
    for (k, v, _, _), sc in zip(segments, scales):
        t = k.shape[2]
        dq = dq + torch.einsum("gbhst,bhtd->gbhsd", dl[..., off:off + t], k.float()) * (c * sc)
        dk = torch.einsum("gbhst,gbhsd->bhtd", dl[..., off:off + t], qh) * (c * sc)
        dv = torch.einsum("gbhst,gbhsd->bhtd", pc[..., off:off + t], do_c) * sc
        dsegs += [dk.to(k.dtype), dv.to(v.dtype)]
        off += t
    return (out_layout(dq.to(in_dt)), out_layout(dks.to(in_dt)), out_layout(dvs.to(in_dt)),
            dsegs)


class _SegB(ctypes.Structure):
    _fields_ = [("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("bias", ctypes.c_void_p), ("dk", ctypes.c_void_p),
                ("dv", ctypes.c_void_p)] + [
        (n, ctypes.c_longlong) for n in (
            "k_sb", "k_sh", "k_st", "v_sb", "v_sh", "v_st", "dk_sb", "dk_sh", "dk_st",
            "dv_sb", "dv_sh", "dv_st", "bias_sg", "bias_sb")] + [
        ("t", ctypes.c_int), ("scale", ctypes.c_float)]


_BWD_FN = None


def _bwd_fn():
    global _BWD_FN
    if _BWD_FN is None:
        from echo_tts_tpu_torch.ops import _build

        f = _build.load("joint_attention_bwd").joint_attention_bwd
        vp, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp] * 10 + [ctypes.c_longlong * 32, i, i, i, i, i,
                                  ctypes.POINTER(_SegB), i, ctypes.c_float, ctypes.c_float, vp]
        f.restype = i
        _BWD_FN = f
    return _BWD_FN


def _joint_attention_bwd_cuda(q, k_self, v_self, segments, out, lse, do, layout):
    """K3. `out` and `lse` come from K1's forward on the same inputs;
    segment masks are fp32 biases or bool. Returns what
    `joint_attention_bwd_plain` returns."""
    dev = q.device
    names = ("q", "k_self", "v_self", "dO", "out")
    views = [_to_head_major(x, layout) for x in (q, k_self, v_self, do, out)]
    for name, x in zip(names, views):
        if x.dim() != 5:
            raise ValueError(f"{name} must be 5-D, got shape {tuple(x.shape)}")
        _check_bf16_rows(name, x, dev)
    g, b, h, s, _ = views[0].shape
    if any(x.shape != views[0].shape for x in views[1:]):
        raise ValueError("q, k_self, v_self, dO and out must have one shape (self keys = "
                         f"queries), got {[tuple(x.shape) for x in views]}")
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"at most {MAX_SEGMENTS} segments, got {len(segments)}")
    if (lse.dtype != torch.float32 or lse.device != dev or lse.shape != (g, b, h, s)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 ({g}, {b}, {h}, {s}) on {dev}")
    grads = [torch.empty_like(x) for x in (q, k_self, v_self)]
    gviews = [_to_head_major(x, layout) for x in grads]
    for name, x in zip(("dq", "dk_self", "dv_self"), gviews):
        _check_bf16_rows(name, x, dev)

    segs = (_SegB * MAX_SEGMENTS)()
    keep, dsegs = [], []
    for i, (k, v, mask, scale) in enumerate(segments):
        _check_bf16_rows(f"segment {i} k", k, dev)
        _check_bf16_rows(f"segment {i} v", v, dev)
        t = k.shape[2]
        if k.dim() != 4 or k.shape[:2] != (b, h) or v.shape != k.shape or t < 1:
            raise ValueError(f"segment {i} k/v must be (B, H, T>=1, {HEAD_DIM}), "
                             f"got {tuple(k.shape)}/{tuple(v.shape)}")
        bias = _bias_of(mask)
        if bias.shape != (g, b, t) or bias.device != dev or bias.stride(-1) != 1:
            raise ValueError(f"segment {i} mask must be ({g}, {b}, {t}) on {dev} "
                             f"with a contiguous last axis, got {tuple(bias.shape)}")
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        _check_bf16_rows(f"segment {i} dk", dk, dev)
        _check_bf16_rows(f"segment {i} dv", dv, dev)
        keep.append(bias)
        dsegs += [dk, dv]
        segs[i] = _SegB(k.data_ptr(), v.data_ptr(), bias.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), *k.stride()[:3], *v.stride()[:3], *dk.stride()[:3],
                        *dv.stride()[:3], bias.stride(0), bias.stride(1),
                        t, 1.0 if scale is None else float(scale))
    r = torch.empty((g, b, h, s), dtype=torch.float32, device=dev)  # rowsum(dO*O)
    strides = (ctypes.c_longlong * 32)(*(st for x in views + gviews for st in x.stride()[:4]))
    err = _bwd_fn()(*(x.data_ptr() for x in views), lse.data_ptr(), r.data_ptr(),
                    *(x.data_ptr() for x in gviews), strides, g, b, h, s, s,
                    segs, len(segments), _LOG2E / math.sqrt(HEAD_DIM),
                    1.0 / math.sqrt(HEAD_DIM), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"joint_attention_bwd kernel launch failed: CUDA error {err}")
    joint_attention_bwd.launches += 1
    return grads[0], grads[1], grads[2], dsegs


def joint_attention_bwd(q, k_self, v_self, segments, do, layout: str = "hm",
                        out=None, lse=None):
    """Gradients of `joint_attention` with respect to q, k_self, v_self and
    each segment's k and v, for the output cotangent `do`. CPU tensors take
    `joint_attention_bwd_plain`; CUDA tensors launch kernel K3, which needs
    K1's `out` and `lse` of the same forward, or raise."""
    if q.device.type == "cpu":
        return joint_attention_bwd_plain(q, k_self, v_self, segments, do, layout)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if out is None or lse is None:
        raise ValueError("the CUDA backward needs the forward's out and lse (kernel K1)")
    return _joint_attention_bwd_cuda(q, k_self, v_self, segments, out, lse, do, layout)


joint_attention_bwd.launches = 0


class _TrainableAttention(torch.autograd.Function):
    """Counterpart of `_make_trainable_attention`'s custom_vjp: inputs
    (layout, n segments, q, k_self, v_self, then k, v, bias, scale per
    segment). Biases and scales get zero gradients: they come from masks
    and configuration, never from parameters."""

    @staticmethod
    def forward(ctx, layout, nseg, q, k_self, v_self, *flat):
        segments = [tuple(flat[4 * i:4 * i + 4]) for i in range(nseg)]
        ctx.layout, ctx.scales = layout, [sg[3] for sg in segments]
        if q.device.type == "cuda":
            g, b, h, s = _to_head_major(q, layout).shape[:4]
            lse = torch.empty((g, b, h, s), dtype=torch.float32, device=q.device)
            out = _joint_attention_cuda(q, k_self, v_self, segments, layout, None, None, lse)
            ctx.save_for_backward(q, k_self, v_self, out, lse,
                                  *(t for sg in segments for t in sg[:3]))
        elif q.device.type == "cpu":
            out = joint_attention_plain(q, k_self, v_self, segments, layout)
            ctx.save_for_backward(q, k_self, v_self, *(t for sg in segments for t in sg[:3]))
        else:
            raise ValueError(f"unsupported device {q.device}")
        return out

    @staticmethod
    def backward(ctx, do):
        saved = ctx.saved_tensors
        q, k_self, v_self = saved[:3]
        on_card = q.device.type == "cuda"
        out, lse = saved[3:5] if on_card else (None, None)
        rest = saved[5:] if on_card else saved[3:]
        segments = [(rest[3 * i], rest[3 * i + 1], rest[3 * i + 2], sc)
                    for i, sc in enumerate(ctx.scales)]
        dq, dks, dvs, dsegs = joint_attention_bwd(q, k_self, v_self, segments, do.contiguous(),
                                                  ctx.layout, out, lse)
        grads = [None, None, dq, dks, dvs]
        for i, (_, _, bias, _) in enumerate(segments):
            zero_bias = torch.zeros_like(bias) if ctx.needs_input_grad[7 + 4 * i] else None
            grads += [dsegs[2 * i], dsegs[2 * i + 1], zero_bias, None]
        return tuple(grads)


def joint_attention_trainable(q, k_self, v_self, segments, layout: str = "hm",
                              self_len=None) -> torch.Tensor:
    """Differentiable segmented joint attention: K1 forward and K3 backward
    on CUDA, the plain pair on the CPU. Arguments as `joint_attention`;
    bool masks become fp32 biases here. `self_len` is inference-only and
    refused, as in the JAX package."""
    if self_len is not None:
        raise ValueError("self_len is inference-only; the trainable attention refuses it")
    flat = []
    for k, v, mask, scale in segments:
        flat += [k, v, _bias_of(mask), None if scale is None else float(scale)]
    return _TrainableAttention.apply(layout, len(segments), q, k_self, v_self, *flat)
