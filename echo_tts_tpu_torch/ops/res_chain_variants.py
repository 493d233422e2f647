"""Kernels K2v-cl, K2v-cf and K2s: the fused three-unit residual chain of the
S1-DAC decoder tail, in the variants the measurement scripts time.

Counterparts of `scripts/bench_conv_kernel_variants.py:res_chain` (body
`_kernel`), `:res_chain_cf` (body `_kernel_cf`) and of the three snake
bodies of `scripts/bench_conv_variants.py:make_kernel`. All compute, for the
dilations (1, 3, 9),

    x <- x + conv1x1(snake(conv7_dilated_causal(snake(x)) + b7)) + b1

where rows before the sequence start stand for each conv's causal zero pad.
`units` is the list of three {snake1 (1,C,1), conv1 {w (O,I,7), b}, snake2,
conv2 {w (O,I,1), b}} of `ops/res_chain.py`.

`res_chain` (channels-last (B, T, C)). Flags that change the function:
`use_sin` True (sin), "poly" (the sin² polynomial of K2) or False (snake
replaced by z·α: wrong math that bounds the sine's cost); `snake_dtype`
float32 or bfloat16 (every operation of the snake rounded to bf16; not with
"poly"); `tap_offsets=False` reads every tap at offset 0 (wrong math, aligned
reads; ignored under pack_taps, as in the Pallas body); `live_mode="off"`
skips the re-zero of the pad rows, which then evolve as the chain on zeros
(the plain version prepends 80 zero rows and drops them). Flags that only choose the schedule: `live_mode` "where" or
"mult" (select, or multiply by a 0/1 column); `pack_taps` (the seven shifted
row groups of each 32-channel chunk staged side by side, one product of
depth 7·32, against seven tap products read from the window in place);
`tile_t`, output rows per block, a multiple of 16 that shared memory bounds
(C=192: up to 96, 48 with pack_taps; C=96: up to 384, 304 with pack_taps;
the defaults are those largest values).

`res_chain_cf` (channels-first (B, C, T)): halo 128, pad columns re-zeroed by
multiply, `use_sin` True or False, `tile_t` up to 96 at C=192 and 400 at
C=96 (default 96, the fastest measured at both). Equals `res_chain` on the
transposed input.

`res_chain_snake` (channels-last): K2's chain with the snake "exact" (sin),
"none" (identity) or "poly" (`snake_poly`, a range-reduced Taylor cosine,
not K2's sin² polynomial).

Each wrapper launches its CUDA kernel (K2v-cl: `csrc/res_chain_variants.cu`
on the `wgmma` conv core `csrc/conv_core.cuh`; K2s: `csrc/res_chain_snake.cu`;
K2v-cf: `csrc/res_chain_cf.cu`; bf16, C 96 or 192, one launch per chain) for
CUDA tensors and runs its plain version for CPU tensors; anything the kernel
does not take raises. `.launches` on each wrapper counts launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from echo_tts_tpu_torch.ops.res_chain import tensor_leaves, round_up, sin2_poly

KS = 7
DILS = (1, 3, 9)
HALO_CL = round_up(sum((KS - 1) * d for d in DILS), 16)    # 80
HALO_CF = round_up(sum((KS - 1) * d for d in DILS), 128)   # 128
LIVE_MODES = ("where", "mult", "off")
SNAKE_MODES = ("exact", "none", "poly")
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
# the kernel's snake codes (res_chain_variants.cu)
_SNAKE_CODE = {True: 0, "poly": 1, False: 2, "exact": 0, "none": 3, "poly_cos": 4}


def _check_units(units, c: int) -> None:
    if len(units) != len(DILS):
        raise ValueError(f"the chain has {len(DILS)} units (dilations {DILS}), got {len(units)}")
    for u in units:
        w7, w1 = u["conv1"]["w"], u["conv2"]["w"]
        if tuple(w7.shape) != (c, c, KS) or tuple(w1.shape) != (c, c, 1):
            raise ValueError(f"unit weights must be ({c}, {c}, {KS}) and ({c}, {c}, 1), "
                             f"got {tuple(w7.shape)} and {tuple(w1.shape)}")


def _bias(conv: dict, c: int, like: torch.Tensor) -> torch.Tensor:
    b = conv.get("b")
    return torch.zeros(c, device=like.device) if b is None else b.float()


def snake_poly(xf: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + (1 - cos(2αx)) / (2(α + 1e-9)) with a Taylor cosine (Horner, fp32)
    after range reduction; torch.round rounds half to even, as jnp.round."""
    two_pi = 2.0 * math.pi
    z = (2.0 * alpha) * xf
    n = torch.round(z * (1.0 / two_pi))
    r = z - n * two_pi
    u = r * r
    c = torch.full_like(u, -1.0 / 87178291200.0)
    for coef in (1.0 / 479001600.0, -1.0 / 3628800.0, 1.0 / 40320.0,
                 -1.0 / 720.0, 1.0 / 24.0, -0.5):
        c = c * u + coef
    cosr = c * u + 1.0
    return xf + (1.0 - cosr) * (0.5 / (alpha + 1e-9))


def _chain_cl_plain(x, units, snk, *, rezero: bool, tap_offsets: bool = True,
                    pack_taps: bool = False):
    """The chain on channels-last x with snake `snk(z, alpha)`, rounded to
    x's dtype where the Pallas bodies round: after snake1, after snake2 and
    after the residual sum. Without `rezero` the 80 pad rows are carried
    along and evolve."""
    b, t, c = x.shape
    _check_units(units, c)
    dtype = x.dtype
    if not rezero:
        x = F.pad(x, (0, 0, HALO_CL, 0))
    rows = x.shape[1]
    for u, d in zip(units, DILS):
        y = snk(x, u["snake1"].reshape(-1)).to(dtype)
        yp = F.pad(y, (0, 0, (KS - 1) * d, 0)).float()
        w7 = u["conv1"]["w"].float().permute(2, 1, 0)  # (K, I, O)
        # the packed form always reads its taps at their offsets, as `_kernel` does
        offs = [j * d if (tap_offsets or pack_taps) else 0 for j in range(KS)]
        if pack_taps:
            xcat = torch.cat([yp[:, o:o + rows] for o in offs], dim=-1)
            acc = xcat @ w7.reshape(KS * c, c) + _bias(u["conv1"], c, x)
        else:
            acc = _bias(u["conv1"], c, x).expand(b, rows, c)
            for j, o in enumerate(offs):
                acc = acc + yp[:, o:o + rows] @ w7[j]
        y = snk(acc, u["snake2"].reshape(-1).float()).to(dtype)
        y = y.float() @ u["conv2"]["w"].float()[:, :, 0].t() + _bias(u["conv2"], c, x)
        x = (x.float() + y).to(dtype)
    return x if rezero else x[:, HALO_CL:]


def _variant_snake(use_sin, snake_dtype):
    if use_sin not in (True, False, "poly"):
        raise ValueError(f"use_sin must be True, False or 'poly', got {use_sin!r}")
    if snake_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"snake_dtype must be float32 or bfloat16, got {snake_dtype}")
    if use_sin == "poly" and snake_dtype != torch.float32:
        raise NotImplementedError("the sin² polynomial runs in float32 only")

    def snk(z, a):
        if not use_sin:
            return z * a
        zf, af = z.to(snake_dtype), a.to(snake_dtype)
        if use_sin == "poly":
            return zf + (1.0 / (af + 1e-9)) * sin2_poly(af * zf)
        return zf + (1.0 / (af + 1e-9)) * torch.square(torch.sin(af * zf))

    return snk


def res_chain_plain(x, units, *, live_mode: str = "where", snake_dtype=torch.float32,
                    tile_t: Optional[int] = None, use_sin=True, tap_offsets: bool = True,
                    pack_taps: bool = False) -> torch.Tensor:
    """The arithmetic of `_kernel` in PyTorch (tile_t does not change it)."""
    if live_mode not in LIVE_MODES:
        raise ValueError(f"live_mode must be one of {LIVE_MODES}, got {live_mode!r}")
    return _chain_cl_plain(x, units, _variant_snake(use_sin, snake_dtype),
                           rezero=live_mode != "off", tap_offsets=tap_offsets,
                           pack_taps=pack_taps)


def res_chain_snake_plain(x, units, snake_mode: str, *,
                          tile_t: Optional[int] = None) -> torch.Tensor:
    """The arithmetic of `make_kernel(snake_mode)` in PyTorch: fp32 snake."""
    if snake_mode not in SNAKE_MODES:
        raise ValueError(f"snake_mode must be one of {SNAKE_MODES}, got {snake_mode!r}")

    def snk(z, a):
        zf, af = z.float(), a.float()
        if snake_mode == "none":
            return zf
        if snake_mode == "poly":
            return snake_poly(zf, af)
        return zf + (1.0 / (af + 1e-9)) * torch.square(torch.sin(af * zf))

    return _chain_cl_plain(x, units, snk, rezero=True)


def res_chain_cf_plain(x, units, *, use_sin: bool = True,
                       tile_t: Optional[int] = None) -> torch.Tensor:
    """The arithmetic of `_kernel_cf` in PyTorch, on channels-first
    (B, C, T): products Wᵀ·y, fp32 snake, pad columns standing for zeros."""
    b, c, t = x.shape
    _check_units(units, c)
    dtype = x.dtype

    def snk(z, a):
        zf, af = z.float(), a.float().reshape(-1)[:, None]
        if not use_sin:
            return zf * af
        return zf + (1.0 / (af + 1e-9)) * torch.square(torch.sin(af * zf))

    for u, d in zip(units, DILS):
        y = snk(x, u["snake1"]).to(dtype)
        yp = F.pad(y, ((KS - 1) * d, 0)).float()
        w7 = u["conv1"]["w"].float()  # (O, I, K)
        acc = _bias(u["conv1"], c, x)[:, None].expand(b, c, t)
        for j in range(KS):
            acc = acc + torch.einsum("oi,bit->bot", w7[:, :, j], yp[:, :, j * d:j * d + t])
        y = snk(acc, u["snake2"]).to(dtype)
        y = torch.einsum("oi,bit->bot", u["conv2"]["w"].float()[:, :, 0], y.float())
        x = (x.float() + y + _bias(u["conv2"], c, x)[:, None]).to(dtype)
    return x


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------

_FNS = None
# the largest tile_t shared memory allows per C, without and with pack_taps
# (csrc/res_chain_variants.cu): the defaults
CL_TILE = {192: (96, 48), 96: (384, 304)}


def _fns():
    global _FNS
    if _FNS is None:
        from echo_tts_tpu_torch.ops import _build

        vp, i = ctypes.c_void_p, ctypes.c_int
        cl = _build.load("res_chain_variants")
        sn = _build.load("res_chain_snake")
        cf = _build.load("res_chain_cf")
        cl.res_chain_var_fwd.argtypes = [vp] * 9 + [i] * 9 + [vp]
        sn.res_chain_snake_fwd.argtypes = [vp] * 10 + [i] * 5 + [vp]
        cf.res_chain_cf_fwd.argtypes = [vp] * 10 + [i] * 5 + [vp]
        cl.res_chain_var_smem_bytes.argtypes = [i, i, i]
        sn.res_chain_snake_smem_bytes.argtypes = [i, i]
        cf.res_chain_cf_smem_bytes.argtypes = [i, i]
        for f in (cl.res_chain_var_fwd, sn.res_chain_snake_fwd, cf.res_chain_cf_fwd,
                  cl.res_chain_var_smem_bytes, sn.res_chain_snake_smem_bytes,
                  cf.res_chain_cf_smem_bytes):
            f.restype = i
        _FNS = {"var": cl.res_chain_var_fwd, "snake": sn.res_chain_snake_fwd,
                "cf": cf.res_chain_cf_fwd, "var_smem": cl.res_chain_var_smem_bytes,
                "snake_smem": sn.res_chain_snake_smem_bytes,
                "cf_smem": cf.res_chain_cf_smem_bytes}
    return _FNS


def _operands(units, c: int, device, snake_bf16: bool = False):
    """Kernel-layout operands of the chain: conv7 weights (3, 7, I, O) and
    1x1 weights (3, I, O) in bf16; alphas, their 1/(α+1e-9) and the biases as
    (3, C) fp32. With snake_bf16 the alphas and reciprocals carry bf16
    rounding, as bf16 arithmetic would give them."""
    _check_units(units, c)

    def vec(name):
        rows = []
        for u in units:
            t = u[name[0]] if len(name) == 1 else u[name[0]].get(name[1])
            rows.append(torch.zeros(c, device=device) if t is None
                        else t.reshape(-1).to(device=device, dtype=torch.float32))
        return torch.stack(rows).contiguous()

    def recip(a):
        if snake_bf16:
            return (1.0 / (a.to(torch.bfloat16) + 1e-9)).float().contiguous()
        return 1.0 / (a + 1e-9)

    a1, a2 = vec(("snake1",)), vec(("snake2",))
    if snake_bf16:
        a1, a2 = a1.to(torch.bfloat16).float(), a2.to(torch.bfloat16).float()
    w7 = torch.stack([u["conv1"]["w"].permute(2, 1, 0) for u in units])
    w1 = torch.stack([u["conv2"]["w"][:, :, 0].t() for u in units])
    return (w7.to(device=device, dtype=torch.bfloat16).contiguous(),
            w1.to(device=device, dtype=torch.bfloat16).contiguous(),
            a1, recip(a1), a2, recip(a2), vec(("conv1", "b")), vec(("conv2", "b")))


def packed_weights(w7: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """K2v-cl's weights: per unit the conv7 taps w7[u] (7, I, O) and the 1x1
    w1[u] (I, O) cut into (32 × C) strip tiles (`conv_core.pack_tiles`),
    units one after another, flat."""
    from echo_tts_tpu_torch.ops.conv_core import pack_tiles

    c = w7.shape[-1]
    return torch.cat([torch.cat([pack_tiles(w7[u], 32, c).reshape(-1),
                                 pack_tiles(w1[u][None], 32, c).reshape(-1)])
                      for u in range(w7.shape[0])])


def _check_x(x: torch.Tensor, c: int) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16 for the CUDA kernel, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"x must be contiguous, 3-D and 16-byte aligned, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if c not in (96, 192) or x.numel() == 0:
        raise ValueError(f"the kernel takes C = 96 or 192 and a non-empty x, got "
                         f"shape {tuple(x.shape)}")


def _check_tile(tile_t: int, smem: int) -> None:
    if tile_t < 16 or tile_t % 16:
        raise ValueError(f"tile_t must be a positive multiple of 16, got {tile_t}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"tile_t={tile_t} needs {smem} bytes of shared memory, over the "
                         f"{SMEM_LIMIT} a block may use")


def _launch(wrapper, fn, x, ops, ints):
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), out.data_ptr(), *(o.data_ptr() for o in ops), *ints,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def _res_chain_cuda(x, units, live_mode, snake_dtype, tile_t, use_sin, tap_offsets, pack_taps):
    if live_mode not in LIVE_MODES:
        raise ValueError(f"live_mode must be one of {LIVE_MODES}, got {live_mode!r}")
    _variant_snake(use_sin, snake_dtype)  # validates the pair
    c = x.shape[-1]
    _check_x(x, c)
    if tile_t is None:
        tile_t = CL_TILE[c][1 if pack_taps else 0]
    fns = _fns()
    _check_tile(tile_t, fns["var_smem"](c, max(int(tile_t), 0), int(bool(pack_taps))))
    b16 = snake_dtype == torch.bfloat16
    w7, w1, *vecs = _operands(units, c, x.device, snake_bf16=b16)
    return _launch(res_chain, fns["var"], x, (packed_weights(w7, w1), *vecs),
                   (x.shape[0], x.shape[1], c, int(tile_t), _SNAKE_CODE[use_sin], int(b16),
                    LIVE_MODES.index(live_mode), int(bool(tap_offsets)), int(bool(pack_taps))))


def _refuse_grad(name: str, x, units) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or any(
            w.requires_grad for u in units for w in tensor_leaves(u))):
        raise RuntimeError(f"{name}: the kernel has no backward (the measurement scripts' "
                           f"Pallas kernels have none either); call it under torch.no_grad() "
                           f"with inputs that do not require grad")
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")


def res_chain(x, units: Sequence[dict], *, live_mode: str = "where",
              snake_dtype=torch.float32, tile_t: Optional[int] = None, use_sin=True,
              tap_offsets: bool = True, pack_taps: bool = False) -> torch.Tensor:
    """K2v-cl on channels-last x (B, T, C); see the module's docstring."""
    if x.device.type == "cpu":
        return res_chain_plain(x, units, live_mode=live_mode, snake_dtype=snake_dtype,
                               tile_t=tile_t, use_sin=use_sin, tap_offsets=tap_offsets,
                               pack_taps=pack_taps)
    _refuse_grad("res_chain", x, units)
    return _res_chain_cuda(x, units, live_mode, snake_dtype, tile_t, use_sin, tap_offsets,
                           pack_taps)


def res_chain_snake(x, units: Sequence[dict], snake_mode: str, *,
                    tile_t: Optional[int] = None) -> torch.Tensor:
    """K2s on channels-last x (B, T, C): snake "exact", "none" or "poly"."""
    if x.device.type == "cpu":
        return res_chain_snake_plain(x, units, snake_mode, tile_t=tile_t)
    _refuse_grad("res_chain_snake", x, units)
    if snake_mode not in SNAKE_MODES:
        raise ValueError(f"snake_mode must be one of {SNAKE_MODES}, got {snake_mode!r}")
    c = x.shape[-1]
    _check_x(x, c)
    if tile_t is None:
        tile_t = 96 if c == 192 else 320
    fns = _fns()
    _check_tile(tile_t, fns["snake_smem"](c, max(int(tile_t), 0)))
    code = _SNAKE_CODE["poly_cos" if snake_mode == "poly" else snake_mode]
    return _launch(res_chain_snake, fns["snake"], x, _operands(units, c, x.device),
                   (x.shape[0], x.shape[1], c, int(tile_t), code))


def res_chain_cf(x, units: Sequence[dict], *, use_sin: bool = True,
                 tile_t: Optional[int] = None) -> torch.Tensor:
    """K2v-cf on channels-first x (B, C, T); see the module's docstring."""
    if x.device.type == "cpu":
        return res_chain_cf_plain(x, units, use_sin=use_sin, tile_t=tile_t)
    _refuse_grad("res_chain_cf", x, units)
    c = x.shape[1] if x.dim() == 3 else -1
    _check_x(x, c)
    if tile_t is None:
        tile_t = 96
    fns = _fns()
    _check_tile(tile_t, fns["cf_smem"](c, max(int(tile_t), 0)))
    return _launch(res_chain_cf, fns["cf"], x, _operands(units, c, x.device),
                   (x.shape[0], x.shape[2], c, int(tile_t), int(bool(use_sin))))


res_chain.launches = 0
res_chain_snake.launches = 0
res_chain_cf.launches = 0
