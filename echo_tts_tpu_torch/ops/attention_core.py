"""A bare check of the attention kernels' shared Hopper core.

`csrc/attention_core.cuh` holds the `wgmma`, `mbarrier`, `cp.async` and
swizzle wrappers that K1 (`csrc/joint_attention.cu`) and K1v
(`csrc/joint_attention_variants.cu`) are built on. A wrong pairing of
swizzle, matrix descriptor and transpose flag gives plausible but wrong
numbers, so `core_products` runs the two products of one tile on their own
(`csrc/attention_core_check.cu`), and `chip_smoke.py` holds them against
`core_products_plain` before it checks the attention kernels:

    s = a · bᵀ                    (64, 64) fp32
    o = bf16(s · p_scale) · v     (64, 128) fp32

with a, b, v (64, 128) bf16; `b_transposed` passes bᵀ (128, 64) instead, the
orientation of K1v's `k_t` keys; `a_from_registers` takes a as register
fragments (what K1 and K1v do with q) instead of from shared memory. It is on
no model path and needs a CUDA card.
"""
from __future__ import annotations

import ctypes

import torch

_FN = None


def _fn():
    global _FN
    if _FN is None:
        from echo_tts_tpu_torch.ops import _build

        f = _build.load("attention_core_check").attention_core_check
        vp = ctypes.c_void_p
        f.argtypes = [vp, vp, vp, vp, vp, ctypes.c_float, ctypes.c_int, ctypes.c_int, vp]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def core_products_plain(a, b, v, p_scale: float, b_transposed: bool = False):
    """(s, o) in fp32 with PyTorch's matmul; the weights are rounded to bf16
    as the kernel rounds them."""
    bt = b.float() if b_transposed else b.float().t()
    s = a.float() @ bt
    return s, (s * p_scale).to(torch.bfloat16).float() @ v.float()


def core_products(a, b, v, p_scale: float, b_transposed: bool = False,
                  a_from_registers: bool = True):
    """(s, o) from the core's two `wgmma` products on one warpgroup."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"core_products needs CUDA tensors, got {dev}")
    b_shape = (128, 64) if b_transposed else (64, 128)
    for name, x, shape in (("a", a, (64, 128)), ("b", b, b_shape), ("v", v, (64, 128))):
        if (x.device != dev or x.dtype != torch.bfloat16 or tuple(x.shape) != shape
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous bfloat16 {shape} on {dev}")
    s = torch.empty((64, 64), dtype=torch.float32, device=dev)
    o = torch.empty((64, 128), dtype=torch.float32, device=dev)
    err = _fn()(a.data_ptr(), b.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(),
                float(p_scale), int(bool(b_transposed)), int(bool(a_from_registers)),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_core_check launch failed: CUDA error {err}")
    return s, o
