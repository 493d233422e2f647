"""The residual-unit kernels' shared Hopper core: weight packing, and a bare
check of the core on the card.

`csrc/conv_core.cuh` keeps every `wgmma` operand of K2 (`csrc/res_chain.cu`)
and K2v-cl (`csrc/res_chain_variants.cu`) in the strip layout: an operand of
R rows and K channels is K/8 strips of R rows × 8 channels, each row 16
contiguous bytes. A conv7 tap, which reads the staged window j·d rows further
down, is then the window's matrix descriptor moved by j·d·16 bytes. The
weights stream through a ring of (KC × NB) strip tiles, one contiguous block
each; `pack_tiles` lays them out so on the host.

`tap_product` runs the core on one tile (`csrc/conv_core_check.cu`),

    out (64, N) = Σ_j y[row0 + j·d : row0 + j·d + 64] @ w[j]      fp32

and `chip_smoke.py` holds it against `tap_product_plain` (torch.matmul) at
d = 1, 3, 9 and at a row offset that is no multiple of 8 before it checks
K2. It is on no model path and needs a CUDA card.
"""
from __future__ import annotations

import ctypes

import torch

CHECK_N = (48, 64, 96, 128, 192)  # the product widths the core has
CHECK_K = 64  # input channels of the bare check

_FN = None


def pack_tiles(w: torch.Tensor, kc: int, nb: int) -> torch.Tensor:
    """w (J, K, N) as [tap][in][out] -> strip tiles (N/nb, J, K/kc, kc/8, nb, 8):
    pass p (output columns p·nb …), tap j, input chunk c is one contiguous
    (kc × nb) tile whose strip s holds, for each output column n, the 8
    inputs c·kc + 8s … c·kc + 8s + 7."""
    j, k, n = w.shape
    if k % kc or kc % 16 or n % nb or nb % 8:
        raise ValueError(f"cannot cut ({j}, {k}, {n}) into {kc} x {nb} tiles")
    return (w.reshape(j, k // kc, kc // 8, 8, n // nb, nb)
            .permute(4, 0, 1, 2, 5, 3).contiguous())


def _fn():
    global _FN
    if _FN is None:
        from echo_tts_tpu_torch.ops import _build

        f = _build.load("conv_core_check").conv_core_check
        vp, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, vp, vp, i, i, i, i, vp]
        f.restype = i
        _FN = f
    return _FN


def tap_product_plain(y: torch.Tensor, w: torch.Tensor, row0: int, d: int) -> torch.Tensor:
    """Σ_j y[row0 + j·d : row0 + j·d + 64] @ w[j] in fp32 with torch.matmul."""
    return sum(y[row0 + j * d:row0 + j * d + 64].float() @ w[j].float()
               for j in range(w.shape[0]))


def tap_product(y: torch.Tensor, w: torch.Tensor, row0: int, d: int) -> torch.Tensor:
    """The same product from the core's window, ring and shifted descriptors:
    y (R, 64) bf16, w (7, 64, N) bf16 with N in CHECK_N."""
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"tap_product needs CUDA tensors, got {dev}")
    rows, n = y.shape[0], w.shape[-1]
    if (y.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or y.shape[1] != CHECK_K
            or tuple(w.shape[:2]) != (7, CHECK_K) or n not in CHECK_N
            or rows < row0 + 64 + 6 * d or not y.is_contiguous()):
        raise ValueError(f"y must be a contiguous bf16 (R >= {row0 + 64 + 6 * d}, {CHECK_K}) "
                         f"and w a bf16 (7, {CHECK_K}, N), N in {CHECK_N}; got "
                         f"{tuple(y.shape)} {y.dtype}, {tuple(w.shape)} {w.dtype}")
    packed = pack_tiles(w, CHECK_K, n)
    out = torch.empty((64, n), dtype=torch.float32, device=dev)
    err = _fn()(y.data_ptr(), packed.data_ptr(), out.data_ptr(), rows, int(row0), int(d), n,
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_core_check launch failed: CUDA error {err}")
    return out
