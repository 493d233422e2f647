"""Kernel families by device-kernel name: the served program's own kernels
by id, the library's GEMMs and convolutions, and the rest (a copy of the
classifier the program's profiling helpers use, kept with the yardstick)."""
from __future__ import annotations


def family(name: str) -> str:
    low = name.lower()
    if "dq_kernel" in name or "dkdv_kernel" in name:
        return "K3"
    if "attention_var" in name:
        return "K1v"
    if "joint_attention" in name:
        return "K1"
    if "res_chain_cf" in name:
        return "K2v-cf"
    if "res_chain_cl" in name:
        return "K2v-cl/K2s"
    if "res_unit" in name:
        return "K2"
    if "int8_gemm_kernel" in name:
        return "K4"
    if "quant_rows_kernel" in name:
        return "K5"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
        return "GEMM"
    if "conv" in low or "cudnn" in low:
        return "conv"
    return "other"
