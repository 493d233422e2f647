"""Tracing, profiling and speed-of-light figures.

Counterpart of `echo_tts_tpu/utils/profiling.py`:
  * PhaseTimer: per-phase wall timers (encode / kv-build / sampler / vocoder)
    with JSON export,
  * trace(): a torch.profiler capture written as a chrome trace (open it in
    Perfetto or chrome://tracing),
  * kernel_family() / device_time_by_family(): a profile's device time summed
    by kernel family (the port's kernels by id, library GEMMs, convolutions,
    the rest),
  * speed_of_light(): analytic per-forward floor from tensor-core FLOPs and
    device-memory bytes, the utilization denominator for bench reporting,
  * metrics_line(): one-line JSON metrics for log scraping.
The multi-process gather of a metric comes with the multi-GPU slice.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict

from echo_tts_tpu_torch.core.config import DiTConfig

log = logging.getLogger("echo_tts_tpu_torch")


class PhaseTimer:
    def __init__(self):
        self.phases: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def as_dict(self) -> Dict[str, float]:
        return {k: round(v, 5) for k, v in self.phases.items()}

    def json(self) -> str:
        return json.dumps(self.as_dict())


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and device trace into `logdir/trace.json` (chrome
    trace format). Yields the profiler, whose `key_averages()` sums device
    time by kernel once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities, acc_events=True)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def kernel_family(name: str) -> str:
    """The family of a device kernel by its name: the port's own kernels by
    id, the library's GEMMs and convolutions, and everything else."""
    low = name.lower()
    if "dq_kernel" in name or "dkdv_kernel" in name:
        return "K3 joint_attention_bwd"
    if "attention_var" in name:
        return "K1v attention_var"
    if "joint_attention" in name:
        return "K1 joint_attention"
    if "res_chain_cf" in name:
        return "K2v-cf res_chain_cf"
    if "res_chain_cl" in name:
        return "K2v-cl/K2s res_chain"
    if "res_unit" in name:
        return "K2 res_chain"
    if "int8_gemm_kernel" in name:  # before the library's "gemm"
        return "K4 int8_gemm"
    if "quant_rows_kernel" in name:
        return "K5 quant_rows"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
        return "GEMM (cuBLAS)"
    if "conv" in low or "cudnn" in low:
        return "conv (cuDNN)"
    return "other (elementwise, norms, copies)"


def device_time_by_family(prof) -> Dict[str, dict]:
    """{family: {"ms", "launches"}} over the device-side events of a finished
    torch.profiler capture (CPU ops also carry their kernels' device time, so
    only events of device type CUDA are summed)."""
    from torch.autograd import DeviceType

    fam: Dict[str, dict] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        row = fam.setdefault(kernel_family(e.key), {"ms": 0.0, "launches": 0})
        row["ms"] += e.device_time_total / 1e3
        row["launches"] += e.count
    return fam


# Per-card envelope (NVIDIA data sheet, SXM part, dense rates at the full
# power limit); add a row for another card.
GPU_SPECS = {
    "h100_sxm": {"bf16_tflops": 989.0, "hbm_gbps": 3350.0},
}


def dit_step_flops(cfg: DiTConfig, batch: int, seq: int, ctx: int) -> float:
    """Tensor-core FLOPs for one DiT trunk forward: 2*P*tokens for the
    matmuls plus attention 2*2*S*(S+ctx)*D per head-layer."""
    d, l, ffn = cfg.model_size, cfg.num_layers, cfg.intermediate_size
    per_layer_params = (5 * d * d                      # wq wk wv wo gate
                        + 2 * cfg.text_model_size * d  # wk/wv_text
                        + 2 * cfg.speaker_model_size * d
                        + 3 * d * ffn
                        + 6 * d * cfg.adaln_rank * 2)
    tokens = batch * seq
    matmul = 2.0 * l * per_layer_params * tokens
    attn = 4.0 * l * batch * seq * (seq + ctx) * d
    return matmul + attn


def speed_of_light(cfg: DiTConfig, batch: int, seq: int, ctx: int,
                   gen: str = "h100_sxm", dtype_bytes: int = 2) -> dict:
    """Per-forward floors: compute-bound (tensor cores) and bandwidth-bound
    (weights read once per forward); the larger is the physical floor."""
    spec = GPU_SPECS[gen]
    flops = dit_step_flops(cfg, batch, seq, ctx)
    d, l, ffn = cfg.model_size, cfg.num_layers, cfg.intermediate_size
    trunk_params = l * (5 * d * d + 2 * cfg.text_model_size * d
                        + 2 * cfg.speaker_model_size * d + 3 * d * ffn)
    weight_bytes = trunk_params * dtype_bytes
    t_compute = flops / (spec["bf16_tflops"] * 1e12)
    t_bw = weight_bytes / (spec["hbm_gbps"] * 1e9)
    return {"flops": flops, "t_compute_ms": t_compute * 1e3,
            "t_weights_ms": t_bw * 1e3,
            "floor_ms": max(t_compute, t_bw) * 1e3}


def metrics_line(name: str, values: dict) -> None:
    """Structured one-line JSON metric (each process logs its own)."""
    log.info("%s", json.dumps({"metric": name, **values}))
