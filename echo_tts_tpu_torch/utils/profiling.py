"""Tracing, profiling and speed-of-light figures.

  * span() / count(): the program's own spans and counters, recorded only
    between enable() and disable() and handed out by drain() / counters()
    (below),
  * trace(): a torch.profiler capture written as a chrome trace (open it in
    Perfetto or chrome://tracing),
  * kernel_family() / device_time_by_family(): a profile's device time summed
    by kernel family (the port's kernels by id, library GEMMs, convolutions,
    the rest),
  * speed_of_light(): analytic per-forward floor from tensor-core FLOPs and
    device-memory bytes, the utilization denominator for bench reporting,
  * allgather_metric(): one value from every rank.

Spans. `with span(name, kind, **attrs) as sp:` marks a stretch of host work
at a layer boundary; `sp.seconds` is its duration whether or not recording
is on, so a caller's timings come from the span's own two clock reads. The
kind says what the host does meanwhile:

  launch  enqueues device work (the sampler's steps, the codec, K2's packing)
  sync    waits for the device (`.cpu()`, `bool(tensor)`, a synchronize)
  host    works on the host alone (tokenize, batch formation, emission)
  wait    a client waiting on the engine

A record is (id, parent, name, kind, t0, t1, thread, attrs): t0 and t1 from
`time.perf_counter_ns()` (the clock of `time.perf_counter()`), the parent the
span open below it on the same thread (0 for a root). A span opened with a
`batch`, `request` or `requests` attribute passes it on to every span opened
inside it, so a batch's spans all carry its id. Records go into a ring of
RING entries; the counter `tracing.dropped` counts the records it lost. With
recording off (the default) a span costs one flag test and two clock reads,
and `count()` one flag test.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
from time import perf_counter_ns
from typing import Dict, List, NamedTuple, Optional

from echo_tts_tpu_torch.core.config import DiTConfig

RING = 1 << 17
_INHERITED = ("batch", "request", "requests")


class Record(NamedTuple):
    id: int
    parent: int
    name: str
    kind: str
    t0: int
    t1: int
    thread: int
    attrs: dict


_on = False
_mu = threading.Lock()
_ring: "collections.deque[Record]" = collections.deque(maxlen=RING)
_counts: Dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    """Start recording spans and counters (in every thread)."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> List[Record]:
    """The records held, oldest first; the ring is emptied."""
    with _mu:
        out = list(_ring)
        _ring.clear()
    return out


def counters() -> Dict[str, int]:
    """A copy of the counters' current values."""
    with _mu:
        return dict(_counts)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` (while recording)."""
    if _on:
        with _mu:
            _counts[name] = _counts.get(name, 0) + n


def _keep(rec: Record) -> None:
    with _mu:
        if len(_ring) == _ring.maxlen:
            _counts["tracing.dropped"] = _counts.get("tracing.dropped", 0) + 1
        _ring.append(rec)


def add(name: str, kind: str, t0: int, t1: int, thread: Optional[int] = None, **attrs) -> None:
    """Record a span whose ends were stamped elsewhere (perf_counter_ns), as
    a root on `thread` (default: the calling thread): a request's queue wait
    is known only once the dispatcher takes it, on another thread."""
    if _on:
        _keep(Record(next(_ids), 0, name, kind, t0, t1,
                     threading.get_ident() if thread is None else thread, attrs))


class _Clock:
    """What span() gives while recording is off: the two clock reads."""

    __slots__ = ("t0", "t1")

    def __enter__(self):
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, et, ev, tb):
        self.t1 = perf_counter_ns()
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span (kept while recording;
        call it before the span ends)."""


class _Span(_Clock):
    __slots__ = ("name", "kind", "attrs", "id", "parent", "ctx")

    def __init__(self, name: str, kind: str, attrs: dict):
        self.name, self.kind, self.attrs = name, kind, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else 0
        ctx = up.ctx if up is not None else None
        own = [k for k in _INHERITED if k in self.attrs]
        if own:
            ctx = dict(ctx or {}, **{k: self.attrs[k] for k in own})
        self.ctx = ctx
        self.id = next(_ids)
        stack.append(self)
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, et, ev, tb):
        self.t1 = perf_counter_ns()
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        attrs = dict(self.ctx, **self.attrs) if self.ctx else self.attrs
        _keep(Record(self.id, self.parent, self.name, self.kind, self.t0, self.t1,
                     threading.get_ident(), attrs))
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


def span(name: str, kind: str, **attrs):
    """A context manager over one stretch of host work (see the module doc):
    `with span("pipeline.crop", "host") as sp: ...`, then `sp.seconds`."""
    if not _on:
        return _Clock()
    return _Span(name, kind, attrs)


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
    if "trunk_residual_modulate_kernel" in name:
        return "K6 trunk_residual_modulate"
    if "trunk_qk_norm_rope_kernel" in name:
        return "K7 trunk_qk_norm_rope"
    if "trunk_gated_product_kernel" in name:
        return "K8 trunk_gated_product"
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


def allgather_metric(value) -> list:
    """Every rank's `value` (any picklable object), in rank order, on every
    rank (`dist.all_gather_object`; [value] for one process): weak-scaling
    aggregation."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out
