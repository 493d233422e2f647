"""Timing for the measurement entry points.

The JAX scripts timed a jitted loop at 8 and at 64 iterations on the host's
clock and reported the slope (t64·64 − t8·8)/56, because every execution
carried a fixed dispatch cost that only a difference cancels. On a CUDA card
events are recorded on the stream itself, before and after the launches, so
the fixed cost never enters: `cuda_times` reports the median of `reps` event
timings of one call each, with the spread beside it.

That holds while the kernel outlasts the host's work to launch it. A call that
is shorter on the card than in Python (the attention kernels: tens of
microseconds against the wrapper's checks and ctypes call) would read the
host, so with `graph_iters` > 0 the calls are captured once into a CUDA graph
and the events time its replays: device time per call, whatever the host costs.

On the CPU (a rehearsal of an entry point, never a measurement) the same
function times on the host's clock; `timing_device` names which it was, and
the entry points write it into their result.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict

import torch


def timing_device(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (host clock: a rehearsal, not a measurement)"


def cuda_times(fn: Callable[[], object], *, reps: int = 7, warmup: int = 2,
               device="cuda", graph_iters: int = 0, stream=None) -> Dict[str, float]:
    """{"ms": median, "min_ms", "max_ms", "reps"} of fn(), in ms per call:
    `warmup` untimed calls, then `reps` timed ones. With `graph_iters` > 0 on
    a CUDA device each timed unit is one replay of a CUDA graph that holds
    that many calls (fn must then neither synchronise nor read results back).
    `stream` (graphs only) is the stream the warm-up runs and the capture
    takes place on: a backward through autograd runs on the stream of its
    forward, so it is captured on the stream its forward ran on."""
    device = torch.device(device)
    if stream is not None and graph_iters <= 0:
        raise ValueError("a capture stream needs graph_iters > 0")
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        for _ in range(warmup):
            fn()
    times = []
    if device.type == "cuda":
        run, per = fn, 1
        if graph_iters > 0:
            torch.cuda.synchronize(device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                for _ in range(graph_iters):
                    fn()
            run, per = graph.replay, graph_iters
            run()
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / per)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return {"ms": statistics.median(times), "min_ms": min(times), "max_ms": max(times),
            "reps": reps}


def cuda_ms(fn: Callable[[], object], reps: int = 7, warmup: int = 2,
            graph_iters: int = 0, stream=None) -> float:
    """Median of `reps` CUDA-event timings of fn(), in ms per call."""
    return cuda_times(fn, reps=reps, warmup=warmup, graph_iters=graph_iters,
                      stream=stream)["ms"]


def card_line(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them ("cpu" off the card):
    every time is written beside it."""
    import subprocess

    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def entry_device(cpu: bool) -> torch.device:
    """The device of a measurement entry point: the card, or the CPU when
    the caller asks for it; with no card and no such request it raises."""
    from echo_tts_tpu_torch.core.device import resolve_device

    return resolve_device("cpu" if cpu else None)


def bench_rows(rows, *, unit: str, device, file, graph_iters: int = 0) -> Dict[str, dict]:
    """Time each (name, fn) of `rows`, print one table line per row to `file`
    and return {name: cuda_times(fn)}."""
    out = {}
    for name, fn in rows:
        with torch.no_grad():
            r = cuda_times(fn, device=device, graph_iters=graph_iters)
        out[name] = r
        print(f"{name:46s} {r['ms']:9.3f} {unit}   [{r['min_ms']:.3f} .. {r['max_ms']:.3f}]",
              file=file, flush=True)
    return out
