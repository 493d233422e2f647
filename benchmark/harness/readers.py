"""Arithmetic the metric readers share: each reader in benchmark/metrics/
takes the run's record (what the runner measured and counted) and returns
its metric, or None when the run has nothing to read for it."""
from __future__ import annotations

from typing import Optional

from . import flops


def rate(rec: dict, amount: str) -> Optional[float]:
    span = rec.get("span_s")
    return rec[amount] / span if span and span > 0 else None


def slice_start(rec: dict) -> float:
    """The host time at which the traced slice began (inf where none was
    taken). The profiler stalls the host from there to the end of its stop,
    so the host-clock metrics of a traced run read only what came before."""
    tr = rec.get("trace")
    return tr["host_from"] if tr else float("inf")


def before_slice(rec: dict, key: str) -> list:
    """The items of rec[key], each (start, end, ...), that ended before the
    traced slice began."""
    a = slice_start(rec)
    return [x for x in rec.get(key, []) if x[1] <= a]


def mfu(rec: dict) -> Optional[float]:
    """Model operations of the work completed before the slice, over the
    time from the window's start to the last of those completions."""
    done = before_slice(rec, "work")
    if not done:
        return None
    span = max(x[1] for x in done) - rec["t0"]
    return flops.mfu_pct(sum(x[2] for x in done), span) if span > 0 else None


def idle(rec: dict) -> Optional[float]:
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline(rec: dict, kernel: str) -> Optional[float]:
    """Share of the least time the kernel's traced calls could take (by
    their shapes and valid keys, at the card's published peaks) in their
    device time."""
    tr = rec.get("trace")
    calls = tr.get(kernel) if tr else None
    if not calls:
        return None
    return 100.0 * sum(b for b, _ in calls) / sum(d for _, d in calls)


def rows_per_batch(rec: dict) -> Optional[float]:
    h0, h1 = rec["health"]
    batches = h1["batches"] - h0["batches"]
    return (h1["requests"] - h0["requests"]) / batches if batches else None
