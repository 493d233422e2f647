"""Median time from a stream's request to its first chunk, on the client's
clock, over the streams whose first chunk came before the traced slice
began (the profiler stalls the host inside it)."""
import statistics

from benchmark.harness.readers import before_slice


def read(rec):
    t = [first - sub for sub, first in before_slice(rec, "ttfa")]
    return statistics.median(t) if t else None
