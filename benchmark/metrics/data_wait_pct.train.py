"""Share of the window spent in next() on the prefetching batch iterator,
over the steps that ended before the traced slice began (the profiler
stalls the host inside it)."""
from benchmark.harness.readers import before_slice


def read(rec):
    steps = before_slice(rec, "work")
    span = max(x[1] for x in steps) - rec["t0"] if steps else 0
    return 100.0 * sum(x[3] for x in steps) / span if span > 0 else None
