"""Model operations of the work the window completed before the traced
slice (harness/flops.py; the profiler stalls the host inside the slice)
over the time it took, at the card's published dense bf16 peak."""
from benchmark.harness.readers import mfu


def read(rec):
    return mfu(rec)
