"""Requests over micro-batches the engine ran in the window (its health
counters)."""
from benchmark.harness.readers import rows_per_batch


def read(rec):
    return rows_per_batch(rec)
