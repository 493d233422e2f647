"""Samples of every whole training step over the span of those steps,
ending in a synchronise."""
from benchmark.harness.readers import rate


def read(rec):
    return rate(rec, "samples")
