"""Kernel K1 (joint attention): the least time its traced calls could take,
by their shapes and valid keys at the published peaks, over their device time."""
from benchmark.harness.readers import roofline


def read(rec):
    return roofline(rec, "k1")
