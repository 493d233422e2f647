"""Kernel K3 (joint attention backward, its dq and dk/dv passes): the least
time its traced calls could take over their device time."""
from benchmark.harness.readers import roofline


def read(rec):
    return roofline(rec, "k3")
