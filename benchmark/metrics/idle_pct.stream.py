"""Share of the traced slice of the window with no operation on the device."""
from benchmark.harness.readers import idle


def read(rec):
    return idle(rec)
