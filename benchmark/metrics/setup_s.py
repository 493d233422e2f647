"""Process start to the window's start: weights, kernel build or load,
pre-encoding, warm-up."""


def read(rec):
    return rec["setup_s"]
