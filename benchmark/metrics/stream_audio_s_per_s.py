"""Seconds of audio in every chunk delivered over the time from the window's
start to the last stream's end (every stream begun in the window is drained)."""
from benchmark.harness.readers import rate


def read(rec):
    return rate(rec, "audio_s")
