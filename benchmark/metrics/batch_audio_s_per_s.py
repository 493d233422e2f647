"""Seconds of audio returned over the time from the window's start to the
last completion (every request sent in the window is drained)."""
from benchmark.harness.readers import rate


def read(rec):
    return rate(rec, "audio_s")
