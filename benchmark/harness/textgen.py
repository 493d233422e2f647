"""Inputs made from the run's seed: texts, speaker prompts, request seeds,
and the arrival schedule of an open loop. Every draw takes its own
generator keyed by (seed, stream, index), so a client's j-th request is the
same whatever the other clients did before it."""
from __future__ import annotations

import numpy as np

_WORDS = (
    "the quiet harbor morning light carried voices across water while old "
    "boats rocked against the pier and gulls argued over scraps a letter "
    "arrived from the north with news of rain storms and a wedding planned "
    "for spring she read it twice then folded the paper into her coat "
    "pocket walking slowly toward the market where bread and apples waited "
    "under striped awnings children ran between the stalls laughing as a "
    "fiddler played a tune nobody remembered learning history books say "
    "the town was founded by sailors who lost their way in fog and decided "
    "to stay because the fish were plentiful and the hills kept the wind "
    "away every evening lamps were lit along the road and the baker "
    "counted his coins before locking the door"
).split()


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *[int(k) for k in keys]])


def text(seed: int, *keys: int, lo: int = 40, hi: int = 700) -> str:
    """An ASCII sentence run of a length drawn uniformly in [lo, hi] bytes."""
    g = rng(seed, 1, *keys)
    n = int(g.integers(lo, hi + 1))
    words, size = [], 0
    while size < n:
        w = _WORDS[int(g.integers(len(_WORDS)))]
        words.append(w)
        size += len(w) + 1
    out = " ".join(words)[:n].rstrip()
    out = out[0].upper() + out[1:]
    return out[:-1] + "." if len(out) >= n else out + "."


def prompt(seed: int, *keys: int, lo_s: float = 10.0, hi_s: float = 25.0,
           sample_rate: int = 44100) -> np.ndarray:
    """A speaker prompt (1, samples) float32 of a duration drawn in
    [lo_s, hi_s]: a few harmonics with a slow vibrato over noise."""
    g = rng(seed, 2, *keys)
    n = int(g.uniform(lo_s, hi_s) * sample_rate)
    t = np.arange(n, dtype=np.float64) / sample_rate
    f0 = g.uniform(90.0, 240.0)
    phase = 2 * np.pi * f0 * (t + 0.002 * np.sin(2 * np.pi * 5.0 * t))
    x = sum((0.3 / k) * np.sin(k * phase + g.uniform(0, 2 * np.pi)) for k in range(1, 6))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * g.uniform(1.5, 4.0) * t))
    x = x + 0.02 * g.standard_normal(n)
    return x.astype(np.float32)[None]


def request_seed(seed: int, *keys: int) -> int:
    """A request's sampler seed: 32 bits, as the served sampler takes it."""
    return int(rng(seed, 3, *keys).integers(0, 2**32))


def poisson_arrivals(seed: int, rate_hz: float, n: int) -> np.ndarray:
    """Arrival times (s) of an open loop: exponential gaps at `rate_hz`."""
    return np.cumsum(rng(seed, 4).exponential(1.0 / rate_hz, size=n))
