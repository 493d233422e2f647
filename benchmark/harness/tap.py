"""The sampler's output latents of every batch the window serves, keyed by
each row's seed, so that the output check can hold the DiT trunk's work by
itself against the reference's latents (the audio's gap is mostly the
codec's own rounding).

The tap wraps three names of the program's pipeline module: `draw_noise`
(which gets the batch's seeds, in row order, just before its sampler runs,
on the same thread), the one-shot sampler (whose result is the batch's
latents) and the streaming loop (whose latent buffer, filled in place
block by block, holds the stream batch's latents once it ends). It keeps a
reference to each result: no copy and no launch on the timed path.
"""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np


class LatentTap:
    def __init__(self):
        self.local = threading.local()
        self.kept: list = []  # (seeds in row order, latents (B, T, C))
        self._orig = None

    def install(self):
        from echo_tts_tpu_torch.pipeline import pipeline as pl

        tap = self
        noise, sample, stream = (pl.draw_noise, pl.sample_euler_cfg_independent_guidances,
                                 pl.stream_blocks_fused)

        def draw_noise(rng_seed, shape, device):
            tap.local.seeds = ([int(rng_seed)] if isinstance(rng_seed, (int, np.integer))
                               else [int(s) for s in rng_seed])
            return noise(rng_seed, shape, device)

        def sampler(*args, **kwargs):
            out = sample(*args, **kwargs)
            tap._keep(out)
            return out

        def blocks(*args, **kwargs):
            first = True
            for item in stream(*args, **kwargs):
                if first:
                    tap._keep(item[0])
                    first = False
                yield item

        pl.draw_noise, pl.sample_euler_cfg_independent_guidances, pl.stream_blocks_fused = (
            draw_noise, sampler, blocks)
        self._orig = (pl, noise, sample, stream)

    def remove(self):
        if self._orig is not None:
            pl, noise, sample, stream = self._orig
            pl.draw_noise, pl.sample_euler_cfg_independent_guidances, pl.stream_blocks_fused = (
                noise, sample, stream)
            self._orig = None

    def _keep(self, latents):
        seeds = getattr(self.local, "seeds", None)
        self.local.seeds = None
        if seeds is not None:
            self.kept.append((seeds, latents))

    def clear(self):
        self.kept = []

    def by_seed(self) -> Dict[int, np.ndarray]:
        """seed -> its row's latents (T, C) in float32 on the host; a seed
        served twice (a retried batch) keeps its last batch's row; the
        engine's pad rows (copies of row 0) are skipped."""
        out = {}
        for seeds, lat in self.kept:
            host = lat.float().cpu().numpy()
            seen = set()
            for i, s in enumerate(seeds[:host.shape[0]]):
                if s not in seen:
                    out[s] = host[i]
                    seen.add(s)
        return out
