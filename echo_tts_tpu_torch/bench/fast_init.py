"""Fast random weights for benchmarks and the checkpoint phase of
chip_smoke.py (counterpart of echo_tts_tpu/bench/fast_init.py).

Benchmarks need weights of the right shapes at a sane scale, not the
initializer's distributions. The shapes come from the port's initializer
run on the `meta` device (nothing is computed); the values from numpy
generators on the host: N(0, scale) for every leaf of two or more
dimensions, ones for 1-D leaves (norm weights, biases), each leaf made on
the host and copied once to `device` in the initializer's dtype. A leaf is
drawn in chunks of 2^22 values, chunk i of the whole tree from
`np.random.default_rng` of the i-th child of `SeedSequence(seed)`, on a
thread pool (numpy's generators release the GIL), so the values depend on
the seed alone and a full-width DiT takes seconds, not a minute.

    params = fast_random_like(lambda dev: init_dit_params(cfg, torch.bfloat16, dev))
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from echo_tts_tpu_torch.core.device import resolve_device

_CHUNK = 1 << 22


def fast_random_like(init_fn: Callable[[torch.device], Any], seed: int = 0,
                     scale: float = 0.02, device=None) -> Any:
    """init_fn(device) builds a tree of tensors (dicts, lists); it is called
    once with the meta device. Returns the same tree filled from numpy on
    `device` (default cuda)."""
    dev = resolve_device(device)
    seeds = np.random.SeedSequence(seed)

    def draw(out: np.ndarray, child) -> None:
        np.random.default_rng(child).standard_normal(out=out, dtype=np.float32)
        np.multiply(out, np.float32(scale), out=out)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        def fill(leaf):
            if isinstance(leaf, dict):
                return {k: fill(v) for k, v in leaf.items()}
            if isinstance(leaf, (list, tuple)):
                return [fill(v) for v in leaf]
            if leaf.dim() <= 1:
                host = np.ones(tuple(leaf.shape), dtype=np.float32)
            else:
                host = np.empty(tuple(leaf.shape), dtype=np.float32)
                flat = host.reshape(-1)
                starts = range(0, flat.size, _CHUNK)
                list(pool.map(draw, [flat[i:i + _CHUNK] for i in starts],
                              seeds.spawn(len(starts))))
            return torch.from_numpy(host).to(dev).to(leaf.dtype)

        return fill(init_fn(torch.device("meta")))
