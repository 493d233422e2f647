"""`jax.random.normal(jax.random.PRNGKey(seed), shape, float32)` on the host,
in numpy, without JAX: the same seed gives the port the same initial noise as
the JAX package (`echo_tts_tpu/sampling/euler_cfg.py:draw_noise`).

The recipe is JAX's default generator with `jax_threefry_partitionable` on
(the default since JAX 0.5):

  * key: `PRNGKey(seed)` with 64-bit types off is the pair (0, seed mod 2^32);
  * bits: threefry-2x32 (20 rounds) of the key over the counters (hi, lo) of
    the flat index of each element, the two output words XORed;
  * uniform: the top 23 bits as the mantissa of a float in [1, 2), minus 1,
    scaled to [nextafter(-1, 0), 1) and clamped below at that bound;
  * normal: sqrt(2) * erfinv(u) with XLA's single-precision erfinv (the
    Giles polynomial), all in float32.

`jax_fold_in(seed, i)` is the key `jax.random.fold_in(PRNGKey(seed), i)`:
threefry-2x32 of PRNGKey(seed) over the counter words (0, i). `jax_normal`
draws from such a key as from a seed (the blockwise sampler's per-block
noise).

Agreement with JAX on the CPU: max |diff| below 1e-6 (the float32 log1p of
numpy and of XLA may differ in the last bit); `tests/test_torch_sampler.py`
holds it to 2e-6.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# XLA's ErfInv32 (Giles, "Approximating the erfinv function"), highest degree first
_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (jax._src.prng.threefry2x32) of the key
    (k0, k1) over the uint32 counter words x0, x1."""
    ks = (np.uint32(k0), np.uint32(k1), np.uint32(k0) ^ np.uint32(k1) ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _erfinv32(x: np.ndarray) -> np.ndarray:
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_W_LT5[0]), np.float32(_W_GE5[0])).astype(np.float32)
    for a, b in zip(_W_LT5[1:], _W_GE5[1:]):
        p = np.where(lt, np.float32(a), np.float32(b)).astype(np.float32) + p * w
    return np.where(np.abs(x) == np.float32(1.0), x * np.finfo(np.float32).max, p * x)


class JaxKey(NamedTuple):
    """A raw threefry key, the two uint32 words of a JAX PRNG key."""

    k0: int
    k1: int


def jax_key(seed: int) -> JaxKey:
    """`jax.random.PRNGKey(seed)` with 64-bit types off."""
    return JaxKey(0, int(seed) & 0xFFFFFFFF)


def jax_fold_in(seed: Union[int, JaxKey], data: int) -> JaxKey:
    """`jax.random.fold_in(key, data)` of `PRNGKey(seed)` (or of a key)."""
    key = seed if isinstance(seed, JaxKey) else jax_key(seed)
    with np.errstate(over="ignore"):
        w0, w1 = threefry2x32(key.k0, key.k1, np.zeros(1, np.uint32),
                              np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return JaxKey(int(w0[0]), int(w1[0]))


def _normal_one(key: JaxKey, shape) -> np.ndarray:
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key.k0, key.k1, hi, lo)
    bits = b0 ^ b1
    one = np.float32(1.0)
    lo_f = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - one
    u = np.maximum(floats * (one - lo_f) + lo_f, lo_f)
    return (np.float32(np.sqrt(2)) * _erfinv32(u)).astype(np.float32).reshape(shape)


def jax_normal(seeds: Union[int, JaxKey, Sequence[int]], shape) -> np.ndarray:
    """float32 standard normals as `jax.random.normal(PRNGKey(seed), shape)`
    draws them, or `jax.random.normal(key, shape)` for a `JaxKey`. With one
    seed per row (a sequence), row i is the draw of seeds[i] at `shape`, and
    the result is (len(seeds), *shape): the rows a batch of requests with
    their own seeds needs."""
    shape = tuple(int(s) for s in shape)
    if isinstance(seeds, JaxKey):
        return _normal_one(seeds, shape)
    if isinstance(seeds, (int, np.integer)):
        return _normal_one(jax_key(seeds), shape)
    return np.stack([_normal_one(jax_key(s), shape) for s in seeds])
