"""`jax.random.normal(jax.random.PRNGKey(seed), shape, float32)` in numpy.

A frozen copy of the recipe the served program uses to draw its initial noise
(threefry-2x32 over the flat index, the top 23 bits as a float in [-1, 1),
then sqrt(2)·erfinv with XLA's single-precision polynomial), so that the
reference re-derives each request's noise from its seed alone.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def _threefry2x32(k0, k1, x0, x1):
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


def _erfinv32(x):
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_W_LT5[0]), np.float32(_W_GE5[0])).astype(np.float32)
    for a, b in zip(_W_LT5[1:], _W_GE5[1:]):
        p = np.where(lt, np.float32(a), np.float32(b)).astype(np.float32) + p * w
    return np.where(np.abs(x) == np.float32(1.0), x * np.finfo(np.float32).max, p * x)


def normal(seed: int, shape) -> np.ndarray:
    """float32 standard normals of `PRNGKey(seed)` (64-bit types off)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = _threefry2x32(0, int(seed) & 0xFFFFFFFF, hi, lo)
    bits = b0 ^ b1
    one = np.float32(1.0)
    lo_f = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - one
    u = np.maximum(floats * (one - lo_f) + lo_f, lo_f)
    return (np.float32(np.sqrt(2)) * _erfinv32(u)).astype(np.float32).reshape(shape)
