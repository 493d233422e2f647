"""Rotary position embeddings (counterpart of echo_tts_tpu/core/rope.py).

Real (cos, sin) tables and an explicit 2x2 rotation of adjacent lane pairs.
The tables are shared by every row of a batch, or gathered one row at a
time (`rope_rows`) when the rows of a continuous group sit at their own
positions; `row_slots` gives such rows' own slices of a buffer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def precompute_rope(dim: int, end: int, theta: float = 10000.0, device=None):
    """(cos, sin) tables of shape (end, dim//2), fp32, computed on the host
    in float64 then cast."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim))
    t = np.arange(end, dtype=np.float64)
    angles = np.outer(t, freqs)
    return (
        torch.as_tensor(np.cos(angles), dtype=torch.float32, device=device),
        torch.as_tensor(np.sin(angles), dtype=torch.float32, device=device),
    )


def per_row(pos) -> bool:
    """True for one position a row (a (B,) tensor, array, list or tuple);
    False for one int shared by every row."""
    return isinstance(pos, (list, tuple)) or getattr(pos, "ndim", 0) == 1


def rope_rows(cos: torch.Tensor, sin: torch.Tensor, idx: torch.Tensor):
    """The (B, n, D//2) tables at the positions idx (B, n). An index past
    the table is clamped to its last row: a free slot of a continuous group
    may sit anywhere, and what it computes is thrown away."""
    i = idx.clamp(0, cos.shape[0] - 1)
    return cos[i], sin[i]


def row_slots(start: torch.Tensor, n: int, limit: int) -> torch.Tensor:
    """(B, n) slots [start_b, start_b + n) of a per-row write or read along
    an axis of `limit`, the start clamped so that the slice fits, as
    `jax.lax.dynamic_update_slice` and `dynamic_slice` clamp it."""
    first = start.clamp(0, max(limit - n, 0))
    return first[:, None] + torch.arange(n, device=start.device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., B, S, H, D) by (S, D//2) tables shared by every row, or
    by (B, S, D//2) tables, one per row (rows of one batch at their own
    positions: continuous batching); either broadcasts over the heads and
    any leading group axis. Pairs are adjacent lanes (x0,x1),(x2,x3),...;
    math in fp32, result in x's dtype."""
    dtype = x.dtype
    xf = x.float()
    xr = xf[..., 0::2]
    xi = xf[..., 1::2]
    if cos.dim() == 2:
        c, s = cos[:, None, :], sin[:, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.stack([xr * c - xi * s, xr * s + xi * c], dim=-1).reshape(x.shape)
    return out.to(dtype)


def apply_rope_half_heads(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                          head_offset: int = 0, total_heads: Optional[int] = None) -> torch.Tensor:
    """RoPE on the first half of the heads only (the DiT's joint-attention
    variant). x: (..., S, H, D). Under tensor parallelism x holds the H
    local heads [head_offset, head_offset + H) of `total_heads`: the heads
    rotated are the global first half, so a rank may hold all of them, some
    or none."""
    n = x.shape[-2]
    total = n if total_heads is None else total_heads
    h = max(0, min(n, total // 2 - head_offset))
    if h == 0:
        return x
    return torch.cat([apply_rope(x[..., :h, :], cos, sin), x[..., h:, :]], dim=-2)
