"""Tensor parallelism inside the model: this process's tp group, the heads a
sharded tree holds, and the collectives of the Megatron split, written out
(no DTensor: the kernels take plain tensors).

A tree sharded by `parallel/sharding.py:shard_params` holds H/tp contiguous
heads of every attention (and the matching MLP columns); a forward sees that
from the head norms' shape and asks `head_split` for the offset of its first
head and the group to reduce over. An unsharded tree needs no group and
takes none, so one process can run a tp=1 reference beside its shard.

Collectives (each adds its host seconds to `STATS`):
  * `reduce_from_tp`: the sum of the partial products of a row-sharded
    weight (wo, w2), the one all-reduce of each attention and MLP; under
    autograd forward all-reduce, backward identity;
  * `copy_to_tp`: before a column-sharded product, identity forward and,
    under autograd, all-reduce backward (the gradient of a replicated
    activation is the sum of the shards' partial gradients);
  * `all_reduce_`: in place, any op (the int8 path's MAX of row scales and
    SUM of int32 partials).
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

_MESH = None
STATS = {"all_reduce_calls": 0, "all_reduce_seconds": 0.0, "all_reduce_bytes": 0}


def set_mesh(mesh) -> None:
    """Register this process's mesh (`make_mesh` does); None unregisters."""
    global _MESH
    _MESH = mesh


def current_mesh():
    return _MESH


def reset_stats() -> None:
    STATS.update(all_reduce_calls=0, all_reduce_seconds=0.0, all_reduce_bytes=0)


def head_split(local: int, total: int) -> Tuple[int, Optional[object]]:
    """(global index of the first local head, tp group or None) for an
    attention that holds `local` of its `total` heads. Raises when a
    sharded tree meets no registered mesh or one of another tp."""
    if local == total:
        return 0, None
    m = _MESH
    if m is None or m.tp_group is None or local * m.tp != total:
        raise RuntimeError(
            f"a tree sharded to {local} of {total} heads needs a registered mesh of tp "
            f"{total // max(local, 1)} (parallel/mesh.py:make_mesh), got "
            f"{None if m is None else m.shape}")
    return m.tp_rank * local, m.tp_group


def all_reduce_(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """In-place all-reduce on `group`, timed on the host clock (gloo returns
    when the result is there; nccl when it is enqueued)."""
    t0 = time.perf_counter()
    dist.all_reduce(x, op=op, group=group)
    STATS["all_reduce_seconds"] += time.perf_counter() - t0
    STATS["all_reduce_calls"] += 1
    STATS["all_reduce_bytes"] += x.numel() * x.element_size()
    return x


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), group=ctx.group), None


def _tracks_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the tp group of x, this rank's partial product. In place
    when autograd does not track x."""
    if group is None:
        return x
    if _tracks_grad(x):
        return _ReduceFromTP.apply(x, group)
    return all_reduce_(x, group=group)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """x itself; under autograd its gradient is summed over the tp group."""
    if group is None or not _tracks_grad(x):
        return x
    return _CopyToTP.apply(x, group)
