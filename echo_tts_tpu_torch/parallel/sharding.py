"""Sharding of EchoDiT parameter trees and activations over a (dp, tp) mesh
(counterpart of echo_tts_tpu/parallel/sharding.py).

Megatron tp over the stacked (L, in, out) layer weights: the head and MLP
up-projections are column-sharded, the down-projections (wo, w2)
row-sharded, the head norms (L, H, Dh) sharded on their heads, so each
attention and each MLP needs one all-reduce (written out in
`parallel/tp.py` and `models/dit.py`). The same names shard the text,
speaker and latent encoders' blocks. dp shards the batch axis of
activations and KV caches; parameters are replicated over dp.

A spec is a tuple with one entry an axis, None or a mesh axis name, as
JAX's PartitionSpec; () replicates. `shard_params` keeps this rank's
contiguous slice of each sharded axis, so rank r of tp holds heads
[r·H/tp, (r+1)·H/tp) and the matching MLP columns.

An int8 leaf (`models/quant.py`: {"q": int8 (L, N, K), "s": fp32 (L, N)},
K-major) is sharded by the name one level up, in that layout: a
column-sharded q splits on N and its s follows; a row-sharded q splits on K
and its s (over N) stays whole.

A LoRA tree (`train/lora.py`: {"blocks.attention.wq": {"a": (L, in, r),
"b": (L, r, out)}, ...}) follows its base weights: a column-sharded
weight's b splits on out and its a stays whole; a row-sharded weight's a
splits on in and its b stays whole.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

_COL = {"wq", "wk", "wv", "gate", "wk_text", "wv_text", "wk_speaker",
        "wv_speaker", "wk_latent", "wv_latent", "w1", "w3"}
_ROW = {"wo", "w2"}
_HEAD_NORM = {"q_norm", "k_norm"}  # (L, H, Dh): shard heads


def spec_for(names: Sequence[str], ndim: int) -> Tuple:
    """The spec of the leaf at path `names` (dict keys from the root) with
    `ndim` axes."""
    name = names[-1]
    if name in ("a", "b") and len(names) >= 2 and "." in names[-2]:
        wname = names[-2].rsplit(".", 1)[-1]
        if ndim == 3 and name == "b" and wname in _COL:
            return (None, None, "tp")
        if ndim == 3 and name == "a" and wname in _ROW:
            return (None, "tp", None)
        return ()
    if name in ("q", "s") and len(names) >= 2:
        wname = names[-2]
        if wname in _COL:
            if name == "q" and ndim == 3:
                return (None, "tp", None)
            if name == "s" and ndim == 2:
                return (None, "tp")
        if wname in _ROW and name == "q" and ndim == 3:
            return (None, None, "tp")
        return ()
    if name in _COL and ndim == 3:
        return (None, None, "tp")
    if name in _ROW and ndim == 3:
        return (None, "tp", None)
    if name in _HEAD_NORM and ndim == 3 and "attention" in names:
        return (None, "tp", None)
    return ()


def _map_with_path(fn, tree, names=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, names + (str(i),)) for i, v in enumerate(tree)]
    return fn(names, tree)


def param_pspecs(params: Any) -> Any:
    """The spec tree of a DiT (or encoder) parameter tree."""
    return _map_with_path(lambda names, x: spec_for(names, x.dim()), params)


def shard_slice(x, spec: Tuple, mesh, names: Sequence[str] = ()):
    """This rank's block of x (a tensor or numpy array) under `spec`: the
    contiguous chunk of each axis named "tp" or "dp". Raises when an axis
    does not divide."""
    coord = {"tp": (mesh.tp_rank, mesh.tp), "dp": (mesh.dp_rank, mesh.dp)}
    for axis, ax_name in enumerate(spec):
        if ax_name is None:
            continue
        r, n = coord[ax_name]
        size = x.shape[axis]
        if size % n:
            raise ValueError(f"{'.'.join(names) or 'leaf'}: axis {axis} of {size} does not "
                             f"divide over {ax_name}={n} (tp must divide every attention's "
                             f"heads: 16 in the trunk, 10 in the encoders at full width)")
        c = size // n
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(r * c, (r + 1) * c)
        x = x[tuple(idx)]
    return x


def _shard_leaf(names, x, mesh):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{'.'.join(names)}: shard_params takes tensors, got {type(x).__name__}")
    spec = spec_for(names, x.dim())
    if not any(spec) or mesh.tp == 1:
        return x
    return shard_slice(x, spec, mesh, names).contiguous()


def shard_params(params: Any, mesh) -> Any:
    """This rank's tree: the tp slice of every sharded leaf (a contiguous
    copy, so the full tree may be freed), the others as they are
    (replicated over dp). At tp=1 the tree comes back unchanged. The
    replicated leaves are the full tree's own tensors: a train step that
    updates the shard in place updates them in the full tree too."""
    return _map_with_path(lambda names, x: _shard_leaf(names, x, mesh), params)


def sharded_leaf_mask(params: Any) -> list:
    """One bool a leaf, in `train/loop.py:tree_leaves` order (dict keys
    sorted): whether the leaf is split over tp, so that its gradient's
    square counts once a shard in a global norm."""
    out = []

    def walk(tree, names):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], names + (str(k),))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, names + (str(i),))
        else:
            out.append(any(spec_for(names, tree.dim())))

    walk(params, ())
    return out


def batch_pspec(ndim: int) -> Tuple:
    """Activations and batches: axis 0 over dp."""
    return ("dp",) + (None,) * (ndim - 1)


def kv_cache_pspec() -> Tuple:
    """Head-major KV caches (L, B, H, T, Dh): batch over dp, heads over tp."""
    return (None, "dp", "tp", None, None)


def shard_batch(tree: Any, mesh) -> Any:
    """This dp rank's rows of every leaf (tensors or numpy arrays)."""
    return _map_with_path(lambda names, x: shard_slice(x, batch_pspec(x.ndim), mesh, names),
                          tree)
