"""Functional LoRA for EchoDiT (counterpart of echo_tts_tpu/train/lora.py).

LoRA is a side-car tree mirroring the targeted leaves of the stacked
parameter tree: for a base weight (L, in, out) the adapter is a (L, in, r)
and b (L, r, out), and the effective weight is w + (alpha/r)·a@b, the delta
in fp32 and the sum cast back to w's dtype. Checkpoints are the JAX
package's npz format, so an adapter saved by either package loads in the
other.

Training does not merge the whole stack up front: `lora_params` puts a
`LoRAWeight` in place of each targeted leaf, and the DiT forward
(`models/dit.py`) forms w[l] + s·a[l]@b[l] inside each layer, where it is
recomputed under remat instead of saved.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from echo_tts_tpu_torch.core.device import resolve_device

# decoder attention + text cross-attention + MLP; the speaker path is left
# out to preserve voice cloning
DEFAULT_TARGETS = (
    "blocks.attention.wq", "blocks.attention.wk", "blocks.attention.wv",
    "blocks.attention.wo",
    "blocks.attention.wk_text", "blocks.attention.wv_text",
    "blocks.mlp.w1", "blocks.mlp.w2", "blocks.mlp.w3",
)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 16.0
    targets: Tuple[str, ...] = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


@dataclasses.dataclass(frozen=True)
class LoRAWeight:
    """A base weight with its adapter, merged only where it is used: a
    stacked (L, in, out) leaf, or one layer's (in, out) slice of it."""

    w: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    scaling: float

    def unbind(self, dim: int = 0) -> list:
        return [LoRAWeight(w, a, b, self.scaling)
                for w, a, b in zip(self.w.unbind(dim), self.a.unbind(dim), self.b.unbind(dim))]

    def weight(self) -> torch.Tensor:
        delta = self.a.float() @ self.b.float()
        return (self.w.float() + self.scaling * delta).to(self.w.dtype)


def _get(tree: dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


def _with(tree: dict, dotted: str, value) -> dict:
    """A copy of the dict path to `dotted` with the leaf replaced; the rest
    of the tree is shared."""
    head, _, rest = dotted.partition(".")
    out = dict(tree)
    out[head] = _with(tree[head], rest, value) if rest else value
    return out


def init_lora(generator: torch.Generator, params: dict, lc: LoRAConfig,
              dtype: torch.dtype = torch.float32) -> dict:
    """a ~ U(-1/sqrt(in), 1/sqrt(in)) (torch's kaiming_uniform with a=sqrt(5)),
    b = 0, so the adapted model equals the base at the start. Drawn from
    `generator` on each base weight's device (the generator's)."""
    lora: Dict[str, dict] = {}
    for tgt in lc.targets:
        w = _get(params, tgt)
        l, d_in, d_out = w.shape
        bound = 1.0 / np.sqrt(d_in)
        a = torch.empty((l, d_in, lc.rank), dtype=torch.float32, device=w.device)
        a.uniform_(-bound, bound, generator=generator)
        lora[tgt] = {"a": a.to(dtype),
                     "b": torch.zeros((l, lc.rank, d_out), dtype=dtype, device=w.device)}
    return lora


def lora_params(params: dict, lora: dict, lc: LoRAConfig) -> dict:
    """params with a `LoRAWeight` at each adapted leaf (nothing merged yet;
    the base tree is shared, not copied)."""
    out = params
    for tgt, ab in lora.items():
        out = _with(out, tgt, LoRAWeight(_get(params, tgt), ab["a"], ab["b"], lc.scaling))
    return out


def apply_lora(params: dict, lora: dict, lc: LoRAConfig) -> dict:
    """params with the effective weights w + scaling·a@b, all layers merged
    (one batched product per target); the base is untouched."""
    out = params
    for tgt, ab in lora.items():
        out = _with(out, tgt, LoRAWeight(_get(params, tgt), ab["a"], ab["b"],
                                         lc.scaling).weight())
    return out


def merge_lora(params: dict, lora: dict, lc: LoRAConfig) -> dict:
    """Bake the adapters into the base weights."""
    return apply_lora(params, lora, lc)


def count_lora_params(lora: dict) -> int:
    return sum(int(ab[k].numel()) for ab in lora.values() for k in ("a", "b"))


def save_lora_checkpoint(path: str, lora: dict, lc: LoRAConfig) -> None:
    """npz side-car checkpoint in the JAX package's format: `<target>.a`,
    `<target>.b` (fp32), `__rank__`, `__alpha__`."""
    flat = {}
    for tgt, ab in lora.items():
        flat[f"{tgt}.a"] = ab["a"].detach().float().cpu().numpy()
        flat[f"{tgt}.b"] = ab["b"].detach().float().cpu().numpy()
    flat["__rank__"] = np.asarray(lc.rank)
    flat["__alpha__"] = np.asarray(lc.alpha)
    np.savez(path, **flat)


def load_lora_checkpoint(path: str, device=None) -> Tuple[dict, LoRAConfig]:
    """An npz written by either package -> (lora on `device`, default cuda;
    config with the sorted targets)."""
    dev = resolve_device(device)
    lora: Dict[str, dict] = {}
    targets: List[str] = []
    with np.load(path) as z:
        for k in z.files:
            if k.endswith(".a"):
                tgt = k[:-2]
                targets.append(tgt)
                lora[tgt] = {"a": torch.from_numpy(z[f"{tgt}.a"]).to(dev),
                             "b": torch.from_numpy(z[f"{tgt}.b"]).to(dev)}
        lc = LoRAConfig(rank=int(z["__rank__"]), alpha=float(z["__alpha__"]),
                        targets=tuple(sorted(targets)))
    return lora, lc
