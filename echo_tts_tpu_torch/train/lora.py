"""Functional LoRA for EchoDiT (counterpart of echo_tts_tpu/train/lora.py).

LoRA is a side-car tree mirroring the targeted leaves of the stacked
parameter tree: for a base weight (L, in, out) the adapter is a (L, in, r)
and b (L, r, out), and the effective weight is w + (alpha/r)·a@b, the delta
in fp32 and the sum cast back to w's dtype. Checkpoints are the JAX
package's npz format, so an adapter saved by either package loads in the
other.

Training merges nothing: `lora_params` puts a `LoRAWeight`
(`models/lora_linear.py`) in place of each targeted leaf, and the DiT
forward hands it to `models/quant.py`'s products, which apply it as a
rank-r side product: h @ w + s·(h @ a) @ b, the frozen w taking no
gradient. Serving and export merge (`apply_lora`, `merge_lora`,
`LoRAWeight.weight`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from echo_tts_tpu_torch.core.device import resolve_device
from echo_tts_tpu_torch.models.lora_linear import LoRAWeight

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
    """params with a `LoRAWeight` at each adapted leaf (nothing merged; the
    base tree is shared, not copied)."""
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


def save_lora_checkpoint(path: str, lora: dict, lc: LoRAConfig,
                         extra: Optional[dict] = None) -> None:
    """npz side-car checkpoint in the JAX package's format: `<target>.a`,
    `<target>.b` (fp32), `__rank__`, `__alpha__`. `extra` (the epoch and
    validation loss a finetune saves with) is accepted and, as in the JAX
    package, not written: the format is unchanged."""
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
