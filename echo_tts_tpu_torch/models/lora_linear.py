"""A LoRA-adapted linear weight, and its product as a rank-r side product.

`LoRAWeight` holds a base weight w and its adapter (a, b, scaling s): a
stacked (L, in, out) leaf, or one layer's (in, out) slice of it. Serving and
export merge it (`weight()`: w + s·a@b, the delta in fp32, the sum cast
back to w's dtype; `train/lora.py:apply_lora`). A training forward leaves it
in the parameter tree (`train/lora.py:lora_params`), and the products of
`models/quant.py` apply it as `side_product`: h @ w + s·(h @ a) @ b, so no
merged weight is formed and a frozen w takes no gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from echo_tts_tpu_torch.parallel.tp import copy_to_tp
from echo_tts_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class LoRAWeight:
    """A base weight with its adapter, merged only where it is used.
    `factors`: a and s·b already in w's dtype (`unbind` forms them once for
    the whole stack), or None to form them where the side product runs."""

    w: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    scaling: float
    factors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def side_factors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """a and s·b in w's dtype, in which the side product runs (the
        scaling on b, so that the product's backward multiplies nothing
        apart)."""
        if self.factors is not None:
            return self.factors
        return self.a.to(self.w.dtype), (self.b * self.scaling).to(self.w.dtype)

    def unbind(self, dim: int = 0) -> list:
        """One layer's slices: a and b as they are (`weight()` merges from
        them), and the factors formed once for the whole stack."""
        a_lo, b_lo = self.side_factors()
        return [LoRAWeight(w, a, b, self.scaling, (al, bl)) for w, a, b, al, bl in zip(
            self.w.unbind(dim), self.a.unbind(dim), self.b.unbind(dim), a_lo.unbind(dim),
            b_lo.unbind(dim))]

    def weight(self) -> torch.Tensor:
        with span("train.lora_merge", "launch"):
            delta = self.a.float() @ self.b.float()
            return (self.w.float() + self.scaling * delta).to(self.w.dtype)


def side_product(h: torch.Tensor, w: LoRAWeight, group=None, row: bool = False) -> torch.Tensor:
    """h @ w.w + (h @ a) @ (s·b), the rank-r product accumulated into the
    base product, under plain autograd. Under tensor parallelism (`group`) the
    adapter follows its weight's sharding (`parallel/sharding.py`): a
    column-sharded w (`row` False) holds this rank's columns of b and the
    whole a, a row-sharded one this rank's rows of a and the whole b; the
    factor held whole has its gradient summed over the group, and a
    row-sharded product's sum is the caller's all-reduce."""
    a, b = w.side_factors()
    if group is not None:
        if row:
            b = copy_to_tp(b, group)
        else:
            a = copy_to_tp(a, group)
    h2 = h.reshape(-1, h.shape[-1])
    out = (h2 @ w.w).addmm_(h2 @ a, b)
    return out.view(*h.shape[:-1], out.shape[-1])
