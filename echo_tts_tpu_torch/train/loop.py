"""Training loop (counterpart of echo_tts_tpu/train/loop.py): AdamW with
warmup-cosine, global-norm clipping, non-finite step skipping and gradient
accumulation, in full-parameter or LoRA mode (only the adapters train).

The optimizer is written by hand on tensors so that it is optax's chain of
the JAX package, step for step:

    MultiSteps(apply_if_finite(chain(clip_by_global_norm(0.4),
                                     adamw(schedule, weight_decay=0.01)), 100), k)

* the schedule is read at the count before its increment, so the first
  applied step has lr 0 whenever warmup_steps > 0;
* clipping scales by max/norm only when norm >= max (not torch's
  max/(norm+1e-6));
* a non-finite step leaves the parameters, the moments and the count as
  they were (up to 100 in a row, then it is applied anyway);
* k > 1 averages k gradients (running mean) and applies them every k-th
  call; as in optax, the accumulator is reset by multiplying it by zero, so
  a non-finite mini-step poisons it;
* the moments take the parameter's dtype (bf16 for bf16 weights, fp32 for
  LoRA adapters), and every optimised tensor is updated, with a zero
  gradient where autograd gives none (weight decay still applies).
The parameters are updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from echo_tts_tpu_torch.core.config import DiTConfig
from echo_tts_tpu_torch.train.loss import compute_diffusion_loss
from echo_tts_tpu_torch.train.lora import LoRAConfig, lora_params

MAX_CONSECUTIVE_ERRORS = 100
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    max_grad_norm: float = 0.4
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_ratio: float = 0.1
    gradient_accumulation_steps: int = 1


def cosine_schedule_with_warmup(tc: TrainConfig):
    """step -> learning rate, computed in float32 as the JAX schedule is:
    linear warmup, then a cosine floored at min_lr_ratio."""

    def sched(step: int) -> float:
        s = torch.tensor(float(step), dtype=torch.float32)
        warm = s / max(tc.warmup_steps, 1)
        progress = (s - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps, 1)
        cos = torch.clamp(0.5 * (1.0 + torch.cos(math.pi * progress)), min=tc.min_lr_ratio)
        return float(tc.learning_rate * (warm if step < tc.warmup_steps else cos))

    return sched


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in the JAX package's flatten order (dict keys sorted, lists in
    order); a dataclass (`OptState`) by its fields, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) for x in tree_leaves(getattr(tree, f.name))]
    return [tree]


@dataclasses.dataclass
class OptState:
    count: int                  # applied updates (adam's and the schedule's count)
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    notfinite_count: int = 0    # consecutive non-finite steps
    total_notfinite: int = 0
    mini_step: int = 0          # accumulation position
    acc: Optional[List[torch.Tensor]] = None


class Optimizer:
    """optax's chain above, on flat lists of tensors (see module doc)."""

    def __init__(self, tc: TrainConfig):
        self.tc = tc
        self.schedule = cosine_schedule_with_warmup(tc)

    def init(self, params) -> OptState:
        leaves = tree_leaves(params)
        zeros = [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in leaves]
        acc = None
        if self.tc.gradient_accumulation_steps > 1:
            acc = [torch.zeros_like(p) for p in leaves]
        return OptState(0, zeros, [torch.zeros_like(z) for z in zeros], acc=acc)

    @torch.no_grad()
    def apply(self, params, grads, state: OptState) -> OptState:
        """One optimizer call: update `params` (a tree, or its leaves) in
        place from `grads` (same structure). Returns the new state."""
        params, grads = tree_leaves(params), tree_leaves(grads)
        k = self.tc.gradient_accumulation_steps
        emit = True
        if k > 1:
            n = state.mini_step
            grads = [a + (g.to(a.dtype) - a) / (n + 1) for a, g in zip(state.acc, grads)]
            emit = n == k - 1
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
        notfinite = 0 if finite else state.notfinite_count + 1
        if emit:
            state.notfinite_count = notfinite
            state.total_notfinite += 0 if finite else 1
            if finite or notfinite > MAX_CONSECUTIVE_ERRORS:
                self._adamw(params, grads, state)
        if k > 1:
            state.acc = [a * float(1 - emit) for a in grads]
            state.mini_step = (state.mini_step + 1) % k
        return state

    def _adamw(self, params, grads, state: OptState) -> None:
        tc = self.tc
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        if not bool(norm < tc.max_grad_norm):
            grads = [(g / norm.to(g.dtype)) * tc.max_grad_norm for g in grads]
        step_size = -self.schedule(state.count)
        count = state.count + 1
        bc1 = 1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** count
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = g.to(mu.dtype)
            mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
            nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
            u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + ADAM_EPS)
            u = u + tc.weight_decay * p
            p.copy_(p + step_size * u)
        state.count = count


def make_optimizer(tc: TrainConfig) -> Optimizer:
    return Optimizer(tc)


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _grads(loss: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaves, zeros where a leaf is unused (the text-cache
    weights, whose cache is built without autograd): optax still decays
    them, so they must be optimised with a zero gradient, not skipped."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def make_train_step(cfg: DiTConfig, tc: TrainConfig, model_dtype=torch.bfloat16,
                    lora_cfg: Optional[LoRAConfig] = None, train_encoders: bool = False):
    """Returns (optimizer, step).

    Full mode:  step(params, opt_state, generator, batch) -> (params, opt_state, loss)
    LoRA mode:  step(base_params, lora, opt_state, generator, batch) -> (lora, ...)
    batch: dict of numpy arrays or tensors with latent, latent_mask,
    text_input_ids, text_mask, speaker_latent, speaker_mask (moved to the
    parameters' device). `generator` draws t and the noise. The trained
    tensors are updated in place and returned; loss is a detached scalar.
    """
    opt = make_optimizer(tc)

    def loss_from(params, generator, batch, device):
        b = _to_device(batch, device)
        return compute_diffusion_loss(
            params, cfg, generator, b["latent"], b["latent_mask"], b["text_input_ids"],
            b["text_mask"], b["speaker_latent"], b["speaker_mask"],
            model_dtype=model_dtype, train_encoders=train_encoders)

    def train(trained, params, opt_state, generator, batch):
        leaves = tree_leaves(trained)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_from(params, generator, batch, leaves[0].device)
        opt_state = opt.apply(leaves, _grads(loss, leaves), opt_state)
        return opt_state, loss.detach()

    if lora_cfg is None:

        def step(params, opt_state, generator, batch):
            opt_state, loss = train(params, params, opt_state, generator, batch)
            return params, opt_state, loss

        return opt, step

    def lora_step(base_params, lora, opt_state, generator, batch):
        opt_state, loss = train(lora, lora_params(base_params, lora, lora_cfg), opt_state,
                                generator, batch)
        return lora, opt_state, loss

    return opt, lora_step
