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

On a (dp, tp) mesh (`make_train_step(..., mesh=...)`, `parallel/mesh.py`):
every rank draws t and the noise of the global batch from the same
generator and keeps its own rows, so the rows match one process's draws;
the loss is the mean over the global batch (each rank's masked sum over the
global count of valid elements, summed over dp, as are the gradients); a
tree sharded over tp (`parallel/sharding.py`) runs the Megatron forward and
backward of `models/dit.py`, and the optimizer's global norm and finite
check take the shards' parts over the tp group. LoRA runs on dp alone, as
the JAX package's LoRA finetuning has no mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.distributed as dist

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

    def __init__(self, tc: TrainConfig, tp_group=None):
        """tp_group: the group over which the leaves marked in `sharded`
        (one bool a leaf, `tree_leaves` order, set by the step) are split;
        their squares and finiteness are summed over it for the global norm
        and the finite check."""
        self.tc = tc
        self.schedule = cosine_schedule_with_warmup(tc)
        self.tp_group = tp_group
        self.sharded: Optional[List[bool]] = None

    def _all_finite(self, grads) -> bool:
        ok = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        if self.tp_group is not None:
            from echo_tts_tpu_torch.parallel.tp import all_reduce_

            ok = all_reduce_(ok.float(), op=dist.ReduceOp.MIN, group=self.tp_group)
        return bool(ok)

    def _global_norm(self, grads) -> torch.Tensor:
        sq = [g.float().square().sum() for g in grads]
        if self.tp_group is None:
            return torch.sqrt(sum(sq))
        from echo_tts_tpu_torch.parallel.tp import all_reduce_

        zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
        shards = all_reduce_(sum((x for x, sh in zip(sq, self.sharded) if sh), zero),
                             group=self.tp_group)
        return torch.sqrt(sum((x for x, sh in zip(sq, self.sharded) if not sh), zero) + shards)

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
        finite = self._all_finite(grads)
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
        norm = self._global_norm(grads)
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


def make_optimizer(tc: TrainConfig, tp_group=None) -> Optimizer:
    return Optimizer(tc, tp_group)


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _grads(loss: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaves, zeros where a leaf is unused (the text-cache
    weights, whose cache is built without autograd): optax still decays
    them, so they must be optimised with a zero gradient, not skipped."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _global_draws(generator, batch: dict, mesh, device):
    """t (B,) and noise (B, T, D) of this dp rank's B rows, cut from the
    draws of the global batch (dp·B rows) in the order one process makes
    them, so every row gets one process's numbers."""
    latent = torch.as_tensor(batch["latent"])
    b = latent.shape[0]
    t = torch.rand(b * mesh.dp, generator=generator, device=device) ** 2.0
    noise = torch.randn((b * mesh.dp,) + tuple(latent.shape[1:]), generator=generator,
                        device=device)
    rows = slice(mesh.dp_rank * b, (mesh.dp_rank + 1) * b)
    return t[rows], noise[rows]


def make_train_step(cfg: DiTConfig, tc: TrainConfig, model_dtype=torch.bfloat16,
                    lora_cfg: Optional[LoRAConfig] = None, train_encoders: bool = False,
                    mesh=None):
    """Returns (optimizer, step).

    Full mode:  step(params, opt_state, generator, batch) -> (params, opt_state, loss)
    LoRA mode:  step(base_params, lora, opt_state, generator, batch) -> (lora, ...)
    batch: dict of numpy arrays or tensors with latent, latent_mask,
    text_input_ids, text_mask, speaker_latent, speaker_mask (moved to the
    parameters' device). `generator` draws t and the noise. The trained
    tensors are updated in place and returned; loss is a detached scalar.

    mesh: a `parallel/mesh.py` Mesh. The batch is then this dp rank's rows
    (`parallel/multihost.py:feed_process_local_batch`), every rank passes a
    generator in the same state, and the loss returned is the global
    batch's. With tp > 1 the params are this rank's `shard_params` tree;
    LoRA takes dp alone.
    """
    tp_group = None
    if mesh is not None and mesh.tp > 1:
        if lora_cfg is not None:
            raise ValueError("LoRA training runs on dp alone: give it a mesh with tp=1")
        tp_group = mesh.tp_group
    opt = make_optimizer(tc, tp_group)
    dp_group = mesh.dp_group if mesh is not None and mesh.dp > 1 else None

    def loss_from(params, generator, batch, device):
        b = _to_device(batch, device)
        kw = {}
        if mesh is not None:
            kw["t"], kw["noise"] = _global_draws(generator, b, mesh, device)
        return compute_diffusion_loss(
            params, cfg, generator, b["latent"], b["latent_mask"], b["text_input_ids"],
            b["text_mask"], b["speaker_latent"], b["speaker_mask"],
            model_dtype=model_dtype, train_encoders=train_encoders, **kw)

    def train(trained, params, opt_state, generator, batch):
        leaves = tree_leaves(trained)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_from(params, generator, batch, leaves[0].device)
        if dp_group is not None:
            from echo_tts_tpu_torch.parallel.tp import all_reduce_

            # this rank's share of the global mean: its masked sum over the
            # global count of valid elements
            n_local = torch.as_tensor(batch["latent_mask"]).sum().to(torch.float32)
            n_global = all_reduce_(n_local.clone().to(loss.device), group=dp_group)
            loss = loss * (n_local.to(loss.device) / n_global.clamp(min=1))
            grads = [all_reduce_(g, group=dp_group) for g in _grads(loss, leaves)]
            loss = all_reduce_(loss.detach().clone(), group=dp_group)
        else:
            grads = _grads(loss, leaves)
        opt_state = opt.apply(leaves, grads, opt_state)
        return opt_state, loss.detach()

    if lora_cfg is None:

        def step(params, opt_state, generator, batch):
            if tp_group is not None:
                from echo_tts_tpu_torch.parallel.sharding import sharded_leaf_mask

                opt.sharded = sharded_leaf_mask(params)
            opt_state, loss = train(params, params, opt_state, generator, batch)
            return params, opt_state, loss

        return opt, step

    def lora_step(base_params, lora, opt_state, generator, batch):
        opt_state, loss = train(lora, lora_params(base_params, lora, lora_cfg), opt_state,
                                generator, batch)
        return lora, opt_state, loss

    return opt, lora_step
