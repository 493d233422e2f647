"""Plain LoRA finetuning step of EchoDiT in float32: the rectified-flow
loss, the adapters' gradients by autograd through the float32 trunk, and
the optimizer chain of the published finetune (global-norm clipping at
0.4, AdamW b1 0.9, b2 0.999, eps 1e-8, weight decay 0.01, linear warmup
then cosine, the schedule read before its count is incremented).

The loss: t ~ U(0, 1)², x_t = (1 - t) x0 + t eps, target eps - x0, squared
error weighted linearly from 1.4 to 0.8 along the sequence, masked mean
over valid latents and channels. The text and speaker caches take no
gradient. The flow time reaches the model rounded to the served type, as
in the sampler (dit.py)."""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import dit as ref_dit


def merged(base: dict, lora: Dict[str, dict], scaling: float) -> dict:
    """base (float32) with w + scaling · a @ b at every adapted leaf."""
    out = dict(base)
    for tgt, ab in lora.items():
        path = tgt.split(".")
        node = out
        for p in path[:-1]:
            node[p] = dict(node[p])
            node = node[p]
        node[path[-1]] = node[path[-1]] + scaling * (ab["a"] @ ab["b"])
    return out


def loss_sum(p: dict, cfg: dict, batch: dict, t, noise, P, time_dtype, rows: slice):
    """Sum over `rows` of the weighted, masked squared error (not yet
    divided by the batch's count of valid elements)."""
    x0 = batch["latent"][rows]
    mask = batch["latent_mask"][rows]
    tt = t[rows]
    te = tt[:, None, None]
    x_t = (1.0 - te) * x0 + te * noise[rows]
    target = noise[rows] - x0
    with torch.no_grad():
        text = ref_dit.text_kv(p, cfg, batch["text_input_ids"][rows], batch["text_mask"][rows], P)
        spk = ref_dit.speaker_kv(p, cfg, batch["speaker_latent"][rows], P)
    smask = batch["speaker_mask"][rows][:, ::cfg["speaker_patch_size"]]
    segs = [(text[0], text[1], batch["text_mask"][rows][None]), (spk[0], spk[1], smask[None])]
    tm = tt.to(time_dtype).float()
    v = ref_dit.trunk(p, cfg, x_t[None], tm, segs, 0, P)[0]
    w = torch.linspace(1.4, 0.8, x0.shape[1], device=x0.device)
    err = (v - target) ** 2 * w[None, :, None] * mask[..., None].float()
    return err.sum()


class AdamW:
    def __init__(self, lr: float, warmup: int, total: int, min_ratio: float, wd: float = 0.01,
                 clip: float = 0.4):
        self.lr, self.warmup, self.total, self.min_ratio = lr, warmup, total, min_ratio
        self.wd, self.clip = wd, clip
        self.count = 0
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def rate(self, step: int) -> float:
        if step < self.warmup:
            return self.lr * step / max(self.warmup, 1)
        prog = (step - self.warmup) / max(self.total - self.warmup, 1)
        return self.lr * max(0.5 * (1.0 + math.cos(math.pi * prog)), self.min_ratio)

    def clipped(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        if norm >= self.clip:
            return [g * (self.clip / norm).float() for g in grads]
        return grads

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> List[torch.Tensor]:
        g = self.clipped(grads)
        if not self.mu:
            self.mu = [torch.zeros_like(x) for x in params]
            self.nu = [torch.zeros_like(x) for x in params]
        lr = self.rate(self.count)
        self.count += 1
        bc1, bc2 = 1 - 0.9 ** self.count, 1 - 0.999 ** self.count
        for p, gi, m, v in zip(params, g, self.mu, self.nu):
            m.mul_(0.9).add_(0.1 * gi)
            v.mul_(0.999).add_(0.001 * gi * gi)
            u = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8) + self.wd * p
            p.sub_(lr * u)
        return g
