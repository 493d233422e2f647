"""Flow-matching (rectified-flow, v-prediction) training loss (counterpart of
echo_tts_tpu/train/loss.py), with every cast where the JAX package has it.

t ~ U(0,1)² (front-loaded), x_t = (1-t)·x0 + t·eps, target v = eps - x0,
a per-position linear time weight, and the masked mean normalised once.
The non-finite guard is a `torch.where`, not a host sync.
"""
from __future__ import annotations

from typing import Optional

import torch

from echo_tts_tpu_torch.core.config import DiTConfig
from echo_tts_tpu_torch.models.dit import dit_forward, get_kv_cache_speaker, get_kv_cache_text


def compute_diffusion_loss(
    params: dict,
    cfg: DiTConfig,
    generator: Optional[torch.Generator],
    latent_target: torch.Tensor,     # (B, T, 80) fp32
    latent_mask: torch.Tensor,       # (B, T) bool
    text_input_ids: torch.Tensor,
    text_mask: torch.Tensor,
    speaker_latent: torch.Tensor,
    speaker_mask: torch.Tensor,
    model_dtype: torch.dtype = torch.bfloat16,
    train_encoders: bool = False,
    time_weight_range=(1.4, 0.8),
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scalar fp32 loss. `t` (B,) and `noise` (B, T, 80) may be injected (the
    tests feed both packages the same numpy draws); otherwise they are drawn
    from `generator` on the target's device. The text and speaker caches are
    built without autograd unless `train_encoders` (the JAX package's
    stop_gradient); the trunk runs with remat and the trainable attention."""
    b, t_len, d = latent_target.shape
    dev = latent_target.device
    if t is None:
        t = torch.rand(b, generator=generator, device=dev) ** 2.0
    if noise is None:
        noise = torch.randn(latent_target.shape, generator=generator, device=dev)
    te = t[:, None, None]
    x_t = (1.0 - te) * latent_target + te * noise
    v_target = noise - latent_target

    with torch.set_grad_enabled(train_encoders and torch.is_grad_enabled()):
        kv_text = get_kv_cache_text(params, cfg, text_input_ids, text_mask)
        kv_speaker = get_kv_cache_speaker(params, cfg, speaker_latent.to(model_dtype))

    v_pred = dit_forward(params, cfg, x_t.to(model_dtype), t.to(model_dtype), text_mask,
                         speaker_mask, kv_text, kv_speaker, remat=True, attn_impl="trainable")

    err = (v_pred.float() - v_target) ** 2
    w = torch.linspace(time_weight_range[0], time_weight_range[1], t_len, device=dev)
    err = err * w[None, :, None]
    err = err * latent_mask[..., None].float()
    num_valid = latent_mask.sum() * d
    loss = err.sum() / num_valid.clamp(min=1)
    return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))
