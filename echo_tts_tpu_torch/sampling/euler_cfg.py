"""Euler sampler with two independent CFG guidances (counterpart of
echo_tts_tpu/sampling/euler_cfg.py).

The time schedule is known on the host, so the JAX package's `lax.cond` on
the CFG window and its traced speaker-KV scale become plain Python
decisions over host floats: no device sync per step. Every flow time and
every window test is fp32, as in the JAX scan. The sampler state stays fp32;
each forward sees it cast to the model dtype.

The opt-in levers of the JAX package are here too: `solver="midpoint"` (two
velocity evaluations a step, each with the CFG window, the speaker-KV scale
and the temporal rescale at its own flow time), `uncond_cache_interval > 1`
(the two uncond branches refreshed every interval-th window step and reused,
stale, in between) and `joint_uncond` (one shared uncond branch). Midpoint
with an uncond cache, and an unknown solver, raise ValueError as in JAX.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from echo_tts_tpu_torch.core.config import DiTConfig, SamplerConfig
from echo_tts_tpu_torch.core.rope import precompute_rope
from echo_tts_tpu_torch.models.dit import (
    dit_forward,
    dit_forward_cfg,
    get_kv_cache_speaker,
    get_kv_cache_text,
)
from echo_tts_tpu_torch.sampling.jax_random import jax_normal
from echo_tts_tpu_torch.utils.profiling import span


def t_schedule(sc: SamplerConfig) -> np.ndarray:
    """linspace(1, 0, steps+1) * init_scale, fp32 on the host."""
    return (np.linspace(1.0, 0.0, sc.num_steps + 1, dtype=np.float32)
            * np.float32(sc.init_scale)).astype(np.float32)


def temporal_score_rescale(v_pred, x_t, t: float, rescale_k: float, rescale_sigma: float):
    """Temporal score rescaling (arXiv 2510.01184); t is a host float."""
    if not t < 1.0:
        return v_pred
    t = np.float32(t)
    snr = (np.float32(1.0) - t) ** 2 / (t ** 2)
    ratio = (snr * np.float32(rescale_sigma ** 2) + 1) / (
        snr * np.float32(rescale_sigma ** 2 / rescale_k) + 1)
    one_m_t = float(np.float32(1.0) - t)
    return (1.0 / one_m_t) * (float(ratio) * (one_m_t * v_pred + x_t) - x_t)


def _f32_ge(a: float, b: float) -> bool:
    """a >= b compared in fp32, as the JAX package compares its fp32
    schedule with Python-float thresholds."""
    return bool(np.float32(a) >= np.float32(b))


def _speaker_scale_vec(sc: SamplerConfig, cfg: DiTConfig, t: float,
                       t0: float) -> Optional[List[float]]:
    """Per-layer use-site speaker-KV scale for the forward at flow-time t:
    active while t >= speaker_kv_min_t, or forever when the schedule never
    crosses it; layers >= speaker_kv_max_layers keep 1."""
    if sc.speaker_kv_scale is None:
        return None
    min_t = sc.speaker_kv_min_t if sc.speaker_kv_min_t is not None else 0.0
    active = _f32_ge(t, min_t) or not _f32_ge(t0, min_t)
    s = float(np.float32(sc.speaker_kv_scale)) if active else 1.0
    max_layers = sc.speaker_kv_max_layers if sc.speaker_kv_max_layers is not None \
        else cfg.num_layers
    return [s if l < max_layers else 1.0 for l in range(cfg.num_layers)]


def _check_solver(sc: SamplerConfig) -> None:
    if sc.solver == "midpoint" and sc.uncond_cache_interval > 1:
        raise ValueError("uncond_cache_interval > 1 is not supported with "
                         "solver='midpoint' — pick one NFE lever")
    if sc.solver not in ("euler", "midpoint"):
        raise ValueError(f"unknown solver {sc.solver!r}")


def euler_cfg_scan(params: dict, cfg: DiTConfig, sc: SamplerConfig,
                   x_init: torch.Tensor, text_mask, speaker_mask, kv_text, kv_speaker,
                   model_dtype: torch.dtype, rope_q=None, kv_latent=None,
                   latent_mask=None, self_len=None) -> torch.Tensor:
    """The sampler loop. x_init (B, S, latent) fp32 with truncation applied;
    returns fp32 latents. rope_q defaults to positions [0, S); the
    blockwise sampler passes its block's slice, the latent-prefix cache and
    its mask, which go to every forward."""
    _check_solver(sc)
    b, s = x_init.shape[:2]
    ts = t_schedule(sc)
    t0 = float(ts[0])
    if rope_q is None:
        rope_q = precompute_rope(cfg.head_dim, s, device=x_init.device)
    extra = dict(rope_q=rope_q, kv_latent=kv_latent, latent_mask=latent_mask,
                 self_len=self_len)

    def in_window(t: float) -> bool:
        return _f32_ge(t, sc.cfg_min_t) and _f32_ge(sc.cfg_max_t, t)

    def t_batch(t: float) -> torch.Tensor:
        return torch.full((b,), t, dtype=torch.float32, device=x_init.device).to(model_dtype)

    def fwd_cfg(x, t):
        v = dit_forward_cfg(params, cfg, x.to(model_dtype), t_batch(t), text_mask,
                            speaker_mask, kv_text, kv_speaker,
                            speaker_kv_scale=_speaker_scale_vec(sc, cfg, t, t0),
                            joint_uncond=sc.joint_uncond, **extra)
        # joint: the one shared uncond serves both guidance terms
        return (v[0], v[1], v[1]) if sc.joint_uncond else (v[0], v[1], v[2])

    def fwd_single(x, t):
        return dit_forward(params, cfg, x.to(model_dtype), t_batch(t), text_mask, speaker_mask,
                           kv_text, kv_speaker, speaker_kv_scale=_speaker_scale_vec(sc, cfg, t, t0),
                           **extra)

    def guide(v_cond, v_ut, v_us):
        return (v_cond + sc.cfg_scale_text * (v_cond - v_ut)
                + sc.cfg_scale_speaker * (v_cond - v_us))

    def rescale(v, x, t):
        if sc.rescale_k is not None and sc.rescale_sigma is not None:
            return temporal_score_rescale(v, x, t, sc.rescale_k, sc.rescale_sigma)
        return v

    x_t = x_init
    if sc.solver == "midpoint":
        def v_at(x, t: float):
            v = guide(*fwd_cfg(x, t)) if in_window(t) else fwd_single(x, t)
            return rescale(v, x, t)

        for i in range(sc.num_steps):
            with span("sampler.step", "launch", step=i):
                t, t_next = np.float32(ts[i]), np.float32(ts[i + 1])
                dt = t_next - t
                x_mid = x_t + float(np.float32(0.5) * dt) * v_at(x_t, float(t))
                x_t = x_t + float(dt) * v_at(x_mid, float(t + np.float32(0.5) * dt))
        return x_t

    # Euler; with uncond_cache_interval > 1 the uncond branches are refreshed
    # every interval-th step inside the CFG window and reused in between
    interval = sc.uncond_cache_interval
    v_ut_c = v_us_c = None
    n_win = 0
    for i in range(sc.num_steps):
        with span("sampler.step", "launch", step=i):
            t, t_next = float(ts[i]), float(ts[i + 1])
            has_cfg = in_window(t)
            if has_cfg and n_win % interval == 0:
                v_cond, v_ut_c, v_us_c = fwd_cfg(x_t, t)
                v_pred = guide(v_cond, v_ut_c, v_us_c)
            else:
                v_pred = fwd_single(x_t, t)
                if has_cfg:
                    v_pred = guide(v_pred, v_ut_c, v_us_c)
            n_win += has_cfg
            v_pred = rescale(v_pred, x_t, t)
            x_t = x_t + v_pred * float(np.float32(t_next) - np.float32(t))
    return x_t


def draw_noise(rng_seed: Union[int, Sequence[int]], shape, device) -> torch.Tensor:
    """Initial standard-normal noise, fp32 on `device`: the numbers
    `jax.random.normal(PRNGKey(rng_seed), shape)` gives the JAX package
    (`sampling/jax_random.py`, drawn on the host). `rng_seed` may also be one
    seed per row of `shape[0]`: row i is then the draw of rng_seed[i] at
    shape[1:], as a batch of requests with their own seeds needs."""
    if isinstance(rng_seed, (int, np.integer)):
        noise = jax_normal(int(rng_seed), shape)
    else:
        if len(rng_seed) != shape[0]:
            raise ValueError(f"{len(rng_seed)} seeds for {shape[0]} rows")
        noise = jax_normal(rng_seed, shape[1:])
    return torch.from_numpy(noise).to(device)


def sample_euler_cfg_independent_guidances(
    params: dict,
    cfg: DiTConfig,
    sc: SamplerConfig,
    speaker_latent: torch.Tensor,   # (B, S_spk, latent)
    speaker_mask: torch.Tensor,     # (B, S_spk) bool
    text_input_ids: torch.Tensor,   # (B, T) int
    text_mask: torch.Tensor,        # (B, T) bool
    noise: torch.Tensor,            # (B, seq_len, latent) fp32 standard normal
    model_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """One-shot sampling. Returns fp32 latents (B, sequence_length, latent)."""
    _check_solver(sc)
    with span("sampler.kv", "launch"):
        kv_text = get_kv_cache_text(params, cfg, text_input_ids, text_mask)
        kv_speaker = get_kv_cache_speaker(params, cfg, speaker_latent.to(model_dtype))
    x_init = noise.float()
    if sc.truncation_factor is not None:
        x_init = x_init * sc.truncation_factor
    return euler_cfg_scan(params, cfg, sc, x_init, text_mask, speaker_mask,
                          kv_text, kv_speaker, model_dtype)
