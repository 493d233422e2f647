"""Blockwise / continuation generation (counterpart of
echo_tts_tpu/sampling/blockwise.py).

The prefix latent buffer is allocated at its full size up front and filled
block by block. The latent-prefix KV is incremental: after each block its
latents are appended into preallocated buffers (`models/dit.py:
extend_latent_kv`), and the next block attends to them through the latent
segment, gated by `latent_pos < start_pos`. Every block's 40 Euler steps run
the trunk with three segments, [latent | text | speaker], through kernel K1.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from echo_tts_tpu_torch.core.config import DiTConfig, SamplerConfig
from echo_tts_tpu_torch.core.rope import per_row, precompute_rope, row_slots, rope_rows
from echo_tts_tpu_torch.models.dit import (
    extend_latent_kv,
    get_kv_cache_speaker,
    get_kv_cache_text,
    init_latent_kv_state,
)
from echo_tts_tpu_torch.sampling.euler_cfg import euler_cfg_scan
from echo_tts_tpu_torch.sampling.jax_random import jax_fold_in, jax_normal
from echo_tts_tpu_torch.utils.profiling import span


@torch.no_grad()
def sample_block_core(params: dict, cfg: DiTConfig, sc: SamplerConfig,
                      prefix_latent: torch.Tensor, lat_state: dict, start_pos,
                      noise: torch.Tensor, text_mask, speaker_mask, kv_text, kv_speaker,
                      block_size: int, total_len: int, model_dtype: torch.dtype,
                      valid_len=None):
    """Sample latents [start_pos, start_pos + block_size) into
    `prefix_latent` (B, total_len, latent) fp32 and append them to
    `lat_state`, both in place; returns (prefix_latent, lat_state). The
    queries take RoPE at their absolute positions; the latent segment shows
    only the patches before start_pos. start_pos is one int for every row,
    or one position a row ((B,): continuous batching, where each row of the
    batch is its own stream). valid_len (B,), when given, is each row's
    count of valid positions in this block: kernel K1's `self_len`, so that
    a row on its final partial block does not see the keys past its budget
    (a free slot passes 0; what it computes is thrown away)."""
    dev = prefix_latent.device
    b = prefix_latent.shape[0]
    kv_latent = (lat_state["k"], lat_state["v"])
    n_lat = kv_latent[0].shape[3]
    latent_pos = torch.arange(n_lat, device=dev) * cfg.speaker_patch_size
    cos, sin = precompute_rope(cfg.head_dim, total_len, device=dev)
    rows = per_row(start_pos)
    if rows:
        start_pos = torch.as_tensor(start_pos, dtype=torch.long, device=dev).reshape(b)
        latent_mask = latent_pos[None] < start_pos[:, None]
        rope_q = rope_rows(cos, sin, start_pos[:, None] + torch.arange(block_size, device=dev))
    else:
        start_pos = int(start_pos)
        latent_mask = (latent_pos < start_pos)[None].expand(b, n_lat)
        rope_q = (cos[start_pos:start_pos + block_size], sin[start_pos:start_pos + block_size])
    if valid_len is not None:
        valid_len = torch.as_tensor(valid_len, dtype=torch.int32, device=dev).reshape(b)

    x_init = noise.float()
    if sc.truncation_factor is not None:
        x_init = x_init * sc.truncation_factor
    x_out = euler_cfg_scan(params, cfg, sc, x_init, text_mask, speaker_mask, kv_text,
                           kv_speaker, model_dtype, rope_q=rope_q, kv_latent=kv_latent,
                           latent_mask=latent_mask, self_len=valid_len)
    # this block's KV conditions the next blocks
    with span("sampler.kv", "launch"):
        extend_latent_kv(params, cfg, lat_state, x_out.to(model_dtype), start_pos)
        if rows:
            prefix_latent[torch.arange(b, device=dev)[:, None],
                          row_slots(start_pos, block_size, total_len)] = x_out
        else:
            prefix_latent[:, start_pos:start_pos + block_size] = x_out
    return prefix_latent, lat_state


def check_patch_aligned(block_sizes: Sequence[int], cont_len: int, patch: int) -> None:
    """Block sizes and the continuation length must be multiples of the
    latent patch size: `extend_latent_kv` appends whole patches."""
    bad = [int(s) for s in block_sizes if int(s) % patch]
    if bad or cont_len % patch:
        raise ValueError(
            f"streaming block sizes {list(map(int, block_sizes))} and continuation "
            f"length {cont_len} must be multiples of the latent patch size {patch} "
            f"(blocks are appended to the latent-prefix KV in patches; use "
            f"pipeline._block_schedule(..., patch=...) to round a schedule)")


@torch.no_grad()
def sample_blockwise_stream(params: dict, cfg: DiTConfig, sc: SamplerConfig,
                            speaker_latent: torch.Tensor, speaker_mask: torch.Tensor,
                            text_input_ids: torch.Tensor, text_mask: torch.Tensor,
                            block_sizes: Sequence[int],
                            noises: Optional[List[torch.Tensor]] = None, rng_seed: int = 0,
                            continuation_latent: Optional[torch.Tensor] = None,
                            model_dtype: torch.dtype = torch.bfloat16):
    """Generator form of the blockwise sampler: after each block yields
    (prefix_latent (B, total_len, latent) fp32, start_pos, block_size).
    Without `noises`, block i draws `jax.random.normal(fold_in(
    PRNGKey(rng_seed), i))`'s numbers. `continuation_latent` (B, C, latent)
    seeds the prefix and the latent caches; blocks follow it. The prefix
    buffer is written in place: copy a yielded prefix to keep it."""
    p = cfg.speaker_patch_size
    cont_len = 0 if continuation_latent is None else int(continuation_latent.shape[1])
    check_patch_aligned(block_sizes, cont_len, p)
    b = text_input_ids.shape[0]
    dev = text_input_ids.device
    kv_text = get_kv_cache_text(params, cfg, text_input_ids, text_mask)
    kv_speaker = get_kv_cache_speaker(params, cfg, speaker_latent.to(model_dtype))
    total_len = cont_len + sum(int(s) for s in block_sizes)

    prefix = torch.zeros((b, total_len, cfg.latent_size), dtype=torch.float32, device=dev)
    lat_state = init_latent_kv_state(params, cfg, b, total_len, model_dtype)
    if continuation_latent is not None:
        prefix[:, :cont_len] = continuation_latent.float()
        extend_latent_kv(params, cfg, lat_state, continuation_latent.to(model_dtype), 0)

    start_pos = cont_len
    for bi, block_size in enumerate(int(s) for s in block_sizes):
        if noises is not None:
            noise = torch.as_tensor(noises[bi], dtype=torch.float32, device=dev)
        else:
            noise = torch.from_numpy(jax_normal(jax_fold_in(rng_seed, bi),
                                                (b, block_size, cfg.latent_size))).to(dev)
        prefix, lat_state = sample_block_core(
            params, cfg, sc, prefix, lat_state, start_pos, noise, text_mask, speaker_mask,
            kv_text, kv_speaker, block_size, total_len, model_dtype)
        yield prefix, start_pos, block_size
        start_pos += block_size


def sample_blockwise_euler_cfg_independent_guidances(
        params: dict, cfg: DiTConfig, sc: SamplerConfig, speaker_latent: torch.Tensor,
        speaker_mask: torch.Tensor, text_input_ids: torch.Tensor, text_mask: torch.Tensor,
        block_sizes: Sequence[int], noises: Optional[List[torch.Tensor]] = None,
        rng_seed: int = 0, continuation_latent: Optional[torch.Tensor] = None,
        model_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """All blocks at once. Returns fp32 latents (B, continuation_len +
    sum(block_sizes), latent_size)."""
    prefix = None
    for prefix, _, _ in sample_blockwise_stream(
            params, cfg, sc, speaker_latent, speaker_mask, text_input_ids, text_mask,
            block_sizes, noises=noises, rng_seed=rng_seed,
            continuation_latent=continuation_latent, model_dtype=model_dtype):
        pass
    return prefix
