"""One-shot sampling pipeline (counterpart of echo_tts_tpu/pipeline/pipeline.py):

text -> ids/mask (cap 768) -> speaker audio -> chunked latents/mask ->
Euler sampler -> PCA deproject + S1-DAC decode -> flattening-point crop.

Text and speaker lengths are padded to the configured shape buckets, as in
the JAX package, so both packages see the same shapes. Runs on the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig, PipelineConfig, SamplerConfig
from echo_tts_tpu_torch.core.device import resolve_device
from echo_tts_tpu_torch.models import pca as pca_mod
from echo_tts_tpu_torch.models import s1dac
from echo_tts_tpu_torch.pipeline import tokenizer as tok
from echo_tts_tpu_torch.pipeline.flattening import crop_audio_to_flattening_point
from echo_tts_tpu_torch.pipeline.speaker import find_min_bucket_gte, get_speaker_latent_and_mask
from echo_tts_tpu_torch.sampling.euler_cfg import (
    draw_noise,
    sample_euler_cfg_independent_guidances,
)


@dataclasses.dataclass
class EchoTTS:
    """The three weight sets plus configs, on one device (default cuda;
    raises when CUDA is absent and the CPU was not asked for, and when the
    PCA state or any DiT/AE weight lies on another device)."""

    dit_params: dict
    dit_cfg: DiTConfig
    ae_params: dict
    ae_cfg: AEConfig
    pca: pca_mod.PCAState
    model_dtype: torch.dtype = torch.bfloat16
    pipe_cfg: PipelineConfig = PipelineConfig()
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        want = self.device
        if want.type == "cuda" and want.index is None:
            want = torch.device("cuda", torch.cuda.current_device())
        named = [("pca.components", self.pca.components), ("pca.mean", self.pca.mean)]
        named += _named_leaves("dit_params", self.dit_params)
        named += _named_leaves("ae_params", self.ae_params)
        for name, leaf in named:
            if leaf.device != want:
                raise ValueError(f"{name} is on {leaf.device}, but this EchoTTS runs on "
                                 f"{want}: build every weight set on the same device")


def _named_leaves(prefix: str, tree):
    """(dotted name, tensor) for every tensor leaf of nested dicts/lists."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named_leaves(f"{prefix}.{k}", v)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _named_leaves(f"{prefix}.{i}", v)]
    return [(prefix, tree)] if isinstance(tree, torch.Tensor) else []


@torch.no_grad()
def _sample_and_decode(dit_params, dit_cfg, sc, ae_params, ae_cfg, pca,
                       speaker_latent, speaker_mask, ids, text_mask, noise,
                       model_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampler + PCA deproject + S1-DAC decode. Returns (latents fp32,
    audio fp32)."""
    latents = sample_euler_cfg_independent_guidances(
        dit_params, dit_cfg, sc, speaker_latent, speaker_mask, ids, text_mask,
        noise, model_dtype=model_dtype)
    z_q = pca_mod.deproject(pca, latents).to(s1dac.params_dtype(ae_params))
    audio = s1dac.decode_zq(ae_params, ae_cfg, z_q)
    return latents, audio.float()


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    if arr.shape[1] >= n:
        return arr[:, :n]
    pad = [(0, 0)] * arr.ndim
    pad[1] = (0, n - arr.shape[1])
    return np.pad(arr, pad)


def _prepare_inputs(tts: EchoTTS, text_prompt: str, speaker_audio: Optional[np.ndarray],
                    normalize_text: bool, pad_to_max_text_length: Optional[int],
                    pad_to_max_speaker_latent_length: Optional[int], use_buckets: bool):
    """Text/speaker preprocessing on the host. The no-speaker fallback is a
    zero (1, 4, 80) latent with an all-false mask (one speaker patch)."""
    pc = tts.pipe_cfg
    timings = {}

    t0 = time.perf_counter()
    max_text = min(pad_to_max_text_length or pc.max_text_length, pc.max_text_length)
    ids, text_mask, normalized = tok.get_text_input_ids_and_mask(
        [text_prompt], max_length=max_text, normalize=normalize_text)
    if pad_to_max_text_length is None and use_buckets:
        bucket = find_min_bucket_gte(pc.text_buckets, int(text_mask.sum()))
        ids = _pad_to(ids, bucket)
        text_mask = _pad_to(text_mask, bucket)
    timings["tokenize"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if speaker_audio is None:
        n = pad_to_max_speaker_latent_length or 4
        speaker_latent = np.zeros((1, n, tts.dit_cfg.latent_size), np.float32)
        speaker_mask = np.zeros((1, n), bool)
    else:
        speaker_latent, speaker_mask = get_speaker_latent_and_mask(
            tts.ae_params, tts.ae_cfg, tts.pca, speaker_audio,
            max_speaker_latent_length=(pad_to_max_speaker_latent_length
                                       or pc.max_speaker_latent_length),
            audio_chunk_latents=pc.audio_chunk_latents,
            pad_to_max=pad_to_max_speaker_latent_length is not None)
        if pad_to_max_speaker_latent_length is None and use_buckets:
            bucket = find_min_bucket_gte(pc.speaker_buckets, speaker_latent.shape[1])
            speaker_latent = _pad_to(speaker_latent, bucket)
            speaker_mask = _pad_to(speaker_mask, bucket)
    timings["speaker_encode"] = time.perf_counter() - t0
    return ids, text_mask, normalized, speaker_latent, speaker_mask, timings


def sample_pipeline(
    tts: EchoTTS,
    text_prompt: str,
    speaker_audio: Optional[np.ndarray],       # (1, samples) or None
    rng_seed: int,
    sc: Optional[SamplerConfig] = None,
    pad_to_max_speaker_latent_length: Optional[int] = None,
    pad_to_max_text_length: Optional[int] = None,
    normalize_text: bool = False,
    noise: Optional[np.ndarray] = None,
    use_buckets: bool = True,
) -> Tuple[np.ndarray, str, dict]:
    """Returns (audio (1, 1, T) fp32 numpy, normalized text, timings).

    timings holds the wall seconds of each stage (tokenize, speaker_encode,
    sample = sampler + decode, crop) and, for checks, the sample count and
    finiteness of the audio before the crop. `noise` (1, sequence_length,
    latent) replaces the seeded draw (`draw_noise`: the numbers
    jax.random.normal gives the JAX package for the same seed)."""
    sc = sc or SamplerConfig()
    dev = tts.device
    (ids, text_mask, normalized, speaker_latent, speaker_mask,
     timings) = _prepare_inputs(tts, text_prompt, speaker_audio, normalize_text,
                                pad_to_max_text_length, pad_to_max_speaker_latent_length,
                                use_buckets)

    t0 = time.perf_counter()
    shape = (1, sc.sequence_length, tts.dit_cfg.latent_size)
    noise_t = (draw_noise(rng_seed, shape, dev) if noise is None
               else torch.as_tensor(np.asarray(noise), dtype=torch.float32, device=dev))
    latents, audio = _sample_and_decode(
        tts.dit_params, tts.dit_cfg, sc, tts.ae_params, tts.ae_cfg, tts.pca,
        torch.as_tensor(speaker_latent, device=dev), torch.as_tensor(speaker_mask, device=dev),
        torch.as_tensor(ids, device=dev), torch.as_tensor(text_mask, device=dev),
        noise_t, tts.model_dtype)
    audio = audio.cpu().numpy()
    timings["sample"] = time.perf_counter() - t0
    timings["samples_before_crop"] = float(audio.shape[-1])
    timings["finite_before_crop"] = float(np.isfinite(audio).all())

    t0 = time.perf_counter()
    audio = crop_audio_to_flattening_point(audio, latents[0],
                                           samples_per_latent=tts.ae_cfg.frame_length)
    timings["crop"] = time.perf_counter() - t0
    return audio, normalized[0], timings
