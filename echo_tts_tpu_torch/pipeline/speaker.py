"""Speaker-prompt conditioning (counterpart of echo_tts_tpu/pipeline/speaker.py):
chunked S1-DAC encode of up to 5 minutes of reference audio in fixed
640-latent chunks, PCA projection, and the decode back to audio."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from echo_tts_tpu_torch.core.config import AEConfig
from echo_tts_tpu_torch.models import pca as pca_mod
from echo_tts_tpu_torch.models import s1dac


@torch.no_grad()
def ae_encode(ae_params: dict, ae_cfg: AEConfig, pca: pca_mod.PCAState,
              audio: torch.Tensor) -> torch.Tensor:
    """audio (B, 1, T) -> (B, T/2048, 80) fp32."""
    return pca_mod.project(pca, s1dac.encode_zq(ae_params, ae_cfg, audio))


@torch.no_grad()
def ae_decode(ae_params: dict, ae_cfg: AEConfig, pca: pca_mod.PCAState,
              latents: torch.Tensor) -> torch.Tensor:
    """(B, T, 80) -> waveform (B, 1, T*2048) fp32."""
    z_q = pca_mod.deproject(pca, latents).to(s1dac.params_dtype(ae_params))
    return s1dac.decode_zq(ae_params, ae_cfg, z_q).float()


@torch.no_grad()
def ae_reconstruct(ae_params: dict, ae_cfg: AEConfig, pca: pca_mod.PCAState,
                   audio: torch.Tensor) -> torch.Tensor:
    """The AE round trip, encode then decode: audio (B, 1, T) -> (B, 1, T')
    fp32, for auditioning a prompt."""
    return ae_decode(ae_params, ae_cfg, pca, ae_encode(ae_params, ae_cfg, pca, audio))


def get_speaker_latent_and_mask(
    ae_params: dict,
    ae_cfg: AEConfig,
    pca: pca_mod.PCAState,
    audio: np.ndarray,                      # (1, samples)
    max_speaker_latent_length: int = 6400,
    audio_chunk_latents: int = 640,
    pad_to_max: bool = False,
    divis_by_patch_size: Optional[int] = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (latent (1, S, 80) fp32, mask (1, S) bool) as numpy arrays."""
    device = pca.components.device
    down = ae_cfg.frame_length
    chunk_samples = audio_chunk_latents * down
    audio = np.asarray(audio)[:, : max_speaker_latent_length * down]

    latent_arr = []
    for i in range(0, audio.shape[1], chunk_samples):
        chunk = audio[:, i: i + chunk_samples]
        if chunk.shape[1] < chunk_samples:
            chunk = np.pad(chunk, ((0, 0), (0, chunk_samples - chunk.shape[1])))
        x = torch.as_tensor(chunk[None], dtype=torch.float32, device=device)
        latent_arr.append(ae_encode(ae_params, ae_cfg, pca, x).cpu().numpy())
    speaker_latent = np.concatenate(latent_arr, axis=1)

    actual = audio.shape[1] // down
    mask = (np.arange(speaker_latent.shape[1]) < actual)[None]
    if pad_to_max and speaker_latent.shape[1] < max_speaker_latent_length:
        padn = max_speaker_latent_length - speaker_latent.shape[1]
        speaker_latent = np.pad(speaker_latent, ((0, 0), (0, padn), (0, 0)))
        mask = np.pad(mask, ((0, 0), (0, padn)))
    elif not pad_to_max:
        speaker_latent = speaker_latent[:, :actual]
        mask = mask[:, :actual]

    if divis_by_patch_size:
        n = speaker_latent.shape[1] // divis_by_patch_size * divis_by_patch_size
        speaker_latent = speaker_latent[:, :n]
        mask = mask[:, :n]
    return speaker_latent.astype(np.float32), mask


def find_min_bucket_gte(buckets, actual_length: int) -> int:
    """Smallest bucket >= length, else the largest bucket."""
    cand = [b for b in buckets if b >= actual_length]
    return min(cand) if cand else max(buckets)
