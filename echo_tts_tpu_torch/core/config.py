"""Frozen configuration dataclasses (counterpart of echo_tts_tpu/core/config.py).

A copy with the same fields and defaults, so a config built for one package
describes the same model in the other. `DTYPE_POLICY` holds torch dtypes.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """EchoDiT hyperparameters."""

    latent_size: int = 80
    model_size: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 5888
    norm_eps: float = 1e-5
    # text encoder
    text_vocab_size: int = 256
    text_model_size: int = 1280
    text_num_layers: int = 14
    text_num_heads: int = 10
    text_intermediate_size: int = 3328
    # speaker / latent encoders (two identical instances)
    speaker_patch_size: int = 4
    speaker_model_size: int = 1280
    speaker_num_layers: int = 14
    speaker_num_heads: int = 10
    speaker_intermediate_size: int = 3328
    # conditioning
    timestep_embed_size: int = 512
    adaln_rank: int = 256
    # whether the blockwise modules (latent_encoder / wk_latent / wv_latent)
    # are present
    has_latent_modules: bool = True

    @property
    def head_dim(self) -> int:
        return self.model_size // self.num_heads

    @property
    def text_head_dim(self) -> int:
        return self.text_model_size // self.text_num_heads

    @property
    def speaker_head_dim(self) -> int:
        return self.speaker_model_size // self.speaker_num_heads

    def tiny(self) -> "DiTConfig":
        """A structurally-identical small config for tests."""
        return dataclasses.replace(
            self,
            model_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=96,
            text_model_size=40,
            text_num_layers=2,
            text_num_heads=2,
            text_intermediate_size=64,
            speaker_model_size=40,
            speaker_num_layers=2,
            speaker_num_heads=2,
            speaker_intermediate_size=64,
            timestep_embed_size=32,
            adaln_rank=8,
        )


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Euler CFG sampler settings, with the opt-in levers `solver`
    ("euler" or "midpoint"), `uncond_cache_interval` and `joint_uncond`
    (sampling/euler_cfg.py)."""

    num_steps: int = 40
    cfg_scale_text: float = 3.0
    cfg_scale_speaker: float = 8.0
    cfg_min_t: float = 0.5
    cfg_max_t: float = 1.0
    truncation_factor: Optional[float] = 1.0
    rescale_k: Optional[float] = None
    rescale_sigma: Optional[float] = None
    speaker_kv_scale: Optional[float] = None
    speaker_kv_max_layers: Optional[int] = None
    speaker_kv_min_t: Optional[float] = None
    sequence_length: int = 640
    init_scale: float = 0.999
    joint_uncond: bool = False
    uncond_cache_interval: int = 1
    first_block_steps: Optional[int] = None
    solver: str = "euler"

    @staticmethod
    def from_preset(d: dict, **overrides) -> "SamplerConfig":
        """A config from the sampler-presets JSON schema, whose numbers may
        be strings ("40", "1.", "none"); the integer fields come back as
        ints and a bool (joint_uncond over HTTP) stays a bool."""

        def to_num(v, is_int=False):
            if v is None or v == "" or (isinstance(v, str) and v.strip().lower() == "none"):
                return None
            if isinstance(v, bool):
                return v
            f = float(v)
            return int(f) if is_int else f

        kw = {}
        for f in dataclasses.fields(SamplerConfig):
            if f.name in d:
                if f.name == "solver":  # the one string-valued field
                    kw[f.name] = str(d[f.name])
                    continue
                is_int = f.name in ("num_steps", "speaker_kv_max_layers", "sequence_length",
                                    "uncond_cache_interval", "first_block_steps")
                kw[f.name] = to_num(d[f.name], is_int)
        kw.update(overrides)
        return SamplerConfig(**kw)


@dataclasses.dataclass(frozen=True)
class AEConfig:
    """Fish S1-DAC hyperparameters."""

    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    latent_dim: int = 1024
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    encoder_transformer_layers: Tuple[int, ...] = (0, 0, 0, 4)
    decoder_transformer_layers: Tuple[int, ...] = (4, 0, 0, 0)
    # quantizer
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    semantic_codebook_size: int = 4096
    downsample_factor: Tuple[int, ...] = (2, 2)
    # pre/post transformer config
    q_n_layer: int = 8
    q_n_head: int = 16
    q_dim: int = 1024
    q_intermediate_size: int = 3072
    q_head_dim: int = 64
    q_window_size: int = 128
    # encoder/decoder block transformer window
    enc_window_size: int = 512
    norm_eps: float = 1e-5
    sample_rate: int = 44100

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.encoder_rates:
            h *= r
        return h  # 512

    @property
    def frame_length(self) -> int:
        d = 1
        for f in self.downsample_factor:
            d *= f
        return self.hop_length * d  # 2048

    def tiny(self) -> "AEConfig":
        return dataclasses.replace(
            self,
            encoder_dim=32,
            encoder_rates=(2, 2),
            latent_dim=64,
            decoder_dim=64,
            decoder_rates=(2, 2),
            encoder_transformer_layers=(0, 1),
            decoder_transformer_layers=(1, 0),
            n_codebooks=2,
            codebook_size=16,
            codebook_dim=4,
            semantic_codebook_size=32,
            q_n_layer=1,
            q_n_head=2,
            q_dim=64,
            q_intermediate_size=96,
            q_head_dim=32,
            q_window_size=8,
            enc_window_size=16,
        )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Pipeline caps and shape buckets."""

    max_text_length: int = 768
    max_speaker_latent_length: int = 6400
    audio_chunk_latents: int = 640
    ae_downsample_factor: int = 2048
    sample_rate: int = 44100
    text_buckets: Tuple[int, ...] = (768,)
    speaker_buckets: Tuple[int, ...] = (640, 2816, 6400)
    latent_buckets: Tuple[int, ...] = (640,)


DTYPE_POLICY = {
    "dit": torch.bfloat16,
    "ae": torch.float32,
    "sampler_state": torch.float32,
    "pca": torch.float32,
}


def load_sampler_presets(path: str) -> dict:
    """A sampler_presets.json file as {name: SamplerConfig}."""
    with open(path) as f:
        raw = json.load(f)
    return {name: SamplerConfig.from_preset(d) for name, d in raw.items()}
