"""The served program's objects, built from a configuration file and the
benchmark's weights. This is the one place the harness constructs the
port's containers; runners call the port's own entry points on them."""
from __future__ import annotations

import torch

from .weights import DTYPES


def as_tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def echo_tts(cfg: dict, weights: dict, device):
    """An `EchoTTS` over `weights` (harness/weights.py) on `device`."""
    from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig, PipelineConfig
    from echo_tts_tpu_torch.models.pca import PCAState
    from echo_tts_tpu_torch.pipeline.pipeline import EchoTTS

    pca = weights["pca"]
    return EchoTTS(weights["dit"], DiTConfig(**as_tuples(cfg["dit"])), weights["ae"],
                   AEConfig(**as_tuples(cfg["ae"])),
                   PCAState(pca["components"], pca["mean"], float(pca["latent_scale"])),
                   model_dtype=DTYPES[cfg["dtype"]],
                   pipe_cfg=PipelineConfig(**as_tuples(cfg["pipeline"])), device=torch.device(device))


def sampler_config(sc: dict):
    from echo_tts_tpu_torch.core.config import SamplerConfig

    return SamplerConfig(**sc)
