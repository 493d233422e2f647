"""Tiny configurations for the CPU tests: the published structure at toy
widths, as the served program's own tests shrink it."""
from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(os.path.dirname(HERE), "configs")

TINY_DIT = dict(model_size=64, num_layers=2, num_heads=4, intermediate_size=96,
                text_model_size=40, text_num_layers=2, text_num_heads=2,
                text_intermediate_size=64, speaker_model_size=40, speaker_num_layers=2,
                speaker_num_heads=2, speaker_intermediate_size=64, timestep_embed_size=32,
                adaln_rank=8)
TINY_AE = dict(encoder_dim=32, encoder_rates=[2, 2], latent_dim=64, decoder_dim=64,
               decoder_rates=[2, 2], encoder_transformer_layers=[0, 1],
               decoder_transformer_layers=[1, 0], n_codebooks=2, codebook_size=16,
               codebook_dim=4, semantic_codebook_size=32, q_n_layer=1, q_n_head=2, q_dim=64,
               q_intermediate_size=96, q_head_dim=32, q_window_size=8, enc_window_size=16)
TINY_PIPE = dict(max_text_length=768, text_buckets=[768], speaker_buckets=[16, 32],
                 audio_chunk_latents=16, max_speaker_latent_length=32)


def tiny_config(name: str, dtype: str = "float32") -> dict:
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["dit"].update(TINY_DIT)
    cfg["ae"].update(TINY_AE)
    cfg["pipeline"].update(TINY_PIPE)
    cfg["dtype"] = dtype
    return cfg
