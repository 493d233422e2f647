"""Sampler and text presets (counterpart of echo_tts_tpu/serve/presets.py).

The sampler-presets JSON schema is read as it is, string-valued numbers
included (`SamplerConfig.from_preset` coerces them)."""
from __future__ import annotations

import json
import os
from typing import Dict, List

from echo_tts_tpu_torch.core import config
from echo_tts_tpu_torch.core.config import SamplerConfig

# the shipped sampler_presets.json values, written on first use when the
# file is missing
DEFAULT_SAMPLER_PRESETS = {
    "Independent-High-Speaker-CFG": {
        "num_steps": "40", "cfg_scale_text": "3.0", "cfg_scale_speaker": "8.0",
        "cfg_min_t": "0.5", "cfg_max_t": "1.0", "truncation_factor": "1.",
        "rescale_k": "1.", "rescale_sigma": "3.0"},
    "Independent-High-Speaker-CFG-Flat": {
        "num_steps": "40", "cfg_scale_text": "3.0", "cfg_scale_speaker": "8.0",
        "cfg_min_t": "0.5", "cfg_max_t": "1.0", "truncation_factor": "0.8",
        "rescale_k": "1.2", "rescale_sigma": "3.0"},
    "Independent-High-CFG": {
        "num_steps": "40", "cfg_scale_text": "8.0", "cfg_scale_speaker": "8.0",
        "cfg_min_t": "0.5", "cfg_max_t": "1.0", "truncation_factor": "1.",
        "rescale_k": "1.", "rescale_sigma": "3.0"},
    "Independent-High-CFG-Flat": {
        "num_steps": "40", "cfg_scale_text": "8.0", "cfg_scale_speaker": "8.0",
        "cfg_min_t": "0.5", "cfg_max_t": "1.0", "truncation_factor": "0.8",
        "rescale_k": "1.2", "rescale_sigma": "3.0"},
    "Independent-Low-CFG": {
        "num_steps": "40", "cfg_scale_text": "3.0", "cfg_scale_speaker": "3.0",
        "cfg_min_t": "0.5", "cfg_max_t": "1.0", "truncation_factor": "1.",
        "rescale_k": "1.", "rescale_sigma": "3.0"},
    "Independent-Low-CFG-Flat": {
        "num_steps": "40", "cfg_scale_text": "3.0", "cfg_scale_speaker": "3.0",
        "cfg_min_t": "0.5", "cfg_max_t": "1.0", "truncation_factor": "0.8",
        "rescale_k": "1.2", "rescale_sigma": "3.0"},
}

# the UI's quick-apply buttons: a guidance pair and a truncation triple
FORCE_SPEAKER_PRESETS = {
    "higher speaker": {"cfg_scale_text": 3.0, "cfg_scale_speaker": 8.0},
    "large guidances": {"cfg_scale_text": 8.0, "cfg_scale_speaker": 8.0},
}
TRUNCATION_PRESETS = {
    "flat": {"truncation_factor": 0.8, "rescale_k": 1.2, "rescale_sigma": 3.0},
    "sharp": {"truncation_factor": 0.9, "rescale_k": 0.96, "rescale_sigma": 3.0},
    "baseline": {"truncation_factor": 1.0, "rescale_k": 1.0, "rescale_sigma": 3.0},
}


def load_sampler_presets(path: str, write_default: bool = True) -> Dict[str, SamplerConfig]:
    """{name: SamplerConfig} from a presets JSON file; a missing file is
    first written with DEFAULT_SAMPLER_PRESETS when `write_default`."""
    if not os.path.exists(path) and write_default:
        with open(path, "w") as f:
            json.dump(DEFAULT_SAMPLER_PRESETS, f, indent=2)
    return config.load_sampler_presets(path)


def load_text_presets(path: str) -> List[List[str]]:
    """Rows [category, word_count, text] from 'Category | text' lines: split
    on ' | ' (one space each side); a line without the separator is
    'Uncategorized'; the word count is len(text.split()). A missing file
    gives no rows."""
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        lines = [line.strip() for line in f if line.strip()]
    result = []
    for line in lines:
        if " | " in line:
            category, text = line.split(" | ", 1)
        else:
            category, text = "Uncategorized", line
        result.append([category, str(len(text.split())), text])
    return result
