"""Carry the JAX package's parameters into the port.

The port keeps the JAX package's pytree as its own parameter state: nested
dicts and lists with the layer stacks on a leading (L, ...) axis, linear
weights as (in, out), conv weights as torch-layout (O, I, K) and transposed
conv weights as (I, O, K). So the conversion is leaf by leaf: each array
(numpy, or anything `np.asarray` takes) becomes a tensor on `device`,
optionally cast to `dtype`. A few shapes are checked against the config.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig
from echo_tts_tpu_torch.core.device import resolve_device


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)  # ml_dtypes bf16 has no torch buffer path
    t = torch.from_numpy(np.array(arr)).to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _expect(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def dit_params_from_numpy(tree: dict, cfg: DiTConfig, device=None,
                          dtype: Optional[torch.dtype] = None) -> dict:
    """JAX DiT params (echo_tts_tpu/models/dit.py:init_dit_params layout)
    -> the port's parameter dict on `device` (default cuda)."""
    p = _convert(tree, resolve_device(device), dtype)
    d, l = cfg.model_size, cfg.num_layers
    attn = p["blocks"]["attention"]
    _expect("blocks.attention.wq", attn["wq"], (l, d, d))
    _expect("blocks.attention.q_norm", attn["q_norm"], (l, cfg.num_heads, cfg.head_dim))
    _expect("blocks.attention.wk_text", attn["wk_text"], (l, cfg.text_model_size, d))
    _expect("in_proj.w", p["in_proj"]["w"], (cfg.latent_size, d))
    _expect("text_encoder.embedding", p["text_encoder"]["embedding"],
            (cfg.text_vocab_size, cfg.text_model_size))
    return p


def ae_params_from_numpy(tree: dict, cfg: AEConfig, device=None,
                         dtype: Optional[torch.dtype] = None) -> dict:
    """JAX S1-DAC params (echo_tts_tpu/bench/init_ae.py layout) -> the
    port's parameter dict on `device` (default cuda)."""
    p = _convert(tree, resolve_device(device), dtype)
    _expect("decoder.stem.w", p["decoder"]["stem"]["w"], (cfg.decoder_dim, cfg.latent_dim, 7))
    _expect("encoder.stem.w", p["encoder"]["stem"]["w"], (cfg.encoder_dim, 1, 7))
    if len(p["decoder"]["blocks"]) != len(cfg.decoder_rates):
        raise ValueError("decoder block count does not match the config")
    if len(p["quantizer"]["residual"]) != cfg.n_codebooks:
        raise ValueError("residual codebook count does not match the config")
    return p


def lora_from_numpy(tree: dict, device=None) -> dict:
    """A JAX LoRA side-car ({target: {"a": (L, in, r), "b": (L, r, out)}},
    echo_tts_tpu/train/lora.py:init_lora) -> the port's, fp32 on `device`
    (default cuda)."""
    lora = _convert(tree, resolve_device(device), torch.float32)
    for tgt, ab in lora.items():
        a, b = ab["a"], ab["b"]
        if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
            raise ValueError(f"{tgt}: a {tuple(a.shape)} and b {tuple(b.shape)} are not "
                             "a stacked (L, in, r) / (L, r, out) adapter")
    return lora
