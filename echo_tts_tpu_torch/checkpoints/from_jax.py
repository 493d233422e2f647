"""Carry the JAX package's parameters into the port.

The port keeps the JAX package's pytree as its own parameter state: nested
dicts and lists with the layer stacks on a leading (L, ...) axis, linear
weights as (in, out), conv weights as torch-layout (O, I, K) and transposed
conv weights as (I, O, K). So the conversion is leaf by leaf: each array
(numpy, or anything `np.asarray` takes) becomes a tensor on `device`,
optionally cast to `dtype`. A few shapes are checked against the config.

A tree quantized by the JAX package's `quantize_dit_params` carries over as
it is: each `{"q": int8 (…, K, N), "s": fp32 (…, N)}` leaf keeps int8 codes
and fp32 scales whatever `dtype` asks, and its codes are laid K-major,
(…, N, K), the port's layout (`models/quant.py`), here once.

Leaves may also be torch tensors already (the safetensors loaders of
`checkpoints/io.py` convert on the device): they are moved and cast the same
way. A leaf of raw bf16 bits (2-byte void items, how npz holds bf16) is read
as the bf16 values it holds.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from echo_tts_tpu_torch.checkpoints.safetensors import bf16_bits_to_f32
from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig
from echo_tts_tpu_torch.core.device import resolve_device
from echo_tts_tpu_torch.models.quant import is_quantized


def _convert(tree, device, dtype):
    if is_quantized(tree):
        q = np.ascontiguousarray(np.swapaxes(np.asarray(tree["q"], np.int8), -1, -2))
        s = np.asarray(tree["s"], np.float32)
        return {"q": torch.from_numpy(q).to(device), "s": torch.from_numpy(s.copy()).to(device)}
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.to(device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t
    arr = np.asarray(tree)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        arr = bf16_bits_to_f32(arr)
    elif str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)  # ml_dtypes bf16 has no torch buffer path
    t = torch.from_numpy(np.array(arr)).to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _expect(name: str, t, shape) -> None:
    """t's shape, a quantized leaf's as the plain (…, K, N) weight's."""
    got = tuple(t.shape) if not is_quantized(t) else \
        tuple(t["q"].shape[:-2]) + (t["q"].shape[-1], t["q"].shape[-2])
    if got != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {got}")


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
    ds = cfg.speaker_model_size
    if cfg.has_latent_modules:
        for name in ("wk_latent", "wv_latent"):
            _expect(f"blocks.attention.{name}", attn[name], (l, ds, d))
        _expect("latent_encoder.in_proj.w", p["latent_encoder"]["in_proj"]["w"],
                (cfg.latent_size * cfg.speaker_patch_size, ds))
        _expect("latent_encoder.blocks.attention.wq",
                p["latent_encoder"]["blocks"]["attention"]["wq"],
                (cfg.speaker_num_layers, ds, ds))
        _expect("latent_norm", p["latent_norm"], (ds,))
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


def res_units_from_numpy(units, device=None, dtype: Optional[torch.dtype] = None) -> list:
    """The measurement scripts' residual units (a list of {snake1 (1, C, 1),
    conv1 {w (C, C, 7), b}, snake2, conv2 {w (C, C, 1), b}}) -> the port's,
    on `device` (default cuda)."""
    us = _convert(list(units), resolve_device(device), dtype)
    for i, u in enumerate(us):
        c = u["snake1"].numel()
        _expect(f"units[{i}].conv1.w", u["conv1"]["w"], (c, c, 7))
        _expect(f"units[{i}].conv2.w", u["conv2"]["w"], (c, c, 1))
        _expect(f"units[{i}].snake2", u["snake2"], (1, c, 1))
    return us


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
