"""Checkpoint conversion: the reference's PyTorch state dicts -> the JAX
package's parameter layout (counterpart of echo_tts_tpu/checkpoints/convert.py,
a copy without its JAX import).

The output is the layout `checkpoints/from_jax.py` carries into the port
(`dit_params_from_numpy`, `ae_params_from_numpy`): torch Linear (out, in)
transposed to (in, out), per-layer module lists stacked on a leading axis,
the blockwise modules optionally stripped, and the S1-DAC's weight-norm
pairs folded into plain weights (in float64, as the JAX code folds them, so
the folded weights equal its bits).

A state is any mapping of the reference's tensor names to arrays: numpy
arrays (what the JAX package's converter takes; the output then equals its
output bit for bit), or torch tensors, for which the transposes and stacks
run as torch operations on the tensors' device (how `checkpoints/io.py`
converts a full-width DiT leaf by leaf on the card).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping

import numpy as np
import torch

from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig

State = Mapping[str, object]


def _t(x):
    """A 2-D weight transposed, contiguous."""
    return x.T.contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x.T)


def _stack_arrays(xs):
    return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)


def _lin(state: State, name: str):
    """torch Linear weight (out, in) -> (in, out)."""
    return _t(state[f"{name}.weight"])


def _stack(fn, n):
    return _stack_arrays([fn(i) for i in range(n)])


def _encoder_blocks(state: State, prefix: str, n_layers: int, n_heads: int) -> dict:
    def ln(i, sub):
        return _lin(state, f"{prefix}.blocks.{i}.{sub}")

    def w(i, sub):
        return state[f"{prefix}.blocks.{i}.{sub}.weight"]

    return {
        "attention": {
            "wq": _stack(lambda i: ln(i, "attention.wq"), n_layers),
            "wk": _stack(lambda i: ln(i, "attention.wk"), n_layers),
            "wv": _stack(lambda i: ln(i, "attention.wv"), n_layers),
            "wo": _stack(lambda i: ln(i, "attention.wo"), n_layers),
            "gate": _stack(lambda i: ln(i, "attention.gate"), n_layers),
            "q_norm": _stack(lambda i: w(i, "attention.q_norm"), n_layers),
            "k_norm": _stack(lambda i: w(i, "attention.k_norm"), n_layers),
        },
        "mlp": {
            "w1": _stack(lambda i: ln(i, "mlp.w1"), n_layers),
            "w3": _stack(lambda i: ln(i, "mlp.w3"), n_layers),
            "w2": _stack(lambda i: ln(i, "mlp.w2"), n_layers),
        },
        "attention_norm": _stack(lambda i: w(i, "attention_norm"), n_layers),
        "mlp_norm": _stack(lambda i: w(i, "mlp_norm"), n_layers),
    }


def convert_dit_state(state: State, cfg: DiTConfig,
                      delete_blockwise_modules: bool = False) -> dict:
    """Reference EchoDiT state dict -> the stacked JAX-layout tree."""
    l = cfg.num_layers
    has_latent = cfg.has_latent_modules and not delete_blockwise_modules

    def patch_encoder(prefix):
        return {
            "in_proj": {"w": _lin(state, f"{prefix}.in_proj"),
                        "b": state[f"{prefix}.in_proj.bias"]},
            "blocks": _encoder_blocks(state, prefix, cfg.speaker_num_layers,
                                      cfg.speaker_num_heads),
        }

    attn = {
        "wq": _stack(lambda i: _lin(state, f"blocks.{i}.attention.wq"), l),
        "wk": _stack(lambda i: _lin(state, f"blocks.{i}.attention.wk"), l),
        "wv": _stack(lambda i: _lin(state, f"blocks.{i}.attention.wv"), l),
        "wo": _stack(lambda i: _lin(state, f"blocks.{i}.attention.wo"), l),
        "gate": _stack(lambda i: _lin(state, f"blocks.{i}.attention.gate"), l),
        "wk_text": _stack(lambda i: _lin(state, f"blocks.{i}.attention.wk_text"), l),
        "wv_text": _stack(lambda i: _lin(state, f"blocks.{i}.attention.wv_text"), l),
        "wk_speaker": _stack(lambda i: _lin(state, f"blocks.{i}.attention.wk_speaker"), l),
        "wv_speaker": _stack(lambda i: _lin(state, f"blocks.{i}.attention.wv_speaker"), l),
        "q_norm": _stack(lambda i: state[f"blocks.{i}.attention.q_norm.weight"], l),
        "k_norm": _stack(lambda i: state[f"blocks.{i}.attention.k_norm.weight"], l),
    }
    if has_latent:
        attn["wk_latent"] = _stack(lambda i: _lin(state, f"blocks.{i}.attention.wk_latent"), l)
        attn["wv_latent"] = _stack(lambda i: _lin(state, f"blocks.{i}.attention.wv_latent"), l)

    def adaln(which):
        out = {}
        for nm in ("shift", "scale", "gate"):
            out[f"{nm}_down"] = _stack(lambda i: _lin(state, f"blocks.{i}.{which}.{nm}_down"), l)
            out[f"{nm}_up"] = {
                "w": _stack(lambda i: _lin(state, f"blocks.{i}.{which}.{nm}_up"), l),
                "b": _stack(lambda i: state[f"blocks.{i}.{which}.{nm}_up.bias"], l)}
        return out

    params = {
        "text_encoder": {
            "embedding": state["text_encoder.text_embedding.weight"],
            "blocks": _encoder_blocks(state, "text_encoder", cfg.text_num_layers,
                                      cfg.text_num_heads),
        },
        "speaker_encoder": patch_encoder("speaker_encoder"),
        "text_norm": state["text_norm.weight"],
        "speaker_norm": state["speaker_norm.weight"],
        "cond_module": {
            "w0": _lin(state, "cond_module.0"),
            "w1": _lin(state, "cond_module.2"),
            "w2": _lin(state, "cond_module.4"),
        },
        "in_proj": {"w": _lin(state, "in_proj"), "b": state["in_proj.bias"]},
        "blocks": {
            "attention": attn,
            "mlp": {
                "w1": _stack(lambda i: _lin(state, f"blocks.{i}.mlp.w1"), l),
                "w3": _stack(lambda i: _lin(state, f"blocks.{i}.mlp.w3"), l),
                "w2": _stack(lambda i: _lin(state, f"blocks.{i}.mlp.w2"), l),
            },
            "attention_adaln": adaln("attention_adaln"),
            "mlp_adaln": adaln("mlp_adaln"),
        },
        "out_norm": state["out_norm.weight"],
        "out_proj": {"w": _lin(state, "out_proj"), "b": state["out_proj.bias"]},
    }
    if has_latent:
        params["latent_encoder"] = patch_encoder("latent_encoder")
        params["latent_norm"] = state["latent_norm.weight"]
    return params


# ---------------------------------------------------------------------------
# Config inference from checkpoint shapes
# ---------------------------------------------------------------------------


def _shape(state: State, name: str):
    shape = getattr(state, "shape", None)
    return tuple(shape(name)) if callable(shape) else tuple(state[name].shape)


def _count(state: State, pattern: str) -> int:
    return 1 + max(int(m.group(1)) for k in state if (m := re.match(pattern, k)))


def infer_dit_config(state: State) -> DiTConfig:
    """A DiTConfig from a reference state dict's tensor shapes (a mapping
    with a `shape(name)` method, such as `SafeTensorsFile`, is read from its
    header alone)."""
    d, latent = _shape(state, "in_proj.weight")
    h, _hd = _shape(state, "blocks.0.attention.q_norm.weight")
    vocab, dt = _shape(state, "text_encoder.text_embedding.weight")
    th, _ = _shape(state, "text_encoder.blocks.0.attention.q_norm.weight")
    ds, patch_in = _shape(state, "speaker_encoder.in_proj.weight")
    sh, _ = _shape(state, "speaker_encoder.blocks.0.attention.q_norm.weight")
    return DiTConfig(
        latent_size=latent, model_size=d, num_layers=_count(state, r"blocks\.(\d+)\."),
        num_heads=h, intermediate_size=_shape(state, "blocks.0.mlp.w1.weight")[0],
        text_vocab_size=vocab, text_model_size=dt,
        text_num_layers=_count(state, r"text_encoder\.blocks\.(\d+)\."), text_num_heads=th,
        text_intermediate_size=_shape(state, "text_encoder.blocks.0.mlp.w1.weight")[0],
        speaker_patch_size=patch_in // latent, speaker_model_size=ds,
        speaker_num_layers=_count(state, r"speaker_encoder\.blocks\.(\d+)\."),
        speaker_num_heads=sh,
        speaker_intermediate_size=_shape(state, "speaker_encoder.blocks.0.mlp.w1.weight")[0],
        timestep_embed_size=_shape(state, "cond_module.0.weight")[1],
        adaln_rank=_shape(state, "blocks.0.attention_adaln.shift_down.weight")[0],
        has_latent_modules="latent_norm.weight" in state,
    )


def infer_ae_config(state: State, base: AEConfig = None) -> AEConfig:
    """Structural AEConfig fields from a (weight-norm-folded) S1-DAC state
    dict. Window sizes are not recoverable from shapes and keep the
    base/default values."""
    base = base or AEConfig()
    enc_dim = _shape(state, "encoder.block.0.conv.weight")[0]
    enc_blocks = sorted({int(m.group(1)) for k in state
                         if (m := re.match(r"encoder\.block\.(\d+)\.block\.", k))})
    rates, enc_t_layers = [], []
    for i in enc_blocks:
        rates.append(_shape(state, f"encoder.block.{i}.block.4.conv.weight")[-1] // 2)
        tl = {int(m.group(1)) for key in state
              if (m := re.match(rf"encoder\.block\.{i}\.block\.5\.layers\.(\d+)\.", key))}
        enc_t_layers.append(len(tl))
    latent_dim = _shape(state, f"encoder.block.{max(enc_blocks) + 2}.conv.weight")[0]
    dec_dim = _shape(state, "decoder.model.0.conv.weight")[0]
    dec_blocks = sorted({int(m.group(1)) for k in state
                         if (m := re.match(r"decoder\.model\.(\d+)\.block\.", k))})
    dec_rates = [_shape(state, f"decoder.model.{i}.block.1.conv.weight")[-1] // 2
                 for i in dec_blocks]
    n_cb = len({int(m.group(1)) for k in state
                if (m := re.match(r"quantizer\.quantizer\.quantizers\.(\d+)\.", k))})
    cb_size, cb_dim = _shape(state, "quantizer.quantizer.quantizers.0.codebook.weight")
    sem_size = _shape(state, "quantizer.semantic_quantizer.quantizers.0.codebook.weight")[0]
    ds_factors = []
    i = 0
    while f"quantizer.downsample.{i}.0.conv.weight" in state:
        ds_factors.append(_shape(state, f"quantizer.downsample.{i}.0.conv.weight")[-1])
        i += 1
    q_layers = len({int(m.group(1)) for k in state
                    if (m := re.match(r"quantizer\.pre_module\.layers\.(\d+)\.", k))})
    q_dim = _shape(state, "quantizer.pre_module.layers.0.attention.wo.weight")[0]
    q_ffn = _shape(state, "quantizer.pre_module.layers.0.feed_forward.w1.weight")[0]
    return dataclasses.replace(
        base, encoder_dim=enc_dim, encoder_rates=tuple(rates),
        latent_dim=latent_dim, decoder_dim=dec_dim,
        decoder_rates=tuple(dec_rates),
        encoder_transformer_layers=tuple(enc_t_layers),
        n_codebooks=n_cb, codebook_size=cb_size, codebook_dim=cb_dim,
        semantic_codebook_size=sem_size, downsample_factor=tuple(ds_factors),
        q_n_layer=q_layers, q_dim=q_dim,
        q_intermediate_size=q_ffn,
        q_n_head=q_dim // base.q_head_dim if q_dim % base.q_head_dim == 0
        else base.q_n_head,
    )


# ---------------------------------------------------------------------------
# Weight-norm folding (for the S1-DAC conv stack)
# ---------------------------------------------------------------------------


def fold_weight_norm(state: State) -> Dict[str, np.ndarray]:
    """Fold torch weight-norm parametrizations into plain weights (numpy).

    torch stores `<mod>.parametrizations.weight.original0` (g) and
    `...original1` (v); the effective weight is g * v / ||v|| with the norm
    over all dims except dim 0, computed in float64 and cast back to g's
    dtype. Returns a new dict with `<mod>.weight` entries and the
    parametrization keys removed; entries already in plain form pass
    through."""
    out: Dict[str, np.ndarray] = {}
    for k in state:
        if ".parametrizations.weight.original0" in k:
            base = k.replace(".parametrizations.weight.original0", "")
            val = np.asarray(state[k])
            g = val.astype(np.float64)
            v = np.asarray(state[base + ".parametrizations.weight.original1"]).astype(np.float64)
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
            out[base + ".weight"] = (g * v / norm).astype(val.dtype)
        elif ".parametrizations.weight.original1" in k:
            continue
        else:
            out[k] = state[k]
    return out


# ---------------------------------------------------------------------------
# S1-DAC conversion (weight norm already folded)
# ---------------------------------------------------------------------------


def _conv(state: State, name: str) -> dict:
    p = {"w": state[f"{name}.weight"]}
    if f"{name}.bias" in state:
        p["b"] = state[f"{name}.bias"]
    return p


def _cconv(state: State, name: str) -> dict:
    """CausalConvNet/CausalTransConvNet wrap their conv as `.conv`."""
    return _conv(state, f"{name}.conv")


def _convnext(state: State, name: str) -> dict:
    return {
        "dwconv": _cconv(state, f"{name}.dwconv"),
        "norm": {"w": state[f"{name}.norm.weight"], "b": state[f"{name}.norm.bias"]},
        "pwconv1": {"w": _t(state[f"{name}.pwconv1.weight"]),
                    "b": state[f"{name}.pwconv1.bias"]},
        "pwconv2": {"w": _t(state[f"{name}.pwconv2.weight"]),
                    "b": state[f"{name}.pwconv2.bias"]},
        "gamma": state[f"{name}.gamma"],
    }


def _vq(state: State, name: str) -> dict:
    return {
        "in_proj": _conv(state, f"{name}.in_proj"),
        "out_proj": _conv(state, f"{name}.out_proj"),
        "codebook": state[f"{name}.codebook.weight"],
    }


def _transformer(state: State, name: str, n_layers: int) -> dict:
    layers = []
    for i in range(n_layers):
        pre = f"{name}.layers.{i}"
        layers.append({
            "attention": {
                "wqkv": {"w": _t(state[f"{pre}.attention.wqkv.weight"])},
                "wo": {"w": _t(state[f"{pre}.attention.wo.weight"])},
            },
            "feed_forward": {k: {"w": _t(state[f"{pre}.feed_forward.{k}.weight"])}
                             for k in ("w1", "w2", "w3")},
            "attention_norm": {"w": state[f"{pre}.attention_norm.weight"]},
            "ffn_norm": {"w": state[f"{pre}.ffn_norm.weight"]},
            "attention_layer_scale": state[f"{pre}.attention_layer_scale.gamma"],
            "ffn_layer_scale": state[f"{pre}.ffn_layer_scale.gamma"],
        })
    return {"layers": layers, "norm": {"w": state[f"{name}.norm.weight"]}}


def _residual_unit_p(state: State, name: str) -> dict:
    return {
        "snake1": state[f"{name}.block.0.alpha"],
        "conv1": _cconv(state, f"{name}.block.1"),
        "snake2": state[f"{name}.block.2.alpha"],
        "conv2": _cconv(state, f"{name}.block.3"),
    }


def convert_ae_state(state: State, cfg: AEConfig) -> dict:
    """Reference DAC (causal build, weight norm already folded by
    `fold_weight_norm`) -> the JAX-layout S1-DAC tree."""
    n_enc = len(cfg.encoder_rates)
    enc_blocks = []
    for i in range(n_enc):
        base = f"encoder.block.{1 + i}.block"
        blk = {
            "res_units": [_residual_unit_p(state, f"{base}.{j}") for j in range(3)],
            "snake": state[f"{base}.3.alpha"],
            "down": _cconv(state, f"{base}.4"),
        }
        n_t = cfg.encoder_transformer_layers[i]
        if n_t > 0:
            blk["transformer"] = _transformer(state, f"{base}.5", n_t)
        enc_blocks.append(blk)

    n_dec = len(cfg.decoder_rates)
    dec_blocks = []
    for i in range(n_dec):
        base = f"decoder.model.{1 + i}.block"
        dec_blocks.append({
            "snake": state[f"{base}.0.alpha"],
            "up": _cconv(state, f"{base}.1"),
            "res_units": [_residual_unit_p(state, f"{base}.{2 + j}") for j in range(3)],
        })

    q = "quantizer"
    n_ds = len(cfg.downsample_factor)
    return {
        "encoder": {
            "stem": _cconv(state, "encoder.block.0"),
            "blocks": enc_blocks,
            "head_snake": state[f"encoder.block.{1 + n_enc}.alpha"],
            "head": _cconv(state, f"encoder.block.{2 + n_enc}"),
        },
        "decoder": {
            "stem": _cconv(state, "decoder.model.0"),
            "blocks": dec_blocks,
            "head_snake": state[f"decoder.model.{1 + n_dec}.alpha"],
            "head": _cconv(state, f"decoder.model.{2 + n_dec}"),
        },
        "quantizer": {
            "semantic": [_vq(state, f"{q}.semantic_quantizer.quantizers.0")],
            "residual": [_vq(state, f"{q}.quantizer.quantizers.{i}")
                         for i in range(cfg.n_codebooks)],
            "downsample": [{"conv": _cconv(state, f"{q}.downsample.{i}.0"),
                            "convnext": _convnext(state, f"{q}.downsample.{i}.1")}
                           for i in range(n_ds)],
            "upsample": [{"conv": _cconv(state, f"{q}.upsample.{i}.0"),
                          "convnext": _convnext(state, f"{q}.upsample.{i}.1")}
                         for i in range(n_ds)],
            "pre_module": _transformer(state, f"{q}.pre_module", cfg.q_n_layer),
            "post_module": _transformer(state, f"{q}.post_module", cfg.q_n_layer),
        },
    }


def torch_state_to_numpy(module_or_state) -> Dict[str, np.ndarray]:
    """A torch nn.Module or state dict -> {name: float32 numpy array}."""
    sd = module_or_state.state_dict() if hasattr(module_or_state, "state_dict") \
        else module_or_state
    return {k: v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in sd.items()}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a safetensors file into numpy, BF16 upcast to float32 (the
    port's own reader, `checkpoints/safetensors.py`)."""
    from echo_tts_tpu_torch.checkpoints.safetensors import load_numpy

    return load_numpy(path)
