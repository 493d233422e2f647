"""Fish S1-DAC audio codec (counterpart of echo_tts_tpu/models/s1dac.py),
the parts the one-shot path runs: encode to codes / z_q, decode z_q.

Parameters are the JAX package's pytree as nested dicts and lists of
tensors, with torch-layout conv weights (O, I, K) and transposed-conv
weights (I, O, K). Time-domain tensors are channels-first (B, C, T) at the
public functions. Every residual-unit chain runs channels-last through
kernel K2 (`ops/res_chain.py:res_units_cl`), as the JAX package's Pallas
route does, and the whole decoder runs channels-last. Plain convs that the
JAX package leaves to XLA use `torch.nn.functional.conv1d` or matmuls.

Quirk kept from the JAX package: the decoder blocks have no transformer
layers; only the encoder's last block and the quantizer pre/post modules do.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from echo_tts_tpu_torch.core.config import AEConfig
from echo_tts_tpu_torch.ops.res_chain import (
    sin2_poly,
    causal_conv_shifted_cl,
    res_units_cl,
    snake_cl,
)

# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def params_dtype(params: dict) -> torch.dtype:
    return params["decoder"]["stem"]["w"].dtype


def conv1d(x, w, b=None, *, stride=1, dilation=1, groups=1, pad=(0, 0)):
    """torch Conv1d on (B, C, T) with an explicit (left, right) zero pad;
    w: (out, in/groups, k)."""
    if pad != (0, 0):
        x = F.pad(x, pad)
    return F.conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)


def get_extra_padding_for_conv1d(length: int, kernel_size: int, stride: int,
                                 padding_total: int) -> int:
    """Right pad so striding covers the whole length."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return ideal_length - length


def causal_conv(x, p: dict, *, kernel_size: int, stride=1, dilation=1, groups=1):
    """Causal conv: left pad k_eff - stride, plus the extra right pad."""
    k_eff = (kernel_size - 1) * dilation + 1
    pad = k_eff - stride
    extra = get_extra_padding_for_conv1d(x.shape[-1], k_eff, stride, pad)
    return conv1d(x, p["w"], p.get("b"), stride=stride, dilation=dilation,
                  groups=groups, pad=(pad, extra))


def causal_tconv(x, p: dict, *, kernel_size: int, stride=1):
    """Causal transposed conv, then the right unpad k - s."""
    out = F.conv_transpose1d(x, p["w"], p.get("b"), stride=stride)
    pad = kernel_size - stride
    return out[..., :-pad] if pad > 0 else out


def snake(x, alpha):
    """x + sin²(αx)/(α+1e-9) with per-channel α (1, C, 1), channels-first;
    the polynomial sin² in fp32, the result in x's dtype."""
    xf = x.float()
    af = alpha.float()
    return (xf + (1.0 / (af + 1e-9)) * sin2_poly(af * xf)).to(x.dtype)


def _layer_norm(x, w, b, eps=1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def convnext_block(x, p: dict, *, kernel_size=7, dilation=1):
    """Depthwise causal conv -> LayerNorm -> pointwise MLP (exact GELU) ->
    layer scale, residual."""
    dim = x.shape[1]
    inp = x
    x = causal_conv(x, p["dwconv"], kernel_size=kernel_size, dilation=dilation, groups=dim)
    x = x.transpose(1, 2)
    x = _layer_norm(x, p["norm"]["w"], p["norm"]["b"], eps=1e-6)
    x = x @ p["pwconv1"]["w"] + p["pwconv1"]["b"]
    x = F.gelu(x)
    x = x @ p["pwconv2"]["w"] + p["pwconv2"]["b"]
    x = p["gamma"] * x
    return inp + x.transpose(1, 2)


# ---------------------------------------------------------------------------
# Quantizer-internal transformer
# ---------------------------------------------------------------------------


def _ae_rope_tables(seq_len: int, head_dim: int, base: float = 10000.0, device=None):
    """The AE's RoPE tables are rounded to bf16 and upcast again."""
    freqs = 1.0 / (base ** (np.arange(0, head_dim, 2)[: head_dim // 2].astype(np.float64) / head_dim))
    angles = np.outer(np.arange(seq_len, dtype=np.float64), freqs)

    def table(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device).to(torch.bfloat16).float()

    return table(np.cos(angles)), table(np.sin(angles))


def _ae_apply_rope(x, cos, sin):
    """Adjacent-pair rotation in fp32; tables (S, D/2)."""
    dtype = x.dtype
    xf = x.float()
    xr, xi = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([xr * c - xi * s, xi * c + xr * s], dim=-1).reshape(x.shape).to(dtype)


def _ae_rms_norm(x, w, eps=1e-5):
    """The AE RMSNorm casts back to x's dtype before the weight multiply."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return xf.to(x.dtype) * w


def window_transformer(x, p: dict, *, n_head: int, head_dim: int,
                       window_size: Optional[int], norm_eps: float = 1e-5):
    """Causal window-limited transformer, channels-first I/O. x: (B, C, T)."""
    x = x.transpose(1, 2)
    b, s, _ = x.shape
    cos, sin = _ae_rope_tables(s, head_dim, device=x.device)
    rows = torch.arange(s, device=x.device)[:, None]
    cols = torch.arange(s, device=x.device)[None, :]
    mask = cols <= rows
    if window_size is not None:
        mask = mask & (cols >= (rows - window_size + 1).clamp_min(0))
    scale = 1.0 / math.sqrt(head_dim)
    for layer in p["layers"]:
        h = _ae_rms_norm(x, layer["attention_norm"]["w"], norm_eps)
        q, k, v = torch.chunk(h @ layer["attention"]["wqkv"]["w"], 3, dim=-1)
        q = _ae_apply_rope(q.reshape(b, s, n_head, head_dim), cos, sin)
        k = _ae_apply_rope(k.reshape(b, s, n_head, head_dim), cos, sin)
        v = v.reshape(b, s, n_head, head_dim)
        logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
        logits = logits.masked_fill(~mask[None, None], -1e30)
        w_ = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bhst,bthd->bshd", w_.float(), v.float()).to(v.dtype)
        o = o.reshape(b, s, n_head * head_dim) @ layer["attention"]["wo"]["w"]
        x = x + layer["attention_layer_scale"] * o
        h = _ae_rms_norm(x, layer["ffn_norm"]["w"], norm_eps)
        ff = layer["feed_forward"]
        h = (F.silu(h @ ff["w1"]["w"]) * (h @ ff["w3"]["w"])) @ ff["w2"]["w"]
        x = x + layer["ffn_layer_scale"] * h
    x = _ae_rms_norm(x, p["norm"]["w"], norm_eps)
    return x.transpose(1, 2)


# ---------------------------------------------------------------------------
# Vector quantization
# ---------------------------------------------------------------------------


def _l2_normalize(x):
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-24)


def vq_similarity(z: torch.Tensor, q: dict) -> torch.Tensor:
    """Cosine similarity (B, T, K) of in_proj(z) to every code."""
    enc = _l2_normalize(conv1d(z, q["in_proj"]["w"], q["in_proj"]["b"]).transpose(1, 2))
    cb = _l2_normalize(q["codebook"])
    return torch.einsum("btd,kd->btk", enc.float(), cb.float())


def vq_encode_indices(z: torch.Tensor, q: dict) -> torch.Tensor:
    """Nearest L2-normalized code. z: (B, D, T) -> indices (B, T) int32."""
    return vq_similarity(z, q).argmax(dim=-1).to(torch.int32)


def vq_decode_from_indices(indices: torch.Tensor, q: dict) -> torch.Tensor:
    """codes (B, T) -> out_proj(codebook[codes]) (B, D, T)."""
    z_p = q["codebook"][indices.long()]
    return conv1d(z_p.transpose(1, 2), q["out_proj"]["w"], q["out_proj"]["b"])


def rvq_encode(z: torch.Tensor, quantizers: list) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual VQ stack. Returns (codes (B, N, T), z_q (B, D, T))."""
    residual = z
    z_q = torch.zeros_like(z)
    codes = []
    for q in quantizers:
        idx = vq_encode_indices(residual, q)
        z_q_i = vq_decode_from_indices(idx, q)
        residual = residual - z_q_i
        z_q = z_q + z_q_i
        codes.append(idx)
    return torch.stack(codes, dim=1), z_q


def rvq_decode(codes: torch.Tensor, quantizers: list) -> torch.Tensor:
    """codes (B, N, T) -> (B, D, T)."""
    z_q = None
    for i, q in enumerate(quantizers):
        z_q_i = vq_decode_from_indices(codes[:, i], q)
        z_q = z_q_i if z_q is None else z_q + z_q_i
    return z_q


# ---------------------------------------------------------------------------
# Encoder / decoder stacks
# ---------------------------------------------------------------------------


def _causal_tconv_phase_cl(x_cl, w, b, *, kernel_size: int, stride: int):
    """Causal transposed conv as ceil(k/s) phase-grouped matmuls,
    channels-last, with the causal right unpad: output length T*s.
    w: (I, O, K) torch layout."""
    t_in, i_ch = x_cl.shape[1], x_cl.shape[2]
    o_ch = w.shape[1]
    s = stride
    m_taps = -(-kernel_size // s)
    k_pad = m_taps * s
    if k_pad != kernel_size:
        w = F.pad(w, (0, k_pad - kernel_size))
    w2 = w.reshape(i_ch, o_ch, m_taps, s)
    out = None
    for m in range(m_taps):
        wm = w2[:, :, m, :].permute(0, 2, 1).reshape(i_ch, s * o_ch)
        xm = x_cl if m == 0 else F.pad(x_cl, (0, 0, m, 0))[:, :t_in]
        o = xm @ wm
        out = o if out is None else out + o
    y = out.reshape(x_cl.shape[0], t_in * s, o_ch)
    return y + b if b is not None else y


def encoder_forward(params: dict, cfg: AEConfig, audio: torch.Tensor) -> torch.Tensor:
    """Audio (B, 1, T) -> latents (B, latent_dim, T/hop)."""
    p = params["encoder"]
    x = causal_conv(audio, p["stem"], kernel_size=7)
    d_model = cfg.encoder_dim
    for i, (stride, n_t) in enumerate(zip(cfg.encoder_rates, cfg.encoder_transformer_layers)):
        d_model *= 2
        blk = p["blocks"][i]
        x = res_units_cl(x.transpose(1, 2).contiguous(), blk["res_units"]).transpose(1, 2)
        x = snake(x, blk["snake"])
        x = causal_conv(x, blk["down"], kernel_size=2 * stride, stride=stride)
        if n_t > 0:
            x = window_transformer(x, blk["transformer"], n_head=d_model // 64,
                                   head_dim=64, window_size=cfg.enc_window_size)
    x = snake(x, p["head_snake"])
    return causal_conv(x, p["head"], kernel_size=3)


def decoder_forward(params: dict, cfg: AEConfig, z: torch.Tensor) -> torch.Tensor:
    """Latents (B, latent_dim, T) -> waveform (B, 1, T*hop), channels-last
    after the stem."""
    p = params["decoder"]
    x = causal_conv(z, p["stem"], kernel_size=7).transpose(1, 2)
    for i, stride in enumerate(cfg.decoder_rates):
        blk = p["blocks"][i]
        x = snake_cl(x, blk["snake"].reshape(-1))
        x = _causal_tconv_phase_cl(x, blk["up"]["w"], blk["up"].get("b"),
                                   kernel_size=2 * stride, stride=stride)
        x = res_units_cl(x.contiguous(), blk["res_units"])
    x = snake_cl(x, p["head_snake"].reshape(-1))
    x = causal_conv_shifted_cl(x, p["head"]["w"], p["head"].get("b"),
                               kernel_size=7, dilation=1)
    return torch.tanh(x).transpose(1, 2)


# ---------------------------------------------------------------------------
# Quantizer top and DAC entry points
# ---------------------------------------------------------------------------


def _downsample(params, cfg: AEConfig, z):
    for i, factor in enumerate(cfg.downsample_factor):
        st = params["quantizer"]["downsample"][i]
        z = causal_conv(z, st["conv"], kernel_size=factor, stride=factor)
        z = convnext_block(z, st["convnext"])
    return z


def quantizer_upsample(params, cfg: AEConfig, z):
    for i, factor in enumerate(reversed(cfg.downsample_factor)):
        st = params["quantizer"]["upsample"][i]
        z = causal_tconv(z, st["conv"], kernel_size=factor, stride=factor)
        z = convnext_block(z, st["convnext"])
    return z


def quantizer_transformer(params, cfg: AEConfig, which: str, z):
    return window_transformer(z, params["quantizer"][which], n_head=cfg.q_n_head,
                              head_dim=cfg.q_head_dim, window_size=cfg.q_window_size,
                              norm_eps=cfg.norm_eps)


def encode_latents(params: dict, cfg: AEConfig, audio: torch.Tensor) -> torch.Tensor:
    """Audio (B, 1, T) -> pre-quantizer latents (B, latent_dim, T/frame):
    right pad to a frame multiple, cast to the params' dtype, encoder,
    downsample, pre-module transformer."""
    right_pad = -audio.shape[-1] % cfg.frame_length
    if right_pad:
        audio = F.pad(audio, (0, right_pad))
    z = encoder_forward(params, cfg, audio.to(params_dtype(params)))
    z = _downsample(params, cfg, z)
    return quantizer_transformer(params, cfg, "pre_module", z)


def encode_codes(params: dict, cfg: AEConfig, audio: torch.Tensor) -> torch.Tensor:
    """Audio (B, 1, T) -> code indices (B, 1+n_codebooks, T/frame)."""
    z = encode_latents(params, cfg, audio)
    sem_codes, sem_zq = rvq_encode(z, params["quantizer"]["semantic"])
    res_codes, _ = rvq_encode(z - sem_zq, params["quantizer"]["residual"])
    return torch.cat([sem_codes, res_codes], dim=1)


def codes_to_zq(params: dict, cfg: AEConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes -> summed semantic+residual z_q, before post/upsample."""
    zq_sem = rvq_decode(codes[:, :1], params["quantizer"]["semantic"])
    zq_res = rvq_decode(codes[:, 1:], params["quantizer"]["residual"])
    return zq_sem + zq_res


def encode_zq(params: dict, cfg: AEConfig, audio: torch.Tensor) -> torch.Tensor:
    return codes_to_zq(params, cfg, encode_codes(params, cfg, audio))


def decode_zq(params: dict, cfg: AEConfig, z_q: torch.Tensor) -> torch.Tensor:
    """z_q (B, latent_dim, T) -> waveform: post_module -> upsample -> decoder."""
    z = quantizer_transformer(params, cfg, "post_module", z_q)
    z = quantizer_upsample(params, cfg, z)
    return decoder_forward(params, cfg, z)
