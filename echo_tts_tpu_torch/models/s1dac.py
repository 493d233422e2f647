"""Fish S1-DAC audio codec (counterpart of echo_tts_tpu/models/s1dac.py):
encode to codes / z_q, decode z_q, and the streaming decodes (a chunk at a
time from carried per-stage state, or re-decoded from its receptive field).

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
from echo_tts_tpu_torch.core.rope import per_row, rope_rows
from echo_tts_tpu_torch.ops.res_chain import (
    causal_conv_shifted_cl,
    chain_ctx,
    res_units_cl,
    sin2_poly,
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
    """Adjacent-pair rotation in fp32; tables (S, D/2), or (B, S, D/2) with
    one position a row (a continuous group's rows at their own offsets)."""
    dtype = x.dtype
    xf = x.float()
    xr, xi = xf[..., 0::2], xf[..., 1::2]
    if cos.dim() == 2:
        c, s = cos[:, None, :], sin[:, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
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


def vq_decode_latents(z_e: torch.Tensor, q: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest code for already-projected codebook latents (B, Dc, T), with
    no in_proj. Returns (z_p (B, Dc, T) the embedded codes, indices (B, T)
    int32)."""
    enc = _l2_normalize(z_e.transpose(1, 2))
    cb = _l2_normalize(q["codebook"])
    idx = torch.einsum("btd,kd->btk", enc.float(), cb.float()).argmax(dim=-1).to(torch.int32)
    return q["codebook"][idx.long()].transpose(1, 2), idx


def rvq_from_latents(latents: torch.Tensor, quantizers: list
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode from concatenated projected latents (B, sum(Dc), T), the
    reference's third RVQ decode path: each codebook's channel slice is
    quantized to its nearest code (no in_proj) and out_proj'd into the
    running sum. Channels beyond the last whole codebook slice are ignored.
    Returns (z_q (B, D, T), z_p (B, sum(Dc), T), codes (B, N, T))."""
    dims = [0]
    for q in quantizers:
        dims.append(dims[-1] + q["codebook"].shape[1])
    n_codebooks = max(i for i in range(len(dims)) if dims[i] <= latents.shape[1])
    z_q = None
    z_ps, codes = [], []
    for i in range(n_codebooks):
        z_p_i, idx = vq_decode_latents(latents[:, dims[i]:dims[i + 1]], quantizers[i])
        z_ps.append(z_p_i)
        codes.append(idx)
        z_q_i = conv1d(z_p_i, quantizers[i]["out_proj"]["w"], quantizers[i]["out_proj"]["b"])
        z_q = z_q_i if z_q is None else z_q + z_q_i
    return z_q, torch.cat(z_ps, dim=1), torch.stack(codes, dim=1)


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


def decode_codes(params: dict, cfg: AEConfig, codes: torch.Tensor) -> torch.Tensor:
    """The whole codec decode: code indices (B, 1+n_codebooks, T) ->
    waveform, through `decode_zq` (K2 on the card)."""
    return decode_zq(params, cfg, codes_to_zq(params, cfg, codes))


def get_output_length(cfg: AEConfig, input_length: int) -> int:
    """Encoder frames for `input_length` samples, before the quantizer's
    downsample."""
    length = input_length
    for stride in cfg.encoder_rates:
        length = -(-length // stride)
    return length


def get_delay(cfg: AEConfig) -> int:
    """The codec's analytic latency in samples: the reference's walk over
    the (kernel, stride, dilation) of every conv, in module order (encoder,
    quantizer, decoder), taken in reverse."""
    layers = []

    def conv(k, s=1, d=1):
        layers.append(("conv", k, s, d))

    def tconv(k, s):
        layers.append(("tconv", k, s, 1))

    conv(7)  # encoder stem
    for stride in cfg.encoder_rates:
        for dil in (1, 3, 9):
            conv(7, 1, dil)
            conv(1)
        conv(2 * stride, stride)
    conv(3)  # encoder head
    # quantizer convs, in registration order: semantic VQ, residual VQs,
    # downsample, upsample
    conv(1)  # semantic in_proj
    conv(1)  # semantic out_proj
    for _ in range(cfg.n_codebooks):
        conv(1)
        conv(1)
    for f in cfg.downsample_factor:
        conv(f, f)
        conv(7)  # convnext dwconv
    for f in reversed(cfg.downsample_factor):
        tconv(f, f)
        conv(7)  # convnext dwconv
    conv(7)  # decoder stem
    for stride in cfg.decoder_rates:
        tconv(2 * stride, stride)
        for dil in (1, 3, 9):
            conv(7, 1, dil)
            conv(1)
    conv(7)  # decoder head

    l_out = get_output_length(cfg, 0)
    length = l_out
    for kind, k, s, d in reversed(layers):
        if kind == "tconv":
            length = (length - d * (k - 1) - 1) / s + 1
        else:
            length = (length - 1) * s + d * (k - 1) + 1
        length = math.ceil(length)
    return (length - l_out) // 2


# ---------------------------------------------------------------------------
# Streaming decode
# ---------------------------------------------------------------------------


def decode_receptive_frames(cfg: AEConfig) -> int:
    """Left context (z_q frames) of the decode: q_n_layer window-limited
    attention layers of (window - 1) frames each, plus < 64 frames of conv
    tail."""
    return cfg.q_n_layer * (cfg.q_window_size - 1) + 64


def decode_zq_window(params: dict, cfg: AEConfig, z_q: torch.Tensor, start: int, end: int,
                     context_frames: Optional[int] = None) -> torch.Tensor:
    """Frames [start, end) of z_q (B, D, T >= end), decoded from enough left
    context to equal the whole decode: (B, 1, (end - start)·frame_length)."""
    if context_frames is None:
        context_frames = decode_receptive_frames(cfg)
    audio = decode_zq(params, cfg, z_q[:, :, max(0, start - context_frames):end])
    return audio[:, :, -(end - start) * cfg.frame_length:]


def decode_zq_streaming(params: dict, cfg: AEConfig, z_q: torch.Tensor,
                        chunk_frames: int = 64, context_frames: Optional[int] = None):
    """Yields the audio of z_q in chunks of `chunk_frames` frames, each
    re-decoded from its receptive field (`decode_zq_window`)."""
    for start in range(0, z_q.shape[-1], chunk_frames):
        yield decode_zq_window(params, cfg, z_q, start, min(start + chunk_frames, z_q.shape[-1]),
                               context_frames)


# The stateful decode carries, between chunks: each post_module layer's last
# (window - 1) keys and values, and the input tail of every conv stage, each
# as long as that stage reaches back. Zero tails stand for each stage's causal
# left pad at the stream start. A residual-unit chain carries `chain_ctx`
# rows of its input and runs on [tail | chunk]; while part of the tail still
# stands for the pad (pad_rows = clip(ctx - pos·rate, 0, ctx) rows), kernel K2
# re-zeroes those rows after every unit (`zero_below`), as each conv's own
# input is zero-padded in the full decode. Each chunk's audio equals the same
# slice of `decode_zq`, at O(chunk) cost.


def _conv_stream_cl(x_cl, tail_cl, w, b, *, kernel_size: int, dilation: int = 1):
    """Stride-1 causal conv on [tail | x], channels-last, cropped to x's
    rows; returns (y, the new tail of (k - 1)·dilation input rows)."""
    ctx = (kernel_size - 1) * dilation
    xw = torch.cat([tail_cl, x_cl], dim=1)
    y = causal_conv_shifted_cl(xw, w, b, kernel_size=kernel_size, dilation=dilation)
    return y[:, ctx:], xw[:, -ctx:].clone()


def _tconv_stream_cl(x_cl, tail_cl, w, b, *, kernel_size: int, stride: int):
    """Causal transposed conv on [tail | x], channels-last: output rows
    [j·s, (j + 1)·s) read inputs j - m .. j with m = ceil(k/s) - 1, the
    tail's length."""
    ctx = -(-kernel_size // stride) - 1
    if ctx == 0:
        return _causal_tconv_phase_cl(x_cl, w, b, kernel_size=kernel_size, stride=stride), tail_cl
    xw = torch.cat([tail_cl, x_cl], dim=1)
    y = _causal_tconv_phase_cl(xw, w, b, kernel_size=kernel_size, stride=stride)
    return y[:, ctx * stride:], xw[:, -ctx:].clone()


def _res_chain_stream_cl(x_cl, tail_cl, units, dilations, pad_rows):
    """The residual-unit chain on [tail | x] (kernel K2 on the card), its
    first `pad_rows` rows (an int, or (B,) one a row) re-zeroed after every
    unit; returns (y, the new tail)."""
    ctx = tail_cl.shape[1]
    xw = torch.cat([tail_cl, x_cl], dim=1)
    y = res_units_cl(xw, units, dilations, zero_below=pad_rows)
    return y[:, ctx:], xw[:, -ctx:].clone()


def _window_transformer_stream(x, p: dict, kv: list, pos0, *, n_head: int,
                               head_dim: int, window: int, norm_eps: float = 1e-5,
                               max_positions: int = 1024):
    """One step of the window-limited transformer on x (B, C, S) at frame
    offset pos0: an int, or a (B,) tensor with each row's own offset. kv:
    per layer {"k", "v"} (B, window - 1, H, Dh), the previous window - 1
    positions (zeros before the start, masked). Returns (y (B, C, S), new
    kv). RoPE from the `max_positions` table."""
    x = x.transpose(1, 2)
    b, s, _ = x.shape
    n_cache = window - 1
    tabs = _ae_rope_tables(max_positions, head_dim, device=x.device)
    # kv slot j holds position pos0 - n_cache + j; query i sits at pos0 + i
    i = torch.arange(s, device=x.device)[:, None]
    j = torch.arange(n_cache + s, device=x.device)[None, :]
    if per_row(pos0):
        cos, sin = rope_rows(*tabs, pos0.long()[:, None] + torch.arange(s, device=x.device))
        mask = ((j >= i) & (j <= i + n_cache))[None] & (j[None] >= n_cache - pos0[:, None, None])
        mask = mask[:, None]  # (B, 1, s, t)
    else:
        cos, sin = (tab[pos0:pos0 + s] for tab in tabs)
        mask = ((j >= i) & (j <= i + n_cache) & (j >= n_cache - pos0))[None, None]
    scale = 1.0 / math.sqrt(head_dim)
    new_kv = []
    for layer, lkv in zip(p["layers"], kv):
        h = _ae_rms_norm(x, layer["attention_norm"]["w"], norm_eps)
        q, k, v = torch.chunk(h @ layer["attention"]["wqkv"]["w"], 3, dim=-1)
        q = _ae_apply_rope(q.reshape(b, s, n_head, head_dim), cos, sin)
        k = _ae_apply_rope(k.reshape(b, s, n_head, head_dim), cos, sin)
        kc = torch.cat([lkv["k"], k.to(lkv["k"].dtype)], dim=1)
        vc = torch.cat([lkv["v"], v.reshape(b, s, n_head, head_dim).to(lkv["v"].dtype)], dim=1)
        new_kv.append({"k": kc[:, -n_cache:].clone(), "v": vc[:, -n_cache:].clone()})
        logits = torch.einsum("bshd,bthd->bhst", q.float(), kc.float()) * scale
        w_ = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1).to(v.dtype)
        o = torch.einsum("bhst,bthd->bshd", w_.float(), vc.float()).to(v.dtype)
        x = x + layer["attention_layer_scale"] * (
            o.reshape(b, s, n_head * head_dim) @ layer["attention"]["wo"]["w"])
        h = _ae_rms_norm(x, layer["ffn_norm"]["w"], norm_eps)
        ff = layer["feed_forward"]
        x = x + layer["ffn_layer_scale"] * (
            (F.silu(h @ ff["w1"]["w"]) * (h @ ff["w3"]["w"])) @ ff["w2"]["w"])
    return _ae_rms_norm(x, p["norm"]["w"], norm_eps).transpose(1, 2), new_kv


def streaming_decode_init(params: dict, cfg: AEConfig, batch: int,
                          dtype: Optional[torch.dtype] = None,
                          per_row_pos: bool = False) -> dict:
    """Zero state for `decode_zq_stream_step` on the params' device, in the
    params' dtype unless `dtype` is given. The stream position is one int
    for every row, or with `per_row_pos` a (B,) int32 tensor on the device:
    each row of the batch is then a stream at its own position (the
    continuous group's form)."""
    dtype = dtype or params_dtype(params)
    dev = params["decoder"]["stem"]["w"].device

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    n_cache = cfg.q_window_size - 1
    blocks, ch = [], cfg.decoder_dim
    for blk in params["decoder"]["blocks"]:
        out_ch = blk["up"]["w"].shape[1]
        blocks.append({"tconv": z(batch, 1, ch), "chain": z(batch, chain_ctx(), out_ch)})
        ch = out_ch
    return {"pos": torch.zeros(batch, dtype=torch.int32, device=dev) if per_row_pos else 0,
            "kv": [{"k": z(batch, n_cache, cfg.q_n_head, cfg.q_head_dim),
                    "v": z(batch, n_cache, cfg.q_n_head, cfg.q_head_dim)}
                   for _ in range(cfg.q_n_layer)],
            "up": [z(batch, cfg.latent_dim, 6) for _ in cfg.downsample_factor],  # (B, C, 6)
            "stem": z(batch, 6, cfg.latent_dim),  # channels-last from here on
            "blocks": blocks,
            "head": z(batch, 6, ch)}


def decode_zq_stream_step(params: dict, cfg: AEConfig, state: dict, z_chunk: torch.Tensor,
                          max_positions: int = 1024):
    """One streaming decode step: z_chunk (B, D, S) holds frames [pos,
    pos + S) (each row's own pos when the state has one a row). Returns
    (audio (B, 1, S·frame_length), the new state); the audio equals that
    slice of `decode_zq`."""
    pos = state["pos"]
    y, kv = _window_transformer_stream(
        z_chunk, params["quantizer"]["post_module"], state["kv"], pos, n_head=cfg.q_n_head,
        head_dim=cfg.q_head_dim, window=cfg.q_window_size, norm_eps=cfg.norm_eps,
        max_positions=max_positions)

    up_tails = []
    for i, factor in enumerate(reversed(cfg.downsample_factor)):
        st = params["quantizer"]["upsample"][i]
        y = causal_tconv(y, st["conv"], kernel_size=factor, stride=factor)
        # the tconv has k == s; the ConvNeXt depthwise k=7 conv carries 6 frames
        yw = torch.cat([state["up"][i], y], dim=-1)
        up_tails.append(yw[..., -6:].clone())
        y = convnext_block(yw, st["convnext"])[..., 6:]

    dec = params["decoder"]
    x, stem_tail = _conv_stream_cl(y.transpose(1, 2), state["stem"], dec["stem"]["w"],
                                   dec["stem"].get("b"), kernel_size=7)
    rate = math.prod(cfg.downsample_factor)
    block_tails = []
    for i, stride in enumerate(cfg.decoder_rates):
        blk, st = dec["blocks"][i], state["blocks"][i]
        rate *= stride  # chain i runs at `rate` rows a z_q frame
        x = snake_cl(x, blk["snake"].reshape(-1))
        x, t_tail = _tconv_stream_cl(x, st["tconv"], blk["up"]["w"], blk["up"].get("b"),
                                     kernel_size=2 * stride, stride=stride)
        ctx = st["chain"].shape[1]
        pad_rows = ((ctx - pos * rate).clamp(0, ctx).to(torch.int32) if per_row(pos)
                    else min(max(ctx - pos * rate, 0), ctx))
        x, c_tail = _res_chain_stream_cl(x, st["chain"], blk["res_units"], (1, 3, 9), pad_rows)
        block_tails.append({"tconv": t_tail, "chain": c_tail})
    x = snake_cl(x, dec["head_snake"].reshape(-1))
    x, head_tail = _conv_stream_cl(x, state["head"], dec["head"]["w"], dec["head"].get("b"),
                                   kernel_size=7)
    new_state = {"pos": pos + z_chunk.shape[-1], "kv": kv, "up": up_tails, "stem": stem_tail,
                 "blocks": block_tails, "head": head_tail}
    return torch.tanh(x).transpose(1, 2), new_state


def decode_zq_streaming_stateful(params: dict, cfg: AEConfig, z_q: torch.Tensor,
                                 chunk_frames: int = 64, max_positions: Optional[int] = None):
    """Yields the audio of z_q (B, D, T) in chunks of up to `chunk_frames`
    frames through the carried state; the last partial chunk is padded on
    the right with zero frames (future context: causality keeps the kept
    samples exact) and cropped."""
    b, _, t = z_q.shape
    if max_positions is None:
        max_positions = max(1024, t)
    state = streaming_decode_init(params, cfg, b, dtype=z_q.dtype)
    spl = cfg.frame_length
    for start in range(0, t, chunk_frames):
        n = min(chunk_frames, t - start)
        chunk = z_q[:, :, start:start + n]
        if n < chunk_frames:
            chunk = F.pad(chunk, (0, chunk_frames - n))
        audio, state = decode_zq_stream_step(params, cfg, state, chunk, max_positions)
        yield audio[:, :, :n * spl]
