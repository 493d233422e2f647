"""Plain Fish S1-DAC in float32 (`jordand/fish-s1-dac-min`): encoder,
residual VQ, the windowed pre/post transformers, ConvNeXt down/upsampling,
decoder; plus the 80-d PCA projection of Echo-TTS.

Torch-layout convs (O, I, K), transposed convs (I, O, K), channels-first
(B, C, T). Every conv is causal (left pad k_eff - stride). The snake is
x + sin²(αx)/(α + 1e-9) with torch.sin. The transformers' RoPE tables are
stored in bfloat16 by the published model, so they are rounded to it here
too (a table of the model, not arithmetic).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .dit import Prec


def frame_length(cfg: dict) -> int:
    """Audio samples a latent frame: the encoder's strides times the
    quantizer's downsampling (2048)."""
    return math.prod(cfg["encoder_rates"]) * math.prod(cfg["downsample_factor"])


def causal_conv(x, p, k: int, stride: int = 1, dilation: int = 1, groups: int = 1,
                P: Prec = None):
    k_eff = (k - 1) * dilation + 1
    pad = k_eff - stride
    length = x.shape[-1]
    n_frames = (length - k_eff + pad) / stride + 1
    extra = (math.ceil(n_frames) - 1) * stride + (k_eff - pad) - length
    x = F.pad(x, (pad, extra))
    w = p["w"].float()
    if P is not None and P.mode == "fp8" and groups == 1:
        from .dit import fp8_round
        x, w = fp8_round(x, 1), fp8_round(w, 1)
    b = p.get("b")
    return F.conv1d(x, w, None if b is None else b.float(), stride=stride, dilation=dilation,
                    groups=groups)


def causal_tconv(x, p, k: int, stride: int):
    out = F.conv_transpose1d(x, p["w"].float(), p["b"].float(), stride=stride)
    return out[..., :-(k - stride)] if k > stride else out


def snake(x, alpha):
    a = alpha.float()
    return x + torch.sin(a * x).pow(2) / (a + 1e-9)


def res_unit(x, u, dilation: int, P: Prec):
    y = causal_conv(snake(x, u["snake1"]), u["conv1"], 7, dilation=dilation, P=P)
    y = causal_conv(snake(y, u["snake2"]), u["conv2"], 1, P=P)
    return x + y


def res_units(x, units, P: Prec):
    for u, d in zip(units, (1, 3, 9)):
        x = res_unit(x, u, d, P)
    return x


def convnext(x, p, P: Prec):
    inp = x
    x = causal_conv(x, p["dwconv"], 7, groups=x.shape[1])
    x = x.transpose(1, 2)
    x = F.layer_norm(x, (x.shape[-1],), p["norm"]["w"].float(), p["norm"]["b"].float(), eps=1e-6)
    x = F.gelu(P.mm(x, p["pwconv1"]["w"]) + p["pwconv1"]["b"].float())
    x = (P.mm(x, p["pwconv2"]["w"]) + p["pwconv2"]["b"].float()) * p["gamma"].float()
    return inp + x.transpose(1, 2)


def _rope_bf16(s: int, hd: int, device):
    freqs = 1.0 / (10000.0 ** (np.arange(0, hd, 2)[: hd // 2].astype(np.float64) / hd))
    ang = np.outer(np.arange(s, dtype=np.float64), freqs)

    def tab(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device).to(torch.bfloat16).float()

    return tab(np.cos(ang)), tab(np.sin(ang))


def _rope(x, cos, sin):
    xr, xi = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([xr * c - xi * s, xi * c + xr * s], dim=-1).reshape(x.shape)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w.float()


def window_transformer(x, p, n_head: int, head_dim: int, window: int, eps: float, P: Prec):
    x = x.transpose(1, 2)
    b, s, _ = x.shape
    cos, sin = _rope_bf16(s, head_dim, x.device)
    r = torch.arange(s, device=x.device)
    mask = (r[None, :] <= r[:, None]) & (r[None, :] > r[:, None] - window)
    for layer in p["layers"]:
        h = _rms(x, layer["attention_norm"]["w"], eps)
        q, k, v = torch.chunk(P.mm(h, layer["attention"]["wqkv"]["w"]), 3, dim=-1)
        q = _rope(q.reshape(b, s, n_head, head_dim), cos, sin)
        k = _rope(k.reshape(b, s, n_head, head_dim), cos, sin)
        v = v.reshape(b, s, n_head, head_dim)
        lg = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(head_dim)
        w = torch.softmax(lg.masked_fill(~mask, -math.inf), dim=-1)
        o = torch.einsum("bhst,bthd->bshd", w, v).reshape(b, s, n_head * head_dim)
        x = x + layer["attention_layer_scale"].float() * P.mm(o, layer["attention"]["wo"]["w"])
        h = _rms(x, layer["ffn_norm"]["w"], eps)
        ff = layer["feed_forward"]
        x = x + layer["ffn_layer_scale"].float() * P.mm(
            F.silu(P.mm(h, ff["w1"]["w"])) * P.mm(h, ff["w3"]["w"]), ff["w2"]["w"])
    return _rms(x, p["norm"]["w"], eps).transpose(1, 2)


def _qtransformer(p, cfg: dict, which: str, z, P: Prec):
    return window_transformer(z, p["quantizer"][which], cfg["q_n_head"], cfg["q_head_dim"],
                              cfg["q_window_size"], cfg["norm_eps"], P)


def _vq(z, q, P: Prec):
    """Nearest L2-normalised code of in_proj(z); returns out_proj(code)."""
    e = causal_conv(z, q["in_proj"], 1, P=P).transpose(1, 2)
    e = e * torch.rsqrt((e * e).sum(-1, keepdim=True) + 1e-24)
    cb = q["codebook"].float()
    cbn = cb * torch.rsqrt((cb * cb).sum(-1, keepdim=True) + 1e-24)
    idx = torch.einsum("btd,kd->btk", e, cbn).argmax(dim=-1)
    return causal_conv(cb[idx].transpose(1, 2), q["out_proj"], 1, P=P)


def encode_zq(p: dict, cfg: dict, audio, P: Prec):
    """audio (B, 1, T) -> z_q (B, 1024, T / 2048)."""
    pad = -audio.shape[-1] % frame_length(cfg)
    x = F.pad(audio.float(), (0, pad))
    e = p["encoder"]
    x = causal_conv(x, e["stem"], 7, P=P)
    dim = cfg["encoder_dim"]
    for i, (stride, n_t) in enumerate(zip(cfg["encoder_rates"], cfg["encoder_transformer_layers"])):
        dim *= 2
        blk = e["blocks"][i]
        x = snake(res_units(x, blk["res_units"], P), blk["snake"])
        x = causal_conv(x, blk["down"], 2 * stride, stride=stride, P=P)
        if n_t:
            x = window_transformer(x, blk["transformer"], dim // 64, 64, cfg["enc_window_size"],
                                   1e-5, P)
    z = causal_conv(snake(x, e["head_snake"]), e["head"], 3, P=P)
    for i, f in enumerate(cfg["downsample_factor"]):
        st = p["quantizer"]["downsample"][i]
        z = convnext(causal_conv(z, st["conv"], f, stride=f, P=P), st["convnext"], P)
    z = _qtransformer(p, cfg, "pre_module", z, P)
    sem = _vq(z, p["quantizer"]["semantic"][0], P)
    residual, z_q = z - sem, sem
    for q in p["quantizer"]["residual"]:
        zi = _vq(residual, q, P)
        residual = residual - zi
        z_q = z_q + zi
    return z_q


def decode_zq(p: dict, cfg: dict, z_q, P: Prec):
    """z_q (B, 1024, T) -> waveform (B, 1, T·2048)."""
    z = _qtransformer(p, cfg, "post_module", z_q.float(), P)
    for i, f in enumerate(reversed(cfg["downsample_factor"])):
        st = p["quantizer"]["upsample"][i]
        z = convnext(causal_tconv(z, st["conv"], f, f), st["convnext"], P)
    d = p["decoder"]
    x = causal_conv(z, d["stem"], 7, P=P)
    for i, stride in enumerate(cfg["decoder_rates"]):
        blk = d["blocks"][i]
        x = causal_tconv(snake(x, blk["snake"]), blk["up"], 2 * stride, stride)
        x = res_units(x, blk["res_units"], P)
    return torch.tanh(causal_conv(snake(x, d["head_snake"]), d["head"], 7, P=P))


def pca_project(pca: dict, z_q):
    z = z_q.float().transpose(1, 2)
    return (z - pca["mean"]) @ pca["components"].T * pca["latent_scale"]


def pca_deproject(pca: dict, latents):
    z = (latents.float() / pca["latent_scale"]) @ pca["components"] + pca["mean"]
    return z.transpose(1, 2)


def speaker_latent(p: dict, cfg: dict, pca: dict, audio: np.ndarray, bucket: int, P: Prec,
                   chunk_latents: int = 640, patch: int = 4):
    """A prompt (1, samples) -> (latent (1, bucket, 80), mask (1, bucket)):
    encoded in chunks of `chunk_latents`, cut to whole frames and whole
    patches, zero-padded to the bucket."""
    dev = pca["mean"].device
    fl = frame_length(cfg)
    chunk = chunk_latents * fl
    outs = []
    for i in range(0, audio.shape[1], chunk):
        a = np.zeros((1, chunk), np.float32)
        seg = audio[:, i:i + chunk]
        a[:, :seg.shape[1]] = seg
        x = torch.as_tensor(a[None], device=dev)
        outs.append(pca_project(pca, encode_zq(p, cfg, x, P)))
    lat = torch.cat(outs, dim=1)
    n = audio.shape[1] // fl
    n -= n % patch
    out = torch.zeros((1, bucket, lat.shape[-1]), dtype=torch.float32, device=dev)
    out[:, :n] = lat[:, :n]
    mask = torch.zeros((1, bucket), dtype=torch.bool, device=dev)
    mask[:, :n] = True
    return out, mask
