"""Plain EchoDiT in float32: the text, speaker and latent encoders, the
context KV caches, the trunk with its [latent | text | speaker] joint
attention, and the Euler sampler with two independent CFG guidances.

Written from the published recipe (Echo-TTS `inference.py`,
`inference_blockwise.py`) as the served program's weight tree lays it out:
stacked layers on a leading axis, linear weights (in, out) used as x @ w,
q/k norms (H, Dh), half-head RoPE in the trunk. No kernel, no cache reuse
between steps, no batching tricks: every forward recomputes from the
weights. Departures, each one deliberate:

* the flow time is handed to the model rounded to the type the model is
  served in, as the published sampler hands it (the model's input, not
  its arithmetic): `time_dtype`;
* a fully masked context segment is left out of the softmax instead of
  being carried with -inf logits (the same numbers).

`Prec` decides where matmul inputs are rounded: "fp32" (the reference) or
"fp8" (both operands scaled per row / per column and rounded to e4m3).
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class Prec:
    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.mode == "fp8":
            x, w = fp8_round(x, -1), fp8_round(w, -2)
        return x @ w


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 after scaling each slice along `dim` to the
    format's largest finite value, and scaled back, in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


def rms(x, w, eps):
    x = x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)
    return x if w is None else x * w


def rope_tables(dim: int, n: int, device, stride: int = 1):
    """(cos, sin) (n, dim // 2) at positions 0, stride, 2·stride, ..."""
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim))
    ang = np.outer(np.arange(n, dtype=np.float64) * stride, freqs)
    return (torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device))


def rope(x, cos, sin):
    """Rotate adjacent lane pairs of x (..., S, H, D) by (S, D/2) tables."""
    xr, xi = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([xr * c - xi * s, xr * s + xi * c], dim=-1).reshape(x.shape)


def rope_half(x, cos, sin):
    h = x.shape[-2] // 2
    return torch.cat([rope(x[..., :h, :], cos, sin), x[..., h:, :]], dim=-2)


def f32_tree(tree):
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [f32_tree(v) for v in tree]
    return tree.float()


def _attend(q, keys, vals, masks, scale):
    """softmax over the concatenated key sets. q (..., S, H, D); each key
    set (..., T, H, D) with a bool mask broadcastable to (..., T) or None."""
    logits, vs = [], []
    for k, v, m in zip(keys, vals, masks):
        lg = torch.einsum("...shd,...thd->...hst", q, k) * scale
        if m is not None:
            if not bool(m.any()):
                continue
            lg = lg.masked_fill(~m[..., None, None, :], -math.inf)
        logits.append(lg)
        vs.append(v)
    w = torch.softmax(torch.cat(logits, dim=-1), dim=-1)
    out, off = 0.0, 0
    for v in vs:
        t = v.shape[-3]
        out = out + torch.einsum("...hst,...thd->...shd", w[..., off:off + t], v)
        off += t
    return out


def encoder(blocks: dict, x, key_mask, causal: bool, n_heads: int, eps: float, P: Prec):
    """Encoder blocks (stacked): RMS norm, q/k/v/gate, q/k norms, RoPE,
    attention (key mask or causal), sigmoid gate, SwiGLU MLP."""
    b, s, d = x.shape
    hd = d // n_heads
    cos, sin = rope_tables(hd, s, x.device)
    a, mlp = blocks["attention"], blocks["mlp"]
    mask = None
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()[None, None]
    elif key_mask is not None:
        mask = key_mask[:, None, None, :]
    for l in range(a["wq"].shape[0]):
        h = rms(x, blocks["attention_norm"][l], eps)
        q = rms(P.mm(h, a["wq"][l]).reshape(b, s, n_heads, hd), a["q_norm"][l], eps)
        k = rms(P.mm(h, a["wk"][l]).reshape(b, s, n_heads, hd), a["k_norm"][l], eps)
        v = P.mm(h, a["wv"][l]).reshape(b, s, n_heads, hd)
        q, k = rope(q, cos, sin), rope(k, cos, sin)
        lg = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
        if mask is not None:
            lg = lg.masked_fill(~mask, -math.inf)
        o = torch.einsum("bhst,bthd->bshd", torch.softmax(lg, dim=-1), v).reshape(b, s, d)
        x = x + P.mm(o * torch.sigmoid(P.mm(h, a["gate"][l])), a["wo"][l])
        h = rms(x, blocks["mlp_norm"][l], eps)
        x = x + P.mm(F.silu(P.mm(h, mlp["w1"][l])) * P.mm(h, mlp["w3"][l]), mlp["w2"][l])
    return x


def _patch_encode(enc: dict, cfg: dict, latent, P: Prec):
    p = cfg["speaker_patch_size"]
    b, s, d = latent.shape
    x = (P.mm(latent.reshape(b, s // p, d * p), enc["in_proj"]["w"]) + enc["in_proj"]["b"]) / 6.0
    return encoder(enc["blocks"], x, None, True, cfg["speaker_num_heads"], cfg["norm_eps"], P)


def _kv(attn: dict, state, wk: str, wv: str, cfg: dict, P: Prec, rope_tab=None):
    """Per-layer context keys and values (L, B, T, H, Dh)."""
    b, t, _ = state.shape
    h = cfg["num_heads"]
    hd = cfg["model_size"] // h
    ks, vs = [], []
    for l in range(attn[wk].shape[0]):
        k = rms(P.mm(state, attn[wk][l]).reshape(b, t, h, hd), attn["k_norm"][l], cfg["norm_eps"])
        if rope_tab is not None:
            k = rope_half(k, *rope_tab)
        ks.append(k)
        vs.append(P.mm(state, attn[wv][l]).reshape(b, t, h, hd))
    return torch.stack(ks), torch.stack(vs)


def text_kv(p: dict, cfg: dict, ids, mask, P: Prec):
    x = p["text_encoder"]["embedding"][ids]
    x = encoder(p["text_encoder"]["blocks"], x, mask, False, cfg["text_num_heads"],
                cfg["norm_eps"], P)
    x = rms(x, p["text_norm"], cfg["norm_eps"])
    return _kv(p["blocks"]["attention"], x, "wk_text", "wv_text", cfg, P)


def speaker_kv(p: dict, cfg: dict, latent, P: Prec):
    x = rms(_patch_encode(p["speaker_encoder"], cfg, latent, P), p["speaker_norm"], cfg["norm_eps"])
    return _kv(p["blocks"]["attention"], x, "wk_speaker", "wv_speaker", cfg, P)


def latent_kv(p: dict, cfg: dict, prefix, P: Prec):
    """The latent-prefix cache of prefix (B, n·patch, 80): keys at
    positions i·patch with half-head RoPE."""
    x = rms(_patch_encode(p["latent_encoder"], cfg, prefix, P), p["latent_norm"], cfg["norm_eps"])
    hd = cfg["model_size"] // cfg["num_heads"]
    tab = rope_tables(hd, x.shape[1], x.device, stride=cfg["speaker_patch_size"])
    return _kv(p["blocks"]["attention"], x, "wk_latent", "wv_latent", cfg, P, rope_tab=tab)


def timestep_embedding(t, size: int):
    half = size // 2
    k = torch.arange(half, dtype=torch.float32, device=t.device)
    args = t.float()[:, None] * (1000.0 * torch.exp(-math.log(10000.0) * k / half))[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def trunk(p: dict, cfg: dict, x, t, segments: List[Tuple], pos0: int, P: Prec):
    """x (G, B, S, 80), t (B,); segments: (k, v (L, B, T, H, Dh), mask
    (G, B, T) bool). Queries sit at positions pos0 .. pos0 + S. Returns
    (G, B, S, 80)."""
    g, b, s, _ = x.shape
    d, eps = cfg["model_size"], cfg["norm_eps"]
    h = cfg["num_heads"]
    hd = d // h
    cos, sin = rope_tables(hd, pos0 + s, x.device)
    cos, sin = cos[pos0:], sin[pos0:]
    cm = p["cond_module"]
    c = F.silu(P.mm(timestep_embedding(t, cfg["timestep_embed_size"]), cm["w0"]))
    c = P.mm(F.silu(P.mm(c, cm["w1"])), cm["w2"])[:, None]  # (B, 1, 3D)
    blocks = p["blocks"]

    def refine(y, ad, name, l):
        z = P.mm(P.mm(F.silu(y), ad[f"{name}_down"][l]), ad[f"{name}_up"]["w"][l])
        return z + ad[f"{name}_up"]["b"][l] + y

    x = P.mm(x, p["in_proj"]["w"]) + p["in_proj"]["b"]
    a, mlp = blocks["attention"], blocks["mlp"]
    shift0, scale0, gate0 = torch.chunk(c, 3, dim=-1)
    for l in range(a["wq"].shape[0]):
        mods = []
        for ad in (blocks["attention_adaln"], blocks["mlp_adaln"]):
            mods.append((refine(shift0, ad, "shift", l), refine(scale0, ad, "scale", l),
                         torch.tanh(refine(gate0, ad, "gate", l))))
        (a_sh, a_sc, a_g), (m_sh, m_sc, m_g) = mods
        hh = rms(x, None, eps) * (a_sc + 1.0) + a_sh
        q = rms(P.mm(hh, a["wq"][l]).reshape(g, b, s, h, hd), a["q_norm"][l], eps)
        k = rms(P.mm(hh, a["wk"][l]).reshape(g, b, s, h, hd), a["k_norm"][l], eps)
        v = P.mm(hh, a["wv"][l]).reshape(g, b, s, h, hd)
        q, k = rope_half(q, cos, sin), rope_half(k, cos, sin)
        keys, vals, masks = [k], [v], [None]
        for sk, sv, sm in segments:
            keys.append(sk[l][None].expand(g, *sk[l].shape))
            vals.append(sv[l][None].expand(g, *sv[l].shape))
            masks.append(sm)
        o = _attend(q, keys, vals, masks, 1.0 / math.sqrt(hd)).reshape(g, b, s, d)
        o = o * torch.sigmoid(P.mm(hh, a["gate"][l]))
        x = x + a_g * P.mm(o, a["wo"][l])
        hh = rms(x, None, eps) * (m_sc + 1.0) + m_sh
        x = x + m_g * P.mm(F.silu(P.mm(hh, mlp["w1"][l])) * P.mm(hh, mlp["w3"][l]), mlp["w2"][l])
    x = rms(x, p["out_norm"], eps)
    return P.mm(x, p["out_proj"]["w"]) + p["out_proj"]["b"]


def model_time(t: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(t, dtype=torch.float32).to(dtype).float())


def euler_cfg(p: dict, cfg: dict, sc: dict, x, text, spk, P: Prec, latent=None,
              pos0: int = 0, time_dtype=torch.bfloat16):
    """The sampler: x (B, S, 80) the initial noise (truncation applied here);
    text / spk: (k, v, mask (B, T) bool) caches; latent: (k, v, mask) or
    None. Inside the CFG window three branches [cond, no text, no speaker]
    run and v = c + s_t (c - u_t) + s_s (c - u_s); outside it one."""
    unsupported = {k: sc[k] for k in ("rescale_k", "speaker_kv_scale", "joint_uncond", "solver",
                                      "uncond_cache_interval", "first_block_steps")
                   if sc.get(k) not in (None, False, 1, "euler")}
    if unsupported:
        raise ValueError(f"the reference samples the default recipe only, not {unsupported}")
    b = x.shape[0]
    ts = (np.linspace(1.0, 0.0, sc["num_steps"] + 1, dtype=np.float32)
          * np.float32(sc["init_scale"])).astype(np.float32)
    x = x.float() * sc["truncation_factor"]
    none_t = torch.zeros_like(text[2])
    none_s = torch.zeros_like(spk[2])
    for i in range(sc["num_steps"]):
        t = float(ts[i])
        tt = torch.full((b,), model_time(t, time_dtype), dtype=torch.float32, device=x.device)
        cfg_on = (np.float32(t) >= np.float32(sc["cfg_min_t"])
                  and np.float32(sc["cfg_max_t"]) >= np.float32(t))
        if cfg_on:
            tm = torch.stack([text[2], none_t, text[2]])
            sm = torch.stack([spk[2], spk[2], none_s])
        else:
            tm, sm = text[2][None], spk[2][None]
        g = tm.shape[0]
        segs = []
        if latent is not None:
            segs.append((latent[0], latent[1], latent[2][None].expand(g, *latent[2].shape)))
        segs += [(text[0], text[1], tm), (spk[0], spk[1], sm)]
        out = trunk(p, cfg, x[None].expand(g, *x.shape), tt, segs, pos0, P)
        if cfg_on:
            v = (out[0] + sc["cfg_scale_text"] * (out[0] - out[1])
                 + sc["cfg_scale_speaker"] * (out[0] - out[2]))
        else:
            v = out[0]
        x = x + v * float(np.float32(ts[i + 1]) - np.float32(ts[i]))
    return x


def sample_oneshot(p: dict, cfg: dict, sc: dict, noise, ids, tmask, spk_lat, smask, P: Prec,
                   time_dtype=torch.bfloat16):
    text = (*text_kv(p, cfg, ids, tmask, P), tmask)
    spk = (*speaker_kv(p, cfg, spk_lat, P), smask[:, ::cfg["speaker_patch_size"]])
    return euler_cfg(p, cfg, sc, noise, text, spk, P, time_dtype=time_dtype)


def sample_blockwise(p: dict, cfg: dict, sc: dict, noise, ids, tmask, spk_lat, smask,
                     block_sizes, P: Prec, time_dtype=torch.bfloat16):
    """Blocks in order: block i is sampled from its rows of `noise` at
    positions [start, start + size), attending to the latent-prefix cache
    of everything sampled before it (re-encoded whole each block)."""
    text = (*text_kv(p, cfg, ids, tmask, P), tmask)
    spk = (*speaker_kv(p, cfg, spk_lat, P), smask[:, ::cfg["speaker_patch_size"]])
    out = torch.zeros_like(noise, dtype=torch.float32)
    start = 0
    for size in block_sizes:
        latent = None
        if start:
            k, v = latent_kv(p, cfg, out[:, :start], P)
            latent = (k, v, torch.ones(k.shape[1:3], dtype=torch.bool, device=k.device))
        out[:, start:start + size] = euler_cfg(p, cfg, sc, noise[:, start:start + size], text,
                                               spk, P, latent=latent, pos0=start,
                                               time_dtype=time_dtype)
        start += size
    return out
