"""EchoDiT (counterpart of echo_tts_tpu/models/dit.py): one-shot and training
forwards.

Parameters are the JAX package's pytree as nested dicts of tensors: trunk and
encoder layers are stacked on a leading L axis and looped over in Python,
linear weights are (in, out) and used as `x @ w`, q_norm/k_norm are (H, Dh).
KV caches are head-major (L, B, H, T, Dh). The CFG branches are a group axis
G on the queries; every branch shares the text/speaker caches and differs
only in its masks. Joint attention goes through kernel K1
(`ops/joint_attention.py`).

The "force speaker" scale is a per-layer list of host floats (the schedule
is known on the host), applied at use-site inside the attention.

Training (`dit_forward(..., remat=True, attn_impl="trainable")`) runs each
trunk layer under `torch.utils.checkpoint` and attention through
`joint_attention_trainable` (K1 forward, K3 backward). A stacked leaf may be
a LoRA-adapted weight (`train/lora.py:LoRAWeight`) instead of a tensor: each
layer forms its own w + s·a@b where it uses it, so under remat the merged
weight is recomputed, never saved.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from echo_tts_tpu_torch.core.config import DiTConfig
from echo_tts_tpu_torch.core.device import resolve_device
from echo_tts_tpu_torch.core.layers import (
    modulate_rms,
    precompute_adaln,
    rms_norm,
    timestep_embedding,
)
from echo_tts_tpu_torch.core.rope import apply_rope, apply_rope_half_heads, precompute_rope
from echo_tts_tpu_torch.models import quant
from echo_tts_tpu_torch.ops.attention import sdpa
from echo_tts_tpu_torch.ops.joint_attention import joint_attention, joint_attention_trainable

_NEG = -1e30


def layer_slices(tree) -> list:
    """The per-layer slices of a pytree whose leaves are stacked on a leading
    L axis. One unbind per leaf, so a leaf that requires grad gets one
    backward node that stacks the layers' gradients, not one full-size zero
    stack per layer. A LoRA-adapted leaf slices itself the same way."""
    if isinstance(tree, dict):
        per = {k: layer_slices(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[l] for k, v in per.items()} for l in range(n)]
    return list(tree.unbind(0))


def layer_weights(tree):
    """Tensors of a (per-layer or stacked) pytree: a LoRA-adapted leaf
    becomes its merged weight w + s·a@b here."""
    if isinstance(tree, dict):
        return {k: layer_weights(v) for k, v in tree.items()}
    return tree if isinstance(tree, torch.Tensor) else tree.weight()


# ---------------------------------------------------------------------------
# Encoder (shared by the text and speaker encoders)
# ---------------------------------------------------------------------------


def encoder_forward(blocks: dict, x: torch.Tensor, mask: Optional[torch.Tensor],
                    cos: torch.Tensor, sin: torch.Tensor, *, num_heads: int,
                    is_causal: bool, eps: float) -> torch.Tensor:
    """Stack of encoder transformer blocks; blocks are stacked over layers."""
    b, s, d = x.shape
    hd = d // num_heads
    for p in layer_slices(blocks):
        p = layer_weights(p)
        a = p["attention"]
        h = rms_norm(x, p["attention_norm"], eps)
        q, k, v, gate = quant.proj_shared(h, [a["wq"], a["wk"], a["wv"], a["gate"]])
        q = rms_norm(q.reshape(b, s, num_heads, hd), a["q_norm"], eps)
        k = rms_norm(k.reshape(b, s, num_heads, hd), a["k_norm"], eps)
        v = v.reshape(b, s, num_heads, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = sdpa(q, k, v, mask=mask, is_causal=is_causal).reshape(b, s, d)
        o = o * torch.sigmoid(gate)
        x = x + quant.mm(o, a["wo"])
        h = rms_norm(x, p["mlp_norm"], eps)
        x = x + quant.swiglu_mlp_q(h, p["mlp"])
    return x


def text_encoder_forward(params: dict, cfg: DiTConfig, input_ids: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Byte embedding plus bidirectional blocks."""
    enc = params["text_encoder"]
    x = enc["embedding"][input_ids.long()]
    cos, sin = precompute_rope(cfg.text_head_dim, input_ids.shape[1], device=x.device)
    return encoder_forward(enc["blocks"], x, mask, cos, sin,
                           num_heads=cfg.text_num_heads, is_causal=False,
                           eps=cfg.norm_eps)


def _patch_encoder_forward(enc: dict, cfg: DiTConfig, latent: torch.Tensor) -> torch.Tensor:
    """Speaker encoder: patchify by 4, in_proj, the x/6 activation scale,
    causal blocks."""
    p = cfg.speaker_patch_size
    b, s, d_lat = latent.shape
    x = latent.reshape(b, s // p, d_lat * p)
    x = x @ enc["in_proj"]["w"] + enc["in_proj"]["b"]
    x = x / 6.0
    cos, sin = precompute_rope(cfg.speaker_head_dim, x.shape[1], device=x.device)
    return encoder_forward(enc["blocks"], x, None, cos, sin,
                           num_heads=cfg.speaker_num_heads, is_causal=True,
                           eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def _project_kv(blocks_attn: dict, state: torch.Tensor, wk_name: str, wv_name: str,
                num_heads: int, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer K/V projections of an encoder state, stacked to
    (L, B, H, S, Dh); k_norm on the keys, no RoPE."""
    b, s, _ = state.shape
    ks, vs = [], []
    for p in layer_slices({n: blocks_attn[n] for n in (wk_name, wv_name, "k_norm")}):
        p = layer_weights(p)
        hd = p[wk_name].shape[-1] // num_heads
        k, v = quant.proj_shared(state, [p[wk_name], p[wv_name]])
        k = rms_norm(k.reshape(b, s, num_heads, hd), p["k_norm"], eps)
        ks.append(k.transpose(1, 2))
        vs.append(v.reshape(b, s, num_heads, hd).transpose(1, 2))
    return torch.stack(ks), torch.stack(vs)


def get_kv_cache_text(params: dict, cfg: DiTConfig, input_ids, mask):
    state = text_encoder_forward(params, cfg, input_ids, mask)
    state = rms_norm(state, params["text_norm"], cfg.norm_eps)
    return _project_kv(params["blocks"]["attention"], state, "wk_text", "wv_text",
                       cfg.num_heads, cfg.norm_eps)


def get_kv_cache_speaker(params: dict, cfg: DiTConfig, speaker_latent):
    state = _patch_encoder_forward(params["speaker_encoder"], cfg, speaker_latent)
    state = rms_norm(state, params["speaker_norm"], cfg.norm_eps)
    return _project_kv(params["blocks"]["attention"], state, "wk_speaker", "wv_speaker",
                       cfg.num_heads, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Joint attention dispatch
# ---------------------------------------------------------------------------


def _joint_attention_grouped(q, k_self, v_self, segments, layout: str = "hm",
                             self_len=None) -> torch.Tensor:
    """Segmented joint attention over the CFG group axis.

    q, k_self, v_self: (G, B, H, S, Dh) (layout="hm") or (G, B, S, H, Dh)
    (layout="sm"). segments: (k (B, H, T, Dh), v, mask (G, B, T) bool or
    fp32 bias, scale float or None[, skips]) where the optional `skips`
    lists the CFG branches whose mask zeroes the whole segment. Branches
    with the same visible segments share one launch that leaves the others
    out: a fully masked segment contributes exactly zero, so the result
    equals the mask-only computation. Returns q's layout."""
    g = q.shape[0]
    skips = [tuple(s[4]) if len(s) > 4 else () for s in segments]
    if g == 1 or not any(skips):
        return joint_attention(q, k_self, v_self, [s[:4] for s in segments],
                               layout=layout, self_len=self_len)
    visible = [tuple(i for i, sk in enumerate(skips) if gi not in sk) for gi in range(g)]
    out = torch.empty(q.shape, dtype=v_self.dtype, device=q.device)
    gi = 0
    while gi < g:  # contiguous branches with equal signatures share a launch
        gj = gi + 1
        while gj < g and visible[gj] == visible[gi]:
            gj += 1
        segs = [(segments[i][0], segments[i][1], segments[i][2][gi:gj], segments[i][3])
                for i in visible[gi]]
        joint_attention(q[gi:gj], k_self[gi:gj], v_self[gi:gj], segs, layout=layout,
                        self_len=self_len, out=out[gi:gj])
        gi = gj
    return out


# ---------------------------------------------------------------------------
# DiT trunk forward
# ---------------------------------------------------------------------------


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """bool (…, T) -> fp32 additive bias 0 / -1e30, built once per forward."""
    return torch.where(mask, 0.0, _NEG).float()


def _dit_forward_grouped(
    params: dict,
    cfg: DiTConfig,
    x: torch.Tensor,                     # (G, B, S, latent_size), model dtype
    t: torch.Tensor,                     # (B,), model dtype
    text_mask: torch.Tensor,             # (G, B, T_text) bool
    spk_mask: torch.Tensor,              # (G, B, T_spk_patches) bool
    kv_text: Tuple[torch.Tensor, torch.Tensor],     # each (L, B, H, T_text, Dh)
    kv_speaker: Tuple[torch.Tensor, torch.Tensor],  # each (L, B, H, T_spk, Dh)
    rope_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    speaker_kv_scale: Optional[Sequence[float]] = None,  # per layer
    branch_skips: Tuple[tuple, tuple] = ((), ()),
    self_len=None,
    remat: bool = False,
    attn_impl: Optional[str] = None,
) -> torch.Tensor:
    """Core trunk. Returns fp32 (G, B, S, latent_size). remat: run each
    layer under torch.utils.checkpoint (the counterpart of
    jax.checkpoint(body)). attn_impl: None for the inference kernel,
    "trainable" for the differentiable K1/K3 pair."""
    if attn_impl not in (None, "trainable"):
        raise ValueError(f"attn_impl must be None or 'trainable', got {attn_impl!r}")
    g, b, s, _ = x.shape
    h_, dh = cfg.num_heads, cfg.head_dim
    eps = cfg.norm_eps
    cos_q, sin_q = rope_q if rope_q is not None else precompute_rope(dh, s, device=x.device)

    cm = params["cond_module"]
    cond = timestep_embedding(t, cfg.timestep_embed_size)
    cond = F.silu(cond @ cm["w0"])
    cond = F.silu(cond @ cm["w1"])
    cond = (cond @ cm["w2"])[:, None]  # (B, 1, 3D), broadcast over G

    x = x @ params["in_proj"]["w"] + params["in_proj"]["b"]
    blocks = params["blocks"]
    a_shift, a_scale, a_gate = precompute_adaln(cond, layer_weights(blocks["attention_adaln"]))
    m_shift, m_scale, m_gate = precompute_adaln(cond, layer_weights(blocks["mlp_adaln"]))
    text_bias, spk_bias = _mask_bias(text_mask), _mask_bias(spk_mask)
    per = zip(layer_slices({"attention": blocks["attention"], "mlp": blocks["mlp"]}),
              *(stack.unbind(0) for stack in (*kv_text, *kv_speaker, a_shift, a_scale,
                                              a_gate, m_shift, m_scale, m_gate)))

    def layer(x, p, kt_k, kt_v, ks_k, ks_v, a_shift, a_scale, a_gate, m_shift, m_scale,
              m_gate, skv):
        p = layer_weights(p)
        a = p["attention"]
        h = modulate_rms(x, a_shift, a_scale, eps)
        q, k_self, v_self, gate = quant.proj_shared(h, [a["wq"], a["wk"], a["wv"], a["gate"]])
        q = rms_norm(q.reshape(g, b, s, h_, dh), a["q_norm"], eps)
        k_self = rms_norm(k_self.reshape(g, b, s, h_, dh), a["k_norm"], eps)
        v_self = v_self.reshape(g, b, s, h_, dh)
        q = apply_rope_half_heads(q, cos_q, sin_q)
        k_self = apply_rope_half_heads(k_self, cos_q, sin_q)
        if attn_impl == "trainable":
            o = joint_attention_trainable(q, k_self, v_self,
                                          [(kt_k, kt_v, text_bias, None),
                                           (ks_k, ks_v, spk_bias, skv)], layout="sm")
        else:
            # segment order [text | speaker]
            segments = [(kt_k, kt_v, text_bias, None, branch_skips[0]),
                        (ks_k, ks_v, spk_bias, skv, branch_skips[1])]
            o = _joint_attention_grouped(q, k_self, v_self, segments, layout="sm",
                                         self_len=self_len)
        o = o.reshape(g, b, s, cfg.model_size) * torch.sigmoid(gate)
        x = x + a_gate * quant.mm(o, a["wo"])
        h = modulate_rms(x, m_shift, m_scale, eps)
        return x + m_gate * quant.swiglu_mlp_q(h, p["mlp"])

    for l, args in enumerate(per):
        skv = None if speaker_kv_scale is None else speaker_kv_scale[l]
        if remat:
            x = checkpoint(layer, x, *args, skv, use_reentrant=False)
        else:
            x = layer(x, *args, skv)

    x = rms_norm(x, params["out_norm"], eps)
    x = x @ params["out_proj"]["w"] + params["out_proj"]["b"]
    return x.float()


def dit_forward(params: dict, cfg: DiTConfig, x, t, text_mask, speaker_mask,
                kv_text, kv_speaker, rope_q=None, speaker_kv_scale=None,
                self_len=None, remat: bool = False,
                attn_impl: Optional[str] = None) -> torch.Tensor:
    """Single-branch forward, fp32 output. speaker_mask is (B, S_spk_latents),
    strided by the patch size here. remat/attn_impl as in
    `_dit_forward_grouped` (training passes True and "trainable")."""
    spk_mask = speaker_mask[..., :: cfg.speaker_patch_size]
    out = _dit_forward_grouped(params, cfg, x[None], t, text_mask[None], spk_mask[None],
                               kv_text, kv_speaker, rope_q, speaker_kv_scale,
                               self_len=self_len, remat=remat, attn_impl=attn_impl)
    return out[0]


def dit_forward_cfg(params: dict, cfg: DiTConfig, x, t, text_mask, speaker_mask,
                    kv_text, kv_speaker, rope_q=None, speaker_kv_scale=None,
                    self_len=None) -> torch.Tensor:
    """CFG forward over [cond, text-uncond, speaker-uncond]: the unconds
    attend to nothing in their ablated segment, the caches carry
    conditional values. Returns fp32 (3, B, S, latent_size)."""
    spk = speaker_mask[..., :: cfg.speaker_patch_size]
    text_m = torch.stack([text_mask, torch.zeros_like(text_mask), text_mask])
    spk_m = torch.stack([spk, spk, torch.zeros_like(spk)])
    xg = x[None].expand((3,) + tuple(x.shape))
    return _dit_forward_grouped(params, cfg, xg, t, text_m, spk_m, kv_text, kv_speaker,
                                rope_q, speaker_kv_scale, branch_skips=((1,), (2,)),
                                self_len=self_len)


# ---------------------------------------------------------------------------
# Initialization (random weights from a seed, made on the device)
# ---------------------------------------------------------------------------


class _Init:
    def __init__(self, device: torch.device, seed: int, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def linear(self, fan_in: int, shape) -> torch.Tensor:
        bound = fan_in ** -0.5
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        return w.uniform_(-bound, bound, generator=self.gen).to(self.dtype)

    def normal(self, shape) -> torch.Tensor:
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        return w.normal_(generator=self.gen).to(self.dtype)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)


def _init_encoder_blocks(ini: _Init, n_layers, d, n_heads, ffn) -> dict:
    hd = d // n_heads
    return {
        "attention": {
            "wq": ini.linear(d, (n_layers, d, d)),
            "wk": ini.linear(d, (n_layers, d, d)),
            "wv": ini.linear(d, (n_layers, d, d)),
            "wo": ini.linear(d, (n_layers, d, d)),
            "gate": ini.linear(d, (n_layers, d, d)),
            "q_norm": ini.ones((n_layers, n_heads, hd)),
            "k_norm": ini.ones((n_layers, n_heads, hd)),
        },
        "mlp": {
            "w1": ini.linear(d, (n_layers, d, ffn)),
            "w3": ini.linear(d, (n_layers, d, ffn)),
            "w2": ini.linear(ffn, (n_layers, ffn, d)),
        },
        "attention_norm": ini.ones((n_layers, d)),
        "mlp_norm": ini.ones((n_layers, d)),
    }


def init_dit_params(cfg: DiTConfig, dtype: torch.dtype = torch.bfloat16,
                    device=None, seed: int = 0) -> dict:
    """Random DiT weights with the JAX initializer's distributions
    (uniform ±1/sqrt(fan_in) linears, unit norms, zero biases, normal
    embedding), drawn on `device` (default cuda) from `seed`. The numbers
    differ from jax.random's; tests carry JAX weights over with
    checkpoints/from_jax.py instead. The latent encoder of the streaming
    path is not ported yet, so `cfg.has_latent_modules` must be False."""
    if cfg.has_latent_modules:
        raise NotImplementedError("the latent encoder (streaming) is not ported yet; "
                                  "use DiTConfig(has_latent_modules=False)")
    ini = _Init(resolve_device(device), seed, dtype)
    d, l, h = cfg.model_size, cfg.num_layers, cfg.num_heads
    hd = cfg.head_dim
    dt, ds = cfg.text_model_size, cfg.speaker_model_size
    r = cfg.adaln_rank

    def adaln():
        return {
            "shift_down": ini.linear(d, (l, d, r)),
            "scale_down": ini.linear(d, (l, d, r)),
            "gate_down": ini.linear(d, (l, d, r)),
            "shift_up": {"w": ini.linear(r, (l, r, d)), "b": ini.zeros((l, d))},
            "scale_up": {"w": ini.linear(r, (l, r, d)), "b": ini.zeros((l, d))},
            "gate_up": {"w": ini.linear(r, (l, r, d)), "b": ini.zeros((l, d))},
        }

    in_dim = cfg.latent_size * cfg.speaker_patch_size
    params = {
        "text_encoder": {
            "embedding": ini.normal((cfg.text_vocab_size, dt)),
            "blocks": _init_encoder_blocks(ini, cfg.text_num_layers, dt,
                                           cfg.text_num_heads, cfg.text_intermediate_size),
        },
        "speaker_encoder": {
            "in_proj": {"w": ini.linear(in_dim, (in_dim, ds)), "b": ini.zeros((ds,))},
            "blocks": _init_encoder_blocks(ini, cfg.speaker_num_layers, ds,
                                           cfg.speaker_num_heads,
                                           cfg.speaker_intermediate_size),
        },
        "text_norm": ini.ones((dt,)),
        "speaker_norm": ini.ones((ds,)),
        "cond_module": {
            "w0": ini.linear(cfg.timestep_embed_size, (cfg.timestep_embed_size, d)),
            "w1": ini.linear(d, (d, d)),
            "w2": ini.linear(d, (d, 3 * d)),
        },
        "in_proj": {"w": ini.linear(cfg.latent_size, (cfg.latent_size, d)),
                    "b": ini.zeros((d,))},
        "blocks": {
            "attention": {
                "wq": ini.linear(d, (l, d, d)),
                "wk": ini.linear(d, (l, d, d)),
                "wv": ini.linear(d, (l, d, d)),
                "wo": ini.linear(d, (l, d, d)),
                "gate": ini.linear(d, (l, d, d)),
                "wk_text": ini.linear(dt, (l, dt, d)),
                "wv_text": ini.linear(dt, (l, dt, d)),
                "wk_speaker": ini.linear(ds, (l, ds, d)),
                "wv_speaker": ini.linear(ds, (l, ds, d)),
                "q_norm": ini.ones((l, h, hd)),
                "k_norm": ini.ones((l, h, hd)),
            },
            "mlp": {
                "w1": ini.linear(d, (l, d, cfg.intermediate_size)),
                "w3": ini.linear(d, (l, d, cfg.intermediate_size)),
                "w2": ini.linear(cfg.intermediate_size, (l, cfg.intermediate_size, d)),
            },
            "attention_adaln": adaln(),
            "mlp_adaln": adaln(),
        },
        "out_norm": ini.ones((d,)),
        "out_proj": {"w": ini.linear(d, (d, cfg.latent_size)),
                     "b": ini.zeros((cfg.latent_size,))},
    }
    return params

