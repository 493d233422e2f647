"""EchoDiT (counterpart of echo_tts_tpu/models/dit.py): one-shot, blockwise
and training forwards.

Parameters are the JAX package's pytree as nested dicts of tensors: trunk and
encoder layers are stacked on a leading L axis and looped over in Python,
linear weights are (in, out) and used as `x @ w`, q_norm/k_norm are (H, Dh).
KV caches are head-major (L, B, H, T, Dh). The CFG branches are a group axis
G on the queries; every branch shares the text/speaker caches and differs
only in its masks. Joint attention goes through kernel K1
(`ops/joint_attention.py`). The blockwise (streaming) path adds a third
segment ahead of text and speaker: the latent-prefix cache of the blocks
already sampled, built incrementally by `extend_latent_kv`.

The "force speaker" scale is a per-layer list of host floats (the schedule
is known on the host), applied at use-site inside the attention.

Training (`dit_forward(..., remat=True, attn_impl="trainable")`) runs each
trunk layer under `torch.utils.checkpoint` and attention through
`joint_attention_trainable` (K1 forward, K3 backward). A stacked leaf may be
a LoRA-adapted weight (`train/lora.py:LoRAWeight`) instead of a tensor: each
layer forms its own w + s·a@b where it uses it, so under remat the merged
weight is recomputed, never saved. A leaf may also be an int8 quantized
weight (`models/quant.py`, inference only), on which `quant.mm` and
`quant.proj_shared` dispatch.

Tensor parallelism: every forward here runs on a tree sharded by
`parallel/sharding.py:shard_params`. Its attentions hold H/tp contiguous
heads (read from the head norms' shape, never from `cfg`), K1 runs over the
local heads, half-head RoPE rotates the global first half (the local heads
carry their global offset), and one all-reduce on the tp group sums the
partial products of wo and of w2 before the residual add (`quant.mm`), and
nowhere else. Under autograd the column products' input sums its gradient
over the group (`parallel/tp.py:copy_to_tp`).
"""
from __future__ import annotations

import math
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
from echo_tts_tpu_torch.core.rope import (
    apply_rope,
    apply_rope_half_heads,
    per_row,
    precompute_rope,
    row_slots,
    rope_rows,
)
from echo_tts_tpu_torch.models import quant
from echo_tts_tpu_torch.ops.attention import sdpa
from echo_tts_tpu_torch.ops.joint_attention import joint_attention, joint_attention_trainable
from echo_tts_tpu_torch.parallel.tp import head_split

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


def local_heads(attn: dict, num_heads: int):
    """(heads this tree holds, global index of its first, tp group or None)
    of an attention dict (stacked or one layer's) of a model with
    `num_heads` heads: the heads are the k_norm's second-to-last axis."""
    h = attn["k_norm"].shape[-2]
    off, group = head_split(h, num_heads)
    return h, off, group


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
    """Stack of encoder transformer blocks; blocks are stacked over layers.
    `num_heads` is the model's; a sharded tree holds a part of them."""
    b, s, d = x.shape
    hd = d // num_heads
    heads, _, group = local_heads(blocks["attention"], num_heads)
    for p in layer_slices(blocks):
        p = layer_weights(p)
        a = p["attention"]
        h = rms_norm(x, p["attention_norm"], eps)
        q, k, v, gate = quant.proj_shared(h, [a["wq"], a["wk"], a["wv"], a["gate"]], group)
        q = rms_norm(q.reshape(b, s, heads, hd), a["q_norm"], eps)
        k = rms_norm(k.reshape(b, s, heads, hd), a["k_norm"], eps)
        v = v.reshape(b, s, heads, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = sdpa(q, k, v, mask=mask, is_causal=is_causal).reshape(b, s, heads * hd)
        o = o * torch.sigmoid(gate)
        x = x + quant.mm(o, a["wo"], group)
        h = rms_norm(x, p["mlp_norm"], eps)
        x = x + quant.swiglu_mlp_q(h, p["mlp"], group)
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
    """Speaker or latent encoder: patchify by 4, in_proj, the x/6
    activation scale, causal blocks."""
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
                num_heads: int, eps: float, rope=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer K/V projections of an encoder state, stacked to
    (L, B, H, S, Dh) (H the heads the tree holds); k_norm on the keys, then
    half-head RoPE when `rope` (cos, sin) of the S positions is given (the
    latent prefix), else none."""
    b, s, _ = state.shape
    heads, off, group = local_heads(blocks_attn, num_heads)
    hd = blocks_attn["k_norm"].shape[-1]
    ks, vs = [], []
    for p in layer_slices({n: blocks_attn[n] for n in (wk_name, wv_name, "k_norm")}):
        p = layer_weights(p)
        k, v = quant.proj_shared(state, [p[wk_name], p[wv_name]], group)
        k = rms_norm(k.reshape(b, s, heads, hd), p["k_norm"], eps)
        if rope is not None:
            k = apply_rope_half_heads(k, *rope, head_offset=off, total_heads=num_heads)
        ks.append(k.transpose(1, 2))
        vs.append(v.reshape(b, s, heads, hd).transpose(1, 2))
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


def get_kv_cache_latent(params: dict, cfg: DiTConfig, prefix_latent):
    """The latent-prefix cache of a whole prefix (B, S, latent_size): the
    latent encoder (a second patch encoder), latent_norm, per-layer
    wk/wv_latent and k_norm, half-head RoPE at positions i·patch."""
    state = _patch_encoder_forward(params["latent_encoder"], cfg, prefix_latent)
    state = rms_norm(state, params["latent_norm"], cfg.norm_eps)
    p = cfg.speaker_patch_size
    cos, sin = precompute_rope(cfg.head_dim, state.shape[1] * p, device=state.device)
    return _project_kv(params["blocks"]["attention"], state, "wk_latent", "wv_latent",
                       cfg.num_heads, cfg.norm_eps, rope=(cos[::p], sin[::p]))


# ---------------------------------------------------------------------------
# Incremental latent-prefix KV (blockwise streaming)
# ---------------------------------------------------------------------------
#
# The latent encoder is causal, so a block's patches are appended into
# preallocated buffers (the encoder's per-layer self-attention K/V and the
# trunk's per-layer latent cache) instead of re-encoding the prefix. The
# buffers are written in place, the counterpart of the JAX package's donated
# dynamic_update_slice; unwritten positions hold zeros and stay inert under
# the `kv <= q` mask here and the sampler's `latent_pos < start_pos` mask.


def init_latent_kv_state(params: dict, cfg: DiTConfig, batch: int, total_len: int,
                         dtype: torch.dtype) -> dict:
    """Zero state for a blockwise run of `total_len` latents, on the
    params' device: enc_k/enc_v (L_enc, B, T_pat, H_enc, Dh_enc), the
    encoder's self-attention K/V; k/v (L, B, H, T_pat, Dh), the trunk's
    latent cache in `get_kv_cache_latent`'s layout."""
    dev = params["latent_norm"].device
    n_pat = total_len // cfg.speaker_patch_size
    enc_heads = params["latent_encoder"]["blocks"]["attention"]["k_norm"].shape[-2]
    heads = params["blocks"]["attention"]["k_norm"].shape[-2]
    enc = (cfg.speaker_num_layers, batch, n_pat, enc_heads, cfg.speaker_head_dim)
    trunk = (cfg.num_layers, batch, heads, n_pat, cfg.head_dim)
    return {"enc_k": torch.zeros(enc, dtype=dtype, device=dev),
            "enc_v": torch.zeros(enc, dtype=dtype, device=dev),
            "k": torch.zeros(trunk, dtype=dtype, device=dev),
            "v": torch.zeros(trunk, dtype=dtype, device=dev)}


def extend_latent_kv(params: dict, cfg: DiTConfig, state: dict, new_latent: torch.Tensor,
                     start_pos) -> dict:
    """Append `new_latent` (B, n·patch, latent_size), the latents
    [start_pos, start_pos + n·patch) in the model dtype, into `state` in
    place and return it. Exact against a whole-prefix `get_kv_cache_latent`:
    the encoder is causal and the masked tail adds exact zeros. start_pos is
    one int for every row, or one position a row ((B,), continuous
    batching): each row then takes RoPE, its causal mask and its writes at
    its own patch offset (a write that would not fit is moved back until it
    does, as the JAX package's dynamic_update_slice moves it; only a free
    slot gets there)."""
    enc = params["latent_encoder"]
    p = cfg.speaker_patch_size
    b, s_lat, d_lat = new_latent.shape
    n = s_lat // p
    eps = cfg.norm_eps
    heads, _, group = local_heads(enc["blocks"]["attention"], cfg.speaker_num_heads)
    hd = cfg.speaker_head_dim
    t_pat = state["enc_k"].shape[2]
    dev = new_latent.device
    rows = per_row(start_pos)
    if rows:
        pos = torch.as_tensor(start_pos, dtype=torch.long, device=dev).reshape(b) // p
        if s_lat % p or n > t_pat:
            raise ValueError(f"{s_lat} latents do not fit {t_pat} patches of {p}")
        idx = pos[:, None] + torch.arange(n, device=dev)  # (B, n) absolute patches
        cos, sin = rope_rows(*precompute_rope(hd, t_pat, device=dev), idx)
        hidden = (torch.arange(t_pat, device=dev)[None, None, :] > idx[:, :, None])[:, None]
        at = row_slots(pos, n, t_pat)
        bi = torch.arange(b, device=dev)[:, None]
    else:
        pos = int(start_pos) // p
        if s_lat % p or pos + n > t_pat:
            raise ValueError(f"{s_lat} latents at {start_pos} do not fit {t_pat} patches of {p}")
        cos, sin = (tab[pos:pos + n] for tab in precompute_rope(hd, t_pat, device=dev))
        # query at patch pos + i sees the keys at patches <= pos + i
        hidden = (torch.arange(t_pat, device=dev)[None, :]
                  > (pos + torch.arange(n, device=dev))[:, None])

    x = new_latent.reshape(b, n, d_lat * p) @ enc["in_proj"]["w"] + enc["in_proj"]["b"]
    x = x / 6.0
    for l, lp in enumerate(layer_slices(enc["blocks"])):
        lp = layer_weights(lp)
        a = lp["attention"]
        h = rms_norm(x, lp["attention_norm"], eps)
        q, k, v, gate = quant.proj_shared(h, [a["wq"], a["wk"], a["wv"], a["gate"]], group)
        q = apply_rope(rms_norm(q.reshape(b, n, heads, hd), a["q_norm"], eps), cos, sin)
        k = apply_rope(rms_norm(k.reshape(b, n, heads, hd), a["k_norm"], eps), cos, sin)
        kbuf, vbuf = state["enc_k"][l], state["enc_v"][l]
        # written before this layer reads the buffer
        if rows:
            kbuf[bi, at] = k.to(kbuf.dtype)
            vbuf[bi, at] = v.reshape(b, n, heads, hd).to(vbuf.dtype)
        else:
            kbuf[:, pos:pos + n] = k
            vbuf[:, pos:pos + n] = v.reshape(b, n, heads, hd)
        logits = torch.einsum("bnhd,bthd->bhnt", q.float(), kbuf.float()) / math.sqrt(hd)
        w = torch.softmax(logits.masked_fill(hidden, _NEG), dim=-1).to(vbuf.dtype)
        o = torch.einsum("bhnt,bthd->bnhd", w.float(), vbuf.float()).to(vbuf.dtype)
        x = x + quant.mm(o.reshape(b, n, heads * hd) * torch.sigmoid(gate), a["wo"], group)
        x = x + quant.swiglu_mlp_q(rms_norm(x, lp["mlp_norm"], eps), lp["mlp"], group)

    # the trunk's cache of the new patches, as get_kv_cache_latent builds it
    x = rms_norm(x, params["latent_norm"], eps)
    cos, sin = precompute_rope(cfg.head_dim, t_pat * p, device=dev)
    rope = rope_rows(cos, sin, idx * p) if rows else \
        (cos[pos * p:(pos + n) * p:p], sin[pos * p:(pos + n) * p:p])
    ks, vs = _project_kv(params["blocks"]["attention"], x, "wk_latent", "wv_latent",
                         cfg.num_heads, eps, rope=rope)
    if rows:  # (L, B, H, T, Dh) caches indexed on axes 1 and 3: (B, n, L, H, Dh)
        state["k"][:, bi, :, at] = ks.permute(1, 3, 0, 2, 4).to(state["k"].dtype)
        state["v"][:, bi, :, at] = vs.permute(1, 3, 0, 2, 4).to(state["v"].dtype)
    else:
        state["k"][:, :, :, pos:pos + n] = ks
        state["v"][:, :, :, pos:pos + n] = vs
    return state


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
    kv_latent: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (L, B, H, T_lat, Dh)
    latent_mask: Optional[torch.Tensor] = None,                     # (G, B, T_lat) bool
) -> torch.Tensor:
    """Core trunk. Returns fp32 (G, B, S, latent_size). remat: run each
    layer under torch.utils.checkpoint (the counterpart of
    jax.checkpoint(body)). attn_impl: None for the inference kernel,
    "trainable" for the differentiable K1/K3 pair. kv_latent, when given,
    is the first segment, [latent | text | speaker]; no branch skips it."""
    if attn_impl not in (None, "trainable"):
        raise ValueError(f"attn_impl must be None or 'trainable', got {attn_impl!r}")
    g, b, s, _ = x.shape
    dh = cfg.head_dim
    h_, h_off, group = local_heads(params["blocks"]["attention"], cfg.num_heads)
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
    stacks = [*kv_text, *kv_speaker, a_shift, a_scale, a_gate, m_shift, m_scale, m_gate]
    if kv_latent is not None:
        lat_bias = _mask_bias(latent_mask)
        stacks += kv_latent
    per = zip(layer_slices({"attention": blocks["attention"], "mlp": blocks["mlp"]}),
              *(stack.unbind(0) for stack in stacks))

    def layer(x, p, kt_k, kt_v, ks_k, ks_v, a_shift, a_scale, a_gate, m_shift, m_scale,
              m_gate, kl_k=None, kl_v=None, skv=None):
        p = layer_weights(p)
        a = p["attention"]
        h = modulate_rms(x, a_shift, a_scale, eps)
        q, k_self, v_self, gate = quant.proj_shared(h, [a["wq"], a["wk"], a["wv"], a["gate"]],
                                                    group)
        q = rms_norm(q.reshape(g, b, s, h_, dh), a["q_norm"], eps)
        k_self = rms_norm(k_self.reshape(g, b, s, h_, dh), a["k_norm"], eps)
        v_self = v_self.reshape(g, b, s, h_, dh)
        q = apply_rope_half_heads(q, cos_q, sin_q, h_off, cfg.num_heads)
        k_self = apply_rope_half_heads(k_self, cos_q, sin_q, h_off, cfg.num_heads)
        # segment order [latent | text | speaker]
        segments = [] if kl_k is None else [(kl_k, kl_v, lat_bias, None, ())]
        segments += [(kt_k, kt_v, text_bias, None, branch_skips[0]),
                     (ks_k, ks_v, spk_bias, skv, branch_skips[1])]
        if attn_impl == "trainable":
            o = joint_attention_trainable(q, k_self, v_self, [sg[:4] for sg in segments],
                                          layout="sm")
        else:
            o = _joint_attention_grouped(q, k_self, v_self, segments, layout="sm",
                                         self_len=self_len)
        o = o.reshape(g, b, s, h_ * dh) * torch.sigmoid(gate)
        x = x + a_gate * quant.mm(o, a["wo"], group)
        h = modulate_rms(x, m_shift, m_scale, eps)
        return x + m_gate * quant.swiglu_mlp_q(h, p["mlp"], group)

    for l, args in enumerate(per):
        if kv_latent is None:
            args += (None, None)
        skv = None if speaker_kv_scale is None else speaker_kv_scale[l]
        if remat:
            x = checkpoint(layer, x, *args, skv, use_reentrant=False)
        else:
            x = layer(x, *args, skv)

    x = rms_norm(x, params["out_norm"], eps)
    x = x @ params["out_proj"]["w"] + params["out_proj"]["b"]
    return x.float()


def _latent_segment(kv_latent, latent_mask, x: torch.Tensor, g: int):
    """The latent segment as the trunk takes it: kept whenever the cache has
    positions, whatever its mask says (as the JAX package keeps it); the
    (B, T_lat) mask, all visible by default, broadcast over g branches."""
    if kv_latent is None or kv_latent[0].shape[3] == 0:
        return None, None
    if latent_mask is None:
        latent_mask = torch.ones((x.shape[0], kv_latent[0].shape[3]), dtype=torch.bool,
                                 device=x.device)
    return kv_latent, latent_mask[None].expand((g,) + tuple(latent_mask.shape))


def dit_forward(params: dict, cfg: DiTConfig, x, t, text_mask, speaker_mask,
                kv_text, kv_speaker, rope_q=None, speaker_kv_scale=None,
                self_len=None, remat: bool = False,
                attn_impl: Optional[str] = None, kv_latent=None,
                latent_mask=None) -> torch.Tensor:
    """Single-branch forward, fp32 output. speaker_mask is (B, S_spk_latents),
    strided by the patch size here. remat/attn_impl as in
    `_dit_forward_grouped` (training passes True and "trainable").
    Blockwise callers pass rope_q sliced at start_pos, the latent-prefix
    cache and its (B, T_lat) `latent_pos < start_pos` mask."""
    spk_mask = speaker_mask[..., :: cfg.speaker_patch_size]
    kv_latent, lm = _latent_segment(kv_latent, latent_mask, x, 1)
    out = _dit_forward_grouped(params, cfg, x[None], t, text_mask[None], spk_mask[None],
                               kv_text, kv_speaker, rope_q, speaker_kv_scale,
                               self_len=self_len, remat=remat, attn_impl=attn_impl,
                               kv_latent=kv_latent, latent_mask=lm)
    return out[0]


def dit_forward_cfg(params: dict, cfg: DiTConfig, x, t, text_mask, speaker_mask,
                    kv_text, kv_speaker, rope_q=None, speaker_kv_scale=None,
                    self_len=None, kv_latent=None, latent_mask=None,
                    joint_uncond: bool = False) -> torch.Tensor:
    """CFG forward over [cond, text-uncond, speaker-uncond], or [cond,
    joint-uncond] (text and speaker both masked) when joint_uncond: the
    unconds attend to nothing in their ablated segments, the caches carry
    conditional values; the latent segment's mask is every branch's. With
    joint_uncond the uncond branch sees no context segment at all (or the
    latent one alone), which K1 takes as a launch of its own. Returns fp32
    (3 or 2, B, S, latent_size)."""
    spk = speaker_mask[..., :: cfg.speaker_patch_size]
    if joint_uncond:
        n_groups, branch_skips = 2, ((1,), (1,))
        text_m = torch.stack([text_mask, torch.zeros_like(text_mask)])
        spk_m = torch.stack([spk, torch.zeros_like(spk)])
    else:
        n_groups, branch_skips = 3, ((1,), (2,))
        text_m = torch.stack([text_mask, torch.zeros_like(text_mask), text_mask])
        spk_m = torch.stack([spk, spk, torch.zeros_like(spk)])
    xg = x[None].expand((n_groups,) + tuple(x.shape))
    kv_latent, lm = _latent_segment(kv_latent, latent_mask, x, n_groups)
    return _dit_forward_grouped(params, cfg, xg, t, text_m, spk_m, kv_text, kv_speaker,
                                rope_q, speaker_kv_scale, branch_skips=branch_skips,
                                self_len=self_len, kv_latent=kv_latent, latent_mask=lm)


# ---------------------------------------------------------------------------
# Initialization (random weights from a seed, made on the device)
# ---------------------------------------------------------------------------


class _Init:
    def __init__(self, device: torch.device, seed: int, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        # meta tensors (shapes alone, bench/fast_init.py) take no generator
        self.gen = (None if device.type == "meta"
                    else torch.Generator(device=device).manual_seed(seed))

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
    checkpoints/from_jax.py instead. With `cfg.has_latent_modules` the
    streaming path's latent encoder, latent_norm and wk/wv_latent are
    built too."""
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

    def patch_encoder():
        in_dim = cfg.latent_size * cfg.speaker_patch_size
        return {
            "in_proj": {"w": ini.linear(in_dim, (in_dim, ds)), "b": ini.zeros((ds,))},
            "blocks": _init_encoder_blocks(ini, cfg.speaker_num_layers, ds,
                                           cfg.speaker_num_heads,
                                           cfg.speaker_intermediate_size),
        }

    params = {
        "text_encoder": {
            "embedding": ini.normal((cfg.text_vocab_size, dt)),
            "blocks": _init_encoder_blocks(ini, cfg.text_num_layers, dt,
                                           cfg.text_num_heads, cfg.text_intermediate_size),
        },
        "speaker_encoder": patch_encoder(),
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
    if cfg.has_latent_modules:
        attn = params["blocks"]["attention"]
        attn["wk_latent"] = ini.linear(ds, (l, ds, d))
        attn["wv_latent"] = ini.linear(ds, (l, ds, d))
        params["latent_encoder"] = patch_encoder()
        params["latent_norm"] = ini.ones((ds,))
    return params

