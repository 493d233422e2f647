"""Ablation profiler for the DiT CFG forward and the S1-DAC decoder
(counterpart of scripts/ablate_dit.py). Diagnostic only.

Toggles one feature of the trunk's block body at a time (the attention: K1,
the plain attention or none; AdaLN; RoPE; QK-norm; the sigmoid gate; the
head-major transposes before the attention) to localize the per-step cost
outside the GEMMs, and times each decoder stage (stem, each block's
transposed conv and its residual chain, kernel K2) to rank the vocoder's
work. Every time is the median of CUDA-event timings of one call after a
warm-up (`bench/timing.py:cuda_times`), on the card whose name and power
limit are printed; --cpu --tiny rehearses it on the host's clock.

    python -m echo_tts_tpu_torch.scripts.ablate_dit [--dec-only] [--cpu --tiny]

Prints a table on stderr and one JSON line {variant or stage: ms} on stdout.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

SEQ, TEXT, SPK, G = 640, 768, 6400, 3
VARIANTS = {
    "base (K1 attention)": dict(attn="kernel"),
    "plain attention": dict(attn="plain"),
    "attn=none": dict(attn="none"),
    "no adaln": dict(adaln=False),
    "no rope": dict(rope=False),
    "no qknorm": dict(qknorm=False),
    "no out_gate": dict(out_gate=False),
    "head-major transposes": dict(head_major=True),
    "bare (attn none, no extras)": dict(attn="none", adaln=False, rope=False, qknorm=False,
                                        out_gate=False),
}


def make_fwd(cfg, *, attn: str = "kernel", adaln: bool = True, rope: bool = True,
             qknorm: bool = True, out_gate: bool = True, head_major: bool = False):
    """The grouped trunk forward of `models/dit.py:_dit_forward_grouped`
    with one feature switched off or changed. attn: "kernel" (K1), "plain"
    (its plain PyTorch version) or "none" (v passes through); head_major
    transposes q, k, v to (G, B, H, S, D) before the attention and back, as
    the JAX package lays them out, where the port hands K1 strides."""
    from echo_tts_tpu_torch.core.layers import (
        modulate_rms,
        precompute_adaln,
        rms_norm,
        timestep_embedding,
    )
    from echo_tts_tpu_torch.core.rope import apply_rope_half_heads, precompute_rope
    from echo_tts_tpu_torch.models.dit import _mask_bias, layer_slices
    from echo_tts_tpu_torch.ops.joint_attention import joint_attention, joint_attention_plain

    h_, dh, eps = cfg.num_heads, cfg.head_dim, cfg.norm_eps
    attend = joint_attention if attn == "kernel" else joint_attention_plain

    def fwd(params, x, t, text_mask, spk_mask, kv_text, kv_speaker):
        g, b, s, _ = x.shape
        cos, sin = precompute_rope(dh, s, device=x.device)
        cm = params["cond_module"]
        cond = timestep_embedding(t, cfg.timestep_embed_size)
        cond = F.silu(cond @ cm["w0"])
        cond = F.silu(cond @ cm["w1"])
        cond = (cond @ cm["w2"])[:, None]
        x = x @ params["in_proj"]["w"] + params["in_proj"]["b"]
        blocks = params["blocks"]
        a_mod = precompute_adaln(cond, blocks["attention_adaln"])
        m_mod = precompute_adaln(cond, blocks["mlp_adaln"])
        text_bias, spk_bias = _mask_bias(text_mask), _mask_bias(spk_mask)
        for l, p in enumerate(layer_slices({"attention": blocks["attention"],
                                            "mlp": blocks["mlp"]})):
            a = p["attention"]
            if adaln:
                h, gate_a = modulate_rms(x, a_mod[0][l], a_mod[1][l], eps), a_mod[2][l]
            else:
                h, gate_a = rms_norm(x, params["out_norm"], eps), 1.0
            q = (h @ a["wq"]).reshape(g, b, s, h_, dh)
            k = (h @ a["wk"]).reshape(g, b, s, h_, dh)
            v = (h @ a["wv"]).reshape(g, b, s, h_, dh)
            gate = h @ a["gate"]
            if qknorm:
                q, k = rms_norm(q, a["q_norm"], eps), rms_norm(k, a["k_norm"], eps)
            if rope:
                q, k = apply_rope_half_heads(q, cos, sin), apply_rope_half_heads(k, cos, sin)
            if attn == "none":
                o = v
            else:
                segs = [(kv_text[0][l], kv_text[1][l], text_bias, None),
                        (kv_speaker[0][l], kv_speaker[1][l], spk_bias, None)]
                if head_major:
                    hm = [y.transpose(2, 3).contiguous() for y in (q, k, v)]
                    o = attend(*hm, segs, layout="hm").transpose(2, 3)
                else:
                    o = attend(q, k, v, segs, layout="sm")
            o = o.reshape(g, b, s, h_ * dh)
            if out_gate:
                o = o * torch.sigmoid(gate)
            x = x + gate_a * (o @ a["wo"])
            if adaln:
                h, gate_m = modulate_rms(x, m_mod[0][l], m_mod[1][l], eps), m_mod[2][l]
            else:
                h, gate_m = rms_norm(x, params["out_norm"], eps), 1.0
            mlp = p["mlp"]
            x = x + gate_m * ((F.silu(h @ mlp["w1"]) * (h @ mlp["w3"])) @ mlp["w2"])
        x = rms_norm(x, params["out_norm"], eps)
        return (x @ params["out_proj"]["w"] + params["out_proj"]["b"]).float()

    return fwd


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from echo_tts_tpu_torch.bench.init_ae import init_ae_params
    from echo_tts_tpu_torch.bench.timing import card_line, cuda_times, entry_device
    from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig
    from echo_tts_tpu_torch.models import s1dac
    from echo_tts_tpu_torch.models.dit import (
        get_kv_cache_speaker,
        get_kv_cache_text,
        init_dit_params,
    )
    from echo_tts_tpu_torch.ops.res_chain import res_units_cl

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dec-only", action="store_true", help="the decoder stages alone")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true", help="the tiny configs (a rehearsal)")
    args = ap.parse_args(argv)
    dev = entry_device(args.cpu)
    cfg, ae_cfg = DiTConfig(has_latent_modules=False), AEConfig()
    seq, text, spk, dtype = SEQ, TEXT, SPK, torch.bfloat16
    if args.tiny:
        cfg, ae_cfg, seq, text, spk = cfg.tiny(), ae_cfg.tiny(), 16, 24, 32
        dtype = torch.float32 if dev.type == "cpu" else dtype
    print(f"# card: {card_line(dev)}", file=sys.stderr)
    res = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(name, fn):
        res[name] = cuda_times(fn, device=dev)["ms"]
        print(f"{name:46s} {res[name]:9.3f} ms", file=sys.stderr)

    with torch.no_grad():
        if not args.dec_only:
            params = init_dit_params(cfg, dtype, dev, seed=0)
            ids = torch.randint(0, 256, (1, text), generator=gen, device=dev)
            tmask = torch.ones((1, text), dtype=torch.bool, device=dev)
            slat = torch.randn((1, spk, cfg.latent_size), generator=gen, device=dev).to(dtype)
            kv_text = get_kv_cache_text(params, cfg, ids, tmask)
            kv_speaker = get_kv_cache_speaker(params, cfg, slat)
            n_spk = spk // cfg.speaker_patch_size
            text_m = tmask[None].expand(G, 1, text)
            spk_m = torch.ones((G, 1, n_spk), dtype=torch.bool, device=dev)
            x0 = torch.randn((G, 1, seq, cfg.latent_size), generator=gen, device=dev).to(dtype)
            t = torch.full((1,), 0.7, device=dev).to(dtype)
            for name, toggles in VARIANTS.items():
                fwd = make_fwd(cfg, **toggles)
                timed(name, lambda fwd=fwd: fwd(params, x0, t, text_m, spk_m, kv_text,
                                                kv_speaker))
            del params, kv_text, kv_speaker
        ae = init_ae_params(ae_cfg, dtype, dev, seed=1)
        p = ae["decoder"]
        z = torch.randn((1, ae_cfg.latent_dim, 4 * seq), generator=gen, device=dev).to(dtype)
        timed(f"dec stem ({ae_cfg.latent_dim}->{ae_cfg.decoder_dim} @{4 * seq})",
              lambda: s1dac.causal_conv(z, p["stem"], kernel_size=7))
        x = s1dac.causal_conv(z, p["stem"], kernel_size=7).transpose(1, 2).contiguous()
        for i, stride in enumerate(ae_cfg.decoder_rates):
            blk = p["blocks"][i]

            def tconv(x=x, blk=blk, stride=stride):
                y = s1dac.snake_cl(x, blk["snake"].reshape(-1))
                return s1dac._causal_tconv_phase_cl(y, blk["up"]["w"], blk["up"].get("b"),
                                                    kernel_size=2 * stride, stride=stride)

            c_in, t_in = x.shape[2], x.shape[1]
            y = tconv()
            timed(f"dec blk{i} tconv {c_in}->{y.shape[2]} @{t_in}", tconv)
            x = y.contiguous()
            timed(f"dec blk{i} res x3 ch{x.shape[2]} @{x.shape[1]}",
                  lambda x=x, blk=blk: res_units_cl(x, blk["res_units"]))
            x = res_units_cl(x, blk["res_units"])
    out = {"card": card_line(dev), **res}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
