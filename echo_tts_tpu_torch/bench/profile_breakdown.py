"""Hot-path breakdown: where a request's device time goes.

Counterpart of `scripts/profile_breakdown.py:main`, on the port's own
`dit_forward_cfg`, `get_kv_cache_text/speaker` and `models/s1dac.py`, at full
width (DiTConfig(has_latent_modules=False), AEConfig(), bf16, random weights
from a seed) with 640 latents, 768 text tokens and a 6400-latent speaker
prompt (1600 patches). It times

  * the three-branch CFG forward and the one-branch forward;
  * a matmul skeleton with the trunk's GEMM shapes and nothing else (no
    attention, norm or RoPE) at 1920 and 640 tokens: what the library's GEMMs
    alone cost, the yardstick for the trunk (plain `@`, as the trunk's own
    projections are);
  * the text and speaker KV builds;
  * the vocoder stage by stage (post_module, upsample, decoder, whole decode);

and, for each of the forwards, the KV builds and the decode, the device time
by kernel family (K1, K2, library GEMMs, convolutions, the rest) from
torch.profiler captures (`utils/profiling.py:trace`).

    python -m echo_tts_tpu_torch.bench.profile_breakdown [--trace-dir DIR]
    python -m echo_tts_tpu_torch.bench.profile_breakdown --cpu --tiny

It needs a CUDA card unless `--cpu` is given (a rehearsal through the plain
versions on the host's clock; `--tiny` takes the tiny configs and short
sequences for it). A table goes to stderr, one JSON line to stdout. Times
are CUDA-event medians (`bench/timing.py`), written beside the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from echo_tts_tpu_torch.bench.init_ae import init_ae_params
from echo_tts_tpu_torch.bench.timing import bench_rows, card_line, entry_device, timing_device
from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig
from echo_tts_tpu_torch.models import s1dac
from echo_tts_tpu_torch.models.dit import (
    layer_slices,
    layer_weights,
    dit_forward,
    dit_forward_cfg,
    get_kv_cache_speaker,
    get_kv_cache_text,
    init_dit_params,
)
from echo_tts_tpu_torch.ops.joint_attention import joint_attention
from echo_tts_tpu_torch.ops.res_chain import res_units_cl
from echo_tts_tpu_torch.utils.profiling import device_time_by_family, speed_of_light, trace

FULL_SHAPE = dict(seq=640, text=768, spk=6400)
TINY_SHAPE = dict(seq=16, text=24, spk=32)


def matmul_skeleton(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The trunk's GEMMs on (tokens, model_size) x, layer by layer: the four
    attention projections, the output projection and the SwiGLU MLP."""
    blocks = params["blocks"]
    for p in layer_slices({"attention": blocks["attention"], "mlp": blocks["mlp"]}):
        p = layer_weights(p)
        a, m = p["attention"], p["mlp"]
        o = (x @ a["wq"] + x @ a["wk"] + x @ a["wv"] + x @ a["gate"]) @ a["wo"]
        x = x + o
        x = x + (F.silu(x @ m["w1"]) * (x @ m["w3"])) @ m["w2"]
    return x


CAPTURES = 3


def family_split(fn, trace_dir: Optional[str] = None) -> dict:
    """{family: {"ms", "launches"}} of one call of fn(): of three
    torch.profiler captures, the one with the median total. A short capture
    now and then comes out scaled as a whole: one in about twenty read 0.47x
    on every family with its launch counts intact (the profiler fits its
    clock conversion anew for every capture, and the host is shared). The
    median of three leaves such a capture out."""
    caps = []
    for i in range(CAPTURES):
        with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
            with trace(tmp if trace_dir is None else f"{trace_dir}/capture{i}") as prof:
                fn()
            caps.append(device_time_by_family(prof))
    caps.sort(key=lambda fam: sum(v["ms"] for v in fam.values()))
    return caps[len(caps) // 2]


def run(device, shape: Optional[dict] = None, *, tiny: bool = False,
        trace_dir: Optional[str] = None, file=sys.stderr) -> dict:
    shape = dict((TINY_SHAPE if tiny else FULL_SHAPE) if shape is None else shape)
    seq, text, spk = shape["seq"], shape["text"], shape["spk"]
    dit_cfg, ae_cfg = DiTConfig(has_latent_modules=False), AEConfig()
    if tiny:
        dit_cfg, ae_cfg = dit_cfg.tiny(), ae_cfg.tiny()
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    params = init_dit_params(dit_cfg, dtype, device, seed=0)
    ae = init_ae_params(ae_cfg, dtype, device, seed=1)

    gen = torch.Generator(device=device).manual_seed(0)
    ids = torch.randint(0, 256, (1, text), generator=gen, device=device)
    tmask = torch.ones(1, text, dtype=torch.bool, device=device)
    smask = torch.ones(1, spk, dtype=torch.bool, device=device)
    slat = torch.randn(1, spk, dit_cfg.latent_size, generator=gen, device=device).to(dtype)
    x0 = torch.randn(1, seq, dit_cfg.latent_size, generator=gen, device=device).to(dtype)
    zq = torch.randn(1, ae_cfg.latent_dim, seq, generator=gen, device=device).to(dtype)
    x3 = torch.randn(3 * seq, dit_cfg.model_size, generator=gen, device=device).to(dtype)
    x1 = x3[:seq].contiguous()

    def t_of(v):
        return torch.full((1,), v, device=device).to(dtype)

    with torch.no_grad():
        kv_text = get_kv_cache_text(params, dit_cfg, ids, tmask)
        kv_speaker = get_kv_cache_speaker(params, dit_cfg, slat)
        post = s1dac.quantizer_transformer(ae, ae_cfg, "post_module", zq)
        up = s1dac.quantizer_upsample(ae, ae_cfg, post)

    def kv_build():
        return (get_kv_cache_text(params, dit_cfg, ids, tmask),
                get_kv_cache_speaker(params, dit_cfg, slat))

    rows = [
        ("3-branch CFG forward", "cfg3_forward",
         lambda: dit_forward_cfg(params, dit_cfg, x0, t_of(0.7), tmask, smask, kv_text,
                                 kv_speaker)),
        ("1-branch forward", "single_forward",
         lambda: dit_forward(params, dit_cfg, x0, t_of(0.3), tmask, smask, kv_text, kv_speaker)),
        (f"matmul skeleton @{3 * seq} tok", f"skeleton_{3 * seq}tok",
         lambda: matmul_skeleton(params, x3)),
        (f"matmul skeleton @{seq} tok", f"skeleton_{seq}tok", lambda: matmul_skeleton(params, x1)),
        ("KV build (text+speaker)", "kv_build", kv_build),
        ("voc_post_module", "voc_post_module",
         lambda: s1dac.quantizer_transformer(ae, ae_cfg, "post_module", zq)),
        ("voc_upsample", "voc_upsample", lambda: s1dac.quantizer_upsample(ae, ae_cfg, post)),
        ("voc_decoder", "voc_decoder", lambda: s1dac.decoder_forward(ae, ae_cfg, up)),
        ("voc_total", "voc_total", lambda: s1dac.decode_zq(ae, ae_cfg, zq)),
    ]
    before = (joint_attention.launches, res_units_cl.launches)
    print(f"# hot-path breakdown on {card_line(device)}; shape {shape}", file=file)
    res = bench_rows([(name, fn) for name, _, fn in rows], unit="ms", device=device, file=file)
    ms = {key: res[name] for name, key, _ in rows}

    # device time by kernel family of the forwards, the KV builds and the decode
    families = {}
    for name, key, fn in rows:
        if key not in ("cfg3_forward", "single_forward", "kv_build", "voc_total"):
            continue
        fam = family_split(fn, None if trace_dir is None else f"{trace_dir}/{key}")
        families[key] = {f: {"ms": round(v["ms"], 4), "launches": v["launches"]}
                         for f, v in fam.items()}
        total = sum(v["ms"] for v in fam.values())
        print(f"{name}: device time {total:.3f} ms by family", file=file)
        for f, v in sorted(fam.items(), key=lambda kv: -kv[1]["ms"]):
            print(f"    {f:40s} {v['ms']:9.3f} ms in {v['launches']} launches", file=file)

    sol = speed_of_light(dit_cfg, 3, seq, text + spk // dit_cfg.speaker_patch_size)
    print(f"speed of light, 3-branch forward: {sol['floor_ms']:.3f} ms "
          f"({sol['flops'] / 1e12:.3f} TFLOP)", file=file)
    return {"bench": "profile_breakdown", "device": timing_device(device),
            "card": card_line(device), "shape": shape,
            "ms": {k: round(v["ms"], 4) for k, v in ms.items()},
            "spread_ms": {k: [round(v["min_ms"], 4), round(v["max_ms"], 4)]
                          for k, v in ms.items()},
            "device_ms_by_family": families,
            "speed_of_light_cfg3": {k: round(v, 4) for k, v in sol.items()},
            "launches": {"joint_attention": joint_attention.launches - before[0],
                         "res_chain": res_units_cl.launches - before[1]}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", help="keep the chrome traces under this directory")
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU (plain versions)")
    ap.add_argument("--tiny", action="store_true", help="tiny configs, for a rehearsal")
    args = ap.parse_args(argv)
    res = run(entry_device(args.cpu), tiny=args.tiny, trace_dir=args.trace_dir)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
