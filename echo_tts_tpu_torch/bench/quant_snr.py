"""Quality of the opt-in int8 W8A8 trunk and of the sampler levers (counterpart
of scripts/quant_snr.py): run the 40-step dual-CFG sampler twice on the same
noise and conditioning, bf16 weights against the test run (int8 weights by
default), and report the latents' relative error and SNR and the decoded
waveform's relative error as one JSON line.

    python -m echo_tts_tpu_torch.bench.quant_snr                       # int8 trunk
    python -m echo_tts_tpu_torch.bench.quant_snr --encoders            # + encoders, KV projections
    python -m echo_tts_tpu_torch.bench.quant_snr --blockwise [--first-steps 8]
    python -m echo_tts_tpu_torch.bench.quant_snr --bf16 --solver midpoint --steps 20
    python -m echo_tts_tpu_torch.bench.quant_snr --cpu --tiny          # a rehearsal

Random full-width weights from seeds 0 and 1 (DiTConfig(), AEConfig(), bf16):
the error measures the quantization scheme itself, at the model's shapes.
Flags as the JAX script's: --encoders (quantize the encoders and the
context-KV projections too), --blockwise (the streaming path, blocks 64 +
192 x 3), --uncond-cache K, --first-steps K (blockwise), --solver and
--steps (the test run's integrator), --ref-steps N (reference Euler-N),
--bf16 (the test run keeps bf16 weights: a lever's own deviation).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

SEQ, TEXT, SPK = 640, 768, 6400
TINY_SEQ, TINY_TEXT, TINY_SPK = 16, 64, 32


def inputs(cfg, device, tiny: bool = False, seed: int = 0) -> dict:
    """Text ids, masks, speaker latents and the sampler's noise, made on the
    host from `seed` (the noise is jax.random.normal(PRNGKey(seed))'s)."""
    from echo_tts_tpu_torch.sampling.euler_cfg import draw_noise

    seq, text, spk = (TINY_SEQ, TINY_TEXT, TINY_SPK) if tiny else (SEQ, TEXT, SPK)
    rng = np.random.default_rng(seed)
    return {"ids": torch.from_numpy(rng.integers(0, 256, (1, text)).astype(np.int32)).to(device),
            "tmask": torch.ones((1, text), dtype=torch.bool, device=device),
            "spk": torch.from_numpy(rng.standard_normal((1, spk, cfg.latent_size)).astype(
                np.float32)).to(device),
            "smask": torch.ones((1, spk), dtype=torch.bool, device=device),
            "noise": draw_noise(seed, (1, seq, cfg.latent_size), device), "seq": seq}


@torch.no_grad()
def run(dit_params, cfg, sc, ae_params, ae_cfg, pca, inp: dict, model_dtype,
        blockwise: bool = False):
    """(latents, audio) as fp32 numpy: one-shot sample + decode, or the
    streaming loop on blocks 64 + 192 x 3 (4 + 8 x ... at a tiny size)."""
    from echo_tts_tpu_torch.models import pca as pca_mod
    from echo_tts_tpu_torch.models import s1dac
    from echo_tts_tpu_torch.pipeline.pipeline import _block_schedule, stream_blocks_fused
    from echo_tts_tpu_torch.sampling.euler_cfg import sample_euler_cfg_independent_guidances

    seq = inp["seq"]
    if blockwise:
        first = 4 if seq < 64 else 64
        blocks = _block_schedule((first, 3 * first), seq, cfg.speaker_patch_size)
        offs = np.cumsum([0] + blocks)
        noises = [inp["noise"][:, a:b] for a, b in zip(offs[:-1], offs[1:])]
        chunks, lat = [], None
        for prefix, chunk, _, _ in stream_blocks_fused(
                dit_params, cfg, sc, ae_params, ae_cfg, pca, inp["spk"], inp["smask"],
                inp["ids"], inp["tmask"], blocks, noises, model_dtype):
            chunks.append(chunk.float().cpu().numpy())
            lat = prefix
        return lat.float().cpu().numpy(), np.concatenate(chunks, axis=-1)
    lat = sample_euler_cfg_independent_guidances(
        dit_params, cfg, sc, inp["spk"], inp["smask"], inp["ids"], inp["tmask"], inp["noise"],
        model_dtype=model_dtype)
    z_q = pca_mod.deproject(pca, lat).to(s1dac.params_dtype(ae_params))
    audio = s1dac.decode_zq(ae_params, ae_cfg, z_q)
    return lat.float().cpu().numpy(), audio.float().cpu().numpy()


def compare(test, ref) -> dict:
    """{latent_rel_l2, latent_snr_db, waveform_rel_l2} of (lat, audio) pairs."""
    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))

    lat_rel = rel(test[0], ref[0])
    return {"latent_rel_l2": lat_rel, "latent_snr_db": float(-20.0 * math.log10(lat_rel + 1e-12)),
            "waveform_rel_l2": rel(test[1], ref[1])}


def metric_name(encoders=False, blockwise=False, uncond_k=1, first_steps=None, solver="euler",
                test_steps=None, ref_steps=None, bf16_test=False, num_steps=40) -> str:
    return (("bf16" if bf16_test else "int8 W8A8 trunk")
            + ("+encoders" if encoders else "")
            + (f"+uncond-cache k={uncond_k}" if uncond_k > 1 else "")
            + (f"+first-block {first_steps} steps" if first_steps else "")
            + (f"+{solver}-{test_steps or num_steps}" if solver != "euler" or test_steps else "")
            + (f" vs bf16 euler-{ref_steps}, " if ref_steps else " vs bf16 exact, ")
            + ("blockwise 64+192x3 streaming" if blockwise else f"exact {num_steps}-step sampler")
            + ", same noise")


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU (plain versions)")
    ap.add_argument("--tiny", action="store_true", help="tiny configs, for a rehearsal")
    ap.add_argument("--encoders", action="store_true",
                    help="also quantize the encoders and the context-KV projections")
    ap.add_argument("--blockwise", action="store_true", help="the streaming path")
    ap.add_argument("--uncond-cache", type=int, default=1, metavar="K")
    ap.add_argument("--first-steps", type=int, default=None, metavar="K",
                    help="the first streaming block's steps (with --blockwise)")
    ap.add_argument("--solver", default="euler", choices=("euler", "midpoint"))
    ap.add_argument("--steps", type=int, default=None, help="the test run's steps")
    ap.add_argument("--ref-steps", type=int, default=None, help="the reference's Euler steps")
    ap.add_argument("--bf16", action="store_true", help="the test run keeps bf16 weights")
    args = ap.parse_args(argv)
    if args.first_steps and not args.blockwise:
        ap.error("--first-steps is a streaming knob; add --blockwise")
    approximated = (args.uncond_cache > 1 or args.first_steps or args.solver != "euler"
                    or args.steps is not None or args.ref_steps is not None)
    if args.bf16 and not approximated:
        ap.error("--bf16 without an approximation flag (--uncond-cache/--first-steps/"
                 "--solver/--steps/--ref-steps) compares a run against itself")
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from echo_tts_tpu_torch.bench.init_ae import init_ae_params
    from echo_tts_tpu_torch.bench.timing import card_line, entry_device, timing_device
    from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig, SamplerConfig
    from echo_tts_tpu_torch.models.dit import init_dit_params
    from echo_tts_tpu_torch.models.pca import PCAState
    from echo_tts_tpu_torch.models.quant import quantize_dit_params
    from echo_tts_tpu_torch.ops.int8_gemm import int8_gemm
    from echo_tts_tpu_torch.ops.quant_rows import quant_rows

    args = parse_args(argv)
    device = entry_device(args.cpu)
    cfg, ae_cfg, dtype = DiTConfig(has_latent_modules=args.blockwise), AEConfig(), torch.bfloat16
    if args.tiny:
        cfg, ae_cfg, dtype = cfg.tiny(), ae_cfg.tiny(), torch.float32
    params = init_dit_params(cfg, dtype, device, seed=0)
    ae_params = init_ae_params(ae_cfg, dtype, device, seed=1)
    pca = PCAState.random(0, ae_cfg.latent_dim, cfg.latent_size, device=device)
    inp = inputs(cfg, device, args.tiny)
    sc = SamplerConfig(num_steps=40, cfg_scale_text=3.0, cfg_scale_speaker=8.0, cfg_min_t=0.5,
                       cfg_max_t=1.0, truncation_factor=0.8, sequence_length=inp["seq"])
    sc_test = dataclasses.replace(sc, uncond_cache_interval=args.uncond_cache,
                                  first_block_steps=args.first_steps, solver=args.solver,
                                  num_steps=args.steps or sc.num_steps)
    sc_ref = dataclasses.replace(sc, num_steps=args.ref_steps) if args.ref_steps else sc
    t0 = time.perf_counter()
    with torch.no_grad():
        qparams = params if args.bf16 else quantize_dit_params(params, encoders=args.encoders)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    quant_s = time.perf_counter() - t0
    before = (int8_gemm.launches, quant_rows.launches)
    t0 = time.perf_counter()
    ref = run(params, cfg, sc_ref, ae_params, ae_cfg, pca, inp, dtype, args.blockwise)
    test = run(qparams, cfg, sc_test, ae_params, ae_cfg, pca, inp, dtype, args.blockwise)
    seconds = time.perf_counter() - t0
    print(f"# two samples + decodes in {seconds:.1f} s, quantization {quant_s:.3f} s",
          file=sys.stderr)
    res = {"bench": "quant_snr", "device": timing_device(device), "card": card_line(device),
           "metric": metric_name(args.encoders, args.blockwise, args.uncond_cache,
                                 args.first_steps, args.solver, args.steps, args.ref_steps,
                                 args.bf16),
           **compare(test, ref), "quantize_s": quant_s, "seconds": seconds,
           "launches": {"int8_gemm": int8_gemm.launches - before[0],
                        "quant_rows": quant_rows.launches - before[1]}}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
