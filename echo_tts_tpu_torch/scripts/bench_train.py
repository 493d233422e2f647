"""LoRA train-step bench at full size (counterpart of scripts/bench_train.py):
does the finetune fit one card, and what does a step take.

Shapes: batch 8, 640 target latents, 768 text bytes, 640 speaker latents,
LoRA r16 / alpha 32 on DiTConfig(has_latent_modules=False) with random bf16
weights (`bench/fast_init.py`). One warm-up step, then three timed ones,
each on a batch of its own, synchronized around the step.

    python -m echo_tts_tpu_torch.scripts.bench_train            # the card
    python -m echo_tts_tpu_torch.scripts.bench_train --cpu --tiny

Prints the JAX script's JSON line, {"metric": "LoRA train step, B=8 @640
latents", "value": ms, "unit": "ms"}; --tiny runs the tiny config at batch
2 and 32 latents (text 64, speaker 32) in fp32.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import torch


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from echo_tts_tpu_torch.bench.fast_init import fast_random_like
    from echo_tts_tpu_torch.bench.timing import entry_device
    from echo_tts_tpu_torch.core.config import DiTConfig
    from echo_tts_tpu_torch.models.dit import init_dit_params
    from echo_tts_tpu_torch.train.loop import TrainConfig, make_train_step
    from echo_tts_tpu_torch.train.lora import LoRAConfig, init_lora

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--tiny", action="store_true", help="the tiny config at small shapes")
    args = ap.parse_args(argv)
    device = entry_device(args.cpu)
    cfg = DiTConfig(has_latent_modules=False)
    b, seq, text, spk, dtype = 8, 640, 768, 640, torch.bfloat16
    if args.tiny:
        cfg, b, seq, text, spk, dtype = cfg.tiny(), 2, 32, 64, 32, torch.float32

    params = fast_random_like(lambda dev: init_dit_params(cfg, dtype, dev), seed=0, device=device)
    print("# params ready", file=sys.stderr)
    lc = LoRAConfig(rank=16, alpha=32.0)
    lora = init_lora(torch.Generator(device=device).manual_seed(1), params, lc)
    opt, step = make_train_step(cfg, TrainConfig(learning_rate=5e-5), model_dtype=dtype,
                                lora_cfg=lc)
    opt_state = opt.init(lora)
    gen = torch.Generator(device=device).manual_seed(2)

    def batch(i: int) -> dict:
        g = torch.Generator(device=device).manual_seed(100 + i)
        return {
            "latent": torch.randn(b, seq, cfg.latent_size, generator=g, device=device),
            "latent_mask": torch.ones(b, seq, dtype=torch.bool, device=device),
            "text_input_ids": torch.randint(0, 256, (b, text), generator=g, device=device),
            "text_mask": torch.ones(b, text, dtype=torch.bool, device=device),
            "speaker_latent": torch.randn(b, spk, cfg.latent_size, generator=g, device=device),
            "speaker_mask": torch.ones(b, spk, dtype=torch.bool, device=device),
        }

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    lora, opt_state, loss = step(params, lora, opt_state, gen, batch(0))
    print(f"# first step {time.perf_counter() - t0:.1f} s loss={float(loss):.4f}", file=sys.stderr)
    times = []
    for i in range(3):
        sync()
        t0 = time.perf_counter()
        lora, opt_state, loss = step(params, lora, opt_state, gen, batch(i + 1))
        float(loss)
        sync()
        times.append(time.perf_counter() - t0)
    ms = min(times) * 1e3
    print(f"# step {ms:.0f} ms, {b / min(times):.1f} samples/s, loss={float(loss):.4f}",
          file=sys.stderr)
    out = {"metric": f"LoRA train step, B={b} @{seq} latents", "value": round(ms, 1), "unit": "ms"}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
