"""Arrival-trace serving bench (counterpart of echo_tts_tpu/bench/trace.py):
drive an `Engine` with a Poisson arrival process of streaming requests and
report what an operator reads: time to first audio (TTFA) and completion
p50/p95, and the achieved audio-s/s, for one serving mode at one offered
load.

    python -m echo_tts_tpu_torch.bench.trace [--continuous] [--n 6] [--rate 0.5]
    python -m echo_tts_tpu_torch.bench.trace --cpu --tiny

`main` serves random full-width weights (DiTConfig() with the latent
modules, AEConfig(), bf16, from seeds 0/1) on the card; it needs a CUDA card
unless `--cpu` is given (a rehearsal on the host's clock; `--tiny` takes the
tiny configs). One JSON line goes to stdout.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

# mixed text lengths, all inside one 768-byte text bucket
_TEXTS = [
    "A short line.",
    "A mid-length sentence that a typical request might carry, with a few "
    "clauses and a natural pause.",
    "A long paragraph of the kind long-form narration produces: several "
    "sentences in a row, enough bytes to sit near the middle of the text "
    "bucket, with clauses, asides, and a steady rhythm that keeps the "
    "token count up without hitting the cap. The quick brown fox jumps "
    "over the lazy dog while the band plays on.",
]


class _Result:
    __slots__ = ("arrival_s", "ttfa_s", "done_s", "audio_s", "error")

    def __init__(self):
        self.arrival_s: float = 0.0
        self.ttfa_s: Optional[float] = None
        self.done_s: Optional[float] = None
        self.audio_s: float = 0.0
        self.error: Optional[str] = None


def _pct(vals: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(vals), q)) if vals else float("nan")


def run_trace(engine, sc, n_requests: int, rate_hz: float, block_size=(64, 192), seed: int = 0,
              timeout_s: float = 1800.0, block_size_mix=None) -> dict:
    """Submit `n_requests` streaming requests at Poisson rate `rate_hz`
    (exponential inter-arrivals from `seed`) to `engine` on threads of their
    own, and measure each one's arrival -> first chunk (TTFA) and arrival
    -> last chunk (completion). Texts cycle through mixed lengths; request
    i has seed 1000 + i. block_size_mix: request i takes
    block_size_mix[i % len] (several keys: groups of their own).
    Throughput is the audio emitted over the makespan (first arrival to
    last completion), queueing included. A client still running after
    `timeout_s` counts in n_hung. Returns the summary dict."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, size=n_requests))
    results = [_Result() for _ in range(n_requests)]
    sr = engine.tts.ae_cfg.sample_rate
    t0 = time.perf_counter()

    def client(i: int):
        r = results[i]
        r.arrival_s = time.perf_counter() - t0
        samples = 0
        bs_i = block_size if block_size_mix is None else block_size_mix[i % len(block_size_mix)]
        try:
            for chunk in engine.generate_stream(_TEXTS[i % len(_TEXTS)], None, seed=1000 + i,
                                                sc=sc, block_size=bs_i):
                if r.ttfa_s is None:
                    r.ttfa_s = time.perf_counter() - t0 - r.arrival_s
                samples += chunk.shape[-1]
            r.done_s = time.perf_counter() - t0
            r.audio_s = samples / sr
        except Exception as e:
            r.error = f"{type(e).__name__}: {e}"

    threads = []
    for i in range(n_requests):
        delay = t0 + arrivals[i] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=client, args=(i,), daemon=True, name=f"echo-tts-trace-{i}")
        t.start()
        threads.append(t)
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    hung = sum(t.is_alive() for t in threads)

    ok = [r for r in results if r.error is None and r.done_s is not None]
    errors = [r.error for r in results if r.error is not None]
    total_audio = sum(r.audio_s for r in ok)
    makespan = (max(r.done_s for r in ok) - min(r.arrival_s for r in ok) if ok
                else float("nan"))
    ttfas = [r.ttfa_s for r in ok if r.ttfa_s is not None]
    compls = [r.done_s - r.arrival_s for r in ok]
    return {
        "n_requests": n_requests,
        "n_ok": len(ok),
        "n_hung": hung,
        "errors": errors[:3],
        "offered_rate_hz": round(rate_hz, 4),
        "offered_audio_s_per_s": round(rate_hz * (total_audio / len(ok) if ok else 0.0), 3),
        "achieved_audio_s_per_s": round(total_audio / makespan, 3) if ok else None,
        "makespan_s": round(makespan, 2) if ok else None,
        "ttfa_p50_s": round(_pct(ttfas, 50), 3),
        "ttfa_p95_s": round(_pct(ttfas, 95), 3),
        "completion_p50_s": round(_pct(compls, 50), 3),
        "completion_p95_s": round(_pct(compls, 95), 3),
    }


def random_tts(device, tiny: bool):
    """An EchoTTS with random weights on `device`: the tiny configs in fp32
    (small shape buckets), or DiTConfig() (latent modules) and AEConfig()
    in bf16."""
    import torch

    from echo_tts_tpu_torch.bench.init_ae import init_ae_params
    from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig, PipelineConfig
    from echo_tts_tpu_torch.models.dit import init_dit_params
    from echo_tts_tpu_torch.models.pca import PCAState
    from echo_tts_tpu_torch.pipeline.pipeline import EchoTTS

    dit_cfg, ae_cfg = DiTConfig(), AEConfig()
    dtype, pipe = torch.bfloat16, PipelineConfig()
    if tiny:
        dit_cfg, ae_cfg, dtype = dit_cfg.tiny(), ae_cfg.tiny(), torch.float32
        pipe = PipelineConfig(max_text_length=768, text_buckets=(768,), speaker_buckets=(16, 32),
                              audio_chunk_latents=16, max_speaker_latent_length=32)
    return EchoTTS(init_dit_params(dit_cfg, dtype, device, seed=0), dit_cfg,
                   init_ae_params(ae_cfg, dtype, device, seed=1), ae_cfg,
                   PCAState.random(0, ae_cfg.latent_dim, dit_cfg.latent_size, device=device),
                   model_dtype=dtype, pipe_cfg=pipe, device=device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from echo_tts_tpu_torch.bench.timing import card_line, entry_device, timing_device
    from echo_tts_tpu_torch.core.config import SamplerConfig
    from echo_tts_tpu_torch.ops.joint_attention import joint_attention
    from echo_tts_tpu_torch.ops.res_chain import res_units_cl
    from echo_tts_tpu_torch.serve.engine import Engine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU (plain versions)")
    ap.add_argument("--tiny", action="store_true", help="tiny configs, for a rehearsal")
    ap.add_argument("--continuous", action="store_true", help="continuous groups, not dispatch")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--n", type=int, default=6, help="requests")
    ap.add_argument("--rate", type=float, default=0.5, help="offered requests a second")
    ap.add_argument("--block", type=int, default=64, help="latent block size")
    ap.add_argument("--seq", type=int, default=None,
                    help="latents a request (default 640, 16 with --tiny)")
    ap.add_argument("--steps", type=int, default=None,
                    help="Euler steps (default 40, 2 with --tiny)")
    args = ap.parse_args(argv)
    device = entry_device(args.cpu)
    tts = random_tts(device, args.tiny)
    sc = SamplerConfig(num_steps=args.steps or (2 if args.tiny else 40), truncation_factor=0.8,
                       sequence_length=args.seq or (16 if args.tiny else 640))
    block = min(args.block, sc.sequence_length)
    eng = Engine(tts, max_batch=args.max_batch, continuous=args.continuous,
                 continuous_block=block)
    before = {"joint_attention": joint_attention.launches, "res_chain": res_units_cl.launches}
    try:
        summary = run_trace(eng, sc, args.n, args.rate, block_size=block)
        health = eng.health()
    finally:
        eng.close()
    res = {"bench": "trace", "device": timing_device(device), "card": card_line(device),
           "mode": "continuous" if args.continuous else "dispatch",
           "max_batch": args.max_batch, "block": block, "sequence_length": sc.sequence_length,
           "num_steps": sc.num_steps, **summary, "batches": health["batches"],
           "launches": {"joint_attention": joint_attention.launches - before["joint_attention"],
                        "res_chain": res_units_cl.launches - before["res_chain"]}}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
