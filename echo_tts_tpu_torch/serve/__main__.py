"""Start the HTTP TTS server on random weights (counterpart of the
random-weight half of scripts/serve.py).

    python -m echo_tts_tpu_torch.serve --random --port 7861           # the card
    python -m echo_tts_tpu_torch.serve --random --int8 --port 7861    # W8A8 int8 trunk
    python -m echo_tts_tpu_torch.serve --cpu --random-tiny --port 7861
    curl -s -X POST localhost:7861/tts -d '{"text": "hello", "seed": 1}' -o out.wav

--random serves DiTConfig() with the latent modules and AEConfig() in bf16
(random weights from seeds 0 and 1) on the card; --random-tiny serves the
tiny configs in fp32. Without --cpu it needs a CUDA card. --int8 serves the
W8A8 int8 trunk (kernels K4 and K5 on the card), --int8-encoders the
encoders and context-KV projections in int8 too. Loading checkpoints
(--dit/--ae/--pca), a saved int8 base (--int8-cache), tensor parallelism
(--tp) and the Gradio UI (--gradio) are not ported: each raises, naming the
ROADMAP.md item it waits for.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

_NOT_PORTED = {
    "dit": "checkpoint loading is not ported yet (ROADMAP.md §1 item 9)",
    "ae": "checkpoint loading is not ported yet (ROADMAP.md §1 item 9)",
    "pca": "checkpoint loading is not ported yet (ROADMAP.md §1 item 9)",
    "int8_cache": "a saved int8 base needs checkpoint I/O, not ported yet (ROADMAP.md §1 item 9)",
    "tp": "tensor-parallel serving is not ported yet (ROADMAP.md §1 item 8)",
    "gradio": "the Gradio UI is not ported: gradio is not installed (ROADMAP.md §1 item 7)",
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    weights = ap.add_mutually_exclusive_group(required=True)
    weights.add_argument("--random", action="store_true",
                         help="random full-width weights (DiTConfig(), AEConfig(), bf16)")
    weights.add_argument("--random-tiny", action="store_true",
                         help="random tiny weights (fp32)")
    weights.add_argument("--dit", help="not ported: DiT checkpoint")
    ap.add_argument("--ae", help="not ported: AE checkpoint")
    ap.add_argument("--pca", help="not ported: PCA checkpoint")
    ap.add_argument("--cpu", action="store_true", help="serve on the CPU (plain versions)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--presets", default="sampler_presets.json",
                    help="sampler presets JSON (the built-in presets when the file is missing)")
    ap.add_argument("--warmup", action="store_true",
                    help="run every serving shape once before taking requests (Engine.warmup)")
    ap.add_argument("--max-batch", type=int, default=1,
                    help=">1 micro-batches concurrent compatible requests")
    ap.add_argument("--batch-wait-ms", type=float, default=10.0)
    ap.add_argument("--continuous", action="store_true",
                    help="block-boundary continuous groups for /tts_stream (needs --max-batch > 1)")
    ap.add_argument("--continuous-block", type=int, default=64,
                    help="the uniform latent block of a continuous group")
    ap.add_argument("--no-fast-join", action="store_true",
                    help="admit a stream without sampling its first block alone")
    ap.add_argument("--int8", action="store_true",
                    help="opt-in W8A8 int8 trunk (models/quant.py)")
    ap.add_argument("--int8-encoders", action="store_true",
                    help="--int8, and the encoders and context-KV projections in int8 too")
    ap.add_argument("--int8-cache", default=None, metavar="PATH",
                    help="not ported: a saved quantized base")
    ap.add_argument("--tp", type=int, default=1, help="not ported above 1")
    ap.add_argument("--gradio", action="store_true", help="not ported")
    return ap.parse_args(argv)


def build_engine(args: argparse.Namespace):
    """The Engine the flags describe; raises for the flags not ported."""
    from echo_tts_tpu_torch.bench.timing import entry_device
    from echo_tts_tpu_torch.bench.trace import random_tts
    from echo_tts_tpu_torch.serve.engine import Engine

    for flag in ("dit", "ae", "pca", "int8_cache", "gradio"):
        if getattr(args, flag):
            raise NotImplementedError(_NOT_PORTED[flag])
    if args.tp > 1:
        raise NotImplementedError(_NOT_PORTED["tp"])
    tts = random_tts(entry_device(args.cpu), tiny=args.random_tiny)
    return Engine(tts, int8=args.int8, int8_encoders=args.int8_encoders,
                  max_batch=args.max_batch, batch_wait_ms=args.batch_wait_ms,
                  continuous=args.continuous, continuous_block=args.continuous_block,
                  continuous_fast_join=not args.no_fast_join)


def main(argv: Optional[Sequence[str]] = None) -> None:
    from echo_tts_tpu_torch.core.config import SamplerConfig
    from echo_tts_tpu_torch.serve.presets import load_sampler_presets
    from echo_tts_tpu_torch.serve.server import serve

    args = parse_args(argv)
    engine = build_engine(args)
    try:
        if args.warmup:
            wall = engine.warmup(SamplerConfig(),
                                 include_streaming=engine.tts.dit_cfg.has_latent_modules)
            print(f"warmup done in {wall:.1f} s", flush=True)
        presets = (load_sampler_presets(args.presets, write_default=False)
                   if os.path.exists(args.presets) else None)
        print(f"HTTP TTS API on http://{args.host}:{args.port} "
              f"({engine.tts.device})", flush=True)
        serve(engine, host=args.host, port=args.port, presets=presets)
    finally:
        engine.close()


if __name__ == "__main__":
    main()
