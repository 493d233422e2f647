"""Start the HTTP TTS server (counterpart of scripts/serve.py).

    python -m echo_tts_tpu_torch.serve --dit dit.safetensors --ae ae.safetensors \
        --pca pca_state.safetensors [--port 7860] [--ae-bf16] [--keep-blockwise]
    python -m echo_tts_tpu_torch.serve --dit ... --int8 --int8-cache q.npz  # W8A8 int8
    python -m echo_tts_tpu_torch.serve --random --port 7861           # random weights
    python -m echo_tts_tpu_torch.serve --cpu --random-tiny --port 7861
    curl -s -X POST localhost:7861/tts -d '{"text": "hello", "seed": 1}' -o out.wav

--dit/--ae/--pca load the reference's safetensors checkpoints (the DiT in
bf16 without its blockwise modules unless --keep-blockwise; the AE in bf16,
as kernel K2 takes it; on the CPU both in fp32, the AE in bf16 with
--ae-bf16). --random serves DiTConfig() with the latent
modules and AEConfig() in bf16 (random weights from seeds 0 and 1);
--random-tiny serves the tiny configs in fp32. Without --cpu it needs a CUDA
card. --int8 serves the W8A8 int8 trunk (kernels K4 and K5 on the card),
--int8-encoders the encoders and context-KV projections in int8 too;
--int8-cache keeps the quantized base in a file (quantized and saved on the
first start, loaded on the next).

--tp N serves the DiT tensor-parallel over N ranks (`parallel/mesh.py`):
this process is rank 0 and serves HTTP, and it starts ranks 1..N-1 as
processes of this module that follow its device calls (`Engine.follow`).
The process group's backend is nccl on the card and gloo with --cpu;
`--dist-backend gloo` shares one card between the ranks (nccl refuses two
ranks on one device, and says so). Every rank builds the same weights and
keeps its slice. With --max-batch M --continuous, rank 0 runs the
continuous scheduler and the followers run each of its group's device
calls (open, resize, join, step, close) on their slice.

    python -m echo_tts_tpu_torch.serve --random --tp 2 --dist-backend gloo --port 7861
    python -m echo_tts_tpu_torch.serve --random --tp 2 --dist-backend gloo --max-batch 4 \
        --continuous --port 7861
    python -m echo_tts_tpu_torch.serve --cpu --random-tiny --tp 2 --port 7861

--warmup runs every serving shape once before the server takes requests;
with --warmup-background only the no-speaker set runs first and the rest
(the speaker buckets, the batch sizes) on a thread while it serves
(/health reports `warmup_tail_running`).

--gradio serves the Gradio UI (serve/gradio_app.py) on the same engine in
place of the HTTP API; under --tp it runs on rank 0 and the other ranks
follow. Where gradio is not installed it raises RuntimeError, before any
weights are built.

    python -m echo_tts_tpu_torch.serve --random --gradio --port 7860
    python -m echo_tts_tpu_torch.serve --cpu --random-tiny --warmup --warmup-background
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional, Sequence

import torch

def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    weights = ap.add_mutually_exclusive_group(required=True)
    weights.add_argument("--random", action="store_true",
                         help="random full-width weights (DiTConfig(), AEConfig(), bf16)")
    weights.add_argument("--random-tiny", action="store_true",
                         help="random tiny weights (fp32)")
    weights.add_argument("--dit", help="the DiT's pytorch_model.safetensors")
    ap.add_argument("--ae", help="the S1-DAC's pytorch_model.safetensors (with --dit)")
    ap.add_argument("--pca", help="pca_state.safetensors (with --dit)")
    ap.add_argument("--ae-bf16", action="store_true",
                    help="the AE in bf16 on the CPU too (on the card it always is: K2 takes bf16)")
    ap.add_argument("--keep-blockwise", action="store_true",
                    help="keep the DiT's blockwise (latent) modules: streaming continuations")
    ap.add_argument("--cpu", action="store_true", help="serve on the CPU (plain versions)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--presets", default="sampler_presets.json",
                    help="sampler presets JSON (the built-in presets when the file is missing)")
    ap.add_argument("--warmup", action="store_true",
                    help="run every serving shape once before taking requests (Engine.warmup)")
    ap.add_argument("--warmup-background", action="store_true",
                    help="with --warmup: the no-speaker set before serving, the speaker "
                         "buckets and batch sizes on a thread while serving (/health reports "
                         "warmup_tail_running)")
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
                    help="npz of the quantized base: the first start quantizes and saves it, "
                         "the next loads it")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (this process serves, the others follow)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="the process group's backend under --tp: nccl on the card, gloo on "
                         "the CPU by default; gloo shares one card between ranks")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gradio", action="store_true",
                    help="serve the Gradio UI (needs gradio) in place of the HTTP API")
    args = ap.parse_args(argv)
    if args.dit and not (args.ae and args.pca):
        ap.error("--dit needs --ae and --pca")
    return args


def load_tts(dit: str, ae: str, pca: str, device, ae_bf16: bool = False,
             keep_blockwise: bool = False):
    """An EchoTTS on `device` from the reference's three safetensors files:
    the DiT in bf16 (fp32 on the CPU, whose matmuls have no bf16 product
    with fp32 accumulation), without its blockwise modules unless
    keep_blockwise; the AE in bf16 on the card (kernel K2 takes bf16
    activations), in fp32 on the CPU unless ae_bf16."""
    from echo_tts_tpu_torch.checkpoints.io import (
        load_ae_from_safetensors,
        load_dit_from_safetensors,
    )
    from echo_tts_tpu_torch.models.pca import PCAState
    from echo_tts_tpu_torch.pipeline.pipeline import EchoTTS

    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    dit_params, dit_cfg = load_dit_from_safetensors(
        dit, dtype=dtype, delete_blockwise_modules=not keep_blockwise, device=device)
    ae_dtype = torch.bfloat16 if ae_bf16 or device.type == "cuda" else torch.float32
    ae_params, ae_cfg = load_ae_from_safetensors(ae, dtype=ae_dtype, device=device)
    return EchoTTS(dit_params, dit_cfg, ae_params, ae_cfg,
                   PCAState.from_safetensors(pca, device=device), model_dtype=dtype,
                   device=device)


def build_engine(args: argparse.Namespace, mesh=None):
    """The Engine the flags describe, on this rank's device and slice of
    `mesh` when given."""
    from echo_tts_tpu_torch.bench.timing import entry_device
    from echo_tts_tpu_torch.bench.trace import random_tts
    from echo_tts_tpu_torch.serve.engine import Engine

    device = mesh.device if mesh is not None else entry_device(args.cpu)
    if args.dit:
        tts = load_tts(args.dit, args.ae, args.pca, device, ae_bf16=args.ae_bf16,
                       keep_blockwise=args.keep_blockwise)
    else:
        tts = random_tts(device, tiny=args.random_tiny)
    return Engine(tts, int8=args.int8, int8_encoders=args.int8_encoders,
                  max_batch=args.max_batch, batch_wait_ms=args.batch_wait_ms,
                  continuous=args.continuous, continuous_block=args.continuous_block,
                  continuous_fast_join=not args.no_fast_join,
                  int8_cache_path=args.int8_cache, mesh=mesh)


def _rank_device(args: argparse.Namespace, rank: int) -> torch.device:
    from echo_tts_tpu_torch.bench.timing import entry_device

    dev = entry_device(args.cpu)
    return dev if dev.type == "cpu" else torch.device("cuda", rank % torch.cuda.device_count())


def _exit_with_parent() -> None:
    """A follower ends when the process that started it is gone (a server
    killed without its shutdown would leave it waiting forever)."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True, name="echo-tts-parent-watch").start()


def _run_rank(args: argparse.Namespace, rank: int, init: str) -> None:
    """Rank `rank` of a --tp group: join the process group, build the engine
    on this rank's slice, serve (rank 0) or follow (the others)."""
    from echo_tts_tpu_torch.core.config import MeshConfig
    from echo_tts_tpu_torch.parallel.mesh import destroy, initialize_multihost, make_mesh

    dev = _rank_device(args, rank)
    initialize_multihost(init, args.tp, rank, backend=args.dist_backend, device=dev)
    try:
        engine = build_engine(args, make_mesh(MeshConfig(dp=1, tp=args.tp), dev))
        if rank == 0:
            _serve(args, engine)
        else:
            try:
                engine.follow()
            finally:
                engine.close()
    finally:
        destroy()


def _launch_tp(args: argparse.Namespace, argv: Sequence[str]) -> None:
    """Start ranks 1..tp-1 as processes of this module, be rank 0, and stop
    the others when this one ends (SIGTERM included)."""
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    with tempfile.TemporaryDirectory(prefix="echo-tts-tp-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [subprocess.Popen([sys.executable, "-m", "echo_tts_tpu_torch.serve", *argv,
                                   "--rank", str(r), "--dist-init", init])
                 for r in range(1, args.tp)]
        try:
            _run_rank(args, 0, init)
        finally:
            for p in procs:
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.terminate()
                    p.wait(timeout=10)


def _serve(args: argparse.Namespace, engine) -> None:
    from echo_tts_tpu_torch.core.config import SamplerConfig
    from echo_tts_tpu_torch.serve.presets import load_sampler_presets
    from echo_tts_tpu_torch.serve.server import serve

    try:
        if args.warmup:
            wall = engine.warmup(SamplerConfig(),
                                 include_streaming=engine.tts.dit_cfg.has_latent_modules,
                                 background_tail=args.warmup_background)
            tail = " (background tail running)" if args.warmup_background else ""
            print(f"warmup done in {wall:.1f} s{tail}", flush=True)
        if args.gradio:
            from echo_tts_tpu_torch.serve.gradio_app import build_app

            print(f"Gradio UI on http://{args.host}:{args.port} ({engine.tts.device})",
                  flush=True)
            build_app(engine, presets_path=args.presets).launch(server_name=args.host,
                                                                server_port=args.port)
            return
        presets = (load_sampler_presets(args.presets, write_default=False)
                   if os.path.exists(args.presets) else None)
        print(f"HTTP TTS API on http://{args.host}:{args.port} "
              f"({engine.tts.device})", flush=True)
        serve(engine, host=args.host, port=args.port, presets=presets)
    finally:
        engine.close()


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.gradio:
        from echo_tts_tpu_torch.serve.gradio_app import require_gradio

        require_gradio()  # before any weights are built or ranks started
    if args.tp <= 1:
        _serve(args, build_engine(args))
    elif args.rank is None:
        _launch_tp(args, argv)
    else:
        _exit_with_parent()
        _run_rank(args, args.rank, args.dist_init)


if __name__ == "__main__":
    main()
