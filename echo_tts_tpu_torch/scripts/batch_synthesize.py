"""Offline batch synthesis (counterpart of scripts/batch_synthesize.py): a
JSONL of requests -> one WAV each, in device batches of `--max-batch` (one
`sample_pipeline_batch` a batch), with one speaker-conditioning LRU for the
whole run, so N texts for one voice pay one AE encode; with --workers N, a
fault-tolerant multi-process fleet.

Input lines: {"id": "utt1", "text": "...", "speaker": "voice.wav"|null, "seed": 0}

    python -m echo_tts_tpu_torch.scripts.batch_synthesize --input reqs.jsonl --outdir out/ \\
        --dit dit.safetensors --ae ae.safetensors --pca pca.safetensors \\
        [--max-batch 4] [--preset NAME] [--ae-bf16] [--int8]
    python -m echo_tts_tpu_torch.scripts.batch_synthesize --input reqs.jsonl --outdir out/ \\
        --random-tiny --cpu

--random takes DiTConfig() and AEConfig() with random bf16 weights from seeds
0 and 1 (`serve --random`'s), full width on the card. On the card the DiT
and the AE run in bf16, on the CPU (--cpu) in fp32
(the AE in bf16 with --ae-bf16), as `serve --dit` loads them. Prints one
JSON line: files written, audio seconds, wall, audio-s/s, speaker encodes
and speaker-cache hits.

Fleet mode (--workers N, `parallel/fleet.py`): N worker processes of this
module each load the model and synthesize the utterances assigned to them;
this process, the coordinator, assigns the work round-robin through a
shared directory (--fleet-dir, default <outdir>/_fleet), watches their
heartbeats, and hands a dead worker's unfinished utterances to the
survivors (or synthesizes them itself when none is left). Sampling is
stateless an utterance and each WAV is written atomically and
deterministically, so a reassigned utterance finished twice is harmless
and the outputs equal a one-process run's byte for byte at --max-batch 1.
Workers on other hosts join with --worker-id and the same --fleet-dir on a
shared mount. --stale-after-s is the heartbeat window; --worker-die-after
IDX:K makes worker IDX exit abruptly after K utterances (the drill of the
tests). On one card the workers share it. The summary adds workers,
reassigned and dead_workers.

    python -m echo_tts_tpu_torch.scripts.batch_synthesize --input reqs.jsonl --outdir out/ \
        --random-tiny --cpu --workers 2 --worker-die-after 1:1 --max-batch 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import wave
from typing import Optional, Sequence


def build_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--dit")
    ap.add_argument("--ae")
    ap.add_argument("--pca")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--preset")
    ap.add_argument("--presets-file", default="sampler_presets.json")
    ap.add_argument("--ae-bf16", action="store_true")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--normalize-text", action="store_true")
    ap.add_argument("--random", action="store_true",
                    help="random full-width weights (DiTConfig(), AEConfig(), bf16)")
    ap.add_argument("--random-tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--num-steps", type=int)
    ap.add_argument("--sequence-length", type=int)
    ap.add_argument("--workers", type=int, default=0,
                    help=">0: coordinator of N worker processes, recovering from a worker's "
                         "death by reassignment")
    ap.add_argument("--stale-after-s", type=float, default=30.0,
                    help="heartbeat window before a worker is declared dead")
    ap.add_argument("--fleet-dir", help="the fleet's shared directory (default <outdir>/_fleet)")
    ap.add_argument("--worker-id", type=int, help="run as fleet worker with this id")
    ap.add_argument("--worker-die-after",
                    help="fault injection: 'IDX:K' makes worker IDX exit after K utterances")
    args = ap.parse_args(argv)
    if args.worker_id is not None and not args.fleet_dir:
        ap.error("--worker-id needs --fleet-dir")
    if args.worker_id is None and not args.input:
        ap.error("--input is required (except with --worker-id)")
    if not (args.random or args.random_tiny) and not (args.dit and args.ae and args.pca):
        ap.error("--dit, --ae and --pca are required (or --random or --random-tiny)")
    return args


def build_tts(args: argparse.Namespace):
    from echo_tts_tpu_torch.bench.timing import entry_device
    from echo_tts_tpu_torch.bench.trace import random_tts
    from echo_tts_tpu_torch.serve.__main__ import load_tts

    device = entry_device(args.cpu)
    if args.random or args.random_tiny:
        tts = random_tts(device, tiny=args.random_tiny)
    else:
        tts = load_tts(args.dit, args.ae, args.pca, device, ae_bf16=args.ae_bf16)
    if args.int8:
        from echo_tts_tpu_torch.models.quant import quantize_dit_params

        tts = dataclasses.replace(tts, dit_params=quantize_dit_params(tts.dit_params))
    return tts


def build_sc(args: argparse.Namespace):
    from echo_tts_tpu_torch.core.config import SamplerConfig
    from echo_tts_tpu_torch.serve.presets import load_sampler_presets

    sc = load_sampler_presets(args.presets_file)[args.preset] if args.preset else SamplerConfig()
    overrides = {}
    if args.num_steps:
        overrides["num_steps"] = args.num_steps
    if args.sequence_length:
        overrides["sequence_length"] = args.sequence_length
    return dataclasses.replace(sc, **overrides) if overrides else sc


class Synth:
    """The model, the speaker LRU and the decoded prompt files of one run.
    `process(items)` synthesizes one device batch and writes each WAV
    atomically (a temporary file, then os.replace)."""

    def __init__(self, args: argparse.Namespace):
        from echo_tts_tpu_torch.serve.engine import _LRUCache

        self.args = args
        self.tts = build_tts(args)
        self.sc = build_sc(args)
        self.speaker_cache = _LRUCache(16)
        self.audio_files = {}
        self.total_audio = 0.0
        self.written = []

    def batch_requests(self, items) -> list:
        """(text, speaker audio or None, seed) of each item, as
        `sample_pipeline_batch` takes them (prompt files decoded once)."""
        from echo_tts_tpu_torch.pipeline.audio_io import load_audio

        batch = []
        for r in items:
            spk = r.get("speaker")
            if spk and spk not in self.audio_files:
                self.audio_files[spk] = load_audio(spk)
            batch.append((r["text"], self.audio_files.get(spk), int(r.get("seed", 0))))
        return batch

    def process(self, items) -> None:
        from echo_tts_tpu_torch.pipeline.audio_io import write_wav
        from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline_batch

        results = sample_pipeline_batch(self.tts, self.batch_requests(items), sc=self.sc,
                                        normalize_text=self.args.normalize_text,
                                        speaker_cache=self.speaker_cache)
        sr = self.tts.ae_cfg.sample_rate
        for r, (audio, _norm, _t) in zip(items, results):
            path = os.path.join(self.args.outdir, str(r["id"]) + ".wav")
            tmp = f"{path}.tmp.{os.getpid()}"
            write_wav(tmp, audio[0], sr)
            os.replace(tmp, path)
            self.total_audio += audio.shape[-1] / sr
            self.written.append(path)


def load_requests(path: str) -> list:
    with open(path) as f:
        reqs = [json.loads(line) for line in f if line.strip()]
    for i, r in enumerate(reqs):
        r.setdefault("id", f"utt{i}")
        r["id"] = str(r["id"])
    return reqs


def _wav_seconds(path: str) -> float:
    with wave.open(path, "rb") as f:
        return f.getnframes() / f.getframerate()


def worker_main(args: argparse.Namespace) -> int:
    """A fleet worker: the first heartbeat before the model loads (liveness
    is "process up", as a large checkpoint may load for longer than the
    window), then `worker_loop` until the stop sentinel."""
    from echo_tts_tpu_torch.parallel.fleet import FleetPaths, atomic_write, worker_loop

    paths = FleetPaths(args.fleet_dir)
    atomic_write(paths.beat_file(args.worker_id), "0\n")
    os.makedirs(args.outdir, exist_ok=True)
    synth = Synth(args)
    die_after = None
    if args.worker_die_after:
        idx, k = args.worker_die_after.split(":")
        if int(idx) == args.worker_id:
            die_after = int(k)
    n = worker_loop(args.fleet_dir, args.worker_id, synth.process, max_batch=args.max_batch,
                    die_after=die_after)
    print(f"# worker {args.worker_id}: {n} utterances", file=sys.stderr)
    return n


def _passthrough(args: argparse.Namespace) -> list:
    """The model and sampler flags a worker is started with."""
    out = []
    for flag, val in (("--dit", args.dit), ("--ae", args.ae), ("--pca", args.pca),
                      ("--preset", args.preset), ("--presets-file", args.presets_file),
                      ("--num-steps", args.num_steps),
                      ("--sequence-length", args.sequence_length),
                      ("--worker-die-after", args.worker_die_after)):
        if val:
            out += [flag, str(val)]
    for flag, on in (("--ae-bf16", args.ae_bf16), ("--int8", args.int8),
                     ("--normalize-text", args.normalize_text),
                     ("--random", args.random), ("--random-tiny", args.random_tiny),
                     ("--cpu", args.cpu)):
        if on:
            out.append(flag)
    return out


def coordinator_main(args: argparse.Namespace) -> dict:
    """Start the workers, run `coordinator_loop` (local synthesis when no
    worker is left), wait for the workers to stop; returns the summary."""
    from echo_tts_tpu_torch.parallel.fleet import coordinator_loop

    reqs = load_requests(args.input)
    os.makedirs(args.outdir, exist_ok=True)
    fleet_dir = args.fleet_dir or os.path.join(args.outdir, "_fleet")
    logdir = os.path.join(fleet_dir, "logs")
    os.makedirs(logdir, exist_ok=True)
    worker_ids = list(range(args.workers))
    t0 = time.time()
    procs, logs = {}, []
    try:
        for w in worker_ids:
            logf = open(os.path.join(logdir, f"{w}.log"), "w")
            logs.append(logf)
            procs[w] = subprocess.Popen(
                [sys.executable, "-m", "echo_tts_tpu_torch.scripts.batch_synthesize",
                 "--worker-id", str(w), "--fleet-dir", fleet_dir, "--outdir", args.outdir,
                 "--max-batch", str(args.max_batch)] + _passthrough(args),
                stdout=logf, stderr=subprocess.STDOUT)
        local = {}

        def local_run(req):
            if "synth" not in local:
                print("# every worker is dead; the coordinator synthesizes", file=sys.stderr)
                local["synth"] = Synth(args)
            local["synth"].process([req])

        fleet = coordinator_loop(fleet_dir, reqs, worker_ids, procs=procs,
                                 stale_after_s=args.stale_after_s, local_run=local_run,
                                 deadline_s=3600.0)
        for p in procs.values():  # workers leave at the stop sentinel
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.terminate()
                p.wait(timeout=10)
    finally:
        for p in procs.values():  # the exact child processes, never a pattern
            if p.poll() is None:
                p.terminate()
        for f in logs:
            f.close()
    wall = time.time() - t0
    files = [os.path.join(args.outdir, r["id"] + ".wav") for r in reqs]
    audio = sum(_wav_seconds(p) for p in files if os.path.exists(p))
    summary = {
        "files": sum(os.path.exists(p) for p in files), "audio_s": round(audio, 3),
        "wall_s": round(wall, 3), "audio_s_per_s": round(audio / max(wall, 1e-9), 3),
        "workers": args.workers, "reassigned": len(fleet.reassigned),
        "dead_workers": sorted(w for w in worker_ids if procs[w].returncode not in (0, None)),
    }
    print(json.dumps(summary), flush=True)
    return summary


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the requests; returns the printed summary (a worker returns the
    number of its utterances)."""
    args = build_args(argv)
    if args.worker_id is not None:
        return worker_main(args)
    if args.workers > 0:
        return coordinator_main(args)
    reqs = load_requests(args.input)
    os.makedirs(args.outdir, exist_ok=True)
    synth = Synth(args)
    t0 = time.time()
    for lo in range(0, len(reqs), args.max_batch):
        chunk = reqs[lo:lo + args.max_batch]
        synth.process(chunk)
        print(f"# batch {lo // args.max_batch}: {len(chunk)} utterances", file=sys.stderr)
    wall = time.time() - t0
    summary = {
        "files": len(synth.written), "audio_s": round(synth.total_audio, 3),
        "wall_s": round(wall, 3),
        "audio_s_per_s": round(synth.total_audio / max(wall, 1e-9), 3),
        "speaker_encodes": synth.speaker_cache.misses,
        "speaker_cache_hits": synth.speaker_cache.hits,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
