"""Offline batch synthesis (counterpart of scripts/batch_synthesize.py,
its single-process path): a JSONL of requests -> one WAV each, in device
batches of `--max-batch` (one `sample_pipeline_batch` a batch), with one
speaker-conditioning LRU for the whole run, so N texts for one voice pay
one AE encode.

Input lines: {"id": "utt1", "text": "...", "speaker": "voice.wav"|null, "seed": 0}

    python -m echo_tts_tpu_torch.scripts.batch_synthesize --input reqs.jsonl --outdir out/ \\
        --dit dit.safetensors --ae ae.safetensors --pca pca.safetensors \\
        [--max-batch 4] [--preset NAME] [--ae-bf16] [--int8]
    python -m echo_tts_tpu_torch.scripts.batch_synthesize --input reqs.jsonl --outdir out/ \\
        --random-tiny --cpu

On the card the DiT and the AE run in bf16, on the CPU (--cpu) in fp32
(the AE in bf16 with --ae-bf16), as `serve --dit` loads them. Prints one
JSON line: files written, audio seconds, wall, audio-s/s, speaker encodes
and speaker-cache hits. The fleet mode (--workers and the flags of its
workers) is multi-process and not ported: it raises, naming ROADMAP.md §1
item 8.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional, Sequence

_FLEET = ("the fleet mode (--workers, --worker-id, --fleet-dir, --stale-after-s, "
          "--worker-die-after: parallel/fleet.py) is not ported yet (ROADMAP.md §1 item 8)")


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
    ap.add_argument("--random-tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--num-steps", type=int)
    ap.add_argument("--sequence-length", type=int)
    ap.add_argument("--workers", type=int, default=0, help="fleet mode: not ported above 0")
    for flag in ("--stale-after-s", "--fleet-dir", "--worker-id", "--worker-die-after"):
        ap.add_argument(flag, help="fleet mode: not ported")
    args = ap.parse_args(argv)
    if args.workers > 0 or any(getattr(args, k) is not None for k in (
            "stale_after_s", "fleet_dir", "worker_id", "worker_die_after")):
        raise NotImplementedError(_FLEET)
    if not args.input:
        ap.error("--input is required")
    if not args.random_tiny and not (args.dit and args.ae and args.pca):
        ap.error("--dit, --ae and --pca are required (or --random-tiny)")
    return args


def build_tts(args: argparse.Namespace):
    from echo_tts_tpu_torch.bench.timing import entry_device
    from echo_tts_tpu_torch.bench.trace import random_tts
    from echo_tts_tpu_torch.serve.__main__ import load_tts

    device = entry_device(args.cpu)
    if args.random_tiny:
        tts = random_tts(device, tiny=True)
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


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the requests; returns the printed summary."""
    args = build_args(argv)
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
