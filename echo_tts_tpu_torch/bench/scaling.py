"""Data-parallel sampling and the weak-scaling harness (counterpart of
echo_tts_tpu/bench/scaling.py).

Rows are independent utterances, so dp sampling needs no collective: each
dp rank samples its contiguous block of the requests as one
`sample_pipeline_batch`, and a row equals the same row of the one-process
batch (its noise is its own seed's, as in the batched pipeline), up to the
rounding of a batch of another size.

`run_weak_scaling` times dp=1 (rank 0 alone) against dp=N (every rank its
own rows) and gives the weak-scaling efficiency, the per-rank throughput
ratio. Ranks that share one card measure the card's sharing, not scaling:
their number is information only.

    python -m echo_tts_tpu_torch.bench.scaling --dp 2 [--backend gloo] [--cpu --tiny]

One utterance a rank, `SamplerConfig()` (2 steps at 16 latents with --tiny).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from echo_tts_tpu_torch.core.config import SamplerConfig
from echo_tts_tpu_torch.parallel.multihost import barrier
from echo_tts_tpu_torch.utils.profiling import allgather_metric

TEXT = "[S1] Weak scaling: every rank samples its own rows."


def dp_rows(n: int, mesh) -> range:
    """This dp rank's contiguous block of n rows (n a multiple of dp)."""
    if n % mesh.dp:
        raise ValueError(f"{n} rows do not divide over dp={mesh.dp}")
    per = n // mesh.dp
    return range(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)


def sample_pipeline_dp(tts, requests, mesh, sc: Optional[SamplerConfig] = None,
                       normalize_text: bool = False, speaker_cache=None) -> list:
    """This dp rank's rows of `requests` ((text, speaker audio or None,
    seed) each) through one `sample_pipeline_batch`: [(row index, (audio,
    normalized text, timings))] in row order."""
    from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline_batch

    rows = dp_rows(len(requests), mesh)
    out = sample_pipeline_batch(tts, [requests[i] for i in rows], sc=sc,
                                normalize_text=normalize_text, speaker_cache=speaker_cache)
    return list(zip(rows, out))


def _sync(tts) -> None:
    if tts.device.type == "cuda":
        torch.cuda.synchronize(tts.device)


def run_weak_scaling(tts, mesh, sc: Optional[SamplerConfig] = None,
                     utterances_per_device: int = 1, repeats: int = 2) -> dict:
    """Seconds a batch at dp=1 (rank 0 samples `utterances_per_device`
    rows, the others wait) and at dp=N (every rank its own as many), each
    after one warm-up; throughputs and the weak-scaling efficiency. Every
    rank calls it and gets the same dict."""
    from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline_batch

    sc = sc or SamplerConfig()
    n, u = mesh.dp, utterances_per_device
    reqs = [(TEXT, None, seed) for seed in range(n * u)]

    def timed(requests) -> float:
        sample_pipeline_batch(tts, requests, sc=sc)  # warm-up
        _sync(tts)
        t0 = time.perf_counter()
        for _ in range(repeats):
            sample_pipeline_batch(tts, requests, sc=sc)
        _sync(tts)
        return (time.perf_counter() - t0) / repeats

    barrier("scaling-dp1")
    t1 = timed(reqs[:u]) if mesh.rank == 0 else None
    barrier("scaling-dpN")
    tn = timed([reqs[i] for i in dp_rows(n * u, mesh)])
    t1 = allgather_metric(t1)[0]
    tn = max(allgather_metric(tn))
    thr1, thrn = u / t1, n * u / tn
    device = (torch.cuda.get_device_name(tts.device) if tts.device.type == "cuda"
              else "cpu")
    return {"devices": n, "device": device, "t_dp1_s": t1, "t_dpN_s": tn,
            "utt_per_s_dp1": thr1, "utt_per_s_dpN": thrn,
            "weak_scaling_efficiency": thrn / n / thr1}


def _rank(rank: int, args: argparse.Namespace, init: str) -> None:
    from echo_tts_tpu_torch.bench.timing import entry_device
    from echo_tts_tpu_torch.bench.trace import random_tts
    from echo_tts_tpu_torch.core.config import MeshConfig
    from echo_tts_tpu_torch.parallel.mesh import destroy, initialize_multihost, make_mesh

    dev = entry_device(args.cpu)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    initialize_multihost(init, args.dp, rank, backend=args.backend, device=dev)
    try:
        mesh = make_mesh(MeshConfig(dp=args.dp, tp=1), dev)
        sc = SamplerConfig(num_steps=2, sequence_length=16) if args.tiny else SamplerConfig()
        res = run_weak_scaling(random_tts(dev, tiny=args.tiny), mesh, sc)
        if rank == 0:
            print(json.dumps(res), flush=True)
    finally:
        destroy()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _rank, args=(args, "file://" + os.path.join(tmp, "store")), nprocs=args.dp,
            start_method="spawn")


if __name__ == "__main__":
    main()
