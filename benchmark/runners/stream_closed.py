"""Streams from a closed loop of clients through `Engine.generate_stream`
(the dispatcher's stream batches, `sample_pipeline_stream_batch`): each
client consumes its stream's chunks as they come and starts its next stream
when the last one ends. After the window the program is freed and a sample
of the served streams is checked against the float32 reference's blockwise
sampler and whole decode."""
from __future__ import annotations

import threading
import time

import numpy as np

from benchmark.runners import common
from benchmark.runners import oneshot_closed
from benchmark.runners.oneshot_closed import Reference, compare, request_work, warm_requests
from benchmark.harness import program
from benchmark.harness.spans import Spans


def block_schedule(sizes, budget: int) -> list:
    """[64, 192] at 640 -> [64, 192, 192, 192]: the list in order, its last
    entry repeated, the final block cut to the budget."""
    out, i = [], 0
    while budget > 0:
        out.append(min(sizes[min(i, len(sizes) - 1)], budget))
        budget -= out[-1]
        i += 1
    return out


def run(ctx) -> dict:
    t = ctx.traffic
    spans = Spans()
    tts, eng, tap, recorder = common.start_program(ctx)
    sc = program.sampler_config(t["sampler"])
    pool = common.voices(ctx)
    blocks = list(t["block_size"])

    def stream(r, on_chunk=None):
        parts = []
        for chunk in eng.generate_stream(r["text"], r["speaker"], seed=r["seed"], sc=sc,
                                         block_size=blocks):
            if on_chunk is not None:
                on_chunk()
            parts.append(np.asarray(chunk, np.float32).ravel())
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    warm = warm_requests(ctx, pool)
    ths = [threading.Thread(target=stream, args=(r,), daemon=True) for r in warm]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    common.sync(ctx.device)
    tap.clear()
    h0 = eng.health()
    setup_s = time.perf_counter() - ctx.t_proc

    done, mu = [], threading.Lock()

    def work(c, j):
        r = common.request(ctx, pool, c, j)
        first = []
        t_sub = time.perf_counter()
        with spans.span("generate_stream"):
            audio = stream(r, lambda: first or first.append(time.perf_counter()))
        t_done = time.perf_counter()
        with mu:
            done.append(dict(r, audio=audio, t_sub=t_sub, t_done=t_done,
                             t_first=first[0] if first else t_done))

    t0, trace, errors = common.closed_loop(ctx, t["clients"], work, spans, recorder)
    h1 = eng.health()
    speakers = common.cached_speakers(eng, pool)
    peak = common.memory_peak(ctx.device)
    latents = tap.by_seed()
    tap.remove()
    if recorder is not None:
        recorder.remove()
    eng.close()
    del eng, tts, tap, recorder
    common.release()
    for d in done:
        d["latent"] = latents.get(d["seed"])

    sched = block_schedule(blocks, t["sampler"]["sequence_length"])
    sr = ctx.config["ae"]["sample_rate"]
    span = max(d["t_done"] for d in done) - t0 if done else float("nan")
    rows = common.pick(ctx, common.clusters(done, "t_first", 0.05), t["check_rows"])
    t_ref = time.perf_counter()
    ref = Reference(ctx)
    checks, rel = compare(ctx, rows, ref.audio(rows, t["sampler"], sched), speakers, ref)
    checks["unanswered"] = {"value": len(errors), "limit": 0}
    return {
        "setup_s": setup_s, "span_s": span, "audio_s": sum(d["audio"].size for d in done) / sr,
        "attempted": len(done) + len(errors), "failed": len(errors),
        "health": (h0, h1), "trace": trace, "memory_peak_bytes": peak,
        "first_chunk_at": [d["t_first"] for d in done],
        "t0": t0, "work": [(d["t_sub"], d["t_done"], request_work(ctx.config, t["sampler"], d, sched))
                           for d in done],
        "ttfa": [(d["t_sub"], d["t_first"]) for d in done],
        "checks": checks,
        "notes": {"streams": len(done), "errors": errors[:3],
                  "reference_s": round(time.perf_counter() - t_ref, 3),
                  "checked": [(d["client"], d["index"], d["voice"]) for d in rows],
                  "rel_per_row": rel,
                  "profiler_cost_s": trace and trace["profiler_cost_s"],
                  "device_s_by_family": trace and trace["family_s"],
                  "trace_markers": trace and trace["markers"],
                  "ttfa_s": [round(d["t_first"] - d["t_sub"], 3) for d in done]},
    }


def control(ctx, prec: str) -> dict:
    t = ctx.traffic
    sched = block_schedule(list(t["block_size"]), t["sampler"]["sequence_length"])
    return oneshot_closed.control(ctx, prec, block_sizes=sched)

