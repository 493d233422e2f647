"""Pieces the runners share: the program's engine on the benchmark's
weights, the closed-loop clients, the traced slice, freeing the program
before the reference runs, and the comparison of one output."""
from __future__ import annotations

import gc
import hashlib
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from benchmark.harness import program, textgen
from benchmark.harness.profile import Recorder, Slice
from benchmark.harness.spans import Spans
from benchmark.harness.tap import LatentTap
from benchmark.harness.weights import make_weights


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def engine(ctx, tts):
    from echo_tts_tpu_torch.serve.engine import Engine

    t = ctx.traffic
    return Engine(tts, max_batch=t["max_batch"], batch_wait_ms=t["batch_wait_ms"],
                  speaker_cache_size=t["speaker_cache"])


def voices(ctx) -> List[np.ndarray]:
    t = ctx.traffic
    return [textgen.prompt(ctx.seed, 100, i, lo_s=t["prompt_s"][0], hi_s=t["prompt_s"][1])
            for i in range(t["voices"])]


def request(ctx, pool, c: int, j: int) -> dict:
    """Client c's j-th request: its text, prompt and seed from the run's
    seed. Every `fresh_every`-th request of a client (offset by the client)
    brings a prompt never heard before; the rest pick a preset voice."""
    t = ctx.traffic
    every = t.get("fresh_every", 0)
    fresh = bool(every) and (c + j) % every == every - 1
    if fresh:
        spk, voice = textgen.prompt(ctx.seed, 200, c, j, lo_s=t["prompt_s"][0],
                                    hi_s=t["prompt_s"][1]), -1
    else:
        voice = int(textgen.rng(ctx.seed, 5, c, j).integers(len(pool)))
        spk = pool[voice]
    return {"text": textgen.text(ctx.seed, c, j, lo=t["text_bytes"][0], hi=t["text_bytes"][1]),
            "speaker": spk, "voice": voice, "seed": textgen.request_seed(ctx.seed, c, j),
            "client": c, "index": j}


def start_program(ctx):
    """The weights from the seed, the program's container and engine, the
    tap on the sampler's latents, and (in a traced run on the card) the K1/K3
    recorder. Returns (tts, engine, tap, recorder or None)."""
    w = make_weights(ctx.config, ctx.seed, ctx.device)
    tts = program.echo_tts(ctx.config, w, ctx.device)
    tap = LatentTap()
    tap.install()
    return tts, engine(ctx, tts), tap, tracer(ctx)


def tracer(ctx) -> Optional[Recorder]:
    """The K1/K3 recorder, installed, and the profiler warmed, in a traced
    run on the card; None otherwise (an untraced window runs the program's
    launches as they are)."""
    if not (ctx.trace and torch.device(ctx.device).type == "cuda"):
        return None
    rec = Recorder()
    rec.install()
    Slice.warm()
    return rec


PROFILER_STOP_S = 5.0  # the profiler's stop holds the host for up to ~4 s


def slice_at(ctx) -> float:
    """Seconds into the window at which the traced slice begins: the
    traffic's `trace_at_s`, earlier in a window too short to hold it and
    the profiler's stop before the window closes."""
    t = ctx.traffic
    return max(0.0, min(t["trace_at_s"], ctx.seconds - t["trace_s"] - PROFILER_STOP_S))


def closed_loop(ctx, clients: int, work: Callable[[int, int], None], spans: Spans,
                recorder: Optional[Recorder]):
    """`clients` threads each call work(c, j) for j = 0, 1, ... until
    --seconds have passed since the start, then finish what they began.
    With --trace, a slice of the window is profiled. Returns (t0, the
    reduced slice or None, the failures)."""
    t = ctx.traffic
    go = threading.Event()
    t0 = [0.0]
    errors = []

    def client(c):
        go.wait()
        j = 0
        while time.perf_counter() < t0[0] + ctx.seconds:
            try:
                work(c, j)
            except Exception as e:  # a failed request is counted, the client goes on
                errors.append(f"{type(e).__name__}: {e}")
            j += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True, name=f"bench-client-{c}")
               for c in range(clients)]
    for th in threads:
        th.start()
    t0[0] = time.perf_counter()
    go.set()
    sl = None
    if recorder is not None:
        time.sleep(max(0.0, t0[0] + slice_at(ctx) - time.perf_counter()))
        sl = Slice(recorder)
        sl.start()
        time.sleep(t["trace_s"])
        sl.stop()
    deadline = time.monotonic() + ctx.seconds + t.get("drain_limit_s", 600)
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
    hung = sum(th.is_alive() for th in threads)
    if hung:
        errors.append(f"{hung} client(s) still waiting at the drain limit")
    reduced = sl.reduce(spans) if sl is not None else None
    return t0[0], reduced, errors


def release() -> None:
    """Give back the memory of the program's state, once the caller has
    dropped it, before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def rel_l2(got: np.ndarray, ref: np.ndarray) -> float:
    got, ref = np.asarray(got, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    n = min(got.size, ref.size)
    return float(np.linalg.norm(got[:n] - ref[:n]) / max(np.linalg.norm(ref[:n]), 1e-30))


def frame_gaps(got, ref, n_got: Optional[int] = None, far: float = 0.05):
    """Frames (T, C) of the program's codec against the reference's: the
    25th percentile over frames of |got - ref| / |ref|, the share of frames
    whose gap is over `far`, and whether the counts of valid frames differ
    (`n_got`: the program's, when `got` is padded past them)."""
    ref = torch.as_tensor(ref).float()
    got = torch.as_tensor(got).float().to(ref.device)
    n_got = got.shape[0] if n_got is None else int(n_got)
    n = min(n_got, ref.shape[0])
    e = ((got[:n] - ref[:n]).norm(dim=-1) / ref[:n].norm(dim=-1).clamp_min(1e-12)).double()
    return float(torch.quantile(e, 0.25)), float((e > far).double().mean()), n_got != ref.shape[0]


def frame_checks(prefix: str, gaps: list, lim: dict) -> dict:
    """The frame numbers of `frame_gaps` over prompts or clips, each by its
    worst: `<prefix>_q25_gap`, `<prefix>_far_share`, `<prefix>_frames_mismatch`."""
    worst = (lambda i: max(g[i] for g in gaps) if gaps else float("inf"))
    return {f"{prefix}_q25_gap": {"value": worst(0), "limit": lim[f"{prefix}_q25_gap"]},
            f"{prefix}_far_share": {"value": worst(1), "limit": lim[f"{prefix}_far_share"]},
            f"{prefix}_frames_mismatch": {"value": sum(int(g[2]) for g in gaps),
                                          "limit": lim[f"{prefix}_frames_mismatch"]}}


def latent_gap(rows, ref_lat, fps) -> float:
    """The widest relative L2 gap of a row's sampler latents to the
    reference's, over the frames the reference keeps (its crop); a row the
    tap never saw reads inf."""
    out = []
    for r, x, n in zip(rows, ref_lat, fps):
        got = r.get("latent")
        if got is None or got.shape[0] < n:
            out.append(float("inf"))
        else:
            out.append(rel_l2(got[:n], x[:n]))
    return max(out)


def cached_speakers(eng, prompts) -> list:
    """(prompt, latent (n, C), valid frames) of each prompt the engine's
    speaker cache holds at the end of the window: the latents the program's
    codec made for it. The cache is keyed by the sha1 of the prompt's
    samples."""
    by_sha = {hashlib.sha1(np.ascontiguousarray(p).tobytes()).hexdigest(): p for p in prompts}
    out = []
    for key, (lat, mask) in list(eng._speaker_cache._d.items()):
        p = by_sha.get(key[1])
        if p is not None:
            out.append((p, np.asarray(lat)[0], int(np.asarray(mask)[0].sum())))
    return out


def clusters(done: list, at: str, gap: float) -> list:
    """The requests in runs whose `at` times lie within `gap` of each other
    (a batch's rows get their first chunks together)."""
    out, cur = [], []
    for d in sorted(done, key=lambda d: d[at]):
        if cur and d[at] - cur[-1][at] > gap:
            out.append(cur)
            cur = []
        cur.append(d)
    return out + ([cur] if cur else [])


def pick(ctx, batches: list, k: int, key=None) -> list:
    """k requests of one of the largest batches, drawn from the seed, with a
    request that `key` marks where a batch has one: any half of a batch of
    8 has requests in a sample of k >= 6."""
    g = textgen.rng(ctx.seed, 6)
    size = max(len(x) for x in batches)
    cand = [x for x in batches if len(x) == size]
    if key is not None and any(key(d) for x in cand for d in x):
        cand = [x for x in cand if any(key(d) for d in x)]
    batch = cand[int(g.integers(len(cand)))]
    idx = list(g.permutation(len(batch)))
    if key is not None:
        idx.sort(key=lambda i: not key(batch[i]))
    return [batch[i] for i in idx[:k]]
