"""One-shot requests from a closed loop of clients through
`Engine.generate` (the micro-batcher, then `sample_pipeline_batch`): each
client sends its next request when the last one returns. After the window
the program is freed and a sample of the served rows is checked against
the float32 reference, which re-derives every row from its text, prompt
audio and seed."""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark.runners import common
from benchmark.harness import flops, program, textgen
from benchmark.harness.spans import Spans
from benchmark.reference import ae as ref_ae
from benchmark.reference import dit as ref_dit
from benchmark.reference import jax_random
from benchmark.reference.text import flattening_point, text_ids


def _concurrently(reqs, fn):
    """fn(r) for every r on threads of their own, started together (one
    micro-batch); raises the first failure."""
    errs = []

    def one(r):
        try:
            fn(r)
        except Exception as e:
            errs.append(e)

    ths = [threading.Thread(target=one, args=(r,), daemon=True) for r in reqs]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    if errs:
        raise errs[0]


def warm_requests(ctx, pool):
    """One batch of the cell's shape: every preset voice (they stay in the
    speaker cache) and fresh prompts for the rest of the rows."""
    t = ctx.traffic
    out = []
    for i in range(t["max_batch"]):
        spk = pool[i] if i < len(pool) else textgen.prompt(
            ctx.seed, 300, i, lo_s=t["prompt_s"][0], hi_s=t["prompt_s"][1])
        out.append({"text": textgen.text(ctx.seed, 900, i), "speaker": spk,
                    "seed": textgen.request_seed(ctx.seed, 900, i)})
    return out


def request_work(cfg: dict, sc: dict, r: dict, block_sizes=None) -> float:
    """Model operations of one request (harness/flops.py), with the encode
    of a prompt heard for the first time."""
    from benchmark.reference.text import normalize

    a, c = cfg["ae"], cfg["dit"]
    fl = ref_ae.frame_length(a)
    n_text = min(len(normalize(r["text"]).encode()) + 1, cfg["pipeline"]["max_text_length"])
    n_spk = r["speaker"].shape[1] // fl
    n_spk -= n_spk % c["speaker_patch_size"]
    f = flops.request_flops(c, a, sc, n_text, n_spk, block_sizes)
    if r.get("voice", 0) < 0:
        f += flops.ae_encode_flops(a, r["speaker"].shape[1])
    return f


class Reference:
    """The float32 reference on the weights made again from the seed, with
    TF32 off; `prec` "fp8" is the control (every product's operands rounded
    to float8), "fp8-dit" the same in the DiT alone (the codec in float32)."""

    def __init__(self, ctx, prec: str = "fp32"):
        from benchmark.harness.weights import make_weights

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.ctx, self.cfg = ctx, ctx.config
        w = make_weights(self.cfg, ctx.seed, ctx.device)
        self.dit, self.ae, self.pca = ref_dit.f32_tree(w["dit"]), ref_dit.f32_tree(w["ae"]), w["pca"]
        self.P = ref_dit.Prec("fp8" if prec == "fp8-dit" else prec)
        self.P_ae = ref_dit.Prec("fp32" if prec == "fp8-dit" else prec)

    def speaker(self, prompt: np.ndarray, bucket=None):
        """A prompt's (latent (1, n or bucket, 80), mask): whole frames and
        patches, encoded in the pipeline's chunks."""
        c, a, pc = self.cfg["dit"], self.cfg["ae"], self.cfg["pipeline"]
        fl = ref_ae.frame_length(a)
        n = min(prompt.shape[1] // fl, pc["max_speaker_latent_length"])
        n -= n % c["speaker_patch_size"]
        if bucket is None:
            bucket = n
        with torch.no_grad():
            return ref_ae.speaker_latent(self.ae, a, self.pca, prompt[:, :(n + 1) * fl - 1],
                                         bucket, self.P_ae, chunk_latents=pc["audio_chunk_latents"],
                                         patch=c["speaker_patch_size"])

    def audio(self, rows, sc: dict, block_sizes=None):
        """Each row's (text, prompt, seed) audio: its own prompt encode, the
        sampler (blockwise when `block_sizes`), PCA, decode and crop.
        Returns (the audio, the sampler's latents (T, C) and the crop in
        frames of each row)."""
        from benchmark.harness.weights import DTYPES

        c, a, pc = self.cfg["dit"], self.cfg["ae"], self.cfg["pipeline"]
        fl = ref_ae.frame_length(a)
        dev = self.ctx.device
        ids, tms, lats, sms, noise = [], [], [], [], []
        for r in rows:
            i, m = text_ids(r["text"], max(pc["text_buckets"]))
            ids.append(i)
            tms.append(m)
            n = min(r["speaker"].shape[1] // fl, pc["max_speaker_latent_length"])
            n -= n % c["speaker_patch_size"]
            bucket = min([b for b in pc["speaker_buckets"] if b >= n]
                         or [max(pc["speaker_buckets"])])
            lat, sm = self.speaker(r["speaker"], bucket)
            lats.append(lat)
            sms.append(sm)
            noise.append(jax_random.normal(r["seed"], (sc["sequence_length"], c["latent_size"])))
        s_len = max(x.shape[1] for x in lats)
        lat = torch.cat([torch.nn.functional.pad(x, (0, 0, 0, s_len - x.shape[1])) for x in lats])
        sm = torch.cat([torch.nn.functional.pad(x, (0, s_len - x.shape[1])) for x in sms])
        args = (torch.as_tensor(np.stack(noise), device=dev),
                torch.as_tensor(np.concatenate(ids), device=dev),
                torch.as_tensor(np.concatenate(tms), device=dev), lat, sm)
        tdt = DTYPES[self.cfg["dtype"]]
        with torch.no_grad():
            if block_sizes:
                x = ref_dit.sample_blockwise(self.dit, c, sc, *args, block_sizes, self.P,
                                             time_dtype=tdt)
            else:
                x = ref_dit.sample_oneshot(self.dit, c, sc, *args, self.P, time_dtype=tdt)
            out, fps = [], []
            for i in range(len(rows)):
                audio = ref_ae.decode_zq(self.ae, a, ref_ae.pca_deproject(self.pca, x[i:i + 1]),
                                         self.P_ae)
                fps.append(flattening_point(x[i]))
                out.append(audio[0, 0, :fps[-1] * fl].cpu().numpy())
        return out, list(x.float().cpu().numpy()), fps


def compare(ctx, rows, ref_out, speakers, ref):
    """The served rows' audio against the reference's (the widest relative
    L2 gap, and any length that differs); their sampler latents against the
    reference's (the widest relative L2 gap: the DiT trunk's work by itself,
    where the audio's gap is mostly the codec's rounding); and the prompts'
    latents as the program's codec encoded them (its speaker cache) against
    the reference's, frame by frame (`common.frame_gaps`: float32 and
    bfloat16 pick other residual VQ codes for about 40 % of the frames,
    which no precision fixes; the frames whose codes agree set the 25th
    percentile). Returns (the checks, each row's audio gap)."""
    lim = ctx.limits
    ref_audio, ref_lat, fps = ref_out
    rel = [common.rel_l2(r["audio"], ra) for r, ra in zip(rows, ref_audio)]
    mism = sum(int(r["audio"].size != ra.size) for r, ra in zip(rows, ref_audio))
    gaps = [common.frame_gaps(lat, ref.speaker(p)[0][0], n) for p, lat, n in speakers]
    checks = {"audio_rel_l2": {"value": max(rel), "limit": lim["audio_rel_l2"]},
              "latent_rel_l2": {"value": common.latent_gap(rows, ref_lat, fps),
                                "limit": lim["latent_rel_l2"]},
              "length_mismatch": {"value": mism, "limit": lim["length_mismatch"]}}
    checks.update(common.frame_checks("speaker", gaps, lim))
    return checks, rel


def run(ctx) -> dict:
    t = ctx.traffic
    spans = Spans()
    tts, eng, tap, recorder = common.start_program(ctx)
    sc = program.sampler_config(t["sampler"])
    pool = common.voices(ctx)

    def gen(r):
        return eng.generate(r["text"], r["speaker"], seed=r["seed"], sc=sc)

    _concurrently(warm_requests(ctx, pool), gen)
    common.sync(ctx.device)
    tap.clear()
    h0 = eng.health()
    setup_s = time.perf_counter() - ctx.t_proc

    done, mu = [], threading.Lock()

    def work(c, j):
        r = common.request(ctx, pool, c, j)
        with spans.span("generate"):
            t_sub = time.perf_counter()
            audio, _, timings = gen(r)
            t_done = time.perf_counter()
        with mu:
            done.append(dict(r, audio=np.asarray(audio, np.float32).ravel(), t_sub=t_sub,
                             t_done=t_done, batch=timings["sample"]))

    t0, trace, errors = common.closed_loop(ctx, t["clients"], work, spans, recorder)
    h1 = eng.health()
    speakers = common.cached_speakers(eng, pool + [d["speaker"] for d in done if d["voice"] < 0])
    peak = common.memory_peak(ctx.device)
    latents = tap.by_seed()
    tap.remove()
    if recorder is not None:
        recorder.remove()
    eng.close()
    del eng, tts, tap, recorder
    common.release()

    sr = ctx.config["ae"]["sample_rate"]
    span = max(d["t_done"] for d in done) - t0 if done else float("nan")
    for d in done:
        d["latent"] = latents.get(d["seed"])
    # a batch's rows carry its one sampler wall in their timings
    batches = {}
    for d in done:
        batches.setdefault(d["batch"], []).append(d)
    rows = common.pick(ctx, list(batches.values()), t["check_rows"], key=lambda d: d["voice"] < 0)
    t_ref = time.perf_counter()
    ref = Reference(ctx)
    checks, rel = compare(ctx, rows, ref.audio(rows, t["sampler"]), speakers, ref)
    checks["unanswered"] = {"value": len(errors), "limit": 0}
    return {
        "setup_s": setup_s, "span_s": span, "audio_s": sum(d["audio"].size for d in done) / sr,
        "attempted": len(done) + len(errors), "failed": len(errors),
        "health": (h0, h1), "trace": trace, "memory_peak_bytes": peak,
        "t0": t0, "work": [(d["t_sub"], d["t_done"], request_work(ctx.config, t["sampler"], d))
                           for d in done],
        "checks": checks,
        "notes": {"requests": len(done), "errors": errors[:3],
                  "reference_s": round(time.perf_counter() - t_ref, 3),
                  "checked": [(d["client"], d["index"], d["voice"]) for d in rows],
                  "rel_per_row": rel,
                  "profiler_cost_s": trace and trace["profiler_cost_s"],
                  "device_s_by_family": trace and trace["family_s"],
                  "trace_markers": trace and trace["markers"]},
    }


def control(ctx, prec: str, block_sizes=None) -> dict:
    """The numbers a run compares, with the reference at `prec` put in the
    program's place: the first request of each of `check_rows` clients,
    and the preset voices' encode."""
    t = ctx.traffic
    pool = common.voices(ctx)
    rows = [common.request(ctx, pool, c, 0) for c in range(t["check_rows"])]
    low = Reference(ctx, prec)
    audio, lat, _ = low.audio(rows, t["sampler"], block_sizes)
    for r, a, x in zip(rows, audio, lat):
        r["audio"], r["latent"] = a, x
    speakers = []
    for p in pool:
        x = low.speaker(p)[0][0].cpu().numpy()
        speakers.append((p, x, x.shape[0]))
    del low
    common.release()
    ref = Reference(ctx)
    return compare(ctx, rows, ref.audio(rows, t["sampler"], block_sizes), speakers, ref)[0]
