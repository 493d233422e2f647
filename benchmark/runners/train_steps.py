"""LoRA finetuning steps through `train/loop.py:make_train_step` over
`train/data.py:batches_prefetch`, on clips pre-encoded in set-up by
`EchoTTSDataset` (kernel K2), as a finetune on one's own voice runs.

Set-up builds the one step object and drives it through its first three
steps with the window's own call and feed; the window then goes on with the
same object. The float32 reference follows those three steps on the same
batches and the same draws of t and noise: each step's loss, the first
gradient as the optimizer got it (its first moment after one step), and each
adapter's change after three. The batches carry latents the program's codec
encoded (the residual VQ picks discrete codes, which float32 and bfloat16
pick differently for many frames); that stage is checked by itself against
the reference codec."""
from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time
import wave

import numpy as np
import torch

from benchmark.runners import common
from benchmark.harness import flops, program, textgen
from benchmark.harness.profile import Slice
from benchmark.harness.spans import Spans
from benchmark.harness.weights import DTYPES, make_weights
from benchmark.reference import ae as ref_ae
from benchmark.reference import dit as ref_dit
from benchmark.reference import train as ref_train

CHECK_STEPS = 3


def _write_wav(path: str, x: np.ndarray, sr: int) -> None:
    pcm = (np.clip(x.ravel(), -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def clips(ctx, folder: str):
    """(path, text, audio as the wav holds it) of each synthetic clip."""
    t = ctx.traffic
    sr = ctx.config["ae"]["sample_rate"]
    n = t["clip_latents"] * ref_ae.frame_length(ctx.config["ae"])
    out = []
    for i in range(t["clips"]):
        x = textgen.prompt(ctx.seed, 400, i, lo_s=n / sr, hi_s=n / sr)[:, :n]
        x = np.pad(x, ((0, 0), (0, n - x.shape[1])))
        path = os.path.join(folder, f"clip{i:02d}.wav")
        _write_wav(path, x, sr)
        q = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2").astype(np.float32) / 32768.0
        out.append((path, textgen.text(ctx.seed, 401, i, lo=t["text_bytes"][0],
                                       hi=t["text_bytes"][1]), q))
    return out


def lora_init(ctx, base: dict, device) -> dict:
    """The adapters from the seed: a ~ U(±1/sqrt(in)), b = 0, float32."""
    t = ctx.traffic
    gen = torch.Generator(device=device).manual_seed((int(ctx.seed) + 17) % (1 << 63))
    out = {}
    for tgt in t["lora"]["targets"]:
        w = base
        for p in tgt.split("."):
            w = w[p]
        l, d_in, d_out = w.shape
        a = torch.empty((l, d_in, t["lora"]["rank"]), dtype=torch.float32, device=device)
        a.uniform_(-d_in ** -0.5, d_in ** -0.5, generator=gen)
        out[tgt] = {"a": a, "b": torch.zeros((l, t["lora"]["rank"], d_out), device=device)}
    return out


def _leaves(lora: dict) -> list:
    return [lora[k][n] for k in sorted(lora) for n in ("a", "b")]


def _moving(grads: list) -> list:
    """The leaves the reference's gradient moves: a norm of at least a
    thousandth of the median nonzero leaf's. The others (the text cache's
    adapters, which take no gradient, and the a-matrices while b is still
    zero) move by round-off or weight decay alone."""
    norms = [float(g.double().norm()) for g in grads]
    med = statistics.median([x for x in norms if x > 0])
    return [x >= 1e-3 * med for x in norms]


def _gap(prog: list, ref: list, keep: list) -> float:
    """Worst leaf's |‖p‖ - ‖r‖| over max(‖r‖, the median leaf's ‖r‖)."""
    rn = [float(r.double().norm()) for r in ref]
    med = statistics.median([x for x, k in zip(rn, keep) if k])
    return max(abs(float(p.double().norm()) - r) / max(r, med)
               for p, r, k in zip(prog, rn, keep) if k)


def run(ctx) -> dict:
    from echo_tts_tpu_torch.core.config import DiTConfig
    from echo_tts_tpu_torch.train import loop
    from echo_tts_tpu_torch.train.data import EchoTTSDataset, TrainingSample, batches_prefetch
    from echo_tts_tpu_torch.train.lora import LoRAConfig

    t, cfg, dev = ctx.traffic, ctx.config, ctx.device
    spans = Spans()
    folder = tempfile.mkdtemp(prefix="benchmark-clips-")
    try:
        made = clips(ctx, folder)
        w = make_weights(cfg, ctx.seed, dev)
        tts = program.echo_tts(cfg, w, dev)
        base = w["dit"]
        del w
        recorder = common.tracer(ctx)
        data = EchoTTSDataset([TrainingSample(p, txt) for p, txt, _ in made], tts.ae_params,
                              tts.ae_cfg, tts.pca, max_latent_length=t["clip_latents"])
        lc = LoRAConfig(rank=t["lora"]["rank"], alpha=t["lora"]["alpha"],
                        targets=tuple(t["lora"]["targets"]))
        tc = loop.TrainConfig(**t["optimizer"])
        lora = lora_init(ctx, base, dev)
        opt, step = loop.make_train_step(DiTConfig(**program.as_tuples(cfg["dit"])), tc,
                                         model_dtype=DTYPES[cfg["dtype"]], lora_cfg=lc)
        state = opt.init(lora)
        gen = torch.Generator(device=dev).manual_seed((int(ctx.seed) + 29) % (1 << 63))
        order = textgen.rng(ctx.seed, 7)

        def feed():
            while True:
                yield from batches_prefetch(data, t["batch"], order)

        it = feed()
        start = [x.detach().clone() for x in _leaves(lora)]
        seen, losses, g1 = [], [], None
        for k in range(CHECK_STEPS):
            batch = next(it)
            seen.append((batch, gen.get_state()))
            lora, state, loss = step(base, lora, state, gen, batch)
            losses.append(float(loss))
            if k == 0:
                g1 = [m.detach().clone() / (1 - loop.ADAM_B1) for m in state.mu]
        moved = [x.detach().clone() - s for x, s in zip(_leaves(lora), start)]
        encoded = {p: data.latent_cache[p].copy() for p, _, _ in made[:t["check_clips"]]}
        common.sync(dev)
        setup_s = time.perf_counter() - ctx.t_proc

        shapes = [tuple(base_shape(base, tgt).shape[1:]) for tgt in t["lora"]["targets"]]
        shapes *= cfg["dit"]["num_layers"]

        def step_work(b) -> float:
            rows = [(int(b["latent_mask"][i].sum()), int(b["text_mask"][i].sum()),
                     int(b["speaker_mask"][i].sum())) for i in range(len(b["latent_mask"]))]
            return flops.train_step_flops(cfg["dit"], rows, t["lora"]["rank"], shapes)

        n_steps, work = 0, []
        t0 = time.perf_counter()
        sl = None
        while time.perf_counter() < t0 + ctx.seconds:
            if recorder is not None and sl is None \
                    and time.perf_counter() >= t0 + common.slice_at(ctx):
                common.sync(dev)
                sl = Slice(recorder)
                sl.start()
                t_sl = time.perf_counter()
            with spans.span("next(batches)"):
                a = time.perf_counter()
                batch = next(it)
                b = time.perf_counter()
            with spans.span("train step"):
                lora, state, loss = step(base, lora, state, gen, batch)
            n_steps += 1
            # (start, end, operations, wait in next()): the step syncs with
            # the card (the optimizer reads it), so its end is its device end
            work.append((a, time.perf_counter(), step_work(batch), b - a))
            if sl is not None and not hasattr(sl, "t_stop") and \
                    time.perf_counter() >= t_sl + t["trace_s"]:
                sl.stop()
        common.sync(dev)
        span = time.perf_counter() - t0
        if sl is not None and not hasattr(sl, "t_stop"):
            sl.stop()
        it.close()
        trace = sl.reduce(spans) if sl is not None else None
        peak = common.memory_peak(dev)
        if recorder is not None:
            recorder.remove()
        prog = {"loss": losses, "g1": [x.cpu() for x in g1], "moved": [x.cpu() for x in moved]}
        del tts, base, lora, state, opt, step, data, g1, start, recorder
        common.release()
        audio = {p: q for p, _, q in made[:t["check_clips"]]}
        checks = compare(ctx, prog, reference_steps(ctx, seen), encoded,
                         reference_encode(ctx, audio))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return {"setup_s": setup_s, "span_s": span, "samples": n_steps * t["batch"],
            "attempted": n_steps + CHECK_STEPS, "failed": 0, "trace": trace,
            "memory_peak_bytes": peak, "t0": t0, "work": work,
            "checks": checks,
            "notes": {"steps": n_steps, "check_losses": losses,
                      "profiler_cost_s": trace and trace["profiler_cost_s"],
                      "device_s_by_family": trace and trace["family_s"],
                      "trace_markers": trace and trace["markers"]}}


def base_shape(base: dict, tgt: str):
    w = base
    for p in tgt.split("."):
        w = w[p]
    return w


def reference_steps(ctx, seen, prec: str = "fp32") -> dict:
    """The three steps again in float32 with TF32 off (`prec` "fp8": the
    control), on the batches and draws the program took: each step's loss,
    the first clipped gradient, each adapter's change, the last gradient."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, cfg, dev = ctx.traffic, ctx.config, ctx.device
    w = make_weights(cfg, ctx.seed, dev)
    lora = lora_init(ctx, w["dit"], dev)
    base = ref_dit.f32_tree(w["dit"])
    del w
    P = ref_dit.Prec(prec)
    tdt = DTYPES[cfg["dtype"]]
    o = t["optimizer"]
    opt = ref_train.AdamW(o["learning_rate"], o["warmup_steps"], o["total_steps"],
                          o["min_lr_ratio"], o["weight_decay"], o["max_grad_norm"])
    leaves = _leaves(lora)
    start = [x.clone() for x in leaves]
    scaling = t["lora"]["alpha"] / t["lora"]["rank"]
    losses, g1, g_last = [], None, None
    for k, (batch, gstate) in enumerate(seen):
        b = {n: torch.as_tensor(v, device=dev) for n, v in batch.items()}
        b["latent"], b["speaker_latent"] = b["latent"].float(), b["speaker_latent"].float()
        gen = torch.Generator(device=dev)
        gen.set_state(gstate)
        n = b["latent"].shape[0]
        tt = torch.rand(n, generator=gen, device=dev) ** 2.0
        noise = torch.randn(b["latent"].shape, generator=gen, device=dev)
        count = b["latent_mask"].sum() * b["latent"].shape[-1]
        for x in leaves:
            x.requires_grad_(True)
        grads = [torch.zeros_like(x) for x in leaves]
        total = 0.0
        step_rows = t.get("reference_rows", 4)
        for r0 in range(0, n, step_rows):
            p = ref_train.merged(base, lora, scaling)
            part = ref_train.loss_sum(p, cfg["dit"], b, tt, noise, P, tdt,
                                      slice(r0, r0 + step_rows)) / count
            # the text cache takes no gradient: its adapters get zeros
            gs = torch.autograd.grad(part, leaves, allow_unused=True)
            grads = [a if g is None else a + g for a, g in zip(grads, gs)]
            total += float(part.detach())
        for x in leaves:
            x.requires_grad_(False)
        losses.append(total)
        clipped = opt.step(leaves, grads)
        if k == 0:
            g1 = [g.detach().clone() for g in clipped]
        g_last = grads
    moved = [x.detach() - s for x, s in zip(leaves, start)]
    return {"loss": losses, "g1": g1, "moved": moved, "g_last": g_last}


def reference_encode(ctx, audio: dict, prec: str = "fp32") -> dict:
    """The reference codec's latents of each clip (path -> (T, 80))."""
    cfg, dev = ctx.config, ctx.device
    w = make_weights(cfg, ctx.seed, dev)
    ae, pca = ref_dit.f32_tree(w["ae"]), w["pca"]
    del w
    P = ref_dit.Prec(prec)
    out = {}
    with torch.no_grad():
        for path, x in audio.items():
            z = ref_ae.encode_zq(ae, cfg["ae"], torch.as_tensor(x[None], device=dev), P)
            out[path] = ref_ae.pca_project(pca, z)[0]
    return out


def compare(ctx, prog: dict, ref: dict, encoded: dict, ref_encoded: dict) -> dict:
    """Each step's loss; the first gradient and the change after three steps
    by the worst moving leaf; the encoded clips' latents against the
    reference codec's frame by frame (`common.frame_gaps`; see
    oneshot_closed.compare)."""
    lim, dev = ctx.limits, ctx.device
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    gaps = [common.frame_gaps(lat, ref_encoded[path]) for path, lat in encoded.items()]
    checks = {
        "loss_gap": {"value": loss_gap, "limit": lim["loss_gap"]},
        "grad1_gap": {"value": _gap([g.to(dev) for g in prog["g1"]], ref["g1"],
                                    _moving(ref["g1"])), "limit": lim["grad1_gap"]},
        "change_gap": {"value": _gap([m.to(dev) for m in prog["moved"]], ref["moved"],
                                     _moving(ref["g_last"])), "limit": lim["change_gap"]},
    }
    checks.update(common.frame_checks("encode", gaps, lim))
    return checks


def control(ctx, prec: str) -> dict:
    """The program's data path makes the clips' batches and the draws the
    three checked steps take; the reference at `prec` then stands in for
    the program's steps and its encode."""
    from echo_tts_tpu_torch.train.data import EchoTTSDataset, TrainingSample, batches_prefetch

    t, cfg, dev = ctx.traffic, ctx.config, ctx.device
    folder = tempfile.mkdtemp(prefix="benchmark-clips-")
    try:
        made = clips(ctx, folder)
        w = make_weights(cfg, ctx.seed, dev)
        tts = program.echo_tts(cfg, w, dev)
        del w
        data = EchoTTSDataset([TrainingSample(p, txt) for p, txt, _ in made], tts.ae_params,
                              tts.ae_cfg, tts.pca, max_latent_length=t["clip_latents"])
        gen = torch.Generator(device=dev).manual_seed((int(ctx.seed) + 29) % (1 << 63))
        it = batches_prefetch(data, t["batch"], textgen.rng(ctx.seed, 7))
        seen = []
        for _ in range(CHECK_STEPS):
            batch = next(it)
            seen.append((batch, gen.get_state()))
            torch.rand(t["batch"], generator=gen, device=dev)
            torch.randn(batch["latent"].shape, generator=gen, device=dev)
        it.close()
        del tts, data
        common.release()
        audio = {p: q for p, _, q in made[:t["check_clips"]]}
        low = reference_steps(ctx, seen, prec)
        low = {"loss": low["loss"], "g1": low["g1"], "moved": low["moved"]}
        low_enc = {p: x.cpu().numpy() for p, x in reference_encode(ctx, audio, prec).items()}
        return compare(ctx, low, reference_steps(ctx, seen), low_enc,
                       reference_encode(ctx, audio))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
