"""Whole runs of each cell at tiny size on the CPU: the result line's
schema, `correct` on a sound program, and `correct` false with the timed
path broken underneath (the planted faults a cell can have)."""
from __future__ import annotations

import io
import json

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import TINY_AE, TINY_DIT, TINY_PIPE

SAMPLER = {"num_steps": 3, "sequence_length": 16}
CELLS = ["oneshot-b8-closed16", "stream-b8-closed8", "lora-r16-b8"]


def tiny(cell):
    cell.config["dit"].update(TINY_DIT)
    cell.config["ae"].update(TINY_AE)
    cell.config["pipeline"].update(TINY_PIPE)
    cell.config["dtype"] = "float32"
    t = cell.traffic
    if "sampler" in t:
        t["sampler"] = dict(t["sampler"], **SAMPLER)
    if "block_size" in t:  # one wave of streams at a time, as at full size
        t.update(block_size=[4, 8], clients=2)
    if "clips" in t:
        t.update(batch=2, clips=6, clip_latents=16, check_clips=2, reference_rows=1)
    for k, v in {"clients": 4, "max_batch": 2, "voices": 2, "check_rows": 2,
                 "prompt_s": [0.004, 0.009], "text_bytes": [20, 60]}.items():
        if k in t:
            t[k] = v


def go(workload, trace=0, seed=2**31 + 7, **kw):
    out = io.StringIO()
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "1.5",
                   "--trace", str(trace)], device="cpu", tweak=tiny, out=out, **kw)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    line = go(workload)
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def _wrap_audio(monkeypatch, fn):
    """Apply fn to the waveform where the pipeline produces it: the one-shot
    decode and each streamed block's decode."""
    from echo_tts_tpu_torch.pipeline import pipeline as pl

    one, block = pl._sample_and_decode, pl._sample_block_and_decode

    def one_bad(*a, **k):
        lat, audio = one(*a, **k)
        return lat, fn(audio)

    def block_bad(*a, **k):
        *state, audio = block(*a, **k)
        return (*state, fn(audio))

    monkeypatch.setattr(pl, "_sample_and_decode", one_bad)
    monkeypatch.setattr(pl, "_sample_block_and_decode", block_bad)


def _perturb_audio(monkeypatch):
    """An answer altered where it is produced."""
    _wrap_audio(monkeypatch, lambda a: a * 1.5)


def _stale_step(monkeypatch):
    """A sampler step that returns its state unchanged: every one-branch
    step (outside the CFG window) predicts zero velocity."""
    import torch

    from echo_tts_tpu_torch.sampling import euler_cfg

    orig = euler_cfg.dit_forward
    monkeypatch.setattr(euler_cfg, "dit_forward",
                        lambda *a, **k: torch.zeros_like(orig(*a, **k)))


def _half_batch(monkeypatch):
    """Half of the batch left out: each odd row gets its even neighbour's
    output."""
    def bad(audio):
        if audio.shape[0] > 1:
            audio = audio.clone()
            audio[1::2] = audio[0::2][: audio[1::2].shape[0]]
        return audio

    _wrap_audio(monkeypatch, bad)


def _stale_update(monkeypatch):
    """A training step that returns its state unchanged: AdamW never
    applies its update."""
    from echo_tts_tpu_torch.train import loop

    monkeypatch.setattr(loop.Optimizer, "_adamw", lambda self, p, g, st: None)


def _half_rows(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from echo_tts_tpu_torch.train import loop

    orig = loop.compute_diffusion_loss

    def bad(params, cfg, gen, latent, mask, ids, tmask, spk, smask, **k):
        h = latent.shape[0] // 2
        t = torch.rand(latent.shape[0], generator=gen, device=latent.device) ** 2.0
        noise = torch.randn(latent.shape, generator=gen, device=latent.device)
        return orig(params, cfg, gen, latent[:h], mask[:h], ids[:h], tmask[:h], spk[:h],
                    smask[:h], t=t[:h], noise=noise[:h], **k)

    monkeypatch.setattr(loop, "compute_diffusion_loss", bad)


def _scaled_loss(monkeypatch):
    """An answer altered where it is produced: the loss doubled."""
    from echo_tts_tpu_torch.train import loop

    orig = loop.compute_diffusion_loss
    monkeypatch.setattr(loop, "compute_diffusion_loss", lambda *a, **k: 2.0 * orig(*a, **k))


FAULTS = [(w, f) for w in CELLS[:2] for f in (_perturb_audio, _stale_step, _half_batch)]
FAULTS += [("lora-r16-b8", f) for f in (_stale_update, _half_rows, _scaled_loss)]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_broken_program_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    line = go(workload)
    assert not line["correct"], line["checks"]


def _limit(workload, check):
    from benchmark.harness.registry import Cell

    return Cell(workload, run.ROOT).limits[check]


def _nudged_trunk(monkeypatch, workload):
    """The sampler's latents off by twice the latent limit where the trunk
    produces them (a lower precision in the trunk alone)."""
    from echo_tts_tpu_torch.pipeline import pipeline as pl

    f = 1.0 + 2.0 * _limit(workload, "latent_rel_l2")
    one, block = pl.sample_euler_cfg_independent_guidances, pl.sample_block_core

    def block_bad(*a, **k):
        prefix, st = block(*a, **k)
        start, bs = a[5], a[11]
        prefix[:, start:start + bs] *= f
        return prefix, st

    monkeypatch.setattr(pl, "sample_euler_cfg_independent_guidances",
                        lambda *a, **k: one(*a, **k) * f)
    monkeypatch.setattr(pl, "sample_block_core", block_bad)


def _prompt_frames(monkeypatch, workload, fn):
    """fn applied to the latents (1, T, C) of each prompt or clip where the
    program's codec encodes it; fn may also shorten the mask with them."""
    import numpy as np

    from echo_tts_tpu_torch.pipeline import pipeline as pl
    from echo_tts_tpu_torch.train import data

    spk, enc = pl.get_speaker_latent_and_mask, data.ae_encode

    def spk_bad(*a, **k):
        lat, mask = spk(*a, **k)
        n = int(mask[0].sum())
        lat, keep = fn(np.array(lat), n)
        return lat, mask[:, :lat.shape[1]] & (np.arange(lat.shape[1]) < keep)[None]

    monkeypatch.setattr(pl, "get_speaker_latent_and_mask", spk_bad)
    monkeypatch.setattr(data, "ae_encode",
                        lambda *a, **k: fn(enc(*a, **k).clone(), None)[0])


def _zeroed_frames(monkeypatch, workload):
    """Three in four of each prompt's frames zeroed where the codec makes
    them."""
    def zero(lat, n):
        n = lat.shape[1] if n is None else n
        lat[:, :3 * n // 4] = 0
        return lat, n

    _prompt_frames(monkeypatch, workload, zero)


def _dropped_frames(monkeypatch, workload):
    """The second half of each prompt's frames dropped where the codec
    makes them."""
    def drop(lat, n):
        n = lat.shape[1] if n is None else n
        return lat[:, :n // 2], n // 2

    _prompt_frames(monkeypatch, workload, drop)


NUMBER_FAULTS = [(w, _nudged_trunk, "latent_rel_l2") for w in CELLS[:2]]
NUMBER_FAULTS += [(w, f, f"speaker_{c}") for w in CELLS[:2]
                  for f, c in ((_zeroed_frames, "far_share"), (_dropped_frames, "frames_mismatch"))]
NUMBER_FAULTS += [("lora-r16-b8", _zeroed_frames, "encode_far_share"),
                  ("lora-r16-b8", _dropped_frames, "encode_frames_mismatch")]


@pytest.mark.parametrize("workload,fault,check", NUMBER_FAULTS)
def test_fault_fails_its_number(workload, fault, check, monkeypatch):
    fault(monkeypatch, workload)
    line = go(workload)
    c = line["checks"][check]
    assert c["value"] > c["limit"], line["checks"]
    assert not line["correct"]


def test_traced_line_reports_per_layer_metrics_only():
    line = go("oneshot-b8-closed16", trace=1)
    assert "batch_audio_s_per_s" not in line["metrics"]
    assert line["metrics"]["rows_per_batch.batch"]["value"] >= 1
