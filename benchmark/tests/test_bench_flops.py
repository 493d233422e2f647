"""The operation and byte counters against hand counts at tiny shapes, and
the gap to the served program's own per-forward count."""
from __future__ import annotations

import json
import os

import pytest

from benchmark.harness import flops

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
TINY = dict(model_size=8, num_layers=2, num_heads=2, intermediate_size=12, latent_size=4,
            timestep_embed_size=4, adaln_rank=2, text_model_size=6, text_num_layers=1,
            text_intermediate_size=10, speaker_model_size=6, speaker_num_layers=1,
            speaker_intermediate_size=10, speaker_patch_size=2)


def test_trunk_by_hand():
    # one layer: q k v gate o (5·8·8) + w1 w3 w2 (3·8·12) per query, two
    # operations a multiply-add; QK and PV over 5 keys of width 8
    q, keys = 3, 5
    per_layer = 2 * q * (5 * 64 + 3 * 96) + 4 * q * keys * 8
    cond = 2 * (4 * 8 + 64 + 8 * 24) + 2 * 6 * 2 * 2 * 8 * 2
    io = 2 * 2 * q * 4 * 8
    assert flops.trunk_flops(TINY, q, keys) == cond + io + 2 * per_layer


def test_caches_by_hand():
    # text: one encoder layer over 7 tokens attending to 7, then k and v of
    # every trunk layer (2 layers · 2 · 7 · 6 · 8 · 2)
    enc = 2 * 7 * (5 * 36 + 3 * 60) + 4 * 7 * 7 * 6
    assert flops.text_cache_flops(TINY, 7) == enc + 2 * 2 * 2 * 7 * 6 * 8
    # speaker: 10 latents -> 5 patches, in_proj 8 -> 6, causal keys 3 on average
    enc = 2 * 5 * (5 * 36 + 3 * 60) + 4 * 5 * 3 * 6
    assert flops.speaker_cache_flops(TINY, 10) == 2 * 5 * 8 * 6 + enc + 2 * 2 * 2 * 5 * 6 * 8


def test_sampler_counts_the_cfg_window():
    sc = dict(num_steps=40, cfg_min_t=0.5, cfg_max_t=1.0, init_scale=0.999)
    assert flops.cfg_steps(sc) == 20
    s = flops.sampler_flops(TINY, sc, 4, text=3, spk_latents=6)
    both = flops.trunk_flops(TINY, 4, 4 + 3 + 3)
    no_text = flops.trunk_flops(TINY, 4, 4 + 3)
    no_spk = flops.trunk_flops(TINY, 4, 4 + 3)
    assert s == 20 * both + 20 * (both + no_text + no_spk)


def test_attention_call_by_hand():
    # two branches, one row: keys 10 and 6; heads 2, queries 3, width 4
    ops, nbytes = flops.attention_call(2, [[10, 6]], 2, 3, 4, [7])
    assert ops == 4 * 2 * 3 * 4 * 16
    assert nbytes == 4 * 2 * (2 * 3 * 4 * 2) + 2 * 2 * 7 * 4 * 2
    ops_b, bytes_b = flops.attention_call(2, [[10, 6]], 2, 3, 4, [7], backward=True)
    assert ops_b == 2.5 * ops
    assert bytes_b == 2 * nbytes + 2 * 2 * 3 * 4


def test_bound_is_the_slower_roof():
    assert flops.bound_seconds(flops.PEAK_BF16_FLOPS, 0) == pytest.approx(1.0)
    assert flops.bound_seconds(0, flops.PEAK_HBM_BYTES_S * 2) == pytest.approx(2.0)


def test_gap_to_the_programs_count():
    """The program's `dit_step_flops` charges the text and speaker KV
    projections and the AdaLN low-rank products to every latent token of
    every forward. At the served shape (640 latents, a full 768-byte text,
    160 speaker patches) it reads 26 % above this counter's forward: the KV
    projections make 63 % of the gap and the AdaLN products the rest."""
    from echo_tts_tpu_torch.core.config import DiTConfig
    from echo_tts_tpu_torch.utils.profiling import dit_step_flops

    with open(os.path.join(CONFIGS, "echo-tts-base-oneshot.json")) as f:
        c = json.load(f)["dit"]
    ours = flops.trunk_flops(c, 640, 640 + 768 + 160)
    theirs = dit_step_flops(DiTConfig(has_latent_modules=False), 1, 640, 768 + 160)
    assert 1.25 < theirs / ours < 1.27
    kv = 24 * 2 * 2 * 640 * (1280 + 1280) * 2048
    adaln = 24 * 2 * 640 * 6 * 2048 * 256 * 2
    ours_adaln = 24 * 6 * 2 * 2 * 2048 * 256
    assert abs((theirs - ours) - (kv + adaln - ours_adaln)) / (theirs - ours) < 0.02


def test_codec_counts_grow_with_length():
    with open(os.path.join(CONFIGS, "echo-tts-base-oneshot.json")) as f:
        a = json.load(f)["ae"]
    d1, d2 = flops.ae_decode_flops(a, 320), flops.ae_decode_flops(a, 640)
    assert 1.9 < d2 / d1 <= 2.01
    assert 4.0e12 < d2 < 4.7e12
    e = flops.ae_encode_flops(a, 20 * 44100)
    assert 1.0e12 < e < 2.0e12
