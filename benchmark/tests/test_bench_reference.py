"""The plain reference against the served program at tiny configurations on
the CPU (the program then runs its plain-PyTorch paths in float32), and the
reference's independence from the program."""
from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from benchmark.harness import program
from benchmark.harness.weights import make_weights
from benchmark.reference import ae as ref_ae
from benchmark.reference import dit as ref_dit
from benchmark.reference import jax_random
from benchmark.reference.text import flattening_point, text_ids
from benchmark.tests.tiny import tiny_config

REF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference")
SC = dict(num_steps=4, sequence_length=16)


def _sc():
    return dict(num_steps=4, cfg_scale_text=3.0, cfg_scale_speaker=8.0, cfg_min_t=0.5,
                cfg_max_t=1.0, truncation_factor=1.0, init_scale=0.999)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_reference_imports_nothing_of_the_program():
    """Every file of the reference imports only the standard library, numpy,
    torch and its own modules: never jax, the JAX package or the port."""
    allowed = {"math", "typing", "numpy", "torch", "__future__", "dataclasses"}
    for name in sorted(os.listdir(REF_DIR)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF_DIR, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative: the reference's own modules
                    continue
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in allowed, f"{name} imports {m}"


def test_noise_matches_the_program():
    from echo_tts_tpu_torch.sampling.jax_random import jax_normal

    for seed in (0, 7, 2**31 + 5):
        np.testing.assert_array_equal(jax_random.normal(seed, (3, 5, 4)),
                                      jax_normal(seed, (3, 5, 4)))


@pytest.mark.parametrize("name", ["echo-tts-base-oneshot", "echo-tts-base-blockwise"])
def test_weights_have_the_programs_layout(name):
    """The benchmark's tree has every leaf of the program's own initialiser,
    at the same shape and dtype."""
    from echo_tts_tpu_torch.bench.init_ae import init_ae_params
    from echo_tts_tpu_torch.models.dit import init_dit_params

    cfg = tiny_config(name)
    w = make_weights(cfg, 3, "cpu")
    tts = program.echo_tts(cfg, w, "cpu")

    def shapes(tree, pre=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in shapes(v, f"{pre}.{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree) for k2, v2 in shapes(v, f"{pre}.{i}").items()}
        return {pre: (tuple(tree.shape), tree.dtype)}

    assert shapes(w["dit"]) == shapes(init_dit_params(tts.dit_cfg, torch.float32, "cpu"))
    assert shapes(w["ae"]) == shapes(init_ae_params(tts.ae_cfg, torch.float32, "cpu"))


def _prompt(seed, n):
    return (0.1 * np.random.default_rng(seed).standard_normal((1, n))).astype(np.float32)


def test_oneshot_reference_matches_program():
    """Text, fresh speaker encode, sampler, PCA, decode and crop: the
    program's `sample_pipeline_batch` (two rows) against the reference."""
    from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline_batch

    cfg = tiny_config("echo-tts-base-oneshot")
    w = make_weights(cfg, 11, "cpu")
    tts = program.echo_tts(cfg, w, "cpu")
    sc = dict(_sc(), sequence_length=16)
    texts = ["Hello there, a short one.", "A second, somewhat longer line of text."]
    prompts = [_prompt(1, 16 * 20), _prompt(2, 16 * 27)]
    seeds = [5, 2**31 + 9]
    out = sample_pipeline_batch(tts, list(zip(texts, prompts, seeds)),
                                program.sampler_config(sc), normalize_text=True)
    rw = ref_dit.f32_tree(w["dit"])
    ra = ref_dit.f32_tree(w["ae"])
    P = ref_dit.Prec("fp32")
    c = cfg["dit"]
    for i in range(2):
        ids, tm = text_ids(texts[i], 768)
        lat, sm = ref_ae.speaker_latent(ra, cfg["ae"], w["pca"], prompts[i], 32, P, chunk_latents=16)
        noise = torch.as_tensor(jax_random.normal(seeds[i], (1, 16, 80)))
        x = ref_dit.sample_oneshot(rw, c, sc, noise, torch.as_tensor(ids), torch.as_tensor(tm),
                                   lat, sm, P, time_dtype=torch.float32)
        audio = ref_ae.decode_zq(ra, cfg["ae"], ref_ae.pca_deproject(w["pca"], x), P)
        fp = flattening_point(x[0])
        audio = audio[..., :fp * 16].numpy()
        assert audio.shape == out[i][0].shape
        assert _rel(out[i][0], audio) < 1e-4


def test_stream_reference_matches_program():
    """The blockwise sampler, the latent-prefix cache and the stateful
    decode: a two-row `sample_pipeline_stream_batch` against the reference's
    blocks re-encoded whole and one full decode."""
    from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline_stream_batch

    cfg = tiny_config("echo-tts-base-blockwise")
    w = make_weights(cfg, 12, "cpu")
    tts = program.echo_tts(cfg, w, "cpu")
    sc = dict(_sc(), sequence_length=32)
    texts = ["Streaming text number one.", "And another, for the second row."]
    prompts = [_prompt(3, 16 * 20), _prompt(4, 16 * 25)]
    seeds = [17, 23]
    chunks = [[], []]
    for out in sample_pipeline_stream_batch(tts, list(zip(texts, prompts, seeds)),
                                            program.sampler_config(sc), block_size=(8, 12),
                                            normalize_text=True):
        for i, ch in out.items():
            chunks[i].append(ch)
    rw = ref_dit.f32_tree(w["dit"])
    ra = ref_dit.f32_tree(w["ae"])
    P = ref_dit.Prec("fp32")
    for i in range(2):
        got = np.concatenate(chunks[i], axis=-1)
        ids, tm = text_ids(texts[i], 768)
        lat, sm = ref_ae.speaker_latent(ra, cfg["ae"], w["pca"], prompts[i], 32, P, chunk_latents=16)
        noise = torch.as_tensor(jax_random.normal(seeds[i], (1, 32, 80)))
        x = ref_dit.sample_blockwise(rw, cfg["dit"], sc, noise, torch.as_tensor(ids),
                                     torch.as_tensor(tm), lat, sm, [8, 12, 12], P,
                                     time_dtype=torch.float32)
        audio = ref_ae.decode_zq(ra, cfg["ae"], ref_ae.pca_deproject(w["pca"], x), P)
        audio = audio[..., :flattening_point(x[0]) * 16].numpy()
        assert got.shape == audio.shape
        assert _rel(got, audio) < 1e-4


def test_flattening_point_matches_program():
    from echo_tts_tpu_torch.pipeline.flattening import find_flattening_point

    g = torch.Generator().manual_seed(0)
    for flat_at in (0, 5, 37, 60):
        x = torch.randn((64, 80), generator=g)
        x[flat_at:] = 0.001 * x[flat_at:]
        assert flattening_point(x) == find_flattening_point(x)
    x = torch.randn((64, 80), generator=g)
    assert flattening_point(x) == find_flattening_point(x) == 64
