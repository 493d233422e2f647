"""The port's sample_pipeline against the JAX package's, end to end on the same
weights and the same injected noise, with and without a speaker prompt:
equal crop length, audio rel-L2 <= 1e-4. Tiny configs and small shape
buckets, fp32 on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echo_tts_tpu.bench.init_ae import init_ae_params as j_init_ae
from echo_tts_tpu.core import config as jc
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.models.pca import PCAState as JPCAState
from echo_tts_tpu.pipeline import pipeline as jpipe
from echo_tts_tpu_torch.checkpoints.from_jax import ae_params_from_numpy, dit_params_from_numpy
from echo_tts_tpu_torch.core import config as tc
from echo_tts_tpu_torch.models.pca import PCAState
from echo_tts_tpu_torch.pipeline import pipeline as tpipe

from torch_parity import np_tree, rel_l2

PIPE = dict(text_buckets=(64,), speaker_buckets=(32, 64), audio_chunk_latents=32,
            max_speaker_latent_length=64)
SAMPLER = dict(num_steps=4, truncation_factor=0.8, sequence_length=16)


@pytest.fixture(scope="module")
def both():
    dcfg = jc.DiTConfig(has_latent_modules=False).tiny()
    acfg = jc.AEConfig().tiny()
    jd = jdit.init_dit_params(jax.random.PRNGKey(2), dcfg, dtype=jnp.float32)
    ja = j_init_ae(jax.random.PRNGKey(3), acfg, dtype=jnp.float32)
    jtts = jpipe.EchoTTS(jd, dcfg, ja, acfg, JPCAState.random(0, acfg.latent_dim),
                         model_dtype=jnp.float32, pipe_cfg=jc.PipelineConfig(**PIPE))
    tdcfg = tc.DiTConfig(has_latent_modules=False).tiny()
    tacfg = tc.AEConfig().tiny()
    ttts = tpipe.EchoTTS(dit_params_from_numpy(np_tree(jd), tdcfg, device="cpu"), tdcfg,
                         ae_params_from_numpy(np_tree(ja), tacfg, device="cpu"), tacfg,
                         PCAState.random(0, tacfg.latent_dim, device="cpu"),
                         model_dtype=torch.float32, pipe_cfg=tc.PipelineConfig(**PIPE),
                         device="cpu")
    return jtts, ttts


@pytest.mark.parametrize("with_speaker", [False, True])
def test_sample_pipeline_matches_jax(both, with_speaker):
    jtts, ttts = both
    rng = np.random.default_rng(11)
    noise = rng.standard_normal((1, 16, 80)).astype(np.float32)
    # 40 latents of prompt: two 32-latent encode chunks, bucket 64
    spk = (0.3 * rng.standard_normal((1, 40 * 16))).astype(np.float32) if with_speaker else None
    text = "Hello there, this is a test."
    ref, ref_text, _ = jpipe.sample_pipeline(jtts, text, spk, 0,
                                             sc=jc.SamplerConfig(**SAMPLER), noise=noise)
    got, got_text, timings = tpipe.sample_pipeline(ttts, text, spk, 0,
                                                   sc=tc.SamplerConfig(**SAMPLER), noise=noise)
    ref = np.asarray(ref)
    assert got_text == ref_text
    assert got.shape == ref.shape and got.shape[-1] > 0
    assert timings["samples_before_crop"] == 16 * ttts.ae_cfg.frame_length
    assert timings["finite_before_crop"] == 1.0
    assert rel_l2(got, ref) <= 1e-4


def test_sample_pipeline_seeded_noise_matches_jax(both):
    """No injected noise: both packages draw it from rng_seed=3 (the port
    reproduces jax.random.normal), so the audio agrees as with injected
    noise."""
    jtts, ttts = both
    text = "Seeded noise, drawn by each package."
    ref, _, _ = jpipe.sample_pipeline(jtts, text, None, 3, sc=jc.SamplerConfig(**SAMPLER))
    got, _, _ = tpipe.sample_pipeline(ttts, text, None, 3, sc=tc.SamplerConfig(**SAMPLER))
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.shape[-1] > 0
    assert rel_l2(got, ref) <= 1e-4


def test_no_speaker_fallback_is_one_masked_patch(both):
    _, ttts = both
    ids, text_mask, _, spk, spk_mask, _ = tpipe._prepare_inputs(
        ttts, "hi", None, False, None, None, True)
    assert ids.shape == (1, 64) and text_mask.sum() == len("hi") + 1  # BOS + bytes
    assert spk.shape == (1, 4, 80) and not spk.any() and not spk_mask.any()
