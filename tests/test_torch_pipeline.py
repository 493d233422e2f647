"""The port's sample_pipeline against the JAX package's, end to end on the same
weights and the same injected noise, with and without a speaker prompt:
equal crop length, audio rel-L2 <= 1e-4 in fp32; in bf16 (DiT and AE, the
speaker encode and the decode included) within 1.5 times the JAX package's
own bf16-to-fp32 distance. Tiny configs and small shape buckets, on the
CPU."""
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


# ---------------------------------------------------------------------------
# bf16, the decode included
# ---------------------------------------------------------------------------


BF16_FACTOR = 1.5
_EINSUM = jnp.einsum


def _einsum_bf16_products(subscripts, *operands, preferred_element_type=None, **kw):
    """XLA on the CPU has no bf16 x bf16 -> fp32 product: the JAX package's
    einsums that ask for one take their bf16 operands upcast to fp32 (the
    same products, exact in fp32, accumulated in fp32), as
    tests/test_torch_batch.py does."""
    if preferred_element_type == jnp.float32 and all(
            getattr(o, "dtype", None) == jnp.bfloat16 for o in operands):
        operands = [o.astype(jnp.float32) for o in operands]
    return _EINSUM(subscripts, *operands, preferred_element_type=preferred_element_type, **kw)


@pytest.mark.parametrize("with_speaker", [False, True])
def test_sample_pipeline_bf16_matches_jax(both, monkeypatch, with_speaker):
    """The whole sample_pipeline in bf16 (the DiT and the AE, so the speaker
    encode and the decode too) against the JAX package's on the same
    injected noise: the port at bf16 lies within BF16_FACTOR times the
    distance between the JAX package at bf16 and at fp32 (audio rel-L2) of
    each, the tolerance tests/test_torch_batch.py holds the forward and the
    sampler to, and crops to the same length."""
    import dataclasses

    monkeypatch.setattr(jnp, "einsum", _einsum_bf16_products)
    jtts, ttts = both
    jd, ja = np_tree(jtts.dit_params), np_tree(jtts.ae_params)
    jbf = dataclasses.replace(
        jtts, dit_params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), jd),
        ae_params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), ja),
        model_dtype=jnp.bfloat16)
    tbf = dataclasses.replace(
        ttts, dit_params=dit_params_from_numpy(jd, ttts.dit_cfg, device="cpu",
                                               dtype=torch.bfloat16),
        ae_params=ae_params_from_numpy(ja, ttts.ae_cfg, device="cpu", dtype=torch.bfloat16),
        model_dtype=torch.bfloat16)
    rng = np.random.default_rng(11)
    noise = rng.standard_normal((1, 16, 80)).astype(np.float32)
    spk = (0.3 * rng.standard_normal((1, 40 * 16))).astype(np.float32) if with_speaker else None
    text = "Hello there, this is a test."
    sc, jsc = tc.SamplerConfig(**SAMPLER), jc.SamplerConfig(**SAMPLER)
    ref32 = np.asarray(jpipe.sample_pipeline(jtts, text, spk, 0, sc=jsc, noise=noise)[0])
    ref16 = np.asarray(jpipe.sample_pipeline(jbf, text, spk, 0, sc=jsc, noise=noise)[0],
                       np.float32)
    got, _, timings = tpipe.sample_pipeline(tbf, text, spk, 0, sc=sc, noise=noise)
    assert timings["finite_before_crop"] == 1.0
    assert got.dtype == np.float32 and got.shape == ref16.shape == ref32.shape
    d_jax = rel_l2(ref16, ref32)
    print(f"bf16 audio rel-L2: JAX bf16 to fp32 {d_jax:.3e}, port bf16 to JAX bf16 "
          f"{rel_l2(got, ref16):.3e}, to JAX fp32 {rel_l2(got, ref32):.3e}")
    assert 0 < d_jax < 0.1
    assert rel_l2(got, ref16) <= BF16_FACTOR * d_jax
    assert rel_l2(got, ref32) <= BF16_FACTOR * d_jax
