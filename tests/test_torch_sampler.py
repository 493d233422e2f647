"""The port's Euler dual-CFG sampler against the JAX package's jitted scan on
the same weights and the same injected noise: 6 steps that cross the CFG
window edge, with temporal score rescale and a force-speaker scale that
switches off mid-run. Tiny config, fp32 on the CPU, rel-L2 <= 1e-4."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echo_tts_tpu.core.config import DiTConfig as JDiTConfig
from echo_tts_tpu.core.config import SamplerConfig as JSamplerConfig
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.sampling import euler_cfg as jeu
from echo_tts_tpu_torch.checkpoints.from_jax import dit_params_from_numpy
from echo_tts_tpu_torch.core.config import DiTConfig, SamplerConfig
from echo_tts_tpu_torch.sampling import euler_cfg as teu
from echo_tts_tpu_torch.sampling.jax_random import jax_fold_in, jax_normal

from torch_parity import np_tree, rel_l2, t

CFG = DiTConfig(has_latent_modules=False).tiny()
JCFG = JDiTConfig(has_latent_modules=False).tiny()
SEQ = 12


@pytest.fixture(scope="module")
def params():
    jp = jdit.init_dit_params(jax.random.PRNGKey(1), JCFG, dtype=jnp.float32)
    return jp, dit_params_from_numpy(np_tree(jp), CFG, device="cpu")


SAMPLERS = {
    "rescale_force_speaker": dict(
        num_steps=6, truncation_factor=0.8, rescale_k=1.2, rescale_sigma=2.0,
        speaker_kv_scale=1.5, speaker_kv_min_t=0.7, speaker_kv_max_layers=1,
        sequence_length=SEQ),
    "default_window": dict(num_steps=6, truncation_factor=0.8, sequence_length=SEQ),
}


def test_schedule_and_scale_vector():
    sc = SamplerConfig(**SAMPLERS["rescale_force_speaker"])
    jsc = JSamplerConfig(**SAMPLERS["rescale_force_speaker"])
    ts = teu.t_schedule(sc)
    np.testing.assert_allclose(ts, np.asarray(jeu.t_schedule(jsc)), atol=1e-7, rtol=0)
    for tt in ts[:-1]:
        ref = np.asarray(jeu._speaker_scale_vec(jsc, JCFG, jnp.float32(tt), jnp.float32(ts[0])))
        assert teu._speaker_scale_vec(sc, CFG, float(tt), float(ts[0])) == ref.tolist()


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_matches_jax(params, name):
    jp, tp = params
    sc, jsc = SamplerConfig(**SAMPLERS[name]), JSamplerConfig(**SAMPLERS[name])
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 256, (1, 24)).astype(np.int32)
    text_mask = np.arange(24)[None] < 20
    spk = rng.standard_normal((1, 16, 80)).astype(np.float32)
    spk_mask = np.arange(16)[None] < 13
    noise = rng.standard_normal((1, SEQ, 80)).astype(np.float32)
    ref = jeu.sample_euler_cfg_independent_guidances(
        jp, JCFG, jsc, jnp.asarray(spk), jnp.asarray(spk_mask), jnp.asarray(ids),
        jnp.asarray(text_mask), jnp.asarray(noise), model_dtype=jnp.float32)
    got = teu.sample_euler_cfg_independent_guidances(
        tp, CFG, sc, t(spk), t(spk_mask), t(ids), t(text_mask), t(noise),
        model_dtype=torch.float32)
    assert rel_l2(got.numpy(), ref) <= 1e-4


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("shape", [(1, 640, 80), (2, 7, 5)])
def test_noise_draw_matches_jax_random(seed, shape):
    """The port's seeded draw against jax.random.normal(PRNGKey(seed)): XLA's
    erfinv and the host polynomial may round the float32 log1p differently
    in the last bit, so max |diff| <= 2e-6."""
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=jnp.float32))
    got = teu.draw_noise(seed, shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert float(np.abs(got.numpy() - ref).max()) <= 2e-6


def test_noise_draw_one_seed_per_row():
    seeds = [4, 9, 4]
    got = teu.draw_noise(seeds, (3, 6, 80), "cpu").numpy()
    for row, s in zip(got, seeds):
        ref = np.asarray(jax.random.normal(jax.random.PRNGKey(s), (6, 80), dtype=jnp.float32))
        assert float(np.abs(row - ref).max()) <= 2e-6
    with pytest.raises(ValueError):
        teu.draw_noise([1, 2], (3, 6, 80), "cpu")


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_folded_key_draw_matches_jax_random(seed):
    """jax_fold_in gives the words of jax.random.fold_in(PRNGKey(seed), i),
    and jax_normal draws from it what jax.random.normal does (the blockwise
    sampler's per-block noise), block indices 0-3, max |diff| <= 2e-6."""
    for i in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
        assert tuple(jax_fold_in(seed, i)) == tuple(int(w) for w in np.asarray(key))
        ref = np.asarray(jax.random.normal(key, (2, 64, 80), dtype=jnp.float32))
        got = jax_normal(jax_fold_in(seed, i), (2, 64, 80))
        assert got.dtype == np.float32
        assert float(np.abs(got - ref).max()) <= 2e-6
