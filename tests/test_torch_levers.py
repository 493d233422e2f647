"""The opt-in sampler levers of the port (echo_tts_tpu_torch/sampling/euler_cfg.py:
the midpoint solver, the uncond cache, the joint uncond branch) against the
JAX package's `euler_cfg_scan` on the same weights and injected noise: alone,
combined and with the temporal score rescale and a force-speaker scale that
switches off mid-run, 6 steps across the CFG window edge (fp32, rel-L2 <=
1e-4, test_torch_sampler.py's bound); the joint-uncond CFG forward with the
latent segment (the uncond branch then sees the latent segment alone); the
blockwise sampler with midpoint, and the stream pipeline with midpoint and
first_block_steps; the two ValueErrors. Tiny configs on the CPU."""
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
from echo_tts_tpu.sampling import blockwise as jbw
from echo_tts_tpu.sampling import euler_cfg as jeu
from echo_tts_tpu_torch.checkpoints.from_jax import ae_params_from_numpy, dit_params_from_numpy
from echo_tts_tpu_torch.core import config as tc
from echo_tts_tpu_torch.models import dit as tdit
from echo_tts_tpu_torch.models.pca import PCAState
from echo_tts_tpu_torch.pipeline import pipeline as tpipe
from echo_tts_tpu_torch.sampling import blockwise as tbw
from echo_tts_tpu_torch.sampling import euler_cfg as teu

from torch_parity import np_tree, rel_l2, t

CFG = tc.DiTConfig().tiny()
JCFG = jc.DiTConfig().tiny()
SEQ = 12

LEVERS = {
    "midpoint": dict(solver="midpoint"),
    "uncond_cache_2": dict(uncond_cache_interval=2),
    "uncond_cache_3": dict(uncond_cache_interval=3),
    "joint_uncond": dict(joint_uncond=True),
    "midpoint_joint_uncond": dict(solver="midpoint", joint_uncond=True),
    "uncond_cache_2_joint_uncond": dict(uncond_cache_interval=2, joint_uncond=True),
}
BASES = {
    "window": dict(num_steps=6, truncation_factor=0.8, sequence_length=SEQ),
    "rescale_force_speaker": dict(
        num_steps=6, truncation_factor=0.8, rescale_k=1.2, rescale_sigma=2.0,
        speaker_kv_scale=1.5, speaker_kv_min_t=0.7, speaker_kv_max_layers=1,
        sequence_length=SEQ),
}


@pytest.fixture(scope="module")
def params():
    jp = jdit.init_dit_params(jax.random.PRNGKey(1), JCFG, dtype=jnp.float32)
    return jp, dit_params_from_numpy(np_tree(jp), CFG, device="cpu")


def _cond(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (1, 24)).astype(np.int32)
    text_mask = np.arange(24)[None] < 20
    spk = rng.standard_normal((1, 16, 80)).astype(np.float32)
    spk_mask = np.arange(16)[None] < 13
    return ids, text_mask, spk, spk_mask


@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_sampler_lever_matches_jax(params, lever, base):
    jp, tp = params
    kw = dict(BASES[base], **LEVERS[lever])
    ids, text_mask, spk, spk_mask = _cond(3)
    noise = np.random.default_rng(4).standard_normal((1, SEQ, 80)).astype(np.float32)
    ref = jeu.sample_euler_cfg_independent_guidances(
        jp, JCFG, jc.SamplerConfig(**kw), jnp.asarray(spk), jnp.asarray(spk_mask),
        jnp.asarray(ids), jnp.asarray(text_mask), jnp.asarray(noise), model_dtype=jnp.float32)
    with torch.no_grad():
        got = teu.sample_euler_cfg_independent_guidances(
            tp, CFG, tc.SamplerConfig(**kw), t(spk), t(spk_mask), t(ids), t(text_mask),
            t(noise), model_dtype=torch.float32)
        exact = teu.sample_euler_cfg_independent_guidances(
            tp, CFG, tc.SamplerConfig(**BASES[base]), t(spk), t(spk_mask), t(ids),
            t(text_mask), t(noise), model_dtype=torch.float32)
    assert rel_l2(got.numpy(), ref) <= 1e-4
    assert rel_l2(got.numpy(), exact.numpy()) > 1e-4  # the lever changed the integration


def test_midpoint_evaluates_at_its_own_flow_time(params, monkeypatch):
    """Each midpoint step evaluates at t and at t + dt/2 computed in fp32;
    the CFG window is tested at each evaluation's own time."""
    _, tp = params
    seen = []
    real_cfg, real_single = teu.dit_forward_cfg, teu.dit_forward

    def cfg_fwd(*a, **k):
        seen.append(("cfg", float(a[3][0])))
        return real_cfg(*a, **k)

    def single_fwd(*a, **k):
        seen.append(("single", float(a[3][0])))
        return real_single(*a, **k)

    monkeypatch.setattr(teu, "dit_forward_cfg", cfg_fwd)
    monkeypatch.setattr(teu, "dit_forward", single_fwd)
    ids, text_mask, spk, spk_mask = _cond(5)
    sc = tc.SamplerConfig(num_steps=4, sequence_length=SEQ, solver="midpoint")
    with torch.no_grad():
        teu.sample_euler_cfg_independent_guidances(
            tp, CFG, sc, t(spk), t(spk_mask), t(ids), t(text_mask),
            torch.zeros(1, SEQ, 80), model_dtype=torch.float32)
    ts = np.asarray(jeu.t_schedule(jc.SamplerConfig(num_steps=4)))
    want = []
    for i in range(4):
        dt = ts[i + 1] - ts[i]
        for tt in (ts[i], ts[i] + np.float32(0.5) * dt):
            want.append(("cfg" if tt >= np.float32(0.5) else "single", float(np.float32(tt))))
    assert seen == want


@pytest.mark.parametrize("start_pos", [8, 16])
def test_joint_uncond_forward_with_the_latent_segment(params, start_pos):
    """dit_forward_cfg(joint_uncond=True) with the latent-prefix cache: two
    branches, the uncond one attending to the latent segment alone."""
    jp, tp = params
    ids, text_mask, spk, spk_mask = _cond(6)
    prefix = np.random.default_rng(7).standard_normal((1, 24, 80)).astype(np.float32)
    x = np.random.default_rng(8).standard_normal((1, 8, 80)).astype(np.float32)
    lat_mask = (np.arange(6) * CFG.speaker_patch_size < start_pos)[None]
    jkt = jdit.get_kv_cache_text(jp, JCFG, jnp.asarray(ids), jnp.asarray(text_mask))
    jks = jdit.get_kv_cache_speaker(jp, JCFG, jnp.asarray(spk))
    jkl = jdit.get_kv_cache_latent(jp, JCFG, jnp.asarray(prefix))
    cos, sin = jdit.precompute_rope(JCFG.head_dim, 32)
    ref = jdit.dit_forward_cfg(
        jp, JCFG, jnp.asarray(x), jnp.full((1,), 0.8), jnp.asarray(text_mask),
        jnp.asarray(spk_mask), jkt, jks, rope_q=(cos[start_pos:start_pos + 8],
                                                  sin[start_pos:start_pos + 8]),
        kv_latent=jkl, latent_mask=jnp.asarray(lat_mask), joint_uncond=True)
    with torch.no_grad():
        kt = tdit.get_kv_cache_text(tp, CFG, t(ids), t(text_mask))
        ks = tdit.get_kv_cache_speaker(tp, CFG, t(spk))
        kl = tdit.get_kv_cache_latent(tp, CFG, t(prefix))
        tcos, tsin = tdit.precompute_rope(CFG.head_dim, 32)
        got = tdit.dit_forward_cfg(
            tp, CFG, t(x), torch.full((1,), 0.8), t(text_mask), t(spk_mask), kt, ks,
            rope_q=(tcos[start_pos:start_pos + 8], tsin[start_pos:start_pos + 8]),
            kv_latent=kl, latent_mask=t(lat_mask), joint_uncond=True)
    assert got.shape == ref.shape == (2, 1, 8, 80)
    assert rel_l2(got.numpy(), ref) <= 1e-4


@pytest.mark.parametrize("lever", ["midpoint", "uncond_cache_2_joint_uncond"])
def test_blockwise_sampler_with_a_lever_matches_jax(params, lever):
    """Two blocks through sample_block_core's caller, each block's scan
    taking the lever (JAX: tests/test_solver.py's midpoint blockwise run)."""
    jp, tp = params
    kw = dict(num_steps=4, truncation_factor=0.8, sequence_length=16, **LEVERS[lever])
    ids, text_mask, spk, spk_mask = _cond(9)
    noises = [np.random.default_rng(10 + i).standard_normal((1, 8, 80)).astype(np.float32)
              for i in range(2)]
    ref = jbw.sample_blockwise_euler_cfg_independent_guidances(
        jp, JCFG, jc.SamplerConfig(**kw), jnp.asarray(spk), jnp.asarray(spk_mask),
        jnp.asarray(ids), jnp.asarray(text_mask), (8, 8),
        noises=[jnp.asarray(n) for n in noises], model_dtype=jnp.float32)
    got = tbw.sample_blockwise_euler_cfg_independent_guidances(
        tp, CFG, tc.SamplerConfig(**kw), t(spk), t(spk_mask), t(ids), t(text_mask), (8, 8),
        noises=[t(n) for n in noises], model_dtype=torch.float32)
    assert got.shape == ref.shape and np.isfinite(got.numpy()).all()
    assert rel_l2(got.numpy(), ref) <= 1e-4


@pytest.fixture(scope="module")
def both(params):
    jp, tp = params
    acfg, jacfg = tc.AEConfig().tiny(), jc.AEConfig().tiny()
    ja = jax.jit(lambda k: j_init_ae(k, jacfg, dtype=jnp.float32))(jax.random.PRNGKey(2))
    pipe = dict(text_buckets=(64,), speaker_buckets=(32, 64), audio_chunk_latents=32,
                max_speaker_latent_length=64)
    jtts = jpipe.EchoTTS(jp, JCFG, ja, jacfg, JPCAState.random(0, jacfg.latent_dim),
                         model_dtype=jnp.float32, pipe_cfg=jc.PipelineConfig(**pipe))
    ttts = tpipe.EchoTTS(tp, CFG, ae_params_from_numpy(np_tree(ja), acfg, device="cpu"), acfg,
                         PCAState.random(0, acfg.latent_dim, device="cpu"),
                         model_dtype=torch.float32, pipe_cfg=tc.PipelineConfig(**pipe),
                         device="cpu")
    return jtts, ttts


def test_stream_with_midpoint_and_first_block_steps_matches_jax(both):
    """sample_pipeline_stream with the midpoint solver and a 1-step first
    block (the serving stack's TTFA knob) against the JAX package's."""
    jtts, ttts = both
    sc = dict(num_steps=3, truncation_factor=0.8, sequence_length=16, solver="midpoint",
              first_block_steps=1)
    kw = dict(block_size=(4, 8), normalize_text=True, stop_at_flattening=False)
    ref = list(jpipe.sample_pipeline_stream(jtts, "Midpoint stream.", None, 3,
                                            sc=jc.SamplerConfig(**sc), **kw))
    got = list(tpipe.sample_pipeline_stream(ttts, "Midpoint stream.", None, 3,
                                            sc=tc.SamplerConfig(**sc), **kw))
    assert [c.shape for c in got] == [np.asarray(c).shape for c in ref]
    assert rel_l2(np.concatenate(got, -1), np.concatenate([np.asarray(c) for c in ref], -1)) \
        <= 1e-4


@pytest.mark.parametrize("kw,match", [
    (dict(solver="midpoint", uncond_cache_interval=2), "midpoint"),
    (dict(solver="heun3"), "heun3"),
])
def test_lever_value_errors(params, kw, match):
    """Midpoint with an uncond cache, and an unknown solver, raise
    ValueError as the JAX scan does, before any forward."""
    _, tp = params
    sc = tc.SamplerConfig(num_steps=2, sequence_length=SEQ, **kw)
    with pytest.raises(ValueError, match=match):
        teu.euler_cfg_scan(tp, CFG, sc, torch.zeros(1, SEQ, 80), None, None, None, None,
                           torch.float32)
    with pytest.raises(ValueError, match=match):
        jeu.euler_cfg_scan(None, JCFG, jc.SamplerConfig(num_steps=2, **kw),
                           jnp.zeros((1, SEQ, 80)), None, None, None, None, jnp.float32)
