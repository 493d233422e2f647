"""The port's streaming path (echo_tts_tpu_torch) against the JAX package's on
the same weights (JAX initializers, carried over by checkpoints/from_jax.py)
and the same numpy inputs: the latent-prefix KV (whole prefix and two
incremental appends), the three-segment CFG forward [latent | text |
speaker] with the JAX side through XLA and through the Pallas K1 in
interpret mode, the blockwise sampler (injected noises, folded-key noises, a
continuation), the stateful and the windowed S1-DAC decode with perturbed
residual biases (the JAX side once through the Pallas K2 in interpret mode),
sample_pipeline_stream, the block schedule and the flattening detector with
the stream's emitter. Tiny configs with the latent modules, fp32 on the
CPU: atol 1e-5 / rtol 1e-4 for modules, rel-L2 <= 1e-4 for audio."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echo_tts_tpu.bench.init_ae import init_ae_params as j_init_ae
from echo_tts_tpu.core import config as jc
from echo_tts_tpu.core.rope import precompute_rope as j_rope
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.models import s1dac as js1
from echo_tts_tpu.models.pca import PCAState as JPCAState
from echo_tts_tpu.pipeline import flattening as jflat
from echo_tts_tpu.pipeline import pipeline as jpipe
from echo_tts_tpu.sampling import blockwise as jbw
from echo_tts_tpu_torch.checkpoints.from_jax import ae_params_from_numpy, dit_params_from_numpy
from echo_tts_tpu_torch.core import config as tc
from echo_tts_tpu_torch.core.rope import precompute_rope
from echo_tts_tpu_torch.models import dit as tdit
from echo_tts_tpu_torch.models import s1dac as ts1
from echo_tts_tpu_torch.models.pca import PCAState
from echo_tts_tpu_torch.pipeline import flattening as tflat
from echo_tts_tpu_torch.pipeline import pipeline as tpipe
from echo_tts_tpu_torch.sampling import blockwise as tbw

from torch_parity import assert_close, np_tree, perturb_res_biases, rel_l2, t

CFG = tc.DiTConfig().tiny()
JCFG = jc.DiTConfig().tiny()
ACFG = tc.AEConfig().tiny()
JACFG = jc.AEConfig().tiny()
PIPE = dict(text_buckets=(64,), speaker_buckets=(32, 64), audio_chunk_latents=32,
            max_speaker_latent_length=64)
SAMPLER = dict(num_steps=3, truncation_factor=0.8, sequence_length=16)


@pytest.fixture(scope="module")
def dit():
    jp = jdit.init_dit_params(jax.random.PRNGKey(4), JCFG, dtype=jnp.float32)
    return jp, dit_params_from_numpy(np_tree(jp), CFG, device="cpu")


@pytest.fixture(scope="module")
def ae():
    tree = perturb_res_biases(np_tree(j_init_ae(jax.random.PRNGKey(5), JACFG,
                                                dtype=jnp.float32)), 6)
    return jax.tree_util.tree_map(jnp.asarray, tree), ae_params_from_numpy(tree, ACFG,
                                                                           device="cpu")


@pytest.fixture(scope="module")
def both(dit, ae):
    jtts = jpipe.EchoTTS(dit[0], JCFG, ae[0], JACFG, JPCAState.random(0, JACFG.latent_dim),
                         model_dtype=jnp.float32, pipe_cfg=jc.PipelineConfig(**PIPE))
    ttts = tpipe.EchoTTS(dit[1], CFG, ae[1], ACFG, PCAState.random(0, ACFG.latent_dim,
                                                                   device="cpu"),
                         model_dtype=torch.float32, pipe_cfg=tc.PipelineConfig(**PIPE),
                         device="cpu")
    return jtts, ttts


def _latents(n, seed):
    return np.random.default_rng(seed).standard_normal((1, n, 80)).astype(np.float32)


def _cond(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (1, 24)).astype(np.int32)
    text_mask = np.arange(24)[None] < 19
    spk = rng.standard_normal((1, 16, 80)).astype(np.float32)
    spk_mask = np.arange(16)[None] < 12
    return ids, text_mask, spk, spk_mask


# ---------------------------------------------------------------------------
# latent-prefix KV
# ---------------------------------------------------------------------------


def test_get_kv_cache_latent(dit):
    jp, tp = dit
    prefix = _latents(20, 1)
    ref = jdit.get_kv_cache_latent(jp, JCFG, jnp.asarray(prefix))
    got = tdit.get_kv_cache_latent(tp, CFG, t(prefix))
    assert tuple(got[0].shape) == (CFG.num_layers, 1, CFG.num_heads, 5, CFG.head_dim)
    for g, r in zip(got, ref):
        assert_close(g, r, atol=1e-5, rtol=1e-4)


def test_extend_latent_kv_two_appends(dit):
    """Two appends (8 latents at 0, 12 at 8) into a 32-latent state: every
    buffer equals the JAX package's, and the trunk cache over the written
    patches equals a whole-prefix get_kv_cache_latent; unwritten patches
    stay zero. The same appends given a (B,) start position equal it too."""
    jp, tp = dit
    prefix = _latents(20, 2)
    js = jdit.init_latent_kv_state(jp, JCFG, 1, 32, jnp.float32)
    ts = tdit.init_latent_kv_state(tp, CFG, 1, 32, torch.float32)
    for a, b in ((0, 8), (8, 20)):
        js = jdit.extend_latent_kv(jp, JCFG, js, jnp.asarray(prefix[:, a:b]), a)
        out = tdit.extend_latent_kv(tp, CFG, ts, t(prefix[:, a:b]), a)
        assert out is ts  # written in place
    for name in ("enc_k", "enc_v", "k", "v"):
        assert_close(ts[name], js[name], atol=1e-5, rtol=1e-4)
    whole = tdit.get_kv_cache_latent(tp, CFG, t(prefix))
    assert_close(ts["k"][:, :, :, :5], whole[0].numpy(), atol=1e-5, rtol=1e-4)
    assert_close(ts["v"][:, :, :, :5], whole[1].numpy(), atol=1e-5, rtol=1e-4)
    assert not ts["k"][:, :, :, 5:].any() and not ts["enc_k"][:, :, 5:].any()
    # the same appends at one start position a row ((B,), continuous batching)
    rows = tdit.init_latent_kv_state(tp, CFG, 1, 32, torch.float32)
    for a, b in ((0, 8), (8, 20)):
        tdit.extend_latent_kv(tp, CFG, rows, t(prefix[:, a:b]), torch.tensor([a]))
    for name in ("enc_k", "enc_v", "k", "v"):
        assert_close(rows[name], js[name], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("start_pos", [0, 8])
def test_dit_forward_cfg_latent_segment(dit, start_pos, jax_impl):
    """One block's CFG forward at start_pos 0 (the latent segment masked in
    every branch) and 8 (two patches visible), 24 latents in all: queries
    with RoPE at [start_pos, start_pos + 8), segments [latent | text |
    speaker], the force-speaker scale on the speaker segment."""
    jp, tp = dit
    ids, text_mask, spk, spk_mask = _cond(3)
    prefix = _latents(8, 4)
    x = _latents(8, 5)
    tt = np.full((1,), 0.8, np.float32)
    total, s = 24, 8
    js = jdit.init_latent_kv_state(jp, JCFG, 1, total, jnp.float32)
    ts = tdit.init_latent_kv_state(tp, CFG, 1, total, torch.float32)
    if start_pos:
        js = jdit.extend_latent_kv(jp, JCFG, js, jnp.asarray(prefix), 0)
        tdit.extend_latent_kv(tp, CFG, ts, t(prefix), 0)
    lmask = (np.arange(total // 4) * 4 < start_pos)[None]
    scale = [1.5] * CFG.num_layers
    cos, sin = j_rope(JCFG.head_dim, total)
    jdit.set_attention_impl(jax_impl)
    try:
        ref = jdit.dit_forward_cfg(
            jp, JCFG, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(text_mask),
            jnp.asarray(spk_mask), jdit.get_kv_cache_text(jp, JCFG, jnp.asarray(ids),
                                                          jnp.asarray(text_mask)),
            jdit.get_kv_cache_speaker(jp, JCFG, jnp.asarray(spk)),
            rope_q=(cos[start_pos:start_pos + s], sin[start_pos:start_pos + s]),
            kv_latent=(js["k"], js["v"]), latent_mask=jnp.asarray(lmask),
            speaker_kv_scale=jnp.asarray(scale))
    finally:
        jdit.set_attention_impl("auto")
    tcos, tsin = precompute_rope(CFG.head_dim, total)
    got = tdit.dit_forward_cfg(
        tp, CFG, t(x), t(tt), t(text_mask), t(spk_mask),
        tdit.get_kv_cache_text(tp, CFG, t(ids), t(text_mask)),
        tdit.get_kv_cache_speaker(tp, CFG, t(spk)),
        rope_q=(tcos[start_pos:start_pos + s], tsin[start_pos:start_pos + s]),
        speaker_kv_scale=scale, kv_latent=(ts["k"], ts["v"]), latent_mask=t(lmask))
    assert tuple(got.shape) == (3, 1, s, 80)
    assert_close(got, ref, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# blockwise sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["noises", "folded_key", "continuation"])
def test_blockwise_sampler_matches_jax(dit, mode):
    jp, tp = dit
    ids, text_mask, spk, spk_mask = _cond(6)
    sc, jsc = tc.SamplerConfig(**SAMPLER), jc.SamplerConfig(**SAMPLER)
    blocks = (8, 4) if mode != "continuation" else (8,)
    kw_j, kw_t = {}, {}
    if mode == "noises":
        noises = [_latents(8, 7), _latents(4, 8)]
        kw_j["noises"] = [jnp.asarray(n) for n in noises]
        kw_t["noises"] = [t(n) for n in noises]
    elif mode == "folded_key":
        kw_j["rng_seed"] = kw_t["rng_seed"] = 5
    else:
        cont = _latents(8, 9)
        kw_j.update(continuation_latent=jnp.asarray(cont), rng_seed=2)
        kw_t.update(continuation_latent=t(cont), rng_seed=2)
    ref = jbw.sample_blockwise_euler_cfg_independent_guidances(
        jp, JCFG, jsc, jnp.asarray(spk), jnp.asarray(spk_mask), jnp.asarray(ids),
        jnp.asarray(text_mask), blocks, model_dtype=jnp.float32, **kw_j)
    got = tbw.sample_blockwise_euler_cfg_independent_guidances(
        tp, CFG, sc, t(spk), t(spk_mask), t(ids), t(text_mask), blocks,
        model_dtype=torch.float32, **kw_t)
    assert got.shape == ref.shape
    assert rel_l2(got, ref) <= 1e-4
    assert_close(got, ref, atol=1e-5, rtol=1e-4)
    if mode == "continuation":
        np.testing.assert_array_equal(got[:, :8].numpy(), cont)


def test_blockwise_sampler_rejects_misaligned_blocks(dit):
    _, tp = dit
    ids, text_mask, spk, spk_mask = _cond(1)
    with pytest.raises(ValueError, match="patch size"):
        next(tbw.sample_blockwise_stream(tp, CFG, tc.SamplerConfig(**SAMPLER), t(spk),
                                         t(spk_mask), t(ids), t(text_mask), (6, 10),
                                         model_dtype=torch.float32))


# ---------------------------------------------------------------------------
# streaming S1-DAC decode
# ---------------------------------------------------------------------------


def _zq(n, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal(
        (1, ACFG.latent_dim, n))).astype(np.float32)


def _cat(chunks):
    return np.concatenate([np.asarray(c) for c in chunks], axis=-1)


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_stateful_decode_matches_jax_and_full(ae, chunk):
    """The stateful decode of 22 frames in chunks of 1, 3 and 8 (the last
    padded and cropped): each chain's zero_below walks down from chain_ctx
    over several short chunks."""
    jp, tp = ae
    z = _zq(22, chunk)
    ref = _cat(js1.decode_zq_streaming_stateful(jp, JACFG, jnp.asarray(z), chunk_frames=chunk))
    got = _cat(ts1.decode_zq_streaming_stateful(tp, ACFG, t(z), chunk_frames=chunk))
    full = ts1.decode_zq(tp, ACFG, t(z)).numpy()
    assert got.shape == ref.shape == full.shape
    assert rel_l2(got, ref) <= 1e-4
    assert rel_l2(got, full) <= 1e-4


def test_stateful_decode_matches_jax_pallas_interpret(ae):
    """The JAX side's steps run unjitted with the conv impl set to the Pallas
    K2 in interpret mode, so its zero_below streaming is the kernel's."""
    jp, tp = ae
    z = _zq(10, 11)
    js1.set_conv_impl("pallas_interpret")
    try:
        state = js1.streaming_decode_init(jp, JACFG, 1, dtype=jnp.float32)
        ref = []
        for start in range(0, 10, 2):
            audio, state = js1.decode_zq_stream_step(jp, JACFG, state,
                                                     jnp.asarray(z[:, :, start:start + 2]), 1024)
            ref.append(np.asarray(audio))
    finally:
        js1.set_conv_impl("auto")
    got = _cat(ts1.decode_zq_streaming_stateful(tp, ACFG, t(z), chunk_frames=2))
    assert rel_l2(got, _cat(ref)) <= 1e-4


def test_stream_state_and_zero_below(ae):
    """The chain tails are chain_ctx rows; zero_below of the first chain
    walks ctx, ctx - rate, ... down to 0 over 1-frame steps and each step's
    audio equals the full decode's slice, with one position for the batch
    and with one position a row."""
    _, tp = ae
    state = ts1.streaming_decode_init(tp, ACFG, 1)
    assert state["pos"] == 0 and state["blocks"][0]["chain"].shape[1] == 80
    seen = []
    real = ts1.res_units_cl

    def spy(x, units, dilations=(1, 3, 9), *, zero_below=None):
        seen.append((x.shape[2], zero_below))
        return real(x, units, dilations, zero_below=zero_below)

    z = _zq(12, 12)
    ts1.res_units_cl = spy
    try:
        chunks = list(ts1.decode_zq_streaming_stateful(tp, ACFG, t(z), chunk_frames=1))
    finally:
        ts1.res_units_cl = real
    rate0 = 4 * ACFG.decoder_rates[0]
    first = [zb for c, zb in seen if c == seen[0][0]]
    assert first == [max(80 - rate0 * p, 0) for p in range(12)]
    assert rel_l2(_cat(chunks), ts1.decode_zq(tp, ACFG, t(z)).numpy()) <= 1e-4
    # with one position a row: pos is a (B,) int32 tensor and zero_below one
    # value a row, the same walk and the same audio
    seen.clear()
    state = ts1.streaming_decode_init(tp, ACFG, 2, per_row_pos=True)
    assert state["pos"].dtype == torch.int32 and state["pos"].tolist() == [0, 0]
    z2 = t(np.concatenate([z, z]))
    ts1.res_units_cl = spy
    try:
        rows = []
        for p in range(12):
            audio, state = ts1.decode_zq_stream_step(tp, ACFG, state, z2[:, :, p:p + 1])
            rows.append(audio.numpy())
    finally:
        ts1.res_units_cl = real
    assert [zb.tolist() for c, zb in seen if c == seen[0][0]] == [[zb, zb] for zb in first]
    assert state["pos"].tolist() == [12, 12]
    assert rel_l2(_cat(rows)[:1], _cat(chunks)) <= 1e-6


def test_windowed_decode_matches_jax(ae):
    jp, tp = ae
    z = _zq(20, 13)
    ref = _cat(js1.decode_zq_streaming(jp, JACFG, jnp.asarray(z), chunk_frames=8,
                                       context_frames=6))
    got = _cat(ts1.decode_zq_streaming(tp, ACFG, t(z), chunk_frames=8, context_frames=6))
    assert rel_l2(got, ref) <= 1e-4
    whole = _cat(ts1.decode_zq_streaming(tp, ACFG, t(z), chunk_frames=8))
    assert rel_l2(whole, ts1.decode_zq(tp, ACFG, t(z)).numpy()) <= 1e-4


# ---------------------------------------------------------------------------
# sample_pipeline_stream
# ---------------------------------------------------------------------------

TEXT = "Streaming test."


@pytest.mark.parametrize("case", ["no_speaker", "speaker", "continuation",
                                  "first_block_steps"])
def test_sample_pipeline_stream_matches_jax(both, case):
    jtts, ttts = both
    rng = np.random.default_rng(21)
    spl = ttts.ae_cfg.frame_length
    kw = dict(block_size=(4, 8), normalize_text=True, stop_at_flattening=False)
    sc = dict(SAMPLER)
    spk = None
    if case == "speaker":
        spk = (0.3 * rng.standard_normal((1, 40 * spl))).astype(np.float32)
    elif case == "continuation":
        kw["continuation_audio"] = (0.2 * rng.standard_normal((1, 8 * spl))).astype(np.float32)
    elif case == "first_block_steps":
        sc["first_block_steps"] = 1
    ref = list(jpipe.sample_pipeline_stream(jtts, TEXT, spk, 3, sc=jc.SamplerConfig(**sc),
                                            **kw))
    got = list(tpipe.sample_pipeline_stream(ttts, TEXT, spk, 3, sc=tc.SamplerConfig(**sc),
                                            **kw))
    assert [c.shape for c in got] == [np.asarray(c).shape for c in ref]
    n_new = 16 - (8 if case == "continuation" else 0)
    assert sum(c.shape[-1] for c in got) == n_new * spl
    assert rel_l2(_cat(got), _cat(ref)) <= 1e-4


def test_stream_requires_latent_modules(both):
    _, ttts = both
    tts2 = dataclasses.replace(ttts, dit_cfg=dataclasses.replace(ttts.dit_cfg,
                                                                 has_latent_modules=False))
    with pytest.raises(ValueError, match="blockwise"):
        next(tpipe.sample_pipeline_stream(tts2, TEXT, None, 0, sc=tc.SamplerConfig(**SAMPLER)))


@pytest.mark.parametrize("flat_at, seq, block, frames", [(10, 16, 8, 10), (30, 64, 32, 30)])
def test_stream_stops_at_flattening(both, monkeypatch, flat_at, seq, block, frames):
    """A detector forced to fire at a known latent: (10) inside the second
    of two 8-latent blocks, smaller than the 20-latent window, so the first
    block is held back whole; (30) inside the first 32-latent block's last
    window, so detection waits for the next block while the holdback keeps
    frames past 30 unsent. Either way exactly `frames` frames are emitted."""
    _, ttts = both
    monkeypatch.setattr(tflat, "find_flattening_point",
                        lambda data, **kw: min(flat_at, data.shape[0]))
    sc = tc.SamplerConfig(**dict(SAMPLER, sequence_length=seq, num_steps=1))
    chunks = list(tpipe.sample_pipeline_stream(ttts, TEXT, None, 3, sc=sc, block_size=block,
                                               normalize_text=True))
    assert sum(c.shape[-1] for c in chunks) == frames * ttts.ae_cfg.frame_length


# ---------------------------------------------------------------------------
# block schedule and flattening detector
# ---------------------------------------------------------------------------

SCHEDULES = [((160,), 640, 1), ((160,), 500, 1), (((64, 192),), 640, 1), (([4, 8, 8],), 16, 1),
             (((8,),), 4, 1), ((6,), 16, 4), ((50,), 640, 4), (((3, 9),), 24, 4),
             (((64, 192),), 640, 4), ((0,), 16, 1), (((8, 0),), 16, 1), (([],), 16, 1),
             ((8,), 14, 4)]


@pytest.mark.parametrize("args, budget, patch", SCHEDULES)
def test_block_schedule_matches_jax(args, budget, patch):
    try:
        ref = jpipe._block_schedule(*args, budget, patch=patch)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpipe._block_schedule(*args, budget, patch=patch)
        assert str(got.value) == str(e)
        return
    assert tpipe._block_schedule(*args, budget, patch=patch) == ref


@pytest.mark.parametrize("sizes, cont", [((8, 8), 0), ((6, 10), 0), ((8,), 6), ((4, 12), 8)])
def test_check_patch_aligned_matches_jax(sizes, cont):
    try:
        jpipe._check_patch_aligned(sizes, cont, 4)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpipe._check_patch_aligned(sizes, cont, 4)
        assert str(got.value) == str(e)
        return
    tpipe._check_patch_aligned(sizes, cont, 4)


@pytest.mark.parametrize("flat_from, n", [(0, 40), (17, 40), (33, 40), (None, 40)])
def test_find_flattening_point_matches_jax(flat_from, n):
    """Latents that go flat (zeros) from a known index, from the first
    latent, and never (the detector then returns one past the end)."""
    lat = 0.8 * np.random.default_rng(flat_from or 0).standard_normal((n, 80)).astype(np.float32)
    if flat_from is not None:
        lat[flat_from:] = 0.0
    ref = int(jflat.find_flattening_point(jnp.asarray(lat)))
    got = tflat.find_flattening_point(t(lat))
    assert got == ref
    assert got == (n if flat_from is None else flat_from)
