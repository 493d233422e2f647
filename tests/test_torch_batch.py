"""Batches of B > 1 through the port (echo_tts_tpu_torch) against the JAX
package on the same weights (JAX initializers, carried over by
checkpoints/from_jax.py) and the same numpy inputs, each row with its own
text length and speaker length, one row with an all-masked (no prompt)
speaker segment: dit_forward_cfg, the three-segment blockwise forward
[latent | text | speaker] and the Euler CFG sampler at B=2 in fp32 and in
bf16; the per-row seeded noise; sample_pipeline_batch and
sample_pipeline_stream_batch against the JAX functions on the same requests
and seeds, and the stream batch's per-row early stop; apply_rope with
per-row (B, S, D/2) tables; the stream rows' bf16 gap to their solo
streams, split between the stateful decode and the sampled latents, in each
package against its own.

Tolerances. fp32: atol 1e-5 / rtol 1e-4 for modules, rel-L2 <= 1e-4 for
audio. bf16: both packages run the same bf16 weights and inputs, and their
rounding differs where their fp32 islands and GEMMs round in another order;
so the port at bf16 must lie within BF16_FACTOR (1.5) times the distance
between the JAX package at bf16 and at fp32 (rel-L2) of each of them. On
these inputs that distance reads 5.6e-3 (forward), 5.8e-3 (three-segment
forward) and 8.1e-3 (sampler); the port at bf16 lies 1.6e-3, 1.6e-3 and
7.6e-3 from the JAX package at bf16. XLA on the CPU has no bf16 x bf16 -> fp32
product, so the JAX package's einsums that ask for one take their bf16
operands upcast to fp32 here: the same products (a product of two bf16
values is exact in fp32) accumulated in fp32. Tiny configs with the latent
modules, on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echo_tts_tpu.bench.init_ae import init_ae_params as j_init_ae
from echo_tts_tpu.core import config as jc
from echo_tts_tpu.core.rope import precompute_rope as j_rope
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.models.pca import PCAState as JPCAState
from echo_tts_tpu.pipeline import pipeline as jpipe
from echo_tts_tpu.sampling import euler_cfg as jeu
from echo_tts_tpu_torch.checkpoints.from_jax import ae_params_from_numpy, dit_params_from_numpy
from echo_tts_tpu_torch.core import config as tc
from echo_tts_tpu_torch.core import rope as trope
from echo_tts_tpu_torch.models import dit as tdit
from echo_tts_tpu_torch.models import s1dac as ts1
from echo_tts_tpu_torch.models.pca import PCAState
from echo_tts_tpu_torch.pipeline import flattening as tflat
from echo_tts_tpu_torch.pipeline import pipeline as tpipe
from echo_tts_tpu_torch.sampling import euler_cfg as teu

from torch_parity import assert_close, np_tree, rel_l2, t

CFG = tc.DiTConfig().tiny()
JCFG = jc.DiTConfig().tiny()
ACFG = tc.AEConfig().tiny()
JACFG = jc.AEConfig().tiny()
PIPE = dict(text_buckets=(32, 64), speaker_buckets=(32, 64), audio_chunk_latents=32,
            max_speaker_latent_length=64)
SAMPLER = dict(num_steps=3, truncation_factor=0.8, sequence_length=16)
BF16_FACTOR = 1.5
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


_EINSUM = jnp.einsum


def _einsum_bf16_products(subscripts, *operands, preferred_element_type=None, **kw):
    if preferred_element_type == jnp.float32 and all(
            getattr(o, "dtype", None) == jnp.bfloat16 for o in operands):
        operands = [o.astype(jnp.float32) for o in operands]
    return _EINSUM(subscripts, *operands, preferred_element_type=preferred_element_type, **kw)


@pytest.fixture(autouse=True)
def _bf16_products_on_the_cpu(monkeypatch):
    monkeypatch.setattr(jnp, "einsum", _einsum_bf16_products)


@pytest.fixture(scope="module")
def weights():
    """fp32 DiT and AE weights from the JAX initializers, as numpy trees."""
    jp = jax.jit(lambda k: jdit.init_dit_params(k, JCFG, dtype=jnp.float32))(
        jax.random.PRNGKey(24))
    ja = jax.jit(lambda k: j_init_ae(k, JACFG, dtype=jnp.float32))(jax.random.PRNGKey(25))
    return np_tree(jp), np_tree(ja)


def _dit(weights, name):
    """(JAX params, port params) in one dtype: the same fp32 values rounded
    to bf16 on both sides."""
    jdt, tdt = DTYPES[name]
    tree = weights[0]
    return (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree),
            dit_params_from_numpy(tree, CFG, device="cpu", dtype=tdt))


@pytest.fixture(scope="module")
def both(weights):
    jtts = jpipe.EchoTTS(_dit(weights, "fp32")[0], JCFG,
                         jax.tree_util.tree_map(jnp.asarray, weights[1]), JACFG,
                         JPCAState.random(0, JACFG.latent_dim), model_dtype=jnp.float32,
                         pipe_cfg=jc.PipelineConfig(**PIPE))
    ttts = tpipe.EchoTTS(_dit(weights, "fp32")[1], CFG,
                         ae_params_from_numpy(weights[1], ACFG, device="cpu"), ACFG,
                         PCAState.random(0, ACFG.latent_dim, device="cpu"),
                         model_dtype=torch.float32, pipe_cfg=tc.PipelineConfig(**PIPE),
                         device="cpu")
    return jtts, ttts


def _rows(seed):
    """Two rows: text 19 and 7 of 24 bytes; speaker 12 of 16 latents and an
    all-masked speaker row (no prompt)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (2, 24)).astype(np.int32)
    text_mask = np.arange(24)[None] < np.array([[19], [7]])
    spk = rng.standard_normal((2, 16, 80)).astype(np.float32)
    spk[1] = 0.0
    spk_mask = np.arange(16)[None] < np.array([[12], [0]])
    x = rng.standard_normal((2, 8, 80)).astype(np.float32)
    tt = np.array([0.8, 0.8], np.float32)
    return ids, text_mask, spk, spk_mask, x, tt


def _check_dtype(name, got, ref, ref_fp32):
    """fp32: close to the JAX package. bf16: within BF16_FACTOR times the
    JAX package's own bf16-to-fp32 distance of each of its results."""
    got = got.float().numpy()
    if name == "fp32":
        assert_close(got, ref, atol=1e-5, rtol=1e-4)
        return
    ref, ref_fp32 = np.asarray(ref, np.float32), np.asarray(ref_fp32, np.float32)
    d_jax = rel_l2(ref, ref_fp32)
    assert 0 < d_jax < 0.1
    assert rel_l2(got, ref) <= BF16_FACTOR * d_jax, (rel_l2(got, ref), d_jax)
    assert rel_l2(got, ref_fp32) <= BF16_FACTOR * d_jax, (rel_l2(got, ref_fp32), d_jax)


def _jax_cfg_forward(jp, jdt, ids, text_mask, spk, spk_mask, x, tt, **kw):
    """The JAX package's caches and CFG forward, under one jit."""
    def fwd(jp, ids, text_mask, spk, spk_mask, x, tt, kw):
        kv_text = jdit.get_kv_cache_text(jp, JCFG, ids, text_mask)
        kv_spk = jdit.get_kv_cache_speaker(jp, JCFG, spk.astype(jdt))
        return jdit.dit_forward_cfg(jp, JCFG, x.astype(jdt), tt.astype(jdt), text_mask,
                                    spk_mask, kv_text, kv_spk, **kw)

    return jax.jit(fwd)(jp, ids, text_mask, spk, spk_mask, x, tt, kw)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dit_forward_cfg_b2(weights, dtype):
    """The CFG forward at B=2 with rows of their own text and speaker
    lengths (one with no prompt) and the force-speaker scale."""
    ids, text_mask, spk, spk_mask, x, tt = _rows(1)
    scale = [1.5, 1.0]
    refs = {}
    for name in {"fp32", dtype}:
        jp, _ = _dit(weights, name)
        refs[name] = _jax_cfg_forward(jp, DTYPES[name][0], ids, text_mask, spk, spk_mask, x, tt,
                                      speaker_kv_scale=jnp.asarray(scale))
    _, tp = _dit(weights, dtype)
    tdt = DTYPES[dtype][1]
    got = tdit.dit_forward_cfg(
        tp, CFG, t(x, tdt), t(tt, tdt), t(text_mask), t(spk_mask),
        tdit.get_kv_cache_text(tp, CFG, t(ids), t(text_mask)),
        tdit.get_kv_cache_speaker(tp, CFG, t(spk, tdt)), speaker_kv_scale=scale)
    assert tuple(got.shape) == (3, 2, 8, 80)
    _check_dtype(dtype, got, refs[dtype], refs["fp32"])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_blockwise_forward_b2(weights, dtype):
    """The three-segment forward [latent | text | speaker] at B=2: queries
    at [8, 16), the latent cache of both rows' 8-latent prefixes, two
    patches visible."""
    ids, text_mask, spk, spk_mask, x, tt = _rows(2)
    prefix = np.random.default_rng(3).standard_normal((2, 8, 80)).astype(np.float32)
    lmask = np.repeat((np.arange(6) * 4 < 8)[None], 2, 0)
    cos, sin = j_rope(JCFG.head_dim, 24)
    refs = {}
    for name in {"fp32", dtype}:
        jp, _ = _dit(weights, name)
        jdt = DTYPES[name][0]
        st = jdit.extend_latent_kv_jit(jp, JCFG, jdit.init_latent_kv_state(jp, JCFG, 2, 24, jdt),
                                       jnp.asarray(prefix, jdt), jnp.int32(0))
        refs[name] = _jax_cfg_forward(jp, jdt, ids, text_mask, spk, spk_mask, x, tt,
                                      rope_q=(cos[8:16], sin[8:16]), kv_latent=(st["k"], st["v"]),
                                      latent_mask=jnp.asarray(lmask))
    _, tp = _dit(weights, dtype)
    tdt = DTYPES[dtype][1]
    st = tdit.init_latent_kv_state(tp, CFG, 2, 24, tdt)
    tdit.extend_latent_kv(tp, CFG, st, t(prefix, tdt), 0)
    tcos, tsin = trope.precompute_rope(CFG.head_dim, 24)
    got = tdit.dit_forward_cfg(
        tp, CFG, t(x, tdt), t(tt, tdt), t(text_mask), t(spk_mask),
        tdit.get_kv_cache_text(tp, CFG, t(ids), t(text_mask)),
        tdit.get_kv_cache_speaker(tp, CFG, t(spk, tdt)), rope_q=(tcos[8:16], tsin[8:16]),
        kv_latent=(st["k"], st["v"]), latent_mask=t(lmask))
    _check_dtype(dtype, got, refs[dtype], refs["fp32"])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_sampler_b2(weights, dtype):
    """sample_euler_cfg_independent_guidances at B=2 on injected noise."""
    ids, text_mask, spk, spk_mask, _, _ = _rows(4)
    noise = np.random.default_rng(5).standard_normal((2, 16, 80)).astype(np.float32)
    sc, jsc = tc.SamplerConfig(**SAMPLER), jc.SamplerConfig(**SAMPLER)
    refs = {}
    for name in {"fp32", dtype}:
        jp, _ = _dit(weights, name)
        refs[name] = jeu.sample_euler_cfg_independent_guidances(
            jp, JCFG, jsc, jnp.asarray(spk), jnp.asarray(spk_mask), jnp.asarray(ids),
            jnp.asarray(text_mask), jnp.asarray(noise), model_dtype=DTYPES[name][0])
    _, tp = _dit(weights, dtype)
    got = teu.sample_euler_cfg_independent_guidances(
        tp, CFG, sc, t(spk), t(spk_mask), t(ids), t(text_mask), t(noise),
        model_dtype=DTYPES[dtype][1])
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 16, 80)
    _check_dtype(dtype, got, refs[dtype], refs["fp32"])


def test_draw_noise_one_seed_a_row_as_the_batch_draws_it():
    """Row i of draw_noise(seeds, (N, S, L)) is the JAX package's
    draw_noise(seed_i, (1, S, L)), as its sample_pipeline_batch stacks
    them; max |diff| <= 2e-6 (erfinv's last bit)."""
    seeds = [3, 7, 12345, 3]
    ref = np.asarray(jnp.concatenate([jeu.draw_noise(s, (1, 16, 80)) for s in seeds]))
    got = teu.draw_noise(seeds, (4, 16, 80), "cpu").numpy()
    assert float(np.abs(got - ref).max()) <= 2e-6


# ---------------------------------------------------------------------------
# per-row RoPE tables
# ---------------------------------------------------------------------------


def _apply_rope_shared(x, cos, sin):
    """apply_rope as it was before per-row tables: the (S, D/2) form must
    keep these bits."""
    xf = x.float()
    xr, xi = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([xr * c - xi * s, xr * s + xi * c], dim=-1).reshape(x.shape).to(x.dtype)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["B,S,H,D", "G,B,S,H,D"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_rope_per_row_tables(lead, dtype):
    """(B, S, D/2) tables, row b gathered at its own offset, equal a loop of
    (S, D/2) calls on each row bit for bit, with and without a leading
    group axis, for the trunk's rope (and its half-heads form) and the
    AE's; the (S, D/2) form is bit for bit what it was."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(*lead, 3, 5, 4, 16, generator=gen).to(dtype)
    cos, sin = trope.precompute_rope(16, 64)
    offs = [0, 17, 40]
    idx = torch.tensor(offs)[:, None] + torch.arange(5)
    tabs = trope.rope_rows(cos, sin, idx)
    for fn in (trope.apply_rope, trope.apply_rope_half_heads, ts1._ae_apply_rope):
        got = fn(x, *tabs)
        for b, o in enumerate(offs):
            torch.testing.assert_close(got[..., b, :, :, :], fn(x[..., b, :, :, :],
                                                                cos[o:o + 5], sin[o:o + 5]),
                                       rtol=0, atol=0)
    torch.testing.assert_close(trope.apply_rope(x, cos[9:14], sin[9:14]),
                               _apply_rope_shared(x, cos[9:14], sin[9:14]), rtol=0, atol=0)
    past = trope.rope_rows(cos, sin, torch.tensor([[62, 63, 64, 90]]))
    torch.testing.assert_close(past[0][0, 2:], cos[63].expand(2, -1), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# batched pipelines
# ---------------------------------------------------------------------------


def _speech(seconds_latents, seed):
    spl = ACFG.frame_length
    return (0.3 * np.random.default_rng(seed).standard_normal((1, seconds_latents * spl))
            ).astype(np.float32)


REQUESTS = [("Batch test one.", None, 3), ("A second and longer request of the batch.", 40, 7),
            ("Third.", None, 12)]


def _requests(n):
    return [(text, None if spk is None else _speech(spk, seed), seed)
            for text, spk, seed in REQUESTS[:n]]


def test_sample_pipeline_batch_matches_jax(both):
    """Three requests, one with a speaker prompt and a longer text, so that
    the others are padded to its buckets: each row's cropped audio equals
    the JAX package's sample_pipeline_batch and the port's own solo
    sample_pipeline."""
    jtts, ttts = both
    reqs = _requests(3)
    sc, jsc = tc.SamplerConfig(**SAMPLER), jc.SamplerConfig(**SAMPLER)
    ref = jpipe.sample_pipeline_batch(jtts, reqs, sc=jsc, normalize_text=True)
    got = tpipe.sample_pipeline_batch(ttts, reqs, sc=sc, normalize_text=True)
    assert len(got) == len(ref) == 3
    for (ga, gt, gtim), (ra, rt, _), (text, spk, seed) in zip(got, ref, reqs):
        assert gt == rt and ga.shape == np.asarray(ra).shape
        assert rel_l2(ga, ra) <= 1e-4
        assert gtim["batch_size"] == 3.0 and gtim["finite_before_crop"] == 1.0
        solo, _, _ = tpipe.sample_pipeline(ttts, text, spk, seed, sc=sc, normalize_text=True)
        assert rel_l2(ga, solo) <= 1e-4


def _stream_rows(gen, n):
    rows = {i: [] for i in range(n)}
    yields = 0
    for out in gen:
        yields += 1
        for i, c in out.items():
            assert c.shape[-1] > 0
            rows[i].append(np.asarray(c))
    return {i: np.concatenate(c, -1) for i, c in rows.items()}, yields


def test_sample_pipeline_stream_batch_matches_jax(both):
    """Two streams on the (4, 8) schedule, one with a speaker prompt: each
    row's chunks, concatenated, equal the JAX package's
    sample_pipeline_stream_batch and the port's solo stream."""
    jtts, ttts = both
    reqs = _requests(2)
    sc, jsc = tc.SamplerConfig(**SAMPLER), jc.SamplerConfig(**SAMPLER)
    kw = dict(block_size=(4, 8), normalize_text=True, stop_at_flattening=False)
    ref, _ = _stream_rows(jpipe.sample_pipeline_stream_batch(jtts, reqs, sc=jsc, **kw), 2)
    got, yields = _stream_rows(tpipe.sample_pipeline_stream_batch(ttts, reqs, sc=sc, **kw), 2)
    assert yields == 3
    for i, (text, spk, seed) in enumerate(reqs):
        assert got[i].shape == ref[i].shape == (1, 1, 16 * ACFG.frame_length)
        assert rel_l2(got[i], ref[i]) <= 1e-4
        solo = np.concatenate(list(tpipe.sample_pipeline_stream(ttts, text, spk, seed, sc=sc,
                                                                **kw)), -1)
        assert rel_l2(got[i], solo) <= 1e-4


@pytest.mark.parametrize("flat", [(30, None), (10, 10)], ids=["one_row", "both_rows"])
def test_stream_batch_early_stop_per_row(both, monkeypatch, flat):
    """A detector forced per row (row 0 at `flat[0]`, row 1 at `flat[1]`,
    None = never) on 64 latents in 32-latent blocks: a row that flattens
    emits exactly its frames and then disappears from the dicts, the other
    streams on; once every row has stopped the batch stops sampling."""
    _, ttts = both
    calls = {}

    def fake(data, **kw):  # the rows are asked in order within a block
        i = calls.get(data.shape[0], 0)
        calls[data.shape[0]] = i + 1
        at = flat[i % 2]
        return data.shape[0] if at is None else min(at, data.shape[0])

    monkeypatch.setattr(tflat, "find_flattening_point", fake)
    sc = tc.SamplerConfig(**dict(SAMPLER, sequence_length=64, num_steps=1))
    got, yields = _stream_rows(tpipe.sample_pipeline_stream_batch(
        ttts, [("Stops early.", None, 1), ("Runs long.", None, 2)], sc=sc, block_size=32,
        normalize_text=True), 2)
    spl = ttts.ae_cfg.frame_length
    assert [got[i].shape[-1] for i in range(2)] == [(64 if f is None else f) * spl for f in flat]
    assert yields == (2 if flat[1] is None else 1)


# ---------------------------------------------------------------------------
# the stream rows' bf16 gap: batched against solo, each package against its own
# ---------------------------------------------------------------------------

SPLIT_FLOOR = 1e-3  # rel-L2 under which a batched-vs-solo gap counts as none


def _bf16_pair(both):
    """(JAX EchoTTS, port EchoTTS), both with the DiT and the AE in bf16."""
    import dataclasses

    jtts, ttts = both
    jd, ja = np_tree(jtts.dit_params), np_tree(jtts.ae_params)
    bf = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)  # noqa: E731
    return (dataclasses.replace(jtts, dit_params=bf(jd), ae_params=bf(ja),
                                model_dtype=jnp.bfloat16),
            dataclasses.replace(
                ttts, dit_params=dit_params_from_numpy(jd, CFG, device="cpu", dtype=torch.bfloat16),
                ae_params=ae_params_from_numpy(ja, ACFG, device="cpu", dtype=torch.bfloat16),
                model_dtype=torch.bfloat16))


def _gap(batched, solos) -> float:
    """The largest rel-L2 of a batched row from its solo run."""
    return max(rel_l2(np.asarray(batched[r], np.float32), np.asarray(s, np.float32))
               for r, s in enumerate(solos))


def _decode_gap(jtts, ttts, z, name) -> float:
    """(i): two 8-frame steps of the stateful decode of `z` (2, D, 16), the
    two rows batched against each alone."""
    from echo_tts_tpu.models import s1dac as js1

    if name == "jax":
        params, acfg, init = jtts.ae_params, JACFG, js1.streaming_decode_init
        step = jax.jit(js1.decode_zq_stream_step, static_argnums=(1, 4))
        cast = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    else:
        params, acfg, init, step = ttts.ae_params, ACFG, ts1.streaming_decode_init, \
            ts1.decode_zq_stream_step
        cast = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731

    def run(rows):
        st, out = init(params, acfg, len(rows)), []
        for a, b in ((0, 8), (8, 16)):
            audio, st = step(params, acfg, st, cast(z[rows, :, a:b]))
            out.append(np.asarray(audio.float() if name == "port" else audio, np.float32))
        return np.concatenate(out, -1)

    return _gap(run([0, 1]), [run([r]) for r in range(2)])


def _latents_gap(jtts, ttts, noise, name) -> float:
    """(ii): the latents of two streams on 8-latent blocks (the prompted
    request first, as on the card: the other row's speaker segment is
    padded), batched against each alone: the sampling half of each
    package's stream_blocks_fused (text and speaker KV, then
    sample_block_core a block, which appends the block's latent KV), the
    JAX package's in one jit."""
    from functools import partial

    from echo_tts_tpu.sampling.blockwise import sample_block_core as j_block
    from echo_tts_tpu_torch.sampling.blockwise import sample_block_core as t_block

    reqs = [_requests(2)[1], _requests(2)[0]]
    sizes = tpipe._block_schedule(8, SAMPLER["sequence_length"], CFG.speaker_patch_size)
    total = sum(sizes)

    def blocks(m, block, sc, tts, spk, sm, ids, tm, nz, zeros):
        p = tts.dit_params
        kv_t = m.get_kv_cache_text(p, tts.dit_cfg, ids, tm)
        kv_s = m.get_kv_cache_speaker(p, tts.dit_cfg, spk.astype(tts.model_dtype)
                                      if name == "jax" else spk.to(tts.model_dtype))
        lat = m.init_latent_kv_state(p, tts.dit_cfg, ids.shape[0], total, tts.model_dtype)
        prefix, start = zeros, 0
        for bs in sizes:
            prefix, lat = block(p, tts.dit_cfg, sc, prefix, lat, start, nz[:, start:start + bs],
                                tm, sm, kv_t, kv_s, bs, total, tts.model_dtype)
            start += bs
        return prefix

    def run(rows):
        if name == "jax":
            preps = [jpipe._prepare_inputs(jtts, reqs[r][0], reqs[r][1], True, None, None, True)
                     for r in rows]
            ids, tm, spk, sm = (np.concatenate([jpipe._pad_to(np.asarray(p[i]), max(
                q[i].shape[1] for q in preps)) for p in preps]) for i in (0, 1, 3, 4))
            fn = jax.jit(partial(blocks, jdit, lambda *a: j_block(*a[:5], jnp.int32(a[5]),
                                                                  *a[6:]),
                                 jc.SamplerConfig(**SAMPLER), jtts))
            return np.asarray(fn(spk, sm, ids, tm, noise[rows],
                                 jnp.zeros((len(rows), total, 80), jnp.float32)))
        preps = [tpipe._prepare_inputs(ttts, reqs[r][0], reqs[r][1], True, None, None, True)
                 for r in rows]
        ids, tm, spk, sm = tpipe._stack_padded(preps, "cpu")
        with torch.no_grad():
            return blocks(tdit, t_block, tc.SamplerConfig(**SAMPLER), ttts, spk, sm, ids, tm,
                          torch.from_numpy(noise[rows]), torch.zeros(len(rows), total, 80)
                          ).float().numpy()

    return _gap(run([0, 1]), [run([r])[0] for r in range(2)])


@pytest.mark.parametrize("part", ["decode", "latents"])
def test_stream_rows_bf16_gap_matches_jax(both, part):
    """The gap of a stream row at B=2 from its solo stream, in bf16, split in
    two and read in each package on the same weights and inputs: (i) the
    stateful decode of identical latents, batched against solo; (ii) the
    sampled latents of the stream rows against each row's solo stream on
    the same noise. The port's gap stays within BF16_FACTOR times the JAX
    package's own, or under SPLIT_FLOOR. On these inputs both packages
    read 0 for both parts: on the CPU a row's bits do not depend on the
    batch, so a fault in the per-row paths (the latent-KV append at B>1,
    the per-row RoPE, the padded speaker segment, the per-row decoder
    position) would show here as a gap of its own."""
    jtts, ttts = _bf16_pair(both)
    rng = np.random.default_rng(31)
    if part == "decode":
        z = (0.5 * rng.standard_normal((2, ACFG.latent_dim, 16))).astype(np.float32)
        gaps = {n: _decode_gap(jtts, ttts, z, n) for n in ("jax", "port")}
    else:
        noise = rng.standard_normal((2, SAMPLER["sequence_length"], 80)).astype(np.float32)
        gaps = {n: _latents_gap(jtts, ttts, noise, n) for n in ("jax", "port")}
    print(f"bf16 {part}, batched-vs-solo rel-L2: JAX {gaps['jax']:.3e}, port {gaps['port']:.3e}")
    assert gaps["port"] <= max(BF16_FACTOR * gaps["jax"], SPLIT_FLOOR), gaps
