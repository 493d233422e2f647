"""The port's continuous stream group (echo_tts_tpu_torch) against the JAX
package's on the same weights (JAX initializers, carried over by
checkpoints/from_jax.py) and the same numpy inputs: rows of one batch at
their own stream positions. Per-row extend_latent_kv and sample_block_core,
valid_len as K1's self_len on a partial final block (the JAX side through
XLA and through the Pallas K1 in interpret mode), the per-row stateful
decode with perturbed residual biases (the JAX side once through the Pallas
K2 in interpret mode), and the group functions _join_row,
_join_row_first_block, _stream_step_rows and _resize_group in the
sequences of the JAX package's tests/test_continuous_batching.py. Live rows
only are compared, as there. Tiny configs with the latent modules, fp32 on
the CPU: atol 1e-5 / rtol 1e-4 for modules, rel-L2 <= 1e-4 for audio."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echo_tts_tpu.bench.init_ae import init_ae_params as j_init_ae
from echo_tts_tpu.core import config as jc
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.models import s1dac as js1
from echo_tts_tpu.models.pca import PCAState as JPCAState
from echo_tts_tpu.pipeline import pipeline as jpipe
from echo_tts_tpu.sampling import blockwise as jbw
from echo_tts_tpu_torch.checkpoints.from_jax import ae_params_from_numpy, dit_params_from_numpy
from echo_tts_tpu_torch.core import config as tc
from echo_tts_tpu_torch.models import dit as tdit
from echo_tts_tpu_torch.models import s1dac as ts1
from echo_tts_tpu_torch.models.pca import PCAState
from echo_tts_tpu_torch.pipeline import pipeline as tpipe
from echo_tts_tpu_torch.sampling import blockwise as tbw

from torch_parity import assert_close, np_tree, perturb_res_biases, rel_l2, t

CFG = tc.DiTConfig().tiny()
JCFG = jc.DiTConfig().tiny()
ACFG = tc.AEConfig().tiny()
JACFG = jc.AEConfig().tiny()
SAMPLER = dict(num_steps=2, sequence_length=16, truncation_factor=0.8)
SC, JSC = tc.SamplerConfig(**SAMPLER), jc.SamplerConfig(**SAMPLER)
TOTAL = 16


@pytest.fixture(scope="module")
def both():
    jp = jax.jit(lambda k: jdit.init_dit_params(k, JCFG, dtype=jnp.float32))(
        jax.random.PRNGKey(14))
    ja = perturb_res_biases(np_tree(jax.jit(lambda k: j_init_ae(k, JACFG, dtype=jnp.float32))(
        jax.random.PRNGKey(15))), 16)
    jtts = jpipe.EchoTTS(jp, JCFG, jax.tree_util.tree_map(jnp.asarray, ja), JACFG,
                         JPCAState.random(0, JACFG.latent_dim), model_dtype=jnp.float32)
    ttts = tpipe.EchoTTS(dit_params_from_numpy(np_tree(jp), CFG, device="cpu"), CFG,
                         ae_params_from_numpy(ja, ACFG, device="cpu"), ACFG,
                         PCAState.random(0, ACFG.latent_dim, device="cpu"),
                         model_dtype=torch.float32, device="cpu")
    return jtts, ttts


def _latents(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _ctx(b, seed):
    """b rows of text and speaker conditioning, each row its own lengths."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, 12)).astype(np.int32)
    tmask = np.arange(12)[None] < np.array([12, 7, 9, 5][:b])[:, None]
    spk = rng.standard_normal((b, 16, 80)).astype(np.float32)
    smask = np.arange(16)[None] < np.array([16, 10, 0, 6][:b])[:, None]
    return ids, tmask, spk, smask


def _caches(jtts, ttts, ids, tmask, spk):
    j = (jdit.get_kv_cache_text(jtts.dit_params, JCFG, jnp.asarray(ids), jnp.asarray(tmask)),
         jdit.get_kv_cache_speaker(jtts.dit_params, JCFG, jnp.asarray(spk)))
    p = (tdit.get_kv_cache_text(ttts.dit_params, CFG, t(ids), t(tmask)),
         tdit.get_kv_cache_speaker(ttts.dit_params, CFG, t(spk)))
    return j, p


# ---------------------------------------------------------------------------
# per-row latent KV and block sampler
# ---------------------------------------------------------------------------


def test_extend_latent_kv_per_row(both):
    """Rows at patches 2 and 1 (latents 8 and 4): every buffer equals the
    JAX package's per-row append, and each row its own solo append. A free
    slot far past the buffer (latent 40) neither raises nor touches the
    live row."""
    jtts, ttts = both
    lat = _latents((2, 8, 80), 3)
    js = jdit.extend_latent_kv(jtts.dit_params, JCFG,
                               jdit.init_latent_kv_state(jtts.dit_params, JCFG, 2, TOTAL,
                                                         jnp.float32),
                               jnp.asarray(lat), jnp.array([8, 4]))
    ts = tdit.init_latent_kv_state(ttts.dit_params, CFG, 2, TOTAL, torch.float32)
    assert tdit.extend_latent_kv(ttts.dit_params, CFG, ts, t(lat), torch.tensor([8, 4])) is ts
    for name in ("enc_k", "enc_v", "k", "v"):
        assert_close(ts[name], js[name], atol=1e-5, rtol=1e-4)
    for r, sp in enumerate((8, 4)):
        solo = tdit.init_latent_kv_state(ttts.dit_params, CFG, 1, TOTAL, torch.float32)
        tdit.extend_latent_kv(ttts.dit_params, CFG, solo, t(lat[r:r + 1]), sp)
        for name in ("enc_k", "enc_v", "k", "v"):
            assert_close(ts[name][:, r:r + 1], solo[name].numpy(), atol=1e-5, rtol=1e-4)
    free = tdit.init_latent_kv_state(ttts.dit_params, CFG, 2, TOTAL, torch.float32)
    tdit.extend_latent_kv(ttts.dit_params, CFG, free, t(lat), [8, 40])
    for name in ("enc_k", "enc_v", "k", "v"):
        torch.testing.assert_close(free[name][:, 0], ts[name][:, 0], rtol=0, atol=0)


def _seeded_state(params, cfg, mod, dtype, seed_lat):
    """Both rows' latent KV seeded at 0 with 8 latents; row 1's last 4 are
    zeros, past its start position and so masked."""
    seeded = seed_lat.copy()
    seeded[1, 4:] = 0.0
    st = mod.init_latent_kv_state(params, cfg, 2, TOTAL, dtype)
    if mod is jdit:
        return mod.extend_latent_kv(params, cfg, st, jnp.asarray(seeded), jnp.array([0, 0]))
    return mod.extend_latent_kv(params, cfg, st, t(seeded), torch.tensor([0, 0]))


def test_sample_block_core_per_row(both):
    """A B=2 block at start_pos [8, 4]: per-row query RoPE, latent-key
    gating and prefix writes equal the JAX package's, and each row's block
    equals its own solo step."""
    jtts, ttts = both
    ids, tmask, spk, smask = _ctx(2, 5)
    (jkt, jks), (tkt, tks) = _caches(jtts, ttts, ids, tmask, spk)
    seed_lat = _latents((2, 8, 80), 6)
    noise = _latents((2, 4, 80), 7)
    prefix = np.zeros((2, TOTAL, 80), np.float32)
    prefix[0, :8] = seed_lat[0]
    prefix[1, :4] = seed_lat[1, :4]
    jst = _seeded_state(jtts.dit_params, JCFG, jdit, jnp.float32, seed_lat)
    tst = _seeded_state(ttts.dit_params, CFG, tdit, torch.float32, seed_lat)
    jp, jst = jbw.sample_block_core(jtts.dit_params, JCFG, JSC, jnp.asarray(prefix), jst,
                                    jnp.array([8, 4]), jnp.asarray(noise), jnp.asarray(tmask),
                                    jnp.asarray(smask), jkt, jks, 4, TOTAL, jnp.float32)
    tp, tst = tbw.sample_block_core(ttts.dit_params, CFG, SC, t(prefix), tst, [8, 4], t(noise),
                                    t(tmask), t(smask), tkt, tks, 4, TOTAL, torch.float32)
    assert_close(tp, jp, atol=1e-5, rtol=1e-4)
    for name in ("enc_k", "enc_v", "k", "v"):
        assert_close(tst[name], jst[name], atol=1e-5, rtol=1e-4)
    for r, sp in enumerate((8, 4)):
        st1 = tdit.init_latent_kv_state(ttts.dit_params, CFG, 1, TOTAL, torch.float32)
        seeded = seed_lat[r:r + 1].copy()
        seeded[:, sp:] = 0.0
        tdit.extend_latent_kv(ttts.dit_params, CFG, st1, t(seeded), 0)
        p1 = t(prefix[r:r + 1])
        tbw.sample_block_core(ttts.dit_params, CFG, SC, p1, st1, sp, t(noise[r:r + 1]),
                              t(tmask[r:r + 1]), t(smask[r:r + 1]),
                              tuple(a[:, r:r + 1] for a in tkt), tuple(a[:, r:r + 1] for a in tks),
                              4, TOTAL, torch.float32)
        assert_close(tp[r, sp:sp + 4], p1[0, sp:sp + 4].numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
def test_valid_len_masks_partial_final_block(both, jax_impl):
    """An 8-latent block with valid_len 4: the whole block equals the JAX
    package's (its K1 through XLA or the Pallas kernel in interpret mode),
    and the 4 valid positions equal a solo 4-latent block: the in-block
    keys past the budget are hidden."""
    jtts, ttts = both
    ids, tmask, spk, smask = _ctx(1, 8)
    (jkt, jks), (tkt, tks) = _caches(jtts, ttts, ids, tmask, spk)
    noise = _latents((1, 8, 80), 9)
    jdit.set_attention_impl(jax_impl)
    try:
        ref, _ = jbw.sample_block_core(
            jtts.dit_params, JCFG, JSC, jnp.zeros((1, TOTAL, 80)),
            jdit.init_latent_kv_state(jtts.dit_params, JCFG, 1, TOTAL, jnp.float32),
            jnp.array([0]), jnp.asarray(noise), jnp.asarray(tmask), jnp.asarray(smask), jkt, jks,
            8, TOTAL, jnp.float32, valid_len=jnp.array([4]))
    finally:
        jdit.set_attention_impl("auto")

    def port(n, start, valid_len):
        prefix = torch.zeros(1, TOTAL, 80)
        tbw.sample_block_core(ttts.dit_params, CFG, SC, prefix,
                              tdit.init_latent_kv_state(ttts.dit_params, CFG, 1, TOTAL,
                                                        torch.float32),
                              start, t(noise[:, :n]), t(tmask), t(smask), tkt, tks, n, TOTAL,
                              torch.float32, valid_len=valid_len)
        return prefix

    got = port(8, [0], [4])
    assert_close(got, ref, atol=1e-5, rtol=1e-4)
    assert_close(got[:, :4], port(4, 0, None)[:, :4].numpy(), atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# per-row stateful decode
# ---------------------------------------------------------------------------


def _stack_states(states):
    return {k: (torch.cat([s[k] for s in states]) if k in ("pos", "stem", "head")
                else [{kk: torch.cat([s[k][i][kk] for s in states]) for kk in states[0][k][i]}
                      if isinstance(states[0][k][i], dict)
                      else torch.cat([s[k][i] for s in states])
                      for i in range(len(states[0][k]))])
            for k in states[0]}


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
def test_decode_stream_step_per_row_pos(both, jax_impl):
    """Rows at frame positions 8 and 1, stepped as one batch of 4 frames:
    each row's audio equals the JAX package's per-row step (its K2 through
    XLA or the Pallas kernel in interpret mode, with its per-row
    zero_below), and its own solo step. Row 1's chains are still re-zeroing
    (zero_below > 0), row 0's are not."""
    jtts, ttts = both
    z = _latents((2, ACFG.latent_dim, 12), 10, 0.3)
    adv = (8, 1)
    states, solo = [], []
    for r, n in enumerate(adv):
        st = ts1.streaming_decode_init(ttts.ae_params, ACFG, 1, per_row_pos=True)
        assert st["pos"].dtype == torch.int32 and st["pos"].shape == (1,)
        _, st = ts1.decode_zq_stream_step(ttts.ae_params, ACFG, st, t(z[r:r + 1, :, :n]), 64)
        states.append(st)
        solo.append(ts1.decode_zq_stream_step(ttts.ae_params, ACFG, st,
                                              t(z[r:r + 1, :, n:n + 4]), 64)[0])
    chunk = np.stack([z[r, :, n:n + 4] for r, n in enumerate(adv)])
    got, new = ts1.decode_zq_stream_step(ttts.ae_params, ACFG, _stack_states(states), t(chunk),
                                         64)
    assert new["pos"].tolist() == [12, 5]

    js1.set_conv_impl(jax_impl)
    try:  # a jit of its own: the conv impl is read when the step is traced
        step = jax.jit(js1.decode_zq_stream_step, static_argnames=("cfg", "max_positions"))
        jstates = []
        for r, n in enumerate(adv):
            st = js1.streaming_decode_init(jtts.ae_params, JACFG, 1, dtype=jnp.float32,
                                           per_row_pos=True)
            jstates.append(step(jtts.ae_params, JACFG, st, jnp.asarray(z[r:r + 1, :, :n]), 64)[1])
        stacked = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]), *jstates)
        ref, _ = step(jtts.ae_params, JACFG, stacked, jnp.asarray(chunk), 64)
    finally:
        js1.set_conv_impl("auto")
    assert rel_l2(got, ref) <= 1e-4
    for r in range(2):
        assert rel_l2(got[r:r + 1], solo[r]) <= 1e-4


# ---------------------------------------------------------------------------
# the group functions
# ---------------------------------------------------------------------------

BS = 8


def _requests(seed, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n):
        ids = rng.integers(0, 256, (1, 12)).astype(np.int32)
        tmask = np.arange(12)[None] < 12 - 3 * r
        spk = rng.standard_normal((1, 16, 80)).astype(np.float32)
        smask = np.arange(16)[None] < 16 - 4 * r
        out.append((ids, tmask, spk, smask))
    return out


class Group:
    """One group driven the same way through both packages; records each
    step's audio and block latents of the live rows."""

    def __init__(self, jtts, ttts, b, total, sc=SAMPLER):
        self.jtts, self.ttts, self.total = jtts, ttts, total
        self.sc, self.jsc = tc.SamplerConfig(**sc), jc.SamplerConfig(**sc)
        self.js = jpipe.init_stream_group(jtts, b, total, 12, 16)
        self.ts = tpipe.init_stream_group(ttts, b, total, 12, 16)

    def join(self, row, req):
        jt, tt = self.jtts, self.ttts
        self.js = jpipe._join_row(jt.dit_params, JCFG, jt.ae_params, JACFG, self.js, row,
                                  *(jnp.asarray(a) for a in req), jnp.float32)
        assert tpipe._join_row(tt.dit_params, CFG, tt.ae_params, ACFG, self.ts, row,
                               *(t(a) for a in req), torch.float32) is self.ts

    def join_first(self, row, req, noise):
        jt, tt = self.jtts, self.ttts
        self.js, ja, jl = jpipe._join_row_first_block(
            jt.dit_params, JCFG, self.jsc, jt.ae_params, JACFG, jt.pca, self.js, row,
            *(jnp.asarray(a) for a in req), jnp.asarray(noise), BS, self.total, jnp.float32, 64)
        ts, ta, tl = tpipe._join_row_first_block(
            tt.dit_params, CFG, self.sc, tt.ae_params, ACFG, tt.pca, self.ts, row,
            *(t(a) for a in req), t(noise), BS, self.total, torch.float32, 64)
        assert ts is self.ts
        assert_close(tl, jl, atol=1e-5, rtol=1e-4)
        assert rel_l2(ta, ja) <= 1e-4
        return ta.numpy()

    def step(self, starts, valids, noise_rows, live):
        jt, tt = self.jtts, self.ttts
        noise = np.stack(noise_rows)
        self.js, ja, jl = jpipe._stream_step_rows(
            jt.dit_params, JCFG, self.jsc, jt.ae_params, JACFG, jt.pca, self.js,
            jnp.asarray(starts, jnp.int32), jnp.asarray(valids, jnp.int32), jnp.asarray(noise),
            BS, self.total, jnp.float32, 64)
        ts, ta, tl = tpipe._stream_step_rows(
            tt.dit_params, CFG, self.sc, tt.ae_params, ACFG, tt.pca, self.ts, starts, valids,
            noise, BS, self.total, torch.float32, 64)
        assert ts is self.ts
        for r in live:
            n = valids[r]
            assert_close(tl[r, :n], np.asarray(jl)[r, :n], atol=1e-5, rtol=1e-4)
            assert rel_l2(ta[r, :, :n * ACFG.frame_length],
                          np.asarray(ja)[r, :, :n * ACFG.frame_length]) <= 1e-4
        return ta.numpy()

    def resize(self, perm, keep):
        self.js = jpipe._resize_group(self.js, np.asarray(perm, np.int32), np.asarray(keep))
        self.ts = tpipe._resize_group(self.ts, perm, keep)
        assert self.ts["prefix"].shape[0] == len(perm)
        assert self.ts["dec"]["pos"].tolist() == np.asarray(self.js["dec"]["pos"]).tolist()
        np.testing.assert_array_equal(self.ts["text_mask"].numpy(), self.js["text_mask"])


def _solo(ttts, req, noise, sizes, sc=SC):
    """The request's solo stream (port): stream_blocks_fused at B=1."""
    ids, tmask, spk, smask = (t(a) for a in req)
    offs = np.cumsum([0] + list(sizes))
    return [a.numpy() for _, a, _, _ in tpipe.stream_blocks_fused(
        ttts.dit_params, CFG, sc, ttts.ae_params, ACFG, ttts.pca, spk, smask, ids, tmask,
        sizes, [t(noise[:, a:b]) for a, b in zip(offs[:-1], offs[1:])], torch.float32,
        max_positions=64)]


def test_stream_group_join_matches_jax_and_solo(both):
    """Request A starts a 2-slot group; B joins slot 1 at the next block
    boundary (_join_row); A retires, B finishes. Every live row's block
    equals the JAX package's group, and its audio its solo stream."""
    jtts, ttts = both
    reqs = _requests(11)
    noises = [_latents((1, 16, 80), 20 + r) for r in range(2)]
    z8 = np.zeros((BS, 80), np.float32)
    g = Group(jtts, ttts, 2, 16 + BS)
    g.join(0, reqs[0])
    audio = {0: [], 1: []}
    a = g.step([0, 0], [8, 0], [noises[0][0, :8], z8], live=[0])
    audio[0].append(a[0:1])
    g.join(1, reqs[1])
    a = g.step([8, 0], [8, 8], [noises[0][0, 8:], noises[1][0, :8]], live=[0, 1])
    audio[0].append(a[0:1])
    audio[1].append(a[1:2])
    a = g.step([16, 8], [0, 8], [z8, noises[1][0, 8:]], live=[1])
    audio[1].append(a[1:2])
    for r in range(2):
        solo = _solo(ttts, reqs[r], noises[r], (8, 8))
        for got, ref in zip(audio[r], solo):
            assert rel_l2(got, ref) <= 1e-4


def test_stream_group_partial_final_block(both):
    """A 12-latent budget in 8-latent blocks: the final block has
    valid_len 4, and its 4 valid positions equal the solo (8, 4) stream's;
    the free slot 1 runs beside it with valid_len 0."""
    jtts, ttts = both
    req = _requests(13, 1)[0]
    noise = _latents((1, 12, 80), 31)
    sc = dict(SAMPLER, sequence_length=12)
    g = Group(jtts, ttts, 2, 12 + BS, sc=sc)
    g.join(0, req)
    z8 = np.zeros((BS, 80), np.float32)
    spl = ACFG.frame_length
    got = [g.step([0, 0], [8, 0], [noise[0, :8], z8], live=[0])[0:1]]
    pad = np.concatenate([noise[0, 8:], np.zeros((4, 80), np.float32)])
    got.append(g.step([8, 0], [4, 0], [pad, z8], live=[0])[0:1, :, :4 * spl])
    solo = _solo(ttts, req, noise, (8, 4), sc=tc.SamplerConfig(**sc))
    for a, b in zip(got, solo):
        assert rel_l2(a, b) <= 1e-4


def test_resize_group_elastic(both):
    """Grow 1 -> 2 to admit B, then shrink 2 -> 1 with B moved from slot 1
    to slot 0 after A retires; the rows' streams go on as their solo runs,
    and every step equals the JAX package's."""
    jtts, ttts = both
    reqs = _requests(17)
    noises = [_latents((1, 16, 80), 60 + r) for r in range(2)]
    g = Group(jtts, ttts, 1, 16 + BS)
    g.join(0, reqs[0])
    audio = {0: [g.step([0], [8], [noises[0][0, :8]], live=[0])[0:1]], 1: []}
    g.resize([0, 0], [True, False])
    g.join(1, reqs[1])
    a = g.step([8, 0], [8, 8], [noises[0][0, 8:], noises[1][0, :8]], live=[0, 1])
    audio[0].append(a[0:1])
    audio[1].append(a[1:2])
    g.resize([1], [True])
    audio[1].append(g.step([8], [8], [noises[1][0, 8:]], live=[0])[0:1])
    for r in range(2):
        for got, ref in zip(audio[r], _solo(ttts, reqs[r], noises[r], (8, 8))):
            assert rel_l2(got, ref) <= 1e-4


def test_join_row_first_block(both):
    """Row 0 joins with its first block sampled alone
    (_join_row_first_block), row 1 by _join_row; the group then continues
    row 0 at 8 and starts row 1 at 0. Both packages agree at every call,
    and row 0's two blocks equal its solo stream."""
    jtts, ttts = both
    reqs = _requests(19)
    noises = [_latents((1, 16, 80), 70 + r) for r in range(2)]
    g = Group(jtts, ttts, 2, 16 + BS)
    first = g.join_first(0, reqs[0], noises[0][:, :8])
    g.join(1, reqs[1])
    a = g.step([8, 0], [8, 8], [noises[0][0, 8:], noises[1][0, :8]], live=[0, 1])
    for got, ref in zip((first, a[0:1]), _solo(ttts, reqs[0], noises[0], (8, 8))):
        assert rel_l2(got, ref) <= 1e-4
