"""The port's continuous stream scheduler (echo_tts_tpu_torch.serve.continuous),
its FIFO device lock (utils/locks.py) and the arrival-trace bench
(bench/trace.py), mirroring the JAX package's tests/test_continuous_fairness.py
and tests/test_trace_bench.py: FairLock order and no starvation; the
continuous engine's rows against the JAX continuous engine's for the same
staggered requests (rel-L2 <= 1e-4, equal lengths) and against the port's
solo streams (atol 2e-5, as the JAX package holds its own); the fast join
emits before the first group step; first_block_steps; a burst admitted at
one boundary in one resize; close() with an active group; set_lora under
load; run_trace in dispatch and continuous mode and its seeded arrivals.
Tiny configs, fp32, on the CPU; every wait is bounded and every Engine is
closed."""
import dataclasses
import threading
import time
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from echo_tts_tpu.core import config as jc
from echo_tts_tpu.serve.engine import Engine as JEngine
from echo_tts_tpu.train.lora import LoRAConfig as JLoRAConfig
from echo_tts_tpu.train.lora import init_lora as j_init_lora
from echo_tts_tpu.train.lora import save_lora_checkpoint as j_save_lora
from echo_tts_tpu_torch.bench import trace
from echo_tts_tpu_torch.core import config as tc
from echo_tts_tpu_torch.pipeline import pipeline as pl
from echo_tts_tpu_torch.serve import continuous as cont
from echo_tts_tpu_torch.serve.engine import Engine
from echo_tts_tpu_torch.utils.locks import FairLock

from torch_parity import rel_l2, tiny_pair

PIPE = dict(text_buckets=(768,), speaker_buckets=(32, 64), audio_chunk_latents=32,
            max_speaker_latent_length=64)
SAMPLER = dict(num_steps=2, sequence_length=16, truncation_factor=0.8)
SC, JSC = tc.SamplerConfig(**SAMPLER), jc.SamplerConfig(**SAMPLER)
WAIT_S = 120


@pytest.fixture(scope="module")
def both():
    return tiny_pair(41, 42, PIPE)


@pytest.fixture
def engines():
    made = []

    def make(cls, tts, **kw):
        made.append(cls(dataclasses.replace(tts), **kw))
        return made[-1]

    yield make
    for e in made:
        e.close()


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a request did not finish in time"


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def _solo(ttts, text, seed, sc=SC, block_size=4):
    return np.concatenate(list(pl.sample_pipeline_stream(
        ttts, text, None, seed, sc=sc, block_size=block_size, normalize_text=True)), axis=-1)


def _slow_steps(monkeypatch, seconds=0.05):
    """Each group step takes at least `seconds`, so a stream of many blocks
    is reliably live while a test acts on it."""
    real = pl._stream_step_rows

    def slow(*a, **k):
        time.sleep(seconds)
        return real(*a, **k)

    monkeypatch.setattr(pl, "_stream_step_rows", slow)


def _live_group(eng):
    _wait(lambda: any(s.n_active >= 1 for s in list(eng._cont_scheds.values())),
          "a live group")
    return next(iter(eng._cont_scheds.values()))


# -- FairLock ---------------------------------------------------------------

def test_fair_lock_fifo_order():
    lock = FairLock()
    order = []

    def worker(i):
        with lock:
            order.append(i)

    threads = []
    with lock:
        for i in range(5):
            t = threading.Thread(target=worker, args=(i,))
            t.start()
            threads.append(t)
            _wait(lambda: len(lock._waiters) == i + 1, f"waiter {i} to queue")
    _join(threads)
    assert order == [0, 1, 2, 3, 4]
    with pytest.raises(RuntimeError, match="unheld"):
        lock.release()


def test_fair_lock_no_starvation_under_reacquire_loop():
    lock = FairLock()
    stop, got_it = threading.Event(), threading.Event()

    def hog():
        while not stop.is_set():
            with lock:
                pass

    h = threading.Thread(target=hog)
    h.start()
    try:
        w = threading.Thread(target=lambda: lock.acquire() and (got_it.set(), lock.release()))
        w.start()
        assert got_it.wait(timeout=10), "waiter starved behind a re-acquire loop"
        _join([w])
    finally:
        stop.set()
        _join([h])


# -- the continuous engine against the JAX package's --------------------------

def _staggered(eng, texts):
    """Stream the first request, start the second once the first's group is
    live; {seed: audio}."""
    got = {}

    def run(seed):
        got[seed] = np.concatenate(list(eng.generate_stream(
            texts[seed], None, seed=seed, sc=eng_sc(eng), block_size=4)), axis=-1)

    seeds = list(texts)
    ta = threading.Thread(target=run, args=(seeds[0],))
    ta.start()
    _wait(lambda: ta.ident and (seeds[0] in got or any(
        s.n_active >= 1 for s in list(eng._cont_scheds.values()))), "the first stream's group")
    tb = threading.Thread(target=run, args=(seeds[1],))
    tb.start()
    _join([ta, tb])
    return got


def eng_sc(eng):
    return JSC if isinstance(eng, JEngine) else SC


def test_continuous_rows_match_jax(both, engines, monkeypatch):
    """The same staggered streams through the JAX continuous engine and the
    port's: each stream's audio agrees, and equals the port's solo stream."""
    jtts, ttts = both
    texts = {50: "Continuous row A.", 51: "Continuous row B, joining later."}
    _slow_steps(monkeypatch, 0.02)
    ref = _staggered(engines(JEngine, jtts, max_batch=2, continuous=True), texts)
    eng = engines(Engine, ttts, max_batch=2, continuous=True)
    got = _staggered(eng, texts)
    for seed, text in texts.items():
        assert got[seed].shape == ref[seed].shape and got[seed].shape[-1] > 0
        assert rel_l2(got[seed], ref[seed]) <= 1e-4, seed
        np.testing.assert_allclose(got[seed], _solo(ttts, text, seed), atol=2e-5, rtol=0)
    h = eng.health()
    assert h["requests"] == 2 and h["failures"] == 0 and h["batches"] >= 1


def test_continuous_row_with_a_smaller_text_bucket(both, engines):
    """With several text buckets a row's text lands in a smaller bucket
    than the group's (the largest): its inputs are padded to the group's
    length and its audio equals the solo stream's. (The JAX package's
    scheduler writes the shorter mask unpadded and raises here.)"""
    _, ttts = both
    tts = dataclasses.replace(ttts, pipe_cfg=dataclasses.replace(ttts.pipe_cfg,
                                                                 text_buckets=(32, 768)))
    eng = engines(Engine, tts, max_batch=2, continuous=True)
    got = np.concatenate(list(eng.generate_stream("Short.", None, seed=2, sc=SC, block_size=4)),
                         axis=-1)
    np.testing.assert_allclose(got, _solo(tts, "Short.", 2), atol=2e-5, rtol=0)


def test_fast_join_emits_before_group_step(both, engines, monkeypatch):
    """Every admission goes through the fast join and pushes the joiner's
    first chunk before the boundary's group step; audio equals solo."""
    _, ttts = both
    events = []  # appended from the scheduler thread only
    real_join, real_step, real_emit = (pl._join_row_first_block, pl._stream_step_rows,
                                       cont.ContinuousStreamScheduler._emit)

    def join_spy(*a, **k):
        events.append(("join",))
        return real_join(*a, **k)

    def step_spy(*a, **k):
        events.append(("step",))
        time.sleep(0.02)
        return real_step(*a, **k)

    def emit_spy(self, rows, slot, *a, **k):
        events.append(("emit", rows[slot].pos))
        return real_emit(self, rows, slot, *a, **k)

    monkeypatch.setattr(pl, "_join_row_first_block", join_spy)
    monkeypatch.setattr(pl, "_stream_step_rows", step_spy)
    monkeypatch.setattr(cont.ContinuousStreamScheduler, "_emit", emit_spy)
    texts = {80: "Fast join A.", 81: "Fast join B, later."}
    got = _staggered(engines(Engine, ttts, max_batch=2, continuous=True), texts)
    for seed, text in texts.items():
        np.testing.assert_allclose(got[seed], _solo(ttts, text, seed), atol=2e-5, rtol=0)
    joins = [i for i, e in enumerate(events) if e[0] == "join"]
    assert len(joins) == 2, events
    for j in joins:
        assert events[j + 1] == ("emit", 0), events[j:j + 3]


def test_continuous_first_block_steps(both, engines):
    """first_block_steps reaches continuous mode through the fast join (the
    stream equals the solo pipeline with the same knob), and requests with
    and without it share one group key."""
    _, ttts = both
    sc_fb = dataclasses.replace(SC, first_block_steps=1)
    eng = engines(Engine, ttts, max_batch=2, continuous=True)
    got = np.concatenate(list(eng.generate_stream("First block steps.", None, seed=9, sc=sc_fb,
                                                  block_size=8)), axis=-1)
    key = next(iter(eng._cont_scheds))
    got_plain = np.concatenate(list(eng.generate_stream("First block steps.", None, seed=9,
                                                        sc=SC, block_size=8)), axis=-1)
    assert list(eng._cont_scheds) == [key]
    np.testing.assert_allclose(got, _solo(ttts, "First block steps.", 9, sc=sc_fb, block_size=8),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_plain, _solo(ttts, "First block steps.", 9, block_size=8),
                               atol=2e-5, rtol=0)
    n = min(got.shape[-1], got_plain.shape[-1])
    assert not np.allclose(got[..., :n], got_plain[..., :n])


def test_burst_admitted_at_one_boundary(both, engines, monkeypatch):
    """Four arrivals at an idle group are admitted at the first boundary
    through one resize 1 -> 4."""
    _, ttts = both
    resizes = []
    real_resize = pl._resize_group

    def resize_spy(gs, perm, keep):
        resizes.append((int(gs["prefix"].shape[0]), len(perm)))
        return real_resize(gs, perm, keep)

    monkeypatch.setattr(pl, "_resize_group", resize_spy)
    eng = engines(Engine, ttts, max_batch=4, continuous=True)
    texts = {90 + i: f"Burst stream {i}." for i in range(4)}
    got = {}

    def run(seed):
        got[seed] = np.concatenate(list(eng.generate_stream(texts[seed], None, seed=seed, sc=SC,
                                                            block_size=4)), axis=-1)

    threads = [threading.Thread(target=run, args=(s,)) for s in texts]
    with eng._lock:  # the scheduler cannot reach its first boundary yet
        for t in threads:
            t.start()
        _wait(lambda: any(s.pending.qsize() == 4 for s in list(eng._cont_scheds.values())),
              "the whole burst to queue")
        sched = next(iter(eng._cont_scheds.values()))
    _join(threads)
    assert sched.n_joined == 4 and sched.max_b == 4
    assert [(a, b) for a, b in resizes if b > a] == [(1, 4)], resizes
    for seed, text in texts.items():
        np.testing.assert_allclose(got[seed], _solo(ttts, text, seed), atol=2e-5, rtol=0)


def test_close_with_active_group_unblocks_clients(both, engines, monkeypatch):
    _, ttts = both
    _slow_steps(monkeypatch)
    sc = dataclasses.replace(SC, sequence_length=64)  # 16 blocks: mid-flight at close
    eng = engines(Engine, ttts, max_batch=2, continuous=True)
    result = {}

    def run():
        chunks = []
        try:
            for c in eng.generate_stream("Close mid stream.", None, seed=3, sc=sc, block_size=4):
                chunks.append(c)
            result["end"] = "clean"
        except RuntimeError as e:
            result["end"] = f"error: {e}"
        result["chunks"] = len(chunks)

    t = threading.Thread(target=run)
    t.start()
    sched = _live_group(eng)
    eng.close()
    _join([t, sched.thread])
    # 16 blocks at >= 50 ms a step: the close came mid-stream
    assert result["end"] == "error: engine closed" and result["chunks"] < 16
    with pytest.raises(RuntimeError, match="engine is closed"):
        list(eng.generate_stream("After close.", None, seed=4, sc=SC, block_size=4))


def test_set_lora_under_continuous_load(both, engines, monkeypatch, tmp_path):
    """set_lora during a live group returns before the group ends; the live
    group finishes on the params it started with, and a stream issued after
    the swap uses the merged params."""
    jtts, ttts = both
    _slow_steps(monkeypatch)
    sc = dataclasses.replace(SC, sequence_length=64)
    lc = JLoRAConfig(rank=2)
    lora = j_init_lora(jax.random.PRNGKey(0), jtts.dit_params, lc)
    lora["blocks.attention.wq"]["b"] = jnp.ones_like(lora["blocks.attention.wq"]["b"]) * 0.1
    path = str(tmp_path / "lora.npz")
    j_save_lora(path, lora, lc)
    eng = engines(Engine, ttts, max_batch=2, continuous=True)
    live = {}
    t = threading.Thread(target=lambda: live.update(out=np.concatenate(list(eng.generate_stream(
        "Live during swap.", None, seed=11, sc=sc, block_size=4)), axis=-1)))
    t.start()
    sched = _live_group(eng)
    swap = threading.Thread(target=eng.set_lora, args=(path,))
    swap.start()
    _join([swap])
    assert t.is_alive(), "the group ended before the swap: the test shows nothing"
    _join([t, sched.thread])
    np.testing.assert_allclose(live["out"], _solo(ttts, "Live during swap.", 11, sc=sc),
                               atol=2e-5, rtol=0)
    after = np.concatenate(list(eng.generate_stream("After the swap.", None, seed=12, sc=SC,
                                                    block_size=4)), axis=-1)
    merged = dataclasses.replace(ttts, dit_params=eng.tts.dit_params)
    np.testing.assert_allclose(after, _solo(merged, "After the swap.", 12), atol=2e-5, rtol=0)
    plain = _solo(ttts, "After the swap.", 12)
    n = min(after.shape[-1], plain.shape[-1])
    assert not np.allclose(after[..., :n], plain[..., :n])


def test_oneshot_interleaves_with_live_group(both, engines, monkeypatch):
    """A one-shot request completes while a continuous group is live (the
    scheduler yields the lock at each boundary) and equals its solo run."""
    _, ttts = both
    _slow_steps(monkeypatch)
    sc = dataclasses.replace(SC, sequence_length=64)
    eng = engines(Engine, ttts, max_batch=2, continuous=True)
    t = threading.Thread(target=lambda: list(eng.generate_stream(
        "A long live stream.", None, seed=21, sc=sc, block_size=4)))
    t.start()
    sched = _live_group(eng)
    audio, _, _ = eng.generate("Quick one shot.", None, seed=22, sc=SC)
    assert sched.thread.is_alive(), "the group ended first: the interleave was not shown"
    ref, _, _ = pl.sample_pipeline(ttts, "Quick one shot.", None, 22, sc=SC, normalize_text=True)
    np.testing.assert_allclose(audio, ref, atol=2e-5, rtol=0)
    _join([t])


# -- the arrival-trace bench -------------------------------------------------

def _check_summary(s, n):
    assert s["n_ok"] == n, s
    assert s["n_hung"] == 0 and not s["errors"]
    assert s["achieved_audio_s_per_s"] > 0
    assert 0 < s["ttfa_p50_s"] <= s["ttfa_p95_s"] <= s["completion_p95_s"]
    assert s["completion_p50_s"] <= s["completion_p95_s"]


@pytest.mark.parametrize("mode", ["dispatch", "continuous", "mixed keys"])
def test_run_trace(both, engines, mode):
    _, ttts = both
    kw = dict(max_batch=2, continuous=mode != "dispatch")
    if mode == "continuous":
        kw["max_batch"] = 4
    eng = engines(Engine, ttts, **kw)
    n = 4 if mode == "dispatch" else 6
    s = trace.run_trace(eng, SC, n_requests=n, rate_hz=50.0, block_size=(4,),
                        block_size_mix=[4, 8] if mode == "mixed keys" else None, timeout_s=WAIT_S)
    _check_summary(s, n)
    assert eng.health()["batches"] >= 1
    if mode == "mixed keys":
        assert len(eng._cont_scheds) == 2, list(eng._cont_scheds)


def test_run_trace_arrivals_reproducible():
    """One seed gives one arrival schedule: the gaps between submissions
    of two runs agree to the host's sleep granularity."""
    def fake_engine(log):
        def generate_stream(text, speaker, seed, sc, block_size):
            log.append((seed, time.perf_counter()))
            yield np.zeros((1, 1, 441), np.float32)

        return types.SimpleNamespace(tts=types.SimpleNamespace(
            ae_cfg=types.SimpleNamespace(sample_rate=44100)), generate_stream=generate_stream)

    gaps = []
    for _ in range(2):
        log = []
        s = trace.run_trace(fake_engine(log), SC, n_requests=6, rate_hz=20.0, seed=7,
                            timeout_s=WAIT_S)
        assert s["n_ok"] == 6 and s["n_hung"] == 0
        times = [t for _, t in sorted(log)]
        gaps.append(np.diff(times))
    arrivals = np.diff(np.cumsum(np.random.default_rng(7).exponential(1 / 20.0, size=6)))
    np.testing.assert_allclose(gaps[0], arrivals, atol=0.02)
    np.testing.assert_allclose(gaps[1], gaps[0], atol=0.02)
