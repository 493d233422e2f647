"""The port's spans and counters (`utils/profiling.py`): the recorder itself,
and the span trees of a micro-batch, a batched stream and a LoRA step at the
tiny configs on the CPU. No JAX: the port alone."""
import threading
import time

import numpy as np
import pytest
import torch

from echo_tts_tpu_torch.bench.init_ae import init_ae_params
from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig, PipelineConfig, SamplerConfig
from echo_tts_tpu_torch.models.dit import init_dit_params
from echo_tts_tpu_torch.models.pca import PCAState
from echo_tts_tpu_torch.pipeline.pipeline import EchoTTS
from echo_tts_tpu_torch.serve.engine import Engine
from echo_tts_tpu_torch.train import loop
from echo_tts_tpu_torch.train.data import batches_prefetch
from echo_tts_tpu_torch.train.lora import LoRAConfig, init_lora
from echo_tts_tpu_torch.utils import profiling

SC = SamplerConfig(num_steps=3, sequence_length=16, truncation_factor=0.8)
PIPE = PipelineConfig(text_buckets=(64,), speaker_buckets=(32, 64), audio_chunk_latents=32,
                      max_speaker_latent_length=64)
WAIT_S = 120


@pytest.fixture
def recording():
    """Recording on for the test, off and emptied after it."""
    profiling.drain()
    profiling.enable()
    yield
    profiling.disable()
    profiling.drain()


@pytest.fixture(scope="module")
def tts():
    dit_cfg, ae_cfg = DiTConfig().tiny(), AEConfig().tiny()
    return EchoTTS(init_dit_params(dit_cfg, torch.float32, "cpu", seed=0), dit_cfg,
                   init_ae_params(ae_cfg, torch.float32, "cpu", seed=1), ae_cfg,
                   PCAState.random(0, ae_cfg.latent_dim, dit_cfg.latent_size, device="cpu"),
                   model_dtype=torch.float32, pipe_cfg=PIPE, device="cpu")


def _voice(seed, latents=40):
    return (0.2 * np.random.default_rng(seed).standard_normal((1, latents * 16))).astype(
        np.float32)


def _run_together(fns):
    """Each fn on a thread of its own, started together; returns their
    results and thread ids in order."""
    out = [None] * len(fns)

    def one(i):
        out[i] = (fns[i](), threading.get_ident())

    ths = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(len(fns))]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=WAIT_S)
    assert not any(th.is_alive() for th in ths), "a request did not finish in time"
    return out


def _named(recs, name):
    return [r for r in recs if r.name == name]


def test_span_ids_parents_threads_kinds_and_inherited_ids(recording):
    with profiling.span("outer", "host", batch=7, requests=[1, 2]) as outer:
        with profiling.span("inner", "launch", rows=2) as inner:
            inner.set(cache_hit=True)
            with profiling.span("leaf", "sync"):
                pass
        profiling.count("c")
        profiling.count("c", 4)

    def other():
        with profiling.span("elsewhere", "host"):
            with profiling.span("below", "launch", request=9):
                pass

    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=WAIT_S)
    profiling.add("queued", "wait", 10, 20, thread=123, request=1, batch=7)
    recs = {r.name: r for r in profiling.drain()}
    assert profiling.drain() == []
    me = threading.get_ident()
    assert recs["outer"].parent == 0 and recs["inner"].parent == recs["outer"].id
    assert recs["leaf"].parent == recs["inner"].id
    assert len({r.id for r in recs.values()}) == len(recs)
    assert [recs[n].kind for n in ("outer", "inner", "leaf")] == ["host", "launch", "sync"]
    assert {recs[n].thread for n in ("outer", "inner", "leaf")} == {me}
    assert recs["inner"].attrs == {"batch": 7, "requests": [1, 2], "rows": 2, "cache_hit": True}
    assert recs["leaf"].attrs == {"batch": 7, "requests": [1, 2]}
    assert recs["elsewhere"].thread == recs["below"].thread != me
    assert recs["elsewhere"].parent == 0 and recs["below"].parent == recs["elsewhere"].id
    assert recs["below"].attrs == {"request": 9}
    assert recs["queued"][4:] == (10, 20, 123, {"request": 1, "batch": 7})
    o = recs["outer"]
    assert o.t0 == outer.t0 and o.t1 == outer.t1 and outer.seconds == (o.t1 - o.t0) * 1e-9
    assert o.t0 <= recs["inner"].t0 <= recs["leaf"].t0 <= recs["leaf"].t1 <= o.t1
    assert profiling.counters()["c"] == 5


def test_off_records_nothing_and_still_times():
    profiling.disable()
    profiling.drain()
    before = profiling.counters()
    with profiling.span("x", "host", rows=1) as sp:
        time.sleep(0.002)
    sp.set(ignored=True)
    profiling.count("off")
    profiling.add("x", "wait", 1, 2)
    assert profiling.drain() == [] and profiling.counters() == before
    assert 0.002 <= sp.seconds < 1.0 and sp.t1 > sp.t0


def test_ring_is_bounded_and_counts_what_it_drops(recording):
    d0 = profiling.counters().get("tracing.dropped", 0)
    for i in range(profiling.RING + 5):
        profiling.add("r", "host", i, i + 1)
    recs = profiling.drain()
    assert len(recs) == profiling.RING
    assert recs[0].t0 == 5 and recs[-1].t0 == profiling.RING + 4  # the oldest went
    assert profiling.counters()["tracing.dropped"] - d0 == 5


def test_span_clock_is_the_perf_counter_clock():
    """Span stamps (perf_counter_ns) and time.perf_counter() read one clock,
    the one the benchmark's slice maps onto the device trace."""
    for _ in range(5):
        a = time.perf_counter()
        with profiling.span("x", "host") as sp:
            pass
        b = time.perf_counter()
        assert a - 1e-6 <= sp.t0 * 1e-9 <= sp.t1 * 1e-9 <= b + 1e-6


def test_micro_batch_span_tree(tts, recording):
    """Two queued requests, one batch: engine.queue x2 -> engine.form ->
    engine.batch -> pipeline.prepare (codec.encode a row, the second a cache
    hit) -> sampler.step x num_steps -> codec.decode -> pipeline.readback,
    every span carrying the batch id; the timings keep their keys."""
    eng = Engine(tts, max_batch=2, batch_wait_ms=60_000)
    try:
        voice = _voice(3)
        got = _run_together([lambda: eng.generate("One two.", voice, seed=1, sc=SC),
                             lambda: eng.generate("Three four.", voice, seed=2, sc=SC)])
    finally:
        eng.close()
    recs = profiling.drain()
    by_id = {r.id: r for r in recs}
    (batch,) = _named(recs, "engine.batch")
    bid = batch.attrs["batch"]
    assert batch.parent == 0 and batch.kind == "host"
    assert batch.attrs["rows"] == 2 and batch.attrs["padded_rows"] == 2
    queue = _named(recs, "engine.queue")
    assert len(queue) == 2 and {q.kind for q in queue} == {"wait"}
    assert sorted(q.attrs["request"] for q in queue) == sorted(batch.attrs["requests"])
    assert {q.thread for q in queue} == {tid for _, tid in got}
    (form,) = _named(recs, "engine.form")
    assert form.attrs["rows"] == 2 and form.kind == "host"
    assert all(q.t0 <= form.t1 == q.t1 <= batch.t0 for q in queue)
    (prep,) = _named(recs, "pipeline.prepare")
    assert prep.parent == batch.id
    enc = _named(recs, "codec.encode")
    assert [e.attrs["cache_hit"] for e in enc] == [False, True]
    assert all(by_id[e.parent] is prep for e in enc)
    assert [by_id[t.parent] for t in _named(recs, "pipeline.tokenize")] == [prep, prep]
    steps = _named(recs, "sampler.step")
    assert [s.attrs["step"] for s in steps] == list(range(SC.num_steps))
    (dec,) = _named(recs, "codec.decode")
    (rb,) = _named(recs, "pipeline.readback")
    (kv,) = _named(recs, "sampler.kv")  # the text and speaker caches
    assert kv.parent == batch.id and prep.t1 <= kv.t0 <= kv.t1 <= steps[0].t0
    assert prep.t1 <= steps[0].t0 and steps[-1].t1 <= dec.t0 <= dec.t1 <= rb.t0
    assert {s.parent for s in steps} == {dec.parent} == {rb.parent} == {batch.id}
    assert rb.kind == "sync" and dec.kind == "launch" and steps[0].kind == "launch"
    assert len(_named(recs, "pipeline.crop")) == 2
    for r in recs:
        assert r.attrs.get("batch") == bid, r
    for (audio, _, timings), _tid in got:
        assert set(timings) >= {"tokenize", "speaker_encode", "sample", "vocoder", "crop",
                                "total", "batch_size"}
        assert timings["sample"] == pytest.approx((rb.t1 - prep.t1) * 1e-9)
    assert "speaker_encode_cache_hit" in got[0][0][2] or "speaker_encode_cache_hit" in got[1][0][2]


def test_stream_batch_has_a_root_a_block(tts, recording):
    eng = Engine(tts, max_batch=2, batch_wait_ms=60_000)
    try:
        got = _run_together([
            lambda: list(eng.generate_stream("One two.", None, seed=1, sc=SC, block_size=8)),
            lambda: list(eng.generate_stream("Three four.", None, seed=2, sc=SC, block_size=8))])
    finally:
        eng.close()
    assert all(len(chunks) for chunks, _ in got)
    recs = profiling.drain()
    blocks = _named(recs, "engine.stream_block")
    work = [b for b in blocks if not b.attrs.get("end")]
    assert [b.attrs["block"] for b in work] == [0, 1]  # 16 latents in blocks of 8
    assert len(blocks) - len(work) <= 1
    assert all(b.parent == 0 and b.attrs["rows"] == 2 for b in blocks)
    (prep,) = _named(recs, "pipeline.prepare")
    assert prep.parent == work[0].id
    for b in work:
        inside = [r for r in recs if r.parent == b.id]
        names = [r.name for r in inside]
        assert names.count("sampler.step") == SC.num_steps
        assert names.count("codec.decode") == 1 and names.count("pipeline.readback") == 1
        assert names.count("sampler.kv") == 2 - b.attrs["block"]  # + the context caches
        assert names.count("stream.emit") == 2
    assert len(_named(recs, "engine.queue")) == 2
    bid = blocks[0].attrs["batch"]
    assert all(r.attrs.get("batch") == bid for r in recs)


def test_lora_step_span_tree_and_host_syncs(recording):
    cfg = DiTConfig(has_latent_modules=False).tiny()
    base = init_dit_params(cfg, torch.float32, "cpu", seed=4)
    lc = LoRAConfig(rank=2)
    lora = init_lora(torch.Generator().manual_seed(0), base, lc)
    opt, step = loop.make_train_step(cfg, loop.TrainConfig(), model_dtype=torch.float32,
                                     lora_cfg=lc)
    state = opt.init(lora)
    rng = np.random.default_rng(5)

    class Clips:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return {"latent": rng.standard_normal((12, 80)).astype(np.float32),
                    "text": "Some words.",
                    "speaker_latent": rng.standard_normal((8, 80)).astype(np.float32),
                    "speaker_mask": np.ones(8, bool)}

    it = batches_prefetch(Clips(), 2, np.random.default_rng(0))
    c0 = profiling.counters().get("train.host_syncs", 0)
    for _ in range(2):
        lora, state, loss = step(base, lora, state, torch.Generator().manual_seed(7), next(it))
    it.close()
    assert profiling.counters()["train.host_syncs"] - c0 == 6  # three a step
    recs = profiling.drain()
    by_id = {r.id: r for r in recs}
    steps = _named(recs, "train.step")
    assert len(steps) == 2 and all(s.parent == 0 for s in steps)
    for s in steps:
        kids = [r for r in recs if r.parent == s.id]
        assert [k.name for k in kids] == ["train.forward", "train.backward", "train.optimizer"]
        fwd, bwd, opt_span = kids
        assert fwd.t1 <= bwd.t0 and bwd.t1 <= opt_span.t0
        syncs = [r for r in recs if r.name == "train.sync" and s.t0 <= r.t0 <= s.t1]
        assert [(by_id[r.parent].name, r.attrs["what"]) for r in syncs] == [
            ("train.forward", "batch_upload"), ("train.optimizer", "all_finite"),
            ("train.optimizer", "clip")]
        # the adapters are side products of the trunk's products: nothing merges
        assert not [r for r in recs if r.name == "train.lora_merge" and s.t0 <= r.t0 <= s.t1]
    assert len(_named(recs, "data.wait")) >= 2


def test_threads_lose_no_record_or_count(recording):
    """More threads than cores, a short switch interval: every span and
    count arrives, ids are unique and each parent is on its child's thread."""
    import sys

    n_threads, n = 24, 500
    c0 = profiling.counters().get("stress", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with profiling.span("outer", "host"):
                    with profiling.span("inner", "launch"):
                        profiling.count("stress")

        ths = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=WAIT_S)
        assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(old)
    recs = profiling.drain()
    assert len(recs) == 2 * n_threads * n
    assert profiling.counters()["stress"] - c0 == n_threads * n
    by_id = {r.id: r for r in recs}
    assert len(by_id) == len(recs)
    for r in recs:
        if r.name == "inner":
            up = by_id[r.parent]
            assert up.name == "outer" and up.thread == r.thread and up.t0 <= r.t0 <= r.t1 <= up.t1
