"""The port's serving layer (echo_tts_tpu_torch.serve) against the JAX
package's on the same weights (JAX initializers, carried over by
checkpoints/from_jax.py): Engine.generate with and without a speaker prompt
against the JAX Engine at the same seed (audio rel-L2 <= 1e-4, the
tolerance of tests/test_torch_pipeline.py, and equal crop length), the
micro-batcher against serial generation (atol 1e-5, as the JAX package's
tests/test_serve.py holds its own), keys that split batches, the speaker
cache (one encode; keys equal the JAX package's), sample_fn and the vocoder
timing key, ae_reconstruct and Engine.reconstruct, set_lora from an npz the
JAX package wrote, the stream micro-batch against solo streams, close()
with a queued stream, the serving options not ported, the HTTP endpoints, MP3
output and its fallback to WAV and SamplerConfig.from_preset. Tiny configs, fp32, on the
CPU; every wait is bounded and every Engine is closed."""
import base64
import dataclasses
import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echo_tts_tpu.core import config as jc
from echo_tts_tpu.pipeline import pipeline as jpipe
from echo_tts_tpu.pipeline import speaker as jspeaker
from echo_tts_tpu.serve import presets as jpresets
from echo_tts_tpu.serve.engine import Engine as JEngine
from echo_tts_tpu.train.lora import LoRAConfig as JLoRAConfig
from echo_tts_tpu.train.lora import init_lora as j_init_lora
from echo_tts_tpu.train.lora import save_lora_checkpoint as j_save_lora
from echo_tts_tpu_torch.core import config as tc
from echo_tts_tpu_torch.pipeline import pipeline as tpipe
from echo_tts_tpu_torch.pipeline import speaker as tspeaker
from echo_tts_tpu_torch.pipeline.audio_io import load_audio, write_wav
from echo_tts_tpu_torch.serve import presets as tpresets
from echo_tts_tpu_torch.serve.engine import Engine
from echo_tts_tpu_torch.serve.server import pcm16_bytes, serve, wav_bytes

from torch_parity import rel_l2, tiny_pair

PIPE = dict(text_buckets=(64,), speaker_buckets=(32, 64), audio_chunk_latents=32,
            max_speaker_latent_length=64)
SAMPLER = dict(num_steps=2, sequence_length=16, truncation_factor=0.8)
SC, JSC = tc.SamplerConfig(**SAMPLER), jc.SamplerConfig(**SAMPLER)
WAIT_S = 120


@pytest.fixture(scope="module")
def both():
    return tiny_pair(31, 32, PIPE)


@pytest.fixture
def engines():
    """Engines made by a test, closed at its end."""
    made = []

    def make(cls, tts, **kw):
        made.append(cls(dataclasses.replace(tts), **kw))
        return made[-1]

    yield make
    for e in made:
        e.close()


def _voice(seed, latents=40):
    """A prompt of `latents` tiny frames (16 samples each)."""
    return (0.2 * np.random.default_rng(seed).standard_normal((1, latents * 16))).astype(
        np.float32)


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a request did not finish in time"


def _concat(chunks):
    return np.concatenate(list(chunks), axis=-1)


@pytest.mark.parametrize("with_speaker", [False, True])
def test_engine_generate_matches_jax(both, engines, with_speaker):
    jtts, ttts = both
    spk = _voice(5) if with_speaker else None
    ref, ref_text, _ = engines(JEngine, jtts).generate("Serve me, please.", spk, seed=3, sc=JSC)
    got, got_text, timings = engines(Engine, ttts).generate("Serve me, please.", spk, seed=3,
                                                            sc=SC)
    ref = np.asarray(ref)
    assert got_text == ref_text
    assert got.shape == ref.shape and got.shape[-1] > 0
    assert rel_l2(got, ref) <= 1e-4
    assert timings["vocoder"] == 0.0 and timings["total"] > 0


def test_micro_batching_matches_serial(both, engines):
    """Three concurrent requests with one key run as one batch of four rows
    (a pad row), and each equals its serial run."""
    _, ttts = both
    reqs = [("Batch one.", 31), ("Batch two two.", 32), ("Batch three three three.", 33)]
    serial = engines(Engine, ttts)
    ref = {s: serial.generate(t_, None, seed=s, sc=SC)[0] for t_, s in reqs}
    eng = engines(Engine, ttts, max_batch=4, batch_wait_ms=2000.0)
    with ThreadPoolExecutor(max_workers=3) as ex:
        futs = {s: ex.submit(eng.generate, t_, None, s, SC) for t_, s in reqs}
        outs = {s: f.result(timeout=WAIT_S) for s, f in futs.items()}
    for seed, (audio, _, timings) in outs.items():
        np.testing.assert_allclose(audio, ref[seed], atol=1e-5, rtol=0)
        assert timings["batch_size"] == 4.0
    st = eng.health()
    assert st["requests"] == 3 and st["batches"] == 1


def test_micro_batching_splits_incompatible(both, engines):
    _, ttts = both
    sc_b = dataclasses.replace(SC, cfg_scale_text=4.0)
    eng = engines(Engine, ttts, max_batch=4, batch_wait_ms=200.0)
    assert eng._batch_key("Same.", None, SC, True) != eng._batch_key("Same.", None, sc_b, True)
    assert eng._batch_key("Same.", None, SC, True) != eng._batch_key("Same.", _voice(1), SC,
                                                                     True)
    with ThreadPoolExecutor(max_workers=2) as ex:
        fa = ex.submit(eng.generate, "Same text.", None, 41, SC)
        fb = ex.submit(eng.generate, "Same text.", None, 41, sc_b)
        a, b = fa.result(timeout=WAIT_S)[0], fb.result(timeout=WAIT_S)[0]
    assert not np.allclose(a, b)
    st = eng.health()
    assert st["requests"] == 2 and st["batches"] == 2


def test_speaker_cache_encodes_once(both, engines, monkeypatch):
    """A repeated prompt is encoded once, the audio does not change, and the
    cache key is the JAX package's for the same audio."""
    jtts, ttts = both
    calls = {"n": 0}
    real = tpipe.get_speaker_latent_and_mask

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tpipe, "get_speaker_latent_and_mask", counting)
    voice = _voice(7)
    ref, _, _ = engines(Engine, ttts, speaker_cache_size=0).generate("Voice cache.", voice,
                                                                     seed=5, sc=SC)
    assert calls["n"] == 1
    eng = engines(Engine, ttts, speaker_cache_size=4)
    a1, _, t1 = eng.generate("Voice cache.", voice, seed=5, sc=SC)
    _, _, t2 = eng.generate("Voice cache two.", voice, seed=6, sc=SC)
    assert calls["n"] == 2
    assert "speaker_encode_cache_hit" in t2 and "speaker_encode_cache_hit" not in t1
    np.testing.assert_array_equal(a1, ref)
    st = eng.health()
    assert st["speaker_cache_hits"] == 1 and st["speaker_cache_misses"] == 1
    eng.generate("Voice cache three.", _voice(8), seed=7, sc=SC)
    assert calls["n"] == 3

    jcache = {}
    jpipe._prepare_inputs(jtts, "Voice cache.", voice, True, None, None, True,
                          speaker_cache=jcache)
    assert list(eng._speaker_cache._d)[:1] == list(jcache)
    (lat, mask), (jlat, jmask) = eng._speaker_cache._d[list(jcache)[0]], list(jcache.values())[0]
    np.testing.assert_allclose(lat, np.asarray(jlat), atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(mask, np.asarray(jmask))


def test_sample_fn_and_vocoder_key(both):
    """sample_fn replaces the sampler (torch tensors on the device, the
    seed); its latents are decoded by ae_decode, whose wall is `vocoder`.
    Against the JAX package's sample_fn path on the same latents."""
    jtts, ttts = both
    lat = np.random.default_rng(9).standard_normal((1, 16, 80)).astype(np.float32)
    seen = {}

    def fn(spk, smask, ids, tmask, seed):
        seen.update(device=ids.device, seed=seed, shapes=(tuple(spk.shape), tuple(ids.shape)))
        return torch.from_numpy(lat)

    got, _, timings = tpipe.sample_pipeline(ttts, "Sample fn.", None, 4, sc=SC, sample_fn=fn)
    ref, _, _ = jpipe.sample_pipeline(jtts, "Sample fn.", None, 4, sc=JSC,
                                      sample_fn=lambda *a: jnp.asarray(lat))
    assert seen == {"device": torch.device("cpu"), "seed": 4, "shapes": ((1, 4, 80), (1, 64))}
    assert timings["vocoder"] > 0 and timings["sample"] >= 0
    assert got.shape == np.asarray(ref).shape and rel_l2(got, ref) <= 1e-4
    _, _, plain = tpipe.sample_pipeline(ttts, "Sample fn.", None, 4, sc=SC)
    assert plain["vocoder"] == 0.0


def test_ae_reconstruct_matches_jax(both, engines):
    jtts, ttts = both
    audio = _voice(11, latents=20)
    ref = jspeaker.ae_reconstruct(jtts.ae_params, jtts.ae_cfg, jtts.pca,
                                  jnp.asarray(audio)[:, None, :])
    got = tspeaker.ae_reconstruct(ttts.ae_params, ttts.ae_cfg, ttts.pca,
                                  torch.from_numpy(audio)[:, None, :])
    assert got.shape == ref.shape and rel_l2(got.numpy(), ref) <= 1e-4
    short = audio[:, :150]  # not a whole frame: padded, then cropped to whole frames
    e_ref = engines(JEngine, jtts).reconstruct(short)
    e_got = engines(Engine, ttts).reconstruct(short)
    assert e_got.shape == e_ref.shape == (1, 1, 160)
    assert rel_l2(e_got, e_ref) <= 1e-4


def test_set_lora_matches_jax(both, engines, tmp_path):
    """An npz written by the JAX package's save_lora_checkpoint merges into
    the same audio in both engines; None brings back the base bit for bit."""
    jtts, ttts = both
    lc = JLoRAConfig(rank=2)
    lora = j_init_lora(jax.random.PRNGKey(0), jtts.dit_params, lc)
    lora["blocks.attention.wq"]["b"] = jnp.ones_like(lora["blocks.attention.wq"]["b"]) * 0.1
    path = str(tmp_path / "lora.npz")
    j_save_lora(path, lora, lc)
    jeng, eng = engines(JEngine, jtts), engines(Engine, ttts)
    base, _, _ = eng.generate("Swap test.", None, seed=2, sc=SC)
    jeng.set_lora(path)
    eng.set_lora(path)
    ref, _, _ = jeng.generate("Swap test.", None, seed=2, sc=JSC)
    got, _, _ = eng.generate("Swap test.", None, seed=2, sc=SC)
    assert eng.health()["lora"] == path
    assert got.shape == np.asarray(ref).shape and rel_l2(got, ref) <= 1e-4
    assert got.shape != base.shape or not np.allclose(got, base)
    eng.set_lora(None)
    np.testing.assert_array_equal(eng.generate("Swap test.", None, seed=2, sc=SC)[0], base)
    assert eng._base_params is ttts.dit_params and eng.tts.dit_params is ttts.dit_params


def test_stream_micro_batch_matches_solo(both, engines):
    """Three concurrent streams with one key and schedule run as one batched
    stream of four rows; each equals its solo stream."""
    _, ttts = both
    reqs = [(21, "Batch stream one."), (22, "Batch stream two."), (23, "Batch stream three.")]
    solo = engines(Engine, ttts)
    ref = {s: _concat(solo.generate_stream(t_, None, seed=s, sc=SC, block_size=8))
           for s, t_ in reqs}
    eng = engines(Engine, ttts, max_batch=4, batch_wait_ms=2000.0)
    got = {}

    def run(seed, text):
        got[seed] = _concat(eng.generate_stream(text, None, seed=seed, sc=SC, block_size=8))

    threads = [threading.Thread(target=run, args=r) for r in reqs]
    for t_ in threads:
        t_.start()
    _join(threads)
    for seed, _ in reqs:
        assert got[seed].shape == ref[seed].shape
        np.testing.assert_allclose(got[seed], ref[seed], atol=2e-5, rtol=0)
    h = eng.health()
    assert h["requests"] == 3 and h["batches"] == 1


def test_close_releases_queued_stream(both, engines):
    _, ttts = both
    eng = engines(Engine, ttts, max_batch=2, batch_wait_ms=5000.0)
    result = {}

    def consume():
        try:
            list(eng.generate_stream("Close test.", None, seed=1, sc=SC, block_size=8))
            result["outcome"] = "completed"
        except RuntimeError as e:
            result["outcome"] = f"error: {e}"

    t_ = threading.Thread(target=consume)
    t_.start()
    deadline = time.monotonic() + WAIT_S
    while not eng._queue and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng._queue, "the stream never queued"
    eng.close()
    _join([t_])
    # the batch the dispatcher had formed runs or is refused; either way the
    # consumer is released
    assert result["outcome"] in ("completed", "error: engine closed")
    assert not eng._dispatcher.is_alive()
    with pytest.raises(RuntimeError, match="engine is closed"):
        eng.generate("After close.", None, seed=1, sc=SC)


def test_stream_lock_released_while_slow_reader_drains(both, engines):
    """A direct stream's device work does not wait for its reader: a
    one-shot request completes while the stream's chunks sit unread."""
    _, ttts = both
    eng = engines(Engine, ttts)
    gen = eng.generate_stream("Slow reader test.", None, seed=1, sc=SC, block_size=4)
    first = next(gen)
    out = {}
    t_ = threading.Thread(target=lambda: out.update(a=eng.generate("Concurrent.", None, seed=2,
                                                                   sc=SC)[0]))
    t_.start()
    _join([t_])
    assert np.isfinite(out["a"]).all()
    rest = list(gen)
    ref = _concat(tpipe.sample_pipeline_stream(ttts, "Slow reader test.", None, 1, sc=SC,
                                               block_size=4, normalize_text=True))
    np.testing.assert_array_equal(_concat([first] + rest), ref)


@pytest.mark.parametrize("max_batch", [1, 2])
def test_retry_reruns_the_same_path_then_fails(both, engines, monkeypatch, max_batch):
    """A failing device call is run again on the same path max_retries
    times and then fails the request; the engine (and its micro-batcher)
    goes on serving."""
    import echo_tts_tpu_torch.serve.engine as engine_mod

    _, ttts = both
    name = "sample_pipeline" if max_batch == 1 else "sample_pipeline_batch"
    real, calls = getattr(engine_mod, name), []

    def failing(*a, **k):
        calls.append(a[0].device)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(engine_mod, name, failing)
    eng = engines(Engine, ttts, max_retries=2, max_batch=max_batch)
    with pytest.raises(RuntimeError, match="failed after 3 attempts") as e:
        eng.generate("Retry me.", None, seed=1, sc=SC)
    assert "illegal memory access" in str(e.value.__cause__)
    assert calls == [torch.device("cpu")] * 3
    st = eng.health()
    assert st["retries"] == 3 and st["failures"] == 1 and st["requests"] == 0
    monkeypatch.setattr(engine_mod, name, real)
    audio, _, _ = eng.generate("Retry me.", None, seed=1, sc=SC)
    assert np.isfinite(audio).all() and eng.health()["requests"] == 1


@pytest.mark.parametrize("kw", [dict(mesh=object())])
def test_levers_not_ported_raise(both, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(both[1], **kw)


@pytest.mark.parametrize("continuous", [False, True])
def test_warmup_runs_every_shape(both, engines, monkeypatch, continuous):
    """warmup runs the one-shot path at the no-speaker shape and each
    speaker bucket, the streaming shapes (in continuous mode one group step
    at each power-of-two size a shape) and the batched sizes, and counts no
    request."""
    _, ttts = both
    steps = []
    real = tpipe._stream_step_rows
    monkeypatch.setattr(tpipe, "_stream_step_rows",
                        lambda *a, **k: steps.append(a[6]["prefix"].shape[0]) or real(*a, **k))
    eng = engines(Engine, ttts, max_batch=4, continuous=continuous, continuous_block=8)
    assert eng.warmup(SC, include_streaming=True) > 0
    assert eng.health()["requests"] == 0
    # 3 one-shot shapes, then the stream shapes, then batches of 2 and 4
    assert eng.warmup_combos == 3 + (3 * 3 if continuous else 3 + 2 * 3) + 2
    assert steps == ([1, 2, 4] * 3 if continuous else [])
    if continuous:
        return
    # background_tail: the no-speaker set now, the rest on a thread that
    # health() reports until it ends
    assert eng.warmup(SC, background_tail=True) > 0
    assert "warmup_tail_running" in eng.health()
    eng._warmup_tail.join(timeout=WAIT_S)
    assert not eng._warmup_tail.is_alive() and not eng.health()["warmup_tail_running"]
    assert eng._warmup_tail.name == "echo-tts-warmup-tail"


def _post(base, path, obj, timeout=WAIT_S):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.headers, resp.read()


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=WAIT_S) as resp:
        return json.loads(resp.read())


@pytest.fixture
def server(both, engines, tmp_path):
    """An engine behind the HTTP server on a free port; shut down after."""
    _, ttts = both
    eng = engines(Engine, ttts)
    (tmp_path / "text_presets.txt").write_text("Reading | [S1] One two three.\n\n"
                                               "No separator line here\n")
    httpd = serve(eng, port=0, background=True, presets={"Fast-Test": SC},
                  text_presets_path=str(tmp_path / "text_presets.txt"))
    try:
        yield eng, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_http_tts_and_presets(both, server, tmp_path):
    """/tts with a preset and a WAV prompt sends the bytes of the direct
    call's audio (on the prompt as the server decodes it); /health,
    /presets and /text_presets answer."""
    _, ttts = both
    eng, base = server
    assert _get(base, "/health")["status"] == "ok"
    assert _get(base, "/presets") == {"Fast-Test": dataclasses.asdict(SC)}
    assert _get(base, "/text_presets") == [["Reading", "4", "[S1] One two three."],
                                           ["Uncategorized", "4", "No separator line here"]]
    p = str(tmp_path / "spk.wav")
    write_wav(p, _voice(3)[0], ttts.ae_cfg.sample_rate)
    b64 = base64.b64encode(open(p, "rb").read()).decode()
    headers, body = _post(base, "/tts", {"text": "Preset request.", "seed": 4,
                                          "preset": "Fast-Test", "speaker_wav_b64": b64})
    direct, normalized, _ = tpipe.sample_pipeline(ttts, "Preset request.", load_audio(p), 4,
                                                  sc=SC, normalize_text=True)
    assert body == wav_bytes(direct[0], ttts.ae_cfg.sample_rate)
    assert base64.b64decode(headers["X-Normalized-Text"]).decode() == normalized
    timings = json.loads(headers["X-Timings"])
    assert timings["speaker_encode"] > 0 and timings["vocoder"] == 0.0
    _, again = _post(base, "/tts", {"text": "Preset request.", "seed": 4,
                                    "preset": "Fast-Test", "speaker_wav_b64": b64})
    assert again == body and eng.health()["speaker_cache_hits"] == 1


def test_http_mp3_falls_back_to_wav(server, monkeypatch):
    """"format": "mp3" sends MP3 (libmp3lame) of the WAV request's audio;
    where the library is missing it sends the WAV, as the JAX server does."""
    from echo_tts_tpu_torch.native import mp3_py

    _, base = server
    req = {"text": "MP3 test.", "seed": 5, "format": "mp3", **SAMPLER}
    _, wav = _post(base, "/tts", dict(req, format="wav"))
    headers, body = _post(base, "/tts", req)
    if mp3_py.mp3_encode_available():
        assert headers["Content-Type"] == "audio/mpeg" and body[:4] != b"RIFF" and len(body) > 0
    else:
        assert headers["Content-Type"] == "audio/wav" and body == wav
    monkeypatch.setattr(mp3_py, "_load_lame", lambda: None)
    headers, body = _post(base, "/tts", req)
    assert headers["Content-Type"] == "audio/wav" and body == wav


def test_http_tts_stream(both, server):
    """/tts_stream sends the PCM16 of sample_pipeline_stream's chunks."""
    _, ttts = both
    _, base = server
    headers, body = _post(base, "/tts_stream", {"text": "Stream me.", "seed": 5,
                                                 "block_size": [4, 8], **SAMPLER})
    assert headers["Content-Type"] == "audio/L16"
    assert int(headers["X-Sample-Rate"]) == ttts.ae_cfg.sample_rate
    ref = tpipe.sample_pipeline_stream(ttts, "Stream me.", None, 5, sc=SC, block_size=[4, 8],
                                       normalize_text=True)
    assert body == b"".join(pcm16_bytes(c) for c in ref) and len(body) > 0


def test_http_reconstruct_and_lora(both, server, tmp_path):
    jtts, ttts = both
    eng, base = server
    p = str(tmp_path / "r.wav")
    write_wav(p, _voice(9, latents=16)[0], ttts.ae_cfg.sample_rate)
    _, body = _post(base, "/reconstruct", {"path": p})
    assert body == wav_bytes(eng.reconstruct(load_audio(p))[0], ttts.ae_cfg.sample_rate)

    lc = JLoRAConfig(rank=2)
    lora = j_init_lora(jax.random.PRNGKey(1), jtts.dit_params, lc)
    lora["blocks.mlp.w1"]["b"] = jnp.ones_like(lora["blocks.mlp.w1"]["b"]) * 0.1
    path = str(tmp_path / "l.npz")
    j_save_lora(path, lora, lc)
    req = {"text": "LoRA over HTTP.", "seed": 6, **SAMPLER}
    _, plain = _post(base, "/tts", req)
    assert json.loads(_post(base, "/lora", {"path": path})[1]) == {"ok": True}
    _, merged = _post(base, "/tts", req)
    assert _get(base, "/health")["lora"] == path
    _post(base, "/lora", {"path": None})
    _, back = _post(base, "/tts", req)
    assert merged != plain and back == plain
    with pytest.raises(urllib.error.HTTPError):
        _post(base, "/lora", {"path": str(tmp_path / "missing.npz")})


def test_sampler_config_from_preset_matches_jax():
    """The shipped presets and the coercions of request fields give the JAX
    package's configs, field for field."""
    for name, d in tpresets.DEFAULT_SAMPLER_PRESETS.items():
        assert jpresets.DEFAULT_SAMPLER_PRESETS[name] == d
        assert (dataclasses.asdict(tc.SamplerConfig.from_preset(d))
                == dataclasses.asdict(jc.SamplerConfig.from_preset(d)))
    d = {"num_steps": "8", "uncond_cache_interval": "2", "first_block_steps": 16,
         "joint_uncond": True, "cfg_scale_text": "3.5", "speaker_kv_scale": "none",
         "solver": "euler"}
    got = tc.SamplerConfig.from_preset(d, sequence_length=32)
    assert dataclasses.asdict(got) == dataclasses.asdict(jc.SamplerConfig.from_preset(
        d, sequence_length=32))
    assert isinstance(got.num_steps, int) and isinstance(got.first_block_steps, int)
    assert got.joint_uncond is True and got.speaker_kv_scale is None


def test_load_presets(tmp_path):
    path = str(tmp_path / "sampler_presets.json")
    got = tpresets.load_sampler_presets(path)  # writes the defaults first
    assert set(got) == set(tpresets.DEFAULT_SAMPLER_PRESETS)
    want = jpresets.load_sampler_presets(path, write_default=False)
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == {
        k: dataclasses.asdict(v) for k, v in want.items()}
    assert got["Independent-Low-CFG-Flat"].truncation_factor == 0.8
    assert tpresets.load_text_presets(str(tmp_path / "none.txt")) == []
