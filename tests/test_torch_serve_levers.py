"""The serving layer with the opt-in levers and the W8A8 int8 trunk
(echo_tts_tpu_torch.serve, models/quant.py), on the CPU at tiny sizes: an
int8 engine's /tts equal byte for byte to the direct call on the quantized
params (trunk only and with the encoders); a LoRA under int8 equal to the
quantized merge, and its revert giving the quantized base back byte for
byte; the micro-batcher's rows and the continuous group's rows against their
solo runs with int8 and with each sampler lever (atol 2e-5, the bound the
port's serving tests hold the fp32 rows to); the server's --int8 flags.
Every wait is bounded and every Engine is closed."""
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

from echo_tts_tpu.train.lora import LoRAConfig as JLoRAConfig
from echo_tts_tpu.train.lora import init_lora as j_init_lora
from echo_tts_tpu.train.lora import save_lora_checkpoint as j_save_lora
from echo_tts_tpu_torch.core import config as tc
from echo_tts_tpu_torch.models import quant
from echo_tts_tpu_torch.pipeline import pipeline as tpipe
from echo_tts_tpu_torch.serve import __main__ as serve_main
from echo_tts_tpu_torch.serve.engine import Engine
from echo_tts_tpu_torch.serve.server import serve, wav_bytes
from echo_tts_tpu_torch.train.lora import load_lora_checkpoint, merge_lora

from torch_parity import tiny_pair

PIPE = dict(text_buckets=(64,), speaker_buckets=(32, 64), audio_chunk_latents=32,
            max_speaker_latent_length=64)
SAMPLER = dict(num_steps=4, sequence_length=16, truncation_factor=0.8)
SC = tc.SamplerConfig(**SAMPLER)
LEVERS = {
    "int8": ({"int8": True}, {}),
    "midpoint": ({}, dict(solver="midpoint")),
    "uncond_cache_2": ({}, dict(uncond_cache_interval=2)),
    "joint_uncond": ({}, dict(joint_uncond=True)),
    "int8_encoders_midpoint_joint": ({"int8_encoders": True},
                                     dict(solver="midpoint", joint_uncond=True)),
}
WAIT_S = 120


@pytest.fixture(scope="module")
def both():
    return tiny_pair(61, 62, PIPE)


@pytest.fixture
def engines():
    made = []

    def make(tts, **kw):
        made.append(Engine(dataclasses.replace(tts), **kw))
        return made[-1]

    yield make
    for e in made:
        e.close()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _same_tree(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _post(base, path, body):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
        return resp.read()


@pytest.mark.parametrize("encoders", [False, True])
def test_int8_engine_tts_matches_the_direct_call(both, engines, encoders):
    """The engine quantizes its base once (the caller's params stay plain),
    and /tts sends the WAV of sample_pipeline on the quantized params; a
    body with joint_uncond takes the lever."""
    _, ttts = both
    eng = engines(ttts, int8=not encoders, int8_encoders=encoders)
    params = eng.tts.dit_params
    assert quant.is_quantized(params["blocks"]["mlp"]["w2"])
    assert quant.is_quantized(params["blocks"]["attention"]["wk_text"]) == encoders
    assert not quant.is_quantized(ttts.dit_params["blocks"]["mlp"]["w2"])
    assert _same_tree(params, quant.quantize_dit_params(ttts.dit_params, encoders=encoders))
    qtts = dataclasses.replace(ttts, dit_params=params)
    httpd = serve(eng, port=0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for extra in ({}, {"joint_uncond": True}):
            body = _post(base, "/tts", {"text": "Int8 request.", "seed": 4, **SAMPLER, **extra})
            direct, _, _ = tpipe.sample_pipeline(qtts, "Int8 request.", None, 4,
                                                 sc=tc.SamplerConfig(**SAMPLER, **extra),
                                                 normalize_text=True)
            assert body == wav_bytes(direct[0], ttts.ae_cfg.sample_rate)
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_int8_lora_requantizes_the_merge(both, engines, tmp_path):
    """set_lora under int8 serves quantize(merge(base)); set_lora(None)
    gives the quantized base back, the same bytes."""
    jtts, ttts = both
    lc = JLoRAConfig(rank=2)
    lora = j_init_lora(jax.random.PRNGKey(3), jtts.dit_params, lc)
    lora["blocks.mlp.w1"]["b"] = lora["blocks.mlp.w1"]["b"] + 0.1
    path = str(tmp_path / "l.npz")
    j_save_lora(path, lora, lc)
    eng = engines(ttts, int8=True)
    base = eng.tts.dit_params
    snapshot = [x.clone() for x in _leaves(base)]
    ref_audio = eng.generate("LoRA under int8.", None, seed=2, sc=SC)[0]
    eng.set_lora(path)
    tl, tlc = load_lora_checkpoint(path, "cpu")
    assert _same_tree(eng.tts.dit_params,
                      quant.quantize_dit_params(merge_lora(ttts.dit_params, tl, tlc)))
    merged_audio = eng.generate("LoRA under int8.", None, seed=2, sc=SC)[0]
    eng.set_lora(None)
    assert eng.tts.dit_params is base
    assert all(torch.equal(a, b) for a, b in zip(_leaves(base), snapshot))
    back = eng.generate("LoRA under int8.", None, seed=2, sc=SC)[0]
    assert not np.array_equal(merged_audio, ref_audio) and np.array_equal(back, ref_audio)


@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_micro_batch_rows_match_solo_with_a_lever(both, engines, lever):
    """Three concurrent requests of one key run as one batch of four rows;
    each row equals its solo sample_pipeline on the engine's params."""
    _, ttts = both
    eng_kw, sc_kw = LEVERS[lever]
    sc = tc.SamplerConfig(**SAMPLER, **sc_kw)
    eng = engines(ttts, max_batch=4, batch_wait_ms=2000.0, **eng_kw)
    reqs = [("Batch one.", 31), ("Batch two two.", 32), ("Batch three three three.", 33)]
    with ThreadPoolExecutor(max_workers=3) as ex:
        futs = {s: ex.submit(eng.generate, t_, None, s, sc) for t_, s in reqs}
        outs = {s: f.result(timeout=WAIT_S) for s, f in futs.items()}
    solo_tts = dataclasses.replace(ttts, dit_params=eng.tts.dit_params)
    for text, seed in reqs:
        audio, _, timings = outs[seed]
        ref = tpipe.sample_pipeline(solo_tts, text, None, seed, sc=sc, normalize_text=True)[0]
        assert timings["batch_size"] == 4.0
        np.testing.assert_allclose(audio, ref, atol=2e-5, rtol=0)
    assert eng.health()["batches"] == 1


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_continuous_rows_match_solo_with_a_lever(both, engines, monkeypatch, lever):
    """Two staggered streams through a continuous group (the second joins the
    live group) equal their solo streams."""
    _, ttts = both
    eng_kw, sc_kw = LEVERS[lever]
    sc = tc.SamplerConfig(**SAMPLER, **sc_kw)
    real = tpipe._stream_step_rows

    def slow(*a, **k):
        time.sleep(0.02)
        return real(*a, **k)

    monkeypatch.setattr(tpipe, "_stream_step_rows", slow)
    eng = engines(ttts, max_batch=2, continuous=True, **eng_kw)
    texts = {50: "Continuous row A.", 51: "Continuous row B, joining later."}
    got = {}

    def run(seed):
        got[seed] = np.concatenate(list(eng.generate_stream(
            texts[seed], None, seed=seed, sc=sc, block_size=4)), axis=-1)

    ta = threading.Thread(target=run, args=(50,))
    ta.start()
    _wait(lambda: 50 in got or any(s.n_active >= 1 for s in list(eng._cont_scheds.values())),
          "the first stream's group")
    tb = threading.Thread(target=run, args=(51,))
    tb.start()
    for th in (ta, tb):
        th.join(timeout=WAIT_S)
    assert not ta.is_alive() and not tb.is_alive()
    solo_tts = dataclasses.replace(ttts, dit_params=eng.tts.dit_params)
    for seed, text in texts.items():
        ref = np.concatenate(list(tpipe.sample_pipeline_stream(
            solo_tts, text, None, seed, sc=sc, block_size=4, normalize_text=True)), axis=-1)
        assert got[seed].shape == ref.shape and ref.shape[-1] > 0
        np.testing.assert_allclose(got[seed], ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("flags,encoders", [(["--int8"], False), (["--int8-encoders"], True)])
def test_serve_entry_point_int8_flags(flags, encoders):
    eng = serve_main.build_engine(serve_main.parse_args(["--cpu", "--random-tiny"] + flags))
    try:
        attn = eng.tts.dit_params["blocks"]["attention"]
        assert eng.int8 and quant.is_quantized(attn["wq"])
        assert quant.is_quantized(attn["wk_text"]) == encoders
    finally:
        eng.close()
