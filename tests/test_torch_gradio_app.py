"""The port's Gradio UI (echo_tts_tpu_torch/serve/gradio_app.py) against the
JAX package's (echo_tts_tpu/serve/gradio_app.py), without gradio: a stub
`gradio` module of this file's own records the components and the callbacks
that `build_app` wires.

* the helpers, each against its JAX counterpart on the same inputs (equal
  results; the resampled prompt within 1e-6);
* the handlers, taken from each package's `build_app` under the stub and
  run on the same tiny fp32 weights (tests/torch_parity.py:tiny_pair):
  `generate` with and without custom shapes (the audio that reaches the
  file, rel-L2 <= 1e-4, the tolerance of tests/test_torch_serve.py; the
  engine call's overrides and sampler config equal), `generate_stream`
  (each chunk's samples within one PCM16 step, the float chunks rel-L2 <=
  1e-4), `set_lora` with a JAX-written adapter and with a missing one (the
  error, then the base audio bit for bit), the selectors and the presets;
* `build_app`'s wiring: the events, callbacks and their inputs and outputs
  in the JAX package's order;
* without gradio, `build_app` and `serve --gradio` raise RuntimeError
  naming it.
Tiny configs, fp32, on the CPU; every Engine is closed."""
import dataclasses
import json
import os
import sys
import time
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from echo_tts_tpu.core import config as jc
from echo_tts_tpu.serve import gradio_app as jga
from echo_tts_tpu.serve import presets as jpresets
from echo_tts_tpu.serve.engine import Engine as JEngine
from echo_tts_tpu.train.lora import LoRAConfig as JLoRAConfig
from echo_tts_tpu.train.lora import init_lora as j_init_lora
from echo_tts_tpu.train.lora import save_lora_checkpoint as j_save_lora
from echo_tts_tpu_torch.core import config as tc
from echo_tts_tpu_torch.pipeline.audio_io import read_wav, write_wav
from echo_tts_tpu_torch.serve import gradio_app as ga
from echo_tts_tpu_torch.serve import presets as tpresets
from echo_tts_tpu_torch.serve.engine import Engine

from torch_parity import rel_l2, tiny_pair

PIPE = dict(text_buckets=(64,), speaker_buckets=(32, 64), audio_chunk_latents=32,
            max_speaker_latent_length=64)
# the twelve sampler fields of a handler call: 2 steps, force-speaker off
FIELDS = (2, 3.0, 5.0, 0.5, 1.0, 0.8, 1.2, 3.0, False, 1.5, 0.9, 24)


# ---------------------------------------------------------------------------
# a stub gradio
# ---------------------------------------------------------------------------


class _Component:
    def __init__(self, registry, kind, *a, **k):
        self._registry = registry
        self.kind = kind
        self.args = a
        self.kwargs = k

    def _reg(self, event, fn, inputs=None, outputs=None):
        self._registry.append((event, fn, inputs, outputs))
        return self

    def click(self, fn, inputs=None, outputs=None):
        return self._reg("click", fn, inputs, outputs)

    def change(self, fn, inputs=None, outputs=None):
        return self._reg("change", fn, inputs, outputs)

    def select(self, fn, inputs=None, outputs=None):
        return self._reg("select", fn, inputs, outputs)

    def release(self, fn, inputs=None, outputs=None):
        return self._reg("release", fn, inputs, outputs)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _fake_gradio(registry):
    mod = types.ModuleType("gradio")

    def make(kind):
        return lambda *a, **k: _Component(registry, kind, *a, **k)

    for kind in ("Blocks", "Markdown", "State", "Row", "Column", "Accordion", "Textbox",
                 "Dataframe", "Audio", "Slider", "Number", "Checkbox", "Radio", "Button",
                 "Dropdown", "Group", "HTML"):
        setattr(mod, kind, make(kind))

    class SelectData:
        def __init__(self, index=0, value=None):
            self.index = index
            self.value = value

    mod.SelectData = SelectData
    mod.update = lambda **k: dict(k)
    return mod


def _build(module, engine, monkeypatch, tmp_path, tag, **kw):
    """module.build_app(engine) under a fresh stub: {callback name: [(event,
    fn, inputs, outputs)]} and the registrations in order."""
    registry = []
    monkeypatch.setitem(sys.modules, "gradio", _fake_gradio(registry))
    kw.setdefault("presets_path", str(tmp_path / f"{tag}_presets.json"))
    kw.setdefault("text_presets_path", str(tmp_path / "text_presets.txt"))
    kw.setdefault("temp_dir", str(tmp_path / f"{tag}_out"))
    assert module.build_app(engine, **kw) is not None
    by_fn = {}
    for event, fn, inputs, outputs in registry:
        by_fn.setdefault(getattr(fn, "__name__", "lambda"), []).append(
            (event, fn, inputs, outputs))
    return by_fn, registry


# ---------------------------------------------------------------------------
# helpers against the JAX package's
# ---------------------------------------------------------------------------


def _stems_and_cleanup(m, d):
    s1, s2 = m.make_stem("echo", "userA"), m.make_stem("echo", "userA")
    shape = (s1 != s2, s1.startswith("echo__userA__"), m.make_stem("echo").count("__"))
    d.mkdir()
    names = ["echo__other__1_aa.wav", f"{s1}.wav", "echo__other__2_bb.wav"]
    for n in names:
        (d / n).write_bytes(b"x")
    os.utime(d / names[0], (time.time() - 1000, time.time() - 1000))
    m.cleanup_temp_audio(d, "userA", max_age_sec=300)
    m.cleanup_temp_audio(d / "missing", "userA")
    return shape, [(d / n).exists() for n in names]


def _prompt_library(m, d):
    d.mkdir()
    for name in ("B.wav", "a.mp3", "notes.txt", "c.FLAC", "d.opus"):
        (d / name).write_bytes(b"x")
    return (m.audio_prompt_files(d), m.audio_prompt_files(d, "WAV"), m.audio_prompt_files(None),
            m.audio_prompt_files(d / "missing"))


def _preset_fields(m, _d):
    presets = {"P": {"num_steps": "20", "cfg_scale_speaker": "7.5", "speaker_kv_enable": "true",
                     "speaker_kv_max_layers": "12"},
               "Q": {"num_steps": 30, "truncation_factor": "bad", "speaker_kv_enable": 0},
               "E": {}}
    return [m.apply_sampler_preset_fields(presets, n) for n in ("P", "Q", "E", "Custom", "x")]


def _save_preset(m, d):
    d.mkdir()
    path = str(d / "sampler_presets.json")
    fields = dict(zip(m.SAMPLER_FIELDS, (30, 4.0, 6.0, 0.4, 0.9, 0.85, 1.1, 2.5, True, 1.4, 0.8,
                                         20)))
    m.save_sampler_preset(path, "My Preset", fields)
    out = m.save_sampler_preset(path, " Another ", {k: fields[k] for k in m.SAMPLER_FIELDS[:4]})
    errors = []
    for bad in ("Custom", "  ", None):
        with pytest.raises(ValueError) as e:
            m.save_sampler_preset(path, bad, fields)
        errors.append(str(e.value))
    return out, json.load(open(path)), errors


def _sampler_config(m, _d):
    sc_mod = jc if m is jga else tc
    fields = dict(zip(m.SAMPLER_FIELDS, (12, 2.0, 4.0, 0.3, 0.9, 0.7, 1.3, 2.0, False, 1.5, 0.9,
                                         24)))
    out = [m.build_sampler_config(sc_mod.SamplerConfig(), fields, custom_latent_length=16)]
    fields["speaker_kv_enable"] = True
    out.append(m.build_sampler_config(sc_mod.SamplerConfig(), fields))
    out.append(m.build_sampler_config(sc_mod.SamplerConfig(num_steps=7), fields, "32"))
    return [dataclasses.asdict(sc) for sc in out]


HELPERS = {
    "stems_and_cleanup": _stems_and_cleanup,
    "parse_buckets": lambda m, _d: [m.parse_buckets(s) for s in (
        "640, 2816, 6400", "768", "", None, "6400, 640", " 12.0 ,3,", 64)],
    "prompt_library": _prompt_library,
    "preset_fields": _preset_fields,
    "save_preset": _save_preset,
    "sampler_config": _sampler_config,
    "constants": lambda m, _d: (m.SAMPLER_FIELDS, sorted(m.AUDIO_EXTS)),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helper_matches_jax(name, tmp_path):
    """Each helper gives the JAX package's result on the same inputs."""
    ref = HELPERS[name](jga, tmp_path / "jax")
    got = HELPERS[name](ga, tmp_path / "port")
    assert got == ref


def test_quick_apply_presets_match_jax():
    assert tpresets.FORCE_SPEAKER_PRESETS == jpresets.FORCE_SPEAKER_PRESETS
    assert tpresets.TRUNCATION_PRESETS == jpresets.TRUNCATION_PRESETS
    assert tpresets.DEFAULT_SAMPLER_PRESETS == jpresets.DEFAULT_SAMPLER_PRESETS


@pytest.mark.parametrize("form", ["int16 stereo tuple", "float tuple", "wav file", "none"])
def test_prepare_speaker_audio_matches_jax(form, tmp_path):
    """A gradio Audio value as the pipeline's prompt: PCM16 stereo at
    another rate (scaled, mixed, resampled), float samples at the codec
    rate, a WAV path, None; within 1e-6 of the JAX package's."""
    rng = np.random.default_rng(3)
    sr_out = 44100
    if form == "int16 stereo tuple":
        value = (22050, (rng.standard_normal((22050, 2)) * 8000).astype(np.int16))
    elif form == "float tuple":
        value = (sr_out, (0.3 * rng.standard_normal(4410)).astype(np.float32))
    elif form == "wav file":
        value = str(tmp_path / "p.wav")
        write_wav(value, (0.3 * rng.standard_normal(8000)).astype(np.float32), 16000)
    else:
        value = None
    ref = jga.prepare_speaker_audio(value, sr_out)
    got = ga.prepare_speaker_audio(value, sr_out)
    if value is None:
        assert got is None and ref is None
        return
    ref = np.asarray(ref)
    assert got.dtype == np.float32 and got.shape == ref.shape and got.shape[0] == 1
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the handlers against the JAX package's, through build_app under the stub
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both():
    return tiny_pair(41, 42, PIPE)


@pytest.fixture
def apps(both, monkeypatch, tmp_path):
    """The JAX and the port's app on engines over the same weights; each
    engine's generate and generate_stream record what they return."""
    jtts, ttts = both
    (tmp_path / "text_presets.txt").write_text("Reading | [S1] One two.\nPlain line\n")
    prompts = tmp_path / "prompts"
    prompts.mkdir()
    (prompts / "voice.wav").write_bytes(b"x")
    engines, out = [], {}
    for tag, module, eng in (("jax", jga, JEngine(jtts)), ("port", ga, Engine(ttts))):
        engines.append(eng)
        seen = {"calls": [], "audio": [], "chunks": []}
        real_gen, real_stream = eng.generate, eng.generate_stream

        def generate(*a, real=real_gen, seen=seen, **k):
            seen["calls"].append(k)
            res = real(*a, **k)
            seen["audio"].append(np.asarray(res[0]))
            return res

        def generate_stream(*a, real=real_stream, seen=seen, **k):
            for c in real(*a, **k):
                seen["chunks"].append(np.asarray(c))
                yield c

        eng.generate, eng.generate_stream = generate, generate_stream
        by_fn, registry = _build(module, eng, monkeypatch, tmp_path, tag,
                                 audio_prompt_folder=str(prompts))
        out[tag] = {"fn": {k: v[0][1] for k, v in by_fn.items()}, "by_fn": by_fn,
                    "registry": registry, "seen": seen, "engine": eng}
    yield out
    for eng in engines:
        eng.close()


def _voice_file(tmp_path, sr):
    path = str(tmp_path / "spk.wav")
    write_wav(path, (0.2 * np.random.default_rng(5).standard_normal(40 * 16)).astype(np.float32),
              sr)
    return path


@pytest.mark.parametrize("shapes", [False, True])
def test_generate_handler_matches_jax(apps, both, tmp_path, monkeypatch, shapes):
    """The generate callback, with a WAV prompt: custom shapes off (the
    base SamplerConfig's length, cut here from 640 to 32 latents in both
    packages for time) and on (text buckets "32, 64", speaker bucket "48",
    latent lengths "8, 16": the largest); the engine call's overrides and
    sampler config, the status, the file and the audio in it (rel-L2 <=
    1e-4 to the JAX package's)."""
    import functools

    _, ttts = both
    monkeypatch.setattr(jga, "SamplerConfig", functools.partial(jc.SamplerConfig,
                                                                sequence_length=32))
    monkeypatch.setattr(ga, "SamplerConfig", functools.partial(tc.SamplerConfig,
                                                               sequence_length=32))
    spk = _voice_file(tmp_path, ttts.ae_cfg.sample_rate)
    outs = {}
    for tag in ("jax", "port"):
        args = (None, "Shapes test.", spk, "wav", *FIELDS, 3, "32, 64", "48", "8, 16", shapes,
                True, False)
        outs[tag] = apps[tag]["fn"]["generate"](*args)
    (jsid, jpath, jstatus, jorig, jrecon), (sid, path, status, orig, recon) = (outs["jax"],
                                                                            outs["port"])
    jcall, call = apps["jax"]["seen"]["calls"][0], apps["port"]["seen"]["calls"][0]
    assert call["pipe_overrides"] == jcall["pipe_overrides"]
    assert call["pipe_overrides"] == ({"text_buckets": (32, 64), "speaker_buckets": (48,)}
                                      if shapes else None)
    assert dataclasses.asdict(call["sc"]) == dataclasses.asdict(jcall["sc"])
    assert call["sc"].sequence_length == (16 if shapes else 32)
    assert status.split(" — ", 1)[1] == jstatus.split(" — ", 1)[1]
    assert status.startswith("Generated in ") and sid and sid != jsid
    assert os.path.basename(path).startswith(f"echo__{sid}__") and path.endswith(".wav")
    audio, jaudio = apps["port"]["seen"]["audio"][0], apps["jax"]["seen"]["audio"][0]
    assert audio.shape == jaudio.shape and rel_l2(audio, jaudio) <= 1e-4
    pcm, sr = read_wav(path)
    assert sr == ttts.ae_cfg.sample_rate and pcm.shape[-1] == audio.shape[-1]
    jpcm, _ = read_wav(jpath)
    assert jpcm.shape == pcm.shape
    assert jorig["visible"] and orig["visible"] and not recon["visible"] and not jrecon["visible"]
    np.testing.assert_allclose(orig["value"][1], jorig["value"][1], atol=1e-6, rtol=0)


def test_generate_stream_handler_matches_jax(apps, both):
    """The streaming callback yields (sr, PCM16) a block: the same blocks
    as the JAX package's, each within one PCM16 step, the float chunks
    behind them rel-L2 <= 1e-4; the engine's stream runs the (64, 192)
    schedule."""
    _, ttts = both
    fields = (2, 3.0, 5.0, 0.5, 1.0, 0.8, 1.2, 3.0, True, 1.5, 0.9, 24)
    got = list(apps["port"]["fn"]["generate_stream"]("Stream me.", None, *fields, 7))
    ref = list(apps["jax"]["fn"]["generate_stream"]("Stream me.", None, *fields, 7))
    assert len(got) == len(ref) > 1
    for (sr, pcm), (jsr, jpcm) in zip(got, ref):
        assert sr == jsr == ttts.ae_cfg.sample_rate and pcm.dtype == np.int16
        assert pcm.shape == np.asarray(jpcm).shape
        assert int(np.abs(pcm.astype(np.int32) - np.asarray(jpcm, np.int32)).max()) <= 1
    chunks, jchunks = apps["port"]["seen"]["chunks"], apps["jax"]["seen"]["chunks"]
    assert rel_l2(np.concatenate(chunks, -1), np.concatenate(jchunks, -1)) <= 1e-4


def test_set_lora_handler_matches_jax(apps, tmp_path):
    """The LoRA callback with a JAX-written adapter (the same status, the
    same adapted audio), the base model, and a missing file: the error,
    and the engine back on the base model, whose audio returns bit for
    bit."""
    jeng = apps["jax"]["engine"]
    lc = JLoRAConfig(rank=2)
    lora = j_init_lora(jax.random.PRNGKey(0), jeng.tts.dit_params, lc)
    lora["blocks.attention.wq"]["b"] = jnp.ones_like(lora["blocks.attention.wq"]["b"]) * 0.1
    good = str(tmp_path / "lora.npz")
    j_save_lora(good, lora, lc)
    missing = str(tmp_path / "missing.npz")
    args = (None, "LoRA test.", None, "wav", *FIELDS, 1, "", "", "16", True, False, False)
    status, audio = {}, {}
    for tag in ("jax", "port"):
        fn, seen = apps[tag]["fn"], apps[tag]["seen"]
        fn["generate"](*args)
        status[tag] = [fn["set_lora"](good, 0.5)]
        fn["generate"](*args)
        status[tag].append(fn["set_lora"](missing, 1.0))
        assert apps[tag]["engine"].health()["lora"] is None
        fn["generate"](*args)
        status[tag].append(fn["set_lora"]("", 1.0))
        audio[tag] = seen["audio"]
    assert status["port"][0] == status["jax"][0] == "✅ Loaded LoRA: lora.npz (strength: 0.50)"
    assert status["port"][1].startswith("❌ Error loading LoRA: ")
    assert status["jax"][1].startswith("❌ Error loading LoRA: ")
    assert status["port"][2] == status["jax"][2] == "ℹ️ Using base model (no LoRA)"
    base, adapted, back = audio["port"]
    np.testing.assert_array_equal(back, base)
    assert not np.array_equal(adapted, base)
    for a, b in zip(audio["port"], audio["jax"]):
        assert a.shape == b.shape and rel_l2(a, b) <= 1e-4


def test_selectors_and_presets_match_jax(apps):
    """The text-preset and prompt-library selectors, the preset editor and
    the quick-apply buttons give the JAX package's updates."""
    gr = sys.modules["gradio"]
    res = {}
    for tag in ("jax", "port"):
        fn, by_fn = apps[tag]["fn"], apps[tag]["by_fn"]
        out = [fn["select_text_preset"](gr.SelectData(index=i)) for i in ((0, 2), 1, 5, "x")]
        out += [fn["select_audio_prompt"](gr.SelectData(value=v)) for v in ("voice.wav", "no.wav",
                                                                            None)]
        out[-3] = os.path.basename(out[-3]["value"])
        out.append(fn["save_preset"]("FromUI", 25, 2.5, 6.5, 0.5, 1.0, 0.9, 1.0, 3.0, True, 1.4,
                                     0.8, 20))
        out.append(fn["save_preset"]("Custom", *FIELDS))
        out += [fn["apply_preset"](n) for n in ("FromUI", "Independent-High-CFG", "Custom")]
        out += [lam() for _e, lam, inputs, _o in by_fn["<lambda>"] if inputs is None]
        out += [lam(v) for _e, lam, inputs, _o in by_fn["<lambda>"] if inputs is not None
                for v in ("Advanced Mode", "voice", "")]
        res[tag] = out
    assert res["port"] == res["jax"]


def test_build_app_wiring_matches_jax(apps):
    """Every surface of the JAX package's UI is wired in its order: the
    same events, callbacks, and numbers of inputs and outputs."""
    def shape(registry):
        return [(event, getattr(fn, "__name__", "lambda"),
                 None if inputs is None else len(inputs), len(outputs))
                for event, fn, inputs, outputs in registry]

    assert shape(apps["port"]["registry"]) == shape(apps["jax"]["registry"])
    by_fn = apps["port"]["by_fn"]
    for name in ("generate", "generate_stream", "set_lora", "select_text_preset",
                 "select_audio_prompt", "apply_preset", "save_preset"):
        assert name in by_fn, name
    _, _, gen_inputs, gen_outputs = by_fn["generate"][0]
    assert len(gen_inputs) == 23 and len(gen_outputs) == 5
    assert len(by_fn["<lambda>"]) >= 8


def test_build_app_reads_presets_as_jax_does(both, monkeypatch, tmp_path):
    """An explicit presets argument wins over the file, the file over the
    built-in presets; the fields start at the first preset's values."""
    _, ttts = both
    p = tmp_path / "sampler_presets.json"
    p.write_text(json.dumps({"FromFile": {"num_steps": "10"}}))
    eng = Engine(ttts)
    try:
        by_fn, registry = _build(ga, eng, monkeypatch, tmp_path, "a",
                                 presets={"FromArg": {"num_steps": "20"}}, presets_path=str(p))
        apply_fn = by_fn["apply_preset"][0][1]
        assert apply_fn("FromArg")[0]["value"] == 20 and apply_fn("FromFile") == [{}] * 13
        by_fn, _ = _build(ga, eng, monkeypatch, tmp_path, "b", presets_path=str(p))
        assert by_fn["apply_preset"][0][1]("FromFile")[0]["value"] == 10
        by_fn, registry = _build(ga, eng, monkeypatch, tmp_path, "c",
                                 presets={"Cfg": tc.SamplerConfig(num_steps=24)},
                                 presets_path=str(tmp_path / "none.json"))
        steps = next(c for c in _components(registry) if c.kwargs.get("label") == "Steps")
        assert steps.kwargs["value"] == 24
        ui = ga.UIHandlers(eng, presets_path=str(tmp_path / "none.json"),
                           temp_dir=str(tmp_path / "d"))
        assert ui.raw_presets == tpresets.DEFAULT_SAMPLER_PRESETS
        assert ui.initial_fields()[0] == list(tpresets.DEFAULT_SAMPLER_PRESETS)[0]
    finally:
        eng.close()


def _components(registry):
    """The components a registry's callbacks read or write."""
    seen = []
    for _e, _f, inputs, outputs in registry:
        for c in (inputs or []) + list(outputs):
            if c not in seen:
                seen.append(c)
    return seen


def test_build_app_and_serve_raise_without_gradio(both, monkeypatch, tmp_path):
    """Where gradio cannot be imported, build_app raises RuntimeError naming
    it, and so does `serve --gradio`, before it builds any weights."""
    from echo_tts_tpu_torch.serve import __main__ as serve_main

    _, ttts = both
    monkeypatch.setitem(sys.modules, "gradio", None)
    eng = Engine(ttts)
    try:
        with pytest.raises(RuntimeError, match="gradio is not installed"):
            ga.build_app(eng, temp_dir=str(tmp_path / "out"))
    finally:
        eng.close()
    assert not (tmp_path / "out").exists()
    monkeypatch.setattr(serve_main, "build_engine", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="gradio is not installed"):
        serve_main.main(["--cpu", "--random-tiny", "--gradio"])
