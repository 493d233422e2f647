"""The Gradio UI (counterpart of echo_tts_tpu/serve/gradio_app.py), on the
same Engine as the HTTP server.

    python -m echo_tts_tpu_torch.serve --random --gradio [--port 7860]

gradio is optional: it is imported inside `build_app` alone, which raises
RuntimeError naming it where it is missing (the HTTP API, serve/server.py,
needs no gradio). Everything else here runs without it:

* the helpers (`make_stem`, `cleanup_temp_audio`, `parse_buckets`,
  `audio_prompt_files`, `apply_sampler_preset_fields`,
  `save_sampler_preset`, `prepare_speaker_audio`, `build_sampler_config`);
* `UIHandlers`, the UI's callbacks as methods that return plain values:
  generation (custom shapes through `Engine.generate(pipe_overrides=...)`,
  WAV or MP3 with a WAV fallback, the session's temp-file hygiene), the
  streamed playback (`Engine.generate_stream` on (64, 192) blocks, PCM16),
  the LoRA swap that reverts to the base model on an error, the sampler,
  guidance and truncation presets with the preset editor, and the text and
  audio-prompt selectors. `build_app` wraps each in `gr.update`.

The UI offers what the JAX package's does: the audio-prompt library with
search, the LoRA path and strength, the text-preset table, the sampler
preset dropdown and its editor, Simple/Advanced mode, custom shape buckets,
the force-speaker row, WAV/MP3, the original and AE-reconstruction
auditions and the streaming output.
"""
from __future__ import annotations

import dataclasses
import json
import os
import secrets
import time
from pathlib import Path
from typing import Optional

import numpy as np

from echo_tts_tpu_torch.core.config import SamplerConfig
from echo_tts_tpu_torch.pipeline.audio_io import load_audio, resample, write_wav
from echo_tts_tpu_torch.serve.presets import (
    DEFAULT_SAMPLER_PRESETS,
    FORCE_SPEAKER_PRESETS,
    TRUNCATION_PRESETS,
    load_text_presets,
)

AUDIO_EXTS = {".wav", ".mp3", ".m4a", ".ogg", ".flac", ".webm", ".aac", ".opus"}

# the field order of apply_sampler_preset_fields, save_sampler_preset and
# the handlers' sampler arguments
SAMPLER_FIELDS = (
    "num_steps", "cfg_scale_text", "cfg_scale_speaker", "cfg_min_t",
    "cfg_max_t", "truncation_factor", "rescale_k", "rescale_sigma",
    "speaker_kv_enable", "speaker_kv_scale", "speaker_kv_min_t",
    "speaker_kv_max_layers",
)

# the streamed playback's block schedule
STREAM_BLOCKS = (64, 192)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def make_stem(prefix: str, user_id: Optional[str] = None) -> str:
    """A unique output-file stem: prefix[__user]__<ms>_<8 hex>."""
    ts = int(time.time() * 1000)
    rand = secrets.token_hex(4)
    return f"{prefix}__{user_id}__{ts}_{rand}" if user_id else f"{prefix}__{ts}_{rand}"


def cleanup_temp_audio(dir_: Path, user_id: Optional[str], max_age_sec: int = 60 * 5) -> None:
    """Drop the files of `dir_` older than max_age_sec, and every file of
    this session."""
    dir_ = Path(dir_)
    if not dir_.exists():
        return
    now = time.time()
    for p in dir_.glob("*"):
        try:
            if p.is_file() and (now - p.stat().st_mtime) > max_age_sec:
                p.unlink(missing_ok=True)
        except OSError:
            pass
    if user_id:
        for p in dir_.glob(f"*__{user_id}__*"):
            try:
                if p.is_file():
                    p.unlink(missing_ok=True)
            except OSError:
                pass


def parse_buckets(s) -> Optional[tuple]:
    """'640, 2816, 6400' -> (640, 2816, 6400), sorted; blank or None ->
    None (no override)."""
    if s is None:
        return None
    s = str(s).strip()
    if not s:
        return None
    return tuple(sorted(int(float(x)) for x in s.split(",") if x.strip()))


def audio_prompt_files(folder, search_query: str = ""):
    """[[filename], ...] of the prompt library's audio files, sorted without
    case, filtered by a substring."""
    if not folder:
        return []
    folder = Path(folder)
    if not folder.exists():
        return []
    files = sorted((f.name for f in folder.iterdir()
                    if f.is_file() and f.suffix.lower() in AUDIO_EXTS), key=str.lower)
    q = search_query.strip().lower()
    if q:
        files = [f for f in files if q in f.lower()]
    return [[f] for f in files]


def _to_num(v, default, is_int=False):
    try:
        f = float(v)
    except (TypeError, ValueError):
        return default
    return int(f) if is_int else f


def _to_bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def apply_sampler_preset_fields(presets: dict, name: str) -> Optional[dict]:
    """A preset (the sampler_presets.json schema, numbers as strings) as
    {field: value} for the SAMPLER_FIELDS, defaults filled in; None for
    'Custom' or a name not in `presets` (the UI leaves its fields)."""
    if name == "Custom" or name not in presets:
        return None
    p = presets[name]
    return {
        "num_steps": _to_num(p.get("num_steps", "40"), 40, is_int=True),
        "cfg_scale_text": _to_num(p.get("cfg_scale_text", "3.0"), 3.0),
        "cfg_scale_speaker": _to_num(p.get("cfg_scale_speaker", "5.0"), 5.0),
        "cfg_min_t": _to_num(p.get("cfg_min_t", "0.5"), 0.5),
        "cfg_max_t": _to_num(p.get("cfg_max_t", "1.0"), 1.0),
        "truncation_factor": _to_num(p.get("truncation_factor", "0.8"), 0.8),
        "rescale_k": _to_num(p.get("rescale_k", "1.2"), 1.2),
        "rescale_sigma": _to_num(p.get("rescale_sigma", "3.0"), 3.0),
        "speaker_kv_enable": _to_bool(p.get("speaker_kv_enable", False)),
        "speaker_kv_scale": _to_num(p.get("speaker_kv_scale", "1.5"), 1.5),
        "speaker_kv_min_t": _to_num(p.get("speaker_kv_min_t", "0.9"), 0.9),
        "speaker_kv_max_layers": _to_num(p.get("speaker_kv_max_layers", "24"), 24,
                                         is_int=True),
    }


def save_sampler_preset(path: str, name: str, fields: dict) -> dict:
    """Store the field values under `name` in the presets file (its schema:
    numbers as strings), adding to what it holds; returns the presets."""
    name = (name or "").strip()
    if not name or name == "Custom":
        raise ValueError("preset name must be non-empty and not 'Custom'")
    presets = {}
    if os.path.exists(path):
        with open(path) as f:
            presets = json.load(f)
    entry = {}
    for k in SAMPLER_FIELDS:
        if k not in fields:
            continue
        v = fields[k]
        entry[k] = bool(v) if k == "speaker_kv_enable" else str(v)
    presets[name] = entry
    with open(path, "w") as f:
        json.dump(presets, f, indent=2)
    return presets


def prepare_speaker_audio(speaker, sample_rate: int):
    """A gradio Audio value, an (sr, samples) tuple or a file path, as the
    pipeline's (1, samples) float32 at the codec rate; None stays None. An
    integer or out-of-range tuple is read as PCM16 and scaled."""
    if speaker is None:
        return None
    if isinstance(speaker, (str, Path)):
        return load_audio(str(speaker))
    sr, data = speaker
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    peak = np.abs(data).max(initial=0.0)
    if data.dtype.kind == "i" or peak > 1.5:
        data = data / 32768.0
    return resample(data[None], sr, sample_rate)


def build_sampler_config(base: SamplerConfig, fields: dict,
                         custom_latent_length=None) -> SamplerConfig:
    """`base` with the UI's field values; the force-speaker fields only when
    it is on (None otherwise); custom_latent_length sets sequence_length."""
    over = {
        "num_steps": int(fields["num_steps"]),
        "cfg_scale_text": float(fields["cfg_scale_text"]),
        "cfg_scale_speaker": float(fields["cfg_scale_speaker"]),
        "cfg_min_t": float(fields["cfg_min_t"]),
        "cfg_max_t": float(fields["cfg_max_t"]),
        "truncation_factor": float(fields["truncation_factor"]),
        "rescale_k": float(fields["rescale_k"]),
        "rescale_sigma": float(fields["rescale_sigma"]),
    }
    if fields.get("speaker_kv_enable"):
        over.update({
            "speaker_kv_scale": float(fields["speaker_kv_scale"]),
            "speaker_kv_min_t": float(fields["speaker_kv_min_t"]),
            "speaker_kv_max_layers": int(fields["speaker_kv_max_layers"]),
        })
    else:
        over.update({"speaker_kv_scale": None, "speaker_kv_min_t": None,
                     "speaker_kv_max_layers": None})
    if custom_latent_length:
        over["sequence_length"] = int(custom_latent_length)
    return dataclasses.replace(base, **over)


def fields_from_args(*values) -> dict:
    """The handlers' twelve sampler arguments, in SAMPLER_FIELDS order."""
    return dict(zip(SAMPLER_FIELDS, values))


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------


class UIHandlers:
    """The UI's callbacks on one Engine, returning plain values (no gradio).

    presets: {name: dict or SamplerConfig} or None; it wins over the file at
    presets_path, which wins over DEFAULT_SAMPLER_PRESETS. The preset editor
    writes presets_path. Generated files go to temp_dir (default
    ./echo_outputs)."""

    def __init__(self, engine, presets: Optional[dict] = None,
                 presets_path: str = "sampler_presets.json",
                 text_presets_path: str = "text_presets.txt",
                 audio_prompt_folder: Optional[str] = None, temp_dir: Optional[str] = None):
        self.engine = engine
        self.presets_path = presets_path
        self.text_presets_path = text_presets_path
        self.audio_prompt_folder = audio_prompt_folder
        if presets is not None:
            self.raw_presets = {k: (dataclasses.asdict(v) if isinstance(v, SamplerConfig) else v)
                                for k, v in presets.items()}
        elif os.path.exists(presets_path):
            with open(presets_path) as f:
                self.raw_presets = json.load(f)
        else:
            self.raw_presets = dict(DEFAULT_SAMPLER_PRESETS)
        self.sr = engine.tts.ae_cfg.sample_rate
        self.tmp = Path(temp_dir or (Path.cwd() / "echo_outputs"))
        self.tmp.mkdir(parents=True, exist_ok=True)

    def initial_fields(self) -> tuple:
        """(the first preset's name, its field values): the values the UI
        shows before any change event (the defaults for 'Custom')."""
        first = (list(self.raw_presets) or ["Custom"])[0]
        init = (apply_sampler_preset_fields(self.raw_presets, first)
                or apply_sampler_preset_fields({"_": {}}, "_"))
        return first, init

    def generate(self, session_id, text, speaker, fmt, num_steps, cfg_text, cfg_speaker,
                 cfg_min_t, cfg_max_t, trunc, rk, rs, force, kvs, kvmt, kvml, seed,
                 text_buckets, speaker_buckets, latent_length, use_custom_shapes,
                 show_original, show_recon):
        """One generation, saved to a file of this session. With
        use_custom_shapes the bucket fields override the pipeline's buckets
        for this request and the latent-length field (its largest entry)
        sets the length. Returns (session_id, the file's path, a status
        line, the original prompt (sr, samples) or None, its AE
        reconstruction or None)."""
        session_id = session_id or secrets.token_hex(8)
        cleanup_temp_audio(self.tmp, session_id)
        fields = fields_from_args(num_steps, cfg_text, cfg_speaker, cfg_min_t, cfg_max_t, trunc,
                                  rk, rs, force, kvs, kvmt, kvml)
        lat_buckets = parse_buckets(latent_length) if use_custom_shapes else None
        sc = build_sampler_config(SamplerConfig(), fields,
                                  lat_buckets[-1] if lat_buckets else None)
        audio_in = prepare_speaker_audio(speaker, self.sr)
        pipe_overrides = {}
        if use_custom_shapes:
            tb, sb = parse_buckets(text_buckets), parse_buckets(speaker_buckets)
            if tb:
                pipe_overrides["text_buckets"] = tb
            if sb:
                pipe_overrides["speaker_buckets"] = sb

        t0 = time.time()
        audio, normalized, _ = self.engine.generate(text, audio_in, seed=int(seed), sc=sc,
                                                    pipe_overrides=pipe_overrides or None)
        elapsed = time.time() - t0

        stem = make_stem("echo", session_id)
        out_path = self.tmp / f"{stem}.wav"
        if fmt == "mp3":
            from echo_tts_tpu_torch.native.mp3_py import encode_mp3

            mp3_path = self.tmp / f"{stem}.mp3"
            if encode_mp3(str(mp3_path), audio[0], self.sr):
                out_path = mp3_path
            else:
                write_wav(str(out_path), audio[0], self.sr)
        else:
            write_wav(str(out_path), audio[0], self.sr)

        orig = (self.sr, audio_in[0]) if (show_original and audio_in is not None) else None
        recon = None
        if show_recon and audio_in is not None:
            recon = (self.sr, np.asarray(self.engine.reconstruct(audio_in))[0, 0])
        return (session_id, str(out_path), f"Generated in {elapsed:.1f}s — {normalized}", orig,
                recon)

    def generate_stream(self, text, speaker, num_steps, cfg_text, cfg_speaker, cfg_min_t,
                        cfg_max_t, trunc, rk, rs, force, kvs, kvmt, kvml, seed):
        """The streamed playback: (sr, PCM16 samples) a block as the
        blockwise sampler and the stateful decode give it."""
        fields = fields_from_args(num_steps, cfg_text, cfg_speaker, cfg_min_t, cfg_max_t, trunc,
                                  rk, rs, force, kvs, kvmt, kvml)
        sc = build_sampler_config(SamplerConfig(), fields)
        audio_in = prepare_speaker_audio(speaker, self.sr)
        for chunk in self.engine.generate_stream(text, audio_in, seed=int(seed), sc=sc,
                                                 block_size=STREAM_BLOCKS):
            pcm = np.clip(np.asarray(chunk)[0, 0] * 32767.0, -32768, 32767).astype(np.int16)
            yield self.sr, pcm

    def set_lora(self, path, strength) -> str:
        """Swap to the LoRA at `path` (blank: the base model); on an error
        go back to the base model and say why."""
        path = (path or "").strip()
        try:
            self.engine.set_lora(path or None, float(strength))
            if path:
                return f"✅ Loaded LoRA: {Path(path).name} (strength: {float(strength):.2f})"
            return "ℹ️ Using base model (no LoRA)"
        except Exception as e:
            self.engine.set_lora(None)
            return f"❌ Error loading LoRA: {e}"

    def select_text_preset(self, index) -> Optional[str]:
        """The text of the preset table's row `index` (an int or a (row,
        column) pair); None when there is no such row."""
        rows = load_text_presets(self.text_presets_path)
        idx = index[0] if isinstance(index, (tuple, list)) else index
        if isinstance(idx, int) and 0 <= idx < len(rows):
            return rows[idx][2]
        return None

    def select_audio_prompt(self, value) -> Optional[str]:
        """The path of the library's file `value`; None when there is none."""
        if value and self.audio_prompt_folder:
            p = Path(self.audio_prompt_folder) / str(value)
            if p.exists():
                return str(p)
        return None

    def apply_preset(self, name) -> Optional[dict]:
        return apply_sampler_preset_fields(self.raw_presets, name)

    def save_preset(self, name, *args) -> tuple:
        """Save the twelve field values under `name`: (the preset names,
        None) or (None, the error)."""
        try:
            self.raw_presets = save_sampler_preset(self.presets_path, name,
                                                   fields_from_args(*args))
            return list(self.raw_presets), None
        except (ValueError, OSError) as e:
            return None, str(e)

    @staticmethod
    def apply_cfg_preset(name) -> Optional[tuple]:
        p = FORCE_SPEAKER_PRESETS.get(name)
        return (p["cfg_scale_text"], p["cfg_scale_speaker"]) if p else None

    @staticmethod
    def apply_trunc_preset(name) -> Optional[tuple]:
        p = TRUNCATION_PRESETS.get(name)
        return (p["truncation_factor"], p["rescale_k"], p["rescale_sigma"]) if p else None


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------


def require_gradio():
    """The gradio module; RuntimeError naming it where it is not installed."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed: the UI needs it; the HTTP API "
            "(python -m echo_tts_tpu_torch.serve without --gradio) does not") from e
    return gr


def build_app(engine, presets: Optional[dict] = None,
              presets_path: str = "sampler_presets.json",
              text_presets_path: str = "text_presets.txt",
              audio_prompt_folder: Optional[str] = None, temp_dir: Optional[str] = None):
    """The gr.Blocks of the UI on `engine` (UIHandlers' arguments); call
    `.launch()` on it. Raises RuntimeError where gradio is missing."""
    gr = require_gradio()
    ui = UIHandlers(engine, presets, presets_path, text_presets_path, audio_prompt_folder,
                    temp_dir)

    def generate(*args):
        session_id, out_path, status, orig, recon = ui.generate(*args)
        return (session_id, out_path, status, gr.update(value=orig, visible=orig is not None),
                gr.update(value=recon, visible=recon is not None))

    def generate_stream(*args):
        yield from ui.generate_stream(*args)

    def set_lora(path, strength):
        return ui.set_lora(path, strength)

    def select_text_preset(evt: "gr.SelectData"):
        text = ui.select_text_preset(evt.index)
        return gr.update() if text is None else gr.update(value=text)

    def select_audio_prompt(evt: "gr.SelectData"):
        path = ui.select_audio_prompt(evt.value)
        return gr.update() if path is None else gr.update(value=path)

    def apply_preset(name):
        vals = ui.apply_preset(name)
        if vals is None:
            return [gr.update()] * 13
        return ([gr.update(value=vals[k]) for k in SAMPLER_FIELDS]
                + [gr.update(visible=vals["speaker_kv_enable"])])

    def save_preset(name, *args):
        names, err = ui.save_preset(name, *args)
        if err is not None:
            return gr.update(), f"❌ {err}"
        return gr.update(choices=["Custom"] + names, value=name), f"✅ Saved preset '{name}'"

    def quick(values, n):
        return [gr.update()] * n if values is None else [gr.update(value=v) for v in values]

    first_name, init = ui.initial_fields()
    with gr.Blocks(title="Echo-TTS") as demo:
        gr.Markdown("# Echo-TTS")
        gr.Markdown("**License Notice:** outputs are CC-BY-NC-SA-4.0 (non-commercial). "
                    "**Responsible Use:** do not impersonate real people without consent or "
                    "generate deceptive audio.")
        session = gr.State(None)

        gr.Markdown("## Speaker Reference")
        with gr.Row():
            if audio_prompt_folder and Path(audio_prompt_folder).exists():
                with gr.Column(scale=1, min_width=200):
                    gr.Markdown("#### Audio Library (click to load)")
                    prompt_search = gr.Textbox(label="", placeholder="🔍 Search audio prompts...",
                                               lines=1, max_lines=1)
                    prompt_table = gr.Dataframe(value=audio_prompt_files(audio_prompt_folder),
                                                headers=["Filename"], datatype=["str"],
                                                interactive=False, label="")
            else:
                prompt_search = prompt_table = None
            with gr.Column(scale=2):
                speaker = gr.Audio(sources=["upload", "microphone"], type="filepath",
                                   label="Speaker reference (first 5 minutes used; blank for "
                                         "none)")

        gr.Markdown("## LoRA Fine-Tuning (Optional)")
        with gr.Accordion("Load Custom LoRA Checkpoint", open=False):
            lora_path = gr.Textbox(label="LoRA Checkpoint Path",
                                   placeholder="checkpoints/lora_best.npz")
            lora_strength = gr.Slider(0.0, 3.0, value=1.0, step=0.05, label="LoRA Strength")
            lora_status = gr.Markdown("ℹ️ Using base model (no LoRA)")

        gr.Markdown("## Text Prompt")
        with gr.Accordion("Text Presets", open=True):
            text_table = gr.Dataframe(value=load_text_presets(text_presets_path),
                                      headers=["Category", "Words", "Preset Text"],
                                      datatype=["str", "str", "str"], interactive=False)
        text = gr.Textbox(label="Text Prompt", lines=4,
                          placeholder="[S1] Enter your text prompt here...")

        gr.Markdown("## Generation")
        mode = gr.Radio(["Simple Mode", "Advanced Mode"], value="Simple Mode", label="")
        with gr.Accordion("Generation Parameters", open=True):
            with gr.Row():
                preset_dd = gr.Dropdown(["Custom"] + list(ui.raw_presets), value=first_name,
                                        label="Sampler Preset")
                steps = gr.Number(value=init["num_steps"], precision=0, minimum=5, maximum=80,
                                  label="Steps")
                seed = gr.Number(value=0, precision=0, label="RNG Seed")
            with gr.Row():
                preset_name = gr.Textbox(label="Save preset as", lines=1)
                preset_save_btn = gr.Button("Save preset")
                preset_save_status = gr.Markdown("")
            force = gr.Checkbox(label='"Force Speaker" (KV scaling)',
                                value=init["speaker_kv_enable"])
            with gr.Row(visible=init["speaker_kv_enable"]) as kv_row:
                kv_scale = gr.Number(value=init["speaker_kv_scale"], label="KV Scale", minimum=0)
                kv_min_t = gr.Number(value=init["speaker_kv_min_t"], label="KV Min t", minimum=0,
                                     maximum=1)
                kv_layers = gr.Number(value=init["speaker_kv_max_layers"], precision=0,
                                      minimum=0, maximum=24, label="Max Layers")
            with gr.Column(visible=False) as advanced:
                with gr.Row():
                    trunc = gr.Number(value=init["truncation_factor"], label="Truncation Factor",
                                      minimum=0)
                    rk = gr.Number(value=init["rescale_k"], label="Rescale k", minimum=0)
                    rs = gr.Number(value=init["rescale_sigma"], label="Rescale σ", minimum=0)
                    trunc_flat = gr.Button("flat", size="sm")
                    trunc_sharp = gr.Button("sharp", size="sm")
                    trunc_base = gr.Button("baseline(sharp)", size="sm")
                with gr.Row():
                    cfg_t = gr.Number(value=init["cfg_scale_text"], label="Text CFG", minimum=0)
                    cfg_s = gr.Number(value=init["cfg_scale_speaker"], label="Speaker CFG",
                                      minimum=0)
                    cfg_min = gr.Number(value=init["cfg_min_t"], label="CFG Min t", minimum=0,
                                        maximum=1)
                    cfg_max = gr.Number(value=init["cfg_max_t"], label="CFG Max t", minimum=0,
                                        maximum=1)
                    cfg_higher = gr.Button("higher speaker", size="sm")
                    cfg_large = gr.Button("large guidances", size="sm")
                use_shapes = gr.Checkbox(label="Use Custom Shapes (Advanced)")
                with gr.Row(visible=False) as shapes_row:
                    text_buckets = gr.Textbox(value="768", label="Max Text Byte Length")
                    spk_buckets = gr.Textbox(value="640, 2816, 6400",
                                             label="Max Speaker Latent Length")
                    lat_len = gr.Textbox(value="640", label="Sample Latent Length")

        with gr.Row():
            fmt = gr.Radio(["wav", "mp3"], value="wav", label="Format")
            btn = gr.Button("Generate Audio", variant="primary")
            stream_btn = gr.Button("Generate (Streaming)")
            show_orig = gr.Checkbox(label="Re-display Original Audio")
            show_recon = gr.Checkbox(label="Show Autoencoder Reconstruction (first 30s of "
                                           "reference)")

        with gr.Accordion("Generated Audio", open=True):
            status = gr.Markdown("")
            out_audio = gr.Audio(label="Generated Audio", type="filepath")
            stream_audio = gr.Audio(label="Streaming Output", streaming=True, autoplay=True)
            orig_audio = gr.Audio(label="Original Reference Audio (5 min)", visible=False)
            recon_audio = gr.Audio(label="Decoded Reference Audio (30s)", visible=False)

        sampler_inputs = [steps, cfg_t, cfg_s, cfg_min, cfg_max, trunc, rk, rs, force, kv_scale,
                          kv_min_t, kv_layers]
        if prompt_table is not None:
            prompt_table.select(select_audio_prompt, outputs=[speaker])
            prompt_search.change(
                lambda q: gr.update(value=audio_prompt_files(audio_prompt_folder, q)),
                inputs=[prompt_search], outputs=[prompt_table])
        text_table.select(select_text_preset, outputs=[text])
        mode.change(lambda m: gr.update(visible=m == "Advanced Mode"), inputs=[mode],
                    outputs=[advanced])
        force.change(lambda f: gr.update(visible=bool(f)), inputs=[force], outputs=[kv_row])
        use_shapes.change(lambda f: gr.update(visible=bool(f)), inputs=[use_shapes],
                          outputs=[shapes_row])
        preset_dd.change(apply_preset, inputs=[preset_dd], outputs=sampler_inputs + [kv_row])
        preset_save_btn.click(save_preset, inputs=[preset_name] + sampler_inputs,
                              outputs=[preset_dd, preset_save_status])
        for button, name in ((trunc_flat, "flat"), (trunc_sharp, "sharp"),
                             (trunc_base, "baseline")):
            button.click(lambda name=name: quick(ui.apply_trunc_preset(name), 3),
                         outputs=[trunc, rk, rs])
        for button, name in ((cfg_higher, "higher speaker"), (cfg_large, "large guidances")):
            button.click(lambda name=name: quick(ui.apply_cfg_preset(name), 2),
                         outputs=[cfg_t, cfg_s])
        lora_path.change(set_lora, inputs=[lora_path, lora_strength], outputs=[lora_status])
        lora_strength.release(set_lora, inputs=[lora_path, lora_strength],
                              outputs=[lora_status])
        btn.click(generate,
                  inputs=[session, text, speaker, fmt] + sampler_inputs
                  + [seed, text_buckets, spk_buckets, lat_len, use_shapes, show_orig,
                     show_recon],
                  outputs=[session, out_audio, status, orig_audio, recon_audio])
        stream_btn.click(generate_stream, inputs=[text, speaker] + sampler_inputs + [seed],
                         outputs=[stream_audio])
    return demo
