"""The port's checkpoint-driven entry points (echo_tts_tpu_torch/scripts and
serve/__main__.py) against the JAX package's scripts, from tiny safetensors
files on the CPU.

* convert_checkpoint: the npz equal to the JAX CLI's, key for key and byte
  for byte;
* batch_synthesize --cpu: each WAV equal to its row of the direct
  `sample_pipeline_batch` call, and within the whole-pipeline rel-L2 1e-4 of
  tests/test_torch_pipeline.py of the JAX script's WAV on the same files and
  seeds (both in fp32) (its fleet mode: tests/test_torch_fleet.py);
* finetune_lora --cpu, one epoch: finite losses, the first equal to
  `make_train_step` called directly on the first batch (from the state the
  run's own `prepare` built: one module fixture runs the script once, with
  torch on two threads, as its many small ops crawl when the test workers
  oversubscribe the cores), an adapter (saved with `extra`) that both
  packages load and `Engine.set_lora` swaps in;
* serve --cpu --dit/--ae/--pca over HTTP, WAV and "format": "mp3";
* bench_train --cpu --tiny.
"""
import base64
import contextlib
import copy
import importlib.util
import io
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from echo_tts_tpu_torch.core.config import SamplerConfig
from echo_tts_tpu_torch.pipeline.audio_io import read_wav, write_wav
from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline, sample_pipeline_batch
from echo_tts_tpu_torch.scripts import batch_synthesize, bench_train, convert_checkpoint
from echo_tts_tpu_torch.scripts import finetune_lora
from echo_tts_tpu_torch.serve import __main__ as serve_main
from echo_tts_tpu_torch.serve.server import serve, wav_bytes

from torch_parity import rel_l2, write_tiny_checkpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SC = SamplerConfig(num_steps=2, sequence_length=16)


def _jax_script(name: str):
    """scripts/<name>.py of the JAX package, as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_tiny_checkpoints(tmp_path_factory.mktemp("ckpt"), 5, 6)


def _load_args(files):
    p = files["paths"]
    return ["--dit", p["dit"], "--ae", p["ae"], "--pca", p["pca"]]


@pytest.mark.parametrize("argv", [["dit"], ["dit", "--delete-blockwise"],
                                  ["dit", "--dtype", "f32"], ["ae"]])
def test_convert_checkpoint_equals_the_jax_cli(files, tmp_path, monkeypatch, argv):
    kind = argv[0]
    src = files["paths"][kind]
    mine, theirs = str(tmp_path / "mine.npz"), str(tmp_path / "theirs.npz")
    out = convert_checkpoint.main([kind, src, mine, "--cpu"] + argv[1:])
    monkeypatch.setattr("sys.argv", ["convert_checkpoint.py", kind, src, theirs] + argv[1:])
    _jax_script("convert_checkpoint").main()
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        assert sum(a[k].size for k in a.files) == out["params"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def _requests(tmp_path):
    """Three requests: two without a prompt, one with a 48 kHz WAV prompt
    (resampled to 44.1 kHz by the native route)."""
    rng = np.random.default_rng(3)
    voice = str(tmp_path / "voice48k.wav")
    write_wav(voice, (0.05 * rng.standard_normal((1, 48000 // 4))).astype(np.float32), 48000)
    reqs = [{"id": "a", "text": "First utterance.", "speaker": None, "seed": 1},
            {"id": "b", "text": "Second one, a little longer.", "speaker": None, "seed": 2},
            {"id": "c", "text": "With a voice.", "speaker": voice, "seed": 3}]
    path = tmp_path / "reqs.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in reqs))
    return str(path), reqs


def test_batch_synthesize_from_files(files, tmp_path, monkeypatch, capsys):
    from echo_tts_tpu.checkpoints import io as jio
    from echo_tts_tpu.pipeline import pipeline as jpipe

    inp, reqs = _requests(tmp_path)
    common = ["--input", inp, "--max-batch", "2", "--num-steps", "2",
              "--sequence-length", "16"] + _load_args(files)
    summary = batch_synthesize.main(common + ["--outdir", str(tmp_path / "port"), "--cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["files"] == 3 and summary["speaker_encodes"] == 1
    assert summary["audio_s"] > 0 and summary["audio_s_per_s"] > 0

    args = batch_synthesize.build_args(common + ["--outdir", str(tmp_path / "x"), "--cpu"])
    synth = batch_synthesize.Synth(args)
    assert synth.tts.model_dtype == torch.float32 and not synth.tts.dit_cfg.has_latent_modules
    for chunk in (reqs[:2], reqs[2:]):
        direct = sample_pipeline_batch(synth.tts, synth.batch_requests(chunk), sc=SC)
        for r, (audio, _, _) in zip(chunk, direct):
            with open(tmp_path / "port" / f"{r['id']}.wav", "rb") as f:
                assert f.read() == wav_bytes(audio[0], synth.tts.ae_cfg.sample_rate), r["id"]

    # the JAX script on the same files and seeds, its DiT in fp32 as the
    # port's CPU path runs it (the JAX loader's default is bf16)
    real_load, real_tts = jio.load_dit_from_safetensors, jpipe.EchoTTS
    monkeypatch.setattr(jio, "load_dit_from_safetensors",
                        lambda path, **kw: real_load(path, **dict(kw, dtype=jnp.float32)))
    monkeypatch.setattr(jpipe, "EchoTTS",
                        lambda *a, **kw: real_tts(*a, **dict(kw, model_dtype=jnp.float32)))
    _jax_script("batch_synthesize").main(common + ["--outdir", str(tmp_path / "jax"), "--cpu"])
    for r in reqs:
        got, sr = read_wav(str(tmp_path / "port" / f"{r['id']}.wav"))
        ref, sr_ref = read_wav(str(tmp_path / "jax" / f"{r['id']}.wav"))
        assert sr == sr_ref and got.shape == ref.shape, r["id"]
        assert rel_l2(got, ref) < 1e-4, (r["id"], rel_l2(got, ref))


def _clips(tmp_path, n=3, seconds=1.0):
    """n synthetic clips and their transcripts."""
    d = tmp_path / "clips"
    d.mkdir()
    rng = np.random.default_rng(7)
    sr = 44100
    texts = {}
    for i in range(n):
        tt = np.arange(int(sr * seconds)) / sr
        x = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * tt) + 0.02 * rng.standard_normal(tt.size)
        path = str(d / f"clip{i}.wav")
        write_wav(path, x.astype(np.float32)[None], sr)
        texts[path] = f"[S1] Clip number {i} says something."
    tr = tmp_path / "transcripts.json"
    tr.write_text(json.dumps(texts))
    return str(d), str(tr)


@contextlib.contextmanager
def _two_threads():
    """torch on at most two threads for the block: the finetune's many
    small ops (a tiny DiT's forward and backward, the AE encodes) crawl
    when every test worker's thread pool takes all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def finetune_run(files, tmp_path_factory):
    """One `finetune_lora.main` run of one epoch: its argv, stdout, summary
    and the state its `prepare` handed the epoch (the data-order rng copied
    before the first batch was drawn), so that the first step can be re-run
    by hand without preparing (loading and encoding) a second time."""
    tmp = tmp_path_factory.mktemp("finetune")
    # a tenth of a second a clip: at the tiny AE's 16 samples a latent that
    # is 275 latents (bucket 320) a clip and a speaker prompt, where a second
    # (bucket 2816) made the step's attention ~80 times the work
    audio_dir, tr = _clips(tmp, seconds=0.1)
    argv = ["--audio-dir", audio_dir, "--transcripts", tr, "--out", str(tmp / "lora.npz"),
            "--epochs", "1", "--batch-size", "2", "--rank", "4", "--cpu"] + _load_args(files)
    real, seen = finetune_lora.prepare, {}

    def prepare(args):
        run = real(args)
        seen["run"] = dict(run, rng=copy.deepcopy(run["rng"]))
        return run

    stdout = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, _two_threads(), contextlib.redirect_stdout(stdout):
        mp.setattr(finetune_lora, "prepare", prepare)
        summary = finetune_lora.main(argv)
    return {"argv": argv, "stdout": stdout.getvalue(), "summary": summary, "run": seen["run"]}


def test_finetune_lora_one_epoch(files, finetune_run):
    from echo_tts_tpu.train.lora import load_lora_checkpoint as j_load_lora
    from echo_tts_tpu_torch.serve.engine import Engine
    from echo_tts_tpu_torch.train.data import batches
    from echo_tts_tpu_torch.train.loop import make_train_step
    from echo_tts_tpu_torch.train.lora import init_lora, load_lora_checkpoint

    argv, summary, run = finetune_run["argv"], finetune_run["summary"], finetune_run["run"]
    args = finetune_lora.parse_args(argv)
    out = args.out
    assert json.loads(finetune_run["stdout"].strip().splitlines()[-1]) == summary
    assert summary["steps"] == 1 and all(np.isfinite(summary["step_losses"]))
    assert np.isfinite(summary["best_val_loss"]) and os.path.exists(out)

    # the first step again, by hand, from the state prepare() built
    with _two_threads():
        first = next(batches(run["ds"], args.batch_size, run["rng"]))
        lora = init_lora(torch.Generator().manual_seed(args.seed), run["dit_params"],
                         run["lc"])
        opt, step = make_train_step(run["dit_cfg"], run["tc"], model_dtype=torch.float32,
                                    lora_cfg=run["lc"])
        _, _, loss = step(run["dit_params"], lora, opt.init(lora),
                          torch.Generator().manual_seed(args.seed + 1), first)
    assert float(loss) == summary["step_losses"][0]

    lora_t, lc = load_lora_checkpoint(out, device="cpu")
    lora_j, lc_j = j_load_lora(out)
    assert lc.rank == lc_j.rank == 4 and lc.targets == lc_j.targets
    eng = Engine(serve_main.load_tts(*[files["paths"][k] for k in ("dit", "ae", "pca")],
                                     torch.device("cpu")))
    try:
        base, _, _ = eng.generate("Adapter.", None, seed=1, sc=SC)
        eng.set_lora(out)
        assert eng._current_lora_path == out
        adapted, _, _ = eng.generate("Adapter.", None, seed=1, sc=SC)
        eng.set_lora(None)
        again, _, _ = eng.generate("Adapter.", None, seed=1, sc=SC)
    finally:
        eng.close()
    assert np.isfinite(adapted).all() and np.array_equal(again, base)


def test_save_lora_checkpoint_takes_extra(tmp_path):
    """The port's save_lora_checkpoint takes `extra` as the JAX one does and
    writes the same format: a file written with it loads in both packages."""
    from echo_tts_tpu.train.lora import load_lora_checkpoint as j_load
    from echo_tts_tpu_torch.train.lora import LoRAConfig, load_lora_checkpoint, save_lora_checkpoint

    lora = {"blocks.attention.wq": {"a": torch.randn(2, 8, 4), "b": torch.randn(2, 4, 8)}}
    path = str(tmp_path / "l.npz")
    save_lora_checkpoint(path, lora, LoRAConfig(rank=4, alpha=8.0, targets=tuple(lora)),
                         extra={"epoch": 3, "val_loss": 0.5})
    got, lc = load_lora_checkpoint(path, device="cpu")
    ref, lc_j = j_load(path)
    assert lc.rank == lc_j.rank == 4 and lc.alpha == lc_j.alpha == 8.0
    for k in ("a", "b"):
        assert torch.equal(got["blocks.attention.wq"][k], lora["blocks.attention.wq"][k])
        assert np.array_equal(np.asarray(ref["blocks.attention.wq"][k]),
                              lora["blocks.attention.wq"][k].numpy())


def _post(base, path, obj):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.headers, resp.read()


def test_serve_from_files_wav_and_mp3(files, tmp_path):
    """serve --cpu --dit/--ae/--pca: /tts sends the WAV of the direct
    sample_pipeline call on the loaded files; "format": "mp3" sends MP3 that
    decodes to the WAV's length, give or take the codec delay (WAV where
    libmp3lame is missing); a 48 kHz WAV prompt is resampled natively."""
    from echo_tts_tpu_torch.native import mp3_py

    args = serve_main.parse_args(["--cpu"] + _load_args(files))
    eng = serve_main.build_engine(args)
    httpd = serve(eng, port=0, background=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert eng.tts.device.type == "cpu" and not eng.tts.dit_cfg.has_latent_modules
        fields = {"num_steps": 2, "sequence_length": 16}
        _, body = _post(base, "/tts", {"text": "Served from files.", "seed": 2, **fields})
        direct, _, _ = sample_pipeline(eng.tts, "Served from files.", None, 2, sc=SC,
                                       normalize_text=True)
        assert body == wav_bytes(direct[0], eng.tts.ae_cfg.sample_rate)
        headers, mp3 = _post(base, "/tts", {"text": "Served from files.", "seed": 2,
                                            "format": "mp3", **fields})
        if mp3_py.mp3_encode_available():
            assert headers["Content-Type"] == "audio/mpeg"
            path = str(tmp_path / "out.mp3")
            open(path, "wb").write(mp3)
            y, sr = mp3_py.decode_mp3(path)
            assert sr == eng.tts.ae_cfg.sample_rate
            # the encoder's delay and padding: up to three 1152-sample frames
            assert 0 <= y.shape[-1] - direct.shape[-1] <= 3 * 1152
        else:
            assert headers["Content-Type"] == "audio/wav" and mp3 == body
        rng = np.random.default_rng(9)
        voice = str(tmp_path / "v48.wav")
        write_wav(voice, (0.05 * rng.standard_normal((1, 12000))).astype(np.float32), 48000)
        b64 = base64.b64encode(open(voice, "rb").read()).decode()
        headers, body = _post(base, "/tts", {"text": "Prompted.", "seed": 4,
                                             "speaker_wav_b64": b64, **fields})
        assert headers["Content-Type"] == "audio/wav" and body[:4] == b"RIFF"
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()


def test_bench_train_cpu_tiny(capsys):
    res = bench_train.main(["--cpu", "--tiny"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert res["unit"] == "ms" and res["value"] > 0
    assert res["metric"].startswith("LoRA train step")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench_train.main([])
