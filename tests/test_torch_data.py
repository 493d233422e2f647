"""The port's training data path (echo_tts_tpu_torch.train.data and
pipeline/audio_io) against the JAX package's: WAV I/O and resampling; the
pre-encoding dataset and collate on WAV files in tmp_path, with AE and PCA
weights from the JAX initializers carried over (latents rel-L2 <= 1e-4;
ids, masks and bucket shapes exact); batches and the prefetching producer;
the ASR helpers with an injected callable. Tiny AE config, fp32 on the CPU."""
import threading
import time

import numpy as np
import pytest

import jax

from echo_tts_tpu.bench.init_ae import init_ae_params as j_init_ae
from echo_tts_tpu.core.config import AEConfig as JAEConfig
from echo_tts_tpu.models.pca import PCAState as JPCAState
from echo_tts_tpu.pipeline import audio_io as jio
from echo_tts_tpu.train import data as jdata
from echo_tts_tpu_torch.checkpoints.from_jax import ae_params_from_numpy
from echo_tts_tpu_torch.core.config import AEConfig
from echo_tts_tpu_torch.models.pca import PCAState
from echo_tts_tpu_torch.pipeline import audio_io as tio
from echo_tts_tpu_torch.train import data as tdata

from torch_parity import np_tree, rel_l2

ACFG = AEConfig().tiny()


@pytest.fixture(scope="module")
def ae():
    ja = j_init_ae(jax.random.PRNGKey(3), JAEConfig().tiny())
    jpca = JPCAState.random(0, ACFG.latent_dim)
    return ja, jpca, ae_params_from_numpy(np_tree(ja), ACFG, device="cpu"), \
        PCAState.random(0, ACFG.latent_dim, device="cpu")


def _write_clips(d, n, lengths, seed=0, sr=44100):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = str(d / f"s{i}.wav")
        tio.write_wav(p, (0.2 * rng.standard_normal(lengths[i])).astype(np.float32)[None], sr)
        paths.append(p)
    return paths


def test_wav_io_and_resample_match_jax(tmp_path):
    sr = 22050
    x = (0.5 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)).astype(np.float32)[None]
    x2 = np.concatenate([x, 0.5 * x], axis=0)
    tio.write_wav(str(tmp_path / "t.wav"), x2, sr)
    jio.write_wav(str(tmp_path / "j.wav"), x2, sr)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr_t = tio.read_wav(str(tmp_path / "j.wav"))
    ref, sr_j = jio.read_wav(str(tmp_path / "j.wav"))
    assert sr_t == sr_j == sr and got.shape == (2, sr)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(tio.resample(x, sr, 44100), jio.resample(x, sr, 44100),
                               atol=1e-6)
    np.testing.assert_allclose(tio.load_audio(str(tmp_path / "t.wav")),
                               jio.load_audio(str(tmp_path / "t.wav")), atol=1e-6)


def test_dataset_and_collate_match_jax(tmp_path, ae):
    ja, jpca, ta, tpca = ae
    fl = ACFG.frame_length
    paths = _write_clips(tmp_path, 3, [fl * (20 + 4 * i) + 5 for i in range(3)])
    transcripts = {p: f"[S1] sample {i}" for i, p in enumerate(paths)}
    t_samples = tdata.prepare_samples_from_directory(str(tmp_path), transcripts)
    j_samples = jdata.prepare_samples_from_directory(str(tmp_path), transcripts)
    assert [(s.audio_path, s.text) for s in t_samples] == [(s.audio_path, s.text)
                                                          for s in j_samples]
    tds = tdata.EchoTTSDataset(t_samples, ta, ACFG, tpca, max_latent_length=24)
    jds = jdata.EchoTTSDataset(j_samples, ja, JAEConfig().tiny(), jpca, max_latent_length=24)
    for p in paths:
        assert tds.latent_cache[p].shape == jds.latent_cache[p].shape
        assert rel_l2(tds.latent_cache[p], jds.latent_cache[p]) <= 1e-4
        np.testing.assert_array_equal(tds.speaker_cache[p][1], jds.speaker_cache[p][1])
        assert rel_l2(tds.speaker_cache[p][0], jds.speaker_cache[p][0]) <= 1e-4

    tb = tdata.collate([tds[i] for i in range(3)], max_text_length=32, bucket_granularity=16)
    jb = jdata.collate([jds[i] for i in range(3)], max_text_length=32, bucket_granularity=16)
    assert tb.keys() == jb.keys()
    for k in tb:
        assert tb[k].shape == jb[k].shape and tb[k].dtype == jb[k].dtype, k
        if k in ("latent", "speaker_latent"):
            assert rel_l2(tb[k], jb[k]) <= 1e-4
        else:
            np.testing.assert_array_equal(tb[k], jb[k])
    assert tb["latent"].shape[1] % 16 == 0

    serial = tdata.EchoTTSDataset(t_samples, ta, ACFG, tpca, max_latent_length=24, io_workers=0)
    for p in paths:
        np.testing.assert_array_equal(serial.latent_cache[p], tds.latent_cache[p])

    ref = list(tdata.batches(tds, 2, np.random.default_rng(2), max_text_length=32))
    pre = list(tdata.batches_prefetch(tds, 2, np.random.default_rng(2), prefetch=2,
                                      max_text_length=32))
    jref = list(jdata.batches(jds, 2, np.random.default_rng(2), max_text_length=32))
    assert len(ref) == len(pre) == len(jref) == 1
    for a, b, c in zip(ref, pre, jref):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].shape == c[k].shape


def test_batches_prefetch_abandoned_consumer(tmp_path, ae):
    """Closing the generator early must stop the producer thread; a blocked
    put would pin batches in memory for the rest of the process."""
    _, _, ta, tpca = ae
    paths = _write_clips(tmp_path, 8, [ACFG.frame_length * 12] * 8)
    ds = tdata.EchoTTSDataset([tdata.TrainingSample(p, "[S1] t") for p in paths], ta, ACFG,
                              tpca, max_latent_length=16, io_workers=0)
    before = threading.active_count()
    gen = tdata.batches_prefetch(ds, 1, np.random.default_rng(1), prefetch=1,
                                 max_text_length=32)
    next(gen)  # the producer runs, its queue full behind us
    gen.close()
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= before


class _FakeASR:
    def __init__(self, fail_on=()):
        self.fail_on = set(fail_on)

    def __call__(self, path):
        if path in self.fail_on:
            raise RuntimeError("decode error")
        return {"text": f"hello from {path.rsplit('/', 1)[-1]}"}


def test_transcription_helpers_match_jax(tmp_path):
    paths = [str(tmp_path / f"x{i}.wav") for i in range(3)]
    seen = []

    def asr_lang(path, language=None):
        seen.append(language)
        return {"text": "hi"}

    for mod in (tdata, jdata):
        assert mod.transcribe_audio(paths[0], asr=_FakeASR()) == "[S1] hello from x0.wav"
        assert mod.transcribe_audio(paths[0], language="de", asr=asr_lang) == "[S1] hi"
        with pytest.raises(RuntimeError):
            mod.transcribe_audio_files(paths, asr=_FakeASR({paths[1]}), on_error="raise")
        mod.transcribe_audio_files_parakeet(paths[:1], language="de", asr=asr_lang)
    assert seen == ["de", None, "de", None]
    for name in ("transcribe_audio_files", "transcribe_audio_files_parakeet",
                 "transcribe_audio_files_parallel"):
        got = getattr(tdata, name)(paths, asr=_FakeASR({paths[1]}))
        assert got == getattr(jdata, name)(paths, asr=_FakeASR({paths[1]}))
        assert set(got) == {paths[0], paths[2]}
    assert tdata._tag_transcript(" [S2] x ") == jdata._tag_transcript(" [S2] x ")

    sr = 8000
    for i in range(2):
        tio.write_wav(str(tmp_path / f"s{i}.wav"), np.zeros((1, sr // 4), np.float32), sr)
    provided = {str(tmp_path / "s0.wav"): "[S1] provided"}
    got = tdata.prepare_samples_from_directory(str(tmp_path), provided,
                                               transcribe_missing=True, asr=_FakeASR())
    ref = jdata.prepare_samples_from_directory(str(tmp_path), provided,
                                               transcribe_missing=True, asr=_FakeASR())
    assert [(s.audio_path, s.text) for s in got] == [(s.audio_path, s.text) for s in ref]
