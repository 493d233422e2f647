"""The port's native host codecs (echo_tts_tpu_torch/native) and the rest of
its S1-DAC API against the JAX package's.

* the upfirdn resampler bit for bit equal to the JAX package's
  `resample_native` (the same source, the same g++ flags) and within 1e-5
  of scipy at the four rate pairs of tests/test_native.py; the mono mix
  within 1e-6; the scipy route where the library cannot be built;
* MP3 decode bit for bit equal to the JAX package's on the same file, the
  encode round trip and `load_audio` on an .mp3, skipped only where the JAX
  tests skip, when libmpg123/libmp3lame are absent;
* vq_decode_latents, rvq_from_latents, decode_codes, get_output_length and
  get_delay against JAX in fp32: codes exactly, z_q and audio at the port's
  AE tolerance (atol 2e-5 / rtol 1e-4, tests/test_torch_s1dac.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echo_tts_tpu.bench.init_ae import init_ae_params as j_init_ae
from echo_tts_tpu.core import config as jc
from echo_tts_tpu.models import s1dac as js
from echo_tts_tpu.native import mp3_py as jmp3
from echo_tts_tpu.native import resample_py as jres
from echo_tts_tpu_torch.checkpoints.from_jax import ae_params_from_numpy
from echo_tts_tpu_torch.core import config as tc
from echo_tts_tpu_torch.models import s1dac as ts
from echo_tts_tpu_torch.native import mp3_py as tmp3
from echo_tts_tpu_torch.native import resample_py as tres
from echo_tts_tpu_torch.pipeline import audio_io

from torch_parity import assert_close, np_tree, t

AE_TOL = dict(atol=2e-5, rtol=1e-4)


def _mp3_libs():
    if not (tmp3.mp3_available() and tmp3.mp3_encode_available()):
        pytest.skip("system libmpg123/libmp3lame not present")


@pytest.mark.parametrize("pair", [(22050, 44100), (16000, 44100), (48000, 44100),
                                  (44100, 16000)])
def test_resample_bit_equal_to_jax_and_near_scipy(pair):
    from scipy.signal import resample_poly

    sf, st = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    mine = tres.resample_native(x, sf, st)
    assert mine.dtype == np.float32 and np.array_equal(mine, jres.resample_native(x, sf, st))
    g = np.gcd(sf, st)
    ref = resample_poly(x.astype(np.float64), st // g, sf // g, axis=-1, window=("kaiser", 5.0))
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, atol=1e-5)
    np.testing.assert_array_equal(audio_io.resample(x, sf, st), mine)


def test_upfirdn_and_mono_mix():
    from scipy.signal import upfirdn

    rng = np.random.default_rng(0)
    x = rng.standard_normal(3000).astype(np.float32)
    h = tres._design_filter(3, 2)
    assert np.array_equal(h, jres._design_filter(3, 2))
    mine = tres.upfirdn_native(x, h, 3, 2)
    ref = upfirdn(h.astype(np.float64), x.astype(np.float64), 3, 2)
    np.testing.assert_allclose(mine, ref[:len(mine)], atol=1e-6)
    a = rng.standard_normal((2, 500)).astype(np.float32) * 3.0
    out = tres.mono_mix_normalize_native(a)
    ref = a.mean(axis=0, keepdims=True)
    np.testing.assert_allclose(out, ref / max(np.abs(ref).max(), 1.0), atol=1e-6)
    assert np.array_equal(out, jres.mono_mix_normalize_native(a))


def test_resample_uses_scipy_when_the_library_cannot_be_built(monkeypatch):
    """A failed build raises inside the native route; audio_io.resample then
    gives scipy's answer."""
    from scipy.signal import resample_poly

    from echo_tts_tpu_torch.native import resample_py

    def no_build():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(resample_py, "load", no_build)
    x = np.random.default_rng(2).standard_normal((1, 999)).astype(np.float32)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        resample_py.resample_native(x, 48000, 44100)
    ref = resample_poly(x, 147, 160, axis=-1, window=("kaiser", 5.0)).astype(np.float32)
    np.testing.assert_array_equal(audio_io.resample(x, 48000, 44100), ref)


def _tone(seconds=1.0, sr=44100, stereo=False):
    tt = np.arange(int(sr * seconds)) / sr
    x = [0.5 * np.sin(2 * np.pi * 440 * tt)]
    if stereo:
        x.append(0.4 * np.sin(2 * np.pi * 550 * tt))
    return np.stack(x).astype(np.float32)


@pytest.mark.parametrize("stereo", [False, True])
def test_mp3_decode_bit_equal_to_jax(tmp_path, stereo):
    """One file, encoded by the JAX package's encoder: the port decodes the
    same samples at the same rate, whole and capped at 0.5 s; the port's
    encoder writes the JAX encoder's bytes."""
    _mp3_libs()
    x = _tone(1.5, stereo=stereo)
    path, mine_path = str(tmp_path / "a.mp3"), str(tmp_path / "b.mp3")
    assert jmp3.encode_mp3(path, x, 44100) and tmp3.encode_mp3(mine_path, x, 44100)
    assert open(path, "rb").read() == open(mine_path, "rb").read()
    for cap in (None, 0.5):
        got, sr = tmp3.decode_mp3(path, max_duration=cap)
        ref, sr_ref = jmp3.decode_mp3(path, max_duration=cap)
        assert sr == sr_ref == 44100 and got.dtype == np.float32
        assert np.array_equal(got, ref)
    assert tmp3.decode_mp3(path, max_duration=0.5)[0].shape == (x.shape[0], 22050)


def test_mp3_round_trip_and_load_audio(tmp_path):
    """Encode a tone, decode it: the waveform survives (correlation > 0.99
    after aligning out the codec delay); load_audio decodes the .mp3 to the
    mono 44.1 kHz float32 the JAX load_audio gives, bit for bit."""
    _mp3_libs()
    from echo_tts_tpu.pipeline import audio_io as jaudio

    x = _tone()
    path = str(tmp_path / "tone.mp3")
    assert tmp3.encode_mp3(path, x, 44100)
    y, sr = tmp3.decode_mp3(path)
    assert sr == 44100 and y.shape[0] == 1
    lag = int(np.argmax(np.correlate(y[0][:4000], x[0][:2000], "valid")))
    n = min(x.shape[1], y.shape[1] - lag) - 1000
    assert np.corrcoef(x[0][:n], y[0][lag:lag + n])[0, 1] > 0.99
    au = audio_io.load_audio(path)
    assert au.shape[0] == 1 and au.dtype == np.float32 and np.abs(au).max() <= 1.0
    assert np.array_equal(au, jaudio.load_audio(path))
    stereo = str(tmp_path / "s.mp3")
    assert tmp3.encode_mp3(stereo, _tone(1.0, 22050, stereo=True), 22050)
    np.testing.assert_array_equal(audio_io.load_audio(stereo), jaudio.load_audio(stereo))


def test_mp3_missing_library_falls_back(monkeypatch, tmp_path):
    """Without libmpg123 decode_mp3 returns None and load_audio goes to
    ffmpeg (absent here: a clear error); without libmp3lame encode_mp3
    returns False."""
    monkeypatch.setattr(tmp3, "_load_mpg123", lambda: None)
    monkeypatch.setattr(tmp3, "_load_lame", lambda: None)
    assert tmp3.decode_mp3(str(tmp_path / "x.mp3")) is None
    assert tmp3.encode_mp3(str(tmp_path / "x.mp3"), _tone()) is False
    assert not tmp3.mp3_available() and not tmp3.mp3_encode_available()
    monkeypatch.setattr(audio_io.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        audio_io.load_audio(str(tmp_path / "x.mp3"))


@pytest.fixture(scope="module")
def ae():
    jcfg = jc.AEConfig().tiny()
    jp = jax.jit(lambda k: j_init_ae(k, jcfg, dtype=jnp.float32))(jax.random.PRNGKey(3))
    cfg = tc.AEConfig().tiny()
    return jp, jcfg, ae_params_from_numpy(np_tree(jp), cfg, device="cpu"), cfg


def test_vq_decode_latents_and_rvq_from_latents(ae):
    """Codes equal JAX's exactly; z_p and z_q within the AE tolerance, with
    trailing channels that fill no whole codebook ignored."""
    jp, _, tp, _ = ae
    rng = np.random.default_rng(4)
    jq, tq = jp["quantizer"]["residual"], tp["quantizer"]["residual"]
    dc = tq[0]["codebook"].shape[1]
    z = rng.standard_normal((2, dc, 7)).astype(np.float32)
    zp_j, idx_j = js.vq_decode_latents(jnp.asarray(z), jq[0])
    zp_t, idx_t = ts.vq_decode_latents(t(z), tq[0])
    assert idx_t.dtype == torch.int32 and np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert_close(zp_t, zp_j, **AE_TOL)
    lat = rng.standard_normal((2, dc * len(tq) + 1, 7)).astype(np.float32)
    ref = js.rvq_from_latents(jnp.asarray(lat), jq)
    got = ts.rvq_from_latents(t(lat), tq)
    assert np.array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[1].shape == (2, dc * len(tq), 7)
    for g_, r_ in zip(got[:2], ref[:2]):
        assert_close(g_, r_, **AE_TOL)


def test_decode_codes(ae):
    """decode_codes of the codes of a short signal against JAX's: the same
    codes in, audio at the AE tolerance, equal to decode_zq(codes_to_zq)."""
    jp, jcfg, tp, cfg = ae
    rng = np.random.default_rng(5)
    audio = (0.1 * rng.standard_normal((1, 1, 4 * cfg.frame_length))).astype(np.float32)
    codes_j = js.encode_codes(jp, jcfg, jnp.asarray(audio))
    with torch.no_grad():
        codes_t = ts.encode_codes(tp, cfg, t(audio))
        assert np.array_equal(codes_t.numpy(), np.asarray(codes_j))
        got = ts.decode_codes(tp, cfg, codes_t)
        assert torch.equal(got, ts.decode_zq(tp, cfg, ts.codes_to_zq(tp, cfg, codes_t)))
    assert_close(got, js.decode_codes(jp, jcfg, codes_j), **AE_TOL)


@pytest.mark.parametrize("tiny", [False, True])
def test_get_delay_and_output_length(tiny):
    jcfg, cfg = jc.AEConfig(), tc.AEConfig()
    if tiny:
        jcfg, cfg = jcfg.tiny(), cfg.tiny()
    assert ts.get_delay(cfg) == js.get_delay(jcfg)
    for n in (0, 1, 511, 512, 44100, 1323000):
        assert ts.get_output_length(cfg, n) == js.get_output_length(jcfg, n)
