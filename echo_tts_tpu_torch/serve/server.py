"""HTTP TTS server on the standard library (counterpart of
echo_tts_tpu/serve/server.py): the same endpoints over one `Engine`.

  GET  /health        engine stats
  GET  /presets       the sampler presets
  GET  /text_presets  [[category, word_count, text], ...] from text_presets.txt
  POST /lora          {"path": ..., "strength": ...}; a null path reverts to base
  POST /reconstruct   {"wav_b64": ... or "path": ...} -> audio/wav, the AE round
                      trip of the first 30 s
  POST /tts           {"text": ..., "preset": name or sampler fields, "seed": int,
                       "speaker_wav_b64": base64 WAV or MP3 bytes (optional),
                       "speaker_path": a path on the server (optional),
                       "format": "wav" (default) or "mp3"} -> audio/wav (16-bit
                      PCM), or audio/mpeg for "mp3" (libmp3lame, 192 kb/s; WAV
                      where the library is missing, as the JAX server does).
  POST /tts_stream    the /tts body plus "block_size" (default [64, 192]: an int,
                      or a list whose last entry repeats) and an optional
                      "continuation_wav_b64" / "continuation_path" (audio to go on
                      from; its transcript belongs in "text") -> chunked
                      audio/L16 (raw mono PCM16, X-Sample-Rate header), one chunk
                      a decoded latent block; it stops at the flattening point.

MP3 input is decoded by `pipeline/audio_io.py:load_audio` (libmpg123).
"""
from __future__ import annotations

import base64
import json
import logging
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from echo_tts_tpu_torch.core.config import SamplerConfig
from echo_tts_tpu_torch.pipeline.audio_io import load_audio, write_wav
from echo_tts_tpu_torch.serve.engine import Engine
from echo_tts_tpu_torch.serve.presets import DEFAULT_SAMPLER_PRESETS, load_text_presets

log = logging.getLogger("echo_tts_tpu_torch.serve")


def _load_request_audio(req: dict, b64_key: str, path_key: str):
    """Audio given as base64 bytes (WAV or MP3, told apart by the magic
    bytes) or as a path on the server; None when neither key is there."""
    if req.get(b64_key):
        raw = base64.b64decode(req[b64_key])
        suffix = ".wav" if raw[:4] == b"RIFF" else ".mp3"
        with tempfile.NamedTemporaryFile(suffix=suffix) as f:
            f.write(raw)
            f.flush()
            return load_audio(f.name)
    if req.get(path_key):
        return load_audio(req[path_key])
    return None


def wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    """audio (channels, samples) as the bytes of a 16-bit PCM WAV file
    (`write_wav`): what /tts and /reconstruct send."""
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        path = f.name
    try:
        write_wav(path, audio, sr)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


def mp3_bytes(audio: np.ndarray, sr: int, bitrate_kbps: int = 192) -> Optional[bytes]:
    """audio (channels, samples) as MP3 bytes (libmp3lame) of the samples
    the WAV holds, clipped to [-1, 1] (the encoder takes that range; beyond
    it, its own clipping would differ from the WAV's); None when the library
    is missing or the encode fails (the caller sends WAV)."""
    from echo_tts_tpu_torch.native.mp3_py import encode_mp3

    with tempfile.NamedTemporaryFile(suffix=".mp3", delete=False) as f:
        path = f.name
    try:
        if not encode_mp3(path, np.clip(audio, -1.0, 1.0), sr, bitrate_kbps):
            return None
        with open(path, "rb") as f:
            return f.read()
    except Exception as e:
        log.warning("mp3 encode failed, sending WAV: %s", e)
        return None
    finally:
        os.unlink(path)


def pcm16_bytes(chunk: np.ndarray) -> bytes:
    """A (1, 1, n) chunk as /tts_stream sends it: little-endian PCM16."""
    return np.clip(chunk[0, 0] * 32767.0, -32768, 32767).astype("<i2").tobytes()


def make_handler(engine: Engine, presets: Dict[str, SamplerConfig],
                 text_presets_path: str = "text_presets.txt"):
    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (/tts_stream) needs HTTP/1.1; every other
        # response carries a Content-Length, so keep-alive is safe
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _wav(self, body: bytes, headers=(), ctype: str = "audio/wav") -> None:
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, engine.health())
            elif self.path == "/presets":
                self._json(200, {k: dict(v.__dict__) if isinstance(v, SamplerConfig) else v
                                 for k, v in presets.items()})
            elif self.path == "/text_presets":
                self._json(200, load_text_presets(text_presets_path))
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._json(400, {"error": "bad json"})

            if self.path == "/lora":
                try:
                    engine.set_lora(req.get("path"), float(req.get("strength", 1.0)))
                    return self._json(200, {"ok": True})
                except Exception as e:
                    return self._json(400, {"error": str(e)})

            if self.path == "/reconstruct":
                try:
                    audio = _load_request_audio(req, "wav_b64", "path")
                    if audio is None:
                        return self._json(400, {"error": "wav_b64 or path required"})
                    rec = engine.reconstruct(audio)
                    self._wav(wav_bytes(rec[0], engine.tts.ae_cfg.sample_rate))
                except Exception as e:
                    self._json(500, {"error": str(e)})
                return

            if self.path not in ("/tts", "/tts_stream"):
                return self._json(404, {"error": "not found"})

            try:
                text = req["text"]
                seed = int(req.get("seed", 0))
                if "preset" in req:
                    sc = presets[req["preset"]]
                    if not isinstance(sc, SamplerConfig):
                        sc = SamplerConfig.from_preset(sc)
                else:
                    fields = {k: v for k, v in req.items()
                              if k in SamplerConfig.__dataclass_fields__}
                    sc = SamplerConfig.from_preset(fields) if fields else SamplerConfig()
                speaker = _load_request_audio(req, "speaker_wav_b64", "speaker_path")
                normalize = bool(req.get("normalize_text", True))

                if self.path == "/tts_stream":
                    # raw PCM16 in chunks: the length is not known up front (the
                    # stream stops at the flattening point). The first chunk is
                    # pulled before the 200 goes out, so a setup error still gets
                    # a JSON error; after the headers the only safe failure is
                    # closing the connection
                    continuation = _load_request_audio(req, "continuation_wav_b64",
                                                       "continuation_path")
                    bs = req.get("block_size", [64, 192])
                    bs = [int(x) for x in bs] if isinstance(bs, list) else int(bs)
                    gen = engine.generate_stream(text, speaker, seed=seed, sc=sc, block_size=bs,
                                                 normalize_text=normalize,
                                                 continuation_audio=continuation)
                    first = next(gen, None)
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/L16")
                    self.send_header("X-Sample-Rate", str(engine.tts.ae_cfg.sample_rate))
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def emit(chunk):
                        pcm = pcm16_bytes(chunk)
                        if pcm:
                            self.wfile.write(f"{len(pcm):X}\r\n".encode())
                            self.wfile.write(pcm)
                            self.wfile.write(b"\r\n")

                    try:
                        if first is not None:
                            emit(first)
                        for chunk in gen:
                            emit(chunk)
                        self.wfile.write(b"0\r\n\r\n")
                    except Exception as e:  # mid-stream: abort, never a second status
                        self.close_connection = True
                        log.warning("tts_stream aborted mid-stream: %s", e)
                    finally:
                        gen.close()
                    return

                audio, normalized, timings = engine.generate(text, speaker, seed=seed, sc=sc,
                                                             normalize_text=normalize)
                sr = engine.tts.ae_cfg.sample_rate
                body = mp3_bytes(audio[0], sr) if req.get("format") == "mp3" else None
                ctype = "audio/mpeg" if body is not None else "audio/wav"
                self._wav(body if body is not None else wav_bytes(audio[0], sr), [
                    ("X-Normalized-Text", base64.b64encode(normalized.encode()).decode()),
                    ("X-Timings", json.dumps({k: round(v, 4) for k, v in timings.items()}))],
                    ctype)
            except Exception as e:
                self._json(500, {"error": str(e)})

    return Handler


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer whose request threads carry a name."""

    daemon_threads = True

    def process_request(self, request, client_address):
        threading.Thread(target=self.process_request_thread, args=(request, client_address),
                         daemon=True, name="echo-tts-http-request").start()


def serve(engine: Engine, host: str = "127.0.0.1", port: int = 7860,
          presets: Optional[Dict[str, SamplerConfig]] = None, background: bool = False,
          text_presets_path: str = "text_presets.txt") -> ThreadingHTTPServer:
    """Serve `engine` on host:port (0: a free port, `server_address` says
    which). background=True returns the started server at once, running on
    a thread `echo-tts-http`; stop it with shutdown() and server_close()."""
    presets = presets or {k: SamplerConfig.from_preset(v)
                          for k, v in DEFAULT_SAMPLER_PRESETS.items()}
    httpd = _Server((host, port), make_handler(engine, presets, text_presets_path))
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True, name="echo-tts-http").start()
        return httpd
    httpd.serve_forever()
    return httpd
