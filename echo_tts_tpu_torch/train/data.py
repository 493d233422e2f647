"""Training data pipeline (counterpart of echo_tts_tpu/train/data.py).

Latents are pre-encoded once through the port's S1-DAC encoder and PCA (on
the card: kernel K2) and cached on the host; batches are zero-padded numpy
with boolean masks, lengths rounded up to shape buckets. A producer thread
can collate the next batches while the card runs the current step. The ASR
helpers are host code with an injectable `asr` callable.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from echo_tts_tpu_torch.core.config import AEConfig
from echo_tts_tpu_torch.models.pca import PCAState
from echo_tts_tpu_torch.pipeline.audio_io import load_audio
from echo_tts_tpu_torch.pipeline.speaker import ae_encode, get_speaker_latent_and_mask
from echo_tts_tpu_torch.pipeline.tokenizer import get_text_input_ids_and_mask
from echo_tts_tpu_torch.utils.queues import drain, put_until_abandoned


@dataclasses.dataclass
class TrainingSample:
    audio_path: str
    text: str
    speaker_audio_path: Optional[str] = None  # None -> the same file is the speaker prompt


class EchoTTSDataset:
    """Pre-encoding dataset: target audio -> 80-d latents; the speaker
    prompt is the first `speaker_max_duration` seconds of the (same) file.
    Encodes on the PCA state's device."""

    def __init__(
        self,
        samples: List[TrainingSample],
        ae_params: dict,
        ae_cfg: AEConfig,
        pca: PCAState,
        max_latent_length: Optional[int] = None,
        speaker_max_duration: float = 30.0,
        io_workers: int = 2,
    ):
        """io_workers > 0 decodes audio on a thread pool, with a bounded
        in-flight window, while this thread feeds the encoder; 0 = serial.
        Both give the same caches."""
        self.samples = samples
        self.max_latent_length = max_latent_length
        self.latent_cache: Dict[str, np.ndarray] = {}
        self.speaker_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

        # distinct decode jobs, in deterministic first-appearance order
        lat_paths, spk_paths = [], []
        for s in samples:
            if s.audio_path not in self.latent_cache:
                self.latent_cache[s.audio_path] = None
                lat_paths.append(s.audio_path)
            sp = s.speaker_audio_path or s.audio_path
            if sp not in self.speaker_cache:
                self.speaker_cache[sp] = None
                spk_paths.append(sp)

        jobs = ([("lat", p, lambda p=p: load_audio(p)) for p in lat_paths]
                + [("spk", p, lambda p=p: load_audio(
                    p, max_duration=speaker_max_duration)) for p in spk_paths])
        device = pca.components.device

        def encode(kind, path, audio):
            if kind == "lat":
                if max_latent_length is not None:
                    audio = audio[:, : max_latent_length * ae_cfg.frame_length]
                x = torch.as_tensor(audio[None], dtype=torch.float32, device=device)
                lat = ae_encode(ae_params, ae_cfg, pca, x).cpu().numpy()
                if max_latent_length is not None:
                    lat = lat[:, :max_latent_length]
                self.latent_cache[path] = lat[0]
            else:
                slat, smask = get_speaker_latent_and_mask(ae_params, ae_cfg, pca, audio)
                self.speaker_cache[path] = (slat[0], smask[0])

        if io_workers <= 0:
            for kind, path, decode in jobs:
                encode(kind, path, decode())
        else:
            window = 2 * io_workers  # bounded in-flight decodes (memory cap)
            with ThreadPoolExecutor(io_workers) as ex:
                pending = []
                for kind, path, decode in jobs:
                    pending.append((kind, path, ex.submit(decode)))
                    if len(pending) >= window:
                        k, p, fut = pending.pop(0)
                        encode(k, p, fut.result())
                for k, p, fut in pending:
                    encode(k, p, fut.result())

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        s = self.samples[idx]
        sp = s.speaker_audio_path or s.audio_path
        slat, smask = self.speaker_cache[sp]
        return {"latent": self.latent_cache[s.audio_path], "text": s.text,
                "speaker_latent": slat, "speaker_mask": smask}


def _bucket(n: int, granularity: int = 64) -> int:
    return max(granularity, -(-n // granularity) * granularity)


def collate(items: List[dict], max_text_length: int = 768,
            bucket_granularity: int = 64) -> Dict[str, np.ndarray]:
    """Zero-pad and mask, with lengths rounded up to the bucket granularity."""
    d = items[0]["latent"].shape[-1]
    t_max = _bucket(max(i["latent"].shape[0] for i in items), bucket_granularity)
    s_max = _bucket(max(i["speaker_latent"].shape[0] for i in items), bucket_granularity)
    n = len(items)

    latents = np.zeros((n, t_max, d), np.float32)
    latent_mask = np.zeros((n, t_max), bool)
    spk = np.zeros((n, s_max, d), np.float32)
    spk_mask = np.zeros((n, s_max), bool)
    for i, it in enumerate(items):
        tl = it["latent"].shape[0]
        latents[i, :tl] = it["latent"]
        latent_mask[i, :tl] = True
        sl = it["speaker_latent"].shape[0]
        spk[i, :sl] = it["speaker_latent"]
        spk_mask[i, :sl] = it["speaker_mask"]

    ids, text_mask, _ = get_text_input_ids_and_mask(
        [it["text"] for it in items], max_length=max_text_length, normalize=False)

    return {"latent": latents, "latent_mask": latent_mask,
            "text_input_ids": ids, "text_mask": text_mask,
            "speaker_latent": spk, "speaker_mask": spk_mask}


def batches(dataset: EchoTTSDataset, batch_size: int, rng: np.random.Generator,
            **collate_kw):
    """Shuffled epoch iterator (a last partial batch is dropped)."""
    order = rng.permutation(len(dataset))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        yield collate([dataset[j] for j in order[i: i + batch_size]], **collate_kw)


def batches_prefetch(dataset: EchoTTSDataset, batch_size: int,
                     rng: np.random.Generator, prefetch: int = 2, **collate_kw):
    """`batches` with a producer thread that collates the next `prefetch`
    batches while the card runs the current step; the same batch sequence
    as `batches` for the same rng state. Closing the generator early stops
    the producer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    end = object()
    stop = threading.Event()

    def produce():
        try:
            for b in batches(dataset, batch_size, rng, **collate_kw):
                if not put_until_abandoned(q, b, stop):
                    return
            put_until_abandoned(q, end, stop)
        except BaseException as e:  # handed to the consumer, which raises it
            put_until_abandoned(q, e, stop)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        drain(q)  # unblock a producer mid-put
        t.join(timeout=5)


AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".ogg", ".m4a")


def prepare_samples_from_directory(
    audio_dir: str,
    transcriptions: Optional[Dict[str, str]] = None,
    extensions: Tuple[str, ...] = AUDIO_EXTENSIONS,
    transcribe_missing: bool = False,
    asr=None,
) -> List[TrainingSample]:
    """Scan a directory for audio and attach transcriptions. With
    `transcribe_missing`, files without a provided transcription are run
    through ASR (opt-in, for machines without the ASR weights)."""
    files: List[Path] = []
    for ext in extensions:
        files.extend(Path(audio_dir).glob(f"*{ext}"))
        files.extend(Path(audio_dir).glob(f"*{ext.upper()}"))
    paths = sorted(str(p) for p in set(files))
    texts = dict(transcriptions or {})
    if transcribe_missing:
        missing = [p for p in paths if p not in texts]
        if missing:
            texts.update(transcribe_audio_files(missing, asr=asr))
    return [TrainingSample(audio_path=p, text=texts[p])
            for p in paths if texts.get(p)]


def _tag_transcript(text: str) -> str:
    """Prepend the `[S1]` speaker tag the tokenizer expects (reference:
    train_utils.py:609-612; mirrors the tokenizer auto-tag rule)."""
    text = text.strip()
    if text and not text.startswith("[") and "S1" not in text:
        text = "[S1] " + text
    return text


def _default_asr(model_name: str):
    """Build a transformers ASR pipeline (zero-egress environments need the
    weights pre-downloaded)."""
    from transformers import pipeline as hf_pipeline  # pragma: no cover

    return hf_pipeline("automatic-speech-recognition", model=model_name)  # pragma: no cover


def _call_asr(asr, path: str, language: Optional[str]) -> str:
    """Invoke an ASR callable, forwarding `language` only when it is accepted
    (the reference passes it to whisper's transcribe, train_utils.py:572;
    Parakeet ignores it, train_utils.py:642). Injected test/offline callables
    that only take a path keep working."""
    if language is not None:
        try:
            import inspect

            sig = inspect.signature(asr)
            accepts = ("language" in sig.parameters
                       or any(p.kind == inspect.Parameter.VAR_KEYWORD
                              for p in sig.parameters.values()))
        except (TypeError, ValueError):  # builtins / C callables
            accepts = False
        if accepts:
            return asr(path, language=language)["text"]
    return asr(path)["text"]


def transcribe_audio(audio_path: str, model_name: str = "openai/whisper-base",
                     language: Optional[str] = "en", asr=None) -> str:
    """Single-file Whisper transcription (reference: train_utils.py:550-580).
    `asr` is an injectable callable path -> {"text": ...} for tests/offline;
    `language` is forwarded when the callable accepts it."""
    asr = asr or _default_asr(model_name)
    return _tag_transcript(_call_asr(asr, audio_path, language))


def transcribe_audio_files(audio_paths: List[str], model_name: str = "openai/whisper-base",
                           language: Optional[str] = "en", asr=None,
                           on_error: str = "collect",
                           progress_every: int = 0) -> Dict[str, str]:
    """Batch ASR (reference: train_utils.py:582-620). Per-file errors are
    collected and skipped (`on_error="collect"`, the reference behavior at
    train_utils.py:715-733) or re-raised (`on_error="raise"`).
    `progress_every` > 0 logs progress every N files."""
    import logging

    log_ = logging.getLogger("echo_tts_tpu_torch.train")
    asr = asr or _default_asr(model_name)
    out: Dict[str, str] = {}
    errors: Dict[str, str] = {}
    for i, p in enumerate(audio_paths):
        try:
            text = _tag_transcript(_call_asr(asr, p, language))
            if text:
                out[p] = text
        except Exception as e:
            if on_error == "raise":
                raise
            errors[p] = str(e)
        if progress_every > 0 and ((i + 1) % progress_every == 0
                                   or i + 1 == len(audio_paths)):
            log_.info("transcribed %d/%d files", i + 1, len(audio_paths))
    if errors:
        log_.warning(
            "transcription failed for %d file(s): %s", len(errors),
            ", ".join(sorted(errors)))
    return out


def transcribe_audio_files_parakeet(audio_paths: List[str],
                                    model_name: str = "nvidia/parakeet-ctc-1.1b",
                                    language: Optional[str] = None,
                                    batch_size: int = 8,
                                    asr=None) -> Dict[str, str]:
    """Parakeet variant (reference: train_utils.py:625-734) — same
    transformers pipeline surface, different default checkpoint. Mirroring
    the reference: `language` is ignored (Parakeet auto-detects,
    train_utils.py:642) and `batch_size` is the progress-update cadence
    (train_utils.py:643, 724-725), not a device batch."""
    return transcribe_audio_files(audio_paths, model_name=model_name,
                                  language=None, asr=asr,
                                  progress_every=batch_size)


def transcribe_audio_files_parallel(audio_paths: List[str],
                                    model_name: str = "openai/whisper-base",
                                    language: Optional[str] = "en",
                                    asr=None, num_workers: int = 4) -> Dict[str, str]:
    """Thread-parallel batch ASR (reference: train_utils.py:786-803). ASR
    decode is host-side and IO/compute-mixed; threads overlap file decode with
    model calls."""
    from concurrent.futures import ThreadPoolExecutor

    asr = asr or _default_asr(model_name)
    out: Dict[str, str] = {}

    def one(p):
        try:
            return p, _tag_transcript(_call_asr(asr, p, language))
        except Exception as e:
            import logging

            logging.getLogger("echo_tts_tpu_torch.train").warning(
                "transcription failed for %s: %s", p, e)
            return p, ""

    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        for p, text in ex.map(one, audio_paths):
            if text:
                out[p] = text
    return out
