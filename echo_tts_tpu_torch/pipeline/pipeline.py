"""Sampling pipelines (counterpart of echo_tts_tpu/pipeline/pipeline.py).

One-shot (`sample_pipeline`): text -> ids/mask (cap 768) -> speaker audio ->
chunked latents/mask -> Euler sampler -> PCA deproject + S1-DAC decode ->
flattening-point crop.

Streaming (`sample_pipeline_stream`): the same inputs, then block by block
the blockwise sampler (`sampling/blockwise.py`, latent-prefix KV appended
after each block), PCA deproject and the stateful S1-DAC decode step of
just that block; each block's audio is yielded as soon as it is decoded,
held back by one flattening-detector window.

Batching (`sample_pipeline_batch`, `sample_pipeline_stream_batch`): N
requests, each prepared as the solo path prepares it (its own tokenize,
speaker encode and seed), padded to the largest text and speaker bucket of
the batch and run as one batch of N rows: the batch lies in each kernel's
grid and in each GEMM's rows, so N rows cost one request's launches. The
continuous group (`init_stream_group`, `_stream_step_rows`, `_join_row`,
`_join_row_first_block`, `_resize_group`) holds N streams at their own
positions in one device-resident state; rows join and retire at block
boundaries.

Text and speaker lengths are padded to the configured shape buckets, as in
the JAX package, so both packages see the same shapes. Runs on the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig, PipelineConfig, SamplerConfig
from echo_tts_tpu_torch.core.device import resolve_device
from echo_tts_tpu_torch.core.rope import row_slots
from echo_tts_tpu_torch.models import pca as pca_mod
from echo_tts_tpu_torch.models import s1dac
from echo_tts_tpu_torch.models.dit import (
    extend_latent_kv,
    get_kv_cache_speaker,
    get_kv_cache_text,
    init_latent_kv_state,
)
from echo_tts_tpu_torch.pipeline import flattening
from echo_tts_tpu_torch.pipeline import tokenizer as tok
from echo_tts_tpu_torch.pipeline.flattening import crop_audio_to_flattening_point
from echo_tts_tpu_torch.pipeline.speaker import (
    ae_decode,
    find_min_bucket_gte,
    get_speaker_latent_and_mask,
)
from echo_tts_tpu_torch.sampling.blockwise import check_patch_aligned as _check_patch_aligned
from echo_tts_tpu_torch.sampling.blockwise import sample_block_core
from echo_tts_tpu_torch.sampling.euler_cfg import (
    draw_noise,
    sample_euler_cfg_independent_guidances,
)


@dataclasses.dataclass
class EchoTTS:
    """The three weight sets plus configs, on one device (default cuda;
    raises when CUDA is absent and the CPU was not asked for, and when the
    PCA state or any DiT/AE weight lies on another device)."""

    dit_params: dict
    dit_cfg: DiTConfig
    ae_params: dict
    ae_cfg: AEConfig
    pca: pca_mod.PCAState
    model_dtype: torch.dtype = torch.bfloat16
    pipe_cfg: PipelineConfig = PipelineConfig()
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        want = self.device
        if want.type == "cuda" and want.index is None:
            want = torch.device("cuda", torch.cuda.current_device())
        named = [("pca.components", self.pca.components), ("pca.mean", self.pca.mean)]
        named += _named_leaves("dit_params", self.dit_params)
        named += _named_leaves("ae_params", self.ae_params)
        for name, leaf in named:
            if leaf.device != want:
                raise ValueError(f"{name} is on {leaf.device}, but this EchoTTS runs on "
                                 f"{want}: build every weight set on the same device")


def _named_leaves(prefix: str, tree):
    """(dotted name, tensor) for every tensor leaf of nested dicts/lists."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named_leaves(f"{prefix}.{k}", v)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _named_leaves(f"{prefix}.{i}", v)]
    return [(prefix, tree)] if isinstance(tree, torch.Tensor) else []


@torch.no_grad()
def _sample_and_decode(dit_params, dit_cfg, sc, ae_params, ae_cfg, pca,
                       speaker_latent, speaker_mask, ids, text_mask, noise,
                       model_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampler + PCA deproject + S1-DAC decode. Returns (latents fp32,
    audio fp32)."""
    latents = sample_euler_cfg_independent_guidances(
        dit_params, dit_cfg, sc, speaker_latent, speaker_mask, ids, text_mask,
        noise, model_dtype=model_dtype)
    z_q = pca_mod.deproject(pca, latents).to(s1dac.params_dtype(ae_params))
    audio = s1dac.decode_zq(ae_params, ae_cfg, z_q)
    return latents, audio.float()


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    if arr.shape[1] >= n:
        return arr[:, :n]
    pad = [(0, 0)] * arr.ndim
    pad[1] = (0, n - arr.shape[1])
    return np.pad(arr, pad)


def _prepare_inputs(tts: EchoTTS, text_prompt: str, speaker_audio: Optional[np.ndarray],
                    normalize_text: bool, pad_to_max_text_length: Optional[int],
                    pad_to_max_speaker_latent_length: Optional[int], use_buckets: bool,
                    speaker_cache=None):
    """Text/speaker preprocessing on the host. The no-speaker fallback is a
    zero (1, 4, 80) latent with an all-false mask (one speaker patch).

    speaker_cache: an optional mapping {key: (latent, mask)} (`get` and item
    assignment) consulted before the chunked AE encode, so that a repeated
    prompt skips the encoder. The key is the audio's shape, the sha1 of its
    bytes, the pad policy and the two settings of the encode
    (`pc.max_speaker_latent_length`, `pc.audio_chunk_latents`), so a hit is
    exactly the encode it replaces, also across per-request PipelineConfig
    overrides (the JAX package's key leaves the two settings out); a hit
    sets timings["speaker_encode_cache_hit"]. Eviction is the caller's
    (serve.Engine keeps an LRU)."""
    pc = tts.pipe_cfg
    timings = {}

    t0 = time.perf_counter()
    max_text = min(pad_to_max_text_length or pc.max_text_length, pc.max_text_length)
    ids, text_mask, normalized = tok.get_text_input_ids_and_mask(
        [text_prompt], max_length=max_text, normalize=normalize_text)
    if pad_to_max_text_length is None and use_buckets:
        bucket = find_min_bucket_gte(pc.text_buckets, int(text_mask.sum()))
        ids = _pad_to(ids, bucket)
        text_mask = _pad_to(text_mask, bucket)
    timings["tokenize"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if speaker_audio is None:
        n = pad_to_max_speaker_latent_length or 4
        speaker_latent = np.zeros((1, n, tts.dit_cfg.latent_size), np.float32)
        speaker_mask = np.zeros((1, n), bool)
    else:
        cache_key = cached = None
        if speaker_cache is not None:
            arr = np.ascontiguousarray(np.asarray(speaker_audio))
            cache_key = (arr.shape, hashlib.sha1(arr.tobytes()).hexdigest(),
                         pad_to_max_speaker_latent_length, pc.max_speaker_latent_length,
                         pc.audio_chunk_latents)
            cached = speaker_cache.get(cache_key)
        if cached is not None:
            speaker_latent, speaker_mask = cached
            timings["speaker_encode_cache_hit"] = 1.0
        else:
            speaker_latent, speaker_mask = get_speaker_latent_and_mask(
                tts.ae_params, tts.ae_cfg, tts.pca, speaker_audio,
                max_speaker_latent_length=(pad_to_max_speaker_latent_length
                                           or pc.max_speaker_latent_length),
                audio_chunk_latents=pc.audio_chunk_latents,
                pad_to_max=pad_to_max_speaker_latent_length is not None)
            if cache_key is not None:
                speaker_cache[cache_key] = (speaker_latent, speaker_mask)
        if pad_to_max_speaker_latent_length is None and use_buckets:
            bucket = find_min_bucket_gte(pc.speaker_buckets, speaker_latent.shape[1])
            speaker_latent = _pad_to(speaker_latent, bucket)
            speaker_mask = _pad_to(speaker_mask, bucket)
    timings["speaker_encode"] = time.perf_counter() - t0
    return ids, text_mask, normalized, speaker_latent, speaker_mask, timings


def sample_pipeline(
    tts: EchoTTS,
    text_prompt: str,
    speaker_audio: Optional[np.ndarray],       # (1, samples) or None
    rng_seed: int,
    sc: Optional[SamplerConfig] = None,
    sample_fn: Optional[Callable[..., torch.Tensor]] = None,
    pad_to_max_speaker_latent_length: Optional[int] = None,
    pad_to_max_text_length: Optional[int] = None,
    normalize_text: bool = False,
    noise: Optional[np.ndarray] = None,
    use_buckets: bool = True,
    speaker_cache=None,
) -> Tuple[np.ndarray, str, dict]:
    """Returns (audio (1, 1, T) fp32 numpy, normalized text, timings).

    timings holds the wall seconds of each stage (tokenize, speaker_encode,
    sample, vocoder, crop) and, for checks, the sample count and finiteness
    of the audio before the crop. Without `sample_fn` the sampler and the
    decode run as one call: "sample" holds both and "vocoder" is 0.0.
    `sample_fn(speaker_latent, speaker_mask, ids, text_mask, rng_seed)`,
    given torch tensors on `tts.device`, replaces the sampler and returns
    the latents (1, T, latent); they are then decoded by `ae_decode`, whose
    wall is "vocoder". `noise` (1, sequence_length, latent) replaces the
    seeded draw (`draw_noise`: the numbers jax.random.normal gives the JAX
    package for the same seed). `speaker_cache`: see `_prepare_inputs`."""
    sc = sc or SamplerConfig()
    dev = tts.device
    (ids, text_mask, normalized, speaker_latent, speaker_mask,
     timings) = _prepare_inputs(tts, text_prompt, speaker_audio, normalize_text,
                                pad_to_max_text_length, pad_to_max_speaker_latent_length,
                                use_buckets, speaker_cache=speaker_cache)
    spk_t, smask_t = (torch.as_tensor(speaker_latent, device=dev),
                      torch.as_tensor(speaker_mask, device=dev))
    ids_t, tmask_t = torch.as_tensor(ids, device=dev), torch.as_tensor(text_mask, device=dev)

    t0 = time.perf_counter()
    if sample_fn is None:
        shape = (1, sc.sequence_length, tts.dit_cfg.latent_size)
        noise_t = (draw_noise(rng_seed, shape, dev) if noise is None
                   else torch.as_tensor(np.asarray(noise), dtype=torch.float32, device=dev))
        latents, audio = _sample_and_decode(
            tts.dit_params, tts.dit_cfg, sc, tts.ae_params, tts.ae_cfg, tts.pca, spk_t,
            smask_t, ids_t, tmask_t, noise_t, tts.model_dtype)
        audio = audio.cpu().numpy()
        timings["sample"] = time.perf_counter() - t0
        timings["vocoder"] = 0.0
    else:
        latents = sample_fn(spk_t, smask_t, ids_t, tmask_t, rng_seed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings["sample"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        audio = ae_decode(tts.ae_params, tts.ae_cfg, tts.pca, latents).cpu().numpy()
        timings["vocoder"] = time.perf_counter() - t0
    timings["samples_before_crop"] = float(audio.shape[-1])
    timings["finite_before_crop"] = float(np.isfinite(audio).all())

    t0 = time.perf_counter()
    audio = crop_audio_to_flattening_point(audio, latents[0],
                                           samples_per_latent=tts.ae_cfg.frame_length)
    timings["crop"] = time.perf_counter() - t0
    return audio, normalized[0], timings


def _stack_padded(preps, dev):
    """The prepared requests' ids, text mask, speaker latents and speaker
    mask, each padded to the batch's largest bucket and stacked on the
    device; the masks keep the padding out of the attention."""
    text_len = max(p[0].shape[1] for p in preps)
    spk_len = max(p[3].shape[1] for p in preps)

    def stack(i, n):
        return torch.as_tensor(np.concatenate([_pad_to(np.asarray(p[i]), n) for p in preps]),
                               device=dev)

    return stack(0, text_len), stack(1, text_len), stack(3, spk_len), stack(4, spk_len)


def sample_pipeline_batch(tts: EchoTTS, requests, sc: Optional[SamplerConfig] = None,
                          normalize_text: bool = False, speaker_cache=None):
    """`sample_pipeline` for N requests (text, speaker_audio or None, seed)
    through one `_sample_and_decode` of N rows. Row i's noise is
    `draw_noise(seed_i)`'s, as the solo call draws it. Returns a list of
    (audio (1, 1, T_i), normalized text, timings) in request order, each
    cropped at its own flattening point; every timings dict carries the
    shared sample wall, `vocoder` 0.0 and `batch_size`. `speaker_cache`:
    see `_prepare_inputs`."""
    sc = sc or SamplerConfig()
    dev = tts.device
    preps = [_prepare_inputs(tts, text, spk, normalize_text, None, None, True,
                             speaker_cache=speaker_cache)
             for text, spk, _seed in requests]
    ids, text_mask, speaker_latent, speaker_mask = _stack_padded(preps, dev)

    t0 = time.perf_counter()
    noise = draw_noise([seed for _text, _spk, seed in requests],
                       (len(requests), sc.sequence_length, tts.dit_cfg.latent_size), dev)
    latents, audio = _sample_and_decode(
        tts.dit_params, tts.dit_cfg, sc, tts.ae_params, tts.ae_cfg, tts.pca, speaker_latent,
        speaker_mask, ids, text_mask, noise, tts.model_dtype)
    audio = audio.cpu().numpy()
    sample_wall = time.perf_counter() - t0

    out = []
    for i, p in enumerate(preps):
        timings = dict(p[5], sample=sample_wall, vocoder=0.0, batch_size=float(len(requests)),
                       samples_before_crop=float(audio.shape[-1]),
                       finite_before_crop=float(np.isfinite(audio[i]).all()))
        t0 = time.perf_counter()
        cropped = crop_audio_to_flattening_point(audio[i:i + 1], latents[i],
                                                 samples_per_latent=tts.ae_cfg.frame_length)
        timings["crop"] = time.perf_counter() - t0
        out.append((cropped, p[2][0], timings))
    return out


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------


def _block_schedule(block_size, budget: int, patch: int = 1) -> list:
    """Block sizes summing to `budget`: an int is a uniform size; a
    sequence is used in order and its last entry repeats (the final block
    truncates), e.g. (64, 192) -> [64, 192, 192, 192] at 640. `patch`
    rounds every size up to a multiple of the latent patch size."""
    sizes = [int(block_size)] if isinstance(block_size, (int, np.integer)) \
        else [int(s) for s in block_size]
    if not sizes or any(s < 1 for s in sizes):
        raise ValueError(f"block sizes must be >= 1, got {block_size}")
    if patch > 1:
        if budget % patch:
            raise ValueError(
                f"block budget {budget} is not a multiple of the latent "
                f"patch size {patch} (the latent-prefix KV is patchified)")
        sizes = [-(-s // patch) * patch for s in sizes]
    out, i = [], 0
    while budget > 0:
        out.append(min(sizes[min(i, len(sizes) - 1)], budget))
        budget -= out[-1]
        i += 1
    return out


def _deprojected(pca, latents, ae_params) -> torch.Tensor:
    return pca_mod.deproject(pca, latents).to(s1dac.params_dtype(ae_params))


@torch.no_grad()
def _sample_block_and_decode(dit_params, dit_cfg, sc, prefix, lat_state, dec_state,
                             start_pos: int, noise, text_mask, speaker_mask, kv_text,
                             kv_speaker, ae_params, ae_cfg, pca, block_size: int,
                             total_len: int, model_dtype, max_positions: int):
    """One streaming step: sample the block [start_pos, start_pos + block),
    append its latent KV, deproject it and decode it through the stateful
    S1-DAC step. Returns (prefix, lat_state, dec_state, audio fp32)."""
    prefix, lat_state = sample_block_core(
        dit_params, dit_cfg, sc, prefix, lat_state, start_pos, noise, text_mask,
        speaker_mask, kv_text, kv_speaker, block_size, total_len, model_dtype)
    z_q = _deprojected(pca, prefix[:, start_pos:start_pos + block_size], ae_params)
    audio, dec_state = s1dac.decode_zq_stream_step(ae_params, ae_cfg, dec_state, z_q,
                                                   max_positions)
    return prefix, lat_state, dec_state, audio.float()


@torch.no_grad()
def _stream_first_block(dit_params, dit_cfg, sc, ae_params, ae_cfg, pca, speaker_latent,
                        speaker_mask, ids, text_mask, noise, block_size: int, total_len: int,
                        model_dtype, max_positions: int):
    """The stream's prologue and first block: text and speaker KV, zero
    prefix, latent-KV and decoder state, then the first block's step.
    Returns (kv_text, kv_speaker, prefix, lat_state, dec_state, audio)."""
    kv_text = get_kv_cache_text(dit_params, dit_cfg, ids, text_mask)
    kv_speaker = get_kv_cache_speaker(dit_params, dit_cfg, speaker_latent.to(model_dtype))
    b = ids.shape[0]
    prefix = torch.zeros((b, total_len, dit_cfg.latent_size), dtype=torch.float32,
                         device=ids.device)
    lat_state = init_latent_kv_state(dit_params, dit_cfg, b, total_len, model_dtype)
    dec_state = s1dac.streaming_decode_init(ae_params, ae_cfg, b)
    prefix, lat_state, dec_state, audio = _sample_block_and_decode(
        dit_params, dit_cfg, sc, prefix, lat_state, dec_state, 0, noise, text_mask,
        speaker_mask, kv_text, kv_speaker, ae_params, ae_cfg, pca, block_size, total_len,
        model_dtype, max_positions)
    return kv_text, kv_speaker, prefix, lat_state, dec_state, audio


@torch.no_grad()
def stream_blocks_fused(dit_params, dit_cfg, sc, ae_params, ae_cfg, pca, speaker_latent,
                        speaker_mask, ids, text_mask, block_sizes, noises, model_dtype,
                        continuation_latent=None, max_positions: Optional[int] = None):
    """The streaming loop shared by `sample_pipeline_stream` and the
    benchmark: per block, sample, deproject and decode through the stateful
    vocoder. Yields (prefix, audio (B, 1, bs·frame_length) fp32 on the
    device, start, bs). A continuation prefix first seeds the latent KV and
    advances the decoder state through the seed region (its audio is
    dropped); only new blocks are yielded. `sc.first_block_steps`, when
    set, is the step count of the first emitted block. The prefix buffer is
    written in place by later blocks."""
    dev = ids.device
    b = ids.shape[0]
    cont_len = 0 if continuation_latent is None else continuation_latent.shape[1]
    _check_patch_aligned(block_sizes, cont_len, dit_cfg.speaker_patch_size)
    total = cont_len + sum(int(s) for s in block_sizes)
    if max_positions is None:
        max_positions = max(1024, total)
    sc_rest = dataclasses.replace(sc, first_block_steps=None)
    sc0 = (dataclasses.replace(sc_rest, num_steps=int(sc.first_block_steps))
           if sc.first_block_steps else sc_rest)

    def noise_of(i):
        return torch.as_tensor(noises[i], dtype=torch.float32, device=dev)

    if continuation_latent is None:
        bs0 = int(block_sizes[0])
        kv_text, kv_speaker, prefix, lat_state, dec_state, audio = _stream_first_block(
            dit_params, dit_cfg, sc0, ae_params, ae_cfg, pca, speaker_latent, speaker_mask,
            ids, text_mask, noise_of(0), bs0, total, model_dtype, max_positions)
        yield prefix, audio, 0, bs0
        start = bs0
        rest = list(enumerate(block_sizes))[1:]
    else:
        kv_text = get_kv_cache_text(dit_params, dit_cfg, ids, text_mask)
        kv_speaker = get_kv_cache_speaker(dit_params, dit_cfg, speaker_latent.to(model_dtype))
        prefix = torch.zeros((b, total, dit_cfg.latent_size), dtype=torch.float32, device=dev)
        prefix[:, :cont_len] = continuation_latent.float()
        lat_state = init_latent_kv_state(dit_params, dit_cfg, b, total, model_dtype)
        extend_latent_kv(dit_params, dit_cfg, lat_state, continuation_latent.to(model_dtype), 0)
        dec_state = s1dac.streaming_decode_init(ae_params, ae_cfg, b)
        z_cont = _deprojected(pca, prefix[:, :cont_len], ae_params)
        for done in range(0, cont_len, 64):
            _, dec_state = s1dac.decode_zq_stream_step(
                ae_params, ae_cfg, dec_state, z_cont[:, :, done:done + 64], max_positions)
        start = cont_len
        rest = list(enumerate(block_sizes))

    for bi, bs in rest:
        # a continuation's first emitted block is the first block too
        sc_b = sc0 if (continuation_latent is not None and bi == 0) else sc_rest
        prefix, lat_state, dec_state, audio = _sample_block_and_decode(
            dit_params, dit_cfg, sc_b, prefix, lat_state, dec_state, start, noise_of(bi),
            text_mask, speaker_mask, kv_text, kv_speaker, ae_params, ae_cfg, pca, int(bs),
            total, model_dtype, max_positions)
        yield prefix, audio, start, int(bs)
        start += int(bs)


class _StreamEmitter:
    """Emission state of one streamed utterance: audio is held back by one
    detector window, so that a flattening point near a block's end crops
    the audio before it is sent; detection looks at the generated region
    only and counts only windows that lie wholly inside the latents seen
    so far (the detector pads past its input with zeros, which would look
    flat at every block's end)."""

    WINDOW = 20  # the flattening detector's window

    def __init__(self, total: int, spl: int, cont_len: int = 0,
                 stop_at_flattening: bool = True):
        self.total = total
        self.spl = spl
        self.cont_len = cont_len
        self.stop_at_flattening = stop_at_flattening
        self.emitted_to = cont_len
        self.held = np.zeros((1, 1, 0), np.float32)
        self.stopped = False

    def on_block(self, lat_row, audio_row: np.ndarray, start: int, bs: int):
        """lat_row: (>= start + bs, latent) latents (a tensor), or None when
        stop_at_flattening is off; audio_row: (1, 1, bs·spl), this block's
        audio. Returns (chunk, possibly empty; stopped)."""
        end = start + bs
        is_final = end == self.total
        audio = np.concatenate([self.held, audio_row], axis=-1)  # [emitted_to, end)
        self.held = np.zeros((1, 1, 0), np.float32)

        fp = None
        if self.stop_at_flattening:
            cand = self.cont_len + int(flattening.find_flattening_point(
                lat_row[self.cont_len:end]))
            if cand <= end - self.WINDOW or (is_final and cand < end):
                fp = cand
        if fp is not None and fp < end:
            self.stopped = True
            return audio[:, :, :max(0, fp - self.emitted_to) * self.spl], True
        if is_final:
            self.stopped = True
            return audio, True
        hold_from = max(self.emitted_to, end - self.WINDOW)
        cut = (hold_from - self.emitted_to) * self.spl
        self.held = audio[:, :, cut:]
        self.emitted_to = hold_from
        return audio[:, :, :cut], False


def sample_pipeline_stream(
    tts: EchoTTS,
    text_prompt: str,
    speaker_audio: Optional[np.ndarray],
    rng_seed: int,
    sc: Optional[SamplerConfig] = None,
    block_size=(64, 192),
    normalize_text: bool = False,
    stop_at_flattening: bool = True,
    decode_context_frames: Optional[int] = None,
    continuation_audio: Optional[np.ndarray] = None,
    speaker_cache=None,
):
    """Streaming generation: yields fp32 numpy chunks (1, 1, n_samples), one
    per latent block, as soon as each block is sampled and decoded.

    Block i's noise is rows [start_i, end_i) of the one-shot draw for
    `rng_seed`. With `stop_at_flattening` the flattening detector runs on
    the latents generated so far after each block; emission is held back
    by its 20-latent window, so the stream crops where the one-shot path
    would and stops there. `continuation_audio` (1, samples) is encoded
    into latents that seed the prefix (the text should include its
    transcript); it spends its share of the sequence_length budget, and
    only new audio is emitted. Needs a checkpoint with the latent modules.
    `speaker_cache`: see `_prepare_inputs`. `decode_context_frames` is
    accepted, at the JAX package's position, and unused: the stateful
    decode carries its own context.
    """
    if not tts.dit_cfg.has_latent_modules:
        raise ValueError(
            "streaming generation needs the blockwise (latent-prefix) modules;"
            " this checkpoint was converted with delete_blockwise_modules")
    sc = sc or SamplerConfig()
    dev = tts.device
    ids, text_mask, _, speaker_latent, speaker_mask, _ = _prepare_inputs(
        tts, text_prompt, speaker_audio, normalize_text, None, None, True,
        speaker_cache=speaker_cache)
    patch = tts.dit_cfg.speaker_patch_size
    block_sizes = _block_schedule(block_size, sc.sequence_length, patch)
    spl = tts.ae_cfg.frame_length

    cont_latent, cont_len = None, 0
    if continuation_audio is not None:
        # whole frames, encoded in chunks; cropped to the valid length and
        # then to a multiple of the latent patch size
        cont_np, cont_mask = get_speaker_latent_and_mask(
            tts.ae_params, tts.ae_cfg, tts.pca, np.asarray(continuation_audio),
            max_speaker_latent_length=tts.pipe_cfg.max_speaker_latent_length,
            audio_chunk_latents=tts.pipe_cfg.audio_chunk_latents, pad_to_max=False)
        cont_len = int(cont_mask.sum())
        cont_len -= cont_len % patch
        if cont_len == 0:
            raise ValueError("continuation audio shorter than one latent patch")
        cont_latent = torch.as_tensor(cont_np[:, :cont_len], device=dev)
        budget = sc.sequence_length - cont_len
        if budget < 1:
            raise ValueError(f"continuation occupies {cont_len} of the {sc.sequence_length}"
                             "-latent budget; nothing left to generate")
        block_sizes = _block_schedule(block_size, budget, patch)

    full_noise = draw_noise(rng_seed, (1, sc.sequence_length, tts.dit_cfg.latent_size), dev)
    offsets = np.cumsum([0] + block_sizes)
    noises = [full_noise[:, a:b] for a, b in zip(offsets[:-1], offsets[1:])]

    em = _StreamEmitter(cont_len + sum(block_sizes), spl, cont_len, stop_at_flattening)
    for prefix, audio, start, bs in stream_blocks_fused(
            tts.dit_params, tts.dit_cfg, sc, tts.ae_params, tts.ae_cfg, tts.pca,
            torch.as_tensor(speaker_latent, device=dev),
            torch.as_tensor(speaker_mask, device=dev), torch.as_tensor(ids, device=dev),
            torch.as_tensor(text_mask, device=dev), block_sizes, noises, tts.model_dtype,
            continuation_latent=cont_latent):
        lat_row = prefix[0, :start + bs] if stop_at_flattening else None
        chunk, stopped = em.on_block(lat_row, audio.cpu().numpy(), start, bs)
        yield chunk
        if stopped:
            return


def sample_pipeline_stream_batch(
    tts: EchoTTS,
    requests,                       # list of (text, speaker_audio or None, seed)
    sc: Optional[SamplerConfig] = None,
    block_size=(64, 192),
    normalize_text: bool = False,
    stop_at_flattening: bool = True,
    speaker_cache=None,
):
    """N streams through one `stream_blocks_fused` of N rows. Yields
    {request index: chunk (1, 1, n > 0)} after each block: a row appears
    only with audio (the hold-back can leave a row's share of a block
    empty) and stops appearing after its flattening point; the batch stops
    once every row has stopped. A row's chunks, concatenated, equal its
    solo `sample_pipeline_stream` up to rounding (its noise rows are its
    seed's; the padding is masked). The emission logic is the solo path's
    `_StreamEmitter`. No continuation: use `sample_pipeline_stream`.
    `speaker_cache`: see `_prepare_inputs`."""
    if not tts.dit_cfg.has_latent_modules:
        raise ValueError(
            "streaming generation needs the blockwise (latent-prefix) modules;"
            " this checkpoint was converted with delete_blockwise_modules")
    sc = sc or SamplerConfig()
    dev = tts.device
    n = len(requests)
    preps = [_prepare_inputs(tts, text, spk, normalize_text, None, None, True,
                             speaker_cache=speaker_cache)
             for text, spk, _seed in requests]
    ids, text_mask, speaker_latent, speaker_mask = _stack_padded(preps, dev)
    block_sizes = _block_schedule(block_size, sc.sequence_length, tts.dit_cfg.speaker_patch_size)
    full = draw_noise([seed for _t, _s, seed in requests],
                      (n, sc.sequence_length, tts.dit_cfg.latent_size), dev)
    offsets = np.cumsum([0] + block_sizes)
    noises = [full[:, a:b] for a, b in zip(offsets[:-1], offsets[1:])]

    ems = [_StreamEmitter(sum(block_sizes), tts.ae_cfg.frame_length, 0, stop_at_flattening)
           for _ in range(n)]
    for prefix, audio, start, bs in stream_blocks_fused(
            tts.dit_params, tts.dit_cfg, sc, tts.ae_params, tts.ae_cfg, tts.pca,
            speaker_latent, speaker_mask, ids, text_mask, block_sizes, noises, tts.model_dtype):
        audio = audio.cpu().numpy()
        out = {}
        for i, em in enumerate(ems):
            if em.stopped:
                continue
            lat_row = prefix[i, :start + bs] if stop_at_flattening else None
            chunk, _ = em.on_block(lat_row, audio[i:i + 1], start, bs)
            if chunk.shape[-1]:
                out[i] = chunk
        yield out
        if all(em.stopped for em in ems):
            return


# ---------------------------------------------------------------------------
# Continuous stream group
# ---------------------------------------------------------------------------
#
# The group state holds B streams, one a row, each at its own position:
#   kv_text, kv_speaker  (k, v) pairs of (L, B, H, T, Dh): each row's caches
#   text_mask, speaker_mask  (B, T) bool; a free row's are all False
#   prefix  (B, total_len, latent) fp32; lat  `init_latent_kv_state` (rows on
#   axis 1); dec  `streaming_decode_init(per_row_pos=True)` (rows on axis 0)
# total_len carries a block of headroom past the sampler budget, so that a
# row's final partial block writes [pos, pos + block) in bounds. A free row
# computes with empty masks and valid_len 0; its outputs are thrown away.
# `_join_row` and `_stream_step_rows` write the state in place (the JAX
# package donates it); `_resize_group` gathers rows into new tensors.


def _map_rows(tree, fn):
    """fn applied to every tensor leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_rows(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_rows(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    """The tensor leaves of nested dicts and lists, in a fixed order."""
    out = []
    _map_rows(tree, out.append)
    return out


def _tails(dec: dict) -> dict:
    """A vocoder state's carried tails and KV window, its position left
    out: rows on axis 0."""
    return {k: v for k, v in dec.items() if k != "pos"}


def init_stream_group(tts: EchoTTS, batch: int, total_len: int, text_len: int,
                      spk_len: int) -> dict:
    """A group state of `batch` free rows on the card: zero caches and
    all-False masks (a fully masked segment adds exact zeros)."""
    cfg, md, dev = tts.dit_cfg, tts.model_dtype, tts.device
    n_spk = spk_len // cfg.speaker_patch_size
    heads = tts.dit_params["blocks"]["attention"]["k_norm"].shape[-2]  # local under tp

    def z(t):
        return torch.zeros((cfg.num_layers, batch, heads, t, cfg.head_dim), dtype=md,
                           device=dev)

    return {"kv_text": (z(text_len), z(text_len)),
            "kv_speaker": (z(n_spk), z(n_spk)),
            "text_mask": torch.zeros((batch, text_len), dtype=torch.bool, device=dev),
            "speaker_mask": torch.zeros((batch, spk_len), dtype=torch.bool, device=dev),
            "prefix": torch.zeros((batch, total_len, cfg.latent_size), dtype=torch.float32,
                                  device=dev),
            "lat": init_latent_kv_state(tts.dit_params, cfg, batch, total_len, md),
            "dec": s1dac.streaming_decode_init(tts.ae_params, tts.ae_cfg, batch,
                                               per_row_pos=True)}


@torch.no_grad()
def _stream_step_rows(dit_params, dit_cfg, sc, ae_params, ae_cfg, pca, gs: dict, start_pos,
                      valid_len, noise, block_size: int, total_len: int, model_dtype,
                      max_positions: int):
    """One block of `block_size` for every row of the group at its own
    position (start_pos (B,)): sample, append each row's latent KV, decode
    through the per-row stateful vocoder. valid_len (B,) hides each row's
    in-block keys past its remaining budget; a free row passes 0. Writes
    `gs` in place; returns (gs, audio (B, 1, block·frame_length) fp32,
    the block's latents (B, block, latent) fp32)."""
    dev = gs["prefix"].device
    start_pos = torch.as_tensor(start_pos, dtype=torch.long, device=dev)
    sample_block_core(dit_params, dit_cfg, sc, gs["prefix"], gs["lat"], start_pos,
                      torch.as_tensor(noise, dtype=torch.float32, device=dev), gs["text_mask"],
                      gs["speaker_mask"], gs["kv_text"], gs["kv_speaker"], block_size,
                      total_len, model_dtype, valid_len=valid_len)
    rows = torch.arange(start_pos.shape[0], device=dev)[:, None]
    block_lat = gs["prefix"][rows, row_slots(start_pos, block_size, total_len)]
    audio, gs["dec"] = s1dac.decode_zq_stream_step(
        ae_params, ae_cfg, gs["dec"], _deprojected(pca, block_lat, ae_params), max_positions)
    return gs, audio.float(), block_lat


def _put_caches(gs: dict, row: int, kv_text, kv_speaker, tmask, smask) -> None:
    """A one-row request's text/speaker caches and masks into slot `row`."""
    for name, new in (("kv_text", kv_text), ("kv_speaker", kv_speaker)):
        for buf, nb in zip(gs[name], new):
            buf[:, row, :, :nb.shape[3]] = nb[:, 0]
    gs["text_mask"][row] = tmask[0]
    gs["speaker_mask"][row] = smask[0]


@torch.no_grad()
def _join_row(dit_params, dit_cfg, ae_params, ae_cfg, gs: dict, row: int, ids, tmask,
              spk_latent, smask, model_dtype) -> dict:
    """Admit a stream into slot `row` of a running group, in place: its
    text and speaker caches and masks are written, and the slot's prefix,
    latent KV and vocoder state (its position too) are zeroed."""
    _put_caches(gs, row, get_kv_cache_text(dit_params, dit_cfg, ids, tmask),
                get_kv_cache_speaker(dit_params, dit_cfg, spk_latent.to(model_dtype)),
                tmask, smask)
    gs["prefix"][row] = 0
    for buf in gs["lat"].values():
        buf[:, row] = 0
    gs["dec"]["pos"][row] = 0
    for buf in _leaves(_tails(gs["dec"])):
        buf[row] = 0
    return gs


@torch.no_grad()
def _join_row_first_block(dit_params, dit_cfg, sc, ae_params, ae_cfg, pca, gs: dict, row: int,
                          ids, tmask, spk_latent, smask, noise, block_size: int,
                          total_len: int, model_dtype, max_positions: int):
    """Admit a stream into slot `row` with its first block: build its caches,
    sample and decode its first `block_size` latents alone (B=1, the solo
    stream's prologue), then write the whole one-row state into the slot,
    in place. The group continues the row at start_pos = block_size.
    Returns (gs, audio (1, 1, block·frame_length) fp32, the block's
    latents (1, block, latent) fp32)."""
    dev = gs["prefix"].device
    kv_text = get_kv_cache_text(dit_params, dit_cfg, ids, tmask)
    kv_speaker = get_kv_cache_speaker(dit_params, dit_cfg, spk_latent.to(model_dtype))
    prefix1 = torch.zeros((1, total_len, dit_cfg.latent_size), dtype=torch.float32, device=dev)
    lat1 = init_latent_kv_state(dit_params, dit_cfg, 1, total_len, model_dtype)
    sample_block_core(dit_params, dit_cfg, sc, prefix1, lat1, 0,
                      torch.as_tensor(noise, dtype=torch.float32, device=dev), tmask, smask,
                      kv_text, kv_speaker, block_size, total_len, model_dtype)
    block_lat = prefix1[:, :block_size]
    dec1 = s1dac.streaming_decode_init(ae_params, ae_cfg, 1, per_row_pos=True)
    audio, dec1 = s1dac.decode_zq_stream_step(
        ae_params, ae_cfg, dec1, _deprojected(pca, block_lat, ae_params), max_positions)

    _put_caches(gs, row, kv_text, kv_speaker, tmask, smask)
    gs["prefix"][row] = prefix1[0]
    for name, buf in gs["lat"].items():
        buf[:, row] = lat1[name][:, 0]
    gs["dec"]["pos"][row] = dec1["pos"][0]
    for buf, new in zip(_leaves(_tails(gs["dec"])), _leaves(_tails(dec1))):
        buf[row] = new[0]
    return gs, audio.float(), block_lat


@torch.no_grad()
def _resize_group(gs: dict, perm, keep) -> dict:
    """A new group state whose row i is old row perm[i]; rows with
    keep[i] False become free slots (masks cleared, vocoder position 0;
    the rest of their state is never read before `_join_row` rewrites it).
    Rows are independent everywhere in a step, so each surviving stream
    goes on exactly as before. Gathers into new tensors; the old state's
    memory is freed when the caller drops it."""
    dev = gs["prefix"].device
    perm = torch.as_tensor(perm, dtype=torch.long, device=dev)
    keep = torch.as_tensor(keep, dtype=torch.bool, device=dev)

    def t0(a):
        return a.index_select(0, perm)

    def t1(a):
        return a.index_select(1, perm)

    dec = gs["dec"]
    return {"kv_text": tuple(t1(a) for a in gs["kv_text"]),
            "kv_speaker": tuple(t1(a) for a in gs["kv_speaker"]),
            "text_mask": t0(gs["text_mask"]) & keep[:, None],
            "speaker_mask": t0(gs["speaker_mask"]) & keep[:, None],
            "prefix": t0(gs["prefix"]),
            "lat": {k: t1(v) for k, v in gs["lat"].items()},
            "dec": dict(_map_rows(_tails(dec), t0),
                        pos=torch.where(keep, t0(dec["pos"]), 0).to(torch.int32))}
