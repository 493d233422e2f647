"""Continuous batching for streams: admission at block boundaries
(counterpart of echo_tts_tpu/serve/continuous.py).

The micro-batcher (engine._run_stream_batch) fixes a stream group when it
dispatches it, so a stream that arrives one block later waits for the whole
group. This scheduler keeps one elastic group live and admits new streams
into free rows at every block boundary (pipeline._join_row), so a late
arrival's time to first audio is the block in flight plus its own first
block. Rows retire on their own (flattening stop, final partial block, a
client that left) and their slots are reused. Each row's audio equals its
solo stream with the same seed and a uniform block schedule, up to rounding
(per-row start positions, RoPE rows, latent KV, self-length masks and
vocoder state: pipeline._stream_step_rows).

* The engine's device lock is FIFO, and the scheduler holds it for one block
  boundary at a time (admissions, a resize, one group step, the copy of the
  step's results to the host), so one-shot requests, streams of other keys,
  `set_lora` and warmup interleave at block granularity.
* Fast join (default): a joiner's first block is sampled alone inside the
  admission (pipeline._join_row_first_block, the solo stream's prologue,
  honouring the request's `first_block_steps`) and emitted before the
  boundary's group step.
* Growth is burst-proof: the row count grows to the demanded power of two
  in one resize; it shrinks one level a boundary.
* Arrivals are FIFO: what a boundary cannot admit waits in a backlog that
  stays ahead of newer arrivals.
* `Engine.close()` sets an event checked at every boundary: active clients
  get an error and END within about a block. A live group keeps the DiT
  params it started with (taken when the group opens, under the device
  lock); `set_lora` applies to groups started after it.
* Every device call goes through the engine (`Engine._dispatch`: the group
  lives in the engine's table by id, `group_open`, `group_resize`,
  `group_join`, `group_step`, `group_close`), so on a tensor-parallel
  engine the followers run each call in the same order on their shard.
  The host side stays here, on rank 0: admissions, the backlog, the
  speaker encode and the noise (sent as host arrays), emission and
  retirement. The group is closed on every rank when the scheduler ends,
  whether it drained, failed or the engine closed.
"""
from __future__ import annotations

import dataclasses
import logging
import queue as _queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from echo_tts_tpu_torch.core.config import SamplerConfig
from echo_tts_tpu_torch.pipeline import pipeline as pl
from echo_tts_tpu_torch.sampling.euler_cfg import draw_noise
from echo_tts_tpu_torch.serve.engine import _pow2_ceil

log = logging.getLogger("echo_tts_tpu_torch.serve")


def prepare_row(tts, text: str, speaker, normalize: bool, seed: int, seq: int, text_len: int,
                spk_len: int, speaker_cache=None):
    """One request's group-row inputs on the host: ids, text mask, speaker
    latents and mask, padded to the group's text and speaker lengths (the
    request's own buckets are never larger), and its seed's noise (1, seq,
    latent). No collective runs here: the speaker encode is the replicated
    AE's."""
    ids, tmask, _, spk, smask, _ = pl._prepare_inputs(tts, text, speaker, normalize, None, None,
                                                      True, speaker_cache=speaker_cache)
    row = [pl._pad_to(np.asarray(a), n)
           for a, n in ((ids, text_len), (tmask, text_len), (spk, spk_len), (smask, spk_len))]
    noise = draw_noise(seed, (1, seq, tts.dit_cfg.latent_size), "cpu").numpy()
    return (*row, noise)


class _Row:
    """Host-side state of one occupied slot."""

    __slots__ = ("req", "emitter", "noise", "pos", "total", "lat_parts")

    def __init__(self, req, emitter, noise, total):
        self.req = req
        self.emitter = emitter
        self.noise = noise          # (1, total, latent) np.float32
        self.pos = 0
        self.total = total
        self.lat_parts: List[torch.Tensor] = []  # each block's (valid, latent), host


class ContinuousStreamScheduler:
    """Owns one live elastic group for a compatibility key on a thread of
    its own (`echo-tts-continuous`), taking the engine's device lock for one
    block boundary at a time. Requests enter through submit(); when the
    group has drained and nothing is pending the thread exits, and the
    engine starts a fresh scheduler for the next stream."""

    def __init__(self, engine, key, block_size: int, sc, normalize: bool, spk_bucket: int,
                 linger_s: float = 0.05):
        self.engine = engine
        self.key = key
        self.gid = next(engine._group_ids)  # the group's id on every rank
        self._open = False                   # the group is open on every rank
        # first_block_steps is an admission knob (the fast join honours it);
        # the group's uniform steps never use it
        self.sc = dataclasses.replace(sc or SamplerConfig(), first_block_steps=None)
        self.normalize = normalize
        self.spk_bucket = spk_bucket  # 0: a no-speaker group
        p = engine.tts.dit_cfg.speaker_patch_size
        self.bs = -(-int(block_size) // p) * p
        # a fast join needs a whole first block inside the budget
        self.fast_join = bool(engine.continuous_fast_join and self.sc.sequence_length >= self.bs)
        self.linger_s = linger_s
        self.pending: "_queue.Queue" = _queue.Queue()
        self._closed = False
        self.n_active = 0  # occupied slots
        self.n_joined = 0  # admissions over the group's life
        self.n_steps = 0   # group steps
        self.cur_b = 1     # current row count
        self.max_b = 1     # its high-water mark
        self._mu = threading.Lock()
        self.thread = threading.Thread(target=self._run, daemon=True, name="echo-tts-continuous")
        self.thread.start()

    def submit(self, req) -> bool:
        """Queue a stream for the next block boundary; False once the
        scheduler is closed (the caller starts a new one)."""
        with self._mu:
            if self._closed:
                return False
            self.pending.put(req)
            return True

    def _emit(self, rows, slot, audio_row: np.ndarray, lat_row: torch.Tensor, v: int, spl: int,
              sr: int):
        """Shared emission of the fast join and the group step: feed the
        row's emitter, push its chunk, retire the row when it stops.
        audio_row (1, 1, >= v·spl) host; lat_row (>= v, latent) host."""
        r = rows[slot]
        r.lat_parts.append(lat_row[:v].float())
        chunk, stopped = r.emitter.on_block(torch.cat(r.lat_parts),
                                            audio_row[:, :, :v * spl].astype(np.float32),
                                            r.pos, v)
        if chunk.shape[-1] and not r.req.push(chunk):
            stopped = True  # the client left during the push
        self.engine._bump(total_audio_s=chunk.shape[-1] / sr)
        r.pos += v
        if stopped or r.pos >= r.total:
            ok = r.req.push(r.req.END)
            self.engine._bump(requests=1, failures=int(not ok))
            rows[slot] = None

    def _fail_out(self, rows, backlog, err):
        """Hand `err` and END to every active, backlogged and pending
        request, and close the scheduler."""
        reqs = [r.req for r in rows if r is not None] + backlog
        backlog.clear()
        while True:
            try:
                reqs.append(self.pending.get_nowait())
            except _queue.Empty:
                break
        for req in reqs:
            req.push(err)
            req.push(req.END)
        with self._mu:
            self._closed = True

    def _close_group(self):
        """Free the group on every rank (once; not after the engine has
        stopped its followers, whose groups went with them)."""
        if not self._open:
            return
        self._open = False
        eng = self.engine
        with eng._device():
            if eng._stopped:
                return
            try:
                eng._dispatch("group_close", self.gid)
            except Exception:
                log.exception("could not close continuous group %d", self.gid)

    def _run(self):
        try:
            self._run_group()
        finally:
            self._close_group()

    def _run_group(self):
        eng = self.engine
        tts = eng.tts
        cfg = tts.dit_cfg
        gid = self.gid
        b_max = eng._continuous_group_size()
        seq = self.sc.sequence_length
        total = seq + self.bs  # headroom for a final partial block
        spl, sr = tts.ae_cfg.frame_length, tts.ae_cfg.sample_rate
        text_len = tts.pipe_cfg.text_buckets[-1]
        spk_len = self.spk_bucket if self.spk_bucket else 4  # the no-speaker shape
        latent = cfg.latent_size

        backlog: List = []
        rows: List[Optional[_Row]] = []
        B = 0
        try:
            while True:
                if eng._closing.is_set():
                    self._fail_out(rows, backlog, RuntimeError("engine closed"))
                    return
                step_out = None
                with eng._device():
                    t_lock = time.perf_counter()
                    # arrivals are drained inside the lock: a burst queued
                    # while the group waited for the device is admitted at
                    # this boundary and sizes the grow below
                    while True:
                        try:
                            req = self.pending.get_nowait()
                        except _queue.Empty:
                            break
                        if req.gone.is_set():
                            req.push(req.END)
                            continue
                        backlog.append(req)
                    # retire rows whose client left before sizing the group
                    for slot, r in enumerate(rows):
                        if r is not None and r.req.gone.is_set():
                            rows[slot] = None
                            eng._bump(requests=1, failures=1)
                    active = sum(r is not None for r in rows)
                    if active or backlog:
                        if not self._open:
                            B = 1
                            eng._dispatch("group_open", gid, B, total, text_len, spk_len)
                            self._open = True
                            rows = [None]
                            eng._bump(batches=1)  # one live group is one batch
                        # burst-proof grow: to the demanded power of two in one
                        # resize, capped at the engine's group size
                        target = min(b_max, _pow2_ceil(max(1, active + len(backlog))))
                        if target > B:
                            perm = list(range(B)) + [0] * (target - B)
                            keep = [r is not None for r in rows] + [False] * (target - B)
                            eng._dispatch("group_resize", gid, perm, keep)
                            rows = rows + [None] * (target - B)
                            B = self.cur_b = target
                            self.max_b = max(self.max_b, B)
                        # admit from the backlog's head into free slots
                        slot = 0
                        while backlog and slot < B:
                            if rows[slot] is not None:
                                slot += 1
                                continue
                            req = backlog.pop(0)
                            if req.gone.is_set():
                                req.push(req.END)
                                continue
                            try:
                                *inputs, noise = prepare_row(
                                    tts, req.text, req.speaker, self.normalize, req.seed, seq,
                                    text_len, spk_len, eng._speaker_cache)
                            except Exception as e:
                                req.push(e)
                                req.push(req.END)
                                continue
                            rows[slot] = _Row(req, pl._StreamEmitter(seq, spl), noise, seq)
                            if self.fast_join:
                                fs = req.sc.first_block_steps
                                sc_first = (dataclasses.replace(self.sc, num_steps=int(fs)) if fs
                                            else self.sc)
                                audio, block_lat = eng._dispatch(
                                    "group_join", gid, slot, inputs, noise[:, :self.bs],
                                    sc_first, self.bs, total)
                                self._emit(rows, slot, audio, block_lat, self.bs, spl, sr)
                            else:
                                eng._dispatch("group_join", gid, slot, inputs, None, None,
                                              self.bs, total)
                            self.n_joined += 1
                            slot += 1
                        self.n_active = sum(r is not None for r in rows)

                        # shrink one level when the active rows fit half the
                        # group and nothing waits
                        act = [i for i, r in enumerate(rows) if r is not None]
                        if B > 1 and len(act) <= B // 2 and not backlog and self.pending.empty():
                            new_b = B // 2
                            perm = (act + [0] * new_b)[:new_b]
                            keep = ([True] * len(act) + [False] * new_b)[:new_b]
                            eng._dispatch("group_resize", gid, perm, keep)
                            rows = [rows[i] for i in act] + [None] * (new_b - len(act))
                            B = self.cur_b = new_b

                        # one step: each row at its own start and valid extent
                        # (zeros on free slots and past each budget; a row
                        # already at its budget never steps)
                        if any(r is not None and r.pos < r.total for r in rows):
                            starts = np.zeros((B,), np.int64)
                            valids = np.zeros((B,), np.int32)
                            noise_b = np.zeros((B, self.bs, latent), np.float32)
                            for slot, r in enumerate(rows):
                                if r is None:
                                    continue
                                starts[slot] = r.pos
                                v = min(self.bs, r.total - r.pos)
                                valids[slot] = v
                                noise_b[slot, :v] = r.noise[0, r.pos:r.pos + v]
                            # on the host before the lock goes: a device error
                            # surfaces here, in this group
                            audio, block_lat = eng._dispatch(
                                "group_step", gid, self.sc, starts, valids, noise_b, self.bs,
                                total)
                            self.n_steps += 1
                            step_out = (audio, block_lat, valids)
                    eng._bump(total_sample_s=time.perf_counter() - t_lock)
                # ---- lock released: emission on the host ----
                if step_out is not None:
                    audio_np, lat, valids = step_out
                    for slot in range(B):
                        v = int(valids[slot])
                        if rows[slot] is None or v == 0:
                            continue
                        self._emit(rows, slot, audio_np[slot:slot + 1], lat[slot], v, spl, sr)
                self.n_active = sum(r is not None for r in rows)
                if self.n_active == 0 and not backlog:
                    # give stragglers one linger window without the lock, then
                    # close
                    try:
                        req = self.pending.get(timeout=self.linger_s)
                        self.pending.put(req)
                        continue
                    except _queue.Empty:
                        with self._mu:
                            if self.pending.empty():
                                self._closed = True
                                return
                        continue
        except Exception as e:
            log.exception("continuous stream group failed")
            self._fail_out(rows, backlog, e)
