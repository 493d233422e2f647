"""Serving engine (counterpart of echo_tts_tpu/serve/engine.py): the model
behind one FIFO device lock, LoRA hot-swap, a content-hashed speaker cache,
a micro-batcher that groups concurrent requests into one batched call, and
utterance-level retry.

* One lock around device work (`utils/locks.py:FairLock`): callers take it
  in arrival order, so a loop that releases and re-takes it each block (the
  continuous scheduler, a stream) cannot starve one-shot requests, other
  streams, `set_lora` or warmup.
* LoRA swap is functional: the effective DiT params are a merged copy, the
  base stays as it was.
* Retry: sampling is stateless a request, so a failed request is run again
  on the same path (the same kernels, the same device), up to
  `max_retries` times, and then fails. There is no other path to fall back
  to.

Threads, streams and grad mode. Device work runs on the threads that call
the engine (HTTP handlers), on the micro-batcher (`echo-tts-microbatcher`),
on a stream worker (`echo-tts-stream-worker`), on a continuous scheduler
(`echo-tts-continuous`) and on the warmup tail (`echo-tts-warmup-tail`).
Grad mode is per thread, so every device entry runs under `_device()`: the
lock and `torch.no_grad()`. The current CUDA stream is per thread too: a
thread that sets none runs on the default stream of `tts.device`, and all
serving work stays there (the K1/K2 wrappers launch on the current stream
of their tensors' device), so launches of two threads never overlap and
each is ordered after the last. Every tensor is made on `tts.device`. Each
device entry copies its results to the host before it lets go of the lock,
so an asynchronous CUDA error surfaces in the request that caused it and
`total_sample_s` counts the device's time.

Tensor parallelism (`Engine(tts, mesh=...)`, `parallel/mesh.py`): each
rank builds its own Engine on the same weights and keeps its tp slice of
every effective tree (`shard_params` after the int8 quantization and after
each LoRA merge, both done on the full tree). Rank 0 serves; the other
ranks run `follow()`. Every device call of rank 0 runs under the device
lock through `_dispatch`, which first sends a small descriptor (the call,
its host-side arguments and seeds) on the mesh's gloo control group; the
followers run the same call in the same order, so the collectives of the
sharded forward meet. The one-shot, micro-batched and stream paths,
`set_lora`, the warmup and the continuous groups go this way;
`reconstruct` (the AE, replicated) runs on rank 0 alone. A continuous group
lives on every rank, in a table by id (`_groups`): rank 0's scheduler keeps
the host side (admissions, the backlog, emission, retirement) and sends
each device call of a group (open, resize, join, step, close) with its host
arrays, so that no follower encodes a speaker or draws noise.

Around every device call but the two closes, the ranks exchange their
status on the control group (`_run_op`): before it, so that no rank enters
the call's collectives while another cannot run it (a continuous group it
does not hold); after it, so that a failure on any rank raises on every
rank and the ranks stay in step for a retry. A failed group call drops the
group on every rank, and a later call of it is refused. `set_lora` commits
in two phases: every rank merges the adapter into a tree of its own, and
each takes that tree only when every rank reports success; otherwise every
rank keeps its old params.

A rank that dies or hangs is caught by the collective bound of
`parallel/mesh.py:initialize_multihost` (100 s by default, as
jax.distributed reports a dead peer): a rank that waits on it in a
collective of the call, or in a status exchange, raises (under gloo; under
nccl the watchdog ends the process), and a peer that has exited is seen at
once. A failed collective or exchange on the control or status group means
the tp group is lost: the engine then refuses every later call on rank 0
(`RuntimeError` naming what was lost; restart every rank), and a follower
leaves `follow()` with that error. Only a follower's wait for the next call
is unbounded (the control group's CONTROL_TIMEOUT): a server may be idle for
as long as it likes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import queue as _queue
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from echo_tts_tpu_torch.core.config import SamplerConfig
from echo_tts_tpu_torch.pipeline import pipeline as pl
from echo_tts_tpu_torch.pipeline.pipeline import (
    EchoTTS,
    sample_pipeline,
    sample_pipeline_batch,
    sample_pipeline_stream,
    sample_pipeline_stream_batch,
)
from echo_tts_tpu_torch.pipeline.speaker import ae_reconstruct, find_min_bucket_gte
from echo_tts_tpu_torch.train.lora import load_lora_checkpoint, merge_lora
from echo_tts_tpu_torch.utils.locks import FairLock
from echo_tts_tpu_torch.utils.queues import drain, put_until_abandoned

log = logging.getLogger("echo_tts_tpu_torch.serve")


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n: batches round up to it (max_batch=3 runs
    a batch of 4), so the port's batches have the JAX package's rows."""
    return 1 << max(0, n - 1).bit_length()


class _LRUCache:
    """Tiny LRU mapping for speaker-conditioning reuse (`get` and item
    assignment are what the pipeline uses). Not thread-safe by itself:
    every access happens under the engine's device lock."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        v = self._d.get(key)
        if v is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return v

    def __setitem__(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)


class _PendingRequest:
    """One queued one-shot generation awaiting the micro-batcher."""

    __slots__ = ("text", "speaker", "seed", "sc", "normalize", "key", "event", "result",
                 "error")

    def __init__(self, text, speaker, seed, sc, normalize, key):
        self.text = text
        self.speaker = speaker
        self.seed = seed
        self.sc = sc
        self.normalize = normalize
        self.key = key
        self.event = threading.Event()
        self.result = None
        self.error = None


class _PendingStream:
    """One queued streaming generation: chunks flow through a bounded
    queue of its own (a slow client never holds the device back); `gone`
    marks a consumer that left, whose chunks are dropped."""

    __slots__ = ("text", "speaker", "seed", "sc", "normalize", "block_size", "key", "queue",
                 "gone")
    END = object()

    def __init__(self, text, speaker, seed, sc, normalize, block_size, key,
                 buffer_chunks: int = 256):
        self.text = text
        self.speaker = speaker
        self.seed = seed
        self.sc = sc
        self.normalize = normalize
        self.block_size = block_size
        self.key = key
        self.queue = _queue.Queue(maxsize=buffer_chunks)
        self.gone = threading.Event()

    def push(self, item) -> bool:
        return put_until_abandoned(self.queue, item, self.gone)


def _consume(req: _PendingStream):
    """The client side of a queued stream: its chunks until END; an error
    pushed by the device side is raised here."""
    try:
        while True:
            item = req.queue.get()
            if item is _PendingStream.END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        req.gone.set()
        drain(req.queue)


class Engine:
    """Serves one `EchoTTS` on its device (`tts.device`: cuda unless the
    container was built for the CPU)."""

    def __init__(self, tts: EchoTTS, max_retries: int = 1, int8: bool = False,
                 int8_encoders: bool = False, max_batch: int = 1,
                 batch_wait_ms: float = 10.0, speaker_cache_size: int = 8,
                 mesh=None, continuous: bool = False, continuous_block: int = 64,
                 continuous_fast_join: bool = True,
                 int8_cache_path: Optional[str] = None):
        """max_batch > 1 starts the micro-batcher: concurrent `generate`
        calls whose (sampler config, text bucket, speaker bucket) match are
        grouped (the dispatcher waits up to `batch_wait_ms` for companions)
        and run as one `sample_pipeline_batch`, rounded up to a power of
        two rows; concurrent streams with the same key and block schedule
        run as one `sample_pipeline_stream_batch`. Each row's audio equals
        its solo run's up to rounding (its noise rows are its seed's).

        speaker_cache_size: LRU entries of encoded speaker conditioning,
        keyed by the audio's content; a repeated prompt skips the AE
        encode. 0 turns it off.

        continuous (needs max_batch > 1): streams join a live group at the
        next block boundary (serve/continuous.py) instead of waiting for a
        dispatched group to finish. The scheduler holds the device lock for
        one block boundary at a time. A request's block schedule collapses
        to its last entry, the group's uniform block (rounded up to the
        latent patch). continuous_fast_join: an admission samples the
        joiner's first block alone (honouring its
        SamplerConfig.first_block_steps), so its first audio does not wait
        for a group step.

        int8 serves the W8A8 int8 trunk (models/quant.py; int8_encoders also
        quantizes the encoders and the context-KV projections): the
        effective params are quantized once, the base here and every LoRA
        merge in `set_lora`, under the device lock. int8_cache_path: a file
        of the quantized base. The first engine quantizes and saves it; once
        it exists, the base is loaded from it without quantizing (equal bit
        for bit to a fresh quantization), after a check that it was written
        for this config and flag. A LoRA merge always quantizes anew.
        `int8_base` says which happened and what it took.

        mesh: a (dp=1, tp) `parallel/mesh.py` Mesh for tensor parallelism,
        `tts` holding the full weights on this rank's device (see the module
        doc); rank 0 serves and the others call `follow()`, which also runs
        rank 0's continuous groups. Only rank 0 writes the int8 cache.

        On cuda the kernels K1 and K2 (and, with int8, K4 and K5) are built
        here (nvcc, at first use in the process), so that no request pays
        the build under the lock."""
        if mesh is not None and mesh.dp != 1:
            raise ValueError(f"an Engine serves one tp group (dp=1), got {mesh.shape}: "
                             f"replicas over dp are engines of their own (parallel/fleet.py)")
        self._mesh = mesh if mesh is not None and mesh.tp > 1 else None
        self._leads = self._mesh is not None and self._mesh.rank == 0
        self._streams = {}
        self._stream_ids = itertools.count()
        self._groups = {}  # live continuous groups by id, on every rank
        self._group_ids = itertools.count()
        self._stopped = False
        self._lost: Optional[str] = None  # why the tp group is gone (then _stopped too)
        self.int8 = int8 or int8_encoders
        self.int8_encoders = int8_encoders
        if tts.device.type == "cuda":
            from echo_tts_tpu_torch.ops import _build

            names = ("joint_attention", "res_chain") + (
                ("int8_gemm", "quant_rows") if self.int8 else ())
            _build.build_all(names)
            for name in names:
                _build.load(name)
        self._base_params = tts.dit_params
        self._int8_cache_path = int8_cache_path
        self.int8_base: Optional[dict] = None
        # own container: a LoRA swap never leaks into the caller's EchoTTS
        self.tts = dataclasses.replace(tts)
        self.max_retries = max_retries
        self._lock = FairLock()
        with self._device():
            # the effective base: quantized once, given back by set_lora(None)
            self._effective_base = self._effective(self._base_params)
            self.tts.dit_params = self._effective_base
        self._current_lora_path: Optional[str] = None
        self.stats = {"requests": 0, "failures": 0, "retries": 0, "total_sample_s": 0.0,
                      "total_audio_s": 0.0, "batches": 0}
        # counters have their own mutex, always taken innermost, so stat
        # updates never queue behind device work
        self._stats_mu = threading.Lock()
        self._closing = threading.Event()
        self._speaker_cache = (_LRUCache(speaker_cache_size) if speaker_cache_size > 0
                               else None)
        self.max_batch = max_batch
        self.batch_wait_ms = batch_wait_ms
        self.continuous = continuous and max_batch > 1
        self.continuous_block = continuous_block
        self.continuous_fast_join = continuous_fast_join
        self._cont_scheds = {}
        self._cont_mu = threading.Lock()
        self._queue = []
        self._qcond = threading.Condition()
        self._shutdown = False
        self._dispatcher = None
        self._warmup_tail: Optional[threading.Thread] = None
        self.follow_errors = deque(maxlen=16)
        if max_batch > 1:
            self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True,
                                                name="echo-tts-microbatcher")
            self._dispatcher.start()

    @contextlib.contextmanager
    def _device(self):
        """The device lock, with autograd off in the calling thread."""
        with self._lock, torch.no_grad():
            yield

    def _bump(self, **fields) -> None:
        with self._stats_mu:
            for k, v in fields.items():
                self.stats[k] += v

    def close(self) -> None:
        """Stop the micro-batcher and signal the live continuous schedulers:
        they check the event at every block boundary, hand their clients an
        error and END, close their groups (on every rank of a tp engine) and
        exit within about one block. Rank 0 of a tp engine then stops its
        followers."""
        self._closing.set()
        with self._qcond:
            self._shutdown = True
            self._qcond.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=5)
        with self._cont_mu:
            scheds = list(self._cont_scheds.values())
        for s in scheds:
            s.thread.join(timeout=30)
        if not (self._leads or self._groups):
            return
        with self._device():
            # a group whose scheduler did not end in time: free it on every
            # rank before the followers stop
            for gid in list(self._groups):
                if not self._stopped:
                    try:
                        self._dispatch("group_close", gid)
                    except RuntimeError as e:
                        log.warning("could not close continuous group %d: %s", gid, e)
            self._groups.clear()
            if self._leads and not self._stopped:
                self._stopped = True
                try:
                    self._send(("stop", ()))
                except RuntimeError as e:  # a follower that is gone already
                    log.warning("could not stop the followers: %s", e)

    # -- device calls (and their mirror on the followers of a tp engine) ---------
    def _exchange(self, what: str, fn, *args, **kwargs):
        """fn(*args, **kwargs), a collective of the control or status group;
        its failure (a rank that died, or did not answer within the group's
        timeout) loses the tp group: this engine stops, and every later
        call raises."""
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            self._lost = (f"the tp group is lost (rank {self._mesh.rank}, {what}: "
                          f"{type(e).__name__}: {e}); restart every rank")
            self._stopped = True
            self._groups.clear()
            raise RuntimeError(self._lost) from e

    def _send(self, desc) -> None:
        import torch.distributed as dist

        self._exchange(f"sending {desc[0]}", dist.broadcast_object_list, [desc], src=0,
                       group=self._mesh.control)

    def _dispatch(self, op: str, *args):
        """Run device call `op` (a `_op_<op>` method) with host-side `args`;
        the caller holds the device lock. Rank 0 of a tp engine first sends
        the descriptor to the followers, which run the same call."""
        if self._leads:
            if self._stopped:
                raise RuntimeError(self._lost or "engine is closed")
            self._send((op, args))
        return self._run_op(op, args)

    # the calls that run no collective and cannot leave the ranks out of step
    _UNCHECKED = ("stream_close", "group_close")

    def _run_op(self, op: str, args):
        """This rank's part of call `op`. On a tp engine every call but
        `_UNCHECKED` runs between two status exchanges of the ranks
        (`_agree`): `_not_ready` before, this rank's failure after; either
        raises on every rank. `set_lora` is committed only after the second
        exchange (`_commit_lora`), on every rank or on none."""
        fn = getattr(self, "_op_" + op)
        if self._mesh is None or op in self._UNCHECKED:
            out = fn(*args)
        else:
            self._agree(op, args, self._not_ready(op, args))
            try:
                out, err = fn(*args), None
            except Exception as e:
                out, err = None, f"{type(e).__name__}: {e}"
            self._agree(op, args, err)
        if op == "set_lora":
            self._commit_lora(out, args[0])
            out = None
        return out

    def _not_ready(self, op: str, args) -> Optional[str]:
        """Why this rank cannot run call `op` (None: it can)."""
        if op.startswith("group_") and op != "group_open" and args[0] not in self._groups:
            return f"group {args[0]} is not open"
        return None

    def _agree(self, op: str, args, err) -> None:
        """Every tp rank's status of call `op` (None: ready or done); raise
        on every rank if any rank reports an error. A failed call of a
        continuous group also drops the group."""
        import torch.distributed as dist

        got = [None] * self._mesh.tp
        self._exchange(f"the status of {op}", dist.all_gather_object, got, err,
                       group=self._mesh.status)
        bad = [(r, e) for r, e in enumerate(got) if e is not None]
        if bad:
            what = op
            if op.startswith("group_"):
                self._groups.pop(args[0], None)
                what = f"continuous group {args[0]}: {op}"
            raise RuntimeError(f"{what} failed on rank "
                               + "; rank ".join(f"{r}: {e}" for r, e in bad))

    def follow(self) -> None:
        """The loop of a tp engine's ranks other than 0: receive rank 0's
        descriptors and run each call, in order, until rank 0 closes. A
        call that failed here or on another rank raised on every rank
        (`_run_op`): rank 0 reports it to its caller, and here it is logged
        and kept in `follow_errors` (the last 16). A lost tp group (rank 0
        gone) raises here."""
        import torch.distributed as dist

        if self._mesh is None or self._leads:
            raise RuntimeError("follow() runs on the ranks other than 0 of a tp engine")
        while True:
            box = [None]
            self._exchange("waiting for a call", dist.broadcast_object_list, box, src=0,
                           group=self._mesh.control)
            op, args = box[0]
            if op == "stop":
                self._stopped = True
                self._groups.clear()
                return
            try:
                with self._device():
                    self._run_op(op, args)
            except Exception as e:
                self.follow_errors.append((op, str(e)))
                log.exception("follower %d: %s failed", self._mesh.rank, op)
                if self._lost:
                    raise

    def _op_pipeline(self, text, speaker_audio, seed, sc, normalize_text, cached,
                     pipe_overrides):
        """One `sample_pipeline`; pipe_overrides: PipelineConfig fields of
        this request alone, applied to a copy of this rank's container."""
        tts = self.tts
        if pipe_overrides:
            tts = dataclasses.replace(tts, pipe_cfg=dataclasses.replace(tts.pipe_cfg,
                                                                        **pipe_overrides))
        return sample_pipeline(tts, text, speaker_audio, seed, sc=sc,
                               normalize_text=normalize_text,
                               speaker_cache=self._speaker_cache if cached else None)

    def _op_batch(self, requests, sc, normalize_text, cached):
        return sample_pipeline_batch(self.tts, requests, sc=sc, normalize_text=normalize_text,
                                     speaker_cache=self._speaker_cache if cached else None)

    def _op_stream_next(self, sid, kind, kwargs):
        """The next chunk of stream `sid` (None at its end), its generator
        made at the first call: kind "solo" is `sample_pipeline_stream`,
        "batch" `sample_pipeline_stream_batch`, on this rank's tts."""
        gen = self._streams.get(sid)
        if gen is None:
            kw = dict(kwargs)
            if kw.pop("cached"):
                kw["speaker_cache"] = self._speaker_cache
            fn = sample_pipeline_stream if kind == "solo" else sample_pipeline_stream_batch
            gen = self._streams[sid] = fn(self.tts, **kw)
        return next(gen, None)

    def _op_stream_close(self, sid):
        gen = self._streams.pop(sid, None)
        if gen is not None:
            gen.close()

    def _stream(self, kind: str, **kwargs):
        """A device stream whose every step takes the device lock: a
        generator of `_op_stream_next`'s chunks, closed (on every rank) when
        it ends or its consumer leaves."""
        sid = next(self._stream_ids)
        try:
            while True:
                with self._device():
                    out = self._dispatch("stream_next", sid, kind, kwargs)
                if out is None:
                    return
                yield out
        finally:
            with self._device():
                if not self._stopped:
                    self._dispatch("stream_close", sid)

    # -- continuous groups (serve/continuous.py), on every rank by id -----------
    def _group(self, gid: int) -> dict:
        g = self._groups.get(gid)
        if g is None:
            raise RuntimeError(f"continuous group {gid} is not open")
        return g

    def _op_group_open(self, gid, batch, total, text_len, spk_len):
        """Open group `gid`: `batch` free rows (`pl.init_stream_group`, the
        caches at this rank's heads) and the DiT params it keeps for its
        life, taken here, at the same point of every rank's call order: a
        `set_lora` after this call leaves the group as it is."""
        self._groups[gid] = {"params": self.tts.dit_params,
                             "gs": pl.init_stream_group(self.tts, batch, total, text_len,
                                                        spk_len)}

    def _op_group_resize(self, gid, perm, keep):
        g = self._group(gid)
        g["gs"] = pl._resize_group(g["gs"], perm, keep)

    def _op_group_join(self, gid, slot, inputs, first_noise, sc_first, block_size, total):
        """Admit a request into `slot` of group `gid`. inputs: `prepare_row`'s
        host ids, text mask, speaker latents and mask. sc_first None:
        `pl._join_row`; else the fast join (`pl._join_row_first_block`) at
        that SamplerConfig on first_noise (1, block, latent), returning the
        first block's audio (1, 1, n) and latents (block, latent) on the
        host."""
        tts, g = self.tts, self._group(gid)
        ids, tmask, spk, smask = (torch.as_tensor(a, device=tts.device) for a in inputs)
        if sc_first is None:
            g["gs"] = pl._join_row(g["params"], tts.dit_cfg, tts.ae_params, tts.ae_cfg, g["gs"],
                                   slot, ids, tmask, spk, smask, tts.model_dtype)
            return None
        g["gs"], audio, block_lat = pl._join_row_first_block(
            g["params"], tts.dit_cfg, sc_first, tts.ae_params, tts.ae_cfg, tts.pca, g["gs"],
            slot, ids, tmask, spk, smask, first_noise, block_size, total, tts.model_dtype,
            max(1024, total))
        return audio.cpu().numpy(), block_lat[0].cpu()

    def _op_group_step(self, gid, sc, starts, valids, noise, block_size, total):
        """One block of every row of group `gid` (`pl._stream_step_rows`);
        returns its audio (B, 1, n) and latents (B, block, latent) on the
        host."""
        tts, g = self.tts, self._group(gid)
        g["gs"], audio, block_lat = pl._stream_step_rows(
            g["params"], tts.dit_cfg, sc, tts.ae_params, tts.ae_cfg, tts.pca, g["gs"], starts,
            valids, noise, block_size, total, tts.model_dtype, max(1024, total))
        return audio.cpu().numpy(), block_lat.cpu()

    def _op_group_close(self, gid):
        self._groups.pop(gid, None)

    def _effective(self, params: dict) -> dict:
        """The params requests run on: quantized when the engine serves int8
        (the base from `int8_cache_path` when that file exists)."""
        if not self.int8:
            return self._shard(params)
        from echo_tts_tpu_torch.models import quant

        cacheable = self._int8_cache_path is not None and params is self._base_params
        if self._mesh is not None and self._mesh.rank != 0:
            cacheable = cacheable and os.path.exists(self._int8_cache_path)
        cfg, path = self.tts.dit_cfg, self._int8_cache_path
        t0 = time.perf_counter()
        if cacheable and os.path.exists(path):
            out = quant.load_quantized(path, params, cfg, encoders=self.int8_encoders)
            how = "loaded"
        else:
            out = quant.quantize_dit_params(params, encoders=self.int8_encoders)
            how = "quantized"
        if params is self._base_params:
            if self.tts.device.type == "cuda":
                torch.cuda.synchronize(self.tts.device)
            self.int8_base = {"how": how, "seconds": time.perf_counter() - t0}
            if cacheable and how == "quantized":
                t0 = time.perf_counter()
                quant.save_quantized(path, out, cfg, encoders=self.int8_encoders)
                self.int8_base["save_seconds"] = time.perf_counter() - t0
        return self._shard(out)

    def _shard(self, params: dict) -> dict:
        """This rank's tp slice of an effective tree (the tree itself at tp=1)."""
        if self._mesh is None:
            return params
        from echo_tts_tpu_torch.parallel.sharding import shard_params

        return shard_params(params, self._mesh)

    # -- LoRA hot-swap -------------------------------------------------------
    def set_lora(self, lora_path: Optional[str], strength: float = 1.0) -> None:
        """Swap the effective DiT params for base + LoRA merged (None: back to
        the base). It takes the FIFO device lock, so it completes within
        about one block boundary under streaming load. A live continuous
        group keeps the params it started with (its streams finish on the
        old voice); every request issued after this call, and every group
        started after it, uses the new params. Under int8 the merge is
        quantized here; None gives the quantized base back as it was."""
        with self._device():
            if lora_path != self._current_lora_path:
                self._dispatch("set_lora", lora_path, strength)

    def _op_set_lora(self, lora_path, strength) -> dict:
        """The first phase of a swap: the effective params of base + LoRA
        (the base's for None) on this rank's slice; nothing is taken yet."""
        if lora_path is None:
            return self._effective_base
        lora, lc = load_lora_checkpoint(lora_path, self.tts.device)
        if strength != 1.0:
            lc = dataclasses.replace(lc, alpha=lc.alpha * strength)
        return self._effective(merge_lora(self._base_params, lora, lc))

    def _commit_lora(self, params: dict, lora_path) -> None:
        """The second phase, once every rank has its tree."""
        self.tts.dit_params = params
        self._current_lora_path = lora_path

    # -- generation ----------------------------------------------------------
    def generate(self, text: str, speaker_audio: Optional[np.ndarray], seed: int = 0,
                 sc: Optional[SamplerConfig] = None, normalize_text: bool = True,
                 pipe_overrides: Optional[dict] = None):
        """Returns (audio (1, 1, T) float32, normalized text, timings).

        pipe_overrides: PipelineConfig fields for this request alone (the
        UI's custom shapes, e.g. {"text_buckets": (256,), "speaker_buckets":
        (1024,)}), applied to a copy of the container on every rank, never
        to the shared one. Such a request skips the micro-batcher."""
        sc = sc or SamplerConfig()
        pipe_overrides = dict(pipe_overrides) if pipe_overrides else None
        if self.max_batch > 1 and not pipe_overrides:
            return self._generate_queued(text, speaker_audio, seed, sc, normalize_text)
        last_err = None
        for attempt in range(self.max_retries + 1):
            try:
                with self._device():
                    t0 = time.perf_counter()
                    audio, normalized, timings = self._dispatch(
                        "pipeline", text, speaker_audio, seed, sc, normalize_text, True,
                        pipe_overrides)
                    wall = time.perf_counter() - t0
                self._bump(requests=1, total_sample_s=wall,
                           total_audio_s=audio.shape[-1] / self.tts.ae_cfg.sample_rate)
                timings["total"] = wall
                return audio, normalized, timings
            except Exception as e:
                last_err = e
                self._bump(retries=1)
                log.warning("generate attempt %d failed: %s", attempt, e)
                if self._lost:
                    break
        self._bump(failures=1)
        raise RuntimeError(f"generation failed: {self._lost}" if self._lost else
                           f"generation failed after {attempt + 1} attempts") from last_err

    # -- micro-batching ------------------------------------------------------
    def _batch_key(self, text: str, speaker_audio, sc: SamplerConfig, normalize: bool):
        """Group signature: the (frozen) sampler config, the normalize flag
        and the text and speaker buckets, estimated on the host from byte
        and sample counts. An estimate off by one only costs efficiency:
        a batch pads every row to its largest bucket."""
        pc = self.tts.pipe_cfg
        n_text = min(len(text.encode("utf-8")) + 1, pc.max_text_length)
        text_bucket = find_min_bucket_gte(pc.text_buckets, n_text)
        if speaker_audio is None:
            spk_bucket = 0
        else:
            n_spk = min(int(np.asarray(speaker_audio).shape[-1]
                            // self.tts.ae_cfg.frame_length) + 1,
                        pc.max_speaker_latent_length)
            spk_bucket = find_min_bucket_gte(pc.speaker_buckets, n_spk)
        return (sc, normalize, text_bucket, spk_bucket)

    def _enqueue(self, req) -> None:
        with self._qcond:
            if self._shutdown:
                raise RuntimeError("engine is closed")
            self._queue.append(req)
            self._qcond.notify_all()

    def _generate_queued(self, text, speaker_audio, seed, sc, normalize):
        req = _PendingRequest(text, speaker_audio, seed, sc, normalize,
                              self._batch_key(text, speaker_audio, sc, normalize))
        self._enqueue(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _dispatch_loop(self):
        while True:
            with self._qcond:
                while not self._queue and not self._shutdown:
                    self._qcond.wait(0.5)
                if self._shutdown:
                    for r in self._queue:
                        if isinstance(r, _PendingStream):
                            r.push(RuntimeError("engine closed"))
                            r.push(_PendingStream.END)
                        else:
                            r.error = RuntimeError("engine closed")
                            r.event.set()
                    self._queue.clear()
                    return
                # adopt the head request's key, then linger up to
                # batch_wait_ms for companions with the same key
                key = self._queue[0].key
                deadline = time.monotonic() + self.batch_wait_ms / 1e3
                while sum(r.key == key for r in self._queue) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._shutdown:
                        break
                    self._qcond.wait(remaining)
                batch, rest = [], []
                for r in self._queue:
                    (batch if r.key == key and len(batch) < self.max_batch else rest).append(r)
                self._queue = rest
            try:
                if isinstance(batch[0], _PendingStream):
                    self._run_stream_batch(batch)
                else:
                    self._run_batch(batch)
            except Exception as e:
                # the run methods handle device failures themselves; anything
                # else must not kill the dispatcher and strand the waiters
                for r in batch:
                    if isinstance(r, _PendingStream):
                        r.push(e)
                        r.push(_PendingStream.END)
                    elif not r.event.is_set():
                        r.error = e
                        r.event.set()
                log.exception("micro-batch dispatcher error")

    def _run_batch(self, batch):
        sc, normalize = batch[0].sc, batch[0].normalize
        # a power-of-two batch, padded with copies of row 0 (their outputs
        # are dropped)
        n = len(batch)
        requests = [(r.text, r.speaker, r.seed) for r in batch]
        requests += [requests[0]] * (_pow2_ceil(n) - n)
        last_err = None
        for attempt in range(self.max_retries + 1):
            try:
                with self._device():
                    t0 = time.perf_counter()
                    results = self._dispatch("batch", requests, sc, normalize, True)
                    wall = time.perf_counter() - t0
                self._bump(requests=n, batches=1, total_sample_s=wall,
                           total_audio_s=sum(a.shape[-1] for a, _, _ in results[:n])
                           / self.tts.ae_cfg.sample_rate)
                for r, (audio, normalized, timings) in zip(batch, results):
                    timings["total"] = wall
                    r.result = (audio, normalized, timings)
                    r.event.set()
                return
            except Exception as e:
                last_err = e
                self._bump(retries=1)
                log.warning("batched generate attempt %d failed: %s", attempt, e)
                if self._lost:
                    break
        self._bump(failures=n)
        for r in batch:
            r.error = RuntimeError(f"generation failed: {self._lost}" if self._lost else
                                   f"generation failed after {attempt + 1} attempts")
            r.error.__cause__ = last_err
            r.event.set()

    def _run_stream_batch(self, batch):
        """Grouped streams as one batched stream (one request: the solo
        stream). The device lock is held for each block, never across the
        stream or while a client drains its chunks; the batch is padded to
        a power of two with copies of row 0, whose chunks are dropped."""
        sc, normalize = batch[0].sc, batch[0].normalize
        block_size = list(batch[0].block_size)
        n = len(batch)
        t0 = time.perf_counter()
        n_samples = [0] * n
        ok = False
        gen = None
        try:
            if n == 1:
                r = batch[0]
                gen = self._stream("solo", text_prompt=r.text, speaker_audio=r.speaker,
                                   rng_seed=r.seed, sc=sc, block_size=block_size,
                                   normalize_text=normalize, cached=True)
                for chunk in gen:
                    n_samples[0] += chunk.shape[-1]
                    r.push(chunk)
                    if r.gone.is_set():
                        break  # the client left: stop paying for its blocks
            else:
                reqs = [(r.text, r.speaker, r.seed) for r in batch]
                reqs += [reqs[0]] * (_pow2_ceil(n) - n)
                gen = self._stream("batch", requests=reqs, sc=sc, block_size=block_size,
                                   normalize_text=normalize, cached=True)
                for out in gen:
                    for i, chunk in out.items():
                        if i >= n:
                            continue  # a pad row
                        n_samples[i] += chunk.shape[-1]
                        batch[i].push(chunk)
                    if all(r.gone.is_set() for r in batch):
                        break
            ok = True
        except Exception as e:
            log.warning("stream batch failed: %s", e)
            for r in batch:
                r.push(e)
        finally:
            if gen is not None:
                gen.close()
            # a refused END means the client left before the end: a failure,
            # as on the direct path
            aborted = sum(1 for r in batch if not r.push(_PendingStream.END))
            self._bump(requests=n, batches=int(n > 1), failures=n if not ok else aborted,
                       total_sample_s=time.perf_counter() - t0,
                       total_audio_s=sum(n_samples) / self.tts.ae_cfg.sample_rate)

    def generate_stream(self, text: str, speaker_audio: Optional[np.ndarray], seed: int = 0,
                        sc: Optional[SamplerConfig] = None, block_size=(64, 192),
                        normalize_text: bool = True,
                        continuation_audio: Optional[np.ndarray] = None,
                        buffer_chunks: int = 256):
        """A generator of fp32 waveform chunks (1, 1, n) as latent blocks are
        decoded (`sample_pipeline_stream`). Device work runs on another
        thread, which takes the device lock for each block and hands chunks
        over through a bounded queue, so a slow consumer never holds the
        lock; closing the generator (a client that left) stops the device
        work at the next block boundary. `continuation_audio` seeds the
        latent prefix (its transcript belongs in `text`).

        With max_batch > 1, concurrent streams with the same key and block
        schedule run as one batched stream; with `continuous`, a stream
        joins the live group of its key at a block boundary. Continuations
        always stream alone."""
        sc = sc or SamplerConfig()
        if self.continuous and continuation_audio is None:
            return self._generate_stream_continuous(text, speaker_audio, seed, sc, block_size,
                                                    normalize_text, buffer_chunks)
        if self.max_batch > 1 and continuation_audio is None:
            return self._generate_stream_queued(text, speaker_audio, seed, sc, block_size,
                                                normalize_text, buffer_chunks)
        return self._generate_stream_direct(text, speaker_audio, seed, sc, block_size,
                                            normalize_text, continuation_audio, buffer_chunks)

    def _continuous_group_size(self) -> int:
        return _pow2_ceil(self.max_batch)

    def _generate_stream_continuous(self, text, speaker_audio, seed, sc, block_size,
                                    normalize_text, buffer_chunks):
        """Submit to the live group of this key, or start one."""
        from echo_tts_tpu_torch.serve.continuous import ContinuousStreamScheduler

        bs = (int(block_size) if isinstance(block_size, (int, np.integer))
              else int(list(block_size)[-1]))
        p = self.tts.dit_cfg.speaker_patch_size
        bs = -(-bs // p) * p
        # first_block_steps is a knob of the admission (the fast join honours
        # it), never of the group's steps: requests that differ only in it
        # share a group; the request keeps its own sc
        sc_group = dataclasses.replace(sc, first_block_steps=None)
        base_key = self._batch_key(text, speaker_audio, sc_group, normalize_text)
        key = ("cont", bs, base_key)
        req = _PendingStream(text, speaker_audio, seed, sc, normalize_text, (bs,), key,
                             buffer_chunks)
        with self._cont_mu:
            if self._shutdown:
                raise RuntimeError("engine is closed")
            sched = self._cont_scheds.get(key)
            if sched is None or not sched.submit(req):
                # drop the finished schedulers of other keys while here
                for k in [k for k, s in self._cont_scheds.items() if not s.thread.is_alive()]:
                    del self._cont_scheds[k]
                sched = ContinuousStreamScheduler(self, key, bs, sc_group, normalize_text,
                                                  spk_bucket=base_key[3])
                if not sched.submit(req):
                    raise RuntimeError("a new continuous scheduler refused its first request")
                self._cont_scheds[key] = sched
        yield from _consume(req)

    def _generate_stream_queued(self, text, speaker_audio, seed, sc, block_size,
                                normalize_text, buffer_chunks):
        bs_key = (tuple(int(b) for b in block_size) if isinstance(block_size, (list, tuple))
                  else (int(block_size),))
        key = ("stream", bs_key, self._batch_key(text, speaker_audio, sc, normalize_text))
        req = _PendingStream(text, speaker_audio, seed, sc, normalize_text, bs_key, key,
                             buffer_chunks)
        self._enqueue(req)
        yield from _consume(req)

    def _generate_stream_direct(self, text, speaker_audio, seed, sc, block_size,
                                normalize_text, continuation_audio, buffer_chunks):
        q: "_queue.Queue" = _queue.Queue(maxsize=max(1, buffer_chunks))
        end = object()
        gone = threading.Event()  # the consumer left

        def work():
            gen = self._stream_device_locked(text, speaker_audio, seed, sc, block_size,
                                             normalize_text, continuation_audio, gone)
            try:
                for chunk in gen:
                    if not put_until_abandoned(q, chunk, gone):
                        return
                put_until_abandoned(q, end, gone)
            except Exception as e:
                put_until_abandoned(q, e, gone)
            finally:
                gen.close()  # releases the device lock at once

        threading.Thread(target=work, daemon=True, name="echo-tts-stream-worker").start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            gone.set()
            drain(q)  # unblocks a worker in the middle of a handoff

    def _stream_device_locked(self, text, speaker_audio, seed, sc, block_size, normalize_text,
                              continuation_audio, gone):
        """The device side of a direct stream: the lock is taken for each
        block (each step of the generator); `gone` is checked between
        blocks."""
        t0 = time.perf_counter()
        n_samples = 0
        done = False
        gen = self._stream("solo", text_prompt=text, speaker_audio=speaker_audio, rng_seed=seed,
                           sc=sc, block_size=block_size, normalize_text=normalize_text,
                           continuation_audio=continuation_audio, cached=True)
        try:
            for chunk in gen:
                n_samples += chunk.shape[-1]
                yield chunk
                if gone.is_set():
                    return
            done = True
        finally:
            gen.close()
            # counted also when the client leaves or the device fails
            self._bump(requests=1, failures=int(not done),
                       total_sample_s=time.perf_counter() - t0,
                       total_audio_s=n_samples / self.tts.ae_cfg.sample_rate)

    # -- warmup, reconstruction, health ----------------------------------------
    def warmup(self, sc: Optional[SamplerConfig] = None, include_speaker_buckets: bool = True,
               include_streaming: bool = False, stream_block_size=(64, 192),
               background_tail: bool = False) -> float:
        """Run each serving shape once before requests come: one
        `sample_pipeline` for the no-speaker shape and, with
        `include_speaker_buckets`, for a synthetic prompt in each speaker
        bucket; with `include_streaming` one stream a prompt (continuous
        mode: one group step at each power-of-two group size a prompt
        shape); with max_batch > 1 one batch at each power-of-two size.
        There is no compile to warm in the port: this runs the allocator,
        cuBLAS and the kernels at each shape (the kernels are built in
        __init__). Returns the seconds it took.

        background_tail: run only the no-speaker set now and the rest on
        a daemon thread while the server takes requests; health() reports
        `warmup_tail_running` until it ends."""
        from echo_tts_tpu_torch.serve.continuous import prepare_row

        sc = sc or SamplerConfig()
        if background_tail:
            wall = self.warmup(sc, include_speaker_buckets=False,
                               include_streaming=include_streaming,
                               stream_block_size=stream_block_size)
            if include_speaker_buckets or self.max_batch > 1:
                def tail():
                    try:
                        t = self.warmup(sc, include_speaker_buckets=include_speaker_buckets,
                                        include_streaming=include_streaming,
                                        stream_block_size=stream_block_size)
                        log.info("warmup background tail done in %.1fs", t)
                    except Exception:
                        log.exception("warmup background tail failed")
                self._warmup_tail = threading.Thread(target=tail, daemon=True,
                                                     name="echo-tts-warmup-tail")
                self._warmup_tail.start()
            return wall
        tts = self.tts
        pc, spl = tts.pipe_cfg, tts.ae_cfg.frame_length
        t0 = time.perf_counter()
        prompts = [None]
        if include_speaker_buckets:
            rng = np.random.default_rng(0)
            for b in pc.speaker_buckets:
                n = min(b, pc.max_speaker_latent_length) * spl
                prompts.append(0.1 * rng.standard_normal((1, n)).astype(np.float32))
        for audio in prompts:
            with self._device():
                self._dispatch("pipeline", "Warmup.", audio, 0, sc, True, False, None)
        n_combos = len(prompts)
        streaming = include_streaming and tts.dit_cfg.has_latent_modules
        if streaming and self.continuous:
            # one join and one group step at each power-of-two group size,
            # as the scheduler makes them (through the same group calls, so
            # a tp engine's followers run them too), for each prompt shape
            cfg = tts.dit_cfg
            p = cfg.speaker_patch_size
            bs = -(-int(self.continuous_block) // p) * p
            total = sc.sequence_length + bs
            sc_g = dataclasses.replace(sc, first_block_steps=None)
            fast = self.continuous_fast_join and sc_g.sequence_length >= bs
            b_max = self._continuous_group_size()
            with self._device():
                for audio in prompts:
                    spk_len = (4 if audio is None else find_min_bucket_gte(
                        pc.speaker_buckets, audio.shape[-1] // spl))
                    *inputs, noise = prepare_row(
                        tts, "Warmup.", audio, True, 0, sc_g.sequence_length,
                        pc.text_buckets[-1], spk_len, self._speaker_cache)
                    gid = next(self._group_ids)
                    self._dispatch("group_open", gid, 1, total, pc.text_buckets[-1], spk_len)
                    try:
                        b = 1
                        while True:
                            if fast:
                                self._dispatch("group_join", gid, 0, inputs, noise[:, :bs],
                                               sc_g, bs, total)
                            else:
                                self._dispatch("group_join", gid, 0, inputs, None, None, bs,
                                               total)
                            self._dispatch("group_step", gid, sc_g, np.zeros((b,), np.int64),
                                           np.full((b,), bs, np.int32),
                                           np.zeros((b, bs, cfg.latent_size), np.float32), bs,
                                           total)
                            n_combos += 1
                            if b >= b_max:
                                break
                            self._dispatch("group_resize", gid, np.arange(2 * b) % b,
                                           np.arange(2 * b) < b)
                            b *= 2
                    finally:
                        if not self._stopped:
                            self._dispatch("group_close", gid)
        elif streaming:
            for audio in prompts:
                for _ in self._stream("solo", text_prompt="Warmup.", speaker_audio=audio,
                                      rng_seed=0, sc=sc, block_size=stream_block_size,
                                      normalize_text=True, stop_at_flattening=False,
                                      cached=False):
                    pass
                n_combos += 1
            b = 2
            while b <= _pow2_ceil(self.max_batch):
                for audio in prompts:
                    reqs = [("Warmup.", audio, i) for i in range(b)]
                    for _ in self._stream("batch", requests=reqs, sc=sc,
                                          block_size=stream_block_size, normalize_text=True,
                                          stop_at_flattening=False, cached=False):
                        pass
                    n_combos += 1
                b *= 2
        if self.max_batch > 1:
            b = 2
            while b <= _pow2_ceil(self.max_batch):
                reqs = [("Warmup.", None, i) for i in range(b)]
                with self._device():
                    self._dispatch("batch", reqs, sc, True, False)
                n_combos += 1
                b *= 2
        wall = time.perf_counter() - t0
        self.warmup_combos = n_combos
        log.info("warmup: %d shape combos in %.1fs", n_combos, wall)
        return wall

    def reconstruct(self, audio: np.ndarray) -> np.ndarray:
        """The AE round trip of the first 30 s (an audition of a prompt),
        under the device lock. The input is padded to the 30-s chunk (the
        encoder is causal, so cropping the padded output is exact).
        Returns (1, 1, whole frames) float32."""
        tts = self.tts
        spl = tts.ae_cfg.frame_length
        chunk = tts.pipe_cfg.audio_chunk_latents * spl
        audio = np.asarray(audio, np.float32)[:, :chunk]
        n = audio.shape[-1]
        n_frames = -(-n // spl)
        padded = np.pad(audio, ((0, 0), (0, chunk - n)))
        with self._device():
            rec = ae_reconstruct(tts.ae_params, tts.ae_cfg, tts.pca,
                                 torch.as_tensor(padded, device=tts.device)[:, None, :])
            rec = rec.cpu().numpy()
        return rec[:, :, :n_frames * spl]

    def health(self) -> dict:
        with self._stats_mu:
            out = {"status": "ok", "lora": self._current_lora_path, **self.stats}
        if self._lost:
            out["status"], out["lost"] = "lost", self._lost
        if self._speaker_cache is not None:
            out["speaker_cache_hits"] = self._speaker_cache.hits
            out["speaker_cache_misses"] = self._speaker_cache.misses
        if self._warmup_tail is not None:
            out["warmup_tail_running"] = self._warmup_tail.is_alive()
        if self.continuous:
            # live groups: rows in use, streams active, admissions, steps
            with self._cont_mu:
                scheds = list(self._cont_scheds.values())
            out["continuous_groups"] = [
                {"rows": s.cur_b, "active": s.n_active, "joined": s.n_joined,
                 "max_rows": s.max_b, "steps": s.n_steps}
                for s in scheds if s.thread.is_alive()]
        return out
