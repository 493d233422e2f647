"""Multi-host serving and training utilities (counterpart of
echo_tts_tpu/parallel/multihost.py).

Pure-dp sampling needs no collective; what more processes add is (a) this
rank's rows of a batch on its device, (b) barriers at bench boundaries,
(c) utterance-level retry bookkeeping. `HostHealth`, `FleetCoordinator`
and `run_with_retry` are pure Python, copied here so that the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from echo_tts_tpu_torch.parallel.sharding import batch_pspec, shard_slice


def feed_process_local_batch(mesh, batch: Any) -> Any:
    """This dp rank's rows of a global batch (a tree of numpy arrays or
    tensors, rows on axis 0, the same on every rank), as tensors on the
    mesh's device."""
    if isinstance(batch, dict):
        return {k: feed_process_local_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [feed_process_local_batch(mesh, v) for v in batch]
    x = batch if isinstance(batch, torch.Tensor) else torch.as_tensor(np.asarray(batch))
    return shard_slice(x, batch_pspec(x.dim()), mesh).to(mesh.device)


def barrier(name: str = "bench") -> None:
    """Every rank waits here (a no-op for one process). `name` is for the
    reader: torch.distributed barriers carry no tag."""
    del name
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class HostHealth:
    """Heartbeat bookkeeping for the serving fleet (SURVEY.md §5.3): each
    host stamps progress; a coordinator treats a stale stamp as failure and
    resubmits that host's utterances (sampling is stateless per utterance)."""

    def __init__(self, stale_after_s: float = 60.0):
        self.stale_after_s = stale_after_s
        self.last_beat: dict[int, float] = {}

    def beat(self, host_id: Optional[int] = None) -> None:
        if host_id is None:
            host_id = dist.get_rank() if dist.is_initialized() else 0
        self.last_beat[host_id] = time.monotonic()

    def stale_hosts(self) -> list[int]:
        now = time.monotonic()
        return [h for h, t in self.last_beat.items()
                if now - t > self.stale_after_s]

    def remove(self, host_id: int) -> None:
        """Forget a host (after its work has been reassigned)."""
        self.last_beat.pop(host_id, None)

    def mark_dead(self, host_id: int) -> None:
        """Force a host stale immediately (used when a stronger death signal
        than a missed heartbeat exists — e.g. the coordinator spawned the
        worker locally and saw its process exit with work pending)."""
        self.last_beat[host_id] = -float("inf")


class FleetCoordinator:
    """Utterance-level work distribution with failure recovery for a pure-DP
    serving fleet (SURVEY.md §5.3): sampling is stateless per utterance, so
    recovering from a dead host is reassignment, not state transfer.

    Transport-agnostic: the caller reports heartbeats however it observes
    them (RPC, shared filesystem, object store) via `observe_beat`, and
    `reap()` returns the work of hosts whose last observed beat is stale —
    the caller resubmits it (typically locally via `run_with_retry`).
    Deliberately NOT built on collectives: a dead process hangs a collective,
    so failure detection must live outside the SPMD layer (the same reason
    the reference has no recovery story to port — SURVEY.md §5.3)."""

    def __init__(self, stale_after_s: float = 30.0):
        self.health = HostHealth(stale_after_s)
        self.assigned: dict[int, set] = {}
        self.done: set = set()
        self.reassigned: list = []

    def assign(self, host_id: int, work_id) -> None:
        self.assigned.setdefault(host_id, set()).add(work_id)
        self.health.beat(host_id)  # assignment implies liveness now

    def observe_beat(self, host_id: int) -> None:
        self.health.beat(host_id)

    def complete(self, host_id: int, work_id) -> None:
        self.assigned.get(host_id, set()).discard(work_id)
        self.done.add(work_id)

    def pending(self) -> set:
        out = set()
        for ids in self.assigned.values():
            out |= ids
        return out

    def reap(self) -> list:
        """Collect the outstanding work of stale hosts and forget them.
        Returns the orphaned work ids (deterministic order) for resubmission."""
        orphans = []
        for h in self.health.stale_hosts():
            orphans.extend(sorted(self.assigned.pop(h, ()), key=repr))
            self.health.remove(h)
        self.reassigned.extend(orphans)
        return orphans


def run_with_retry(fn: Callable[[], Any], max_retries: int = 2,
                   on_failure: Optional[Callable[[Exception], None]] = None) -> Any:
    """Utterance-level retry wrapper: pure-DP work is resubmittable."""
    last: Optional[Exception] = None
    for _ in range(max_retries + 1):
        try:
            return fn()
        except Exception as e:  # pragma: no cover - device-failure path
            last = e
            if on_failure:
                on_failure(e)
    raise RuntimeError(f"failed after {max_retries + 1} attempts") from last
