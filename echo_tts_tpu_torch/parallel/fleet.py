"""Executable serving-fleet driver (a copy of echo_tts_tpu/parallel/fleet.py,
pure Python, so that the port imports nothing of the JAX package):
coordinator + worker loops composing FleetCoordinator/HostHealth
(multihost.py; SURVEY.md §5.3) into the product form of BASELINE config 5 — utterance-level failure recovery for a pure-DP
synthesis fleet. The reference has no multi-process anything (SURVEY §2.2);
this is net-new, prescribed by the survey's "utterance-level retry on
preemption" design: sampling is stateless per utterance, so recovering from
a dead host is reassignment, not state transfer.

Transport is a shared directory — the natural medium for a fleet of GPU hosts
(every host mounts the same NFS/GCS path; no RPC stack to operate, and the
coordinator needs no network reachability to workers):

    fleet_dir/
      assign/<worker>.jsonl  append-only work queue per worker (coordinator
                             writes; single-line O_APPEND writes are atomic)
      beat/<worker>          heartbeat counter (worker atomically replaces;
                             the coordinator counts CONTENT changes, never
                             wall-clock mtime — clock skew between hosts
                             must not fake liveness)
      done/<id>              completion marker naming the finishing worker
      pids/<worker>          worker PID (observability; external kills)
      stop                   sentinel: drain queues and exit cleanly

Recovery invariants:
  * outputs are idempotent — result files are written to a temp name and
    os.replace'd, and re-synthesis of the same (text, seed) is
    deterministic, so a slow-but-alive worker double-finishing a
    reassigned utterance is harmless;
  * worker death is detected two ways: a stale heartbeat (the only signal
    a real multi-host fleet has) and, for coordinator-spawned local
    workers, process exit with work still pending (`procs=`);
  * orphans are reassigned round-robin to live workers, or run in the
    coordinator process when none remain (`local_run`).

Deliberately NOT built on collectives: a dead process hangs a collective,
so failure detection lives outside the SPMD layer (multihost.py docstring).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

from echo_tts_tpu_torch.parallel.multihost import FleetCoordinator, run_with_retry


class FleetPaths:
    """Layout helper for the shared fleet directory."""

    def __init__(self, root: str):
        self.root = root
        self.assign_dir = os.path.join(root, "assign")
        self.beat_dir = os.path.join(root, "beat")
        self.done_dir = os.path.join(root, "done")
        self.pid_dir = os.path.join(root, "pids")
        for d in (self.assign_dir, self.beat_dir, self.done_dir, self.pid_dir):
            os.makedirs(d, exist_ok=True)
        self.stop_file = os.path.join(root, "stop")

    def assign_file(self, worker: int) -> str:
        return os.path.join(self.assign_dir, f"{worker}.jsonl")

    def beat_file(self, worker: int) -> str:
        return os.path.join(self.beat_dir, str(worker))

    def pid_file(self, worker: int) -> str:
        return os.path.join(self.pid_dir, str(worker))

    def done_file(self, work_id: str) -> str:
        return os.path.join(self.done_dir, str(work_id))


def atomic_write(path: str, content: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(content)
    os.replace(tmp, path)


def append_assignment(paths: FleetPaths, worker: int, req: dict) -> None:
    """One JSON line per utterance; O_APPEND single-write is atomic for
    lines far below PIPE_BUF, so the worker never reads a torn line."""
    with open(paths.assign_file(worker), "a") as f:
        f.write(json.dumps(req) + "\n")


def read_assignments(path: str) -> List[dict]:
    """Tolerates a missing file and (defensively) a torn trailing line."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:  # pragma: no cover - torn tail
                break
    return out


def worker_loop(
    fleet_dir: str,
    worker_id: int,
    process_batch: Callable[[List[dict]], None],
    max_batch: int = 4,
    poll_s: float = 0.1,
    die_after: Optional[int] = None,
) -> int:
    """Worker side: poll the assignment queue, synthesize in device batches
    of up to `max_batch`, mark completions, heartbeat. Returns the number of
    utterances completed. `process_batch(items)` must write each item's
    output idempotently (temp + os.replace) — it may run twice for a
    reassigned utterance.

    die_after: fault injection — os._exit (abrupt, no cleanup: a real host
    death, not an exception) after completing that many utterances.
    """
    paths = FleetPaths(fleet_dir)
    atomic_write(paths.pid_file(worker_id), str(os.getpid()))
    beat_n = 0
    processed: set = set()

    def beat():
        nonlocal beat_n
        beat_n += 1
        atomic_write(paths.beat_file(worker_id), f"{beat_n}\n")

    beat()
    while True:
        todo = [r for r in read_assignments(paths.assign_file(worker_id))
                if r["id"] not in processed]
        if not todo:
            if os.path.exists(paths.stop_file):
                return len(processed)
            beat()  # idle is alive
            time.sleep(poll_s)
            continue
        batch = todo[:max_batch]
        beat()
        process_batch(batch)
        for r in batch:
            processed.add(r["id"])
            atomic_write(paths.done_file(r["id"]), str(worker_id))
            if die_after is not None and len(processed) >= die_after:
                os._exit(17)  # injected abrupt host death
        beat()


def coordinator_loop(
    fleet_dir: str,
    requests: Sequence[dict],
    worker_ids: Sequence[int],
    procs: Optional[Dict[int, "object"]] = None,
    stale_after_s: float = 30.0,
    poll_s: float = 0.1,
    local_run: Optional[Callable[[dict], None]] = None,
    deadline_s: float = 3600.0,
) -> FleetCoordinator:
    """Coordinator side: round-robin assignment, heartbeat observation,
    reap-and-reassign, completion tracking. Returns the FleetCoordinator
    (fleet.reassigned records every recovered utterance). Each request dict
    must carry a unique "id".

    procs: optional {worker_id: Popen-like} — a spawned worker that exits
    while its queue is non-empty is reaped immediately instead of waiting
    out the heartbeat staleness window (a real multi-host deployment passes
    nothing here and relies on beats alone).
    local_run: fallback when no live workers remain — runs one request in
    the coordinator process (with utterance-level retry).
    """
    paths = FleetPaths(fleet_dir)
    fleet = FleetCoordinator(stale_after_s)
    reqs_by_id = {str(r["id"]): r for r in requests}
    if len(reqs_by_id) != len(requests):
        raise ValueError("request ids must be unique")
    rr = 0
    for i, r in enumerate(requests):
        w = worker_ids[i % len(worker_ids)]
        append_assignment(paths, w, r)
        fleet.assign(w, str(r["id"]))
    last_beat: Dict[int, str] = {}
    dead: set = set()
    seen_done: set = set()
    deadline = time.monotonic() + deadline_s

    def complete_everywhere(wid: str) -> None:
        for h in list(fleet.assigned):
            if wid in fleet.assigned[h]:
                fleet.complete(h, wid)
        fleet.done.add(wid)

    while len(fleet.done) < len(reqs_by_id):
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"fleet did not finish within {deadline_s}s; done="
                f"{len(fleet.done)}/{len(reqs_by_id)}, dead={sorted(dead)}")
        # 1) observe heartbeats (content change = one beat)
        for w in worker_ids:
            if w in dead:
                continue
            try:
                with open(paths.beat_file(w)) as f:
                    content = f.read()
            except OSError:
                continue
            if content and content != last_beat.get(w):
                last_beat[w] = content
                fleet.observe_beat(w)
        # 2) observe completions
        try:
            done_names = os.listdir(paths.done_dir)
        except OSError:  # pragma: no cover
            done_names = []
        for name in done_names:
            if name not in seen_done and name in reqs_by_id:
                seen_done.add(name)
                complete_everywhere(name)
        # 3) a spawned worker that exited with work pending is dead NOW
        if procs:
            for w, p in procs.items():
                if (w not in dead and p.poll() is not None
                        and fleet.assigned.get(w)):
                    fleet.health.mark_dead(w)
        # 4) reap stale/dead hosts, reassign their orphans
        before = set(fleet.health.last_beat)
        orphans = fleet.reap()
        dead |= before - set(fleet.health.last_beat)
        for wid in orphans:
            if wid in fleet.done:
                continue  # finished just before its host died
            live = [w for w in worker_ids
                    if w not in dead
                    and (procs is None or procs[w].poll() is None)]
            if live:
                w = live[rr % len(live)]
                rr += 1
                append_assignment(paths, w, reqs_by_id[wid])
                fleet.assign(w, wid)
            elif local_run is not None:
                run_with_retry(lambda wid=wid: local_run(reqs_by_id[wid]))
                complete_everywhere(wid)
            else:
                raise RuntimeError(
                    f"no live workers for orphaned work {wid!r} and no "
                    f"local_run fallback")
        time.sleep(poll_s)
    atomic_write(paths.stop_file, "done\n")
    return fleet
