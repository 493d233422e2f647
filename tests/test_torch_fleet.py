"""The port's fleet (echo_tts_tpu_torch/parallel/fleet.py, multihost.py and
the fleet mode of echo_tts_tpu_torch.scripts.batch_synthesize): real worker
processes doing tiny-model synthesis on the CPU with one killed mid-run,
byte-equal to one process; the coordinator's transport drill with threads
as workers; the kill-a-host drill of HostHealth/FleetCoordinator. The
drills are the JAX package's tests (tests/test_fleet_driver.py,
tests/test_multihost_distributed.py) on the port's copies. No JAX here."""
import json
import os
import subprocess
import sys
import time

import pytest

from echo_tts_tpu_torch.scripts import batch_synthesize

REQS = [
    {"id": "a", "text": "Fleet item one.", "speaker": None, "seed": 1},
    {"id": "b", "text": "Fleet item two.", "speaker": None, "seed": 2},
    {"id": "c", "text": "Fleet item three.", "speaker": None, "seed": 3},
    {"id": "d", "text": "Fleet item four.", "speaker": None, "seed": 4},
]
# --max-batch 1: every utterance its own B=1 call, so the bytes do not depend
# on how the fleet groups them
COMMON = ["--random-tiny", "--cpu", "--max-batch", "1", "--num-steps", "2",
          "--sequence-length", "16"]


def test_fleet_kill_a_worker_completes_identically(tmp_path, capsys):
    """The coordinator starts two worker processes; worker 1 exits abruptly
    after its first utterance. Its unfinished work goes to worker 0 and
    every WAV equals the one-process run's byte for byte."""
    inp = tmp_path / "reqs.jsonl"
    inp.write_text("\n".join(json.dumps(r) for r in REQS))
    ref_dir, fleet_dir = tmp_path / "ref", tmp_path / "fleet"
    batch_synthesize.main(["--input", str(inp), "--outdir", str(ref_dir)] + COMMON)
    capsys.readouterr()
    summary = batch_synthesize.main(
        ["--input", str(inp), "--outdir", str(fleet_dir), "--workers", "2",
         "--worker-die-after", "1:1", "--stale-after-s", "120"] + COMMON)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["files"] == len(REQS) and summary["workers"] == 2
    assert summary["dead_workers"] == [1] and summary["reassigned"] >= 1
    for r in REQS:
        ref = (ref_dir / (r["id"] + ".wav")).read_bytes()
        assert (fleet_dir / (r["id"] + ".wav")).read_bytes() == ref, r["id"]
    assert (fleet_dir / "_fleet" / "stop").exists()


def test_fleet_flags_are_checked(tmp_path):
    with pytest.raises(SystemExit):
        batch_synthesize.build_args(["--outdir", str(tmp_path), "--worker-id", "0",
                                     "--random-tiny"])
    with pytest.raises(SystemExit):
        batch_synthesize.build_args(["--outdir", str(tmp_path), "--random-tiny"])
    args = batch_synthesize.build_args(["--outdir", str(tmp_path), "--worker-id", "1",
                                        "--fleet-dir", "f", "--random-tiny"])
    assert args.worker_id == 1 and args.stale_after_s == 30.0


def test_coordinator_reassigns_without_procs(tmp_path):
    """Transport-level drill (no model, no subprocesses): coordinator_loop
    driven purely by heartbeat files — a worker that stops beating with
    work pending is reaped on staleness alone (the only signal a real
    multi-host fleet has) and its work lands on the survivor."""
    import threading
    import time

    from echo_tts_tpu_torch.parallel.fleet import (
        FleetPaths, atomic_write, coordinator_loop, read_assignments)

    fleet_dir = str(tmp_path / "fleet")
    paths = FleetPaths(fleet_dir)
    reqs = [{"id": f"w{i}"} for i in range(6)]
    stop = threading.Event()

    def fake_worker(wid, die_after=None, delay=0.05):
        n, done = 0, set()
        while not stop.is_set():
            atomic_write(paths.beat_file(wid), f"{n}\n")
            n += 1
            todo = [r for r in read_assignments(paths.assign_file(wid))
                    if r["id"] not in done]
            for r in todo:
                time.sleep(delay)
                atomic_write(paths.done_file(r["id"]), str(wid))
                done.add(r["id"])
                if die_after is not None and len(done) >= die_after:
                    return  # stops beating — looks dead to the coordinator
            if os.path.exists(paths.stop_file):
                return
            time.sleep(0.02)

    threads = [threading.Thread(target=fake_worker, args=(0,)),
               threading.Thread(target=fake_worker, args=(1, 1))]
    for t in threads:
        t.start()
    try:
        fleet = coordinator_loop(fleet_dir, reqs, [0, 1],
                                 stale_after_s=0.5, poll_s=0.02,
                                 deadline_s=60.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert fleet.done == {r["id"] for r in reqs}
    assert len(fleet.reassigned) >= 1
    done_by = {r["id"]: (paths.root and open(paths.done_file(r["id"])).read())
               for r in reqs}
    # every reassigned utterance was finished by the surviving worker 0
    for wid in fleet.reassigned:
        if wid in done_by:
            assert done_by[wid] == "0"


def test_kill_a_host_detected_and_recovered(tmp_path):
    """Fault injection (SURVEY.md §5.3): host 1 is a real subprocess that
    heartbeats through the shared filesystem, completes part of its work,
    and dies mid-assignment. The coordinator detects the stale heartbeat
    (HostHealth), reaps the orphaned utterances (FleetCoordinator), and
    resubmits them locally (run_with_retry) — pure-DP sampling is stateless
    per utterance, so recovery is resubmission."""
    from echo_tts_tpu_torch.parallel.multihost import FleetCoordinator, run_with_retry

    beats = tmp_path / "beats"
    done_dir = tmp_path / "done"
    beats.mkdir()
    done_dir.mkdir()

    worker_code = f"""
import os, time
beats = {str(beats)!r}; done = {str(done_dir)!r}
for i in range(5):  # heartbeat; complete work 4 and 5; then die
    open(os.path.join(beats, "1"), "w").write(f"beat-{{i}}")
    if i in (1, 2):
        open(os.path.join(done, str(3 + i)), "w").write("ok")
    time.sleep(0.05)
os._exit(1)  # abrupt death mid-assignment (work 6, 7 orphaned)
"""
    fleet = FleetCoordinator(stale_after_s=0.8)
    results = {}

    def local_run(work_id):
        results[work_id] = work_id * 10  # stands in for sample_pipeline
        return results[work_id]

    # host 0 = this process; host 1 = the flaky subprocess. Its work is
    # assigned only once it is observed ALIVE (first heartbeat) — otherwise
    # a slow process start is indistinguishable from death and the test
    # races its own staleness window.
    for w in (0, 1, 2, 3):
        fleet.assign(0, w)
    proc = subprocess.Popen([sys.executable, "-c", worker_code])
    start_deadline = time.monotonic() + 20
    while not (beats / "1").exists():
        assert time.monotonic() < start_deadline, "worker never started"
        time.sleep(0.02)
    for w in (4, 5, 6, 7):
        fleet.assign(1, w)

    for w in (0, 1, 2, 3):  # host 0 does its own work
        local_run(w)
        fleet.complete(0, w)
        fleet.observe_beat(0)

    seen_done = set()
    last_beat_content = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        b = beats / "1"
        if b.exists():
            content = b.read_text()
            if content != last_beat_content:  # only NEW beats count
                last_beat_content = content
                fleet.observe_beat(1)
            for f in done_dir.iterdir():  # observe each completion once
                w = int(f.name)
                if w not in seen_done:
                    seen_done.add(w)
                    fleet.complete(1, w)
        fleet.observe_beat(0)
        orphans = fleet.reap()
        if orphans:
            # only the dead host 1 is reaped; host 0 keeps beating
            assert 0 in fleet.health.last_beat
            for w in orphans:  # resubmit locally
                run_with_retry(lambda w=w: local_run(w))
                fleet.complete(0, w)
        if not fleet.pending():
            break
        time.sleep(0.05)
    proc.wait(timeout=10)

    assert fleet.done == {0, 1, 2, 3, 4, 5, 6, 7}
    assert set(fleet.reassigned) == {6, 7}, fleet.reassigned
    assert results[6] == 60 and results[7] == 70
    # host 1 was forgotten after the reap; host 0 is still healthy
    assert 1 not in fleet.health.last_beat
    assert fleet.health.stale_hosts() == []
