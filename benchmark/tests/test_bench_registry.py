"""The harness is driven by data: a cell, a traffic mix and a metric come
from new files and new entries alone. And a run refuses to report when JAX
or the JAX package is loaded in its process."""
from __future__ import annotations

import io
import json
import os
import shutil
import sys
import types

import pytest

from benchmark import run
from benchmark.harness.card import forbidden_modules
from benchmark.tests.test_bench_run import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_a_cell_from_new_files_alone(tmp_path):
    """Copy the benchmark, then add a traffic mix (a data file), its cell's
    limits, a metric reader and the entries naming them; the harness runs
    the new cell and reports the new metric, and no existing file changed."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: open(p, "rb").read() for p in map(str, root.rglob("*")) if os.path.isfile(p)}

    base = json.load(open(root / "benchmark" / "traffic" / "closed16-oneshot-640.json"))
    base.update(clients=4, text_bytes=[300, 700], fresh_every=0)
    (root / "benchmark" / "traffic" / "closed4-long-text.json").write_text(json.dumps(base))
    (root / "benchmark" / "limits" / "oneshot-b8-closed4-long.json").write_text(
        (root / "benchmark" / "limits" / "oneshot-b8-closed16.json").read_text())
    (root / "benchmark" / "metrics" / "requests_done.py").write_text(
        '"""Requests the window completed."""\n\n\ndef read(rec):\n'
        '    return rec["attempted"] - rec["failed"]\n')
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["workloads"].append({"name": "oneshot-b8-closed4-long",
                               "config": "echo-tts-base-oneshot",
                               "traffic": "closed4-long-text", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["oneshot-b8-closed4-long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = io.StringIO()
    rc = run.main(["--workload", "oneshot-b8-closed4-long", "--seed", "5", "--seconds", "1",
                   "--trace", "0"], root=str(root), device="cpu", tweak=tiny, out=out)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"]
    assert line["metrics"]["requests_done"]["value"] >= 4
    assert "batch_audio_s_per_s" not in line["metrics"]
    for p, data in before.items():
        if not p.endswith("BENCHMARK.json"):
            assert open(p, "rb").read() == data, p


@pytest.mark.parametrize("name,bad", [("jax", True), ("jaxlib.xla", True), ("flax", True),
                                      ("echo_tts_tpu", True), ("echo_tts_tpu.models.dit", True),
                                      ("echo_tts_tpu_torch.models.dit", False),
                                      ("jax_like_but_not", False)])
def test_forbidden_modules_by_whole_top_level_name(name, bad, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in forbidden_modules()) == bad


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    out = io.StringIO()
    rc = run.main(["--workload", "oneshot-b8-closed16", "--seed", "3", "--seconds", "0.5",
                   "--trace", "0"], device="cpu", tweak=tiny, out=out)
    assert rc != 0 and out.getvalue() == ""


def test_without_a_card_a_run_prints_no_result(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    rc = run.main(["--workload", "oneshot-b8-closed16", "--seed", "3", "--seconds", "1",
                   "--trace", "0"], out=out)
    assert rc != 0 and out.getvalue() == ""


@pytest.mark.parametrize("workload,metric", [("oneshot-b8-closed16", "mfu_pct.batch"),
                                             ("stream-b8-closed8", "mfu_pct.stream"),
                                             ("stream-b8-closed8", "ttfa_p50_s.stream"),
                                             ("lora-r16-b8", "mfu_pct.train"),
                                             ("lora-r16-b8", "data_wait_pct.train")])
def test_host_clock_metrics_skip_the_traced_slice(workload, metric):
    """The profiler stalls the host from the slice's start to the end of its
    stop: a traced run's host-clock metrics read only what ended before the
    slice, so work inside and after it moves nothing."""
    from benchmark.harness.registry import Cell

    read = Cell(workload, ROOT).reader(metric)

    def rec(late: float):
        # (start, end, operations, wait) items: three before the slice at
        # t = 10, two that a stalled host stretched by `late`
        work = [(0.0, 3.0, 3e15, 0.1), (3.0, 6.0, 3e15, 0.1), (6.0, 9.0, 3e15, 0.1),
                (9.0, 14.0 + late, 3e15, 0.1 + late), (14.0 + late, 17.0 + late, 3e15, 0.1)]
        return {"t0": 0.0, "work": work, "ttfa": [(s, s + 1.0 + (late if s >= 9 else 0))
                                                   for s, *_ in work],
                "trace": {"host_from": 10.0, "host_to": 14.0}}

    a, b = read(rec(0.0)), read(rec(4.0))
    assert a is not None and a > 0 and a == b
    # an untraced record reads all of its work
    assert read(dict(rec(4.0), trace=None)) is not None
