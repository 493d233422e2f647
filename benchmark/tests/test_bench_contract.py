"""BENCHMARK.json keeps to its schema, and every name in it finds its
files: configuration, traffic mix, output-check limits, metric reader."""
from __future__ import annotations

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads", "bound"}


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == json.load(open(os.path.join(ROOT, c["file"])))["reduced"] == []
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200


def test_workloads_find_their_files():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        t = json.load(open(os.path.join(ROOT, "benchmark", "traffic", f"{w['traffic']}.json")))
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "runners", f"{t['runner']}.py"))
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "limits", f"{w['name']}.json"))


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        assert set(m) <= METRIC_KEYS and NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert "bound" not in m and m["moves"] in e2e
            assert 1 <= len(m["layer"]) <= 200
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            moved = [x for x in BENCH["end_to_end"] if x["name"] == m["moves"]][0]
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]["bound"] <= 0.25


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for kind in ("batch", "stream", "train"):
        assert any(m["name"] == f"mfu_pct.{kind}" for m in BENCH["per_layer"])
