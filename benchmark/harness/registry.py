"""Finds a cell's parts by the names in BENCHMARK.json: the configuration
file, the traffic file `benchmark/traffic/<traffic>.json` (whose "runner"
names `benchmark/runners/<runner>.py`), the limits of its output check
`benchmark/limits/<workload>.json`, and each metric's reader
`benchmark/metrics/<metric>.py`. A cell, a mix or a metric is added by
adding such files and entries; no file here names one."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    def __init__(self, workload: str, root: str = ROOT):
        self.root = root
        self.bench = _json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in self.bench["workloads"] if w["name"] == workload]
        if not found:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = found[0]
        conf = [c for c in self.bench["configs"] if c["name"] == self.workload["config"]][0]
        self.config = _json(os.path.join(root, conf["file"]))
        self.traffic = _json(os.path.join(root, "benchmark", "traffic",
                                          f"{self.workload['traffic']}.json"))
        self.limits = _json(os.path.join(root, "benchmark", "limits", f"{workload}.json"))

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, traced: bool) -> List[dict]:
        """The metrics this cell reports: its end-to-end metrics untraced,
        its per-layer metrics traced."""
        pool = self.bench["per_layer"] if traced else self.bench["end_to_end"]
        return [m for m in pool if self.name in m.get("workloads", [self.name])]

    def runner(self):
        return importlib.import_module(f"benchmark.runners.{self.traffic['runner']}")

    def reader(self, metric: str) -> Callable[[Dict], object]:
        path = os.path.join(self.root, "benchmark", "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
