"""Runs one benchmark cell once and prints its result as the last line of
standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, output-check limits and metric
readers are found by name from BENCHMARK.json (benchmark/harness/registry.py).
Set-up makes the weights from the seed on the card and warms the cell's
shapes; the window then drives the program for --seconds; the outputs are
checked against the plain float32 reference once the program is gone.
With --trace 1 a slice of the window is profiled and the cell's per-layer
metrics are reported instead of its end-to-end ones.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class Ctx:
    """What a runner gets: the cell's parts and the run's arguments."""

    def __init__(self, cell, args, device, t_proc):
        self.cell = cell
        self.config, self.traffic, self.limits = cell.config, cell.traffic, cell.limits
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.device, self.t_proc = device, t_proc


def _env(root: str) -> None:
    # keep libraries from loading JAX or Flax behind the program's back, and
    # every compile cache in the checkout, at fixed paths
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    cache = os.path.join(root, "build", "benchmark_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))


def main(argv=None, root: str = ROOT, device=None, tweak=None, out=sys.stdout) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env(root)

    from benchmark.harness.card import forbidden_modules, power_limit
    from benchmark.harness.registry import Cell

    cell = Cell(args.workload, root)
    if tweak is not None:
        tweak(cell)
    import torch

    if device is None:
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"this cell needs {chips} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    ctx = Ctx(cell, args, device, T_PROC)
    rec = cell.runner().run(ctx)

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3

    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        v = cell.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = rec["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device == "cuda" else str(device),
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else str(device),
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(rec.get("memory_peak_bytes", 0))}
    line = {"correct": bool(correct), "attempted": int(rec["attempted"]),
            "failed": int(rec["failed"]), "metrics": metrics, "device": dev}
    if args.trace and rec.get("trace"):
        tr = rec["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["card"] = power_limit() if device == "cuda" else "cpu"
    line["checks"] = checks
    for k, v in rec.get("notes", {}).items():
        print(f"# {k}: {v}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
