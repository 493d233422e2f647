"""The output check's control, at a cell's own size: the float32 reference
with every product's operands rounded to float8 (the nearest precision
below the bfloat16 the configurations state) put in the program's place,
compared as a run compares the program. Prints, per seed, each number the
cell compares with its limit; a sound check reads every seed as failing.
`--precision fp8-dit` rounds the DiT's products alone (the codec stays in
float32): the reading the serving cells' latent number is held against.

    python3 benchmark/control/precision.py --workload <name> --seeds 1 2 3
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(argv=None, root=ROOT, device="cuda", tweak=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", default="fp8", choices=("fp32", "fp8", "fp8-dit"))
    args = ap.parse_args(argv)
    from benchmark.harness.registry import Cell
    from benchmark.run import Ctx

    cell = Cell(args.workload, root)
    if tweak is not None:
        tweak(cell)
    out = []
    for seed in args.seeds:
        a = argparse.Namespace(seed=seed, seconds=0, trace=0)
        t0 = time.perf_counter()
        checks = cell.runner().control(Ctx(cell, a, device, t0), args.precision)
        line = {"workload": args.workload, "seed": seed, "precision": args.precision,
                "failed_any": any(c["value"] > c["limit"] for c in checks.values()),
                "checks": checks, "seconds": round(time.perf_counter() - t0, 2)}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    main()
