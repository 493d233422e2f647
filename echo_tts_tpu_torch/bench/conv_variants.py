"""What the snake costs in the fused residual chain (K2s).

Counterpart of `scripts/bench_conv_variants.py:main`: the chain (B=1, bf16,
non-zero biases) with the snake exact (sin), none (identity: isolates the
products and the copies) and poly (a range-reduced Taylor cosine, fused
multiply-adds only), beside kernel K2 itself on the same input; and the
largest error of the polynomial snake against the exact one on [-20, 20] at
alpha 1.3. The script times C=192, T=655,360; the C=96, T=1,310,720 stage of
the same decoder tail follows it. K2s runs on the conv-core chain kernel of
K2v-cl (`csrc/res_chain_variants.cu`).

    python -m echo_tts_tpu_torch.bench.conv_variants
    python -m echo_tts_tpu_torch.bench.conv_variants --cpu --tiny

It needs a CUDA card unless `--cpu` is given (a rehearsal through the plain
versions on the host's clock; `--tiny` shrinks T and C for it). A table goes
to stderr, one JSON line to stdout. Times are device time per call over
CUDA-graph replays, as in `bench/conv_kernel_variants.py`.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from echo_tts_tpu_torch.bench.conv_kernel_variants import GRAPH_ITERS
from echo_tts_tpu_torch.bench.timing import bench_rows, card_line, entry_device, timing_device
from echo_tts_tpu_torch.ops.res_chain import res_units_cl
from echo_tts_tpu_torch.ops.res_chain_variants import SNAKE_MODES, res_chain_snake, snake_poly

FULL_SHAPE = (192, 655360)  # the script's shape
FULL_SHAPES = (FULL_SHAPE, (96, 1310720))
TINY_SHAPES = ((16, 600),)


def make_units(gen, c: int, device, dtype=torch.bfloat16) -> list:
    """The script's units: alphas uniform in [0.2, 1.5], weights 0.05 n,
    biases 0.1 n."""
    def n(*shape, s):
        return (torch.randn(*shape, generator=gen, device=device) * s).to(dtype)

    def alpha():
        return (0.2 + 1.3 * torch.rand(1, c, 1, generator=gen, device=device)).to(dtype)

    return [{"snake1": alpha(), "snake2": alpha(),
             "conv1": {"w": n(c, c, 7, s=0.05), "b": n(c, s=0.1)},
             "conv2": {"w": n(c, c, 1, s=0.05), "b": n(c, s=0.1)}} for _ in range(3)]


def poly_error(device) -> float:
    """max |snake_poly - exact snake| on [-20, 20] at alpha 1.3, fp32."""
    xs = torch.linspace(-20.0, 20.0, 200001, dtype=torch.float32, device=device)
    a = torch.tensor(1.3, device=device)
    exact = xs + (1.0 / (a + 1e-9)) * torch.square(torch.sin(a * xs))
    return float((snake_poly(xs, a) - exact).abs().max())


def run(device, shapes=FULL_SHAPES, *, file=sys.stderr) -> dict:
    res, spread = {}, {}
    before = res_chain_snake.launches
    print(f"# snake variants on {card_line(device)}", file=file)
    for c, t in shapes:
        gen = torch.Generator(device=device).manual_seed(0)
        units = make_units(gen, c, device)
        x = torch.randn(1, t, c, generator=gen, device=device).to(torch.bfloat16)
        rows = [(f"res chain C={c} snake={mode}",
                 lambda mode=mode: res_chain_snake(x, units, mode)) for mode in SNAKE_MODES]
        rows.append((f"res chain C={c} K2 res_units_cl (3 launches)",
                     lambda: res_units_cl(x, units)))
        out = bench_rows(rows, unit="ms", device=device, file=file, graph_iters=GRAPH_ITERS)
        res.update({k: round(v["ms"], 4) for k, v in out.items()})
        spread.update({k: [round(v["min_ms"], 4), round(v["max_ms"], 4)] for k, v in out.items()})
    err = poly_error(device)
    print(f"poly snake max abs err on [-20,20], a=1.3: {err:.3e}", file=file)
    return {"bench": "conv_variants", "device": timing_device(device), "card": card_line(device),
            "shapes": [list(s) for s in shapes], "ms": res, "spread_ms": spread,
            "poly_err": err, "launches": {"res_chain_snake": res_chain_snake.launches - before}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU (plain versions)")
    ap.add_argument("--tiny", action="store_true", help="small shapes, for a rehearsal")
    args = ap.parse_args(argv)
    res = run(entry_device(args.cpu), TINY_SHAPES if args.tiny else FULL_SHAPES)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
