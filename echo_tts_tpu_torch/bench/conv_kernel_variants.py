"""Variant ablation of the fused residual-chain kernel (K2v) at the S1-DAC
decoder's two hottest stages.

Counterpart of `scripts/bench_conv_kernel_variants.py:main`: the three-unit
chain at C=192, T=655,360 and C=96, T=1,310,720 (B=1, bf16). The script's
two rows, "poly 7-dots (prod)" and "poly packed-taps", come first; then the
rows its functions support and its history used: the snake (sin, the sin²
polynomial, none, bf16 arithmetic), `live_mode`, `tap_offsets`, the time
tile, the channels-first chain, and beside them kernel K2 (`res_units_cl`,
one launch a unit) on the same input.

    python -m echo_tts_tpu_torch.bench.conv_kernel_variants [--c192 | --c96]
    python -m echo_tts_tpu_torch.bench.conv_kernel_variants --cpu --tiny

It needs a CUDA card unless `--cpu` is given (a rehearsal through the plain
versions on the host's clock; `--tiny` shrinks T and C for it). A table goes
to stderr, one JSON line to stdout. Times are CUDA-event medians
(`bench/timing.py`), written beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from echo_tts_tpu_torch.bench.timing import bench_rows, card_line, entry_device, timing_device
from echo_tts_tpu_torch.ops.res_chain import res_units_cl
from echo_tts_tpu_torch.ops.res_chain_variants import res_chain, res_chain_cf

KS = 7
FULL_SHAPES = ((192, 655360), (96, 1310720))
TINY_SHAPES = ((16, 600),)


def make_units(gen, c: int, device, dtype=torch.bfloat16) -> list:
    """The script's units: alphas 1 + 0.1 n, weights 0.05 n, zero biases."""
    def n(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    return [{"snake1": (n(1, c, 1) * 0.1 + 1.0).to(dtype),
             "conv1": {"w": (n(c, c, KS) * 0.05).to(dtype),
                       "b": torch.zeros(c, dtype=dtype, device=device)},
             "snake2": (n(1, c, 1) * 0.1 + 1.0).to(dtype),
             "conv2": {"w": (n(c, c, 1) * 0.05).to(dtype),
                       "b": torch.zeros(c, dtype=dtype, device=device)}} for _ in range(3)]


def cl_rows(c: int):
    """(name, flags of `res_chain`) for the channels-last rows at width c."""
    tiles = {192: (48, 64), 96: (96, 176)}.get(c, ())
    return ([("poly 7-dots (prod)", dict(use_sin="poly")),
             ("poly packed-taps", dict(use_sin="poly", pack_taps=True)),
             ("sin 7-dots", dict(use_sin=True)),
             ("no-sin 7-dots", dict(use_sin=False)),
             ("sin bf16-snake", dict(use_sin=True, snake_dtype=torch.bfloat16)),
             ("poly live=mult", dict(use_sin="poly", live_mode="mult")),
             ("poly live=off", dict(use_sin="poly", live_mode="off")),
             ("poly taps@0", dict(use_sin="poly", tap_offsets=False))]
            + [(f"poly tile_t={tt}", dict(use_sin="poly", tile_t=tt)) for tt in tiles])


def cf_rows(c: int):
    """(name, flags of `res_chain_cf`) for the channels-first rows."""
    tiles = {192: (64,), 96: (192, 384)}.get(c, ())
    return ([("cf sin", dict(use_sin=True)), ("cf no-sin", dict(use_sin=False))]
            + [(f"cf sin tile_t={tt}", dict(use_sin=True, tile_t=tt)) for tt in tiles])


def run(device, shapes=FULL_SHAPES, *, file=sys.stderr) -> dict:
    res, spread = {}, {}
    before = (res_chain.launches, res_chain_cf.launches)
    print(f"# residual-chain variants on {card_line(device)}", file=file)
    for c, t in shapes:
        gen = torch.Generator(device=device).manual_seed(c)
        units = make_units(gen, c, device)
        x = torch.randn(1, t, c, generator=gen, device=device).to(torch.bfloat16)
        xcf = x.transpose(1, 2).contiguous()
        rows = [(f"c{c} {name}", lambda kw=kw: res_chain(x, units, **kw))
                for name, kw in cl_rows(c)]
        rows += [(f"c{c} {name}", lambda kw=kw: res_chain_cf(xcf, units, **kw))
                 for name, kw in cf_rows(c)]
        rows.append((f"c{c} K2 res_units_cl (3 launches)", lambda: res_units_cl(x, units)))
        out = bench_rows(rows, unit="ms/chain", device=device, file=file)
        res.update({k: round(v["ms"], 4) for k, v in out.items()})
        spread.update({k: [round(v["min_ms"], 4), round(v["max_ms"], 4)] for k, v in out.items()})
    return {"bench": "conv_kernel_variants", "device": timing_device(device),
            "card": card_line(device), "shapes": [list(s) for s in shapes], "ms": res,
            "spread_ms": spread,
            "launches": {"res_chain": res_chain.launches - before[0],
                         "res_chain_cf": res_chain_cf.launches - before[1]}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--c192", action="store_true", help="only C=192, T=655360")
    which.add_argument("--c96", action="store_true", help="only C=96, T=1310720")
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU (plain versions)")
    ap.add_argument("--tiny", action="store_true", help="small shapes, for a rehearsal")
    args = ap.parse_args(argv)
    device = entry_device(args.cpu)
    shapes = TINY_SHAPES if args.tiny else FULL_SHAPES
    if args.c192:
        shapes = tuple(s for s in shapes if s[0] == 192)
    elif args.c96:
        shapes = tuple(s for s in shapes if s[0] == 96)
    res = run(device, shapes)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
