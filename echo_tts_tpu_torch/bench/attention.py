"""Micro-bench of the joint-attention kernel K1 at serving shapes.

Counterpart of `scripts/bench_attention.py:main`, at G=3, B=1, H=16, S=640,
D=128 with text 768 + speaker 1600 keys and the CFG masks: (1) K1 on the
three-branch call; (2) per-branch calls with exact segment sets (the uncond
branches mask a whole segment; computing then discarding it is wasted work);
(3) the plain PyTorch version, where the script had the XLA einsum. One
`scaled_dot_product_attention` call on the same inputs is timed beside them
as the library yardstick and is used nowhere in the port.

    python -m echo_tts_tpu_torch.bench.attention
    python -m echo_tts_tpu_torch.bench.attention --cpu --tiny

It needs a CUDA card unless `--cpu` is given (a rehearsal through the plain
version on the host's clock; `--tiny` shrinks the shapes for it). A table
goes to stderr, one JSON line to stdout.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from echo_tts_tpu_torch.bench.attention_variants import (
    FULL_SHAPE,
    TINY_SHAPE,
    make_inputs,
    reference_calls,
)
from echo_tts_tpu_torch.bench.timing import bench_rows, card_line, entry_device, timing_device
from echo_tts_tpu_torch.ops.attention_variants import mask_operand
from echo_tts_tpu_torch.ops.joint_attention import joint_attention, joint_attention_plain


def run(device, shape: Optional[dict] = None, *, file=sys.stderr) -> dict:
    shape = dict(FULL_SHAPE if shape is None else shape)
    inp = make_inputs(device, **shape)
    q, ks, vs = inp["q"], inp["k_self"], inp["v_self"]
    (kt, vt, tm), (ksp, vsp, sm) = inp["segs2"]
    tb, sb = mask_operand(tm, "bias"), mask_operand(sm, "bias")
    out = torch.empty_like(q)

    def per_branch():
        joint_attention(q[0:1], ks[0:1], vs[0:1], [(kt, vt, tb[0:1], None),
                                                   (ksp, vsp, sb[0:1], None)], "hm",
                        out=out[0:1])
        joint_attention(q[1:2], ks[1:2], vs[1:2], [(ksp, vsp, sb[0:1], None)], "hm",
                        out=out[1:2])
        joint_attention(q[2:3], ks[2:3], vs[2:3], [(kt, vt, tb[0:1], None)], "hm", out=out[2:3])
        return out

    base, sdpa = reference_calls(inp)
    rows = [("base kernel", base[1]), ("per-branch exact segments", per_branch),
            ("plain PyTorch", lambda: joint_attention_plain(
                q, ks, vs, [(kt, vt, tb, None), (ksp, vsp, sb, None)], "hm")),
            sdpa]
    before = joint_attention.launches
    print(f"# joint attention on {card_line(device)}; shape {shape}", file=file)
    res = bench_rows(rows, unit="ms/layer", device=device, file=file)
    return {"bench": "attention", "device": timing_device(device), "card": card_line(device),
            "shape": shape, "ms": {k: round(v["ms"], 4) for k, v in res.items()},
            "spread_ms": {k: [round(v["min_ms"], 4), round(v["max_ms"], 4)]
                          for k, v in res.items()},
            "launches": {"joint_attention": joint_attention.launches - before}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU (plain version)")
    ap.add_argument("--tiny", action="store_true", help="small shapes, for a rehearsal")
    args = ap.parse_args(argv)
    res = run(entry_device(args.cpu), TINY_SHAPE if args.tiny else None)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
