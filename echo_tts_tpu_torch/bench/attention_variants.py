"""Variant ablation of the joint-attention kernel (K1v) at serving shapes.

Counterpart of `scripts/bench_attention_variants.py:main`: the script's
fourteen named variants of `attention_var` at G=3, B=1, H=16, S=640, D=128
with text 768 + speaker 1600 keys (or one concatenated segment of 2368),
where the script's q tiles of 320 and 640 rows are the CUDA kernel's 64 and
128. The port adds the rows the H100 asks about: the other mask forms, heads
per block, the block order, and beside them kernel K1 and one
`scaled_dot_product_attention` call at the same shape (a yardstick, timed
here and used nowhere in the port).

    python -m echo_tts_tpu_torch.bench.attention_variants [--only SUBSTR]
    python -m echo_tts_tpu_torch.bench.attention_variants --cpu --tiny

It needs a CUDA card unless `--cpu` is given (a rehearsal through the plain
versions on the host's clock; `--tiny` shrinks the shapes for it). A table
goes to stderr, one JSON line to stdout. Times are CUDA-event medians
(`bench/timing.py`), written beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from echo_tts_tpu_torch.bench.timing import bench_rows, card_line, entry_device, timing_device
from echo_tts_tpu_torch.ops.attention_variants import attention_var, mask_operand
from echo_tts_tpu_torch.ops.joint_attention import joint_attention

FULL_SHAPE = dict(g=3, b=1, h=16, s=640, d=128, t_text=768, t_spk=1600)
TINY_SHAPE = dict(g=3, b=1, h=2, s=32, d=16, t_text=48, t_spk=64)

# (name, segments, flags): the script's fourteen, then the port's own rows
VARIANTS = (
    ("2seg tq=64 bias (prod)", 2, dict(tq=64, mask_mode="bias")),
    ("2seg tq=64 bias DOTS-only", 2, dict(tq=64, mask_mode="bias", probe="dots")),
    ("2seg tq=64 bias kT", 2, dict(tq=64, mask_mode="bias", k_t=True)),
    ("2seg tq=64 bias kT DOTS-only", 2, dict(tq=64, mask_mode="bias", k_t=True, probe="dots")),
    ("2seg tq=128 bias kT", 2, dict(tq=128, mask_mode="bias", k_t=True)),
    ("2seg tq=64 bias NO-AV", 2, dict(tq=64, mask_mode="bias", probe="noav")),
    ("2seg tq=64 bias exp2", 2, dict(tq=64, mask_mode="bias", use_exp2=True)),
    ("2seg tq=128 bias", 2, dict(tq=128, mask_mode="bias")),
    ("2seg tq=128 bias exp2 (prod)", 2, dict(tq=128, mask_mode="bias", use_exp2=True)),
    ("2seg tq=128 bias exp2 FOLD", 2, dict(tq=128, mask_mode="bias", use_exp2=True,
                                           probe="fold")),
    ("2seg tq=64 bias exp2 FOLD", 2, dict(tq=64, mask_mode="bias", use_exp2=True, probe="fold")),
    ("1seg tq=128 bias exp2", 1, dict(tq=128, mask_mode="bias", use_exp2=True)),
    ("1seg tq=64 bias exp2", 1, dict(tq=64, mask_mode="bias", use_exp2=True)),
    ("1seg tq=128 bias DOTS-only", 1, dict(tq=128, mask_mode="bias", probe="dots")),
    ("2seg tq=64 where exp2", 2, dict(tq=64, mask_mode="where", use_exp2=True)),
    ("2seg tq=64 arith exp2", 2, dict(tq=64, mask_mode="arith", use_exp2=True)),
    ("2seg tq=64 none exp2", 2, dict(tq=64, mask_mode="none", use_exp2=True)),
    ("2seg tq=64 none DOTS-only", 2, dict(tq=64, mask_mode="none", probe="dots")),
    ("2seg tq=64 bias exp2 hg=2", 2, dict(tq=64, mask_mode="bias", use_exp2=True, hg=2)),
    ("2seg tq=64 bias exp2 g_outer", 2, dict(tq=64, mask_mode="bias", use_exp2=True,
                                             block_order="g_outer")),
    ("2seg tq=64 bias exp2 FOLD g_outer", 2, dict(tq=64, mask_mode="bias", use_exp2=True,
                                                  probe="fold", block_order="g_outer")),
)


def make_inputs(device, seed: int = 0, *, g, b, h, s, d, t_text, t_spk,
                dtype=torch.bfloat16) -> dict:
    """q, k_self, v_self (G, B, H, S, D), the text and speaker segments with
    the CFG masks (cond sees both; text-uncond no text; speaker-uncond no
    speaker), and the one concatenated segment, from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    q, ks, vs = rnd(g, b, h, s, d), rnd(g, b, h, s, d), rnd(g, b, h, s, d)
    kt, vt, ksp, vsp = rnd(b, h, t_text, d), rnd(b, h, t_text, d), rnd(b, h, t_spk, d), \
        rnd(b, h, t_spk, d)
    on = torch.ones
    tm = torch.stack([on(b, t_text), torch.zeros(b, t_text), on(b, t_text)]).bool().to(device)
    sm = torch.stack([on(b, t_spk), on(b, t_spk), torch.zeros(b, t_spk)]).bool().to(device)
    if g != 3:
        tm, sm = tm[:1].expand(g, b, t_text), sm[:1].expand(g, b, t_spk)
    return {"q": q, "k_self": ks, "v_self": vs,
            "segs2": [(kt, vt, tm), (ksp, vsp, sm)],
            "segs1": [(torch.cat([kt, ksp], 2), torch.cat([vt, vsp], 2), torch.cat([tm, sm], 2))]}


def variant_call(inp: dict, nseg: int, flags: dict):
    """A zero-argument call of one variant with its operands prepared outside
    the timing: masks in the mode's form, keys transposed under k_t."""
    k_t = flags.get("k_t", False)

    def key(k):
        return k.transpose(-1, -2).contiguous() if k_t else k

    mode = flags.get("mask_mode", "where")
    segs = [(key(k), v, mask_operand(m, mode)) for k, v, m in inp[f"segs{nseg}"]]
    q, ks, vs = inp["q"], key(inp["k_self"]), inp["v_self"]
    return lambda: attention_var(q, ks, vs, segs, **flags)


def reference_calls(inp: dict):
    """K1 on the same inputs (additive biases, no KV scale), and one SDPA call
    over the concatenated keys with the same bias: the yardsticks."""
    q, ks, vs = inp["q"], inp["k_self"], inp["v_self"]
    segs = [(k, v, mask_operand(m, "bias"), None) for k, v, m in inp["segs2"]]
    g, b, h, s, d = q.shape
    kc = torch.cat([ks] + [k[None].expand(g, *k.shape) for k, _, _, _ in segs], dim=3)
    vc = torch.cat([vs] + [v[None].expand(g, *v.shape) for _, v, _, _ in segs], dim=3)
    bias = torch.cat([torch.zeros(g, b, s, device=q.device)] + [m for _, _, m, _ in segs], dim=-1)
    # 4-D operands, one batch row per (branch, batch row)
    q4, k4, v4 = (x.reshape(g * b, h, -1, d) for x in (q, kc, vc))
    bias4 = bias.reshape(g * b, 1, 1, -1).to(q.dtype)
    return [("K1 joint_attention (3-branch)", lambda: joint_attention(q, ks, vs, segs, "hm")),
            ("SDPA (library yardstick)",
             lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                                      attn_mask=bias4))]


def run(device, *, only: Optional[str] = None, shape: Optional[dict] = None,
        file=sys.stderr) -> dict:
    """Time every variant whose name contains `only` (all when None)."""
    shape = dict(FULL_SHAPE if shape is None else shape)
    inp = make_inputs(device, **shape)
    tq_map = {64: min(64, shape["s"]), 128: min(128, shape["s"])}
    rows = []
    for name, nseg, flags in VARIANTS:
        if only is not None and only.lower() not in name.lower():
            continue
        rows.append((name, variant_call(inp, nseg, {**flags, "tq": tq_map[flags["tq"]]})))
    if only is None:
        rows += reference_calls(inp)
    print(f"# attention variants on {card_line(device)}; shape {shape}", file=file)
    before = attention_var.launches
    res = bench_rows(rows, unit="ms/layer", device=device, file=file)
    return {"bench": "attention_variants", "device": timing_device(device),
            "card": card_line(device), "shape": shape,
            "ms": {k: round(v["ms"], 4) for k, v in res.items()},
            "spread_ms": {k: [round(v["min_ms"], 4), round(v["max_ms"], 4)]
                          for k, v in res.items()},
            "launches": {"attention_var": attention_var.launches - before}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", help="run just the variants whose name contains this")
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU (plain versions)")
    ap.add_argument("--tiny", action="store_true", help="small shapes, for a rehearsal")
    args = ap.parse_args(argv)
    device = entry_device(args.cpu)
    res = run(device, only=args.only, shape=TINY_SHAPE if args.tiny else None)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
