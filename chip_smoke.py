#!/usr/bin/env python3
"""Start the PyTorch port (echo_tts_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel checks + kernel times
    python3 chip_smoke.py --slices-only   # phases 1, 5 and 6 only (K1, K2, K3 built)

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), torch/CUDA/nvcc versions;
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel),
     with each source's build seconds and ptxas' registers and spills; a
     kernel whose wgmma ptxas serialised (C7512/C7514) is flagged;
  3. TF32 off for the comparisons; the attention kernels' shared wgmma core
     (csrc/attention_core.cuh) on one bare tile against torch.matmul, keys
     as (T, D) and as (D, T); the residual-unit kernels' conv core
     (csrc/conv_core.cuh) on one bare tile, the tap-shifted product at
     d = 1, 3, 9 and row offsets that are no multiple of 8;
  4. each kernel against its plain PyTorch version at main-path shapes, bf16
     inputs, rel-L2 < 2e-2 (bf16 rounding gives ~1e-3, a wrong kernel O(1)):
     K1 forward (full and ragged shapes, both q tiles, its log-sum-exp), K2
     residual units at all eight widths of the S1-DAC stacks (ragged T,
     zero_below scalar and per row), K3 attention backward (each gradient, at the training
     shape and one past its tiles' edges, both layouts, through autograd);
     then every instance of the measurement variants that the bench entry
     points use (K1v attention_var, K2v-cl res_chain, K2v-cf res_chain_cf,
     K2s res_chain_snake) at the full shapes and at a ragged one, K2v-cf
     against K2v-cl on the transposed input (at both widths, with T a
     multiple of 8 and not), and K2s poly against exact;
  5. the one-shot slice at the full width of DiTConfig(has_latent_modules=
     False) and AEConfig() in bf16, random weights from a seed: one CFG
     forward and one decode through the kernels against the plain versions;
     sample_pipeline on three requests, with per-stage wall times and
     launch counts of each kernel (K2 exactly one a unit); torch.profiler
     passes over one more request and over the 20 s prompt's speaker
     encode; the host cost of the seeded noise draw;
  6. the training slice on the same weights: 16 synthetic 29.72 s clips
     written to WAV, pre-encoded by EchoTTSDataset (K2; a torch.profiler
     pass over the pre-encode once more), LoRA r16/alpha32
     steps at B=8 (K1 forward and recompute, K3 backward), one warm-up and
     three timed, with exact launch counts; a torch.profiler pass over one
     more step; the LoRA gradient at B=1 through K1+K3 against the plain
     attention under autograd;
  7. the measurement path: the entry points of echo_tts_tpu_torch/bench/
     (attention_variants, conv_kernel_variants, conv_variants, attention,
     profile_breakdown) at their full shapes, each printing its JSON line,
     with the launch counts set to 0 before each and read after it;
  8. kernel times (CUDA events, median of 7 after warm-up; for the attention
     kernels, K3 and its SDPA-backward yardstick included, over replays of a
     CUDA graph of 20 launches) beside the plain
     version, one library call where one exists, and the bound, for K1 (at
     the one-branch, the three-branch and the training shape, with both q
     tiles, and the wrapper's host microseconds per launch), K2 (a chain at
     each decoder and encoder width, beside the cuDNN composition of the
     same chain), K3, K1v, K2v-cl, K2v-cf and K2s (over replays of a graph
     of 3 chains, and call by call as well: the wrappers' host work to pack
     the weights is then included, as in the readings before); and K2v-cf
     against K2v-cl (sin) timed in turns at both widths of the entry point.
The line before the last is the kernel JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX. --slices-only is for
comparing two trees end to end in one call on one card (run them in turns:
the host's clock moves more between calls than a kernel change moves it); it
prints no kernel JSON. The build of the seven sources runs in parallel;
ptxas serialising a wgmma of K2 or of the chain kernel of K2v-cl, K2v-cf and
K2s (C7512/C7514) fails the run.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor core, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
REL_L2_BOUND = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    # float64: the `dots` probe under an additive mask carries values near
    # 1e21, whose squares overflow float32
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phase 1-3
# ---------------------------------------------------------------------------


def phase_environment():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    from echo_tts_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"# card: {smi}")
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}")
    return smi


PTXAS: dict = {}  # source -> kernel -> registers, spill bytes, wgmma serialized (phase 2)
SERIALIZED = ("C7512", "C7514")  # ptxas: "wgmma.mma_async instructions are serialized"
SERIAL_FREE = ("res_chain", "res_chain_variants")  # must show none: the run fails


def _kernel_name(mangled: str) -> str:
    """kernel<its integer and bool template arguments>: joint_attention_kernel<2>,
    res_chain_cl_kernel<192, 0> (width, snake code), dq_kernel."""
    m = re.search(r"\d+([a-z][a-z_]*_kernel)", mangled)
    if m is None:
        return mangled
    rest = mangled[m.end():]
    args = re.findall(r"L[ib](\d+)E", rest.split("Ev", 1)[0]) if rest.startswith("I") else []
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def parse_ptxas(text: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads", "serialized"}}
    from the `-Xptxas -v` output of one source."""
    out, cur = {}, None
    for line in text.splitlines():
        quoted = re.search(r"'(_Z\w+)'", line) or re.search(r"properties for (_Z\w+)", line)
        if quoted:
            name = _kernel_name(quoted.group(1))
            out.setdefault(name, {"registers": None, "spill_stores": 0, "spill_loads": 0,
                                  "serialized": False})
            if any(c in line for c in SERIALIZED):
                out[name]["serialized"] = True
            else:
                cur = name
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur]["spill_stores"], out[cur]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    return out


def phase_build(names=None):
    from echo_tts_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all(_build.KERNELS if names is None else names)
    log(f"# built {sorted(paths)} in {time.perf_counter() - t0:.1f} s; nvcc seconds per source: "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(_build.BUILD_SECONDS.items())))
    for name in paths:
        ptxas = _build.BUILD_DIR / f"{name}.ptxas.txt"
        if ptxas.exists():
            text = ptxas.read_text()
            for line in text.splitlines():
                if any(w in line for w in ("registers", "spill", "warning", "Performance Loss")):
                    log(f"#   {name}: {line.strip()}")
            PTXAS[name] = parse_ptxas(text)
            for kernel, info in PTXAS[name].items():
                if info["serialized"]:
                    log(f"# FLAG {name}: ptxas serialised the wgmma of {kernel} "
                        f"({'/'.join(SERIALIZED)}): the kernel lost its overlap; fix it before "
                        f"timing anything")
                    if name in SERIAL_FREE:
                        raise SystemExit(f"{name}.cu: ptxas serialised the wgmma of {kernel}")


def phase_core_check(dev) -> None:
    """The shared core of K1 and K1v on one bare tile, before anything is
    built on it: s = a.b^T (fp32 sums of exact bf16 products: rel-L2 < 1e-5
    against torch.matmul) and o = bf16(s * c).v through the register A
    operand (rel-L2 < 5e-3: a weight on a bf16 rounding edge may round the
    other way), with b as (64, 128) and as its transpose (128, 64), a from
    shared memory and from registers; then an identity v, which returns the
    weights where the fragment layout puts them."""
    from echo_tts_tpu_torch.ops import attention_core as ac

    gen = torch.Generator(device=dev).manual_seed(4)
    a, b, v = (torch.randn(64, 128, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    eye = torch.zeros(64, 128, device=dev, dtype=torch.bfloat16)
    eye[:, :64] = torch.eye(64, device=dev)
    failures = []
    for b_transposed in (False, True):
        bb = b.t().contiguous() if b_transposed else b
        for a_regs in (False, True):
            for what, vv in (("random v", v), ("identity v", eye)):
                got_s, got_o = ac.core_products(a, bb, vv, 0.05, b_transposed, a_regs)
                torch.cuda.synchronize()
                ref_s, ref_o = ac.core_products_plain(a, bb, vv, 0.05, b_transposed)
                rs, ro = rel_l2(got_s, ref_s), rel_l2(got_o, ref_o)
                log(f"# check attention_core [b {'(D, T)' if b_transposed else '(T, D)'}, a from "
                    f"{'registers' if a_regs else 'shared memory'}, {what}]: "
                    f"q.k^T rel-L2 {rs:.3e}, p.v rel-L2 {ro:.3e}")
                if not (rs < 1e-5 and ro < 5e-3):
                    failures.append(f"b_transposed={b_transposed} a_regs={a_regs} {what}: "
                                    f"{rs:.3e}, {ro:.3e}")
    if failures:
        raise SystemExit("the wgmma core disagrees with torch.matmul: " + "; ".join(failures))


def phase_conv_core_check(dev) -> None:
    """The conv core of K2 and K2v-cl on one bare tile, before either is
    checked or timed: sum_j y[row0 + j d : row0 + j d + 64] . W[j] from the
    strip window, the bulk-copied weight ring and the shifted descriptors,
    at every product width the core has, d = 1, 3, 9 and row offsets 0, 5
    and 13 (no multiple of 8), against torch.matmul: fp32 sums of exact bf16
    products, rel-L2 < 1e-5."""
    from echo_tts_tpu_torch.ops import conv_core as cc

    gen = torch.Generator(device=dev).manual_seed(6)
    worst, failures = 0.0, []
    for n in cc.CHECK_N:
        for d in (1, 3, 9):
            for row0 in (0, 5, 13):
                y = torch.randn(row0 + 64 + 6 * d + 3, cc.CHECK_K, generator=gen,
                                device=dev).to(torch.bfloat16)
                w = torch.randn(7, cc.CHECK_K, n, generator=gen, device=dev).to(torch.bfloat16)
                got = cc.tap_product(y, w, row0, d)
                torch.cuda.synchronize()
                r = rel_l2(got, cc.tap_product_plain(y, w, row0, d))
                worst = max(worst, r)
                if not r < 1e-5:
                    failures.append(f"N={n} d={d} row0={row0}: {r:.3e}")
    log(f"# check conv_core [tap-shifted product, N {cc.CHECK_N}, d 1/3/9, row offsets 0/5/13]: "
        f"worst rel-L2 {worst:.3e}")
    if failures:
        raise SystemExit("the conv core disagrees with torch.matmul: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------


def _k1_inputs(gen, g, s, h, seg_lens, dev, spk_scale=1.5, all_masked=(), b=1):
    """seq-major q/k/v (G, B, S, H, 128) and head-major segments, bf16."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = (rnd(g, b, s, h, 128) for _ in range(3))
    segs = []
    for i, t in enumerate(seg_lens):
        mask = torch.rand(g, b, t, generator=gen, device=dev) < 0.8
        if i in all_masked:
            mask = torch.zeros_like(mask)
        scale = spk_scale if i == len(seg_lens) - 1 else None
        segs.append((rnd(b, h, t, 128), rnd(b, h, t, 128), mask, scale))
    return q, k, v, segs


def k1_lse_plain(q, k, v, segs, layout, self_len=None):
    """Each query row's base-2 log-sum-exp of K1's logits, fp32 (G, B, H, S)."""
    qh, kh = ((x.transpose(2, 3) if layout == "sm" else x).float() for x in (q, k))
    c = 1.0 / math.sqrt(qh.shape[-1])
    l_self = torch.einsum("gbhsd,gbhtd->gbhst", qh, kh) * c
    if self_len is not None:
        keep = torch.arange(kh.shape[3], device=q.device)[None] < self_len[:, None]
        l_self = l_self + torch.where(keep, 0.0, -1e30)[None, :, None, None, :]
    logits = [l_self]
    for kk, _, m, sc in segs:
        l_seg = torch.einsum("gbhsd,bhtd->gbhst", qh, kk.float()) * c * (1.0 if sc is None else sc)
        logits.append(l_seg + torch.where(m, 0.0, -1e30)[:, :, None, None, :])
    return torch.logsumexp(torch.cat(logits, -1), -1) * math.log2(math.e)


def f32_segments(segs):
    return [(k.float(), v.float(), m, sc) for k, v, m, sc in segs]


def f32_units(units):
    return [{k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
                 else v.float()) for k, v in u.items()} for u in units]


def _k3_inputs(gen, g, b, s, h, seg_lens, scales, dev, all_masked=()):
    """seq-major q/k_self/v_self/dO (G, B, S, H, 128) bf16; head-major
    segments with fp32 0/-1e30 biases (80 % visible)."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, do = (rnd(g, b, s, h, 128) for _ in range(4))
    segs = []
    for i, (t, sc) in enumerate(zip(seg_lens, scales)):
        keep = torch.rand(g, b, t, generator=gen, device=dev) < 0.8
        if i in all_masked:
            keep = torch.zeros_like(keep)
        segs.append((rnd(b, h, t, 128), rnd(b, h, t, 128),
                     torch.where(keep, 0.0, -1e30).float(), sc))
    return q, k, v, do, segs


def k3_check(ja, q, k, v, do, segs, layout="sm"):
    """K1 (with its log-sum-exp) then K3 on bf16 inputs, and the plain
    backward in fp32 on the same inputs: [(name, got, ref)] per gradient.
    q, k, v, do come seq-major; layout "hm" runs them head-major."""
    g, b, s, h, _ = q.shape
    if layout == "hm":
        q, k, v, do = (x.transpose(2, 3).contiguous() for x in (q, k, v, do))
    lse = torch.empty((g, b, h, s), dtype=torch.float32, device=q.device)
    out = ja._joint_attention_cuda(q, k, v, segs, layout, None, None, lse)
    got = ja._joint_attention_bwd_cuda(q, k, v, segs, out, lse, do, layout)
    ref = ja.joint_attention_bwd_plain(q.float(), k.float(), v.float(), f32_segments(segs),
                                       do.float(), layout)
    names = ["dq", "dk_self", "dv_self"] + [f"{x}_seg{i}" for i in range(len(segs))
                                            for x in ("dk", "dv")]
    return list(zip(names, [*got[:3], *got[3]], [*ref[:3], *ref[3]]))


def phase_kernel_checks(dev) -> dict:
    from echo_tts_tpu_torch.ops import joint_attention as ja
    from echo_tts_tpu_torch.ops import res_chain as rc

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"joint_attention": 0.0, "res_chain": 0.0, "joint_attention_bwd": 0.0}
    failures = []

    def check(kernel, case, got, ref):
        torch.cuda.synchronize()
        r = rel_l2(got, ref)
        e = max_abs(got, ref)
        finite = bool(torch.isfinite(got.float()).all())
        log(f"# check {kernel} [{case}]: rel-L2 {r:.3e}, max|err| {e:.3e}")
        errs[kernel] = max(errs[kernel], e)
        if not (finite and r < REL_L2_BOUND):
            failures.append(f"{kernel} [{case}] rel-L2 {r:.3e} finite={finite}")

    # K1: the CFG group with text 768 and the largest speaker bucket
    q, k, v, segs = _k1_inputs(gen, 3, 640, 16, (768, 1600), dev)
    check("joint_attention", "G=3 S=640 H=16 text 768 + speaker 1600, scale 1.5",
          ja._joint_attention_cuda(q, k, v, segs, "sm", None, None),
          ja.joint_attention_plain(q.float(), k.float(), v.float(), f32_segments(segs), "sm"))
    # K1: no speaker prompt -> one all-masked speaker patch (T=1)
    q, k, v, segs = _k1_inputs(gen, 3, 640, 16, (768, 1), dev, all_masked=(1,))
    check("joint_attention", "T=1 all-masked speaker segment",
          ja._joint_attention_cuda(q, k, v, segs, "sm", None, None),
          ja.joint_attention_plain(q.float(), k.float(), v.float(), f32_segments(segs), "sm"))
    # K1: branch split as dit_forward_cfg launches it (uncond branches drop
    # their fully masked segment) against the mask-only plain version
    q, k, v, segs = _k1_inputs(gen, 3, 640, 16, (768, 704), dev)
    (kt, vt, mt, st), (ksp, vsp, msp, ssp) = segs
    mt = mt.clone()
    msp = msp.clone()
    mt[1] = False
    msp[2] = False
    ref = ja.joint_attention_plain(q.float(), k.float(), v.float(),
                                   f32_segments([(kt, vt, mt, st), (ksp, vsp, msp, ssp)]), "sm")
    out = torch.empty_like(q)
    ja._joint_attention_cuda(q[0:1], k[0:1], v[0:1],
                             [(kt, vt, mt[0:1], st), (ksp, vsp, msp[0:1], ssp)],
                             "sm", None, out[0:1])
    ja._joint_attention_cuda(q[1:2], k[1:2], v[1:2], [(ksp, vsp, msp[1:2], ssp)],
                             "sm", None, out[1:2])
    ja._joint_attention_cuda(q[2:3], k[2:3], v[2:3], [(kt, vt, mt[2:3], st)],
                             "sm", None, out[2:3])
    check("joint_attention", "branch split, speaker 704", out, ref)
    # K1: per-row self_len (B=2)
    qb, kb, vb = (torch.randn(1, 2, 640, 16, 128, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(3))
    kt2 = torch.randn(2, 16, 768, 128, generator=gen, device=dev).to(torch.bfloat16)
    vt2 = torch.randn(2, 16, 768, 128, generator=gen, device=dev).to(torch.bfloat16)
    mt2 = torch.rand(1, 2, 768, generator=gen, device=dev) < 0.8
    sl = torch.tensor([640, 200], dtype=torch.int32, device=dev)
    check("joint_attention", "self_len (640, 200), B=2",
          ja._joint_attention_cuda(qb, kb, vb, [(kt2, vt2, mt2, None)], "sm", sl, None),
          ja.joint_attention_plain(qb.float(), kb.float(), vb.float(),
                                   f32_segments([(kt2, vt2, mt2, None)]), "sm", sl))

    # K1 at ragged shapes and through every way the port calls it, with one
    # and with two consumer warpgroups a block: an out= view of a larger
    # buffer, the log-sum-exp K3 reads (max |err| < 2e-2, as the card's tests
    # hold it), then branch by branch on q[i:i+1] slices into out[i:i+1]
    def k1_case(case, g, b, s, h, seg_lens, layout="sm", all_masked=(), self_len=None):
        q, k, v, segs = _k1_inputs(gen, g, s, h, seg_lens, dev, all_masked=all_masked, b=b)
        if layout == "hm":
            q, k, v = (x.transpose(2, 3).contiguous() for x in (q, k, v))
        sl = None if self_len is None else torch.tensor(self_len, dtype=torch.int32, device=dev)
        ref = ja.joint_attention_plain(q.float(), k.float(), v.float(), f32_segments(segs),
                                       layout, sl)
        ref_lse = k1_lse_plain(q, k, v, segs, layout, sl)
        for tq in (64, 128):
            buf = torch.full((g + 2, *q.shape[1:]), 7.0, dtype=torch.bfloat16, device=dev)
            lse = torch.empty((g, b, h, s), dtype=torch.float32, device=dev)
            ja._joint_attention_cuda(q, k, v, segs, layout, sl, buf[1:g + 1], lse, tq)
            check("joint_attention", f"{case}, {layout}, tq {tq}, out= view", buf[1:g + 1], ref)
            lse_err = max_abs(lse, ref_lse)
            if not (lse_err < 2e-2 and bool((buf[0] == 7.0).all()) and bool((buf[-1] == 7.0).all())):
                failures.append(f"joint_attention [{case}, tq {tq}] lse max|err| {lse_err:.3e} "
                                f"or a write outside the out= view")
            split = torch.empty_like(q)
            for i in range(g):
                ja._joint_attention_cuda(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                         [(kk, vv, m[i:i + 1], sc) for kk, vv, m, sc in segs],
                                         layout, sl, split[i:i + 1], None, tq)
            if g > 1:
                check("joint_attention", f"{case}, {layout}, tq {tq}, branch slices", split, ref)
        log(f"# check joint_attention [{case}] log-sum-exp max|err| {lse_err:.3e}")

    k1_case("S=200 G=3 B=2 H=16, T=700 + T=1 all-masked", 3, 2, 200, 16, (700, 1),
            all_masked=(1,))
    k1_case("S=200 G=3 B=2 H=16, T=700 + T=1 all-masked", 3, 2, 200, 16, (700, 1), layout="hm",
            all_masked=(1,))
    k1_case("training shape G=1 B=8 S=640 H=16, text 768 + speaker 160", 1, 8, 640, 16,
            (768, 160))
    k1_case("self_len (200, 77) inside a tile, S=200 B=2 H=16, T=160", 1, 2, 200, 16, (160,),
            self_len=(200, 77))
    k1_case("three segments S=200 G=2 H=16, T=300 + 52 + 7", 2, 1, 200, 16, (300, 52, 7),
            layout="hm")

    # K2 at every width of the S1-DAC stacks (decoder 768/384/192/96, encoder
    # 64/128/256/512), non-zero biases, ragged lengths, B=2, zero_below
    # scalar and per row; one launch a unit
    def units(c):
        return variant_units(gen, c, dev)

    for c, t, zb in ((768, 2048, None), (384, 3000, 80), (192, 4096, None),
                     (96, 4100, [80, 13]), (64, 4096, [0, 80]), (128, 1003, [7, 300]),
                     (256, 2050, 41), (512, 777, [80, 0])):
        bsz = 1 if zb is None or isinstance(zb, int) else len(zb)
        x = torch.randn(bsz, t, c, generator=gen, device=dev).to(torch.bfloat16)
        us = units(c)
        before = rc.res_units_cl.launches
        got = rc._res_chain_cuda(x, us, (1, 3, 9), zb)
        if rc.res_units_cl.launches - before != 3:
            failures.append(f"res_chain C={c}: {rc.res_units_cl.launches - before} launches, "
                            f"expected 3")
        check("res_chain", f"C={c} T={t} B={bsz} zero_below={zb}", got,
              rc.res_chain_plain(x.float(), f32_units(us), (1, 3, 9), zb))

    # K3 at the training shape (G=1, B=8, S=640, text 768 + speaker 160,
    # speaker scale 1.5), then at the edges of its tiles: G=3, B=2 with an
    # unaligned T=700 segment and a T=1 all-masked one (whose dk/dv must be
    # exactly 0), and S=130 with a T=129 segment (one past a 128-row q tile
    # of pass A and a 128-key tile of pass B), seq-major and head-major;
    # every gradient against the fp32 plain backward
    for case, args, masked, layouts in (
            ("training shape G=1 B=8 S=640 H=16, text 768 + speaker 160, scale 1.5",
             (1, 8, 640, 16, (768, 160), (None, 1.5)), (), ("sm",)),
            ("G=3 B=2 S=640 H=16, T=700 + T=1 all-masked, scale 1.5",
             (3, 2, 640, 16, (700, 1), (None, 1.5)), (1,), ("sm", "hm")),
            ("G=1 B=2 S=130 H=16, T=129 at scale 1.5", (1, 2, 130, 16, (129,), (1.5,)), (),
             ("sm", "hm"))):
        q3, k3, v3, do3, segs3 = _k3_inputs(gen, *args, dev, all_masked=masked)
        for layout in layouts:
            for name, got, ref in k3_check(ja, q3, k3, v3, do3, segs3, layout):
                if name[-1].isdigit() and int(name[-1]) in masked:
                    torch.cuda.synchronize()
                    zero = not bool(got.any())
                    log(f"# check joint_attention_bwd [{case}, {layout}: {name}]: exactly 0: {zero}")
                    if not zero:
                        failures.append(f"joint_attention_bwd [{case}, {layout}] {name} of the "
                                        f"all-masked segment is not 0")
                else:
                    check("joint_attention_bwd", f"{case}, {layout}: {name}", got, ref)
        del q3, k3, v3, do3, segs3
    # K3 through the autograd Function (layout "sm", bool masks), under
    # torch.autograd.grad, against the plain backward
    q3, k3, v3, do3, segs3 = _k3_inputs(gen, 1, 2, 200, 16, (300, 52), (None, 1.5), dev)
    segs_b = [(kk, vv, bias == 0, sc) for kk, vv, bias, sc in segs3]
    inputs = [x.clone().requires_grad_() for x in (q3, k3, v3, segs3[0][0], segs3[0][1],
                                                    segs3[1][0], segs3[1][1])]
    k1_before, k3_before = ja.joint_attention.launches, ja.joint_attention_bwd.launches
    out = ja.joint_attention_trainable(inputs[0], inputs[1], inputs[2],
                                       [(inputs[3], inputs[4], segs_b[0][2], None),
                                        (inputs[5], inputs[6], segs_b[1][2], 1.5)], layout="sm")
    grads = torch.autograd.grad(out, inputs, grad_outputs=do3)
    launched = (ja.joint_attention.launches - k1_before, ja.joint_attention_bwd.launches - k3_before)
    if launched != (1, 1):
        failures.append(f"joint_attention_trainable launched (K1, K3) = {launched}, expected (1, 1)")
    ref = ja.joint_attention_bwd_plain(q3.float(), k3.float(), v3.float(), f32_segments(segs3),
                                       do3.float(), "sm")
    for name, got, r in zip(("dq", "dk_self", "dv_self", "dk_seg0", "dv_seg0", "dk_seg1",
                             "dv_seg1"), grads, [*ref[:3], *ref[3]]):
        check("joint_attention_bwd", f"autograd.grad through joint_attention_trainable, "
              f"B=2 S=200, text 300 + speaker 52: {name}", got, r)

    # the wrappers refuse what the kernels do not take, on the card too
    for bad in ("dtype", "layout"):
        xq = q.float() if bad == "dtype" else q.transpose(3, 4)
        try:
            ja.joint_attention(xq, k, v, [], "sm")
        except (TypeError, ValueError) as exc:
            log(f"# joint_attention refuses bad {bad}: {type(exc).__name__}")
        else:
            failures.append(f"joint_attention accepted a bad {bad}")
        xc = torch.zeros(1, 64, 96, device=dev)
        if bad == "layout":
            xc = torch.zeros(1, 96, 64, device=dev, dtype=torch.bfloat16).transpose(1, 2)
        try:
            rc.res_units_cl(xc, units(96))
        except (TypeError, ValueError) as exc:
            log(f"# res_chain refuses bad {bad}: {type(exc).__name__}")
        else:
            failures.append(f"res_chain accepted a bad {bad}")

    if failures:
        raise SystemExit("kernel checks failed: " + "; ".join(failures))
    return errs


# ---------------------------------------------------------------------------
# phase 4b: the measurement-variant kernels against their plain versions
# ---------------------------------------------------------------------------


def variant_units(gen, c, dev, bias=0.3):
    """Three residual units with non-zero biases, bf16."""
    def w(*shape, s):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(torch.bfloat16)

    def alpha():
        return (0.2 + 1.3 * torch.rand(1, c, 1, generator=gen, device=dev)).to(torch.bfloat16)

    return [{"snake1": alpha(), "snake2": alpha(),
             "conv1": {"w": w(c, c, 7, s=1.0 / math.sqrt(7 * c)), "b": w(c, s=bias)},
             "conv2": {"w": w(c, c, 1, s=1.0 / math.sqrt(c)), "b": w(c, s=bias)}}
            for _ in range(3)]


def phase_variant_checks(dev) -> dict:
    """Every instance the measurement entry points use, at their full shapes
    and at one ragged shape, against its plain version in fp32 on the same
    bf16 inputs; K2v-cf against K2v-cl; K2s poly against exact. Returns each
    kernel's largest absolute error against its plain version (the `dots`
    probe apart, whose output has no scale)."""
    from echo_tts_tpu_torch.bench import attention_variants as bav
    from echo_tts_tpu_torch.bench import conv_kernel_variants as bcv
    from echo_tts_tpu_torch.ops import attention_variants as av
    from echo_tts_tpu_torch.ops import res_chain_variants as rv

    failures = []
    errs = {"attention_var": 0.0, "res_chain_var": 0.0, "res_chain_cf": 0.0,
            "res_chain_snake": 0.0}

    def check(kernel, case, got, ref, against_plain=True):
        torch.cuda.synchronize()
        r, e = rel_l2(got, ref), max_abs(got, ref)
        finite = bool(torch.isfinite(got.float()).all())
        log(f"# check {kernel} [{case}]: rel-L2 {r:.3e}, max|err| {e:.3e}")
        if against_plain and "dots" not in case.lower():
            errs[kernel] = max(errs[kernel], e)
        if not (finite and r < REL_L2_BOUND):
            failures.append(f"{kernel} [{case}] rel-L2 {r:.3e} finite={finite}")

    # K1v: every named variant at the full shape, then at a ragged one
    # (S and T no multiples of a tile, a T=1 segment; noav needs 128 keys)
    ragged = dict(g=3, b=2, h=4, s=200, d=128, t_text=300, t_spk=1)
    ragged_noav = dict(ragged, t_spk=130)
    def f32(inp):
        return {k: ([tuple(a.float() if a.dtype == torch.bfloat16 else a for a in sg)
                     for sg in v] if isinstance(v, list) else v.float()) for k, v in inp.items()}

    for shape_name, shape in (("full", bav.FULL_SHAPE), ("ragged", ragged)):
        inp = bav.make_inputs(dev, seed=11, **shape)
        inp_noav = bav.make_inputs(dev, seed=11, **ragged_noav) if shape is ragged else inp
        inp32, inp32_noav = f32(inp), f32(inp_noav)
        for name, nseg, flags in bav.VARIANTS:
            use, use32 = ((inp_noav, inp32_noav) if flags.get("probe") == "noav"
                          else (inp, inp32))
            got = bav.variant_call(use, nseg, flags)()
            ref = av.attention_var_plain(*_variant_args(use32, nseg, flags), **flags)
            check("attention_var", f"{shape_name}: {name}", got, ref)
            if flags.get("probe") == "dots" and flags["mask_mode"] != "none":
                # under the additive mask the masked branches (near 1e21)
                # carry the relative error: the unmasked product is held here
                bare = dict(flags, mask_mode="none")
                check("attention_var", f"{shape_name}: {name}, mask_mode=none",
                      bav.variant_call(use, nseg, bare)(),
                      av.attention_var_plain(*_variant_args(use32, nseg, bare), **bare))
        del inp, inp32, inp_noav, inp32_noav

    gen = torch.Generator(device=dev).manual_seed(21)
    # K2v-cl, K2v-cf, K2s: every row of the entry points at its full shape,
    # then at a ragged length (no multiple of any tile) at B=2
    for c, lens in ((192, ((1, 655360), (2, 1000))), (96, ((1, 1310720), (2, 1003)))):
        us = variant_units(gen, c, dev)
        us32 = f32_units(us)
        for bsz, t in lens:
            x = torch.randn(bsz, t, c, generator=gen, device=dev).to(torch.bfloat16)
            for name, kw in bcv.cl_rows(c):
                check("res_chain_var", f"C={c} B={bsz} T={t}: {name}", rv.res_chain(x, us, **kw),
                      rv.res_chain_plain(x.float(), us32, **kw))
            xcf = x.transpose(1, 2).contiguous()
            cl = rv.res_chain(x, us, live_mode="mult")
            for name, kw in bcv.cf_rows(c):
                got = rv.res_chain_cf(xcf, us, **kw)
                check("res_chain_cf", f"C={c} B={bsz} T={t}: {name}", got,
                      rv.res_chain_cf_plain(xcf.float(), us32, **kw))
                if kw.get("use_sin", True):
                    check("res_chain_cf", f"C={c} B={bsz} T={t}: {name} vs K2v-cl transposed",
                          got.transpose(1, 2), cl, against_plain=False)
            outs = {}
            for mode in rv.SNAKE_MODES:
                outs[mode] = rv.res_chain_snake(x, us, mode)
                check("res_chain_snake", f"C={c} B={bsz} T={t}: snake={mode}", outs[mode],
                      rv.res_chain_snake_plain(x.float(), us32, mode))
            check("res_chain_snake", f"C={c} B={bsz} T={t}: poly vs exact", outs["poly"],
                  outs["exact"], against_plain=False)
    # K2v-cf's channel rows 16-byte aligned (T % 8 == 0) or not, at both
    # widths (the loop above has C=192 at T=1000 and C=96 at T=1003)
    for c, t in ((192, 1003), (96, 1000)):
        us = variant_units(gen, c, dev)
        us32 = f32_units(us)
        x = torch.randn(2, t, c, generator=gen, device=dev).to(torch.bfloat16)
        xcf = x.transpose(1, 2).contiguous()
        cl = rv.res_chain(x, us, live_mode="mult")
        for name, kw in bcv.cf_rows(c):
            got = rv.res_chain_cf(xcf, us, **kw)
            check("res_chain_cf", f"C={c} B=2 T={t}: {name}", got,
                  rv.res_chain_cf_plain(xcf.float(), us32, **kw))
            if kw.get("use_sin", True):
                check("res_chain_cf", f"C={c} B=2 T={t}: {name} vs K2v-cl transposed",
                      got.transpose(1, 2), cl, against_plain=False)

    # the wrappers refuse what the kernels do not take
    x = torch.zeros(1, 64, 96, device=dev, dtype=torch.bfloat16)
    us = variant_units(gen, 96, dev)
    q = torch.zeros(1, 1, 2, 64, 128, device=dev, dtype=torch.bfloat16)
    for what, call, exc in (
            ("attention_var dtype", lambda: av.attention_var(q.float(), q, q, [], tq=64), TypeError),
            ("attention_var tq", lambda: av.attention_var(q, q, q, [], tq=320), ValueError),
            ("attention_var stride", lambda: av.attention_var(q.transpose(3, 4), q, q, [], tq=64),
             ValueError),
            ("res_chain dtype", lambda: rv.res_chain(x.float(), us), TypeError),
            ("res_chain width", lambda: rv.res_chain(x[..., :64].contiguous(), us), ValueError),
            ("res_chain tile", lambda: rv.res_chain(x, us, tile_t=4096), ValueError),
            ("res_chain_cf stride", lambda: rv.res_chain_cf(x.transpose(1, 2), us), ValueError),
            ("res_chain_snake mode", lambda: rv.res_chain_snake(x, us, "cubic"), ValueError)):
        try:
            call()
        except exc as e:
            log(f"# {what} refused: {type(e).__name__}")
        else:
            failures.append(f"{what} was accepted")
    if failures:
        raise SystemExit("variant kernel checks failed: " + "; ".join(failures))
    return errs


def _variant_args(inp, nseg, flags):
    """(q, k_self, v_self, segments) of one variant for the plain version:
    keys transposed under k_t, bool masks."""
    k_t = flags.get("k_t", False)

    def key(k):
        return k.transpose(-1, -2) if k_t else k

    return (inp["q"], key(inp["k_self"]), inp["v_self"],
            [(key(k), v, m) for k, v, m in inp[f"segs{nseg}"]])


# ---------------------------------------------------------------------------
# phase 8: kernel times
# ---------------------------------------------------------------------------


def by_path(launches: dict, name: str) -> dict:
    return {path: counts[name] for path, counts in launches.items() if name in counts}


def phase_kernel_times(dev, errs: dict, launches: dict) -> list:
    """launches: {path: {kernel: count}} from the one-shot and training runs;
    a row's `launches` is the count on the path that introduced the kernel,
    and `launches_by_path` has every path's."""
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []

    # K1 at three shapes of the main paths: one launch of a single-branch
    # step (text 768, the 640-latent speaker bucket of 160 patches), of the
    # three-branch CFG group (speaker 1600), and of a LoRA step at B=8
    k1 = [k1_times(dev, gen, *shape) for shape in K1_SHAPES]
    host_us = k1_host_us(dev, gen)
    from echo_tts_tpu_torch.ops import _build

    rows.append({"name": "joint_attention", "route": "cuda",
                 "source": "echo_tts_tpu_torch/csrc/joint_attention.cu",
                 "replaces": "echo_tts_tpu/ops/pallas_attention.py:49",
                 "launches": launches["one_shot"]["joint_attention"],
                 "launches_by_path": by_path(launches, "joint_attention"),
                 "max_abs_err": errs["joint_attention"], **k1[0], "other_shapes": k1[1:],
                 "host_us_per_launch": host_us,
                 "build_seconds": {k: round(v, 1) for k, v in _build.BUILD_SECONDS.items()}})

    rows.append(k2_times(dev, gen, errs, launches))
    rows.append(k3_times(dev, gen, errs, launches))
    return rows + variant_times(dev, errs, launches)


# the chains of one 640-latent decode and of one 640-latent encode (B=1)
K2_DECODER = ((768, 20480), (384, 163840), (192, 655360), (96, 1310720))
K2_ENCODER = ((64, 1310720), (128, 655360), (256, 163840), (512, 20480))


def library_chain(x_cf, units, dilations=(1, 3, 9)):
    """K2's library yardstick, timed only (the port never calls it): the
    chain as cuDNN and eager PyTorch compose it on channels-first bf16
    (B, C, T): per unit the snake in bf16 ops, F.conv1d with the dilation
    after a causal left pad, the snake, the 1x1 F.conv1d, the residual."""
    import torch.nn.functional as F

    def snk(v, a):
        return v + torch.sin(a * v).square() / (a + 1e-9)

    for u, d in zip(units, dilations):
        y = F.conv1d(F.pad(snk(x_cf, u["snake1"]), (6 * d, 0)), u["conv1"]["w"],
                     u["conv1"]["b"], dilation=d)
        x_cf = x_cf + F.conv1d(snk(y, u["snake2"]), u["conv2"]["w"], u["conv2"]["b"])
    return x_cf


def k2_times(dev, gen, errs: dict, launches: dict) -> dict:
    """K2, one three-unit chain at each decoder and each encoder width at
    the row counts a 640-latent decode and encode give it: kernel, plain
    version, the cuDNN composition (library_chain), bound. The JSON row's
    times are the decoder chains summed; `widths` has each."""
    from echo_tts_tpu_torch.bench.timing import cuda_ms
    from echo_tts_tpu_torch.ops import res_chain as rc

    widths, tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    with torch.no_grad():
        for stack, shapes in (("decoder", K2_DECODER), ("encoder", K2_ENCODER)):
            for c, t in shapes:
                x = torch.randn(1, t, c, generator=gen, device=dev).to(torch.bfloat16)
                us = [{"snake1": torch.ones(1, c, 1, device=dev, dtype=torch.bfloat16),
                       "snake2": torch.ones(1, c, 1, device=dev, dtype=torch.bfloat16),
                       "conv1": {"w": (torch.randn(c, c, 7, generator=gen, device=dev) * 0.02
                                       ).to(torch.bfloat16),
                                 "b": (torch.randn(c, generator=gen, device=dev) * 0.1
                                       ).to(torch.bfloat16)},
                       "conv2": {"w": (torch.randn(c, c, 1, generator=gen, device=dev) * 0.02
                                       ).to(torch.bfloat16),
                                 "b": (torch.randn(c, generator=gen, device=dev) * 0.1
                                       ).to(torch.bfloat16)}}
                      for _ in range(3)]
                k_ms = cuda_ms(lambda: rc._res_chain_cuda(x, us, (1, 3, 9), None), reps=5)
                p_ms = cuda_ms(lambda: rc.res_chain_plain(x, us, (1, 3, 9), None), reps=3,
                               warmup=1)
                x_cf = x.transpose(1, 2).contiguous()
                l_ms = cuda_ms(lambda: library_chain(x_cf, us), reps=5)
                del x_cf
                flops = 3 * 2.0 * t * c * c * 8
                nbytes = 2 * 2 * t * c + 3 * 2 * (8 * c * c) + 3 * 4 * 4 * c
                b_ms, b_by = bound(flops, nbytes)
                log(f"# time res_chain {stack} C={c} T={t}: kernel {k_ms:.3f} ms "
                    f"({k_ms / b_ms:.2f}x its bound, {flops / k_ms / 1e9:.0f} TFLOP/s), plain "
                    f"{p_ms:.3f} ms, cuDNN composition {l_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
                widths.append({"stack": stack, "C": c, "T": t, "ms": k_ms, "plain_ms": p_ms,
                               "library_ms": l_ms, "bound_ms": b_ms})
                if stack == "decoder":
                    for k, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                                 ("flops", flops), ("bytes", nbytes)):
                        tot[k] += v
                del x
    b_ms, b_by = bound(tot["flops"], tot["bytes"])
    log(f"# time res_chain, the four decoder chains of a decode: kernel {tot['ms']:.3f} ms, "
        f"cuDNN composition {tot['library_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
        f"bound {b_ms:.3f} ms")
    return {"name": "res_chain", "route": "cuda",
            "source": "echo_tts_tpu_torch/csrc/res_chain.cu",
            "replaces": "echo_tts_tpu/ops/pallas_conv.py:60",
            "launches": launches["one_shot"]["res_chain"],
            "launches_by_path": by_path(launches, "res_chain"),
            "max_abs_err": errs["res_chain"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": tot["library_ms"],
            "library": "cuDNN composition: bf16 F.conv1d (dilated, causal pad) + eager snakes "
                       "+ 1x1 F.conv1d",
            "widths": widths, "ptxas": PTXAS.get("res_chain", {}),
            "shape": "decoder chains C=768/384/192/96 at T=20480/163840/655360/1310720, summed"}


K1_SHAPES = (("one branch", 1, 1, (768, 160)), ("three branches", 3, 1, (768, 1600)),
             ("training", 1, 8, (768, 160)))
GRAPH_ITERS = 20  # calls per timed CUDA-graph replay, for kernels shorter than their launch


def k1_times(dev, gen, what, g, b, seg_lens) -> dict:
    """K1 at S=640, H=16, D=128, seq-major, speaker scale 1.5, fp32 biases:
    device ms (CUDA-graph replays of 20 launches: the kernel is shorter than
    the wrapper's host time) with 64 and with 128 query rows a block, the
    plain version, the bound, and the library yardstick: one SDPA call over
    [k_self | k_text | k_spk*s] with the concatenated additive bias (timed
    only; the port never calls it)."""
    from echo_tts_tpu_torch.bench.timing import cuda_ms
    from echo_tts_tpu_torch.ops import joint_attention as ja

    s, h, d = 640, 16, 128
    q, k, v, segs = _k1_inputs(gen, g, s, h, seg_lens, dev, b=b)
    segs = [(kk, vv, torch.where(m, 0.0, -1e30).float(), sc) for kk, vv, m, sc in segs]
    out = torch.empty_like(q)
    with torch.no_grad():
        by_tq = {tq: cuda_ms(lambda: ja._joint_attention_cuda(q, k, v, segs, "sm", None, out,
                                                              None, tq), graph_iters=GRAPH_ITERS)
                 for tq in (64, 128)}
        plain_ms = cuda_ms(lambda: ja.joint_attention_plain(q, k, v, segs, "sm"), reps=3)
        scaled = [(kk if sc is None else kk * sc, vv if sc is None else vv * sc)
                  for kk, vv, _, sc in segs]
        kc = torch.cat([k.transpose(2, 3)] + [kk[None].expand(g, *kk.shape) for kk, _ in scaled], 3)
        vc = torch.cat([v.transpose(2, 3)] + [vv[None].expand(g, *vv.shape) for _, vv in scaled], 3)
        bias = torch.cat([torch.zeros(g, b, s, device=dev)] + [m for _, _, m, _ in segs], -1)
        q4, k4, v4 = (x.reshape(g * b, h, -1, d) for x in (q.transpose(2, 3), kc, vc))
        bias4 = bias.reshape(g * b, 1, 1, -1).to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=bias4), graph_iters=GRAPH_ITERS)
    t_seg = sum(seg_lens)
    flops = 4.0 * g * b * h * s * (s + t_seg) * d
    nbytes = 2 * (4 * g * b * s * h * d + 2 * b * h * t_seg * d) + 4 * g * b * t_seg
    b_ms, b_by = bound(flops, nbytes)
    ms = by_tq[ja.TQ]
    log(f"# time joint_attention, {what} (G={g} B={b}): kernel {ms:.4f} ms at tq {ja.TQ} "
        f"(tq 64: {by_tq[64]:.4f}, tq 128: {by_tq[128]:.4f}; {flops / ms / 1e9:.0f} TFLOP/s), "
        f"plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "tq": ja.TQ, "ms_tq64": by_tq[64], "ms_tq128": by_tq[128],
            "shape": f"{what}: G={g} B={b} S={s} H={h} D={d} self {s} + text {seg_lens[0]} + "
                     f"speaker {seg_lens[1]} (scale 1.5)"}


def k1_host_us(dev, gen, launches: int = 400) -> float:
    """What one launch of K1 costs the host: `launches` calls of the public
    wrapper as the sampler makes them (seq-major views, fp32 biases, out=)
    timed on the host's clock up to the last call's return, one synchronize
    after it. The shape is the one-branch one, whose kernel is shorter than
    this, so the queue never fills and the loop never waits for the card."""
    from echo_tts_tpu_torch.ops.joint_attention import joint_attention

    q, k, v, segs = _k1_inputs(gen, 1, 640, 16, (768, 160), dev)
    segs = [(kk, vv, torch.where(m, 0.0, -1e30).float(), sc) for kk, vv, m, sc in segs]
    out = torch.empty_like(q)
    with torch.no_grad():
        for _ in range(20):
            joint_attention(q, k, v, segs, "sm", out=out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(launches):
            joint_attention(q, k, v, segs, "sm", out=out)
        host = (time.perf_counter() - t0) / launches * 1e6
        torch.cuda.synchronize()
    log(f"# joint_attention wrapper: {host:.1f} us of host time per launch "
        f"({launches} launches, one synchronize at the end)")
    return host


def k3_times(dev, gen, errs: dict, launches: dict) -> dict:
    """K3 at the training shape (G=1, B=8, S=640, H=16, text 768, speaker 160
    at scale 1.5), with K1's out and lse of the same inputs: device ms over
    CUDA-graph replays of 20 calls (two kernels each), TFLOP/s on the 10*S*T*D
    of the five products; the plain backward on the same bf16 inputs; the
    yardstick is the backward of one SDPA call over [k_self | k_text |
    k_spk*s] with the concatenated bias (timed only; the port never calls
    it), over graph replays too: its forward runs on a side stream, so that
    torch.autograd.grad, whose kernels run on the forward's stream, is
    captured there."""
    from echo_tts_tpu_torch.bench.timing import cuda_ms
    from echo_tts_tpu_torch.ops import joint_attention as ja

    g, b, s, h, d, t_text, t_spk = 1, TRAIN_B, 640, 16, 128, 768, 160
    q, k, v, do, segs = _k3_inputs(gen, g, b, s, h, (t_text, t_spk), (None, 1.5), dev)
    lse = torch.empty((g, b, h, s), dtype=torch.float32, device=dev)
    out = ja._joint_attention_cuda(q, k, v, segs, "sm", None, None, lse)
    ms = cuda_ms(lambda: ja._joint_attention_bwd_cuda(q, k, v, segs, out, lse, do, "sm"),
                 graph_iters=GRAPH_ITERS)
    plain_ms = cuda_ms(lambda: ja.joint_attention_bwd_plain(q, k, v, segs, do, "sm"), reps=3)
    (kt, vt, bt, _), (ksp, vsp, bsp, ssp) = segs
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        qh = q[0].transpose(1, 2).detach().requires_grad_()
        kc = torch.cat([k[0].transpose(1, 2), kt, ksp * ssp], dim=2).detach().requires_grad_()
        vc = torch.cat([v[0].transpose(1, 2), vt, vsp * ssp], dim=2).detach().requires_grad_()
        bias = torch.cat([torch.zeros(b, s, device=dev), bt[0], bsp[0]], dim=-1)
        bias = bias[:, None, None, :].to(torch.bfloat16)
        o_lib = torch.nn.functional.scaled_dot_product_attention(qh, kc, vc, attn_mask=bias)
        do_lib = do[0].transpose(1, 2)
    torch.cuda.current_stream(dev).wait_stream(side)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(o_lib, (qh, kc, vc), do_lib, retain_graph=True),
                     graph_iters=GRAPH_ITERS, stream=side)
    t_all = s + t_text + t_spk
    flops = 10.0 * g * b * h * s * t_all * d
    # q, k_self, v_self, out, dO read and dq, dk_self, dv_self written (bf16);
    # segment k, v read and dk, dv written; lse and biases read
    nbytes = (2 * 8 * g * b * s * h * d + 2 * 4 * b * h * (t_text + t_spk) * d
              + 4 * g * b * h * s + 4 * g * b * (t_text + t_spk))
    b_ms, b_by = bound(flops, nbytes)
    log(f"# time joint_attention_bwd: kernel {ms:.4f} ms over graph replays "
        f"({flops / ms / 1e9:.0f} TFLOP/s of 10*S*T*D), plain {plain_ms:.3f} ms, "
        f"sdpa backward {lib_ms:.4f} ms over graph replays, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "joint_attention_bwd", "route": "cuda",
            "source": "echo_tts_tpu_torch/csrc/joint_attention_bwd.cu",
            "replaces": "echo_tts_tpu/ops/pallas_attention.py:379",
            "launches": launches["training"]["joint_attention_bwd"],
            "launches_by_path": by_path(launches, "joint_attention_bwd"),
            "max_abs_err": errs["joint_attention_bwd"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "tflops": flops / ms / 1e9, "ptxas": PTXAS.get("joint_attention_bwd", {}),
            "shape": f"G={g} B={b} S={s} H={h} D={d} self {s} + text {t_text} + "
                     f"speaker {t_spk} (scale 1.5)"}


def variant_times(dev, errs: dict, launches: dict) -> list:
    """K1v, K2v-cl, K2v-cf and K2s at the shapes their entry points time, the
    instance each entry point calls "(prod)" or its default: kernel, plain
    version on the same bf16 inputs, bound, and for K1v one SDPA call."""
    from echo_tts_tpu_torch.bench import attention_variants as bav
    from echo_tts_tpu_torch.bench import conv_kernel_variants as bcv
    from echo_tts_tpu_torch.bench import conv_variants as bsv
    from echo_tts_tpu_torch.bench.timing import cuda_ms, cuda_times
    from echo_tts_tpu_torch.ops import attention_variants as av
    from echo_tts_tpu_torch.ops import res_chain_variants as rv

    measured = launches.get("measurement", {})
    rows = []
    with torch.no_grad():
        # K1v: the two-pass exact softmax, q tile 128, additive bias, exp2
        shp = bav.FULL_SHAPE
        g, b, h, s, d, t_text, t_spk = (shp[k] for k in ("g", "b", "h", "s", "d", "t_text",
                                                          "t_spk"))
        inp = bav.make_inputs(dev, seed=2, **shp)
        flags = dict(tq=128, mask_mode="bias", use_exp2=True)
        ms = cuda_ms(bav.variant_call(inp, 2, flags), graph_iters=GRAPH_ITERS)
        plain_ms = cuda_ms(lambda: av.attention_var_plain(*_variant_args(inp, 2, flags), **flags))
        lib_ms = cuda_ms(bav.reference_calls(inp)[1][1], graph_iters=GRAPH_ITERS)
        flops = 4.0 * g * b * h * s * (s + t_text + t_spk) * d
        nbytes = (2 * 4 * g * b * h * s * d + 2 * 2 * b * h * (t_text + t_spk) * d
                  + 4 * g * b * (t_text + t_spk))
        b_ms, b_by = bound(flops, nbytes)
        log(f"# time attention_var: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa "
            f"{lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows.append({"name": "attention_var", "route": "cuda",
                     "source": "echo_tts_tpu_torch/csrc/joint_attention_variants.cu",
                     "replaces": "scripts/bench_attention_variants.py:65",
                     "launches": measured.get("attention_var", 0),
                     "max_abs_err": errs["attention_var"], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "shape": f"G={g} B={b} H={h} S={s} D={d} self {s} + text {t_text} + speaker "
                              f"{t_spk}; probe full, tq 128, bias, exp2"})
        del inp

        # the chains at C=192, T=655,360: one read and one write of x, the
        # weights once, 3 units of a K=7 and a K=1 product
        c, t = bsv.FULL_SHAPE
        gen = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(1, t, c, generator=gen, device=dev).to(torch.bfloat16)
        xcf = x.transpose(1, 2).contiguous()
        units = bsv.make_units(gen, c, dev)
        flops = 3 * 2.0 * t * c * c * 8
        nbytes = 2 * 2 * t * c + 3 * 2 * (8 * c * c) + 3 * 4 * 4 * c
        b_ms, b_by = bound(flops, nbytes)
        # one source, two kernel names: res_chain_cl_kernel<C, snake> (K2v-cl,
        # K2s) and res_chain_cf_kernel<C, snake> (K2v-cf)
        ptxas = PTXAS.get("res_chain_variants", {})
        for name, key, kernel, replaces, what, fn, plain in (
                ("res_chain_var", "res_chain_var", "res_chain_cl",
                 "scripts/bench_conv_kernel_variants.py:36", "sin² polynomial, seven taps",
                 lambda: rv.res_chain(x, units, use_sin="poly"),
                 lambda: rv.res_chain_plain(x, units, use_sin="poly")),
                ("res_chain_cf", "res_chain_cf", "res_chain_cf",
                 "scripts/bench_conv_kernel_variants.py:99", "channels first, sin",
                 lambda: rv.res_chain_cf(xcf, units),
                 lambda: rv.res_chain_cf_plain(xcf, units)),
                ("res_chain_snake", "res_chain_snake", "res_chain_cl",
                 "scripts/bench_conv_variants.py:56", "snake exact",
                 lambda: rv.res_chain_snake(x, units, "exact"),
                 lambda: rv.res_chain_snake_plain(x, units, "exact"))):
            # device time per call over graph replays; and one call at a time,
            # as earlier readings were taken (the wrapper's host work to pack
            # the weights included)
            ms = cuda_ms(fn, reps=5, graph_iters=bcv.GRAPH_ITERS)
            per_call = cuda_times(fn, reps=5)
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            log(f"# time {name}: kernel {ms:.3f} ms ({per_call['ms']:.3f} ms timed call by "
                f"call), plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
            rows.append({"name": name, "route": "cuda",
                         "source": "echo_tts_tpu_torch/csrc/res_chain_variants.cu",
                         "replaces": replaces,
                         "launches": measured.get(key, 0), "max_abs_err": errs[key], "ms": ms,
                         "ms_call_by_call": per_call["ms"],
                         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                         # no single PyTorch call computes the three-unit chain
                         "library_ms": None,
                         "ptxas": {k: v for k, v in ptxas.items() if k.startswith(kernel)},
                         "shape": f"three-unit chain, B=1 C={c} T={t}; {what}"})
        del x, xcf
        cf_row = next(r for r in rows if r["name"] == "res_chain_cf")
        cf_row["in_turns"] = [layout_in_turns(dev, c, t) for c, t in bcv.FULL_SHAPES]
    return rows


def layout_in_turns(dev, c, t) -> dict:
    """K2v-cl and K2v-cf, both with the sin snake and the multiply re-zero
    (one kernel body, the layout of x and out apart), timed in turns (cl, cf,
    cf, cl) on the same input over graph replays: what channels first costs,
    without the drift between rows that are timed one after another."""
    from echo_tts_tpu_torch.bench import conv_kernel_variants as bcv
    from echo_tts_tpu_torch.bench.timing import cuda_ms
    from echo_tts_tpu_torch.ops import res_chain_variants as rv

    gen = torch.Generator(device=dev).manual_seed(c)
    units = bcv.make_units(gen, c, dev)
    x = torch.randn(1, t, c, generator=gen, device=dev).to(torch.bfloat16)
    xcf = x.transpose(1, 2).contiguous()
    calls = {"cl": lambda: rv.res_chain(x, units, live_mode="mult"),
             "cf": lambda: rv.res_chain_cf(xcf, units)}
    ms = {"cl": [], "cf": []}
    for k in ("cl", "cf", "cf", "cl"):
        ms[k].append(cuda_ms(calls[k], reps=5, graph_iters=bcv.GRAPH_ITERS))
    cl, cf = statistics.mean(ms["cl"]), statistics.mean(ms["cf"])
    log(f"# time in turns C={c} T={t}: K2v-cl sin {ms['cl']} ms, K2v-cf sin {ms['cf']} ms, "
        f"cf/cl {cf / cl:.3f}")
    return {"C": c, "T": t, "cl_sin_ms": ms["cl"], "cf_sin_ms": ms["cf"], "cf_over_cl": cf / cl}


# ---------------------------------------------------------------------------
# phase 7: the measurement path
# ---------------------------------------------------------------------------


def phase_measurement(dev) -> dict:
    """The entry points of echo_tts_tpu_torch/bench/ at their full shapes, as
    `python -m echo_tts_tpu_torch.bench.<name>` runs them: each prints its
    table to stderr and its JSON line to stdout. Every launch count is set
    to 0 before an entry point and read after it; an entry point that did
    not go through its kernels, or reports a time that is not positive and
    finite, fails the run. Returns the launches summed over the path."""
    import importlib

    from echo_tts_tpu_torch.ops.attention_variants import attention_var
    from echo_tts_tpu_torch.ops.joint_attention import joint_attention
    from echo_tts_tpu_torch.ops.res_chain import res_units_cl
    from echo_tts_tpu_torch.ops.res_chain_variants import res_chain, res_chain_cf, res_chain_snake

    wrappers = {"joint_attention": joint_attention, "res_chain": res_units_cl,
                "attention_var": attention_var, "res_chain_var": res_chain,
                "res_chain_cf": res_chain_cf, "res_chain_snake": res_chain_snake}
    path = (("attention_variants", ("attention_var", "joint_attention")),
            ("conv_kernel_variants", ("res_chain_var", "res_chain_cf", "res_chain")),
            ("conv_variants", ("res_chain_snake", "res_chain")),
            ("attention", ("joint_attention",)),
            ("profile_breakdown", ("joint_attention", "res_chain")))
    totals = {k: 0 for k in wrappers}
    for name, through in path:
        mod = importlib.import_module(f"echo_tts_tpu_torch.bench.{name}")
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        res = mod.main([])
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items() if w.launches}
        log(f"# entry point bench.{name}: {time.perf_counter() - t0:.1f} s, launches {counts}")
        missing = [k for k in through if not counts.get(k)]
        bad = {k: v for k, v in res["ms"].items() if not (math.isfinite(v) and v > 0)}
        if missing or bad or res["device"] != torch.cuda.get_device_name(0):
            raise SystemExit(f"bench.{name}: kernels never launched {missing}, bad times {bad}, "
                             f"device {res['device']!r}")
        for k, v in counts.items():
            totals[k] += v
    log(f"# launches on the measurement path: {totals}")
    return totals


# ---------------------------------------------------------------------------
# phase 5: the one-shot slice at full width
# ---------------------------------------------------------------------------

SHORT_TEXT = "[S1] Hello! This is a short test of the port on the GPU."
SPEAKER_TEXT = "[S1] The speaker prompt sets the voice; the text sets the words."
LONG_TEXT = ("[S1] " + " ".join([
    "Once upon a time, in a small village beside a slow green river, there lived",
    "an old clockmaker who repaired every clock in the valley. Each morning he",
    "opened his shop at seven, wound the tall clock by the door, and listened to",
    "the gears settle into their steady rhythm. Children came by after school to",
    "watch him work, and he would tell them how every tooth on every wheel had",
    "to be cut just so, or the whole machine would drift. One winter a stranger",
    "arrived with a broken pocket watch that no one else could fix. The old man",
    "studied it for three days, and on the fourth he understood: the watch was",
    "not broken at all. It was simply waiting for someone patient enough to",
    "listen.",
]))


def synthetic_speech(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A voice-like test waveform: a gliding harmonic tone under a syllable
    envelope, plus a little noise; (1, samples) fp32."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.3 * t) + 10 * rng.standard_normal() * np.sin(2 * np.pi * 2.1 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    tone = sum(np.sin(k * phase) / k for k in range(1, 9))
    envelope = np.clip(np.sin(2 * np.pi * 3.7 * t) + 0.3, 0, None)
    wav = 0.2 * tone * envelope + 0.005 * rng.standard_normal(n)
    return wav[None].astype(np.float32)


def param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_count(v) for v in tree)
    return tree.numel()


def phase_slice(dev, wrappers: dict) -> dict:
    from echo_tts_tpu_torch.bench.init_ae import init_ae_params
    from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig, SamplerConfig
    from echo_tts_tpu_torch.models.dit import init_dit_params
    from echo_tts_tpu_torch.models.pca import PCAState
    from echo_tts_tpu_torch.pipeline.pipeline import EchoTTS, sample_pipeline
    from echo_tts_tpu_torch.pipeline.speaker import get_speaker_latent_and_mask

    dit_cfg = DiTConfig(has_latent_modules=False)
    ae_cfg = AEConfig()
    t0 = time.perf_counter()
    dit_params = init_dit_params(dit_cfg, torch.bfloat16, dev, seed=0)
    ae_params = init_ae_params(ae_cfg, torch.bfloat16, dev, seed=1)
    torch.cuda.synchronize()
    log(f"# init on the card: DiT {param_count(dit_params) / 1e9:.3f} B params, "
        f"AE {param_count(ae_params) / 1e6:.1f} M params, bf16, "
        f"{time.perf_counter() - t0:.1f} s")
    tts = EchoTTS(dit_params, dit_cfg, ae_params, ae_cfg, PCAState.random(device=dev),
                  model_dtype=torch.bfloat16, device=dev)
    sc = SamplerConfig(num_steps=40, cfg_scale_text=3.0, cfg_scale_speaker=8.0,
                       cfg_min_t=0.5, cfg_max_t=1.0, truncation_factor=0.8,
                       sequence_length=640)
    sr = ae_cfg.sample_rate
    requests = [("i: short text, no speaker", SHORT_TEXT, None),
                ("ii: text + 20 s speaker prompt", SPEAKER_TEXT, synthetic_speech(20.0, sr, 7)),
                ("iii: long text", LONG_TEXT, None)]
    log(f"# long text: {len(LONG_TEXT.encode())} bytes")

    phase_path_check(tts, dev)

    # warm-up (CUDA context, cuBLAS/cuDNN handles, allocator); not reported
    sample_pipeline(tts, SHORT_TEXT, None, rng_seed=99, sc=sc)
    torch.cuda.synchronize()

    for w in wrappers.values():
        w.launches = 0
    deltas = []
    for i, (name, text, spk) in enumerate(requests):
        before = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        audio, _, tm = sample_pipeline(tts, text, spk, rng_seed=i, sc=sc)
        wall = time.perf_counter() - t0
        delta = {k: w.launches - before[k] for k, w in wrappers.items()}
        deltas.append(delta)
        secs = audio.shape[-1] / sr
        log(f"# request {name}: tokenize {tm['tokenize'] * 1e3:.1f} ms, "
            f"speaker_encode {tm['speaker_encode'] * 1e3:.1f} ms, "
            f"sample+decode {tm['sample'] * 1e3:.1f} ms, crop {tm['crop'] * 1e3:.1f} ms, "
            f"wall {wall * 1e3:.1f} ms; audio {secs:.2f} s "
            f"(before crop {tm['samples_before_crop'] / sr:.2f} s), "
            f"{secs / wall:.2f} audio-s/s; peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {delta}")
        if tm["samples_before_crop"] != sc.sequence_length * ae_cfg.frame_length:
            raise SystemExit(f"request {name}: {tm['samples_before_crop']} samples before the crop")
        if tm["finite_before_crop"] != 1.0 or not np.isfinite(audio).all():
            raise SystemExit(f"request {name}: audio is not finite")
        if min(delta.values()) <= 0:
            raise SystemExit(f"request {name}: a kernel was never launched: {delta}")
    k1_expected = 20 * dit_cfg.num_layers * 3 + 20 * dit_cfg.num_layers
    if deltas[0]["joint_attention"] != k1_expected:
        raise SystemExit(f"joint_attention launched {deltas[0]['joint_attention']} times on "
                         f"request i, expected {k1_expected}")
    # K2: one launch a unit, three units a stack block; a prompt is encoded
    # in 640-latent chunks
    spk_audio = requests[1][2]
    chunks = math.ceil(spk_audio.shape[-1] / (tts.pipe_cfg.audio_chunk_latents
                                              * ae_cfg.frame_length))
    k2_decode, k2_chunk = 3 * len(ae_cfg.decoder_rates), 3 * len(ae_cfg.encoder_rates)
    if (deltas[0]["res_chain"] != k2_decode
            or deltas[1]["res_chain"] != k2_decode + chunks * k2_chunk):
        raise SystemExit(f"res_chain launched {deltas[0]['res_chain']} / "
                         f"{deltas[1]['res_chain']} times on requests i / ii, expected "
                         f"{k2_decode} / {k2_decode + chunks * k2_chunk}")
    totals = {k: w.launches for k, w in wrappers.items()}
    log(f"# launches over the three requests: {totals}")
    profile_families("request i again", lambda: sample_pipeline(tts, SHORT_TEXT, None,
                                                                rng_seed=5, sc=sc))
    profile_families(f"speaker encode of the 20 s prompt ({chunks} chunk of "
                     f"{tts.pipe_cfg.audio_chunk_latents} latents)",
                     lambda: get_speaker_latent_and_mask(
                         tts.ae_params, ae_cfg, tts.pca, spk_audio,
                         audio_chunk_latents=tts.pipe_cfg.audio_chunk_latents))
    for k, w in wrappers.items():  # the profiles' launches are not the path's
        w.launches = totals[k]
    noise_host_us(dev)
    return tts, totals


def noise_host_us(dev, reps: int = 20) -> float:
    """F4: the host cost of the seeded (1, 640, 80) draw the sampler starts
    from (jax.random.normal's numbers, on the host, then to the card)."""
    from echo_tts_tpu_torch.sampling.euler_cfg import draw_noise

    draw_noise(0, (1, 640, 80), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        draw_noise(i, (1, 640, 80), dev)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / reps * 1e6
    log(f"# seeded noise draw (1, 640, 80) as jax.random.normal gives it: {us:.1f} us a draw "
        f"on the host, the copy to the card included")
    return us


def phase_path_check(tts, dev) -> None:
    """At full width, on the activations the path really produces: one CFG
    forward (branch split, the text and speaker caches as the sampler builds
    them) through K1 against the same forward through the plain version;
    and one decode of 640 latents with non-zero residual-unit biases in
    which every K2 call is checked against the plain version (fp32) on the
    same input. rel-L2 < 2e-2 each. The end-to-end decode through the plain
    chain is printed too: bf16 rounding differences compound over twelve
    units and four upsamplings, so it is information, not a gate."""
    import echo_tts_tpu_torch.models.dit as dit_mod
    import echo_tts_tpu_torch.models.s1dac as s1_mod
    from echo_tts_tpu_torch.ops.joint_attention import joint_attention_plain
    from echo_tts_tpu_torch.ops.res_chain import res_chain_plain

    def plain_attention(q, k_self, v_self, segments, layout="hm", self_len=None, out=None):
        res = joint_attention_plain(q, k_self, v_self, segments, layout, self_len)
        return res if out is None else out.copy_(res)

    cfg, gen = tts.dit_cfg, torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, 256, (1, 768), generator=gen, device=dev)
    text_mask = torch.arange(768, device=dev)[None] < 300
    spk = torch.randn(1, 640, cfg.latent_size, generator=gen, device=dev).to(torch.bfloat16)
    spk_mask = torch.arange(640, device=dev)[None] < 430
    x = torch.randn(1, 640, cfg.latent_size, generator=gen, device=dev).to(torch.bfloat16)
    t = torch.full((1,), 0.7, device=dev).to(torch.bfloat16)
    p = tts.dit_params
    with torch.no_grad():
        kv_text = dit_mod.get_kv_cache_text(p, cfg, ids, text_mask)
        kv_spk = dit_mod.get_kv_cache_speaker(p, cfg, spk)
        fwd = lambda: dit_mod.dit_forward_cfg(p, cfg, x, t, text_mask, spk_mask,  # noqa: E731
                                              kv_text, kv_spk, speaker_kv_scale=[1.5] * cfg.num_layers)
        got = fwd()
        kernel_attention, dit_mod.joint_attention = dit_mod.joint_attention, plain_attention
        try:
            ref = fwd()
        finally:
            dit_mod.joint_attention = kernel_attention
        attn_rel = rel_l2(got, ref)

        ae = dict(tts.ae_params)
        ae["decoder"] = dict(ae["decoder"])
        ae["decoder"]["blocks"] = [dict(b) for b in ae["decoder"]["blocks"]]
        for blk in ae["decoder"]["blocks"]:
            blk["res_units"] = [
                {**u, **{c: {**u[c], "b": (0.3 * torch.randn(u[c]["w"].shape[0], generator=gen,
                                                             device=dev)).to(torch.bfloat16)}
                         for c in ("conv1", "conv2")}} for u in blk["res_units"]]
        z_q = (0.3 * torch.randn(1, tts.ae_cfg.latent_dim, 640, generator=gen,
                                 device=dev)).to(torch.bfloat16)
        kernel_chain = s1_mod.res_units_cl
        per_call = []

        def checked_chain(xc, units, dilations=(1, 3, 9), *, zero_below=None):
            out = kernel_chain(xc, units, dilations, zero_below=zero_below)
            ref_c = res_chain_plain(xc.float(), f32_units(units), dilations, zero_below)
            per_call.append((tuple(xc.shape), rel_l2(out, ref_c)))
            return out

        s1_mod.res_units_cl = checked_chain
        try:
            got = s1_mod.decode_zq(ae, tts.ae_cfg, z_q)
            s1_mod.res_units_cl = res_chain_plain
            ref = s1_mod.decode_zq(ae, tts.ae_cfg, z_q)
        finally:
            s1_mod.res_units_cl = kernel_chain
        decode_rel = rel_l2(got, ref)
    chain_rel = max(r for _, r in per_call)
    log(f"# full-width path, kernels vs plain versions: CFG forward rel-L2 {attn_rel:.3e}; "
        f"decode, per K2 call on its real input: max rel-L2 {chain_rel:.3e} over "
        + ", ".join(f"{shape} {r:.2e}" for shape, r in per_call)
        + f"; whole decode through the plain chain (information) rel-L2 {decode_rel:.3e}")
    if not (attn_rel < REL_L2_BOUND and chain_rel < REL_L2_BOUND):
        raise SystemExit("the full-width path disagrees with its plain versions")


def profile_families(what: str, run) -> None:
    """Wall time of run() unprofiled, then under torch.profiler: device time
    by kernel family and the device-busy share of the unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from echo_tts_tpu_torch.utils.profiling import device_time_by_family, kernel_family

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: CPU ops also carry their kernels' device time
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    fam = device_time_by_family(prof)
    total = sum(v["ms"] for v in fam.values())
    log(f"# profile, {what}: wall {wall_ms:.1f} ms unprofiled, "
        f"{prof_wall_ms:.1f} ms profiled; device busy {total:.1f} ms = "
        f"{total / wall_ms:.1%} of the unprofiled wall")
    for f, v in sorted(fam.items(), key=lambda kv: -kv[1]["ms"]):
        log(f"#   {f}: {v['ms']:.1f} ms in {v['launches']} launches "
            f"({v['ms'] / total:.1%} of device time)")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        log(f"#   top kernel {e.key[:70]}: {e.device_time_total / 1e3:.1f} ms, {e.count} launches")
    # each kernel of the port's own families on its own line (K3's two passes)
    for e in sorted(kernels, key=lambda e: -e.device_time_total):
        if kernel_family(e.key).startswith("K"):
            name = re.search(r"::(\w+(?:<\d+>)?)", e.key)
            log(f"#   port kernel {name.group(1) if name else e.key[:60]}: "
                f"{e.device_time_total / 1e3:.2f} ms in {e.count} launches")


# ---------------------------------------------------------------------------
# phase 6: the training slice at full width
# ---------------------------------------------------------------------------

TRAIN_B = 8
TRAIN_CLIPS = 16
CLIP_LATENTS = 640  # 29.72 s at 44.1 kHz


def phase_train(tts, dev, wrappers: dict) -> dict:
    """LoRA finetuning as scripts/finetune_lora.py runs it, on the weights
    the one-shot phase made: WAV clips -> prepare_samples_from_directory ->
    EchoTTSDataset (K2 encodes) -> batches_prefetch(B=8) -> LoRA steps."""
    import tempfile

    from echo_tts_tpu_torch.pipeline.audio_io import write_wav
    from echo_tts_tpu_torch.train.data import (
        EchoTTSDataset,
        batches_prefetch,
        prepare_samples_from_directory,
    )
    from echo_tts_tpu_torch.train.lora import LoRAConfig, count_lora_params, init_lora
    from echo_tts_tpu_torch.train.loop import TrainConfig, make_train_step

    cfg, ae_cfg = tts.dit_cfg, tts.ae_cfg
    sr = ae_cfg.sample_rate
    for w in wrappers.values():
        w.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        transcripts = {}
        for i in range(TRAIN_CLIPS):
            path = os.path.join(tmp, f"clip{i:02d}.wav")
            write_wav(path, synthetic_speech(CLIP_LATENTS * ae_cfg.frame_length / sr, sr, 100 + i),
                      sr)
            transcripts[path] = f"[S1] Training clip number {i}. " + LONG_TEXT[5:200 + 20 * i]
        samples = prepare_samples_from_directory(tmp, transcripts)
        t1 = time.perf_counter()
        ds = EchoTTSDataset(samples, tts.ae_params, ae_cfg, tts.pca)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k2 = wrappers["res_chain"].launches
        log(f"# training data: {len(samples)} clips of {CLIP_LATENTS} latents written in "
            f"{(t1 - t0) * 1e3:.1f} ms, pre-encoded in {(t2 - t1) * 1e3:.1f} ms "
            f"({k2} K2 launches)")
        profile_families(f"pre-encode of the {TRAIN_CLIPS} clips again",
                         lambda: EchoTTSDataset(samples, tts.ae_params, ae_cfg, tts.pca))
        wrappers["res_chain"].launches = k2  # the profile's launches are not the path's
    # one launch a unit, three units a block of the encoder, whole chunks
    if len(ds) != TRAIN_CLIPS or k2 <= 0 or k2 % (3 * len(ae_cfg.encoder_rates)):
        raise SystemExit(f"the dataset encode did not run through K2 as expected ({k2} "
                         f"launches, {len(ds)} samples)")
    lat_shapes = {v.shape for v in ds.latent_cache.values()}
    if lat_shapes != {(CLIP_LATENTS, cfg.latent_size)}:
        raise SystemExit(f"unexpected latent shapes {lat_shapes}")

    lc = LoRAConfig(rank=16, alpha=32.0)  # scripts/finetune_lora.py defaults
    lora = init_lora(torch.Generator(device=dev).manual_seed(0), tts.dit_params, lc)
    tc = TrainConfig(learning_rate=5e-5)
    opt, step = make_train_step(cfg, tc, model_dtype=torch.bfloat16, lora_cfg=lc)
    opt_state = opt.init(lora)
    log(f"# LoRA r{lc.rank} alpha {lc.alpha}: {count_lora_params(lora) / 1e6:.3f} M "
        f"adapter params over {len(lc.targets)} targets")

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    per_step = {"joint_attention": 2 * cfg.num_layers, "joint_attention_bwd": cfg.num_layers,
                "res_chain": 0}
    rows, first_batch = [], None
    for epoch in range(2):  # two batches of 8 per epoch
        for batch in batches_prefetch(ds, TRAIN_B, rng, prefetch=2):
            first_batch = first_batch or batch
            shapes = {k: v.shape for k, v in batch.items()}
            before = {k: w.launches for k, w in wrappers.items()}
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lora, opt_state, loss = step(tts.dit_params, lora, opt_state, gen, batch)
            loss = float(loss)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            delta = {k: w.launches - before[k] for k, w in wrappers.items()}
            rows.append((wall, loss, delta))
            log(f"# train step {len(rows) - 1}{' (warm-up)' if len(rows) == 1 else ''}, "
                f"epoch {epoch}: wall {wall * 1e3:.1f} ms, {TRAIN_B / wall:.2f} samples/s, "
                f"loss {loss:.5f}, peak memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {delta}; "
                f"batch {shapes['latent']} text {shapes['text_input_ids']} "
                f"speaker {shapes['speaker_latent']}")
            if not math.isfinite(loss) or delta != per_step:
                raise SystemExit(f"train step: loss {loss}, launches {delta}, "
                                 f"expected finite and {per_step}")
    timed = [r[0] for r in rows[1:]]
    log(f"# LoRA step at B={TRAIN_B}, {CLIP_LATENTS} latents: median "
        f"{statistics.median(timed) * 1e3:.1f} ms over {len(timed)} timed steps "
        f"({', '.join(f'{w * 1e3:.1f}' for w in timed)}), "
        f"{TRAIN_B / statistics.median(timed):.2f} samples/s; optimizer count {opt_state.count}")
    moved = max(float(ab["b"].detach().abs().max()) for ab in lora.values())
    if not moved > 0:
        raise SystemExit("no LoRA b moved from zero after the steps")
    log(f"# largest |b| after the steps: {moved:.3e} (the first update has lr 0)")
    totals = {k: w.launches for k, w in wrappers.items()}
    log(f"# launches on the training path (encode + {len(rows)} steps): {totals}")

    profile_families("one more LoRA step",
                     lambda: step(tts.dit_params, lora, opt_state, gen, first_batch))
    phase_train_grad_check(tts, dev, lora, lc, first_batch)
    return totals


def phase_train_grad_check(tts, dev, lora, lc, batch) -> None:
    """At B=1, with every b perturbed from zero and one injected t and
    noise: the LoRA gradient through K1+K3 against the same loss with the
    plain attention under autograd. rel-L2 of the whole vector < 2e-2."""
    import echo_tts_tpu_torch.models.dit as dit_mod
    from echo_tts_tpu_torch.ops.joint_attention import joint_attention_plain
    from echo_tts_tpu_torch.train.loop import tree_leaves
    from echo_tts_tpu_torch.train.lora import lora_params
    from echo_tts_tpu_torch.train.loss import compute_diffusion_loss

    gen = torch.Generator(device=dev).manual_seed(5)
    lora = {tgt: {"a": ab["a"].detach().clone().requires_grad_(),
                  "b": (0.02 * torch.randn(ab["b"].shape, generator=gen, device=dev)
                        ).requires_grad_()} for tgt, ab in lora.items()}
    b1 = {k: torch.as_tensor(v[:1], device=dev) for k, v in batch.items()}
    t = torch.full((1,), 0.6, device=dev)
    noise = torch.randn(b1["latent"].shape, generator=gen, device=dev)
    leaves = tree_leaves(lora)

    def grads():
        loss = compute_diffusion_loss(
            lora_params(tts.dit_params, lora, lc), tts.dit_cfg, None, b1["latent"],
            b1["latent_mask"], b1["text_input_ids"], b1["text_mask"], b1["speaker_latent"],
            b1["speaker_mask"], model_dtype=torch.bfloat16, t=t, noise=noise)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(loss.detach()), torch.cat([(torch.zeros_like(p) if g is None else g).flatten()
                                       for p, g in zip(leaves, gs)])

    def plain_trainable(q, k_self, v_self, segments, layout="hm", self_len=None):
        return joint_attention_plain(q, k_self, v_self, segments, layout, self_len)

    loss_k, g_k = grads()
    kernel_fn, dit_mod.joint_attention_trainable = (dit_mod.joint_attention_trainable,
                                                    plain_trainable)
    try:
        loss_p, g_p = grads()
    finally:
        dit_mod.joint_attention_trainable = kernel_fn
    r = rel_l2(g_k, g_p)
    log(f"# full-width LoRA gradient at B=1, K1+K3 vs plain attention under autograd: "
        f"rel-L2 {r:.3e} over {g_k.numel()} values (|g| {float(g_p.norm()):.3e}); "
        f"loss {loss_k:.6f} vs {loss_p:.6f}")
    if not (r < REL_L2_BOUND and torch.isfinite(g_k).all()):
        raise SystemExit("the full-width LoRA gradient disagrees with the plain attention's")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    kernels_only, slices_only = "--kernels-only" in argv, "--slices-only" in argv
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from echo_tts_tpu_torch.ops.joint_attention import joint_attention, joint_attention_bwd
    from echo_tts_tpu_torch.ops.res_chain import res_units_cl

    slice_wrappers = {"joint_attention": joint_attention, "res_chain": res_units_cl}
    train_wrappers = {**slice_wrappers, "joint_attention_bwd": joint_attention_bwd}
    if slices_only:
        phase_build(("joint_attention", "joint_attention_bwd", "res_chain"))
        tts, _ = phase_slice(dev, slice_wrappers)
        phase_train(tts, dev, train_wrappers)
    else:
        phase_build()
        phase_core_check(dev)
        phase_conv_core_check(dev)
        errs = phase_kernel_checks(dev)
        errs.update(phase_variant_checks(dev))
        launches = {"one_shot": {"joint_attention": 0, "res_chain": 0},
                    "training": {"joint_attention": 0, "joint_attention_bwd": 0, "res_chain": 0}}
        if not kernels_only:
            tts, launches["one_shot"] = phase_slice(dev, slice_wrappers)
            launches["training"] = phase_train(tts, dev, train_wrappers)
            del tts
            torch.cuda.empty_cache()
            launches["measurement"] = phase_measurement(dev)
        rows = phase_kernel_times(dev, errs, launches)
    log(f"# {smi}")
    if not slices_only:
        print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
