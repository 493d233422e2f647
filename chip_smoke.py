#!/usr/bin/env python3
"""Start the PyTorch port (echo_tts_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel checks + kernel times

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), torch/CUDA/nvcc versions;
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. TF32 off for the comparisons;
  4. each kernel against its plain PyTorch version at main-path shapes, bf16
     inputs, rel-L2 < 2e-2 (bf16 rounding gives ~1e-3, a wrong kernel O(1)):
     K1 forward, K2 residual units, K3 attention backward (each gradient);
  5. the one-shot slice at the full width of DiTConfig(has_latent_modules=
     False) and AEConfig() in bf16, random weights from a seed: one CFG
     forward and one decode through the kernels against the plain versions;
     sample_pipeline on three requests, with per-stage wall times and
     launch counts of each kernel; a torch.profiler pass over one more;
  6. the training slice on the same weights: 16 synthetic 29.72 s clips
     written to WAV, pre-encoded by EchoTTSDataset (K2), LoRA r16/alpha32
     steps at B=8 (K1 forward and recompute, K3 backward), one warm-up and
     three timed, with exact launch counts; a torch.profiler pass over one
     more step; the LoRA gradient at B=1 through K1+K3 against the plain
     attention under autograd;
  7. kernel times (CUDA events, median of 7 after warm-up) beside the plain
     version, one library call where one exists, and the bound.
The line before the last is the kernel JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
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
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median of `reps` CUDA-event timings of fn()."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_build():
    from echo_tts_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"# built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name in paths:
        ptxas = _build.BUILD_DIR / f"{name}.ptxas.txt"
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"#   {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------


def _k1_inputs(gen, g, s, h, seg_lens, dev, spk_scale=1.5, all_masked=()):
    """seq-major q/k/v (G, 1, S, H, 128) and head-major segments, bf16."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = (rnd(g, 1, s, h, 128) for _ in range(3))
    segs = []
    for i, t in enumerate(seg_lens):
        mask = torch.rand(g, 1, t, generator=gen, device=dev) < 0.8
        if i in all_masked:
            mask = torch.zeros_like(mask)
        scale = spk_scale if i == len(seg_lens) - 1 else None
        segs.append((rnd(1, h, t, 128), rnd(1, h, t, 128), mask, scale))
    return q, k, v, segs


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


def k3_check(ja, q, k, v, do, segs):
    """K1 (with its log-sum-exp) then K3 on bf16 inputs, and the plain
    backward in fp32 on the same inputs: [(name, got, ref)] per gradient."""
    g, b, s, h, _ = q.shape
    lse = torch.empty((g, b, h, s), dtype=torch.float32, device=q.device)
    out = ja._joint_attention_cuda(q, k, v, segs, "sm", None, None, lse)
    got = ja._joint_attention_bwd_cuda(q, k, v, segs, out, lse, do, "sm")
    ref = ja.joint_attention_bwd_plain(q.float(), k.float(), v.float(), f32_segments(segs),
                                       do.float(), "sm")
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

    # K2 at every decoder width and one encoder width, non-zero biases
    def units(c):
        def w(*shape, s):
            return (torch.randn(*shape, generator=gen, device=dev) * s).to(torch.bfloat16)
        return [{"snake1": (0.2 + 1.3 * torch.rand(1, c, 1, generator=gen, device=dev)).to(torch.bfloat16),
                 "snake2": (0.2 + 1.3 * torch.rand(1, c, 1, generator=gen, device=dev)).to(torch.bfloat16),
                 "conv1": {"w": w(c, c, 7, s=1.0 / math.sqrt(7 * c)), "b": w(c, s=0.3)},
                 "conv2": {"w": w(c, c, 1, s=1.0 / math.sqrt(c)), "b": w(c, s=0.3)}}
                for _ in range(3)]

    for c, t, zb in ((768, 2048, None), (384, 3000, 80), (192, 4096, None),
                     (96, 4100, [80, 13]), (64, 4096, [0, 80])):
        bsz = 1 if zb is None or isinstance(zb, int) else len(zb)
        x = torch.randn(bsz, t, c, generator=gen, device=dev).to(torch.bfloat16)
        us = units(c)
        check("res_chain", f"C={c} T={t} B={bsz} zero_below={zb}",
              rc._res_chain_cuda(x, us, (1, 3, 9), zb),
              rc.res_chain_plain(x.float(), f32_units(us), (1, 3, 9), zb))

    # K3 at the training shape (G=1, B=8, S=640, text 768 + speaker 160,
    # speaker scale 1.5), then G=3, B=2 with a T=1 all-masked segment and an
    # unaligned T=700 one; every gradient against the fp32 plain backward
    for case, args in (("training shape G=1 B=8 S=640 H=16, text 768 + speaker 160, scale 1.5",
                        (1, 8, 640, 16, (768, 160), (None, 1.5))),
                       ("G=3 B=2 S=640 H=16, T=700 + T=1 all-masked, scale 1.5",
                        (3, 2, 640, 16, (700, 1), (None, 1.5)))):
        q3, k3, v3, do3, segs3 = _k3_inputs(gen, *args, dev, all_masked=(1,) if "T=1" in case
                                            else ())
        for name, got, ref in k3_check(ja, q3, k3, v3, do3, segs3):
            check("joint_attention_bwd", f"{case}: {name}", got, ref)
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
# phase 7: kernel times
# ---------------------------------------------------------------------------


def by_path(launches: dict, name: str) -> dict:
    return {path: counts[name] for path, counts in launches.items() if name in counts}


def phase_kernel_times(dev, errs: dict, launches: dict) -> list:
    """launches: {path: {kernel: count}} from the one-shot and training runs;
    a row's `launches` is the count on the path that introduced the kernel,
    and `launches_by_path` has every path's."""
    from echo_tts_tpu_torch.ops import joint_attention as ja
    from echo_tts_tpu_torch.ops import res_chain as rc

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []

    # K1: one main-path launch: a single-branch step over text 768 and the
    # 640-latent speaker bucket (160 patches), seq-major, speaker scale 1.5
    s, h, d, t_text, t_spk = 640, 16, 128, 768, 160
    q, k, v, segs = _k1_inputs(gen, 1, s, h, (t_text, t_spk), dev)
    segs = [(kk, vv, torch.where(m, 0.0, -1e30).float(), sc) for kk, vv, m, sc in segs]
    out = torch.empty_like(q)
    ms = cuda_ms(lambda: ja._joint_attention_cuda(q, k, v, segs, "sm", None, out))
    plain_ms = cuda_ms(lambda: ja.joint_attention_plain(q, k, v, segs, "sm"))
    # library yardstick: SDPA over [k_self | k_text | k_spk*s] with the
    # concatenated additive bias (timed only; the port never calls it)
    (kt, vt, bt, _), (ksp, vsp, bsp, ssp) = segs
    qh = q[0].transpose(1, 2)
    kc = torch.cat([k[0].transpose(1, 2), kt, ksp * ssp], dim=2)
    vc = torch.cat([v[0].transpose(1, 2), vt, vsp * ssp], dim=2)
    bias = torch.cat([torch.zeros(1, s, device=dev), bt[0], bsp[0]], dim=-1)
    bias = bias[:, None, None, :].to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kc, vc, attn_mask=bias))
    t_all = s + t_text + t_spk
    flops = 4.0 * h * s * t_all * d
    nbytes = 2 * (4 * s * h * d + 2 * h * (t_text + t_spk) * d) + 4 * (t_text + t_spk)
    b_ms, b_by = bound(flops, nbytes)
    rows.append({"name": "joint_attention", "route": "cuda",
                 "source": "echo_tts_tpu_torch/csrc/joint_attention.cu",
                 "replaces": "echo_tts_tpu/ops/pallas_attention.py:49",
                 "launches": launches["one_shot"]["joint_attention"],
                 "launches_by_path": by_path(launches, "joint_attention"),
                 "max_abs_err": errs["joint_attention"], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                 "shape": f"G=1 B=1 S={s} H={h} D={d} self {s} + text {t_text} + speaker {t_spk}"})

    # K2: one residual-unit chain (3 units) at each decoder width, at the
    # row counts a 640-latent decode gives it; the JSON row is the sum
    c_t = ((768, 20480), (384, 163840), (192, 655360), (96, 1310720))
    tot = {"ms": 0.0, "plain": 0.0, "bound": 0.0, "flops": 0.0, "bytes": 0.0}
    for c, t in c_t:
        x = torch.randn(1, t, c, generator=gen, device=dev).to(torch.bfloat16)
        us = [{"snake1": torch.ones(1, c, 1, device=dev, dtype=torch.bfloat16),
               "snake2": torch.ones(1, c, 1, device=dev, dtype=torch.bfloat16),
               "conv1": {"w": (torch.randn(c, c, 7, generator=gen, device=dev) * 0.02).to(torch.bfloat16),
                         "b": (torch.randn(c, generator=gen, device=dev) * 0.1).to(torch.bfloat16)},
               "conv2": {"w": (torch.randn(c, c, 1, generator=gen, device=dev) * 0.02).to(torch.bfloat16),
                         "b": (torch.randn(c, generator=gen, device=dev) * 0.1).to(torch.bfloat16)}}
              for _ in range(3)]
        k_ms = cuda_ms(lambda: rc._res_chain_cuda(x, us, (1, 3, 9), None), reps=5)
        p_ms = cuda_ms(lambda: rc.res_chain_plain(x, us, (1, 3, 9), None), reps=5)
        flops = 3 * 2.0 * t * c * c * 8
        nbytes = 2 * 2 * t * c + 3 * 2 * (8 * c * c) + 3 * 4 * 4 * c
        b_ms, _ = bound(flops, nbytes)
        log(f"# time res_chain C={c} T={t}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {b_ms:.3f} ms")
        tot["ms"] += k_ms
        tot["plain"] += p_ms
        tot["flops"] += flops
        tot["bytes"] += nbytes
    b_ms, b_by = bound(tot["flops"], tot["bytes"])
    rows.append({"name": "res_chain", "route": "cuda",
                 "source": "echo_tts_tpu_torch/csrc/res_chain.cu",
                 "replaces": "echo_tts_tpu/ops/pallas_conv.py:60",
                 "launches": launches["one_shot"]["res_chain"],
                 "launches_by_path": by_path(launches, "res_chain"),
                 "max_abs_err": errs["res_chain"], "ms": tot["ms"], "plain_ms": tot["plain"],
                 # no single PyTorch call computes a snake/conv7/snake/1x1 unit
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 "shape": "decoder chains C=768/384/192/96 at T=20480/163840/655360/1310720, summed"})
    log(f"# time joint_attention: kernel {rows[0]['ms']:.3f} ms, plain "
        f"{rows[0]['plain_ms']:.3f} ms, sdpa {rows[0]['library_ms']:.3f} ms, "
        f"bound {rows[0]['bound_ms']:.4f} ms ({rows[0]['bound_by']})")
    rows.append(k3_times(dev, gen, errs, launches))
    return rows


def k3_times(dev, gen, errs: dict, launches: dict) -> dict:
    """K3 at the training shape (G=1, B=8, S=640, H=16, text 768, speaker 160
    at scale 1.5), with K1's out and lse of the same inputs; the plain
    backward on the same bf16 inputs; the yardstick is the backward of one
    SDPA call over [k_self | k_text | k_spk*s] with the concatenated bias
    (timed only; the port never calls it)."""
    from echo_tts_tpu_torch.ops import joint_attention as ja

    g, b, s, h, d, t_text, t_spk = 1, TRAIN_B, 640, 16, 128, 768, 160
    q, k, v, do, segs = _k3_inputs(gen, g, b, s, h, (t_text, t_spk), (None, 1.5), dev)
    lse = torch.empty((g, b, h, s), dtype=torch.float32, device=dev)
    out = ja._joint_attention_cuda(q, k, v, segs, "sm", None, None, lse)
    ms = cuda_ms(lambda: ja._joint_attention_bwd_cuda(q, k, v, segs, out, lse, do, "sm"))
    plain_ms = cuda_ms(lambda: ja.joint_attention_bwd_plain(q, k, v, segs, do, "sm"), reps=3)
    (kt, vt, bt, _), (ksp, vsp, bsp, ssp) = segs
    qh = q[0].transpose(1, 2).detach().requires_grad_()
    kc = torch.cat([k[0].transpose(1, 2), kt, ksp * ssp], dim=2).detach().requires_grad_()
    vc = torch.cat([v[0].transpose(1, 2), vt, vsp * ssp], dim=2).detach().requires_grad_()
    bias = torch.cat([torch.zeros(b, s, device=dev), bt[0], bsp[0]], dim=-1)
    bias = bias[:, None, None, :].to(torch.bfloat16)
    o_lib = torch.nn.functional.scaled_dot_product_attention(qh, kc, vc, attn_mask=bias)
    do_lib = do[0].transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(o_lib, (qh, kc, vc), do_lib, retain_graph=True))
    t_all = s + t_text + t_spk
    flops = 10.0 * g * b * h * s * t_all * d
    # q, k_self, v_self, out, dO read and dq, dk_self, dv_self written (bf16);
    # segment k, v read and dk, dv written; lse and biases read
    nbytes = (2 * 8 * g * b * s * h * d + 2 * 4 * b * h * (t_text + t_spk) * d
              + 4 * g * b * h * s + 4 * g * b * (t_text + t_spk))
    b_ms, b_by = bound(flops, nbytes)
    log(f"# time joint_attention_bwd: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"sdpa backward {lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "joint_attention_bwd", "route": "cuda",
            "source": "echo_tts_tpu_torch/csrc/joint_attention_bwd.cu",
            "replaces": "echo_tts_tpu/ops/pallas_attention.py:379",
            "launches": launches["training"]["joint_attention_bwd"],
            "launches_by_path": by_path(launches, "joint_attention_bwd"),
            "max_abs_err": errs["joint_attention_bwd"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"G={g} B={b} S={s} H={h} D={d} self {s} + text {t_text} + "
                     f"speaker {t_spk} (scale 1.5)"}


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
    if deltas[1]["res_chain"] <= deltas[0]["res_chain"]:
        raise SystemExit("the speaker prompt did not run the encoder's residual chains")
    totals = {k: w.launches for k, w in wrappers.items()}
    log(f"# launches over the three requests: {totals}")
    profile_families("request i again", lambda: sample_pipeline(tts, SHORT_TEXT, None,
                                                                rng_seed=5, sc=sc))
    return tts, totals


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
    total = sum(e.device_time_total for e in kernels) / 1e3

    def family(name: str) -> str:
        if "dq_kernel" in name or "dkdv_kernel" in name or "rowdot_kernel" in name:
            return "K3 joint_attention_bwd"
        if "joint_attention" in name:
            return "K1 joint_attention"
        if "res_unit" in name:
            return "K2 res_chain"
        if any(k in name for k in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
            return "GEMM (cuBLAS)"
        if "conv" in name.lower() or "cudnn" in name.lower():
            return "conv (cuDNN)"
        return "other (elementwise, norms, copies)"

    fam = {}
    for e in kernels:
        f = family(e.key)
        n, ms = fam.get(f, (0, 0.0))
        fam[f] = (n + e.count, ms + e.device_time_total / 1e3)
    log(f"# profile, {what}: wall {wall_ms:.1f} ms unprofiled, "
        f"{prof_wall_ms:.1f} ms profiled; device busy {total:.1f} ms = "
        f"{total / wall_ms:.1%} of the unprofiled wall")
    for f, (n, ms) in sorted(fam.items(), key=lambda kv: -kv[1][1]):
        log(f"#   {f}: {ms:.1f} ms in {n} launches ({ms / total:.1%} of device time)")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        log(f"#   top kernel {e.key[:70]}: {e.device_time_total / 1e3:.1f} ms, {e.count} launches")


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
    if len(ds) != TRAIN_CLIPS or k2 <= 0:
        raise SystemExit(f"the dataset encode did not run through K2 ({k2} launches, "
                         f"{len(ds)} samples)")
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
    kernels_only = "--kernels-only" in argv
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = phase_kernel_checks(dev)

    from echo_tts_tpu_torch.ops.joint_attention import joint_attention, joint_attention_bwd
    from echo_tts_tpu_torch.ops.res_chain import res_units_cl

    launches = {"one_shot": {"joint_attention": 0, "res_chain": 0},
                "training": {"joint_attention": 0, "joint_attention_bwd": 0, "res_chain": 0}}
    if not kernels_only:
        tts, launches["one_shot"] = phase_slice(dev, {"joint_attention": joint_attention,
                                                      "res_chain": res_units_cl})
        launches["training"] = phase_train(tts, dev, {"joint_attention": joint_attention,
                                                      "joint_attention_bwd": joint_attention_bwd,
                                                      "res_chain": res_units_cl})
        del tts
    rows = phase_kernel_times(dev, errs, launches)
    log(f"# {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
