#!/usr/bin/env python3
"""Start the PyTorch port (echo_tts_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel checks + kernel times
    python3 chip_smoke.py --slices-only   # phases 1, 5, 6, 9-13 only (K1-K5 built)
    python3 chip_smoke.py --checkpoints-only  # phases 1, 2 (K1-K5) and 13
    python3 chip_smoke.py --mesh-only     # phases 1, 2 (K1-K5) and 14

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), torch/CUDA/nvcc versions;
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel),
     with each source's build seconds and ptxas' registers and spills; a
     kernel whose wgmma ptxas serialised (C7512/C7514) is flagged, and in K2,
     the chain kernel of K2v-cl/K2v-cf/K2s and K4 it fails the run;
  3. TF32 off for the comparisons; the attention kernels' shared wgmma core
     (csrc/attention_core.cuh) on one bare tile against torch.matmul, keys
     as (T, D) and as (D, T); the residual-unit kernels' conv core
     (csrc/conv_core.cuh) on one bare tile, the tap-shifted product at
     d = 1, 3, 9 and row offsets that are no multiple of 8; K4's s8 core
     (csrc/int8_core.cuh) on one bare tile, wgmma m64nNk32 s8 at N = 64,
     128, 256 with the tiles copied by the threads and by TMA, against
     torch._int_mm (equal);
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
     multiple of 8 and not), and K2s poly against exact; K1 with no context
     segment and with the latent segment alone (the joint-uncond branch);
     K5 quant_rows and K4 int8_gemm bit for bit against their plain versions
     (K5 at D = 2048, 5888, 1280, 3328 (one read of a row) and 1000, 7000
     (two), bf16 and fp32, ragged M, an all-zero row; K4's int32 sums and
     bf16 and fp32 outputs at the trunk's (K, N) with M = 1920, 640, 576,
     192, 64, 7680, 2560, 1, 37, the encoders' (K, N) at M = 768 and 1600,
     a ragged and an odd N, K a multiple of 16 and not of 128; the grouped
     launches q/k/v/gate, w1/w3 and a context's k/v and one of four unequal
     N; every tile shape forced; K5's scale-only and codes-at-a-scale modes
     at the tp=2 and tp=4 widths, quotients at and near half-integers too,
     and K4 at every tp=2 (K, N)), and the wrappers refusing what the kernels
     do not take;
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
  9. (run after 6) the streaming slice at the full width of DiTConfig()
     (latent modules) and AEConfig() in bf16: one block's CFG forward with
     the latent segment [latent | text | speaker] through K1 against the
     plain attention at start_pos 0 (all latent keys masked: the forward
     must equal the one without the segment bit for bit) and 256, S = 64
     and 192; the stateful decode of 640 z_q frames in blocks 64 + 192 x 3
     and with 1- and 2-frame first chunks, each K2 call (zero_below 80, 48,
     16, 0) against the plain chain and the audio against decode_zq, the
     host cost of packing a step's weights; sample_pipeline_stream on the
     (64, 192) schedule with the 20 s prompt, warm-up and timed (time to
     first audio, block walls, audio-s/s, peak memory, exact K1 and K2
     launch counts, one torch.profiler pass); stream_blocks_fused at
     bench.py --blockwise's 160 x 4; a continuation from 5 s of audio;
     (f) the flattening detector and the crop on the card against the CPU
     on latents that go flat at known indices, and a 3 x 64-latent stream
     (20 steps) whose detector is forced to fire at 50: chunks of 44 and 6
     latents, equal to the unstopped stream's first 50 bit for bit;
 10. (run after 9, on its weights) batching: K1 at B=4 (one CFG block at S=64,
     rows at start_pos 0/64/256/448 with self_len 64/64/40/0) and K2 at B=4
     (one stateful decode step, rows at frame 0/1/2/64, zero_below one a
     row) against their plain versions, each row of a B=4 launch against
     the row launched alone (bit for bit), the B=4 forward and decode step
     against each row's own B=1 run (information); sample_pipeline_batch
     at B = 1, 2 and 4 (wall, CUDA-event time, aggregate audio-s/s, peak
     memory, exact K1 and K2 launches; one torch.profiler pass at B=4), each
     row of B=4 against its solo sample_pipeline; sample_pipeline_stream_batch
     at B=2 on (64, 192) against the solo streams, the rows' gap split
     between the sampled latents and the decode (the solo latents decoded
     at B=2 against B=1); a continuous group of four
     rows on 64-latent blocks (first-block and plain joins, a partial final
     block, a resize 4 -> 2; each step's wall and CUDA-event time, the state
     a row, peak memory) against the solo streams; audio rel-L2 < 2e-2;
 11. (run after 10, on its weights) serving through Engine and the HTTP
     server on 127.0.0.1: one-shot /tts of requests (i) and (ii) (the 20 s
     prompt as WAV base64, twice: the speaker cache), each body equal to the
     server's WAV of a direct sample_pipeline; /tts_stream of (ii) on
     (64, 192), its chunks equal to sample_pipeline_stream's PCM16 (time to
     first chunk at the client); four concurrent /tts of one batch key on
     Engine(max_batch=4): one batch, one request's K1 and decode K2, every
     row equal to its solo run, aggregate audio-s/s; run_trace (3 streams of
     256 latents at 0.5/s, 64-latent blocks) on a continuous, a dispatch and
     a continuous engine without the fast join: TTFA and completion p50/p95,
     achieved audio-s/s, one continuous
     row against its solo stream (rel-L2 < 2e-2); /reconstruct equal to
     ae_reconstruct; /lora with an r16 LoRA and back (the base audio bit
     for bit); set_lora while a continuous group of two 256-latent rows
     (20 steps) is live (each row stays on the old params); (g) the Gradio
     UI's handlers
     (serve/gradio_app.py:UIHandlers, which need no gradio) on (a)'s engine:
     generate of (ii) with custom shapes (text bucket 256, speaker bucket
     1024) byte-equal to a direct sample_pipeline on those buckets (K1 1920,
     K2 12), the same request with max_speaker_latent_length overridden
     missing the speaker cache, generate_stream's PCM16 equal to
     sample_pipeline_stream's, set_lora on a missing file (the error, then
     the base audio), Engine.warmup(background_tail=True) with health()
     showing the tail running and then done;
 12. (run after 11, on its weights) the sampler levers and the int8 trunk:
     request (i) with joint_uncond, uncond_cache_interval=2 and midpoint at
     20 steps (wall, CUDA-event time, exact K1 and K2 launches counted from
     the schedule, rel-L2 from the Euler-40 request as information); the
     time to quantize the params; bench/quant_snr.py's latent SNR of the
     int8 trunk against bf16, trunk only and with the encoders (>= 40 dB);
     one int8 request (i) (exact K1, K2, K4, K5 launches, peak memory, a
     profile by family beside the bf16 request's on the same weights) and
     one int8 stream on (64, 192) beside the same stream in bf16;
     Engine(int8=True)
     behind the HTTP server: /tts byte-equal to the direct call, set_lora
     re-quantizing the merge and reverting to the int8 base bytes, a /tts
     with "joint_uncond" in the body; (f) Engine(int8=True, continuous=True)
     with two 192-latent streams (20 steps) in one group of two rows, each
     row against its int8 solo stream, exact K1, K2, K4 and K5 launches;
 13. (run after 12, on weights of its own) checkpoints and the entry points
     that load them: DiTConfig() with its latent modules in bf16 (random
     values from bench/fast_init.py), AEConfig() in fp32 with weight-norm
     pairs and a PCA state, written under the reference's tensor names by
     the port's safetensors writer and loaded back (the DiT with and without
     its blockwise modules), every leaf against what was written, with
     write and load seconds and the peak host RSS; serve --dit/--ae/--pca
     behind HTTP (/tts request (i) equal to the direct call, K1 1920 and K2
     12; the same as "format": "mp3", decoded by libmpg123, correlation >
     0.99); --int8 --int8-cache twice (quantize and save, then load; equal
     bodies, K4 and K5 3840 each); batch_synthesize at --max-batch 4 with a
     20 s 48 kHz prompt as WAV and as MP3, every WAV equal to its row of the
     direct batch call; finetune_lora one epoch over three 29.72 s clips (K3)
     and its adapter through /lora and back; convert_checkpoint ae and dit
     reloaded to the same bits; the native resampler against scipy,
     get_delay, and decode_codes against decode_zq (K2 12). The MP3 steps
     print "mp3: skipped" where the libraries are missing;
 14. (run after 13, on weights of its own) the mesh and the fleet
     (echo_tts_tpu_torch/parallel/) at the full width of
     DiTConfig(has_latent_modules=False) and AEConfig() in bf16, seeds 0 and 1
     in every process: (a) a world-size-1 NCCL mesh, request (i) through the
     sharded tree equal to the direct call; (b) tp=2 as two ranks on cuda:0
     over gloo (NCCL takes one rank a card): request (i) at 640 latents and
     MESH_STEPS (20) steps against tp=1 (rel-L2 of latents and audio < 2e-2),
     each rank's launches (K1 960, K2 12), peak memory and all-reduce seconds;
     the int8 trunk the same way (K4 1920, K5 960 and each tp mode 960) with one
     layer's row-sharded products bit for bit; a B=2 training batch's loss
     and gradients through K1 + K3 against tp=1 and one step; an Engine
     whose rank 1 alone cannot read a LoRA adapter: set_lora raises on both
     ranks and neither takes a new tree (digests of each rank's DiT tree,
     all-gathered); `serve --tp 2
     --dist-backend gloo` over HTTP, /tts of (i) and a /lora swap, bodies
     equal to the direct tp=2 calls; (c) dp=2, four rows two a rank against
     sample_pipeline_batch at B=4 (rel-L2 < 2e-2), run_weak_scaling as
     information (the ranks share one card); (d) batch_synthesize --workers
     2 --worker-die-after 1:1 --max-batch 1 on four 640-latent requests,
     byte-equal to one process, dead_workers [1], reassigned >= 1; (e) a
     sharded torch.distributed.checkpoint save and load at tp=2, equal bits;
     (f) continuous stream groups on a tp=2 engine, two ranks on cuda:0 over
     gloo with `serve --random`'s weights (DiTConfig() with its latent
     modules): Engine(mesh, max_batch=4, continuous=True), three 128-latent
     streams on 64-latent blocks at MESH_STEPS (the second and third
     admitted into the first's group at one boundary: one resize, two fast
     joins), then two 192-latent streams on an int8 engine at
     CONT_INT8_STEPS (10) in one group of two rows (K4, K5 and K5's tp
     modes), each row within 2e-2 of the tp=2 solo stream of its seed on
     its trunk, rank 1's launches and all-reduce calls equal to rank 0's
     and to the count from the group's samplings;
  7. the measurement path: the entry points of echo_tts_tpu_torch/bench/
     (attention_variants, conv_kernel_variants, conv_variants, attention,
     profile_breakdown) at their full shapes, each printing its JSON line,
     with the launch counts set to 0 before each and read after it;
  8. kernel times (CUDA events, median of 7 after warm-up; for the attention
     kernels, K3 and its SDPA-backward yardstick included, over replays of a
     CUDA graph of 20 launches) beside the plain
     version, one library call where one exists, and the bound, for K1 (at
     the one-branch, the three-branch, the training and the streaming
     shape, with both q tiles, and the wrapper's host microseconds per
     launch), K2 (a chain at each decoder and encoder width and the four
     chains of a 64-latent stream step, beside the cuDNN composition of the
     same chain), K3, K1v, K2v-cl, K2v-cf and K2s (over replays of a graph
     of 3 chains, and call by call as well: the wrappers' host work to pack
     the weights is then included, as in the readings before); and K2v-cf
     against K2v-cl (sin) timed in turns at both widths of the entry point;
     K4, one trunk layer's products as the int8 path launches them (four
     launches, two of them grouped) at M = 1920, 640, 576, 192 and 64, with
     TOP/s and x bound, beside one launch a weight, each tile shape forced,
     torch._int_mm + the dequantize and the bf16 torch.matmul it replaces,
     and each launch alone; K5, a layer's four quantizations at the same M,
     with GB/s and x bound; the host time a call of K4's and K5's wrappers
     and of encoding one TMA tensor map; all over CUDA-graph replays.
The line before the last is the kernel JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX. --slices-only is for
comparing two trees end to end in one call on one card (run them in turns:
the host's clock moves more between calls than a kernel change moves it); it
prints no kernel JSON. The build of the nine sources runs in parallel;
ptxas serialising a wgmma of K2, of the chain kernel of K2v-cl, K2v-cf and
K2s, or of K4 (C7512/C7514) fails the run.
"""
from __future__ import annotations

import dataclasses
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

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and int8 tensor core, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
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


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak * 1e3
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
    from echo_tts_tpu_torch.native import mp3_py

    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    log(f"# host codecs: g++ {gxx}; libmpg123 "
        f"{'loaded' if mp3_py.mp3_available() else 'not found'}, libmp3lame "
        f"{'loaded' if mp3_py.mp3_encode_available() else 'not found'}")
    return smi


PTXAS: dict = {}  # source -> kernel -> registers, spill bytes, wgmma serialized (phase 2)
SERIALIZED = ("C7512", "C7514")  # ptxas: "wgmma.mma_async instructions are serialized"
SERIAL_FREE = ("res_chain", "res_chain_variants", "int8_gemm")  # must show none: the run fails


def _kernel_name(mangled: str) -> str:
    """kernel<its integer and bool template arguments>: joint_attention_kernel<2>,
    res_chain_cl_kernel<192, 0> (width, snake code), dq_kernel. The name is
    the `<length><name>` of the mangling that ends in "_kernel"; a digit run
    may carry a namespace's digits before the length (int8_gemm_kernel)."""
    for run in re.finditer(r"\d+", mangled):
        for i in range(run.start(), run.end()):
            n = int(mangled[i:run.end()])
            name = mangled[run.end():run.end() + n]
            if len(name) == n and re.fullmatch(r"[a-z][a-z0-9_]*_kernel", name):
                rest = mangled[run.end() + n:]
                args = (re.findall(r"L[ib](\d+)E", rest.split("Ev", 1)[0])
                        if rest.startswith("I") else [])
                return name + (f"<{', '.join(args)}>" if args else "")
    return mangled


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


def phase_int8_core_check(dev) -> None:
    """The s8 side of the core (csrc/int8_core.cuh), K4's products, on one
    bare tile before K4 is checked: a (64, 128) . b (N, 128)^T in int32 from
    four k32 slices of wgmma s8 at every width K4 issues (N = 64, 128, 256),
    the tiles copied into swizzled shared memory by the threads and by TMA,
    against torch._int_mm: equal (the sums are exact)."""
    from echo_tts_tpu_torch.ops import int8_gemm as ig

    gen = torch.Generator(device=dev).manual_seed(14)
    failures = []
    for n in (64, 128, 256):
        a = torch.randint(-127, 128, (64, 128), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, 128), generator=gen, device=dev, dtype=torch.int8)
        ref = torch._int_mm(a, b.t().contiguous())
        for use_tma in (False, True):
            got = ig.core_products_s8(a, b, use_tma)
            torch.cuda.synchronize()
            same = torch.equal(got, ref)
            log(f"# check int8_core [wgmma m64n{n}k32 s8, tiles by "
                f"{'TMA' if use_tma else 'the threads'}]: equal to torch._int_mm: {same}; "
                f"{int((got != ref).sum())} sums differ")
            if not same:
                failures.append(f"N={n} tma={use_tma}")
    if failures:
        raise SystemExit("the s8 wgmma core disagrees with torch._int_mm: " + "; ".join(failures))


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

    # K1 with no context segment and with the latent segment alone: the
    # joint-uncond branch of the one-shot path (text and speaker skipped)
    # and of a stream; G=1 and 2, S=64 and 640, self_len given and not
    for g in (1, 2):
        for s_ in (64, 640):
            for seg_lens in ((), (160,)):
                for sl_rows in (None, (s_, s_ // 2 + 3)):
                    b_ = 1 if sl_rows is None else 2
                    q, k, v, segs = _k1_inputs(gen, g, s_, 16, seg_lens, dev, b=b_)
                    segs = [(kk, vv, m, None) for kk, vv, m, _ in segs]
                    sl = None if sl_rows is None else torch.tensor(sl_rows, dtype=torch.int32,
                                                                   device=dev)
                    before = ja.joint_attention.launches
                    got = ja.joint_attention(q, k, v, segs, "sm", self_len=sl)
                    if ja.joint_attention.launches - before != 1:
                        failures.append(f"joint_attention nseg={len(segs)}: no launch")
                    check("joint_attention",
                          f"nseg {len(segs)} ({'latent 160' if segs else 'no context'}), G={g} "
                          f"B={b_} S={s_}, self_len {sl_rows}", got,
                          ja.joint_attention_plain(q.float(), k.float(), v.float(),
                                                   f32_segments(segs), "sm", sl))

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


def int8_rows(gen, m, k, dev):
    """bf16 activation rows (M, K) and their codes and scales (M,) from the
    plain K5, as the int8 trunk hands them to K4."""
    from echo_tts_tpu_torch.ops.quant_rows import quant_rows_plain

    h = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    a, s_row = quant_rows_plain(h)
    return h, a, s_row.reshape(-1)


def int8_weight(gen, k, n, dev):
    """A random bf16 (K, N) weight of the initializer's scale and its
    quantized leaf (codes (N, K), scales (N,))."""
    from echo_tts_tpu_torch.models.quant import quantize_weight

    w = ((torch.rand(k, n, generator=gen, device=dev) * 2 - 1) * k ** -0.5).to(torch.bfloat16)
    return w, quantize_weight(w)


# the trunk's projections (K, N) a layer: wq wk wv gate wo, w1 w3, w2
INT8_KN = ((2048, 2048), (2048, 5888), (5888, 2048))
# the encoders' (K, N): wq..wo, w1 w3, w2, and the context K/V projections
INT8_ENC_KN = ((1280, 1280), (1280, 3328), (3328, 1280), (1280, 2048))
# a trunk layer as the int8 path launches K4: the weights of each launch
INT8_LAYER_LAUNCHES = (((2048, 2048),) * 4, ((2048, 2048),), ((2048, 5888),) * 2,
                       ((5888, 2048),))
# M the int8 paths launch: one-shot CFG / outside the window, stream blocks of
# 64 and 192 inside and outside the window, a one-shot batch of four
INT8_M = (1920, 640, 576, 192, 64, 7680, 2560)


def near_ties(gen, m, d, dev) -> torch.Tensor:
    """fp32 rows whose quotients x / s lie on half-integers or a few ulps
    from them (where K5 divides instead of multiplying by 1 / s): each row's
    amax is its first element (127 in the first half of the rows, so s = 1
    and the ties are exact), the rest (k + 0.5) * s moved by -2..2 ulps."""
    amax = torch.rand(m, 1, generator=gen, device=dev) * 10 + 0.01
    amax[: m // 2] = 127.0
    k = torch.randint(-127, 127, (m, d), generator=gen, device=dev).float() + 0.5
    x = k * (amax / 127.0)
    for _ in range(2):
        step = torch.randint(-1, 2, (m, d), generator=gen, device=dev).float()
        x = torch.where(step == 0, x, torch.nextafter(x, step * torch.inf))
    x[:, :1] = amax
    return x


def int8_gemm_case(what, gen, m, k, ns, dev, failures, tile=None, dtypes=None):
    """K4 on one activation against the weights (K, n) for n in `ns` (one
    weight: int8_gemm; several: one int8_gemm_grouped launch) against the
    plain version, int32 sums and bf16 and fp32 outputs bit for bit, one
    launch a call; a failure is appended to `failures`."""
    from echo_tts_tpu_torch.ops import int8_gemm as ig

    _, a, s_row = int8_rows(gen, m, k, dev)
    ws = [(qw["q"], qw["s"]) for qw in (int8_weight(gen, k, n, dev)[1] for n in ns)]
    bad = []
    for dtype in dtypes or (torch.int32, torch.bfloat16, torch.float32):
        before = ig.int8_gemm.launches
        if len(ws) == 1:
            got = [ig.int8_gemm(a, s_row, *ws[0], dtype, tile=tile)]
        else:
            got = ig.int8_gemm_grouped(a, s_row, ws, dtype, tile=tile)
        torch.cuda.synchronize()
        ref = ig.int8_gemm_grouped_plain(a, s_row, ws, dtype)
        if ig.int8_gemm.launches - before != 1:
            bad.append(f"{dtype} launches {ig.int8_gemm.launches - before}")
        bad += [f"{str(dtype)[6:]} out {i}" for i, (x, y) in enumerate(zip(got, ref))
                if not torch.equal(x, y)]
    log(f"# check int8_gemm [{what}: M {m}, K {k}, N {list(ns)}"
        f"{'' if tile is None else f', tile {tile}'}]: equal to the plain version: "
        f"{not bad}{'' if not bad else ' ' + ', '.join(bad)}")
    if bad:
        failures.append(f"int8_gemm {what} ({m}, {k}, {list(ns)}, tile {tile})")


def phase_int8_checks(dev) -> dict:
    """K5 (row quantize) and K4 (int8 GEMM + dequantize) against their plain
    versions, bit for bit. K5 at the widths the paths quantize (2048, 5888,
    1280, 3328: one read of a row) and at two others (1000, 7000: two reads),
    bf16 and fp32, ragged M, an all-zero row, and rows whose quotients lie
    on or a few ulps from half-integers (where the kernel divides), against
    the plain version on the CPU (IEEE division, round half to even). K4's int32 sums and bf16
    and fp32 outputs against the plain version (float64 sums, exact here):
    every trunk (K, N) at every M the int8 paths launch (and 1, 37), the
    encoders' (K, N) at M = 768 and 1600, a ragged and an odd N, K a
    multiple of 16 and not of 128; every grouped launch the paths make
    (q/k/v/gate, w1/w3, a context's k/v) and one of four unequal N; each
    tile shape forced. The wrappers refuse what the kernels do not take."""
    from echo_tts_tpu_torch.ops import int8_gemm as ig
    from echo_tts_tpu_torch.ops import quant_rows as qr

    gen = torch.Generator(device=dev).manual_seed(12)
    failures = []
    for m, d, ties in ((1920, 2048, False), (1920, 5888, False), (192, 2048, False),
                       (37, 2048, False), (768, 1280, False), (1600, 3328, False),
                       (37, 5888, False), (37, 1000, False), (64, 7000, False),
                       (256, 2048, True), (64, 1000, True)):
        for dtype in (torch.bfloat16, torch.float32):
            h = near_ties(gen, m, d, dev) if ties else torch.randn(m, d, generator=gen,
                                                                    device=dev) * 3
            h = h.to(dtype)
            h[3] = 0
            before = qr.quant_rows.launches
            q, s = qr.quant_rows(h)
            torch.cuda.synchronize()
            rq, rs = qr.quant_rows_plain(h.cpu())
            same = torch.equal(q.cpu(), rq) and torch.equal(s.cpu(), rs)
            log(f"# check quant_rows [({m}, {d}) {str(dtype)[6:]}, "
                f"{'one read' if qr.one_read(d, dtype) else 'two reads'}, "
                f"{'quotients at and near half-integers, ' if ties else ''}row 3 all zero]: "
                f"codes and scales equal to the plain version: {same}; "
                f"{int((q.cpu() != rq).sum())} codes differ")
            if not same or qr.quant_rows.launches - before != 1:
                failures.append(f"quant_rows ({m}, {d}) {dtype}")
    for m in INT8_M + (1, 37):
        for k, n in INT8_KN:
            int8_gemm_case("trunk", gen, m, k, (n,), dev, failures)
    for m in (768, 1600):
        for k, n in INT8_ENC_KN:
            int8_gemm_case("encoders", gen, m, k, (n,), dev, failures)
    for what, m, k, ns in (("ragged N", 37, 2048, (200,)), ("odd N", 37, 1040, (203,)),
                           ("K a multiple of 16, not of 128", 640, 2064, (2048,))):
        int8_gemm_case(what, gen, m, k, ns, dev, failures)
    for m in (64, 192, 576, 640, 1920, 7680):
        int8_gemm_case("grouped q/k/v/gate", gen, m, 2048, (2048,) * 4, dev, failures)
        int8_gemm_case("grouped w1/w3", gen, m, 2048, (5888,) * 2, dev, failures)
    for m in (768, 1600):
        int8_gemm_case("grouped context k/v", gen, m, 1280, (2048,) * 2, dev, failures)
    int8_gemm_case("grouped, four unequal N", gen, 37, 1040, (200, 2048, 72, 203), dev,
                   failures)
    # tensor parallelism: K5's scale-only and codes-at-a-scale modes at the
    # widths of the row-sharded products at tp=2 and tp=4 (a row split in
    # `parts`), quotients at and near half-integers too, and K4 at every
    # (K, N) a tp=2 rank launches (int32 out for the row-sharded ones)
    for m, d, parts, ties in ((1920, 1024, 2, False), (1920, 2944, 2, False),
                              (640, 1024, 2, False), (768, 640, 2, False),
                              (1600, 1664, 2, False), (37, 1000, 2, False),
                              (1920, 512, 4, False), (1920, 1472, 4, False),
                              (768, 320, 4, False), (1600, 832, 4, False),
                              (1920, 1024, 2, True), (1920, 2944, 2, True),
                              (1920, 512, 4, True), (1920, 1472, 4, True)):
        for dtype in (torch.bfloat16, torch.float32):
            h = (near_ties(gen, m, parts * d, dev) if ties
                 else torch.randn(m, parts * d, generator=gen, device=dev) * 3).to(dtype)
            h[3] = 0
            pieces = [x.contiguous() for x in h.split(d, dim=1)]
            before = (qr.quant_rows_scale.launches, qr.quant_rows_at.launches)
            scales = [qr.quant_rows_scale(x) for x in pieces]
            s_max = torch.stack(scales).amax(0)
            codes = [qr.quant_rows_at(x, s_max) for x in pieces]
            torch.cuda.synchronize()
            same = all(torch.equal(sx.cpu(), qr.quant_rows_scale_plain(x.cpu()))
                       and torch.equal(qx.cpu(), qr.quant_rows_at_plain(x.cpu(), s_max.cpu()))
                       for x, sx, qx in zip(pieces, scales, codes))
            rq, rs = qr.quant_rows_plain(h.cpu())
            whole = torch.equal(s_max.cpu(), rs) and torch.equal(torch.cat(codes, 1).cpu(), rq)
            log(f"# check quant_rows_scale / quant_rows_at [{parts} parts of ({m}, {parts * d}) "
                f"{str(dtype)[6:]}, "
                f"{'codes in registers' if qr.at_registers(d, dtype) else 'codes streamed'}, "
                f"{'quotients at and near half-integers, ' if ties else ''}row 3 all zero]: each "
                f"equal to the plain version: {same}; the max of the parts' scales and the codes "
                f"at it equal the whole row's: {whole}")
            launched = (qr.quant_rows_scale.launches - before[0],
                        qr.quant_rows_at.launches - before[1])
            if not (same and whole) or launched != (parts, parts):
                failures.append(f"quant_rows tp modes ({m}, {d}) x {parts} {dtype} {launched}")
    for m in (1920, 640):
        for what, k, ns in (("tp=2 q/k/v/gate", 2048, (1024,) * 4), ("tp=2 wo", 1024, (2048,)),
                            ("tp=2 w1/w3", 2048, (2944,) * 2), ("tp=2 w2", 2944, (2048,))):
            int8_gemm_case(what, gen, m, k, ns, dev, failures)
    for m in (768, 1600):
        for what, k, ns in (("tp=2 encoders q/k/v/gate", 1280, (640,) * 4),
                            ("tp=2 encoders wo", 640, (1280,)),
                            ("tp=2 encoders w1/w3", 1280, (1664,) * 2),
                            ("tp=2 encoders w2", 1664, (1280,)),
                            ("tp=2 context k/v", 1280, (1024,) * 2)):
            int8_gemm_case(what, gen, m, k, ns, dev, failures)
    for tile in ig.TILES:
        for what, m, k, ns in (("tile", 1920, 2048, (2048,)), ("tile", 192, 5888, (2048,)),
                               ("tile", 37, 1040, (203,)), ("tile, grouped", 576, 2048,
                                                            (2048,) * 4)):
            int8_gemm_case(what, gen, m, k, ns, dev, failures, tile=tile,
                           dtypes=(torch.int32, torch.bfloat16))
    a8 = torch.zeros(4, 40, dtype=torch.int8, device=dev)
    sv = torch.ones(4, device=dev)
    w16 = torch.zeros(16, 64, dtype=torch.int8, device=dev)
    a32 = torch.zeros(4, 64, dtype=torch.int8, device=dev)
    for what, call, exc in (
            ("K not a multiple of 16", lambda: ig.int8_gemm(a8, sv, a8, sv, torch.bfloat16),
             ValueError),
            ("float activations", lambda: ig.int8_gemm(a8[:, :32].float(), sv, w16[:, :32], sv,
                                                       torch.bfloat16), TypeError),
            ("a transposed weight", lambda: ig.int8_gemm(
                torch.zeros(64, 16, dtype=torch.int8, device=dev), torch.ones(64, device=dev),
                w16.t(), torch.ones(64, device=dev), torch.bfloat16), ValueError),
            ("five weights in one launch", lambda: ig.int8_gemm_grouped(
                a32, sv, [(w16, torch.ones(16, device=dev))] * 5, torch.bfloat16), ValueError),
            ("weights of another K", lambda: ig.int8_gemm_grouped(
                a32, sv, [(w16, torch.ones(16, device=dev)), (w16[:, :32].contiguous(),
                                                              torch.ones(16, device=dev))],
                torch.bfloat16), ValueError),
            ("a tile it has no instance of", lambda: ig.int8_gemm(
                a32, sv, w16, torch.ones(16, device=dev), torch.bfloat16, tile=(64, 64)),
             ValueError),
            ("D not a multiple of 8", lambda: qr.quant_rows(torch.zeros(4, 12, device=dev)),
             ValueError),
            ("int8 rows", lambda: qr.quant_rows(a8), TypeError)):
        before = (ig.int8_gemm.launches, qr.quant_rows.launches)
        try:
            call()
        except exc as e:
            log(f"# the int8 wrappers refuse {what}: {type(e).__name__}")
        else:
            failures.append(f"the int8 wrappers accepted {what}")
        if (ig.int8_gemm.launches, qr.quant_rows.launches) != before:
            failures.append(f"a refused call ({what}) launched")
    if failures:
        raise SystemExit("int8 kernel checks failed: " + "; ".join(failures))
    return {"int8_gemm": 0.0, "quant_rows": 0.0, "quant_rows_scale": 0.0, "quant_rows_at": 0.0}


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
    k1 = [k1_times(dev, gen, *shape) for shape in K1_SHAPES + K1_STREAM + K1_BATCH]
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
    return rows + variant_times(dev, errs, launches) + int8_times(dev, errs, launches)


# the chains of one 640-latent decode and of one 640-latent encode (B=1)
K2_DECODER = ((768, 20480), (384, 163840), (192, 655360), (96, 1310720))
K2_ENCODER = ((64, 1310720), (128, 655360), (256, 163840), (512, 20480))
K2_RATES = (4 * 8, 8, 4, 2)  # AEConfig(): the quantizer's x4, then each decoder block's stride


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


def k2_chain_times(dev, gen, c, t, zero_below=None, b=1) -> dict:
    """One three-unit chain of K2 at width c, T rows and B batch rows:
    kernel, plain version, the cuDNN composition (library_chain), bound."""
    from echo_tts_tpu_torch.bench.timing import cuda_ms
    from echo_tts_tpu_torch.ops import res_chain as rc

    x = torch.randn(b, t, c, generator=gen, device=dev).to(torch.bfloat16)
    us = [{"snake1": torch.ones(1, c, 1, device=dev, dtype=torch.bfloat16),
           "snake2": torch.ones(1, c, 1, device=dev, dtype=torch.bfloat16),
           "conv1": {"w": (torch.randn(c, c, 7, generator=gen, device=dev) * 0.02
                           ).to(torch.bfloat16),
                     "b": (torch.randn(c, generator=gen, device=dev) * 0.1).to(torch.bfloat16)},
           "conv2": {"w": (torch.randn(c, c, 1, generator=gen, device=dev) * 0.02
                           ).to(torch.bfloat16),
                     "b": (torch.randn(c, generator=gen, device=dev) * 0.1).to(torch.bfloat16)}}
          for _ in range(3)]
    with torch.no_grad():
        k_ms = cuda_ms(lambda: rc._res_chain_cuda(x, us, (1, 3, 9), zero_below), reps=5)
        p_ms = cuda_ms(lambda: rc.res_chain_plain(x, us, (1, 3, 9), zero_below), reps=3,
                       warmup=1)
        x_cf = x.transpose(1, 2).contiguous()
        l_ms = cuda_ms(lambda: library_chain(x_cf, us), reps=5)
    flops = 3 * 2.0 * b * t * c * c * 8
    nbytes = 2 * 2 * b * t * c + 3 * 2 * (8 * c * c) + 3 * 4 * 4 * c
    b_ms, b_by = bound(flops, nbytes)
    return {"C": c, "T": t, "B": b, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
            "bound_by": b_by, "flops": flops, "bytes": nbytes}


def k2_times(dev, gen, errs: dict, launches: dict) -> dict:
    """K2, one three-unit chain at each decoder and each encoder width at
    the row counts a 640-latent decode and encode give it, and the four
    chains of one streaming decode step of a 64-latent first block (rows +
    chain_ctx, zero_below = chain_ctx) and of a continuous group's step at
    B=4 (rows at frame 0, 1, 2 and 64: zero_below one a row): kernel, plain
    version, the cuDNN composition (library_chain), bound. The JSON row's
    times are the decoder chains summed; `widths` has each, `stream_step`
    and `group_step` the steps'."""
    from echo_tts_tpu_torch.ops.res_chain import chain_ctx

    widths, tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    ctx = chain_ctx()
    step, group = {k: 0.0 for k in tot}, {k: 0.0 for k in tot}
    stream = tuple((c, t // 10 + ctx) for c, t in K2_DECODER)  # 64 of 640 latents
    for stack, shapes in (("decoder", K2_DECODER), ("encoder", K2_ENCODER),
                          ("stream step", stream), ("group step B=4", stream)):
        for i, (c, t) in enumerate(shapes):
            zb, b = None, 1
            if stack == "stream step":
                zb = ctx
            elif stack == "group step B=4":
                rate = math.prod(K2_RATES[:i + 1])  # rows a z_q frame at chain i
                zb, b = [min(max(ctx - pos * rate, 0), ctx) for pos in (0, 1, 2, 64)], 4
            r = k2_chain_times(dev, gen, c, t, zb, b)
            log(f"# time res_chain {stack} C={c} T={t}: kernel {r['ms']:.3f} ms "
                f"({r['ms'] / r['bound_ms']:.2f}x its bound, {r['flops'] / r['ms'] / 1e9:.0f} "
                f"TFLOP/s), plain {r['plain_ms']:.3f} ms, cuDNN composition "
                f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
            widths.append({"stack": stack, **{k: r[k] for k in ("C", "T", "ms", "plain_ms",
                                                                 "library_ms", "bound_ms")}})
            acc = {"decoder": tot, "stream step": step, "group step B=4": group}.get(stack)
            if acc is not None:
                for k in acc:
                    acc[k] += r[k]
    b_ms, b_by = bound(tot["flops"], tot["bytes"])
    s_ms, s_by = bound(step["flops"], step["bytes"])
    log(f"# time res_chain, the four decoder chains of a decode: kernel {tot['ms']:.3f} ms, "
        f"cuDNN composition {tot['library_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
        f"bound {b_ms:.3f} ms")
    log(f"# time res_chain, the four chains of a 64-latent stream step (T = rows + {ctx}, "
        f"zero_below {ctx}): kernel {step['ms']:.3f} ms, cuDNN composition "
        f"{step['library_ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, bound {s_ms:.3f} ms")
    g_ms, g_by = bound(group["flops"], group["bytes"])
    log(f"# time res_chain, the four chains of a B=4 group step (the same T, zero_below one a "
        f"row): kernel {group['ms']:.3f} ms, cuDNN composition {group['library_ms']:.3f} ms, "
        f"plain {group['plain_ms']:.3f} ms, bound {g_ms:.3f} ms")
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
            "stream_step": {"ms": step["ms"], "plain_ms": step["plain_ms"],
                            "library_ms": step["library_ms"], "bound_ms": s_ms,
                            "bound_by": s_by, "shape": f"C=768/384/192/96 at T = "
                            + "/".join(str(t) for _, t in stream) + f", zero_below {ctx}"},
            "group_step": {"ms": group["ms"], "plain_ms": group["plain_ms"],
                           "library_ms": group["library_ms"], "bound_ms": g_ms,
                           "bound_by": g_by, "shape": "the stream step's chains at B=4, rows "
                           "at z_q frame 0/1/2/64, zero_below one a row"},
            "shape": "decoder chains C=768/384/192/96 at T=20480/163840/655360/1310720, summed"}


K1_SHAPES = (("one branch", 1, 1, (768, 160)), ("three branches", 3, 1, (768, 1600)),
             ("training", 1, 8, (768, 160)))
# the streaming cond branch at a 192- and a 64-latent block: latent 160 +
# text 768 + the 20 s prompt's speaker bucket of 160 patches
K1_STREAM = tuple((f"stream, cond branch, S={s}", 1, 1, (160, 768, 160), s,
                   ("latent", "text", "speaker")) for s in (192, 64))
# a continuous group's step at B=4 (64-latent blocks), the cond branch
K1_BATCH = (("group step, cond branch, S=64", 1, 4, (160, 768, 160), 64,
             ("latent", "text", "speaker")),)
GRAPH_ITERS = 20  # calls per timed CUDA-graph replay, for kernels shorter than their launch


def k1_times(dev, gen, what, g, b, seg_lens, s=640, names=("text", "speaker")) -> dict:
    """K1 at S (640), H=16, D=128, seq-major, speaker scale 1.5, fp32 biases:
    device ms (CUDA-graph replays of 20 launches: the kernel is shorter than
    the wrapper's host time) with 64 and with 128 query rows a block, the
    plain version, the bound, and the library yardstick: one SDPA call over
    [k_self | k_text | k_spk*s] with the concatenated additive bias (timed
    only; the port never calls it)."""
    from echo_tts_tpu_torch.bench.timing import cuda_ms
    from echo_tts_tpu_torch.ops import joint_attention as ja

    h, d = 16, 128
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
    tq = ja.pick_tq(s)
    ms = by_tq[tq]
    log(f"# time joint_attention, {what} (G={g} B={b}): kernel {ms:.4f} ms at tq {tq} "
        f"(tq 64: {by_tq[64]:.4f}, tq 128: {by_tq[128]:.4f}; {flops / ms / 1e9:.0f} TFLOP/s), "
        f"plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "tq": tq, "ms_tq64": by_tq[64], "ms_tq128": by_tq[128],
            "shape": f"{what}: G={g} B={b} S={s} H={h} D={d} self {s} + "
                     + " + ".join(f"{n} {t}" for n, t in zip(names, seg_lens)) + " (scale 1.5)"}


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


def int8_layer(gen, m, dev) -> list:
    """One trunk layer's operands at M rows, launch by launch as the int8
    path makes them (INT8_LAYER_LAUNCHES): the bf16 rows, their codes and
    scales, and each weight in bf16, quantized, and transposed for
    torch._int_mm."""
    out = []
    for kns in INT8_LAYER_LAUNCHES:
        k = kns[0][0]
        h, a, s_row = int8_rows(gen, m, k, dev)
        ws = [int8_weight(gen, k, n, dev) for _, n in kns]
        out.append({"h": h, "a": a, "s_row": s_row, "k": k, "ns": [n for _, n in kns],
                    "w_bf": [w for w, _ in ws], "ws": [(q["q"], q["s"]) for _, q in ws],
                    "wt": [q["q"].t().contiguous() for _, q in ws]})
    return out


def layer_work(m: int, launches=INT8_LAYER_LAUNCHES):
    """Operations and bytes (inputs read once, bf16 outputs written once)
    of a layer's int8 products at M rows."""
    flops = sum(2.0 * m * k * n for kns in launches for k, n in kns)
    nbytes = sum(m * kns[0][0] + 4 * m + sum(n * k + 4 * n + 2 * m * n for k, n in kns)
                 for kns in launches)
    return flops, nbytes


def int8_host_us(dev, gen, calls: int = 400) -> dict:
    """What a call costs the host: K4's wrapper with one weight and with the
    four of q/k/v/gate, and K5's, at M = 192 (each shorter on the card than
    on the host, so the queue never fills), `calls` calls on the host's
    clock up to the last return, one synchronize after; and the encoding of
    one TMA tensor map (K4 makes one for the activation and one a weight on
    every call) inside the library."""
    from echo_tts_tpu_torch.ops import int8_gemm as ig
    from echo_tts_tpu_torch.ops import quant_rows as qr

    (qkvg, wo, *_) = int8_layer(gen, 192, dev)
    runs = {"int8_gemm, one weight": lambda: ig.int8_gemm(wo["a"], wo["s_row"], *wo["ws"][0],
                                                           torch.bfloat16),
            "int8_gemm_grouped, four weights": lambda: ig.int8_gemm_grouped(
                qkvg["a"], qkvg["s_row"], qkvg["ws"], torch.bfloat16),
            "quant_rows": lambda: qr.quant_rows(qkvg["h"])}
    out = {}
    with torch.no_grad():
        for name, run in runs.items():
            for _ in range(20):
                run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                run()
            out[name] = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()
    out["tensor map encode"] = ig.tensor_map_us(qkvg["a"])
    log("# int8 wrappers, host time a call (M = 192, " + str(calls) + " calls, one synchronize "
        "after): " + ", ".join(f"{k} {v:.2f} us" for k, v in out.items()))
    return out


def int8_times(dev, errs: dict, launches: dict) -> list:
    """K4 and K5 at the trunk's shapes, over CUDA-graph replays: at each M
    the int8 paths launch (1920, 640, 576, 192, 64), one trunk layer's
    products as the path launches them (four K4 launches: q/k/v/gate
    grouped, wo, w1/w3 grouped, w2) timed as one unit, so the 57 MB of
    weights a layer stream from memory as in a forward; beside them the same
    layer with one launch a weight, with each tile shape forced, the bf16
    torch.matmul of the same eight products (what int8 replaces) and
    torch._int_mm + the dequantize (the library's int8 product), the bound
    (1979 TOP/s int8, 3.35 TB/s); each launch alone; K5 at the layer's four
    (M, D); the host time a call. The JSON rows' times are one layer's at
    M = 1920."""
    from echo_tts_tpu_torch.bench.timing import cuda_ms
    from echo_tts_tpu_torch.ops import int8_gemm as ig
    from echo_tts_tpu_torch.ops import quant_rows as qr

    gen = torch.Generator(device=dev).manual_seed(13)
    bf = torch.bfloat16
    at_m, k5_at_m, per_launch = {}, {}, []

    def layer(ops, tile=None):
        def run():
            for op in ops:
                ig.int8_gemm_grouped(op["a"], op["s_row"], op["ws"], bf, tile=tile)
        return run

    def layer_ungrouped(ops):
        def run():
            for op in ops:
                for w, s_col in op["ws"]:
                    ig.int8_gemm(op["a"], op["s_row"], w, s_col, bf)
        return run

    def layer_bf16(ops):
        def run():
            for op in ops:
                for w in op["w_bf"]:
                    torch.matmul(op["h"], w)
        return run

    def layer_library(ops):
        def run():
            for op in ops:
                for wt, (_, s_col) in zip(op["wt"], op["ws"]):
                    (torch._int_mm(op["a"], wt).float()
                     * (op["s_row"][:, None] * s_col)).to(bf)
        return run

    with torch.no_grad():
        for m in (1920, 640, 576, 192, 64):
            ops = int8_layer(gen, m, dev)
            flops, nbytes = layer_work(m)
            b_ms, b_by = bound(flops, nbytes, PEAK_INT8_OPS)
            row = {"M": m, "ms": cuda_ms(layer(ops), graph_iters=GRAPH_ITERS),
                   "ungrouped_ms": cuda_ms(layer_ungrouped(ops), graph_iters=GRAPH_ITERS),
                   "bf16_matmul_ms": cuda_ms(layer_bf16(ops), graph_iters=GRAPH_ITERS),
                   "library_ms": cuda_ms(layer_library(ops), graph_iters=GRAPH_ITERS),
                   "tiles": {f"{t[0]}x{t[1]}": cuda_ms(layer(ops, t), graph_iters=GRAPH_ITERS)
                             for t in ig.TILES},
                   "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}
            if m == 1920:
                row["plain_ms"] = cuda_ms(lambda: [ig.int8_gemm_grouped_plain(
                    op["a"], op["s_row"], op["ws"], bf) for op in ops], reps=3)
            at_m[m] = row
            log(f"# time int8_gemm, one trunk layer at M = {m} (4 launches): kernel "
                f"{row['ms']:.4f} ms ({flops / row['ms'] / 1e9:.0f} TOP/s, "
                f"{row['ms'] / b_ms:.2f}x its bound {b_ms:.4f} ms ({b_by})); one launch a weight "
                f"{row['ungrouped_ms']:.4f} ms; bf16 torch.matmul {row['bf16_matmul_ms']:.4f} ms; "
                f"torch._int_mm + dequantize {row['library_ms']:.4f} ms; tiles "
                + ", ".join(f"{k} {v:.4f}" for k, v in row["tiles"].items()))
            for op, kns in zip(ops, INT8_LAYER_LAUNCHES):
                f1, b1 = layer_work(m, (kns,))
                ms = cuda_ms(layer([op]), graph_iters=GRAPH_ITERS)
                bl_ms, bl_by = bound(f1, b1, PEAK_INT8_OPS)
                per_launch.append({"M": m, "K": op["k"], "N": op["ns"], "ms": ms,
                                   "bound_ms": bl_ms, "bound_by": bl_by})
                log(f"# time int8_gemm (M, K, N) = ({m}, {op['k']}, {op['ns']}): kernel "
                    f"{ms:.4f} ms ({f1 / ms / 1e9:.0f} TOP/s, {ms / bl_ms:.2f}x its bound "
                    f"{bl_ms:.4f} ms, {bl_by})")
            hs = [op["h"] for op in ops]  # the layer's four quantized activations
            k5_bytes = sum(3 * h.numel() + 4 * h.shape[0] for h in hs)
            k5_b_ms, _ = bound(5.0 * sum(h.numel() for h in hs), k5_bytes)
            k5 = {"M": m, "ms": cuda_ms(lambda: [qr.quant_rows(h) for h in hs],
                                        graph_iters=GRAPH_ITERS),
                  "bound_ms": k5_b_ms, "bound_by": "bytes", "bytes": k5_bytes}
            if m == 1920:
                k5["plain_ms"] = cuda_ms(lambda: [qr.quant_rows_plain(h) for h in hs], reps=5)
            k5_at_m[m] = k5
            log(f"# time quant_rows, one trunk layer's four quantizations at M = {m} "
                f"(3 x ({m}, 2048) + ({m}, 5888) bf16): kernel {k5['ms']:.4f} ms "
                f"({k5_bytes / k5['ms'] / 1e6:.0f} GB/s, {k5['ms'] / k5_b_ms:.2f}x its bound "
                f"{k5_b_ms:.4f} ms)")
            del ops, hs
        # K5's tp modes: one tp=2 layer's two row-sharded inputs (wo's 1024
        # and w2's 2944 columns of each of M = 1920 rows), scales and codes
        tp_h = [torch.randn(1920, d, generator=gen, device=dev).to(bf) for d in (1024, 2944)]
        tp_s = [qr.quant_rows_scale(h) for h in tp_h]
        n_el = sum(h.numel() for h in tp_h)
        modes = {}
        for name, run, plain, nbytes in (
                ("quant_rows_scale", lambda: [qr.quant_rows_scale(h) for h in tp_h],
                 lambda: [qr.quant_rows_scale_plain(h) for h in tp_h], 2 * n_el + 4 * 2 * 1920),
                ("quant_rows_at", lambda: [qr.quant_rows_at(h, s) for h, s in zip(tp_h, tp_s)],
                 lambda: [qr.quant_rows_at_plain(h, s) for h, s in zip(tp_h, tp_s)],
                 3 * n_el + 4 * 2 * 1920)):
            b_ms, b_by = bound(3.0 * n_el, nbytes)
            modes[name] = {"ms": cuda_ms(run, graph_iters=GRAPH_ITERS),
                           "plain_ms": cuda_ms(plain, reps=5), "bound_ms": b_ms,
                           "bound_by": b_by, "bytes": nbytes}
            log(f"# time {name}, one tp=2 layer's row-sharded inputs ((1920, 1024) + (1920, "
                f"2944) bf16): kernel {modes[name]['ms']:.4f} ms "
                f"({nbytes / modes[name]['ms'] / 1e6:.0f} GB/s, "
                f"{modes[name]['ms'] / b_ms:.2f}x its bound {b_ms:.4f} ms); plain "
                f"{modes[name]['plain_ms']:.4f} ms")
        del tp_h, tp_s
    host = int8_host_us(dev, gen)
    layer_row, k5 = at_m[1920], k5_at_m[1920]
    log(f"# time int8_gemm, one trunk layer at M = 1920: kernel {layer_row['ms']:.4f} ms, bf16 "
        f"matmul {layer_row['bf16_matmul_ms']:.4f} ms, bound {layer_row['bound_ms']:.4f} ms; at "
        f"M = 192: kernel {at_m[192]['ms']:.4f} ms, bf16 matmul "
        f"{at_m[192]['bf16_matmul_ms']:.4f} ms, bound {at_m[192]['bound_ms']:.4f} ms "
        f"({at_m[192]['bound_by']})")
    return [{"name": "int8_gemm", "route": "cuda",
             "source": "echo_tts_tpu_torch/csrc/int8_gemm.cu",
             "replaces": "echo_tts_tpu/models/quant.py:113 (qdot: no Pallas kernel, XLA fuses "
                         "the int8 dot and its dequantize)",
             "launches": launches.get("int8", {}).get("int8_gemm", 0),
             "launches_by_path": by_path(launches, "int8_gemm"),
             "max_abs_err": errs["int8_gemm"], "ms": layer_row["ms"],
             "plain_ms": layer_row["plain_ms"], "bound_ms": layer_row["bound_ms"],
             "bound_by": layer_row["bound_by"], "library_ms": layer_row["library_ms"],
             "library": "torch._int_mm + the dequantize in PyTorch ops",
             "bf16_matmul_ms": layer_row["bf16_matmul_ms"], "at_m": at_m,
             "per_launch": per_launch, "host_us": host, "ptxas": PTXAS.get("int8_gemm", {}),
             "shape": "one trunk layer's eight projections at M = 1920 in four launches: "
                      "4 x (2048 -> 2048), 2048 -> 2048, 2 x (2048 -> 5888), 5888 -> 2048"},
            {"name": "quant_rows", "route": "cuda",
             "source": "echo_tts_tpu_torch/csrc/quant_rows.cu",
             "replaces": "echo_tts_tpu/models/quant.py:104 (quant_rows: no Pallas kernel, XLA "
                         "fuses it into the int8 dot)",
             "launches": launches.get("int8", {}).get("quant_rows", 0),
             "launches_by_path": by_path(launches, "quant_rows"),
             "max_abs_err": errs["quant_rows"], "ms": k5["ms"], "plain_ms": k5["plain_ms"],
             "bound_ms": k5["bound_ms"], "bound_by": "bytes",
             # no single PyTorch call quantizes rows with their own dynamic scales
             "library_ms": None, "at_m": k5_at_m, "ptxas": PTXAS.get("quant_rows", {}),
             "shape": "the four row quantizations of one trunk layer at M = 1920: 3 x "
                      "(1920, 2048) + 1 x (1920, 5888) bf16, summed"}] + [
            {"name": name, "route": "cuda", "source": "echo_tts_tpu_torch/csrc/quant_rows.cu",
             "replaces": "echo_tts_tpu/models/quant.py:104 (quant_rows over the whole K, which "
                         "GSPMD gives the row-sharded products: no Pallas kernel)",
             "launches": launches.get("mesh tp=2 int8", {}).get(name, 0),
             "launches_by_path": by_path(launches, name), "max_abs_err": errs[name],
             **modes[name],
             # no PyTorch call takes row scales alone or codes at given scales
             "library_ms": None,
             "shape": "one tp=2 layer's row-sharded inputs at M = 1920: (1920, 1024) + "
                      "(1920, 2944) bf16"}
            for name in ("quant_rows_scale", "quant_rows_at")]


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


def plain_attention(q, k_self, v_self, segments, layout="hm", self_len=None, out=None):
    from echo_tts_tpu_torch.ops.joint_attention import joint_attention_plain

    res = joint_attention_plain(q, k_self, v_self, segments, layout, self_len)
    return res if out is None else out.copy_(res)


def with_random_res_biases(ae_params, gen, dev):
    """A copy of the AE weights whose decoder residual units have non-zero
    biases (zero biases map the causal pad to zeros and hide the re-zero)."""
    ae = dict(ae_params)
    ae["decoder"] = dict(ae["decoder"])
    ae["decoder"]["blocks"] = [dict(b) for b in ae["decoder"]["blocks"]]
    for blk in ae["decoder"]["blocks"]:
        blk["res_units"] = [
            {**u, **{c: {**u[c], "b": (0.3 * torch.randn(u[c]["w"].shape[0], generator=gen,
                                                         device=dev)).to(torch.bfloat16)}
                     for c in ("conv1", "conv2")}} for u in blk["res_units"]]
    return ae


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
    from echo_tts_tpu_torch.ops.res_chain import res_chain_plain

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

        ae = with_random_res_biases(tts.ae_params, gen, dev)
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


def profile_families(what: str, run) -> dict:
    """Wall time of run() unprofiled, then under torch.profiler: device time
    by kernel family and the device-busy share of the unprofiled wall
    (returned as wall_ms, device_ms, busy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from echo_tts_tpu_torch.utils.profiling import device_time_by_family, kernel_family

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity only: the tables read device events alone, and host-op
    # events made the profile's own processing take minutes on a stream
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
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
    return {"wall_ms": wall_ms, "device_ms": total, "busy": total / wall_ms}


# ---------------------------------------------------------------------------
# phase 9: the streaming slice at full width
# ---------------------------------------------------------------------------


def lap(name: str, since: float) -> float:
    now = time.perf_counter()
    log(f"# stream ({name}) took {now - since:.1f} s")
    return now


def phase_stream(dev, wrappers: dict) -> dict:
    """Streaming generation at the full width of DiTConfig() (latent modules)
    and AEConfig() in bf16, random weights from seeds 0/1: (a) one block's
    CFG forward through K1 against the plain attention, on the latent cache
    of a 640-latent run at start_pos 0 and 256, S = 64 and 192; (b) the
    stateful decode of 640 z_q frames in blocks 64 + 192 x 3, every K2 call
    against the plain chain and the audio against decode_zq, and 1- and
    2-frame first chunks; (c) sample_pipeline_stream with the (64, 192)
    schedule and phase 5's prompts, warm-up and timed, exact launch counts,
    one profile of its first block; (d) stream_blocks_fused at bench.py
    --blockwise's shapes;
    (e) a continuation from 5 s of audio; (f) the flattening detector and
    the crop on the card against the CPU, and a stream whose detector is
    forced to fire. Returns the launches of (c) and the weights, which
    phase 10 goes on with."""
    import echo_tts_tpu_torch.models.dit as dit_mod
    import echo_tts_tpu_torch.models.s1dac as s1_mod
    from echo_tts_tpu_torch.bench.init_ae import init_ae_params
    from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig, SamplerConfig
    from echo_tts_tpu_torch.core.rope import precompute_rope
    from echo_tts_tpu_torch.models.dit import init_dit_params
    from echo_tts_tpu_torch.models.pca import PCAState
    from echo_tts_tpu_torch.ops.res_chain import chain_ctx, res_chain_plain, unit_operands
    from echo_tts_tpu_torch.pipeline.pipeline import (
        EchoTTS,
        _prepare_inputs,
        sample_pipeline_stream,
        stream_blocks_fused,
    )
    from echo_tts_tpu_torch.sampling.euler_cfg import _f32_ge, draw_noise, t_schedule

    t_phase = time.perf_counter()
    dit_cfg, ae_cfg = DiTConfig(), AEConfig()
    t0 = time.perf_counter()
    tts = EchoTTS(init_dit_params(dit_cfg, torch.bfloat16, dev, seed=0), dit_cfg,
                  init_ae_params(ae_cfg, torch.bfloat16, dev, seed=1), ae_cfg,
                  PCAState.random(device=dev), model_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    log(f"# stream: init on the card, DiT with latent modules "
        f"{param_count(tts.dit_params) / 1e9:.3f} B params, {time.perf_counter() - t0:.1f} s")
    sc = SamplerConfig(num_steps=40, cfg_scale_text=3.0, cfg_scale_speaker=8.0, cfg_min_t=0.5,
                       cfg_max_t=1.0, truncation_factor=0.8, sequence_length=640)
    sr, spl = ae_cfg.sample_rate, ae_cfg.frame_length
    spk_audio = synthetic_speech(20.0, sr, 7)
    gen = torch.Generator(device=dev).manual_seed(11)
    p, L = tts.dit_params, dit_cfg.num_layers

    # (a) one block's CFG forward, kernels against the plain attention
    ids, tmask, _, spk, smask, _ = _prepare_inputs(tts, SPEAKER_TEXT, spk_audio, False, None,
                                                   None, True)
    ids, tmask, spk, smask = (torch.as_tensor(a, device=dev) for a in (ids, tmask, spk, smask))
    with torch.no_grad():
        kv_text = dit_mod.get_kv_cache_text(p, dit_cfg, ids, tmask)
        kv_spk = dit_mod.get_kv_cache_speaker(p, dit_cfg, spk.to(torch.bfloat16))
        lat = {0: dit_mod.init_latent_kv_state(p, dit_cfg, 1, 640, torch.bfloat16)}
        lat[256] = dit_mod.extend_latent_kv(
            p, dit_cfg, dit_mod.init_latent_kv_state(p, dit_cfg, 1, 640, torch.bfloat16),
            torch.randn(1, 256, 80, generator=gen, device=dev).to(torch.bfloat16), 0)
        cos, sin = precompute_rope(dit_cfg.head_dim, 640, device=dev)
        t_b = torch.full((1,), 0.7, device=dev).to(torch.bfloat16)
        fwd_rel = {}
        for start in (0, 256):
            lmask = (torch.arange(160, device=dev) * 4 < start)[None]
            for s in (64, 192):
                x = torch.randn(1, s, 80, generator=gen, device=dev).to(torch.bfloat16)
                kw = dict(rope_q=(cos[start:start + s], sin[start:start + s]),
                          speaker_kv_scale=[1.5] * L)
                lat_kw = dict(kv_latent=(lat[start]["k"], lat[start]["v"]), latent_mask=lmask)
                k1 = wrappers["joint_attention"].launches
                got = dit_mod.dit_forward_cfg(p, dit_cfg, x, t_b, tmask, smask, kv_text, kv_spk,
                                              **kw, **lat_kw)
                k1 = wrappers["joint_attention"].launches - k1
                kernel_attention, dit_mod.joint_attention = dit_mod.joint_attention, \
                    plain_attention
                try:
                    ref = dit_mod.dit_forward_cfg(p, dit_cfg, x, t_b, tmask, smask, kv_text,
                                                  kv_spk, **kw, **lat_kw)
                finally:
                    dit_mod.joint_attention = kernel_attention
                fwd_rel[(start, s)] = rel_l2(got, ref)
                exact = ""
                if start == 0:  # every latent key masked: K1 must add exact zeros
                    without = dit_mod.dit_forward_cfg(p, dit_cfg, x, t_b, tmask, smask,
                                                      kv_text, kv_spk, **kw)
                    exact = f", max |diff| against no latent segment {max_abs(got, without):.3e}"
                    if not torch.equal(got, without):
                        raise SystemExit(f"stream (a): the all-masked latent segment at S={s} "
                                         f"changed the forward{exact}")
                log(f"# stream (a) CFG forward, start_pos {start}, S={s}, latent 160 "
                    f"({int(lmask.sum())} visible) + text 768 + speaker {kv_spk[0].shape[3]}: "
                    f"K1 vs plain rel-L2 {fwd_rel[(start, s)]:.3e}, {k1} K1 launches{exact}")
                if k1 != 3 * L:
                    raise SystemExit(f"stream (a): {k1} K1 launches, expected {3 * L}")
    if max(fwd_rel.values()) >= REL_L2_BOUND:
        raise SystemExit(f"stream (a): the forward disagrees with its plain version {fwd_rel}")
    split = lap("a", t_phase)
    del lat, kv_text, kv_spk

    # (b) the stateful decode, every K2 call against the plain chain
    ae = with_random_res_biases(tts.ae_params, gen, dev)
    z_q = (0.3 * torch.randn(1, ae_cfg.latent_dim, 640, generator=gen, device=dev)
           ).to(torch.bfloat16)
    kernel_chain, calls = s1_mod.res_units_cl, []

    def checked_chain(xc, units, dilations=(1, 3, 9), *, zero_below=None):
        out = kernel_chain(xc, units, dilations, zero_below=zero_below)
        ref_c = res_chain_plain(xc.float(), f32_units(units), dilations, zero_below)
        calls.append((xc.shape[2], xc.shape[1], zero_below, rel_l2(out, ref_c),
                      bool(out[:, :zero_below].any())))
        return out

    def stream_decode(frames, sizes):
        state, chunks, off = s1_mod.streaming_decode_init(ae, ae_cfg, 1), [], 0
        for n in sizes:
            audio, state = s1_mod.decode_zq_stream_step(ae, ae_cfg, state,
                                                        frames[:, :, off:off + n])
            chunks.append(audio)
            off += n
        return torch.cat(chunks, -1)

    with torch.no_grad():
        full = s1_mod.decode_zq(ae, ae_cfg, z_q)
        s1_mod.res_units_cl = checked_chain
        try:
            streamed = stream_decode(z_q, (64, 192, 192, 192))
            main_calls = list(calls)
            short = {n: stream_decode(z_q[:, :, :64], (n, 64 - n)) for n in (1, 2)}
        finally:
            s1_mod.res_units_cl = kernel_chain
        full64 = s1_mod.decode_zq(ae, ae_cfg, z_q[:, :, :64])
        pack_units = [u for blk in ae["decoder"]["blocks"] for u in blk["res_units"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for u in pack_units:
            unit_operands(u, u["conv1"]["w"].shape[0], dev)
        pack_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    dec_rel = rel_l2(streamed, full)
    short_rel = {n: rel_l2(a, full64) for n, a in short.items()}
    chain_rel = max(c[3] for c in calls)
    # the first chain (rate0 rows a z_q frame) re-zeroes clip(ctx - pos*rate0, 0, ctx)
    ctx, rate0 = chain_ctx(), math.prod(ae_cfg.downsample_factor) * ae_cfg.decoder_rates[0]
    c0 = main_calls[0][0]
    zb_first = [c[2] for c in main_calls if c[0] == c0]
    zb_short = {n: [c[2] for c in calls[len(main_calls):] if c[0] == c0][2 * i:2 * i + 2]
                for i, n in enumerate((1, 2))}
    zb_want = {pos: min(max(ctx - pos * rate0, 0), ctx) for pos in (0, 1, 2, 64, 256, 448)}
    log(f"# stream (b) stateful decode of 640 z_q frames in 64 + 192 x 3 (non-zero biases): "
        f"{len(calls)} K2 calls, max rel-L2 vs the plain chain {chain_rel:.3e}; first chain's "
        f"zero_below {zb_first} (chain_ctx {ctx} rows), then "
        f"{zb_short[1]} and {zb_short[2]} after a 1- and a 2-frame first chunk; streamed audio "
        f"vs decode_zq rel-L2 {dec_rel:.3e}; 1 + 63 frames {short_rel[1]:.3e}, 2 + 62 "
        f"{short_rel[2]:.3e}; weight packing of the 12 units a step: {pack_ms:.2f} ms of host "
        f"time")
    if (chain_rel >= REL_L2_BOUND or any(c[4] for c in calls) or dec_rel >= REL_L2_BOUND
            or max(short_rel.values()) >= REL_L2_BOUND
            or zb_first != [zb_want[pos] for pos in (0, 64, 256, 448)]
            or zb_short != {n: [zb_want[0], zb_want[n]] for n in (1, 2)}):
        raise SystemExit("stream (b): the streaming decode disagrees")
    del ae, z_q, full, streamed, short, full64
    split = lap("b", split)

    # (c) sample_pipeline_stream, warm-up then timed, exact launches, a profile
    ts = t_schedule(sc)
    n_cfg = sum(_f32_ge(float(ts[i]), sc.cfg_min_t) and _f32_ge(sc.cfg_max_t, float(ts[i]))
                for i in range(sc.num_steps))
    n_blocks = 4
    k1_expected = n_blocks * (3 * n_cfg + (sc.num_steps - n_cfg)) * L
    pc = tts.pipe_cfg
    prompt_chunks = math.ceil(min(spk_audio.shape[-1], pc.max_speaker_latent_length * spl)
                              / (pc.audio_chunk_latents * spl))
    k2_expected = (n_blocks * 3 * len(ae_cfg.decoder_rates)
                   + prompt_chunks * 3 * len(ae_cfg.encoder_rates))

    def run_stream(seed, sc=sc, n_chunks=None, **kw):
        t0, walls, chunks = time.perf_counter(), [], []
        for chunk in sample_pipeline_stream(tts, SPEAKER_TEXT, spk_audio, seed, sc=sc,
                                            stop_at_flattening=False, **kw):
            walls.append(time.perf_counter() - t0)
            chunks.append(chunk)
            if len(chunks) == n_chunks:
                break
        return walls, np.concatenate(chunks, -1)

    # warm-up: two steps a block reach every shape of the timed stream (one
    # step in the CFG window, one after it)
    run_stream(99, sc=dataclasses.replace(sc, num_steps=2))
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    walls, audio = run_stream(0)
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    secs = audio.shape[-1] / sr
    blocks_ms = [(b - a) * 1e3 for a, b in zip([0.0] + walls[:-1], walls)]
    log(f"# stream (c) sample_pipeline_stream, (64, 192) -> 4 blocks, 20 s prompt: time to first "
        f"audio {walls[0] * 1e3:.1f} ms, block walls {', '.join(f'{b:.1f}' for b in blocks_ms)} "
        f"ms, total {walls[-1] * 1e3:.1f} ms, audio {secs:.2f} s, {secs / walls[-1]:.2f} "
        f"audio-s/s; peak memory {peak:.2f} GiB; launches {launches} (expected K1 "
        f"{k1_expected}, K2 {k2_expected})")
    if (audio.shape[-1] != 640 * spl or not np.isfinite(audio).all()
            or launches["joint_attention"] != k1_expected
            or launches["res_chain"] != k2_expected):
        raise SystemExit("stream (c): wrong audio length, non-finite audio or launch counts")
    # the profile reads the first block (64 latents, the prompt's encode and
    # KV build with it) only: the profiler's own processing of a whole
    # stream's ~350k launches took ~100 s
    prof = profile_families("the first block of one stream again",
                            lambda: run_stream(5, n_chunks=1))
    for k, w in wrappers.items():  # the profile's launches are not the path's
        w.launches = launches[k]
    split = lap("c", split)

    # (d) stream_blocks_fused at bench.py --blockwise's shapes, timed once
    bids = torch.randint(0, 256, (1, 768), generator=gen, device=dev)
    bspk = torch.randn(1, 6400, 80, generator=gen, device=dev)
    ones_t = torch.ones(1, 768, dtype=torch.bool, device=dev)
    ones_s = torch.ones(1, 6400, dtype=torch.bool, device=dev)
    noise = draw_noise(0, (1, 640, 80), dev)
    noises = [noise[:, i * 160:(i + 1) * 160] for i in range(4)]
    torch.cuda.synchronize()
    t0, d_walls = time.perf_counter(), []
    for _, chunk, _, _ in stream_blocks_fused(tts.dit_params, dit_cfg, sc, tts.ae_params, ae_cfg,
                                              tts.pca, bspk, ones_s, bids, ones_t,
                                              [160] * 4, noises, torch.bfloat16):
        torch.cuda.synchronize()
        d_walls.append(time.perf_counter() - t0)
    log(f"# stream (d) stream_blocks_fused 160 x 4, text 768, speaker 6400 latents: time to "
        f"first audio {d_walls[0] * 1e3:.1f} ms, block walls "
        f"{', '.join(f'{(b - a) * 1e3:.1f}' for a, b in zip([0.0] + d_walls[:-1], d_walls))} "
        f"ms, total {d_walls[-1] * 1e3:.1f} ms, {640 * spl / sr / d_walls[-1]:.2f} audio-s/s")

    split = lap("d", split)

    # (e) a continuation from 5 s of audio: only new audio is emitted
    cont = synthetic_speech(5.0, sr, 8)
    cont_len = cont.shape[-1] // spl // dit_cfg.speaker_patch_size * dit_cfg.speaker_patch_size
    e_walls, e_audio = run_stream(1, continuation_audio=cont)
    log(f"# stream (e) continuation from 5 s ({cont_len} latents): {len(e_walls)} blocks, "
        f"{e_audio.shape[-1] / spl:.0f} new latents of audio ({e_audio.shape[-1] / sr:.2f} s), "
        f"time to first audio {e_walls[0] * 1e3:.1f} ms, total {e_walls[-1] * 1e3:.1f} ms")
    if e_audio.shape[-1] != (640 - cont_len) * spl or not np.isfinite(e_audio).all():
        raise SystemExit(f"stream (e): {e_audio.shape[-1]} samples, expected "
                         f"{(640 - cont_len) * spl} of new audio")
    split = lap("e", split)

    # (f) the flattening-point crop on the card
    crop_checks(dev, tts, sc, wrappers, gen)
    for k, w in wrappers.items():
        w.launches = launches[k]
    lap("f", split)
    log(f"# stream phase: {time.perf_counter() - t_phase:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return {"launches": launches, "tts": tts, "ttfa_ms": walls[0] * 1e3, "block_ms": blocks_ms,
            "audio_s_per_s": secs / walls[-1], "profile": prof,
            "blockwise_ttfa_ms": d_walls[0] * 1e3, "pack_ms": pack_ms}


def crop_checks(dev, tts, sc, wrappers: dict, gen) -> None:
    """Phase 9 (f), the flattening-point crop on the card: latents that go
    flat at known indices (zeros, or a decay that crosses the detector's
    thresholds gradually) and never, each index and each crop against the
    CPU's on the same tensor; then a stream of three 64-latent blocks whose
    detector is forced to fire at latent 50, inside the first block's last
    window (tests/test_torch_streaming.py's construction): it must stop
    after the second block, having held the first block's last 20 latents
    back, and send exactly 50 latents of the unstopped stream's audio."""
    from echo_tts_tpu_torch.pipeline import flattening
    from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline_stream

    dit_cfg, spl = tts.dit_cfg, tts.ae_cfg.frame_length
    rng = np.random.default_rng(9)
    audio_f = torch.randn(1, 1, 640 * spl, generator=gen, device=dev)
    found = []
    for flat_from in (0, 17, 333, 620, None, "decay"):
        lat = 0.8 * rng.standard_normal((640, 80)).astype(np.float32)
        if flat_from == "decay":
            lat[300:] *= np.exp(-np.arange(340, dtype=np.float32) / 40.0)[:, None]
        elif flat_from is not None:
            lat[flat_from:] = 0.0
        cpu = torch.from_numpy(lat)
        got = flattening.find_flattening_point(cpu.to(dev))
        want = flattening.find_flattening_point(cpu)
        crop = flattening.crop_audio_to_flattening_point(audio_f, cpu.to(dev), spl)
        crop_cpu = flattening.crop_audio_to_flattening_point(audio_f.cpu(), cpu, spl)
        found.append((flat_from, got, want, torch.equal(crop.cpu(), crop_cpu)))
    log(f"# stream (f) find_flattening_point on the card against the CPU, 640 x 80 latents, "
        f"(flat from, card, CPU, crops equal): {found}")
    if any(g_ != w_ or not eq for _f, g_, w_, eq in found) or found[1][1] != 17:
        raise SystemExit(f"stream (f): the card's flattening points differ from the CPU's {found}")
    sc_f = dataclasses.replace(sc, sequence_length=192, num_steps=20)
    real_find = flattening.find_flattening_point
    flattening.find_flattening_point = lambda data, **kw: min(50, data.shape[0])
    try:
        for w in wrappers.values():
            w.launches = 0
        stopped = list(sample_pipeline_stream(tts, SHORT_TEXT, None, 0, sc=sc_f, block_size=64,
                                              normalize_text=True))
        got_f = {k: w.launches for k, w in wrappers.items()}
    finally:
        flattening.find_flattening_point = real_find
    full = np.concatenate(list(sample_pipeline_stream(
        tts, SHORT_TEXT, None, 0, sc=sc_f, block_size=64, normalize_text=True,
        stop_at_flattening=False)), -1)
    sizes_f = [c.shape[-1] // spl for c in stopped]
    k1_block = k1_launches(sc_f, dit_cfg.num_layers)
    same = np.array_equal(np.concatenate(stopped, -1), full[..., :50 * spl])
    log(f"# stream (f) a stream of 3 x 64 latents, the detector forced to fire at 50: chunks of "
        f"{sizes_f} latents, equal to the unstopped stream's first 50 latents bit for bit: "
        f"{same}; launches {got_f} (two blocks sampled: K1 {2 * k1_block})")
    if sizes_f != [44, 6] or not same or got_f["joint_attention"] != 2 * k1_block:
        raise SystemExit(f"stream (f): the forced stop emitted {sizes_f} latents (expected "
                         f"[44, 6]), equal {same}, launches {got_f}")


# ---------------------------------------------------------------------------
# phase 10: batching at full width
# ---------------------------------------------------------------------------


def events_ms(run):
    """(result, wall ms, ms between two CUDA events around run())."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = run()
    end.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def stack_rows(trees):
    """One-row states (nested dicts and lists of tensors) stacked on axis 0."""
    if isinstance(trees[0], dict):
        return {k: stack_rows([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return [stack_rows(list(x)) for x in zip(*trees)]
    return torch.cat(trees)


def check_batch_rows(what: str, got: dict, ref: dict) -> None:
    """rel-L2 of each row's audio against its solo run, printed; fails
    above the bound or on a length mismatch."""
    rels = {}
    for r in ref:
        if got[r].shape != ref[r].shape:
            raise SystemExit(f"batching {what}: row {r} has {got[r].shape[-1]} samples, its solo "
                             f"run {ref[r].shape[-1]}")
        rels[r] = rel_l2(torch.from_numpy(got[r]), torch.from_numpy(ref[r]))
    log(f"# batching {what}: each row against its solo run, audio rel-L2 "
        f"{', '.join(f'row {r} {v:.3e}' for r, v in rels.items())}")
    if max(rels.values()) >= REL_L2_BOUND or not all(np.isfinite(got[r]).all() for r in got):
        raise SystemExit(f"batching {what}: a row disagrees with its solo run {rels}")


def stream_gap_split(tts, s_reqs, prefixes, got_c, solo_c) -> dict:
    """Phase 10 (c)'s rows' gap to their solo streams, split in two and
    printed: the sampled latents (`prefixes`: the batch's, then each solo
    stream's) against the solo stream's, and the stateful decode of the solo
    streams' latents on the stream's blocks at B=2 against B=1; beside the
    audio's. Returns {row: (latents, decode, audio) rel-L2}."""
    import echo_tts_tpu_torch.models.s1dac as s1_mod
    from echo_tts_tpu_torch.pipeline import pipeline as pl

    ae, ae_cfg = tts.ae_params, tts.ae_cfg
    lat_b, lat_solo = prefixes[0], torch.cat(prefixes[1:3])
    seq = lat_b.shape[1]
    cuts = np.cumsum([0] + pl._block_schedule((64, 192), seq, tts.dit_cfg.speaker_patch_size))

    def decode(lat):
        st, out = s1_mod.streaming_decode_init(ae, ae_cfg, lat.shape[0]), []
        for a, b in zip(cuts[:-1], cuts[1:]):
            audio, st = s1_mod.decode_zq_stream_step(
                ae, ae_cfg, st, pl._deprojected(tts.pca, lat[:, a:b], ae), max(1024, seq))
            out.append(audio.float())
        return torch.cat(out, -1)

    with torch.no_grad():
        dec_b = decode(lat_solo)
        gap = {r: (rel_l2(lat_b[r], lat_solo[r]),
                   rel_l2(dec_b[r], decode(lat_solo[r:r + 1])[0]),
                   rel_l2(torch.from_numpy(got_c[r]), torch.from_numpy(solo_c[r])))
               for r in range(2)}
    log("# batching (c) the stream rows' gap to their solo streams, split: " + "; ".join(
        f"row {r} ({'prompted' if s_reqs[r][1] is not None else 'no prompt'}) latents rel-L2 "
        f"{g[0]:.3e}, the solo latents decoded at B=2 against B=1 {g[1]:.3e}, audio {g[2]:.3e}"
        for r, g in gap.items()))
    return gap


def phase_batch(dev, wrappers: dict, tts) -> dict:
    """Batching on phase 9's weights (DiTConfig() with the latent modules,
    AEConfig(), bf16): (a) K1 and K2 at B=4 with one position a row, each
    call against its plain version and a row of the B=4 launch against the
    same row launched alone; (b) sample_pipeline_batch at B = 1, 2 and 4,
    each row of B=4 against its solo sample_pipeline; (c)
    sample_pipeline_stream_batch at B=2 against the solo streams; (d) a
    continuous group of 4 rows on 64-latent blocks (joins with and without
    a first block, a partial final block, a resize 4 -> 2) against the solo
    streams. Returns the launches of (b) at B=4, (c) and (d) by path, and
    `tts`, which phase 11 goes on with."""
    import echo_tts_tpu_torch.models.dit as dit_mod
    import echo_tts_tpu_torch.models.s1dac as s1_mod
    from echo_tts_tpu_torch.core.config import SamplerConfig
    from echo_tts_tpu_torch.core.rope import precompute_rope, rope_rows
    from echo_tts_tpu_torch.ops.joint_attention import pick_tq
    from echo_tts_tpu_torch.ops.res_chain import chain_ctx, res_chain_plain
    from echo_tts_tpu_torch.pipeline import pipeline as pl
    from echo_tts_tpu_torch.sampling.euler_cfg import draw_noise

    t_phase = time.perf_counter()
    dit_cfg, ae_cfg = tts.dit_cfg, tts.ae_cfg
    p, L, md = tts.dit_params, dit_cfg.num_layers, tts.model_dtype
    sc = SamplerConfig(num_steps=40, cfg_scale_text=3.0, cfg_scale_speaker=8.0, cfg_min_t=0.5,
                       cfg_max_t=1.0, truncation_factor=0.8, sequence_length=640)
    sr, spl = ae_cfg.sample_rate, ae_cfg.frame_length
    spk_audio = synthetic_speech(20.0, sr, 7)
    requests = [(SHORT_TEXT, None, 0), (SPEAKER_TEXT, spk_audio, 1), (LONG_TEXT, None, 2),
                (SHORT_TEXT, None, 3)]
    gen = torch.Generator(device=dev).manual_seed(21)
    k1_w, k2_w = wrappers["joint_attention"], wrappers["res_chain"]
    pc = tts.pipe_cfg
    prompt_chunks = math.ceil(min(spk_audio.shape[-1], pc.max_speaker_latent_length * spl)
                              / (pc.audio_chunk_latents * spl))
    k2_step, k2_chunk = 3 * len(ae_cfg.decoder_rates), 3 * len(ae_cfg.encoder_rates)

    # (a) K1 at B=4: one CFG block forward at S=64, rows at start_pos 0, 64,
    # 256, 448 with self_len 64, 64, 40, 0, the four requests' caches
    starts, self_len = [0, 64, 256, 448], [64, 64, 40, 0]
    preps = [pl._prepare_inputs(tts, text, spk, False, None, None, True)
             for text, spk, _ in requests]
    ids, tmask, spk, smask = pl._stack_padded(preps, dev)
    captured = []

    def capture_k1(q, k_self, v_self, segments, layout="hm", self_len=None, out=None):
        res = k1_w(q, k_self, v_self, segments, layout=layout, self_len=self_len, out=out)
        if not captured:
            captured.append((q, k_self, v_self, list(segments), layout, self_len))
        return res

    with torch.no_grad():
        kv_text = dit_mod.get_kv_cache_text(p, dit_cfg, ids, tmask)
        kv_spk = dit_mod.get_kv_cache_speaker(p, dit_cfg, spk.to(md))
        lat = dit_mod.init_latent_kv_state(p, dit_cfg, 4, 640, md)
        dit_mod.extend_latent_kv(p, dit_cfg, lat, torch.randn(4, 448, 80, generator=gen,
                                                              device=dev).to(md), 0)
        st = torch.tensor(starts, device=dev)
        lmask = torch.arange(160, device=dev)[None] * 4 < st[:, None]
        rope_q = rope_rows(*precompute_rope(dit_cfg.head_dim, 640, device=dev),
                           st[:, None] + torch.arange(64, device=dev))
        sl = torch.tensor(self_len, dtype=torch.int32, device=dev)
        x = torch.randn(4, 64, 80, generator=gen, device=dev).to(md)
        kw = dict(rope_q=rope_q, speaker_kv_scale=[1.5] * L, self_len=sl,
                  kv_latent=(lat["k"], lat["v"]), latent_mask=lmask)
        t_b = torch.full((4,), 0.7, device=dev).to(md)
        before = k1_w.launches
        dit_mod.joint_attention = capture_k1
        try:
            got = dit_mod.dit_forward_cfg(p, dit_cfg, x, t_b, tmask, smask, kv_text, kv_spk, **kw)
            dit_mod.joint_attention = plain_attention
            ref = dit_mod.dit_forward_cfg(p, dit_cfg, x, t_b, tmask, smask, kv_text, kv_spk, **kw)
        finally:
            dit_mod.joint_attention = k1_w
        k1_n = k1_w.launches - before
        live = [b for b in range(4) if self_len[b] > 0]
        fwd_rel = {b: rel_l2(got[:, b], ref[:, b]) for b in range(4)}
        # a row of the B=4 launch against the same row launched alone
        q, k_self, v_self, segs, layout, slc = captured[0]
        whole = k1_w(q, k_self, v_self, segs, layout=layout, self_len=slc)
        row_equal = [torch.equal(whole[:, b:b + 1], k1_w(
            q[:, b:b + 1], k_self[:, b:b + 1], v_self[:, b:b + 1],
            [(k[b:b + 1], v[b:b + 1], m[:, b:b + 1], s_) for k, v, m, s_ in segs],
            layout=layout, self_len=slc[b:b + 1])) for b in range(4)]
    log(f"# batching (a) CFG block forward at B=4, S=64, start_pos {starts}, self_len {self_len}, "
        f"latent visible {lmask.sum(1).tolist()} of 160, text {kv_text[0].shape[3]}, speaker "
        f"{kv_spk[0].shape[3]}: {k1_n} K1 launches, K1 vs plain rel-L2 by row "
        f"{', '.join(f'{fwd_rel[b]:.3e}' for b in range(4))} (live rows {live}); K1 tile "
        f"{pick_tq(64)} query rows: G x B x H x q tiles = {q.shape[0]} x {q.shape[1]} x "
        f"{q.shape[3]} x {math.ceil(q.shape[2] / pick_tq(64))} blocks for the cond branch's "
        f"launch; row of the B=4 launch == the row alone, bit for bit: {row_equal}")
    if (k1_n != 3 * L or max(fwd_rel[b] for b in live) >= REL_L2_BOUND
            or not torch.isfinite(got).all()):
        raise SystemExit(f"batching (a): K1 at B=4 disagrees with its plain version {fwd_rel}")
    if not all(row_equal):
        raise SystemExit(f"batching (a): a row of the B=4 K1 launch differs from the row "
                         f"launched alone {row_equal}")
    # information: the whole B=4 forward against each row's own B=1 forward
    # (the GEMMs see another M; K1 and K2 give each row its own blocks)
    with torch.no_grad():
        solo_rel = []
        for b in range(4):
            one = lambda a: a[b:b + 1]  # noqa: E731
            kw1 = dict(kw, rope_q=tuple(map(one, rope_q)), self_len=one(sl),
                       kv_latent=(lat["k"][:, b:b + 1], lat["v"][:, b:b + 1]),
                       latent_mask=one(lmask))
            solo_rel.append(rel_l2(got[:, b:b + 1], dit_mod.dit_forward_cfg(
                p, dit_cfg, one(x), one(t_b), one(tmask), one(smask),
                tuple(a[:, b:b + 1] for a in kv_text), tuple(a[:, b:b + 1] for a in kv_spk),
                **kw1)))
    log(f"# batching (a) the B=4 CFG forward against each row's own B=1 forward: rel-L2 "
        f"{', '.join(f'{r_:.3e}' for r_ in solo_rel)}")
    del kv_text, kv_spk, lat, got, ref, captured, whole

    # K2 at B=4: one stateful decode step of 64 frames, rows at frame 0, 1, 2, 64
    ae = with_random_res_biases(tts.ae_params, gen, dev)
    z = (0.3 * torch.randn(4, ae_cfg.latent_dim, 128, generator=gen, device=dev)).to(md)
    k2_calls = []

    def checked_chain(xc, units, dilations=(1, 3, 9), *, zero_below=None):
        out = k2_w(xc, units, dilations, zero_below=zero_below)
        ref_c = res_chain_plain(xc.float(), f32_units(units), dilations, zero_below)
        zb = torch.as_tensor(zero_below).reshape(-1).tolist()
        dirty = any(bool(out[b, :zb[b]].any()) for b in range(out.shape[0]))
        row_eq = all(torch.equal(out[b:b + 1], k2_w(xc[b:b + 1].contiguous(), units, dilations,
                                                     zero_below=zb[b:b + 1]))
                     for b in range(out.shape[0]))
        k2_calls.append((xc.shape[2], xc.shape[1], zb, rel_l2(out, ref_c), dirty, row_eq))
        return out

    pos = [0, 1, 2, 64]
    with torch.no_grad():
        states = []
        for r, n in enumerate(pos):
            st1 = s1_mod.streaming_decode_init(ae, ae_cfg, 1, per_row_pos=True)
            if n:
                _, st1 = s1_mod.decode_zq_stream_step(ae, ae_cfg, st1, z[r:r + 1, :, :n])
            states.append(st1)
        chunk = torch.stack([z[r, :, n:n + 64] for r, n in enumerate(pos)])
        s1_mod.res_units_cl = checked_chain
        try:
            audio4, _ = s1_mod.decode_zq_stream_step(ae, ae_cfg, stack_rows(states), chunk)
        finally:
            s1_mod.res_units_cl = k2_w
    ctx, rate0 = chain_ctx(), math.prod(ae_cfg.downsample_factor) * ae_cfg.decoder_rates[0]
    want0 = [min(max(ctx - n * rate0, 0), ctx) for n in pos]
    for c, rows, zb, rel, dirty, row_eq in k2_calls:
        log(f"# batching (a) K2 at B=4, C={c}, T={rows}: zero_below by row {zb}, rel-L2 vs "
            f"plain {rel:.3e}, zero rows exactly zero {not dirty}, each row == the row alone "
            f"bit for bit {row_eq}")
    if (len(k2_calls) != len(ae_cfg.decoder_rates) or k2_calls[0][2] != want0
            or any(c[3] >= REL_L2_BOUND or c[4] or not c[5] for c in k2_calls)
            or not torch.isfinite(audio4).all()):
        raise SystemExit(f"batching (a): K2 at B=4 disagrees (first chain's zero_below "
                         f"expected {want0})")
    with torch.no_grad():  # information: each row's step decoded alone
        dec_rel = [rel_l2(audio4[r:r + 1], s1_mod.decode_zq_stream_step(
            ae, ae_cfg, states[r], chunk[r:r + 1])[0]) for r in range(4)]
    log(f"# batching (a) the B=4 decode step against each row's own B=1 step: audio rel-L2 "
        f"{', '.join(f'{r_:.3e}' for r_ in dec_rel)}")
    del ae, z, states, audio4
    split = lap("batching a", t_phase)

    # (b) sample_pipeline_batch at B = 1, 2, 4; each row of B=4 against its solo run
    pl.sample_pipeline_batch(tts, requests, sc=dataclasses.replace(sc, num_steps=2))  # warm-up
    out_b, launches = {}, {}
    for bsz in (1, 2, 4):
        reqs = requests[:bsz]
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        res, wall, ev = events_ms(lambda: pl.sample_pipeline_batch(tts, reqs, sc=sc))
        got_l = {k: w.launches for k, w in wrappers.items()}
        launches[f"batch_{bsz}"] = got_l
        secs = sum(a.shape[-1] for a, _, _ in res) / sr
        prompted = sum(spk_ is not None for _, spk_, _ in reqs)
        want = {"joint_attention": 20 * 3 * L + 20 * L,
                "res_chain": k2_step + prompted * prompt_chunks * k2_chunk}
        log(f"# batching (b) sample_pipeline_batch B={bsz}: wall {wall:.1f} ms, CUDA events "
            f"around the call {ev:.1f} ms, sample+decode {res[0][2]['sample'] * 1e3:.1f} ms, "
            f"audio {secs:.2f} s, {secs / wall * 1e3:.2f} audio-s/s; peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {got_l} "
            f"(expected {want}: K1 and the decode's K2 as at B=1, "
            f"{prompt_chunks * k2_chunk} K2 for each prompted request's encode)")
        if got_l != want or any(tm["batch_size"] != bsz for _, _, tm in res):
            raise SystemExit(f"batching (b): launches {got_l}, expected {want}")
        out_b[bsz] = {r: a for r, (a, _, _) in enumerate(res)}
    profile_families("sample_pipeline_batch B=4",
                     lambda: pl.sample_pipeline_batch(tts, requests, sc=sc))
    solo = {r: pl.sample_pipeline(tts, text, spk_, seed, sc=sc)[0]
            for r, (text, spk_, seed) in enumerate(requests)}
    check_batch_rows("(b) B=4", out_b[4], solo)
    split = lap("batching b", split)

    # (c) sample_pipeline_stream_batch at B=2, (64, 192), the prompt on one row
    s_reqs = [requests[1], requests[0]]
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0, c_walls, rows_c = time.perf_counter(), [], {0: [], 1: []}
    prefixes = []  # each stream's latents: the prefix of its last block
    real_blocks = pl.stream_blocks_fused

    def keep_prefix(*a, **k):
        for item in real_blocks(*a, **k):
            if item[2] == 0:
                prefixes.append(None)
            prefixes[-1] = item[0]
            yield item

    pl.stream_blocks_fused = keep_prefix
    try:
        for out in pl.sample_pipeline_stream_batch(tts, s_reqs, sc=sc, stop_at_flattening=False):
            c_walls.append(time.perf_counter() - t0)
            for r, chunk_ in out.items():
                rows_c[r].append(chunk_)
        launches["stream_batch_2"] = {k: w.launches for k, w in wrappers.items()}
        want_c = {"joint_attention": 4 * (20 * 3 + 20) * L,
                  "res_chain": 4 * k2_step + prompt_chunks * k2_chunk}
        got_c = {r: np.concatenate(v, -1) for r, v in rows_c.items()}
        log(f"# batching (c) sample_pipeline_stream_batch B=2, (64, 192): time to first audio "
            f"{c_walls[0] * 1e3:.1f} ms, block walls "
            f"{', '.join(f'{(b - a) * 1e3:.1f}' for a, b in zip([0.0] + c_walls[:-1], c_walls))} ms, "
            f"total {c_walls[-1] * 1e3:.1f} ms, {2 * 640 * spl / sr / c_walls[-1]:.2f} audio-s/s; "
            f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches "
            f"{launches['stream_batch_2']} (expected {want_c})")
        if launches["stream_batch_2"] != want_c:
            raise SystemExit("batching (c): launch counts")
        solo_c = {r: np.concatenate(list(pl.sample_pipeline_stream(
            tts, text, spk_, seed, sc=sc, stop_at_flattening=False)), -1)
            for r, (text, spk_, seed) in enumerate(s_reqs)}
    finally:
        pl.stream_blocks_fused = real_blocks
    # information, the gate is below: the rows' gap split in two
    stream_gap_split(tts, s_reqs, prefixes, got_c, solo_c)
    check_batch_rows("(c) stream B=2", got_c, solo_c)
    split = lap("batching c", split)

    # (d) a continuous group of 4 rows on 64-latent blocks
    bs = 64
    budgets = {0: 192, 1: 160, 2: 256}
    total = max(budgets.values()) + bs
    g_preps = [pl._prepare_inputs(tts, text, spk_, False, None, None, True)
               for text, spk_, _ in requests[:3]]
    text_len = max(pp[0].shape[1] for pp in g_preps)
    spk_len = max(pp[3].shape[1] for pp in g_preps)

    def row_inputs(r):
        pp = g_preps[r]
        return [torch.as_tensor(pl._pad_to(np.asarray(pp[i]), n), device=dev)
                for i, n in ((0, text_len), (1, text_len), (3, spk_len), (4, spk_len))]

    noise = {r: draw_noise(requests[r][2], (1, n, 80), dev) for r, n in budgets.items()}
    zero = torch.zeros(bs, 80, device=dev)

    def nrow(r, a):
        blk = noise[r][0, a:a + bs]
        return torch.cat([blk, zero[:bs - blk.shape[0]]]) if r is not None else zero

    args = (p, dit_cfg, sc, tts.ae_params, ae_cfg, tts.pca)
    g_audio = {r: [] for r in budgets}
    d_rows = []

    def step(gs, slots, starts_, valids):
        b = len(starts_)
        nz = torch.stack([nrow(slots[i], starts_[i]) if valids[i] else zero for i in range(b)])
        (gs, audio, _), wall, ev = events_ms(lambda: pl._stream_step_rows(
            *args, gs, starts_, valids, nz, bs, total, md, 1024))
        audio = audio.cpu().numpy()
        for i, r in enumerate(slots):
            if r is not None and valids[i]:
                g_audio[r].append(audio[i:i + 1, :, :valids[i] * spl])
        d_rows.append((f"step B={b} starts {starts_} valid {valids}", wall, ev))
        return gs

    def join_first(gs, row, r):
        (gs, audio, _), wall, ev = events_ms(lambda: pl._join_row_first_block(
            *args, gs, row, *row_inputs(r), nrow(r, 0)[None], bs, total, md, 1024))
        g_audio[r].append(audio.cpu().numpy())
        d_rows.append((f"join row {r} with its first block", wall, ev))
        return gs

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        gs = pl.init_stream_group(tts, 4, total, text_len, spk_len)
        torch.cuda.synchronize()
        state_gb = sum(t_.numel() * t_.element_size() for t_ in pl._leaves(gs)) / 4 / 1e9
        gs = join_first(gs, 0, 0)
        (gs, wall, ev) = events_ms(lambda: pl._join_row(p, dit_cfg, tts.ae_params, ae_cfg, gs,
                                                        1, *row_inputs(1), md))
        d_rows.append(("join row 1", wall, ev))
        gs = step(gs, [0, 1, None, None], [64, 0, 0, 0], [64, 64, 0, 0])
        gs = step(gs, [0, 1, None, None], [128, 64, 0, 0], [64, 64, 0, 0])
        gs = join_first(gs, 2, 2)
        # row 0 retired; row 1's last block holds 32 valid latents
        gs = step(gs, [None, 1, 2, None], [192, 128, 64, 0], [0, 32, 64, 0])
        (gs, wall, ev) = events_ms(lambda: pl._resize_group(gs, [2, 3], [True, False]))
        d_rows.append(("resize 4 -> 2", wall, ev))
        gs = step(gs, [2, None], [128, 0], [64, 0])
        gs = step(gs, [2, None], [192, 0], [64, 0])
    launches["continuous_group"] = {k: w.launches for k, w in wrappers.items()}
    n_blocks = 2 + 5
    want_d = {"joint_attention": n_blocks * (20 * 3 + 20) * L, "res_chain": n_blocks * k2_step}
    peak_d = torch.cuda.max_memory_allocated(dev) / 2**30
    for what, wall, ev in d_rows:
        log(f"# batching (d) {what}: wall {wall:.1f} ms, CUDA events {ev:.1f} ms")
    log(f"# batching (d) group state {state_gb:.3f} GB a row (text {text_len}, speaker "
        f"{spk_len} latents, {total} latents of prefix); peak memory {peak_d:.2f} GiB; "
        f"launches {launches['continuous_group']} (expected {want_d})")
    if launches["continuous_group"] != want_d:
        raise SystemExit("batching (d): launch counts")
    got_d = {r: np.concatenate(v, -1) for r, v in g_audio.items()}
    solo_d = {r: np.concatenate(list(pl.sample_pipeline_stream(
        tts, requests[r][0], requests[r][1], requests[r][2],
        sc=dataclasses.replace(sc, sequence_length=n), block_size=bs,
        stop_at_flattening=False)), -1) for r, n in budgets.items()}
    check_batch_rows("(d) continuous group", got_d, solo_d)
    del gs
    lap("batching d", split)
    log(f"# batching phase: {time.perf_counter() - t_phase:.1f} s")
    return {"batch_one_shot": launches["batch_4"], "stream_batch": launches["stream_batch_2"],
            "continuous_group": launches["continuous_group"]}, tts


# ---------------------------------------------------------------------------
# phase 11: serving at full width
# ---------------------------------------------------------------------------


# phase 11 (d): streams in a trace; three keep the first arrivals' burst of
# three and hold the whole script, phase 14 included, inside its time limit;
# each 256 latents (four 64-latent blocks): 320 since phase 14 (f) was added,
# 256 since its int8 group was
TRACE_STREAMS = 3
TRACE_LATENTS = 256


def http_call(port: int, method: str, path: str, body=None):
    """(status, headers, body bytes, client wall ms) of one request."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, dict(resp.getheaders()), data, (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def http_stream(port: int, body: dict):
    """POST /tts_stream; the HTTP chunks as the server framed them (read
    from the raw body), the ms to the first at the client, and the total."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/tts_stream", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200 or resp.getheader("Transfer-Encoding") != "chunked":
            raise SystemExit(f"serving (b): /tts_stream answered {resp.status}: {resp.read()[:200]}")
        chunks, first_ms = [], None
        while True:
            size = int(resp.fp.readline().split(b";")[0], 16)
            if size == 0:
                resp.fp.readline()
                break
            chunks.append(resp.fp.read(size))
            resp.fp.readline()
            if first_ms is None:
                first_ms = (time.perf_counter() - t0) * 1e3
        return chunks, first_ms, (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def phase_serve(dev, wrappers: dict, tts) -> dict:
    """Serving on phase 9/10's weights (DiTConfig() with the latent modules,
    AEConfig(), bf16, text bucket 768) through Engine and the HTTP server on
    127.0.0.1: (a) one-shot /tts, requests (i) and (ii) (the 20 s prompt as
    WAV base64, twice: the second hits the speaker cache), each body equal to
    the server's encoding of a direct sample_pipeline on the prompt as the
    server decodes it; (b) /tts_stream of (ii) on (64, 192), its chunks equal
    to the PCM16 of sample_pipeline_stream's; (c) four concurrent /tts of one
    batch key on Engine(max_batch=4): one batch, K1 and the decode's K2 as one
    request's, every row equal to its solo run; (d) run_trace, 3 streams of
    256 latents at 0.5 requests/s on 64-latent blocks, on a continuous, a
    dispatch and a continuous engine without the fast join, one continuous
    row against its solo stream; (e)
    /reconstruct against ae_reconstruct, /lora with an r16 LoRA (the audio
    changes) and back (the base audio bit for bit), and set_lora while a
    continuous group of two rows is live (each row stays on the old params);
    (g) the
    Gradio UI's handlers on (a)'s engine (`phase_ui`). Returns the launches
    of the served requests and of the UI's generate and stream."""
    import base64
    import tempfile
    import threading

    from echo_tts_tpu_torch.bench.trace import _TEXTS, run_trace
    from echo_tts_tpu_torch.core.config import SamplerConfig
    from echo_tts_tpu_torch.pipeline import pipeline as pl
    from echo_tts_tpu_torch.pipeline.audio_io import load_audio, write_wav
    from echo_tts_tpu_torch.pipeline.speaker import ae_reconstruct
    from echo_tts_tpu_torch.sampling.euler_cfg import _f32_ge, t_schedule
    from echo_tts_tpu_torch.serve.engine import Engine
    from echo_tts_tpu_torch.serve.server import pcm16_bytes, serve, wav_bytes
    from echo_tts_tpu_torch.train.lora import LoRAConfig, init_lora, save_lora_checkpoint

    t_phase = time.perf_counter()
    dit_cfg, ae_cfg, L = tts.dit_cfg, tts.ae_cfg, tts.dit_cfg.num_layers
    fields = dict(num_steps=40, cfg_scale_text=3.0, cfg_scale_speaker=8.0, cfg_min_t=0.5,
                  cfg_max_t=1.0, truncation_factor=0.8, sequence_length=640)
    sc = SamplerConfig(**fields)
    sr, spl = ae_cfg.sample_rate, ae_cfg.frame_length
    ts = t_schedule(sc)
    n_cfg = sum(_f32_ge(float(ts[i]), sc.cfg_min_t) and _f32_ge(sc.cfg_max_t, float(ts[i]))
                for i in range(sc.num_steps))
    k1_request = (3 * n_cfg + (sc.num_steps - n_cfg)) * L
    k2_decode = 3 * len(ae_cfg.decoder_rates)
    served = {k: 0 for k in wrappers}

    def serving(fn):
        """Run fn with every count at 0 before and read after; the served
        requests' launches add up in `served`."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        got = {k: w.launches for k, w in wrappers.items()}
        for k in served:
            served[k] += got[k]
        return out, got

    def need(ok, what):
        if not ok:
            raise SystemExit(f"serving {what}")

    tmp = tempfile.mkdtemp(prefix="echo_tts_serve_")
    spk_path = os.path.join(tmp, "prompt.wav")
    write_wav(spk_path, synthetic_speech(20.0, sr, 7)[0], sr)
    spk_b64 = base64.b64encode(open(spk_path, "rb").read()).decode()
    spk = load_audio(spk_path)  # the prompt as the server decodes it
    engines, servers = [], []

    def start(**kw):
        eng = Engine(tts, **kw)
        httpd = serve(eng, host="127.0.0.1", port=0, background=True)
        engines.append(eng)
        servers.append(httpd)
        return eng, httpd.server_address[1]

    try:
        # (a) one-shot over HTTP
        eng_a, port_a = start(max_batch=1)
        status, _, body, _ = http_call(port_a, "GET", "/health")
        need(status == 200 and json.loads(body)["status"] == "ok", "(a): /health")
        status, _, body, _ = http_call(port_a, "GET", "/presets")
        need(status == 200 and len(json.loads(body)) == 6, "(a): /presets")
        a_reqs = [("i", {"text": SHORT_TEXT, "seed": 0}),
                  ("ii", {"text": SPEAKER_TEXT, "seed": 1, "speaker_wav_b64": spk_b64}),
                  ("ii again", {"text": SPEAKER_TEXT, "seed": 1, "speaker_wav_b64": spk_b64})]
        bodies, a_tm = {}, {}
        for name, req in a_reqs:
            torch.cuda.reset_peak_memory_stats(dev)
            (status, headers, body, wall), got = serving(
                lambda: http_call(port_a, "POST", "/tts", {**req, **fields}))
            need(status == 200, f"(a) {name}: status {status}: {body[:200]}")
            tm = json.loads(headers["X-Timings"])
            bodies[name], a_tm[name] = body, tm
            secs = (len(body) - 44) / 2 / sr
            log(f"# serving (a) POST /tts request {name}: client wall {wall:.1f} ms, "
                f"speaker_encode {tm['speaker_encode'] * 1e3:.1f} ms"
                f"{' (cache hit)' if tm.get('speaker_encode_cache_hit') else ''}, sample+decode "
                f"{tm['sample'] * 1e3:.1f} ms, engine total {tm['total'] * 1e3:.1f} ms; audio "
                f"{secs:.2f} s, {secs / wall * 1e3:.2f} audio-s/s at the client; peak memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {got}")
        need("speaker_encode_cache_hit" not in a_tm["ii"]
             and a_tm["ii again"].get("speaker_encode_cache_hit") == 1.0,
             f"(a): the second (ii) did not hit the speaker cache: {a_tm}")
        direct = {0: pl.sample_pipeline(tts, SHORT_TEXT, None, 0, sc=sc, normalize_text=True)[0],
                  1: pl.sample_pipeline(tts, SPEAKER_TEXT, spk, 1, sc=sc, normalize_text=True)[0]}
        same = {name: bodies[name] == wav_bytes(direct[req["seed"]][0], sr)
                for name, req in a_reqs}
        log(f"# serving (a) each body equal to the WAV of a direct sample_pipeline: {same}; "
            f"speaker_encode {a_tm['ii']['speaker_encode'] * 1e3:.1f} ms, then "
            f"{a_tm['ii again']['speaker_encode'] * 1e3:.1f} ms from the cache")
        need(all(same.values()), "(a): a response differs from the direct call")
        split = lap("serving a", t_phase)

        # (b) /tts_stream of (ii) on (64, 192)
        (chunks, first_ms, total_ms), got = serving(lambda: http_stream(port_a, {
            "text": SPEAKER_TEXT, "seed": 1, "speaker_wav_b64": spk_b64, "block_size": [64, 192],
            **fields}))
        ref = [pcm16_bytes(c) for c in pl.sample_pipeline_stream(
            tts, SPEAKER_TEXT, spk, 1, sc=sc, block_size=[64, 192], normalize_text=True)]
        ref = [c for c in ref if c]
        secs = sum(len(c) for c in chunks) / 2 / sr
        log(f"# serving (b) POST /tts_stream (ii), (64, 192): first chunk at the client "
            f"{first_ms:.1f} ms, {len(chunks)} chunks, total {total_ms:.1f} ms, audio "
            f"{secs:.2f} s, {secs / total_ms * 1e3:.2f} audio-s/s; launches {got}; chunks equal "
            f"to sample_pipeline_stream's PCM16: {chunks == ref}")
        need(chunks == ref, "(b): the streamed chunks differ from sample_pipeline_stream's")
        split = lap("serving b", split)

        # (c) four concurrent /tts of one batch key on Engine(max_batch=4)
        eng_c, port_c = start(max_batch=4, batch_wait_ms=5000.0)
        c_reqs = [(SHORT_TEXT, 0), (LONG_TEXT, 1), (LONG_TEXT, 2), (SHORT_TEXT, 3)]
        keys = {eng_c._batch_key(text, None, sc, True) for text, _ in c_reqs}
        need(len(keys) == 1, f"(c): the four requests have {len(keys)} batch keys")
        res_c = {}

        def post_c(seed, text):
            res_c[seed] = http_call(port_c, "POST", "/tts", {"text": text, "seed": seed, **fields})

        def burst():
            threads = [threading.Thread(target=post_c, args=(seed, text),
                                        name=f"echo-tts-client-{seed}") for text, seed in c_reqs]
            for t_ in threads:
                t_.start()
            for t_ in threads:
                t_.join(timeout=600)
            need(not any(t_.is_alive() for t_ in threads), "(c): a request hung")

        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        _, got = serving(burst)
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        need(all(res_c[s][0] == 200 for _, s in c_reqs), f"(c): statuses "
             f"{[res_c[s][0] for _, s in c_reqs]}")
        solo = {s: direct[0] if s == 0 else pl.sample_pipeline(tts, text, None, s, sc=sc,
                                                                normalize_text=True)[0]
                for text, s in c_reqs}
        same = {s: res_c[s][2] == wav_bytes(solo[s][0], sr) for _, s in c_reqs}
        secs = sum(a.shape[-1] for a in solo.values()) / sr
        st = eng_c.health()
        want = {"joint_attention": k1_request, "res_chain": k2_decode}
        log(f"# serving (c) four concurrent POST /tts, one batch key: wall {wall:.1f} ms (client "
            f"walls {', '.join(f'{res_c[s][3]:.1f}' for _, s in c_reqs)}), audio {secs:.2f} s, "
            f"**{secs / wall * 1e3:.2f} aggregate audio-s/s**; batches {st['batches']}, requests "
            f"{st['requests']}; peak memory {peak:.2f} GiB; launches {got} (expected {want}); "
            f"each row equal to its solo run: {same}")
        need(st["batches"] == 1 and st["requests"] == 4, f"(c): {st}")
        need(got == want, f"(c): launches {got}, expected {want}")
        need(all(same.values()), "(c): a batched row differs from its solo run")
        split = lap("serving c", split)

        # (d) the arrival trace on a continuous and on a dispatch engine, each
        # stream TRACE_LATENTS long
        sc_trace = dataclasses.replace(sc, sequence_length=TRACE_LATENTS)
        traces = {}
        for mode, kw in (("continuous", dict(continuous=True, continuous_block=64)),
                         ("dispatch", {}),
                         ("continuous, no fast join", dict(continuous=True, continuous_block=64,
                                                           continuous_fast_join=False))):
            eng_t = Engine(tts, max_batch=4, **kw)
            engines.append(eng_t)
            streams, real = {}, eng_t.generate_stream

            def tee(text, speaker, seed=0, real=real, streams=streams, **kw_):
                streams[seed] = (text, [])
                for c in real(text, speaker, seed=seed, **kw_):
                    streams[seed][1].append(c)
                    yield c

            eng_t.generate_stream = tee
            torch.cuda.reset_peak_memory_stats(dev)
            s, got = serving(lambda: run_trace(eng_t, sc_trace, TRACE_STREAMS, 0.5,
                                               block_size=64, seed=0, timeout_s=600))
            st = eng_t.health()
            traces[mode] = dict(s, batches=st["batches"], launches=got)
            log(f"# serving (d) run_trace {mode}, {TRACE_STREAMS} streams of {TRACE_LATENTS} "
                f"latents at 0.5/s, "
                f"64-latent "
                f"blocks: TTFA p50 {s['ttfa_p50_s'] * 1e3:.1f} / p95 {s['ttfa_p95_s'] * 1e3:.1f} "
                f"ms, completion p50 {s['completion_p50_s'] * 1e3:.1f} / p95 "
                f"{s['completion_p95_s'] * 1e3:.1f} ms, **{s['achieved_audio_s_per_s']} "
                f"achieved audio-s/s** (offered {s['offered_audio_s_per_s']}), makespan "
                f"{s['makespan_s']} s; n_ok {s['n_ok']}, n_hung {s['n_hung']}, errors "
                f"{s['errors']}; batches {st['batches']}; peak memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {got}")
            need(s["n_ok"] == TRACE_STREAMS and s["n_hung"] == 0, f"(d) {mode}: {s}")
            if mode == "continuous":
                seed = 1000 + TRACE_STREAMS - 1
                text, parts = streams[seed]
                row = np.concatenate(parts, -1)
                ref = np.concatenate(list(pl.sample_pipeline_stream(
                    tts, text, None, seed, sc=sc_trace, block_size=64, normalize_text=True)), -1)
                need(row.shape == ref.shape, f"(d): row {seed} has {row.shape[-1]} samples, its "
                     f"solo stream {ref.shape[-1]}")
                r = rel_l2(torch.from_numpy(row), torch.from_numpy(ref))
                log(f"# serving (d) continuous row seed {seed} against its solo stream: audio "
                    f"rel-L2 {r:.3e}")
                need(r < REL_L2_BOUND, f"(d): the continuous row is {r:.3e} from its solo stream")
            eng_t.close()
        split = lap("serving d", split)

        # (e) /reconstruct, /lora and back, set_lora under a live group
        (status, _, body, wall), got = serving(
            lambda: http_call(port_a, "POST", "/reconstruct", {"wav_b64": spk_b64}))
        chunk = tts.pipe_cfg.audio_chunk_latents * spl
        a_ = spk[:, :chunk]
        with torch.no_grad():
            rec = ae_reconstruct(tts.ae_params, ae_cfg, tts.pca, torch.as_tensor(
                np.pad(a_, ((0, 0), (0, chunk - a_.shape[-1]))), device=dev)[:, None])
        rec = rec.cpu().numpy()[:, :, :-(-a_.shape[-1] // spl) * spl]
        need(status == 200 and body == wav_bytes(rec[0], sr), "(e): /reconstruct differs from "
             "ae_reconstruct")
        log(f"# serving (e) POST /reconstruct of the 20 s prompt: client wall {wall:.1f} ms, "
            f"equal to ae_reconstruct's WAV; launches {got}")
        gen = torch.Generator(device=dev).manual_seed(16)
        lc = LoRAConfig(rank=16, alpha=16.0)
        lora = init_lora(gen, tts.dit_params, lc)
        # b large enough that the adapted model's audio moves beyond the
        # rows' 2e-2 gate: with random weights the sampler's output is
        # mostly its noise, and b ~ N(0, 0.05) moved it by 1.8e-2 only
        for ab in lora.values():
            ab["b"].normal_(0.0, 0.5, generator=gen)
        lora_path = os.path.join(tmp, "lora_r16.npz")
        save_lora_checkpoint(lora_path, lora, lc)
        del lora
        req_i = {"text": SHORT_TEXT, "seed": 0, **fields}

        def lora_round():
            out = [http_call(port_a, "POST", "/lora", {"path": lora_path})]
            out.append(http_call(port_a, "POST", "/tts", req_i))
            out.append(http_call(port_a, "POST", "/lora", {"path": None}))
            out.append(http_call(port_a, "POST", "/tts", req_i))
            return out

        torch.cuda.reset_peak_memory_stats(dev)
        (set_, merged, unset, back), got = serving(lora_round)
        need(all(r[0] == 200 for r in (set_, merged, unset, back)), "(e): a /lora round failed")
        pcm = {k: np.frombuffer(b[44:], "<i2").astype(np.float64)
               for k, b in (("base", bodies["i"]), ("lora", merged[2]))}
        n = min(len(pcm["base"]), len(pcm["lora"]))
        moved = rel_l2(torch.from_numpy(pcm["lora"][:n]), torch.from_numpy(pcm["base"][:n]))
        log(f"# serving (e) POST /lora r16 (set {set_[3]:.1f} ms, revert {unset[3]:.1f} ms): "
            f"request (i) with the LoRA {moved:.3e} from the base audio (rel-L2), back to the "
            f"base bit for bit: {back[2] == bodies['i']}; peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {got}")
        need(merged[2] != bodies["i"] and moved > REL_L2_BOUND, "(e): the LoRA did not change "
             "the audio beyond the gate")
        need(back[2] == bodies["i"], "(e): reverting the LoRA did not bring the base audio back")

        # two 256-latent streams in one live group while set_lora waits (a
        # group's streams share one SamplerConfig): the second is admitted
        # once the first's group is live, when the first has two blocks
        # left, so that both rows are live when the swap is asked for
        sc_live = dataclasses.replace(sc, sequence_length=256, num_steps=20)
        live_sc = {4: sc_live, 5: sc_live}
        live_text = {4: SHORT_TEXT, 5: SPEAKER_TEXT}
        eng_g = Engine(tts, max_batch=2, continuous=True, continuous_block=64)
        engines.append(eng_g)
        live = {}

        def live_stream(seed):
            live[seed] = np.concatenate(list(eng_g.generate_stream(
                live_text[seed], None, seed=seed, sc=live_sc[seed], block_size=64)), -1)

        def swap_under_load():
            def wait_rows(n, threads):
                deadline = time.monotonic() + 600
                while not any(s_.n_active >= n for s_ in list(eng_g._cont_scheds.values())):
                    need(time.monotonic() < deadline and all(t_.is_alive() for t_ in threads),
                         f"(e): no live group of {n} rows")
                    time.sleep(0.005)
                return next(s_ for s_ in eng_g._cont_scheds.values() if s_.n_active >= n)

            clients = [threading.Thread(target=live_stream, args=(4,),
                                        name="echo-tts-client-live-4")]
            clients[0].start()
            wait_rows(1, clients)
            clients.append(threading.Thread(target=live_stream, args=(5,),
                                            name="echo-tts-client-live-5"))
            clients[1].start()
            sched = wait_rows(2, clients)
            t0 = time.perf_counter()
            eng_g.set_lora(lora_path)
            swap_ms = (time.perf_counter() - t0) * 1e3
            group = eng_g._groups.get(sched.gid)  # the params it took when it opened
            alive = sched.thread.is_alive()
            need(group is not None and group["params"] is tts.dit_params
                 and eng_g.tts.dit_params is not tts.dit_params,
                 "(e): the live group's params were replaced, or the swap did nothing")
            for t_ in clients:
                t_.join(timeout=600)
            need(not any(t_.is_alive() for t_ in clients), "(e): a live stream hung")
            return swap_ms, alive, sched.max_b

        (swap_ms, alive, rows_max), got = serving(swap_under_load)
        rels = {}
        for seed in live_sc:
            ref = np.concatenate(list(pl.sample_pipeline_stream(
                tts, live_text[seed], None, seed, sc=live_sc[seed], block_size=64,
                normalize_text=True)), -1)
            need(live[seed].shape == ref.shape, f"(e): live row {seed}'s length differs")
            rels[seed] = rel_l2(torch.from_numpy(live[seed]), torch.from_numpy(ref))
        log(f"# serving (e) set_lora while a continuous group of two rows was live (at most "
            f"{rows_max} rows): returned in {swap_ms:.1f} ms with the group still live ({alive}); "
            f"each live row against its solo stream on the base params: rel-L2 "
            f"{', '.join(f'row {k} {v:.3e}' for k, v in rels.items())}; launches {got}")
        need(alive and max(rels.values()) < REL_L2_BOUND,
             "(e): the live group did not stay on the old params")
        split = lap("serving e", split)

        # (g) the UI's handlers (serve/gradio_app.py, which needs no gradio
        # until its app is built) on (a)'s engine, whose speaker cache holds
        # the 20 s prompt
        ui_counts = phase_ui(dev, tts, eng_a, serving, need, tmp, spk_path, spk)
        lap("serving g", split)
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        for eng in engines:
            eng.close()
        for name in os.listdir(tmp):
            os.unlink(os.path.join(tmp, name))
        os.rmdir(tmp)
    need(min(served.values()) > 0, f"(all): a kernel was never launched: {served}")
    log(f"# serving phase: {time.perf_counter() - t_phase:.1f} s, launches of the served "
        f"requests {served}; trace summaries {json.dumps(traces)}")
    return {"serving": served, **ui_counts}


# the UI's twelve sampler fields (the "Independent-High-Speaker-CFG-Flat"
# preset's values, force speaker off): its SamplerConfig sets rescale_k and
# rescale_sigma, which the HTTP requests above leave at None
UI_FIELDS = (40, 3.0, 8.0, 0.5, 1.0, 0.8, 1.2, 3.0, False, 1.5, 0.9, 24)


def phase_ui(dev, tts, eng, serving, need, tmp: str, spk_path: str, spk) -> dict:
    """Phase 11 (g): the Gradio UI's handlers (`UIHandlers`, the callbacks
    `build_app` wires) at full width on `eng`, phase 11's engine: generate
    of request (ii) with custom shapes (text bucket 256, speaker bucket
    1024), its WAV equal byte for byte to a direct sample_pipeline on the
    container with those buckets, K1 and the decode's K2 counted (the
    prompt comes from the speaker cache); the same request with
    max_speaker_latent_length overridden, which must miss the cache;
    generate_stream's PCM16 against sample_pipeline_stream's; set_lora on a
    missing file (the error, then the base audio byte for byte); and
    Engine.warmup(background_tail=True) on a copy of the container with one
    text and two speaker buckets, health() showing the tail running and
    then done. `serving` and `need` are phase 11's. Returns the launches of
    the UI's generate and stream."""
    from echo_tts_tpu_torch.core.config import SamplerConfig
    from echo_tts_tpu_torch.pipeline import pipeline as pl
    from echo_tts_tpu_torch.pipeline.audio_io import write_wav
    from echo_tts_tpu_torch.serve import gradio_app as ga
    from echo_tts_tpu_torch.serve.engine import Engine

    sr, L = tts.ae_cfg.sample_rate, tts.dit_cfg.num_layers
    ui = ga.UIHandlers(eng, presets_path=os.path.join(tmp, "presets.json"),
                       text_presets_path=os.path.join(tmp, "text_presets.txt"), temp_dir=tmp)
    sc = ga.build_sampler_config(SamplerConfig(), ga.fields_from_args(*UI_FIELDS), 640)
    k1 = k1_launches(sc, L)
    k2_decode = 3 * len(tts.ae_cfg.decoder_rates)
    counts = {}

    def step(name, since):
        now = time.perf_counter()
        log(f"# serving (g) {name} took {now - since:.1f} s")
        return now

    t0 = time.perf_counter()
    shapes = {"text_buckets": (256,), "speaker_buckets": (1024,)}
    args = (None, SPEAKER_TEXT, spk_path, "wav", *UI_FIELDS, 1, "256", "1024", "640", True,
            False, False)
    (sid, path, status, _, _), got = serving(lambda: ui.generate(*args))
    counts["ui generate"] = got
    body = open(path, "rb").read()
    custom = dataclasses.replace(tts, pipe_cfg=dataclasses.replace(tts.pipe_cfg, **shapes))
    direct, _, tm = pl.sample_pipeline(custom, SPEAKER_TEXT, spk, 1, sc=sc, normalize_text=True)
    ref_path = os.path.join(tmp, "direct_custom.wav")
    write_wav(ref_path, direct[0], sr)
    same = body == open(ref_path, "rb").read()
    want = {"joint_attention": k1, "res_chain": k2_decode}
    log(f"# serving (g) UI generate of (ii) with custom shapes {shapes}: {status!r}; "
        f"{(len(body) - 44) / 2 / sr:.2f} s of audio; WAV equal to a direct sample_pipeline on "
        f"those buckets: {same}; launches {got} (expected {want}: the prompt from the speaker "
        f"cache)")
    need(same, "(g): the UI's custom-shape WAV differs from the direct call")
    need(got == want, f"(g): UI generate launches {got}, expected {want}")
    split = step("generate with custom shapes", t0)

    over = {"max_speaker_latent_length": 320}
    (_, _, tm), got = serving(lambda: eng.generate(SPEAKER_TEXT, spk, seed=1, sc=sc,
                                                   pipe_overrides=over))
    miss = "speaker_encode_cache_hit" not in tm
    log(f"# serving (g) the same request with {over}: speaker cache missed: {miss} "
        f"(speaker_encode {tm['speaker_encode'] * 1e3:.1f} ms); launches {got}")
    need(miss, "(g): an encode override hit the speaker cache")
    split = step("max_speaker_latent_length override", split)

    def pcm(c):
        return np.clip(np.asarray(c)[0, 0] * 32767.0, -32768, 32767).astype(np.int16)

    stream_args = (SPEAKER_TEXT, spk_path, *UI_FIELDS, 1)
    chunks, got = serving(lambda: [c for _, c in ui.generate_stream(*stream_args)])
    counts["ui stream"] = got
    ref = [pcm(c) for c in pl.sample_pipeline_stream(tts, SPEAKER_TEXT, spk, 1, sc=sc,
                                                     block_size=list(ga.STREAM_BLOCKS),
                                                     normalize_text=True)]
    chunks, ref = [c for c in chunks if c.size], [c for c in ref if c.size]
    same = len(chunks) == len(ref) and all(np.array_equal(a, b) for a, b in zip(chunks, ref))
    n_blocks = len(pl._block_schedule(list(ga.STREAM_BLOCKS), sc.sequence_length,
                                      tts.dit_cfg.speaker_patch_size))
    log(f"# serving (g) UI generate_stream of (ii), {ga.STREAM_BLOCKS}: {len(chunks)} chunks, "
        f"{sum(c.size for c in chunks) / sr:.2f} s of audio, PCM16 equal to "
        f"sample_pipeline_stream's: {same}; launches {got} (K1 expected {n_blocks * k1})")
    need(same, "(g): the UI's stream differs from sample_pipeline_stream")
    need(got["joint_attention"] == n_blocks * k1 and got["res_chain"] > 0,
         f"(g): UI stream launches {got}")
    split = step("generate_stream", split)

    msg = ui.set_lora(os.path.join(tmp, "missing_lora.npz"), 1.0)
    (_, path2, _, _, _), got = serving(lambda: ui.generate(*args))
    back = open(path2, "rb").read() == body
    log(f"# serving (g) UI set_lora on a missing file: {msg!r}; engine LoRA "
        f"{eng.health()['lora']}; the next request equal to the base audio byte for byte: "
        f"{back}; launches {got}")
    need(msg.startswith("❌ Error loading LoRA") and eng.health()["lora"] is None,
         f"(g): set_lora on a missing file gave {msg!r}")
    need(back, "(g): after the failed set_lora the audio is not the base's")
    split = step("set_lora with its revert", split)

    pc = dataclasses.replace(tts.pipe_cfg, text_buckets=(768,), speaker_buckets=(160, 320))
    eng_w = Engine(dataclasses.replace(tts, pipe_cfg=pc))
    try:
        sc_w = SamplerConfig(num_steps=4)
        (wall, running, done), got = serving(lambda: (
            eng_w.warmup(sc_w, background_tail=True),
            eng_w.health()["warmup_tail_running"],
            eng_w._warmup_tail.join(timeout=300) or eng_w.health()["warmup_tail_running"]))
        log(f"# serving (g) Engine.warmup(background_tail=True), buckets text {pc.text_buckets} "
            f"speaker {pc.speaker_buckets}, {sc_w.num_steps} steps: first part {wall:.1f} s, "
            f"tail running after it: {running}, then done: {not done}; combos "
            f"{eng_w.warmup_combos}; launches {got}")
        need(running is True and done is False and eng_w.warmup_combos == 3,
             f"(g): warmup tail running {running}, after join {done}, combos "
             f"{eng_w.warmup_combos}")
    finally:
        eng_w.close()
    step("warmup with a background tail", split)
    return counts


# ---------------------------------------------------------------------------
# phase 12: the sampler levers and the int8 trunk at full width
# ---------------------------------------------------------------------------


def k1_launches(sc, num_layers: int) -> int:
    """K1 launches of one sampling with `sc`, counted from the schedule: an
    evaluation inside the CFG window launches once a branch signature (3, or
    2 with joint_uncond), one outside it once; midpoint evaluates at t and at
    t + dt/2, the uncond cache refreshes every interval-th window step."""
    from echo_tts_tpu_torch.sampling.euler_cfg import _f32_ge, t_schedule

    ts = t_schedule(sc)
    g = 2 if sc.joint_uncond else 3

    def win(t):
        return _f32_ge(t, sc.cfg_min_t) and _f32_ge(sc.cfg_max_t, t)

    per_layer, n_win = 0, 0
    for i in range(sc.num_steps):
        t, t_next = np.float32(ts[i]), np.float32(ts[i + 1])
        if sc.solver == "midpoint":
            for tt in (t, t + np.float32(0.5) * (t_next - t)):
                per_layer += g if win(float(tt)) else 1
            continue
        refresh = win(float(t)) and n_win % sc.uncond_cache_interval == 0
        per_layer += g if refresh else 1
        n_win += win(float(t))
    return per_layer * num_layers


def cont_streams(eng, streams: dict, block: int) -> dict:
    """Streams of `streams` ({seed: (text, SamplerConfig)}) through a
    continuous engine: the first alone, the others once its group is live
    (admitted at a block boundary), then eng.close(). Returns each row's audio, time to first
    audio and wall, the clients' errors, and the scheduler's joins, group
    steps (boundaries with a step), largest group and resizes (rows before,
    rows after)."""
    import threading

    from echo_tts_tpu_torch.pipeline import pipeline as pl

    resizes, rows, errors = [], {}, []
    real_resize = pl._resize_group

    def resize_spy(gs, perm, keep):
        resizes.append((int(gs["prefix"].shape[0]), len(perm)))
        return real_resize(gs, perm, keep)

    def client(seed):
        text, sc = streams[seed]
        t = {"submit": time.perf_counter()}
        chunks = []
        try:
            for c in eng.generate_stream(text, None, seed=seed, sc=sc, block_size=block):
                t.setdefault("first", time.perf_counter())
                chunks.append(c)
        except Exception as e:  # reported by the caller: the phase fails
            errors.append(f"{seed}: {type(e).__name__}: {e}")
        t["end"] = time.perf_counter()
        rows[seed] = {"audio": np.concatenate(chunks, axis=-1) if chunks else None,
                      "ttfa_s": t.get("first", t["end"]) - t["submit"],
                      "wall_s": t["end"] - t["submit"]}

    seeds = list(streams)
    pl._resize_group = resize_spy
    try:
        first = threading.Thread(target=client, args=(seeds[0],))
        first.start()
        deadline = time.monotonic() + 300
        while not any(s_.n_active >= 1 for s_ in list(eng._cont_scheds.values())):
            if time.monotonic() > deadline or not first.is_alive():
                break
            time.sleep(0.005)
        later = [threading.Thread(target=client, args=(s_,)) for s_ in seeds[1:]]
        for th in later:
            th.start()
        for th in [first] + later:
            th.join(timeout=600)
    finally:
        pl._resize_group = real_resize
    sched = max(eng._cont_scheds.values(), key=lambda s_: s_.n_joined)
    out = {"rows": rows, "errors": errors, "joined": sched.n_joined, "steps": sched.n_steps,
           "max_rows": sched.max_b, "resizes": resizes, "health": eng.health()}
    eng.close()
    return out


def int8_continuous(tts, sc, wrappers: dict) -> dict:
    """Phase 12 (f): Engine(int8=True, continuous=True, max_batch=4) on two
    192-latent streams on 64-latent blocks, the second admitted into the
    first's live group at a boundary (the first has a block left then, so
    the group grows to two rows); each row against its int8 solo stream
    on the engine's quantized params (rel-L2 bound REL_L2_BOUND), the
    launches of K1, K2, K4 and K5 exactly as the group's samplings imply.
    Returns the launches."""
    from echo_tts_tpu_torch.pipeline import pipeline as pl
    from echo_tts_tpu_torch.serve.engine import Engine

    L, k2_decode = tts.dit_cfg.num_layers, 3 * len(tts.ae_cfg.decoder_rates)
    sc = dataclasses.replace(sc, sequence_length=192, num_steps=20)
    streams = {4000: (SHORT_TEXT, sc), 4001: (SPEAKER_TEXT, sc)}
    eng = Engine(tts, int8=True, max_batch=4, continuous=True, continuous_block=64)
    qtts = dataclasses.replace(tts, dit_params=eng.tts.dit_params)
    solo = {seed: np.concatenate(list(pl.sample_pipeline_stream(
        qtts, text, None, seed, sc=sc_, block_size=64, normalize_text=True)), -1)
        for seed, (text, sc_) in streams.items()}
    del qtts
    for w in wrappers.values():
        w.launches = 0
    g, wall, ev = events_ms(lambda: cont_streams(eng, streams, 64))
    got = {k: w.launches for k, w in wrappers.items()}
    del eng
    samplings = g["joined"] + g["steps"]  # a fast join samples its first block alone
    per = samplings * L * sc.num_steps
    want = {"joint_attention": samplings * k1_launches(sc, L), "res_chain": samplings * k2_decode,
            "int8_gemm": 4 * per, "quant_rows": 4 * per}
    fails = list(g["errors"])
    for seed, row in sorted(g["rows"].items()):
        a = row["audio"]
        rel = (rel_l2(torch.from_numpy(a), torch.from_numpy(solo[seed]))
               if a is not None and a.shape == solo[seed].shape else float("inf"))
        log(f"# int8 (f) continuous group row {seed}: time to first audio {row['ttfa_s']:.2f} s, "
            f"wall {row['wall_s']:.2f} s, audio rel-L2 against its int8 solo stream {rel:.3e} "
            f"(bound {REL_L2_BOUND})")
        if not (rel < REL_L2_BOUND and np.isfinite(a).all()):
            fails.append(f"row {seed}: rel-L2 {rel:.3e}")
    grows = [(a, b) for a, b in g["resizes"] if b > a]
    log(f"# int8 (f) Engine(int8=True, continuous=True, max_batch=4), two 192-latent streams "
        f"on 64-latent blocks: {g['joined']} joins (fast), {g['steps']} group steps, resizes "
        f"{g['resizes']}, at most {g['max_rows']} rows; wall {wall:.1f} ms, CUDA events "
        f"{ev:.1f} ms; launches {got} (expected from {samplings} samplings {want})")
    if got != want:
        fails.append(f"launches {got}, expected {want}")
    if g["joined"] != len(streams) or grows != [(1, 2)] or g["health"]["failures"]:
        fails.append(f"joins {g['joined']}, grows {grows}, health {g['health']}")
    if fails:
        raise SystemExit("int8 (f): " + "; ".join(fails))
    return got


def phase_levers(dev, wrappers: dict, tts) -> dict:
    """The opt-in levers and the W8A8 int8 trunk on phase 9-11's weights
    (DiTConfig() with the latent modules, AEConfig(), bf16, text bucket
    768): (c) request (i) one-shot with joint_uncond, with
    uncond_cache_interval=2 and with the midpoint solver at 20 steps: wall,
    CUDA-event time, audio-s/s, exact K1 and K2 launches, rel-L2 from the
    Euler-40 request (information: other integrators); (d) the time to
    quantize the params; bench/quant_snr.py's latent SNR of the int8 trunk
    against bf16 on the same noise, trunk only and with the encoders (gate
    >= 40 dB); one int8 request (i): wall, device time, busy share, peak
    memory, exact launches, one profile by family beside the bf16 request's
    on the same weights, the host time spent inside the trunk's GEMM calls
    of either; one int8 stream on (64, 192) beside the bf16 one; (e)
    Engine(int8=True) behind the HTTP server: /tts byte-equal to
    the direct call on its quantized params, set_lora (r16) re-quantizing
    the merge and set_lora(None) giving the int8 base bytes back, one /tts
    with "joint_uncond" in the body; (f) Engine(int8=True, continuous=True,
    max_batch=4): two 128-latent streams, the second admitted into the
    first's live group at a boundary, each row against its int8 solo stream,
    exact K1, K2, K4 and K5 launches from the group's samplings. Returns
    {path: launches}."""
    import tempfile

    from echo_tts_tpu_torch.bench import quant_snr as qs
    from echo_tts_tpu_torch.core.config import SamplerConfig
    from echo_tts_tpu_torch.models import quant
    from echo_tts_tpu_torch.models.quant import is_quantized, quantize_dit_params
    from echo_tts_tpu_torch.pipeline import pipeline as pl
    from echo_tts_tpu_torch.serve.engine import Engine
    from echo_tts_tpu_torch.serve.server import serve, wav_bytes
    from echo_tts_tpu_torch.train.lora import LoRAConfig, init_lora, save_lora_checkpoint

    t_phase = time.perf_counter()
    dit_cfg, ae_cfg, L = tts.dit_cfg, tts.ae_cfg, tts.dit_cfg.num_layers
    fields = dict(num_steps=40, cfg_scale_text=3.0, cfg_scale_speaker=8.0, cfg_min_t=0.5,
                  cfg_max_t=1.0, truncation_factor=0.8, sequence_length=640)
    sc = SamplerConfig(**fields)
    sr = ae_cfg.sample_rate
    k2_decode = 3 * len(ae_cfg.decoder_rates)
    out = {}

    def counted(run):
        """run() with every count at 0 before it; (result, wall ms, event ms,
        launches)."""
        for w in wrappers.values():
            w.launches = 0
        res, wall, ev = events_ms(run)
        return res, wall, ev, {k: w.launches for k, w in wrappers.items()}

    def request(params, sc_, seed=0, text=SHORT_TEXT):
        return pl.sample_pipeline(dataclasses.replace(tts, dit_params=params), text, None,
                                  seed, sc=sc_, normalize_text=True)[0]

    # (c) the sampler levers, one-shot, on request (i)
    base_audio = request(tts.dit_params, sc)
    levers = {"joint_uncond": dataclasses.replace(sc, joint_uncond=True),
              "uncond_cache_interval=2": dataclasses.replace(sc, uncond_cache_interval=2),
              "midpoint-20": dataclasses.replace(sc, solver="midpoint", num_steps=20)}
    out["levers"] = {}
    for name, sc_l in levers.items():
        request(tts.dit_params, dataclasses.replace(sc_l, num_steps=2))  # warm-up
        audio, wall, ev, got = counted(lambda: request(tts.dit_params, sc_l))
        want = {"joint_attention": k1_launches(sc_l, L), "res_chain": k2_decode}
        secs = audio.shape[-1] / sr
        r = rel_l2(torch.from_numpy(audio), torch.from_numpy(base_audio))
        log(f"# levers (c) request (i), {name}: wall {wall:.1f} ms, CUDA events {ev:.1f} ms, "
            f"{secs / wall * 1e3:.2f} audio-s/s; launches {got} (expected {want}); audio "
            f"rel-L2 from the Euler-40 request {r:.3e} (information)")
        if ({k: got[k] for k in want} != want or not np.isfinite(audio).all()
                or got["int8_gemm"] or got["quant_rows"]):
            raise SystemExit(f"levers (c) {name}: launches {got}, expected {want}, or "
                             f"non-finite audio")
        out["levers"][name] = got
    split = lap("levers c", t_phase)

    # (d) int8: quantization time, SNR, one request, one stream
    q_s = {}
    for enc in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qp = quantize_dit_params(tts.dit_params, encoders=enc)
        torch.cuda.synchronize()
        q_s[enc] = (time.perf_counter() - t0) * 1e3
        if enc:
            qparams_enc = qp
        else:
            qparams = qp
    q_bytes = sum(v["q"].numel() for v in qparams["blocks"]["attention"].values()
                  if is_quantized(v)) + sum(v["q"].numel()
                                            for v in qparams["blocks"]["mlp"].values())
    log(f"# int8 (d) quantize_dit_params: trunk {q_s[False]:.1f} ms ({q_bytes / 1e9:.3f} GB of "
        f"int8 codes), with the encoders {q_s[True]:.1f} ms")
    inp = qs.inputs(dit_cfg, dev)
    ref = qs.run(tts.dit_params, dit_cfg, sc, tts.ae_params, ae_cfg, tts.pca, inp,
                 tts.model_dtype)
    snr = {}
    for name, qp in (("trunk", qparams), ("trunk+encoders", qparams_enc)):
        (lat, audio), wall, ev, got = counted(
            lambda: qs.run(qp, dit_cfg, sc, tts.ae_params, ae_cfg, tts.pca, inp,
                           tts.model_dtype))
        snr[name] = qs.compare((lat, audio), ref)
        log(f"# int8 (d) bench/quant_snr.py, {name} vs bf16, 40 steps, text 768, speaker 6400 "
            f"latents, same noise: {json.dumps(snr[name])}; launches {got}")
    if min(v["latent_snr_db"] for v in snr.values()) < 40.0:
        raise SystemExit(f"int8 (d): latent SNR under 40 dB: {snr}")
    del qparams_enc
    request(qparams, dataclasses.replace(sc, num_steps=2))  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    audio, wall, ev, got = counted(lambda: request(qparams, sc))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    per_fwd = sc.num_steps * L
    # a trunk layer: K4 q/k/v/gate (one grouped launch), wo, w1/w3 (grouped),
    # w2; K5 before q/k/v/gate, wo, w1/w3 and w2
    want = {"joint_attention": k1_launches(sc, L), "res_chain": k2_decode,
            "int8_gemm": 4 * per_fwd, "quant_rows": 4 * per_fwd}
    secs = audio.shape[-1] / sr
    log(f"# int8 (d) request (i) on the int8 trunk: wall {wall:.1f} ms, CUDA events {ev:.1f} ms, "
        f"{secs / wall * 1e3:.2f} audio-s/s, peak memory {peak:.2f} GiB; launches {got} (expected "
        f"{want}); audio rel-L2 from the bf16 request {rel_l2(torch.from_numpy(audio), torch.from_numpy(base_audio)):.3e}")
    if got != want or not np.isfinite(audio).all():
        raise SystemExit(f"int8 (d): launches {got}, expected {want}, or non-finite audio")
    out["int8"] = got
    prof = profile_families("request (i) on the int8 trunk", lambda: request(qparams, sc))
    prof_bf = profile_families("request (i) on the bf16 trunk, the same weights",
                               lambda: request(tts.dit_params, sc))
    log(f"# int8 (d) request (i): device time {prof['device_ms']:.1f} ms, busy "
        f"{prof['busy']:.1%} of the unprofiled wall; the bf16 request on the same weights: "
        f"{prof_bf['device_ms']:.1f} ms, busy {prof_bf['busy']:.1%}")

    def host_in_gemms(params):
        """(host ms inside the trunk's GEMM calls, quant.mm and
        quant.proj_shared, which the forward calls through the module; the
        request's wall ms) for one request (i)."""
        spent, orig = [0.0], {n: getattr(quant, n) for n in ("mm", "proj_shared")}

        def timed(fn):
            def run(*args):
                t0 = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    spent[0] += time.perf_counter() - t0
            return run

        for n, fn in orig.items():
            setattr(quant, n, timed(fn))
        try:
            _, wall, _ = events_ms(lambda: request(params, sc))
        finally:
            for n, fn in orig.items():
                setattr(quant, n, fn)
        return spent[0] * 1e3, wall

    for turn in range(2):
        (h_bf, w_bf), (h_q, w_q) = host_in_gemms(tts.dit_params), host_in_gemms(qparams)
        log(f"# int8 (d) host time inside the trunk's GEMM calls (quant.mm, quant.proj_shared), "
            f"turn {turn}: bf16 {h_bf:.1f} ms of a {w_bf:.1f} ms wall, int8 {h_q:.1f} ms of a "
            f"{w_q:.1f} ms wall")

    def stream(params=qparams):
        t0, walls, chunks = time.perf_counter(), [], []
        for chunk in pl.sample_pipeline_stream(dataclasses.replace(tts, dit_params=params),
                                               SHORT_TEXT, None, 0, sc=sc,
                                               block_size=[64, 192], normalize_text=True,
                                               stop_at_flattening=False):
            walls.append(time.perf_counter() - t0)
            chunks.append(chunk)
        return walls, np.concatenate(chunks, -1)

    (walls, s_audio), wall, ev, got = counted(stream)
    want_s = {"int8_gemm": 4 * 4 * per_fwd, "quant_rows": 4 * 4 * per_fwd}
    log(f"# int8 (d) sample_pipeline_stream on the int8 trunk, (64, 192): first audio "
        f"{walls[0] * 1e3:.1f} ms, total {walls[-1] * 1e3:.1f} ms, CUDA events {ev:.1f} ms, "
        f"{s_audio.shape[-1] / sr / walls[-1]:.2f} audio-s/s; launches {got} (expected K4/K5 "
        f"{want_s})")
    if {k: got[k] for k in want_s} != want_s or not np.isfinite(s_audio).all():
        raise SystemExit(f"int8 (d): stream launches {got}, expected {want_s}")
    out["int8_stream"] = got
    (walls, s_audio), wall, ev, got = counted(lambda: stream(tts.dit_params))
    log(f"# int8 (d) the same stream on the bf16 trunk: first audio {walls[0] * 1e3:.1f} ms, "
        f"total {walls[-1] * 1e3:.1f} ms, CUDA events {ev:.1f} ms, "
        f"{s_audio.shape[-1] / sr / walls[-1]:.2f} audio-s/s")
    split = lap("int8 d", split)

    # (e) Engine(int8=True) behind the HTTP server
    tmp = tempfile.mkdtemp(prefix="echo_tts_int8_")
    eng = Engine(tts, int8=True)
    httpd = serve(eng, host="127.0.0.1", port=0, background=True)
    port = httpd.server_address[1]
    try:
        base_q = eng.tts.dit_params
        req = {"text": SHORT_TEXT, "seed": 0, **fields}
        (status, _, body, cwall), _, _, got = counted(lambda: http_call(port, "POST", "/tts", req))
        direct = request(base_q, sc)
        same = status == 200 and body == wav_bytes(direct[0], sr)
        log(f"# int8 (e) Engine(int8=True) POST /tts (i): client wall {cwall:.1f} ms, equal to "
            f"the direct call on the engine's int8 params: {same}; launches {got}")
        if not same or got["int8_gemm"] != 4 * per_fwd:
            raise SystemExit("int8 (e): the int8 /tts differs from the direct call")
        sc_j = dataclasses.replace(sc, joint_uncond=True)
        (status, _, body_j, cwall), _, _, got = counted(
            lambda: http_call(port, "POST", "/tts", {**req, "joint_uncond": True}))
        same_j = status == 200 and body_j == wav_bytes(request(base_q, sc_j)[0], sr)
        log(f"# int8 (e) POST /tts (i) with \"joint_uncond\": true: client wall {cwall:.1f} ms, "
            f"equal to the direct call: {same_j}; launches {got} (K1 expected "
            f"{k1_launches(sc_j, L)})")
        if not same_j or got["joint_attention"] != k1_launches(sc_j, L):
            raise SystemExit("int8 (e): the joint_uncond /tts differs from the direct call")
        gen = torch.Generator(device=dev).manual_seed(17)
        lc = LoRAConfig(rank=16, alpha=16.0)
        lora = init_lora(gen, tts.dit_params, lc)
        for ab in lora.values():
            ab["b"].normal_(0.0, 0.5, generator=gen)
        lora_path = os.path.join(tmp, "lora_r16.npz")
        save_lora_checkpoint(lora_path, lora, lc)
        del lora
        t0 = time.perf_counter()
        eng.set_lora(lora_path)
        set_ms = (time.perf_counter() - t0) * 1e3
        merged_q = eng.tts.dit_params
        requant = (merged_q is not base_q and is_quantized(merged_q["blocks"]["mlp"]["w1"])
                   and not torch.equal(merged_q["blocks"]["mlp"]["w1"]["q"],
                                       base_q["blocks"]["mlp"]["w1"]["q"]))
        _, _, body_l, _ = http_call(port, "POST", "/tts", req)
        t0 = time.perf_counter()
        eng.set_lora(None)
        unset_ms = (time.perf_counter() - t0) * 1e3
        _, _, body_b, _ = http_call(port, "POST", "/tts", req)
        log(f"# int8 (e) set_lora r16 under int8: {set_ms:.1f} ms (merge + quantize), the merge "
            f"re-quantized: {requant}, audio changed: {body_l != body}; set_lora(None) "
            f"{unset_ms:.1f} ms, the int8 base back: {eng.tts.dit_params is base_q}, its "
            f"bytes: {body_b == body}")
        if not (requant and body_l != body and eng.tts.dit_params is base_q and body_b == body):
            raise SystemExit("int8 (e): set_lora under int8 did not re-quantize or revert")
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()
        for name in os.listdir(tmp):
            os.unlink(os.path.join(tmp, name))
        os.rmdir(tmp)
    split = lap("int8 e", split)

    # (f) int8 rows in a continuous group
    got = int8_continuous(tts, sc, wrappers)
    out["int8_continuous"] = got
    lap("int8 f", split)
    log(f"# levers and int8 phase: {time.perf_counter() - t_phase:.1f} s")
    return out


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


# ---------------------------------------------------------------------------
# phase 13: checkpoints, the native host codecs and the checkpoint-driven
# entry points at full width
# ---------------------------------------------------------------------------

CKPT_DIR = os.path.join(HERE, "build", "echo_tts_tpu_torch", "ckpt")
CKPT_MIN_FREE_GB = 20.0


def peak_rss_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def wav_pcm(body: bytes) -> np.ndarray:
    """A /tts WAV body's samples as float in [-1, 1]."""
    return np.frombuffer(body[44:], "<i2").astype(np.float64) / 32768.0


def mp3_against_wav(mp3: bytes, wav: bytes, sr: int, tmp: str) -> dict:
    """Decode an MP3 body with the port's libmpg123 route and hold it
    against the WAV body of the same audio: the lengths (the MP3 longer by
    the codec's delay and padding, up to three 1152-sample frames) and the
    correlation after aligning out the delay (the lag of the largest
    cross-correlation), over the whole band and below 16 kHz (the band the
    192 kb/s encoder keeps: above its lowpass a noise-like signal loses
    what no MP3 carries). The gate is the second above 0.99."""
    from scipy.signal import butter, correlate, sosfiltfilt

    from echo_tts_tpu_torch.native.mp3_py import decode_mp3

    path = os.path.join(tmp, "body.mp3")
    with open(path, "wb") as f:
        f.write(mp3)
    y, sr_y = decode_mp3(path)
    x, y = wav_pcm(wav), y[0].astype(np.float64)
    head = min(x.size, 10 * sr)
    lag = int(np.argmax(correlate(y[:head + 3 * 1152], x[:head], mode="valid", method="fft")))
    n = min(x.size, y.size - lag)
    full = float(np.corrcoef(x[:n], y[lag:lag + n])[0, 1])
    sos = butter(8, 16000, fs=sr, output="sos")
    band = float(np.corrcoef(sosfiltfilt(sos, x[:n]), sosfiltfilt(sos, y[lag:lag + n]))[0, 1])
    return {"sr": sr_y, "wav_samples": x.size, "mp3_samples": y.size, "lag": lag,
            "corr": full, "corr_below_16khz": band, "wav_peak": float(np.abs(x).max()),
            "ok": sr_y == sr and 0 <= y.size - x.size <= 3 * 1152 and band > 0.99}


def phase_checkpoints(dev, wrappers: dict) -> dict:
    """The checkpoint layer and its entry points at full width, from files
    written here under the reference's tensor names (no published weights
    are in the repo): (a) DiTConfig() with its latent modules in bf16 (fast
    random values, bench/fast_init.py), AEConfig() in fp32 with weight-norm
    pairs (the port's initializer) and a PCA state, written by the port's
    safetensors writer and loaded back (the DiT stripped and whole), every
    leaf against what was written; (b) `serve --dit/--ae/--pca` behind HTTP:
    /tts request (i) equal to the direct sample_pipeline, and as MP3; (c)
    `--int8 --int8-cache` twice: quantize and save, then load; equal bodies;
    (d) `batch_synthesize` (four requests at --max-batch 4, a 20 s 48 kHz
    WAV prompt and the same prompt as MP3), every WAV equal to its row of
    the direct sample_pipeline_batch; (e) `finetune_lora` one epoch over
    three 29.72 s clips, its adapter through /lora and back; (f)
    `convert_checkpoint` ae and dit, reloaded to the same bits; (g) the
    native resampler against scipy, get_delay / get_output_length, and
    decode_codes against decode_zq(codes_to_zq). Files go to
    build/echo_tts_tpu_torch/ckpt/ and are deleted when their step is done.
    Returns the launches of the driven entry points."""
    import base64
    import shutil
    import tempfile

    from echo_tts_tpu_torch.bench.fast_init import fast_random_like
    from echo_tts_tpu_torch.bench.init_ae import init_ae_params
    from echo_tts_tpu_torch.checkpoints import convert as cv
    from echo_tts_tpu_torch.checkpoints import io as cio
    from echo_tts_tpu_torch.checkpoints.from_jax import ae_params_from_numpy, dit_params_from_numpy
    from echo_tts_tpu_torch.checkpoints.safetensors import SafeTensorsFile, load_numpy, save_file
    from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig, SamplerConfig
    from echo_tts_tpu_torch.models import s1dac
    from echo_tts_tpu_torch.models.dit import init_dit_params
    from echo_tts_tpu_torch.models.pca import PCAState
    from echo_tts_tpu_torch.native import mp3_py
    from echo_tts_tpu_torch.native.resample_py import resample_native
    from echo_tts_tpu_torch.pipeline import pipeline as pl
    from echo_tts_tpu_torch.pipeline.audio_io import load_audio, write_wav
    from echo_tts_tpu_torch.scripts import batch_synthesize, convert_checkpoint, finetune_lora
    from echo_tts_tpu_torch.serve import __main__ as serve_main
    from echo_tts_tpu_torch.serve.server import serve, wav_bytes
    from echo_tts_tpu_torch.train.loop import tree_leaves

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_parity import reference_ae_state, reference_dit_state, tree_diffs

    t_phase = time.perf_counter()
    os.makedirs(CKPT_DIR, exist_ok=True)
    free_gb = shutil.disk_usage(CKPT_DIR).free / 1e9
    log(f"# checkpoints: {free_gb:.1f} GB free under {CKPT_DIR}")
    if free_gb < CKPT_MIN_FREE_GB:
        raise SystemExit(f"checkpoints: {free_gb:.1f} GB free under {CKPT_DIR}, the phase "
                         f"writes about 7.2 GB at once and needs {CKPT_MIN_FREE_GB:.0f} GB")
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=CKPT_DIR)
    paths = {k: os.path.join(tmp, f"{k}.safetensors") for k in ("dit", "ae", "pca")}
    mp3_enc, mp3_dec = mp3_py.mp3_encode_available(), mp3_py.mp3_available()
    driven = {k: 0 for k in wrappers}

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize(dev)
        got = {k: w.launches for k, w in wrappers.items()}
        for k in driven:
            driven[k] += got[k]
        return out, got

    def need(ok, what):
        if not ok:
            raise SystemExit(f"checkpoints {what}")

    def lap13(name, since):
        now = time.perf_counter()
        log(f"# checkpoints ({name}) took {now - since:.1f} s")
        return now

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    dit_cfg, ae_cfg = DiTConfig(), AEConfig()
    sr, L = ae_cfg.sample_rate, dit_cfg.num_layers
    sc = SamplerConfig(num_steps=40, cfg_scale_text=3.0, cfg_scale_speaker=8.0, cfg_min_t=0.5,
                       cfg_max_t=1.0, truncation_factor=0.8, sequence_length=640)
    fields = {k: getattr(sc, k) for k in ("num_steps", "cfg_scale_text", "cfg_scale_speaker",
                                          "cfg_min_t", "cfg_max_t", "truncation_factor",
                                          "sequence_length")}
    want_req = dict({k: 0 for k in wrappers}, joint_attention=k1_launches(sc, L),
                    res_chain=3 * len(ae_cfg.decoder_rates))
    files = ["--dit", paths["dit"], "--ae", paths["ae"], "--pca", paths["pca"]]
    engines, servers = [], []
    try:
        # (a) write, then load back
        (dit_tree, t_init) = timed(lambda: fast_random_like(
            lambda d: init_dit_params(dit_cfg, torch.bfloat16, d), seed=0, device=dev))
        ae_tree = init_ae_params(ae_cfg, torch.float32, dev, seed=1)
        n_dit, n_ae = param_count(dit_tree), param_count(ae_tree)
        ref_pca = PCAState.random(2, ae_cfg.latent_dim, dit_cfg.latent_size, device="cpu")
        pca = {"pca_components": ref_pca.components.numpy(), "pca_mean": ref_pca.mean.numpy(),
               "latent_scale": np.asarray(ref_pca.latent_scale, np.float32)}
        writes = {}
        for name, state in (("dit", lambda: reference_dit_state(dit_tree)),
                            ("ae", lambda: reference_ae_state(ae_tree)), ("pca", lambda: pca)):
            t0 = time.perf_counter()
            nbytes = save_file(state(), paths[name])
            writes[name] = (nbytes, time.perf_counter() - t0)
        log(f"# checkpoints (a) fast_random_like DiTConfig() with latent modules: "
            f"{n_dit / 1e9:.3f} "
            f"B params in {t_init:.1f} s; AEConfig() {n_ae / 1e6:.1f} M (init_ae_params); written "
            + ", ".join(f"{k} {b / 1e9:.3f} GB in {s:.1f} s ({b / s / 1e9:.2f} GB/s)"
                        for k, (b, s) in writes.items())
            + f"; peak host RSS {peak_rss_gib():.2f} GiB")
        rss0 = peak_rss_gib()
        for strip in (True, False):
            (loaded, cfg), secs = timed(lambda: cio.load_dit_from_safetensors(
                paths["dit"], delete_blockwise_modules=strip, device=dev))
            ref = {k: v for k, v in dit_tree.items()
                   if not (strip and k in ("latent_encoder", "latent_norm"))}
            if strip:
                ref["blocks"] = dict(ref["blocks"], attention={
                    k: v for k, v in ref["blocks"]["attention"].items()
                    if k not in ("wk_latent", "wv_latent")})
            bad = tree_diffs(loaded, ref)
            want_cfg = DiTConfig(has_latent_modules=not strip)
            log(f"# checkpoints (a) load_dit_from_safetensors(delete_blockwise_modules={strip}): "
                f"{param_count(loaded) / 1e9:.3f} B params in {secs:.1f} s "
                f"({writes['dit'][0] / secs / 1e9:.2f} GB/s of file), inferred config equal to "
                f"DiTConfig(has_latent_modules={not strip}): {cfg == want_cfg}, leaves differing "
                f"from the written tree: {bad[:5]}; "
                f"peak host RSS {peak_rss_gib():.2f} GiB")
            need(cfg == want_cfg and not bad, f"(a): the DiT loaded with strip={strip} differs")
            del loaded
        del dit_tree
        torch.cuda.empty_cache()
        with SafeTensorsFile(paths["dit"]) as f:
            need(cv.infer_dit_config(f) == dit_cfg, "(a): infer_dit_config from the header")
        (ae_loaded, acfg), secs = timed(lambda: cio.load_ae_from_safetensors(paths["ae"],
                                                                            device=dev))
        # the written AE is its weight-norm pairs; what they hold is their
        # fold (float64 on the host), and the loader must give exactly that
        folded = ae_params_from_numpy(cv.convert_ae_state(cv.fold_weight_norm(
            load_numpy(paths["ae"])), ae_cfg), ae_cfg, device=dev)
        bad = tree_diffs(ae_loaded, folded)
        worst = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                    for a, b in zip(tree_leaves(ae_loaded), tree_leaves(ae_tree))
                    if a.numel())
        pca_state = PCAState.from_safetensors(paths["pca"], device=dev)
        pca_ok = (np.array_equal(pca_state.components.cpu().numpy(), pca["pca_components"])
                  and np.array_equal(pca_state.mean.cpu().numpy(), pca["pca_mean"]))
        log(f"# checkpoints (a) load_ae_from_safetensors: {secs:.1f} s, cfg == AEConfig(): "
            f"{acfg == ae_cfg}, leaves differing from the fold of the written pairs: {bad[:5]}, "
            f"largest relative difference from the initializer's tree {worst:.3e} (the float64 "
            f"fold); PCAState.from_safetensors equal: {pca_ok}; peak host RSS "
            f"{peak_rss_gib():.2f} GiB (before the loads {rss0:.2f})")
        need(acfg == ae_cfg and not bad and worst < 1e-6 and pca_ok, "(a): the AE or PCA differ")
        del ae_loaded, folded, ae_tree
        torch.cuda.empty_cache()
        split = lap13("a", t_phase)

        # (b) serve --dit --ae --pca
        def start(argv):
            args = serve_main.parse_args(argv)
            (eng, secs) = timed(lambda: serve_main.build_engine(args))
            httpd = serve(eng, host="127.0.0.1", port=0, background=True)
            engines.append(eng)
            servers.append(httpd)
            return eng, httpd.server_address[1], secs

        eng_b, port_b, secs = start(files)
        want_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        need(not eng_b.tts.dit_cfg.has_latent_modules and eng_b.tts.model_dtype == want_dtype
             and s1dac.params_dtype(eng_b.tts.ae_params) == want_dtype,
             "(b): the server did not load the one-shot DiT and the AE in their dtype")
        req_i = {"text": SHORT_TEXT, "seed": 0, **fields}
        http_call(port_b, "POST", "/tts", dict(req_i, num_steps=2))  # warm-up
        (status, _, body_i, wall), got = counted(lambda: http_call(port_b, "POST", "/tts", req_i))
        direct = pl.sample_pipeline(eng_b.tts, SHORT_TEXT, None, 0, sc=sc, normalize_text=True)[0]
        same = body_i == wav_bytes(direct[0], sr)
        log(f"# checkpoints (b) serve --dit --ae --pca: engine built from the files in {secs:.1f} "
            f"s; POST /tts request (i): status {status}, client wall {wall:.1f} ms, audio "
            f"{direct.shape[-1] / sr:.2f} s; launches {got} (expected {want_req}); equal to the "
            f"WAV of a direct sample_pipeline: {same}")
        need(status == 200 and same and got == want_req, "(b): /tts from the files")
        if mp3_enc and mp3_dec:
            (status, headers, mp3, wall), got = counted(lambda: http_call(
                port_b, "POST", "/tts", dict(req_i, format="mp3")))
            m = mp3_against_wav(mp3, body_i, sr, tmp)
            log(f"# checkpoints (b) POST /tts request (i) as mp3: status {status}, "
                f"{headers.get('Content-Type')}, {len(mp3)} bytes, client wall {wall:.1f} ms; "
                f"decoded (libmpg123) {json.dumps(m)}; launches {got}")
            need(status == 200 and headers.get("Content-Type") == "audio/mpeg" and m["ok"]
                 and got == want_req, "(b): the mp3 response")
        else:
            log(f"mp3: skipped (libmp3lame {'found' if mp3_enc else 'not found'}, libmpg123 "
                f"{'found' if mp3_dec else 'not found'})")
        split = lap13("b", split)

        # (c) --int8 --int8-cache twice
        cache = os.path.join(tmp, "int8_base.npz")
        want_int8 = dict(want_req, int8_gemm=4 * sc.num_steps * L,
                         quant_rows=4 * sc.num_steps * L)
        int8_bodies = []
        for run in ("first", "second"):
            eng_c, port_c, secs = start(files + ["--int8", "--int8-cache", cache])
            http_call(port_c, "POST", "/tts", dict(req_i, num_steps=2))  # warm-up
            (status, _, body, wall), got = counted(lambda: http_call(port_c, "POST", "/tts",
                                                                     req_i))
            int8_bodies.append(body)
            log(f"# checkpoints (c) serve --int8 --int8-cache, {run} start: engine in {secs:.1f} "
                f"s, int8 base {json.dumps(eng_c.int8_base)}, cache file "
                f"{os.path.getsize(cache) / 1e9:.3f} GB; POST /tts (i) client wall {wall:.1f} "
                f"ms; launches {got} (expected {want_int8})")
            need(status == 200 and got == want_int8, f"(c) {run}: /tts")
            need(eng_c.int8_base["how"] == ("quantized" if run == "first" else "loaded"),
                 f"(c) {run}: the base was {eng_c.int8_base['how']}")
            httpd = servers.pop()
            httpd.shutdown()
            httpd.server_close()
            engines.pop().close()
            del eng_c
            torch.cuda.empty_cache()
        log(f"# checkpoints (c) the two int8 bodies equal byte for byte: "
            f"{int8_bodies[0] == int8_bodies[1]}")
        need(int8_bodies[0] == int8_bodies[1], "(c): the cached base serves other bytes")
        os.unlink(cache)
        split = lap13("c", split)

        # (d) batch_synthesize
        prompt48 = synthetic_speech(20.0, 48000, 7)
        wav48 = os.path.join(tmp, "prompt48k.wav")
        write_wav(wav48, prompt48[0], 48000)
        reqs = [{"id": f"u{i}", "text": text, "speaker": None, "seed": i}
                for i, text in enumerate((SHORT_TEXT, SPEAKER_TEXT, LONG_TEXT, SHORT_TEXT))]
        reqs.append({"id": "wav_prompt", "text": SPEAKER_TEXT, "speaker": wav48, "seed": 4})
        if mp3_enc and mp3_dec:
            mp3_48 = os.path.join(tmp, "prompt48k.mp3")
            need(mp3_py.encode_mp3(mp3_48, prompt48[0], 48000), "(d): encode the mp3 prompt")
            reqs.append({"id": "mp3_prompt", "text": SPEAKER_TEXT, "speaker": mp3_48, "seed": 5})
        else:
            log("mp3: skipped (the mp3 prompt of batch synthesis)")
        inp = os.path.join(tmp, "requests.jsonl")
        with open(inp, "w") as f:
            f.write("\n".join(json.dumps(r) for r in reqs))
        outdir = os.path.join(tmp, "batch_out")
        summary, got = counted(lambda: batch_synthesize.main(
            ["--input", inp, "--outdir", outdir, "--max-batch", "4"] + files))
        log(f"# checkpoints (d) batch_synthesize --max-batch 4, {len(reqs)} requests: "
            f"{json.dumps(summary)}; launches {got}")
        want_k1 = 2 * k1_launches(SamplerConfig(), L)
        need(summary["files"] == len(reqs) and got["joint_attention"] == want_k1,
             f"(d): files {summary['files']}, K1 {got['joint_attention']} (expected {want_k1})")
        same = {}
        for lo in range(0, len(reqs), 4):
            chunk = reqs[lo:lo + 4]
            batch = [(r["text"], load_audio(r["speaker"]) if r["speaker"] else None, r["seed"])
                     for r in chunk]
            for r, (audio, _, _) in zip(chunk, pl.sample_pipeline_batch(eng_b.tts, batch)):
                with open(os.path.join(outdir, f"{r['id']}.wav"), "rb") as f:
                    same[r["id"]] = f.read() == wav_bytes(audio[0], sr)
        log(f"# checkpoints (d) each WAV equal to its row of the direct sample_pipeline_batch: "
            f"{same}")
        need(all(same.values()), "(d): a WAV differs from the direct batch call")
        split = lap13("d", split)

        # (e) finetune_lora, then /lora on the server of (b)
        clip_dir = os.path.join(tmp, "clips")
        os.makedirs(clip_dir)
        texts = {}
        for i in range(3):
            p = os.path.join(clip_dir, f"clip{i}.wav")
            write_wav(p, synthetic_speech(CLIP_LATENTS * ae_cfg.frame_length / sr, sr, 30 + i)[0],
                      sr)
            texts[p] = f"[S1] Clip number {i} of the finetune says a sentence of its own."
        tr = os.path.join(tmp, "transcripts.json")
        with open(tr, "w") as f:
            json.dump(texts, f)
        lora_path = os.path.join(tmp, "lora_best.npz")
        ft, got = counted(lambda: finetune_lora.main(
            ["--audio-dir", clip_dir, "--transcripts", tr, "--out", lora_path, "--epochs", "1",
             "--batch-size", "2"] + files))
        log(f"# checkpoints (e) finetune_lora, 1 epoch, 3 clips of {CLIP_LATENTS} latents, batch "
            f"2: {json.dumps(ft)}; launches {got}")
        need(ft["steps"] >= 1 and all(math.isfinite(x) for x in ft["step_losses"])
             and os.path.exists(lora_path) and got["joint_attention_bwd"] == ft["steps"] * L,
             "(e): the finetune")

        def lora_round():
            out = [http_call(port_b, "POST", "/lora", {"path": lora_path})]
            out.append(http_call(port_b, "POST", "/tts", req_i))
            out.append(http_call(port_b, "POST", "/lora", {"path": None}))
            out.append(http_call(port_b, "POST", "/tts", req_i))
            return out

        (set_, merged, unset, back), got = counted(lora_round)
        log(f"# checkpoints (e) POST /lora the finetuned adapter ({set_[3]:.1f} ms), /tts, revert "
            f"({unset[3]:.1f} ms), /tts: statuses {[r[0] for r in (set_, merged, unset, back)]}; "
            f"back to the bytes of (b): {back[2] == body_i}; launches {got}")
        need(all(r[0] == 200 for r in (set_, merged, unset, back)) and back[2] == body_i,
             "(e): /lora and back")
        shutil.rmtree(clip_dir)
        split = lap13("e", split)

        # (f) convert_checkpoint ae, then dit
        ae_f32, _ = cio.load_ae_from_safetensors(paths["ae"], device=dev)
        for kind, extra, ref_params, to_port in (
                ("ae", [], ae_f32,
                 lambda t_: ae_params_from_numpy(t_, ae_cfg, device=dev, dtype=torch.float32)),
                ("dit", ["--delete-blockwise"], eng_b._base_params,
                 lambda t_: dit_params_from_numpy(t_, eng_b.tts.dit_cfg, device=dev,
                                                  dtype=want_dtype))):
            npz = os.path.join(tmp, f"{kind}.npz")
            (out, secs) = timed(lambda: convert_checkpoint.main(
                [kind, paths[kind], npz] + extra + (["--dtype", "f32"] if want_dtype ==
                                                    torch.float32 and kind == "dit" else [])))
            (back_tree, load_secs) = timed(lambda: to_port(cio.load_pytree(npz)))
            bad = tree_diffs(back_tree, ref_params)
            log(f"# checkpoints (f) convert_checkpoint {kind}: {out['params'] / 1e6:.1f} M params, "
                f"npz {os.path.getsize(npz) / 1e9:.3f} GB in {secs:.1f} s; load_pytree + "
                f"from_jax {load_secs:.1f} s; leaves differing from the server's: {bad[:5]}")
            need(not bad, f"(f): the {kind} npz reloads to other bits")
            del back_tree
            os.unlink(npz)
        del ae_f32
        split = lap13("f", split)

        # (g) the native routes and the rest of the S1-DAC API
        from scipy.signal import resample_poly

        prompt16 = synthetic_speech(20.0, 16000, 8)
        for x, rate in ((prompt48, 48000), (prompt16, 16000)):
            t0 = time.perf_counter()
            mine = resample_native(x, rate, sr)
            secs = time.perf_counter() - t0
            g = math.gcd(rate, sr)
            t0 = time.perf_counter()
            ref = resample_poly(x.astype(np.float64), sr // g, rate // g, axis=-1,
                                window=("kaiser", 5.0))
            ref_secs = time.perf_counter() - t0
            err = float(np.abs(mine - ref).max())
            log(f"# checkpoints (g) resample_native {rate} -> {sr} of 20 s: {secs * 1e3:.1f} ms "
                f"(scipy {ref_secs * 1e3:.1f} ms), max |native - scipy| {err:.3e}")
            need(mine.shape == ref.shape and err < 1e-5, f"(g): resample {rate} -> {sr}")
        n_in = prompt48.shape[-1] * sr // 48000
        log(f"# checkpoints (g) get_delay(AEConfig()) = {s1dac.get_delay(ae_cfg)} samples; "
            f"get_output_length(AEConfig(), {n_in}) = {s1dac.get_output_length(ae_cfg, n_in)}")
        spk = load_audio(wav48)
        chunk = 640 * ae_cfg.frame_length
        spk = spk[:, :chunk]
        x = torch.as_tensor(np.pad(spk, ((0, 0), (0, chunk - spk.shape[-1]))), device=dev)[None]
        with torch.no_grad():
            codes, got_enc = counted(lambda: s1dac.encode_codes(eng_b.tts.ae_params, ae_cfg, x))
            audio_c, got = counted(lambda: s1dac.decode_codes(eng_b.tts.ae_params, ae_cfg, codes))
            audio_z = s1dac.decode_zq(eng_b.tts.ae_params, ae_cfg,
                                      s1dac.codes_to_zq(eng_b.tts.ae_params, ae_cfg, codes))
        same = torch.equal(audio_c, audio_z)
        log(f"# checkpoints (g) encode_codes of the prompt ({tuple(codes.shape)}; launches "
            f"{got_enc}), decode_codes -> {tuple(audio_c.shape)}: equal to "
            f"decode_zq(codes_to_zq): {same}; launches {got}")
        need(same and got["res_chain"] == 3 * len(ae_cfg.decoder_rates)
             and bool(torch.isfinite(audio_c).all()), "(g): decode_codes")
        lap13("g", split)
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        for eng in engines:
            eng.close()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"# checkpoint phase: {time.perf_counter() - t_phase:.1f} s, peak host RSS "
        f"{peak_rss_gib():.2f} GiB; launches {driven}")
    return driven


# ---------------------------------------------------------------------------
# phase 14: the mesh and the fleet
# ---------------------------------------------------------------------------

MESH_DIR = os.path.join(HERE, "build", "echo_tts_tpu_torch", "mesh")
# the weights flags of the entry points phase 14 starts (serve, batch_synthesize)
MESH_WEIGHTS_FLAGS = ["--random"]
MESH_WRAPPERS = ("joint_attention", "joint_attention_bwd", "res_chain", "int8_gemm",
                 "quant_rows", "quant_rows_scale", "quant_rows_at")


def mesh_wrappers() -> dict:
    """Every kernel wrapper the mesh path launches, by name."""
    from echo_tts_tpu_torch.ops.int8_gemm import int8_gemm
    from echo_tts_tpu_torch.ops.joint_attention import joint_attention, joint_attention_bwd
    from echo_tts_tpu_torch.ops.quant_rows import quant_rows, quant_rows_at, quant_rows_scale
    from echo_tts_tpu_torch.ops.res_chain import res_units_cl

    return {"joint_attention": joint_attention, "joint_attention_bwd": joint_attention_bwd,
            "res_chain": res_units_cl, "int8_gemm": int8_gemm, "quant_rows": quant_rows,
            "quant_rows_scale": quant_rows_scale, "quant_rows_at": quant_rows_at}


# the sampler steps of phase 14: 20 since (f) was added, to keep the script
# inside its budget (each tp=2 request is a host all-reduce a layer a step);
# (f)'s int8 group runs CONT_INT8_STEPS
MESH_STEPS = 20


def mesh_sc(num_steps: int = MESH_STEPS):
    """The default sampler (dual CFG, 640 latents) at `num_steps`."""
    from echo_tts_tpu_torch.core.config import SamplerConfig

    return SamplerConfig(num_steps=num_steps, cfg_scale_text=3.0, cfg_scale_speaker=8.0,
                         cfg_min_t=0.5, cfg_max_t=1.0, truncation_factor=0.8,
                         sequence_length=640)


def mesh_tts(dev):
    """DiTConfig(has_latent_modules=False) and AEConfig() in bf16 from seeds 0
    and 1 with random_tts's PCA state: `serve --random`'s weights without its
    latent modules, which init_dit_params draws last, so a one-shot request
    gives the same bytes on both."""
    from echo_tts_tpu_torch.bench.init_ae import init_ae_params
    from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig, PipelineConfig
    from echo_tts_tpu_torch.models.dit import init_dit_params
    from echo_tts_tpu_torch.models.pca import PCAState
    from echo_tts_tpu_torch.pipeline.pipeline import EchoTTS

    dit_cfg, ae_cfg = DiTConfig(has_latent_modules=False), AEConfig()
    return EchoTTS(init_dit_params(dit_cfg, torch.bfloat16, dev, seed=0), dit_cfg,
                   init_ae_params(ae_cfg, torch.bfloat16, dev, seed=1), ae_cfg,
                   PCAState.random(0, ae_cfg.latent_dim, dit_cfg.latent_size, device=dev),
                   model_dtype=torch.bfloat16, pipe_cfg=PipelineConfig(), device=dev)


def request_i(tts, sc, seed: int = 0):
    """Request (i) (SHORT_TEXT, no speaker, normalized as the server does) on
    `tts`: (latents fp32 on the host, audio, the server's WAV bytes), the
    audio as `sample_pipeline` makes it."""
    from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline
    from echo_tts_tpu_torch.sampling.euler_cfg import (
        draw_noise,
        sample_euler_cfg_independent_guidances,
    )
    from echo_tts_tpu_torch.serve.server import wav_bytes

    box = {}

    def sample(spk, smask, ids, tmask, rng_seed):
        noise = draw_noise(rng_seed, (1, sc.sequence_length, tts.dit_cfg.latent_size),
                           tts.device)
        box["lat"] = sample_euler_cfg_independent_guidances(
            tts.dit_params, tts.dit_cfg, sc, spk, smask, ids, tmask, noise,
            model_dtype=tts.model_dtype)
        return box["lat"]

    with torch.no_grad():
        audio, _, _ = sample_pipeline(tts, SHORT_TEXT, None, seed, sc=sc, normalize_text=True,
                                      sample_fn=sample)
    return box["lat"].float().cpu(), audio, wav_bytes(audio[0], tts.ae_cfg.sample_rate)


def counted(wrappers: dict, fn, dev):
    """fn() with every launch count at 0 before, the tp collectives' stats
    and the peak memory reset; (result, launches, all-reduce stats, peak
    GiB, wall s) read just after."""
    from echo_tts_tpu_torch.parallel.tp import STATS, reset_stats

    cuda = dev.type == "cuda"
    for w in wrappers.values():
        w.launches = 0
    reset_stats()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, {k: w.launches for k, w in wrappers.items()}, dict(STATS),
            torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0, wall)


def mesh_train_batch(b: int, seed: int) -> dict:
    """A training batch at the path's shapes: B clips of 640 latents (the
    second ragged), 768 text tokens (60 real), a 640-latent speaker
    prompt."""
    rng = np.random.default_rng(seed)
    lm = np.ones((b, 640), bool)
    lm[1:, 600:] = False
    tm = np.zeros((b, 768), bool)
    tm[:, :60] = True
    return {"latent": rng.standard_normal((b, 640, 80)).astype(np.float32), "latent_mask": lm,
            "text_input_ids": rng.integers(0, 256, (b, 768)).astype(np.int32), "text_mask": tm,
            "speaker_latent": rng.standard_normal((b, 640, 80)).astype(np.float32),
            "speaker_mask": np.ones((b, 640), bool)}


def _mesh_rank(rank: int, task: str, init: str, out_dir: str, dev_type: str) -> None:
    """One rank of a phase-14 group: two ranks on cuda:0 over gloo."""
    from echo_tts_tpu_torch.parallel.mesh import destroy, initialize_multihost

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device(dev_type)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(init, 2, rank, backend="gloo", device=dev)
    try:
        res = {"tp": _mesh_tp_work, "dp": _mesh_dp_work,
               "cont": _mesh_cont_work}[task](rank, dev, out_dir)
        torch.save(res, os.path.join(out_dir, f"{task}_rank{rank}.pt"))
    finally:
        destroy()


def _grad_parts(loss_fn, full: dict, shard: dict, rank: int):
    """(loss full, loss shard, sum of squared differences and of squared
    reference values over this rank's part of the gradients): the shard's
    gradients against the slices of the full tree's, each replicated leaf
    counted by rank 0 alone."""
    from echo_tts_tpu_torch.parallel.sharding import shard_slice, spec_for
    from echo_tts_tpu_torch.parallel.tp import current_mesh
    from echo_tts_tpu_torch.train.loop import tree_leaves

    def named(tree, names=()):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in named(tree[k], names + (k,))]
        return [(names, tree)]

    out = []
    for tree in (full, shard):
        leaves = tree_leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(tree)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for p in leaves:
            p.requires_grad_(False)
        out.append((float(loss.detach()), list(grads)))
    (l1, g1), (l2, g2) = out
    diff2 = ref2 = 0.0
    mesh = current_mesh()
    for (names, p), a, b in zip(named(full), g1, g2):
        if a is None and b is None:
            continue
        a = torch.zeros_like(p) if a is None else a
        spec = spec_for(names, a.dim())
        if "tp" in spec:
            a = shard_slice(a, spec, mesh, names)
        elif rank != 0:
            continue
        b = torch.zeros_like(a) if b is None else b
        diff2 += float((b.double() - a.double()).square().sum())
        ref2 += float(a.double().square().sum())
    return l1, l2, diff2, ref2


def clone_tree(tree):
    return ({k: clone_tree(v) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.clone())


def _mesh_tp_work(rank: int, dev, out_dir: str) -> dict:
    """(b) and (e) on one rank of tp=2: request (i) in bf16 and int8 against
    the tp=1 references, each row-sharded int8 product of one layer bit for
    bit, the gradients of a B=2 training loss against tp=1's and one train
    step, the direct tp=2 calls the server's bodies are held to, and a
    sharded torch.distributed.checkpoint save and load."""
    import dataclasses
    import shutil

    from echo_tts_tpu_torch.checkpoints.io import load_sharded, save_sharded
    from echo_tts_tpu_torch.core.config import MeshConfig
    from echo_tts_tpu_torch.models import quant
    from echo_tts_tpu_torch.parallel.mesh import make_mesh
    from echo_tts_tpu_torch.parallel.multihost import barrier, feed_process_local_batch
    from echo_tts_tpu_torch.parallel.sharding import shard_params
    from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline
    from echo_tts_tpu_torch.serve.server import wav_bytes
    from echo_tts_tpu_torch.train.loop import TrainConfig, make_train_step
    from echo_tts_tpu_torch.train.loss import compute_diffusion_loss
    from echo_tts_tpu_torch.train.lora import load_lora_checkpoint, merge_lora

    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    wrappers = mesh_wrappers()
    sc = mesh_sc()
    mesh = make_mesh(MeshConfig(dp=1, tp=2), dev)
    tts = mesh_tts(dev)
    res = {"rank": rank}
    stts = dataclasses.replace(tts, dit_params=shard_params(tts.dit_params, mesh))
    res["heads"] = stts.dit_params["blocks"]["attention"]["k_norm"].shape[1]
    (lat, audio, wav), res["launches"], res["all_reduce"], res["peak_gib"], res["wall_s"] = \
        counted(wrappers, lambda: request_i(stts, sc), dev)
    res["wav"] = wav
    res["rel_latents"], res["rel_audio"] = rel_l2(lat, inp["lat"]), rel_l2(
        torch.as_tensor(audio), torch.as_tensor(inp["audio"]))
    res["finite"] = bool(np.isfinite(audio).all())

    # int8, the trunk quantized on the full tree and then sharded
    qfull = quant.quantize_dit_params(tts.dit_params)
    q8 = dataclasses.replace(tts, dit_params=shard_params(qfull, mesh))
    (lat8, audio8, _), res["int8_launches"], res["int8_all_reduce"], res["int8_peak_gib"], \
        res["int8_wall_s"] = counted(wrappers, lambda: request_i(q8, sc), dev)
    res["int8_rel_latents"] = rel_l2(lat8, inp["lat8"])
    res["int8_rel_audio"] = rel_l2(torch.as_tensor(audio8), torch.as_tensor(inp["audio8"]))
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = {}
    with torch.no_grad():
        for name, w in (("wo", qfull["blocks"]["attention"]["wo"]),
                        ("w2", qfull["blocks"]["mlp"]["w2"])):
            w0 = {"q": w["q"][0], "s": w["s"][0]}
            k = w0["q"].shape[1] // 2
            h = torch.randn((1920, 2 * k), generator=gen, device=dev).to(torch.bfloat16)
            mine = {"q": w0["q"][:, rank * k:(rank + 1) * k].contiguous(), "s": w0["s"]}
            got = quant.mm(h[:, rank * k:(rank + 1) * k].contiguous(), mine, mesh.tp_group)
            rows[name] = bool(torch.equal(got, quant.mm(h, w0)))
    res["int8_rows_equal"] = rows
    del q8, qfull
    torch.cuda.empty_cache()

    # training: the loss and gradients at B=2 through K1 + K3 against tp=1,
    # then one full-param step on the shard
    batch = mesh_train_batch(2, 22)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    draw = torch.Generator(device=dev).manual_seed(23)
    t_d = torch.rand(b["latent"].shape[0], generator=draw, device=dev) ** 2.0
    noise = torch.randn(b["latent"].shape, generator=draw, device=dev)

    def loss_fn(params):
        return compute_diffusion_loss(params, tts.dit_cfg, None, b["latent"], b["latent_mask"],
                                      b["text_input_ids"], b["text_mask"], b["speaker_latent"],
                                      b["speaker_mask"], model_dtype=tts.model_dtype, t=t_d,
                                      noise=noise)

    (l1, l2, d2, r2), res["train_launches"], res["train_all_reduce"], res["train_peak_gib"], \
        res["train_wall_s"] = counted(wrappers, lambda: _grad_parts(
            loss_fn, tts.dit_params, stts.dit_params, rank), dev)
    res.update(loss_tp1=l1, loss_tp2=l2, grad_diff2=d2, grad_ref2=r2)
    tc = TrainConfig(learning_rate=1e-5, warmup_steps=0, total_steps=10)
    opt, step = make_train_step(tts.dit_cfg, tc, model_dtype=tts.model_dtype, mesh=mesh)
    # a copy: the shard's replicated leaves are the full tree's own tensors,
    # and the step updates them in place
    train_params = clone_tree(shard_params(tts.dit_params, mesh))
    state = opt.init(train_params)
    (_, _, loss), res["step_launches"], _, _, res["step_wall_s"] = counted(
        wrappers, lambda: step(train_params, state, torch.Generator(device=dev).manual_seed(24),
                               feed_process_local_batch(mesh, batch)), dev)
    res["step_loss"] = float(loss)
    del train_params, state, opt, step
    torch.cuda.empty_cache()

    # the direct tp=2 calls the server is held to: request (i), and the same
    # with the LoRA merged on the full tree
    res["direct"] = wav
    lora, lc = load_lora_checkpoint(inp["lora"], dev)
    merged = dataclasses.replace(tts, dit_params=shard_params(
        merge_lora(tts.dit_params, lora, lc), mesh))
    with torch.no_grad():
        audio_l, _, _ = sample_pipeline(merged, SHORT_TEXT, None, 0, sc=sc, normalize_text=True)
    res["direct_lora"] = wav_bytes(audio_l[0], tts.ae_cfg.sample_rate)
    del merged
    torch.cuda.empty_cache()

    # (e) a sharded save and load
    ckpt = os.path.join(out_dir, "dcp")
    barrier()
    t0 = time.perf_counter()
    save_sharded(ckpt, stts.dit_params, mesh)
    res["dcp_save_s"] = time.perf_counter() - t0
    def zeros(tree):
        return ({k: zeros(v) for k, v in tree.items()} if isinstance(tree, dict)
                else torch.zeros_like(tree))

    t0 = time.perf_counter()
    back = load_sharded(ckpt, zeros(stts.dit_params), mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    res["dcp_load_s"] = time.perf_counter() - t0

    def equal(a, bb):
        if isinstance(a, dict):
            return all(equal(a[k], bb[k]) for k in a)
        return bool(torch.equal(a, bb))

    res["dcp_equal"] = equal(stts.dit_params, back)
    res["dcp_bytes"] = sum(os.path.getsize(os.path.join(r, f))
                           for r, _, fs in os.walk(ckpt) for f in fs)
    barrier()
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    del back
    torch.cuda.empty_cache()
    res["f7"] = _mesh_f7_set_lora(rank, tts, mesh, inp["lora"])
    return res


def tree_digest(tree) -> str:
    """sha1 over a tree's leaves in key order, each read on its device as
    the sum of its bits (as integer words of its width) and of its values in
    fp64:
    a tree that took any other values reads another digest."""
    import hashlib

    h = hashlib.sha1()

    def walk(t, name):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{name}.{k}")
            return
        word = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        bits = int(t.contiguous().view(word).sum(dtype=torch.int64))
        h.update(f"{name}:{tuple(t.shape)}:{bits}:{float(t.double().sum())!r};".encode())

    walk(tree, "")
    return h.hexdigest()


def _mesh_f7_set_lora(rank: int, tts, mesh, lora_path: str) -> dict:
    """(b) F7 on one rank of a tp=2 Engine: rank 1 alone cannot read the
    adapter. Both ranks must raise, and neither may take a new tree: the
    digest of each rank's DiT tree before and after, all-gathered."""
    import torch.distributed as dist

    import echo_tts_tpu_torch.serve.engine as engine_mod

    t0 = time.perf_counter()
    real = engine_mod.load_lora_checkpoint
    if rank == 1:
        def unreadable(path, device=None):
            raise OSError(f"adapter {path} unreadable on rank 1")

        engine_mod.load_lora_checkpoint = unreadable
    try:
        eng = engine_mod.Engine(tts, mesh=mesh)
        before = tree_digest(eng.tts.dit_params)
        err = None
        if rank == 0:
            try:
                eng.set_lora(lora_path)
            except RuntimeError as e:
                err = str(e)
        else:
            eng.follow()
            err = eng.follow_errors[-1][1] if eng.follow_errors else None
        eng.close()
        mine = (before, tree_digest(eng.tts.dit_params), eng._current_lora_path)
    finally:
        engine_mod.load_lora_checkpoint = real
    digests = [None, None]
    dist.all_gather_object(digests, mine)
    del eng
    torch.cuda.empty_cache()
    return {"error": err, "digests": digests, "seconds": time.perf_counter() - t0}


# (f): three 128-latent streams (two 64-latent blocks each) on a tp=2
# continuous engine; the first alone, the other two once its group is live;
# then two on an int8 one
CONT_STREAMS = {3000: SHORT_TEXT, 3001: SPEAKER_TEXT,
                3002: "[S1] A third stream joins the group at a block boundary."}
CONT_LATENTS, CONT_BLOCK = 128, 64
# the int8 group's two streams, three blocks each: the first still has a
# block to sample when the second joins, so the group grows to two rows (a
# group's streams share one SamplerConfig, their length included)
CONT_INT8_STREAMS = {3010: SHORT_TEXT, 3011: SPEAKER_TEXT}
CONT_INT8_LATENTS, CONT_INT8_STEPS = CONT_LATENTS + CONT_BLOCK, 10


def cont_kinds():
    """(f)'s groups: (trunk, {seed: (text, SamplerConfig)}); the bf16 one at
    MESH_STEPS, the int8 one at CONT_INT8_STEPS."""
    def sc(steps, n):
        return dataclasses.replace(mesh_sc(steps), sequence_length=n)

    return [("bf16", {seed: (text, sc(MESH_STEPS, CONT_LATENTS))
                      for seed, text in CONT_STREAMS.items()}),
            ("int8", {seed: (text, sc(CONT_INT8_STEPS, CONT_INT8_LATENTS))
                      for seed, text in CONT_INT8_STREAMS.items()})]


def _mesh_cont_work(rank: int, dev, out_dir: str) -> dict:
    """(f) on one rank of tp=2: `serve --random`'s weights (DiTConfig() with
    its latent modules, AEConfig(), bf16). For the bf16 trunk (CONT_STREAMS)
    and then the int8 trunk (CONT_INT8_STREAMS), `cont_kinds`:
    each stream alone through `sample_pipeline_stream` on the sharded tree
    (the int8 one quantized whole, then sharded, as the engine does) at the
    uniform block (the reference), then Engine(mesh, max_batch=4,
    continuous=True[, int8=True]): rank 0 streams the first request, and
    the others once the first's group is live, which admits them at one
    boundary (one resize 1 -> 2, fast joins); rank 1 follows. Launches,
    all-reduces and wall a rank over each engine's life (rank 1: its
    follow())."""
    import dataclasses

    from echo_tts_tpu_torch.bench.trace import random_tts
    from echo_tts_tpu_torch.core.config import MeshConfig
    from echo_tts_tpu_torch.models.quant import quantize_dit_params
    from echo_tts_tpu_torch.parallel.mesh import make_mesh
    from echo_tts_tpu_torch.parallel.multihost import barrier
    from echo_tts_tpu_torch.parallel.sharding import shard_params
    from echo_tts_tpu_torch.pipeline import pipeline as pl
    from echo_tts_tpu_torch.serve.engine import Engine

    wrappers = mesh_wrappers()
    mesh = make_mesh(MeshConfig(dp=1, tp=2), dev)
    tts = random_tts(dev, tiny=False)
    out = {"rank": rank}
    for kind, streams in cont_kinds():
        res = out[kind] = {}
        full = quantize_dit_params(tts.dit_params) if kind == "int8" else tts.dit_params
        direct = dataclasses.replace(tts, dit_params=shard_params(full, mesh))
        del full
        t0 = time.perf_counter()
        with torch.no_grad():
            res["solo"] = {seed: np.concatenate(list(pl.sample_pipeline_stream(
                direct, text, None, seed, sc=sc, block_size=CONT_BLOCK, normalize_text=True)),
                axis=-1) for seed, (text, sc) in streams.items()}
        res["solo_s"] = time.perf_counter() - t0
        del direct
        torch.cuda.empty_cache()
        barrier()
        eng = Engine(tts, mesh=mesh, int8=kind == "int8", max_batch=4, continuous=True,
                     continuous_block=CONT_BLOCK)
        if rank != 0:
            _, res["launches"], res["all_reduce"], res["peak_gib"], res["wall_s"] = counted(
                wrappers, eng.follow, dev)
            eng.close()
        else:
            res["group"], res["launches"], res["all_reduce"], res["peak_gib"], \
                res["wall_s"] = counted(wrappers, lambda: cont_streams(
                    eng, streams, CONT_BLOCK), dev)
        del eng
        torch.cuda.empty_cache()
    return out


def _mesh_dp_work(rank: int, dev, out_dir: str) -> dict:
    """(c) on one rank of dp=2: its two rows of the four requests through
    sample_pipeline_dp, and run_weak_scaling (information: both ranks share
    the card)."""
    from echo_tts_tpu_torch.bench.scaling import run_weak_scaling, sample_pipeline_dp
    from echo_tts_tpu_torch.core.config import MeshConfig
    from echo_tts_tpu_torch.parallel.mesh import make_mesh

    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    wrappers = mesh_wrappers()
    mesh = make_mesh(MeshConfig(dp=2, tp=1), dev)
    tts = mesh_tts(dev)
    rows, launches, _, peak, wall = counted(wrappers, lambda: sample_pipeline_dp(
        tts, inp["dp_requests"], mesh, sc=mesh_sc(), normalize_text=True), dev)
    scaling = run_weak_scaling(tts, mesh, mesh_sc(), repeats=1)
    return {"rows": [(i, a) for i, (a, _n, _t) in rows], "launches": launches, "peak_gib": peak,
            "wall_s": wall, "scaling": scaling}


def spawn_mesh(task: str, out_dir: str, timeout: float, dev) -> list:
    """Two ranks of `task` on `dev` (cuda:0) over gloo (spawned; a file://
    store); their results in rank order. A rank's failure or a hang fails
    the run."""
    import torch.multiprocessing as mp

    store = os.path.join(out_dir, f"{task}.store")
    ctx = mp.start_processes(_mesh_rank, args=(task, "file://" + store, out_dir, dev.type),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise SystemExit(f"mesh ({task}): the ranks still ran after {timeout} s")
    return [torch.load(os.path.join(out_dir, f"{task}_rank{r}.pt"), weights_only=False)
            for r in range(2)]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_tp2(out_dir: str, lora_path: str, smi: str) -> dict:
    """`python -m echo_tts_tpu_torch.serve --random --tp 2 --dist-backend
    gloo`: rank 0 serves HTTP and starts rank 1; /tts of request (i), /lora
    to the adapter, /tts again, /lora back; then SIGTERM, and every process
    it started is gone."""
    import signal

    port = free_port()
    log_path = os.path.join(out_dir, "serve_tp2.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen([sys.executable, "-m", "echo_tts_tpu_torch.serve",
                                 *MESH_WEIGHTS_FLAGS, "--tp", "2", "--dist-backend", "gloo",
                                 "--port", str(port)],
                                cwd=HERE, stdout=logf, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            while True:
                if proc.poll() is not None:
                    raise SystemExit(f"mesh (b): serve --tp 2 exited with {proc.returncode}:\n"
                                     + open(log_path).read()[-3000:])
                try:
                    status, _, _, _ = http_call(port, "GET", "/health")
                    if status == 200:
                        break
                except OSError:
                    pass
                if time.perf_counter() - t0 > 300:
                    raise SystemExit("mesh (b): serve --tp 2 did not answer within 300 s")
                time.sleep(1.0)
            out = {"start_s": time.perf_counter() - t0}
            body = {"text": SHORT_TEXT, "seed": 0, **dataclasses.asdict(mesh_sc())}
            status, _, out["tts"], out["tts_ms"] = http_call(port, "POST", "/tts", body)
            if status != 200:
                raise SystemExit(f"mesh (b): /tts answered {status}: {out['tts'][:300]}")
            status, _, _, _ = http_call(port, "POST", "/lora", {"path": lora_path})
            if status != 200:
                raise SystemExit(f"mesh (b): /lora answered {status}")
            status, _, out["tts_lora"], out["tts_lora_ms"] = http_call(port, "POST", "/tts", body)
            http_call(port, "POST", "/lora", {"path": None})
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=90)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
    left = processes_with(f"--port {port}")
    if left:
        for pid in left:
            os.kill(pid, signal.SIGKILL)
        raise SystemExit(f"mesh (b): serve --tp 2 left processes {left}")
    return out


def processes_with(arg: str) -> list:
    """The pids whose command line holds `arg` and names the server."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if "echo_tts_tpu_torch.serve" in cmd and arg in cmd:
            out.append(int(pid))
    return out


def phase_mesh(dev, smi: str) -> dict:
    """Phase 14: the mesh and the fleet at the full width of
    DiTConfig(has_latent_modules=False) and AEConfig() in bf16 (weights from
    seeds 0 and 1 in every process). (a) a world-size-1 NCCL mesh here;
    (b) tp=2, two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
    device): request (i) at 640 latents and MESH_STEPS steps against tp=1 (rel-L2
    of latents and audio), the launches, peak memory and all-reduce seconds
    a rank, int8 the same way with the row-sharded products of one layer bit
    for bit, the loss and gradients of a B=2 training batch through K1 + K3
    against tp=1 and one step, `serve --tp 2` over HTTP (/tts and a /lora
    swap) against the direct tp=2 calls; (c) dp=2: four rows, two a rank,
    against sample_pipeline_batch at B=4, run_weak_scaling as information;
    (d) batch_synthesize --workers 2 --worker-die-after 1:1 --max-batch 1 on
    four 640-latent requests, byte-equal to the one-process run; (e) a
    sharded torch.distributed.checkpoint save and load at tp=2 (in (b)'s
    ranks), bit for bit. Returns rank 0's launches of (b)'s bf16 and int8
    requests and training step."""
    import shutil

    import torch.distributed as dist

    from echo_tts_tpu_torch.core.config import MeshConfig
    from echo_tts_tpu_torch.models import quant
    from echo_tts_tpu_torch.parallel.mesh import destroy, initialize_multihost, make_mesh
    from echo_tts_tpu_torch.parallel.sharding import shard_params
    from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline_batch
    from echo_tts_tpu_torch.train.lora import LoRAConfig, init_lora, save_lora_checkpoint

    t_phase = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    sc = mesh_sc()
    tts = mesh_tts(dev)
    sr = tts.ae_cfg.sample_rate

    # (a) a world-size-1 NCCL mesh: request (i) through the sharded tree
    initialize_multihost(f"tcp://localhost:{free_port()}", 1, 0,
                         backend="nccl" if dev.type == "cuda" else "gloo", device=dev)
    try:
        mesh1 = make_mesh(MeshConfig(dp=1, tp=1), dev)
        one = torch.ones(4, device=dev)
        dist.all_reduce(one)
        lat, audio, wav = request_i(tts, sc)
        _, _, wav_mesh = request_i(dataclasses.replace(
            tts, dit_params=shard_params(tts.dit_params, mesh1)), sc)
        if wav_mesh != wav or not torch.equal(one, torch.ones(4, device=dev)):
            raise SystemExit("mesh (a): request (i) on the world-size-1 nccl mesh differs from "
                             "the direct call")
        backend = dist.get_backend()
    finally:
        destroy()
    log(f"# mesh (a) world-size-1 {backend} mesh (dp=1, tp=1): request (i) through the sharded "
        f"tree equal to the direct call, {len(wav)} bytes [{smi}]")

    # tp=1 references, (c)'s B=4 reference, the adapter
    qtts = dataclasses.replace(tts, dit_params=quant.quantize_dit_params(tts.dit_params))
    lat8, audio8, _ = request_i(qtts, sc)
    del qtts
    dp_requests = [(SHORT_TEXT, None, seed) for seed in range(4)]
    with torch.no_grad():
        batch4 = [a for a, _n, _t in sample_pipeline_batch(tts, dp_requests, sc=sc,
                                                          normalize_text=True)]
    gen = torch.Generator(device=dev).manual_seed(16)
    lc = LoRAConfig(rank=16, alpha=16.0)
    lora = init_lora(gen, tts.dit_params, lc)
    for ab in lora.values():
        ab["b"].normal_(0.0, 0.5, generator=gen)
    lora_path = os.path.join(MESH_DIR, "lora_r16.npz")
    save_lora_checkpoint(lora_path, lora, lc)
    torch.save({"lat": lat, "audio": audio, "lat8": lat8, "audio8": audio8, "lora": lora_path,
                "dp_requests": dp_requests}, os.path.join(MESH_DIR, "inputs.pt"))
    n_layers, steps = tts.dit_cfg.num_layers, sc.num_steps
    k2_expected = 3 * len(tts.ae_cfg.decoder_rates)  # one launch a unit, three a block
    del tts, lora
    torch.cuda.empty_cache()

    # (b), (e): tp=2
    t0 = time.perf_counter()
    ranks = spawn_mesh("tp", MESH_DIR, 900, dev)
    spawn_s = time.perf_counter() - t0
    fails = []
    k1_expected = k1_launches(sc, n_layers)
    for r in ranks:
        n = r["rank"]
        lb = r["launches"]
        log(f"# mesh (b) tp=2 rank {n} ({r['heads']} of {2 * r['heads']} heads) request (i), "
            f"{sc.sequence_length} latents, {steps} steps: wall {r['wall_s']:.2f} s, rel-L2 against tp=1 latents {r['rel_latents']:.3e} "
            f"audio {r['rel_audio']:.3e}; launches {lb}; all-reduce {r['all_reduce']['all_reduce_calls']} "
            f"calls, {r['all_reduce']['all_reduce_seconds']:.2f} s, "
            f"{r['all_reduce']['all_reduce_bytes'] / 2**30:.2f} GiB; peak memory "
            f"{r['peak_gib']:.2f} GiB [{smi}]")
        li = r["int8_launches"]
        log(f"# mesh (b) tp=2 rank {n} int8 request (i): wall {r['int8_wall_s']:.2f} s, rel-L2 "
            f"against int8 tp=1 latents {r['int8_rel_latents']:.3e} audio "
            f"{r['int8_rel_audio']:.3e}; launches {li}; all-reduce "
            f"{r['int8_all_reduce']['all_reduce_calls']} calls, "
            f"{r['int8_all_reduce']['all_reduce_seconds']:.2f} s; peak memory "
            f"{r['int8_peak_gib']:.2f} GiB; one layer's row-sharded products equal to tp=1's: "
            f"{r['int8_rows_equal']} [{smi}]")
        log(f"# mesh (b) tp=2 rank {n} training B=2 through K1 + K3: loss tp=1 {r['loss_tp1']:.6f} "
            f"tp=2 {r['loss_tp2']:.6f}; gradients {r['train_wall_s']:.2f} s (both runs), launches "
            f"{r['train_launches']}, all-reduce {r['train_all_reduce']['all_reduce_calls']} calls "
            f"{r['train_all_reduce']['all_reduce_seconds']:.2f} s, peak {r['train_peak_gib']:.2f} "
            f"GiB; one step {r['step_wall_s']:.2f} s, loss {r['step_loss']:.6f}, launches "
            f"{r['step_launches']} [{smi}]")
        log(f"# mesh (e) tp=2 rank {n} torch.distributed.checkpoint: save {r['dcp_save_s']:.2f} s, "
            f"load {r['dcp_load_s']:.2f} s, {r['dcp_bytes'] / 2**30:.2f} GiB on disk, equal bits "
            f"{r['dcp_equal']} [{smi}]")
        if lb["joint_attention"] != k1_expected or lb["res_chain"] != k2_expected:
            fails.append(f"rank {n}: K1 {lb['joint_attention']} (expected {k1_expected}), K2 "
                         f"{lb['res_chain']} (expected {k2_expected})")
        per = n_layers * steps
        want8 = (4 * per, 2 * per, 2 * per, 2 * per)
        if (li["int8_gemm"], li["quant_rows"], li["quant_rows_scale"],
                li["quant_rows_at"]) != want8:
            fails.append(f"rank {n}: int8 launches {li}, expected K4, K5 and each tp mode "
                         f"{want8}")
        if r["train_launches"]["joint_attention_bwd"] != 2 * n_layers or \
                r["train_launches"]["joint_attention"] != 4 * n_layers:
            fails.append(f"rank {n}: training launches {r['train_launches']}, expected K1 "
                         f"{4 * n_layers} and K3 {2 * n_layers} over the tp=1 and tp=2 "
                         f"gradients")
        if not r["finite"] or r["rel_latents"] > REL_L2_BOUND or r["rel_audio"] > REL_L2_BOUND:
            fails.append(f"rank {n}: request (i) tp=2 against tp=1 rel-L2 {r['rel_latents']:.3e} "
                         f"/ {r['rel_audio']:.3e} (bound {REL_L2_BOUND})")
        if r["int8_rel_latents"] > REL_L2_BOUND or r["int8_rel_audio"] > REL_L2_BOUND:
            fails.append(f"rank {n}: int8 tp=2 against tp=1 rel-L2 {r['int8_rel_latents']:.3e}")
        if not all(r["int8_rows_equal"].values()):
            fails.append(f"rank {n}: a row-sharded int8 product differs: {r['int8_rows_equal']}")
        if not (np.isfinite(r["step_loss"]) and abs(r["loss_tp2"] - r["loss_tp1"])
                <= REL_L2_BOUND * abs(r["loss_tp1"])):
            fails.append(f"rank {n}: training loss tp=2 {r['loss_tp2']} against tp=1 "
                         f"{r['loss_tp1']}, step loss {r['step_loss']}")
        if not r["dcp_equal"]:
            fails.append(f"rank {n}: the checkpoint did not restore the same bits")
        f7 = r["f7"]
        kept = all(b == a and path is None for b, a, path in f7["digests"])
        log(f"# mesh (b) tp=2 rank {n} F7 set_lora with an adapter rank 1 alone cannot read "
            f"({f7['seconds']:.1f} s): raised {f7['error']!r}; every rank's DiT digest unchanged "
            f"and no LoRA taken: {kept} [{smi}]")
        if not (f7["error"] and "set_lora failed on rank 1" in f7["error"]
                and "unreadable on rank 1" in f7["error"] and kept):
            fails.append(f"rank {n}: F7 set_lora: raised {f7['error']!r}, trees kept {kept}")
    grad_rel = math.sqrt(sum(r["grad_diff2"] for r in ranks)
                         / max(sum(r["grad_ref2"] for r in ranks), 1e-30))
    log(f"# mesh (b) tp=2 training: gradients rel-L2 against tp=1 {grad_rel:.3e} over every "
        f"parameter (bound {REL_L2_BOUND}); spawn to results {spawn_s:.1f} s [{smi}]")
    if grad_rel > REL_L2_BOUND:
        fails.append(f"gradients rel-L2 {grad_rel:.3e}")
    if ranks[0]["wav"] != ranks[1]["wav"]:
        fails.append("the two tp ranks' audio differ")
    if fails:
        raise SystemExit("mesh (b)/(e) failed: " + "; ".join(fails))

    served = serve_tp2(MESH_DIR, lora_path, smi)
    same = (served["tts"] == ranks[0]["direct"], served["tts_lora"] == ranks[0]["direct_lora"],
            ranks[0]["direct_lora"] != ranks[0]["direct"])
    log(f"# mesh (b) serve --tp 2 --dist-backend gloo: up in {served['start_s']:.1f} s; /tts (i) "
        f"{served['tts_ms'] / 1e3:.2f} s, body equal to the direct tp=2 call: {same[0]}; after "
        f"/lora {served['tts_lora_ms'] / 1e3:.2f} s, equal to the direct tp=2 call on the merged "
        f"tree: {same[1]} (and differs from the base: {same[2]}) [{smi}]")
    if not all(same):
        raise SystemExit(f"mesh (b): serve --tp 2 bodies differ from the direct calls: {same}")

    # (c) dp=2
    dps = spawn_mesh("dp", MESH_DIR, 600, dev)
    rows = dict(ia for r in dps for ia in r["rows"])
    rels = {i: rel_l2(torch.as_tensor(rows[i]), torch.as_tensor(batch4[i])) for i in range(4)}
    bits = {i: bool(np.array_equal(rows[i], batch4[i])) for i in range(4)}
    for n, r in enumerate(dps):
        log(f"# mesh (c) dp=2 rank {n}: rows {[i for i, _ in r['rows']]} in {r['wall_s']:.2f} s, "
            f"launches {r['launches']}, peak {r['peak_gib']:.2f} GiB [{smi}]")
    log(f"# mesh (c) dp=2 rows against sample_pipeline_batch at B=4: rel-L2 "
        f"{ {i: f'{v:.2e}' for i, v in rels.items()} }, equal bits {bits} (bound "
        f"{REL_L2_BOUND}: a B=2 batch may round apart from B=4) [{smi}]")
    log(f"# mesh (c) run_weak_scaling (information: both ranks share one card) "
        f"{json.dumps(dps[0]['scaling'])} [{smi}]")
    if sorted(rows) != [0, 1, 2, 3] or max(rels.values()) > REL_L2_BOUND:
        raise SystemExit(f"mesh (c): dp rows {sorted(rows)} rel-L2 {rels}")

    # (d) the fleet with a killed worker, byte-equal to one process
    phase_fleet(smi)

    # (f) continuous stream groups on a tp=2 engine, bf16 and int8
    cont = phase_mesh_continuous(dev, smi, n_layers, k2_expected)
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    log(f"# mesh phase: {time.perf_counter() - t_phase:.1f} s [{smi}]")
    r0 = ranks[0]
    return {"mesh tp=2 request (i)": r0["launches"], "mesh tp=2 int8": r0["int8_launches"],
            "mesh tp=2 train step": r0["step_launches"],
            "mesh tp=2 continuous": cont["bf16"], "mesh tp=2 continuous int8": cont["int8"]}


def phase_mesh_continuous(dev, smi: str, n_layers: int, k2_per_decode: int) -> dict:
    """(f): Engine(mesh, max_batch=4, continuous=True) at tp=2, two ranks on
    cuda:0 over gloo, `serve --random`'s weights: three 128-latent streams
    on 64-latent blocks with the default sampler at MESH_STEPS, the second
    and third
    admitted into the first's live group at one boundary (one resize, two
    fast joins); then two 192-latent streams on the int8 trunk at
    CONT_INT8_STEPS steps in one group of two rows (K4, K5 and K5's two tp
    modes). Each row against the
    tp=2 solo stream of its seed on the same trunk (rel-L2 bound
    REL_L2_BOUND), the launches and all-reduces of rank 1 equal to rank 0's
    and to the count from the group's samplings. Returns rank 0's launches
    by trunk."""
    t0 = time.perf_counter()
    ranks = spawn_mesh("cont", MESH_DIR, 600, dev)
    wall = time.perf_counter() - t0
    fails, launches = [], {}
    for kind, streams in cont_kinds():
        r0, r1 = ranks[0][kind], ranks[1][kind]
        g = r0["group"]
        sc = next(iter(streams.values()))[1]
        steps = sc.num_steps
        samplings = g["joined"] + g["steps"]  # a fast join samples its first block alone
        per = samplings * n_layers * steps
        want = {"joint_attention": samplings * k1_launches(sc, n_layers),
                "res_chain": samplings * k2_per_decode}
        if kind == "int8":  # a trunk layer: four K4, two K5, two of each tp mode
            want.update(int8_gemm=4 * per, quant_rows=2 * per, quant_rows_scale=2 * per,
                        quant_rows_at=2 * per)
        fails += [f"{kind} {e}" for e in g["errors"]]
        for seed, row in sorted(g["rows"].items()):
            ref = r0["solo"][seed]
            a = row["audio"]
            rel = (rel_l2(torch.as_tensor(a), torch.as_tensor(ref))
                   if a is not None and a.shape == ref.shape else float("inf"))
            log(f"# mesh (f) tp=2 continuous {kind} row {seed}: time to first audio "
                f"{row['ttfa_s']:.2f} s, wall {row['wall_s']:.2f} s, audio rel-L2 against the "
                f"tp=2 {kind} solo stream of its seed {rel:.3e} (bound {REL_L2_BOUND}) [{smi}]")
            if not (rel <= REL_L2_BOUND and np.isfinite(a).all()):
                fails.append(f"{kind} row {seed}: rel-L2 {rel:.3e}")
        grows = [(a, b) for a, b in g["resizes"] if b > a]
        log(f"# mesh (f) tp=2 continuous {kind} group, {steps} steps: {g['steps']} group steps "
            f"(boundaries with a step), {g['joined']} joins (fast), resizes {g['resizes']}, at "
            f"most {g['max_rows']} rows; requests {g['health']['requests']}, failures "
            f"{g['health']['failures']} [{smi}]")
        for n, r in enumerate((r0, r1)):
            ar = r["all_reduce"]
            log(f"# mesh (f) tp=2 continuous {kind} rank {n}: engine wall {r['wall_s']:.2f} s, "
                f"launches {r['launches']}, all-reduce {ar['all_reduce_calls']} calls "
                f"{ar['all_reduce_seconds']:.2f} s {ar['all_reduce_bytes'] / 2**30:.2f} GiB, peak "
                f"{r['peak_gib']:.2f} GiB; solo references {r['solo_s']:.2f} s [{smi}]")
        same = (r1["launches"] == r0["launches"]
                and r1["all_reduce"]["all_reduce_calls"] == r0["all_reduce"]["all_reduce_calls"])
        log(f"# mesh (f) {kind}: rank 1's launches and all-reduce calls equal rank 0's: {same}; "
            f"expected from {samplings} samplings: {want} [{smi}]")
        if not same:
            fails.append(f"{kind}: rank 1 launches {r1['launches']} against rank 0's "
                         f"{r0['launches']}")
        if {k: r0["launches"][k] for k in want} != want:
            fails.append(f"{kind}: launches {r0['launches']}, expected {want}")
        if g["joined"] != len(streams) or grows != [(1, 2)]:
            fails.append(f"{kind}: joins {g['joined']}, grows {grows} (expected "
                         f"{len(streams)} and [(1, 2)])")
        if g["health"]["failures"]:
            fails.append(f"{kind}: health {g['health']}")
        launches[kind] = r0["launches"]
    log(f"# mesh (f) spawn to results {wall:.1f} s [{smi}]")
    if fails:
        raise SystemExit("mesh (f) failed: " + "; ".join(fails))
    return launches


def phase_fleet(smi: str) -> dict:
    """(d): batch_synthesize --random --max-batch 1 on four 640-latent
    requests as one process, then with --workers 2 --worker-die-after 1:1,
    each run a process of its own with the same defaults: every WAV equal,
    dead_workers [1], reassigned >= 1."""
    d = os.path.join(MESH_DIR, "fleet")
    os.makedirs(d)
    inp = os.path.join(d, "reqs.jsonl")
    with open(inp, "w") as f:
        for i in range(4):
            f.write(json.dumps({"id": f"u{i}", "text": SHORT_TEXT, "speaker": None,
                                "seed": i}) + "\n")
    sc = mesh_sc()
    common = ["--input", inp, *MESH_WEIGHTS_FLAGS, "--max-batch", "1", "--num-steps",
              str(sc.num_steps), "--sequence-length", str(sc.sequence_length)]
    def run(extra):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "echo_tts_tpu_torch.scripts.batch_synthesize",
                               *common, *extra], cwd=HERE, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"mesh (d): batch_synthesize {extra} failed:\n{proc.stderr[-3000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1]), time.perf_counter() - t0

    one, one_s = run(["--outdir", os.path.join(d, "one")])
    summary, fleet_s = run(["--outdir", os.path.join(d, "fleet"), "--workers", "2",
                            "--worker-die-after", "1:1", "--stale-after-s", "300"])
    equal = {f"u{i}": open(os.path.join(d, "one", f"u{i}.wav"), "rb").read()
             == open(os.path.join(d, "fleet", f"u{i}.wav"), "rb").read() for i in range(4)}
    log(f"# mesh (d) batch_synthesize --workers 2 --worker-die-after 1:1 --max-batch 1, four "
        f"640-latent requests: {fleet_s:.1f} s (one process {one_s:.1f} s, {one['files']} "
        f"files); summary {json.dumps(summary)}; WAVs byte-equal to one process {equal} [{smi}]")
    if (summary["files"] != 4 or summary["dead_workers"] != [1] or summary["reassigned"] < 1
            or not all(equal.values())):
        raise SystemExit(f"mesh (d): fleet summary {summary}, equal {equal}")
    return {"summary": summary, "equal": equal}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    kernels_only, slices_only = "--kernels-only" in argv, "--slices-only" in argv
    checkpoints_only, mesh_only = "--checkpoints-only" in argv, "--mesh-only" in argv
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from echo_tts_tpu_torch.ops.int8_gemm import int8_gemm
    from echo_tts_tpu_torch.ops.joint_attention import joint_attention, joint_attention_bwd
    from echo_tts_tpu_torch.ops.quant_rows import quant_rows
    from echo_tts_tpu_torch.ops.res_chain import res_units_cl

    slice_wrappers = {"joint_attention": joint_attention, "res_chain": res_units_cl}
    train_wrappers = {**slice_wrappers, "joint_attention_bwd": joint_attention_bwd}
    int8_wrappers = {**slice_wrappers, "int8_gemm": int8_gemm, "quant_rows": quant_rows}
    ckpt_wrappers = {**int8_wrappers, "joint_attention_bwd": joint_attention_bwd}
    if mesh_only:
        phase_build(("joint_attention", "joint_attention_bwd", "res_chain", "int8_gemm",
                     "quant_rows"))
        phase_mesh(dev, smi)
    elif checkpoints_only:
        phase_build(("joint_attention", "joint_attention_bwd", "res_chain", "int8_gemm",
                     "quant_rows"))
        phase_checkpoints(dev, ckpt_wrappers)
    elif slices_only:
        phase_build(("joint_attention", "joint_attention_bwd", "res_chain", "int8_gemm",
                     "quant_rows"))
        tts, _ = phase_slice(dev, slice_wrappers)
        phase_train(tts, dev, train_wrappers)
        del tts
        torch.cuda.empty_cache()
        _, tts = phase_batch(dev, slice_wrappers, phase_stream(dev, slice_wrappers)["tts"])
        phase_serve(dev, slice_wrappers, tts)
        phase_levers(dev, int8_wrappers, tts)
        del tts
        torch.cuda.empty_cache()
        phase_checkpoints(dev, ckpt_wrappers)
    else:
        phase_build()
        phase_core_check(dev)
        phase_conv_core_check(dev)
        phase_int8_core_check(dev)
        errs = phase_kernel_checks(dev)
        errs.update(phase_int8_checks(dev))
        errs.update(phase_variant_checks(dev))
        launches = {"one_shot": {"joint_attention": 0, "res_chain": 0},
                    "training": {"joint_attention": 0, "joint_attention_bwd": 0, "res_chain": 0}}
        if not kernels_only:
            tts, launches["one_shot"] = phase_slice(dev, slice_wrappers)
            launches["training"] = phase_train(tts, dev, train_wrappers)
            del tts
            torch.cuda.empty_cache()
            stream = phase_stream(dev, slice_wrappers)
            launches["streaming"] = stream["launches"]
            batch_launches, tts = phase_batch(dev, slice_wrappers, stream.pop("tts"))
            launches.update(batch_launches)
            del stream
            launches.update(phase_serve(dev, slice_wrappers, tts))
            lever_paths = phase_levers(dev, int8_wrappers, tts)
            launches.update({f"levers {k}": v for k, v in lever_paths.pop("levers").items()})
            launches.update(lever_paths)
            del tts
            torch.cuda.empty_cache()
            launches["checkpoints"] = phase_checkpoints(dev, ckpt_wrappers)
            launches.update(phase_mesh(dev, smi))
            launches["measurement"] = phase_measurement(dev)
        rows = phase_kernel_times(dev, errs, launches)
    log(f"# {smi}")
    if not (slices_only or checkpoints_only or mesh_only):
        print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
