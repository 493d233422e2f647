"""Ranks of the port's multi-process tests (tests/test_torch_mesh.py): each
task runs in every rank of a gloo process group on the CPU, started with
torch.multiprocessing (spawn) and a file:// store under the test's
tmp_path, and writes its numpy results to rank<r>.pt there. This module
imports torch and the port only, never JAX: the JAX references are computed
in the parent. `run_ranks` joins with a timeout, so a hang fails the test
instead of eating the suite's time."""
from __future__ import annotations

import os
import time

import torch

TIMEOUT_S = 400.0


def spawn_ranks(task: str, world: int, dirpath, timeout: float = TIMEOUT_S,
                exits: dict | None = None, **kw):
    """Start `task` on `world` ranks; returns collect(), which joins them
    (within `timeout` seconds of the start) and gives their results in rank
    order. Raises with a child's traceback when one fails, TimeoutError
    when one hangs. The parent may compute its references in between.
    exits: {rank: exit code} of ranks that the task ends itself, with no
    result (None in the list); every other rank must end with code 0."""
    import torch.multiprocessing as mp

    dirpath = str(dirpath)
    os.makedirs(dirpath, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(task, world, dirpath, kw), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout

    def fail(err: Exception):
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        raise err

    def collect() -> list:
        late = TimeoutError(f"{task}: ranks still running after {timeout} s")
        if exits:
            # ProcessContext.join would end the other ranks at the first
            # non-zero exit
            for r, p in enumerate(ctx.processes):
                p.join(max(0.1, deadline - time.monotonic()))
                if p.is_alive():
                    fail(late)
                if p.exitcode != exits.get(r, 0):
                    fail(RuntimeError(f"{task}: rank {r} exited with {p.exitcode}"))
        else:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    fail(late)
        return [None if exits and r in exits else
                torch.load(os.path.join(dirpath, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]

    return collect


def run_ranks(task: str, world: int, dirpath, timeout: float = TIMEOUT_S, **kw) -> list:
    """`spawn_ranks` and join at once."""
    return spawn_ranks(task, world, dirpath, timeout, **kw)()


def _rank_main(rank: int, task: str, world: int, dirpath: str, kw: dict) -> None:
    """One rank: a gloo group on the CPU; kw["bound_s"], when given, is the
    collective bound (initialize_multihost's timeout) in seconds, and goes
    to the task too."""
    import datetime

    from echo_tts_tpu_torch.parallel.mesh import COLLECTIVE_TIMEOUT, destroy, initialize_multihost

    torch.set_num_threads(2)
    bound = kw.get("bound_s")
    initialize_multihost("file://" + os.path.join(dirpath, "store"), world, rank,
                         backend="gloo", device="cpu",
                         timeout=COLLECTIVE_TIMEOUT if bound is None
                         else datetime.timedelta(seconds=bound))
    try:
        out = TASKS[task](rank, dirpath, **kw)
        torch.save(out, os.path.join(dirpath, f"rank{rank}.pt"))
    finally:
        destroy()


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else x


def _load(dirpath: str) -> dict:
    return torch.load(os.path.join(dirpath, "..", "inputs.pt"), weights_only=False)


def _mesh(dp: int, tp: int):
    from echo_tts_tpu_torch.core.config import MeshConfig
    from echo_tts_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(MeshConfig(dp=dp, tp=tp), torch.device("cpu"))


# ---------------------------------------------------------------------------
# tp=2: the forwards, the caches, int8, the sampler
# ---------------------------------------------------------------------------


def task_forward(rank: int, dirpath: str) -> dict:
    from echo_tts_tpu_torch.core import rope as rope_mod
    from echo_tts_tpu_torch.core.rope import precompute_rope
    from echo_tts_tpu_torch.models import dit, quant
    from echo_tts_tpu_torch.parallel.sharding import shard_params
    from echo_tts_tpu_torch.parallel.tp import STATS
    from echo_tts_tpu_torch.sampling.euler_cfg import sample_euler_cfg_independent_guidances

    inp = _load(dirpath)
    cfg, params = inp["cfg"], inp["params"]
    mesh = _mesh(1, 2)
    sp = shard_params(params, mesh)
    t = {k: torch.from_numpy(v) for k, v in inp["arrays"].items()}
    out = {"heads": sp["blocks"]["attention"]["k_norm"].shape[1]}
    with torch.no_grad():
        kvt = dit.get_kv_cache_text(sp, cfg, t["ids"], t["text_mask"])
        kvs = dit.get_kv_cache_speaker(sp, cfg, t["spk"])
        out["kv_text"], out["kv_speaker"] = _np(kvt), _np(kvs)
        out["kv_latent"] = _np(dit.get_kv_cache_latent(sp, cfg, t["prefix"]))
        out["fwd"] = _np(dit.dit_forward(sp, cfg, t["x"], t["t"], t["text_mask"],
                                         t["spk_mask"], kvt, kvs))
        out["fwd_cfg"] = _np(dit.dit_forward_cfg(sp, cfg, t["x"], t["t"], t["text_mask"],
                                                 t["spk_mask"], kvt, kvs,
                                                 speaker_kv_scale=inp["scale"]))
        state = dit.init_latent_kv_state(sp, cfg, 1, inp["total"], torch.float32)
        dit.extend_latent_kv(sp, cfg, state, t["prefix"][:, :8], 0)
        dit.extend_latent_kv(sp, cfg, state, t["prefix"][:, 8:], 8)
        out["latent_state"] = _np(state)
        cos, sin = precompute_rope(cfg.head_dim, inp["total"])
        sp0, s = inp["start_pos"], t["x"].shape[1]
        out["fwd_latent"] = _np(dit.dit_forward_cfg(
            sp, cfg, t["x"], t["t"], t["text_mask"], t["spk_mask"], kvt, kvs,
            rope_q=(cos[sp0:sp0 + s], sin[sp0:sp0 + s]), speaker_kv_scale=inp["scale"],
            kv_latent=(state["k"], state["v"]), latent_mask=t["latent_mask"]))
        # the trap: half-head RoPE over the local heads alone
        real = dit.apply_rope_half_heads
        dit.apply_rope_half_heads = lambda x, c, s_, *a, **k: rope_mod.apply_rope_half_heads(
            x, c, s_)
        try:
            out["fwd_local_rope"] = _np(dit.dit_forward(sp, cfg, t["x"], t["t"], t["text_mask"],
                                                        t["spk_mask"], kvt, kvs))
            out["kv_latent_local_rope"] = _np(dit.get_kv_cache_latent(sp, cfg, t["prefix"]))
        finally:
            dit.apply_rope_half_heads = real
        qsp = shard_params(quant.quantize_dit_params(params, encoders=True), mesh)
        out["int8_q_shape"] = {
            "wq": tuple(qsp["blocks"]["attention"]["wq"]["q"].shape),
            "wq_s": tuple(qsp["blocks"]["attention"]["wq"]["s"].shape),
            "w2": tuple(qsp["blocks"]["mlp"]["w2"]["q"].shape),
            "w2_s": tuple(qsp["blocks"]["mlp"]["w2"]["s"].shape)}
        out["fwd_int8"] = _np(dit.dit_forward_cfg(
            qsp, cfg, t["x"], t["t"], t["text_mask"], t["spk_mask"],
            dit.get_kv_cache_text(qsp, cfg, t["ids"], t["text_mask"]),
            dit.get_kv_cache_speaker(qsp, cfg, t["spk"])))
        # the row-sharded products of one layer, this rank's K
        qfull = quant.quantize_dit_params(params)
        for name, w in (("wo", qfull["blocks"]["attention"]["wo"]),
                        ("w2", qfull["blocks"]["mlp"]["w2"])):
            w0 = {"q": w["q"][0], "s": w["s"][0]}
            k = w0["q"].shape[1] // 2
            h = t[f"h_{name}"][:, rank * k:(rank + 1) * k]
            mine = {"q": w0["q"][:, rank * k:(rank + 1) * k].contiguous(), "s": w0["s"]}
            out[f"row_{name}"] = quant.mm(h, mine, mesh.tp_group).numpy()
        sc = inp["sc"]
        STATS["all_reduce_calls"] = 0
        out["sample"] = _np(sample_euler_cfg_independent_guidances(
            sp, cfg, sc, t["spk"], t["spk_mask"], t["ids"], t["text_mask"], t["noise"],
            model_dtype=torch.float32))
        out["sample_all_reduces"] = STATS["all_reduce_calls"]
        bsp = shard_params({k: _cast(v, torch.bfloat16) for k, v in params.items()}, mesh)
        xb = t["x"].to(torch.bfloat16)
        out["fwd_bf16"] = _np(dit.dit_forward(
            bsp, cfg, xb, t["t"].to(torch.bfloat16), t["text_mask"], t["spk_mask"],
            dit.get_kv_cache_text(bsp, cfg, t["ids"], t["text_mask"]),
            dit.get_kv_cache_speaker(bsp, cfg, t["spk"].to(torch.bfloat16))))
    return out


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


# ---------------------------------------------------------------------------
# dp=2 sampling
# ---------------------------------------------------------------------------


def task_sample_dp(rank: int, dirpath: str) -> dict:
    from echo_tts_tpu_torch.bench.scaling import run_weak_scaling, sample_pipeline_dp
    from echo_tts_tpu_torch.parallel.multihost import feed_process_local_batch
    from echo_tts_tpu_torch.sampling.euler_cfg import sample_euler_cfg_independent_guidances

    inp = _load(dirpath)
    mesh = _mesh(2, 1)
    b = feed_process_local_batch(mesh, inp["arrays"])
    with torch.no_grad():
        lat = sample_euler_cfg_independent_guidances(
            inp["params"], inp["cfg"], inp["sc"], b["spk"], b["spk_mask"], b["ids"],
            b["text_mask"], b["noise"], model_dtype=torch.float32)
        rows = sample_pipeline_dp(inp["tts"], inp["requests"], mesh, sc=inp["sc"])
        scaling = run_weak_scaling(inp["tts"], mesh, inp["sc"], repeats=1)
    return {"latents": lat.numpy(), "rows": [(i, a) for i, (a, _n, _t) in rows],
            "scaling": scaling}


# ---------------------------------------------------------------------------
# dp=2 x tp=2 train step
# ---------------------------------------------------------------------------


def task_train(rank: int, dirpath: str) -> dict:
    from echo_tts_tpu_torch.parallel.multihost import feed_process_local_batch
    from echo_tts_tpu_torch.parallel.sharding import shard_params
    from echo_tts_tpu_torch.train.loop import make_train_step

    inp = _load(dirpath)
    mesh = _mesh(2, 2)
    sp = shard_params(inp["params"], mesh)
    opt, step = make_train_step(inp["cfg"], inp["tc"], model_dtype=torch.float32, mesh=mesh)
    state = opt.init(sp)
    gen = torch.Generator().manual_seed(inp["seed"])
    sp, state, loss = step(sp, state, gen, feed_process_local_batch(mesh, inp["batch"]))
    return {"loss": float(loss), "params": _np(sp), "dp_rank": mesh.dp_rank,
            "tp_rank": mesh.tp_rank}


# ---------------------------------------------------------------------------
# sharded checkpoints
# ---------------------------------------------------------------------------


def task_checkpoint(rank: int, dirpath: str) -> dict:
    from echo_tts_tpu_torch.checkpoints.io import (
        load_pytree_sharded,
        load_sharded,
        save_sharded,
    )
    from echo_tts_tpu_torch.parallel.sharding import shard_params

    inp = _load(dirpath)
    mesh = _mesh(1, 2)
    sp = shard_params(inp["params"], mesh)
    ckpt = os.path.join(dirpath, "..", "dcp")
    save_sharded(ckpt, sp, mesh)
    like = shard_params(inp["zeros"], mesh)
    back = load_sharded(ckpt, like, mesh)
    return {"mine": _raw(sp), "dcp": _raw(back),
            "npz": _raw(load_pytree_sharded(inp["npz"], mesh)),
            "safetensors": _raw(load_pytree_sharded(inp["safetensors"], mesh))}


def _raw(tree):
    """Leaves as numpy with their dtype's bits (bf16 as int16)."""
    if isinstance(tree, dict):
        return {k: _raw(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy()
    return tree.numpy()


# ---------------------------------------------------------------------------
# Engine(mesh) at tp=2: rank 0 drives it, rank 1 follows
# ---------------------------------------------------------------------------


def _digest(tree) -> str:
    """sha1 of a tree's leaves, bits and names, in key order."""
    import hashlib

    h = hashlib.sha1()

    def walk(t, name):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{name}.{k}")
        else:
            h.update(name.encode())
            h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())

    walk(tree, "")
    return h.hexdigest()


def _bounded(fn, what: str, seconds: float = 120.0):
    """fn() on a thread of its own; a call that has not returned within
    `seconds` ends this rank with exit code 3, so the parent fails at once
    instead of waiting for the spawn's timeout."""
    import sys
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(seconds)
    if th.is_alive():
        print(f"{what} did not finish in {seconds} s", file=sys.stderr, flush=True)
        os._exit(3)
    if "err" in box:
        raise box["err"]
    return box["out"]


def _error_of(fn) -> str:
    try:
        fn()
    except RuntimeError as e:
        return f"{e} <- {e.__cause__}" if e.__cause__ is not None else str(e)
    return ""


def task_engine(rank: int, dirpath: str) -> dict:
    import dataclasses
    import threading

    import echo_tts_tpu_torch.serve.engine as engine_mod

    from echo_tts_tpu_torch.bench.trace import random_tts
    from echo_tts_tpu_torch.parallel.sharding import shard_params
    from echo_tts_tpu_torch.pipeline.pipeline import (
        sample_pipeline,
        sample_pipeline_batch,
        sample_pipeline_stream,
    )
    from echo_tts_tpu_torch.serve.engine import Engine
    from echo_tts_tpu_torch.serve.server import wav_bytes
    from echo_tts_tpu_torch.train.lora import load_lora_checkpoint, merge_lora

    inp = _load(dirpath)
    sc, text, lora_path = inp["sc"], inp["text"], inp["lora"]
    voice, overrides = inp["voice"], inp["overrides"]
    cpu = torch.device("cpu")
    mesh = _mesh(1, 2)
    tts = random_tts(cpu, tiny=True)
    sr = tts.ae_cfg.sample_rate
    direct = dataclasses.replace(tts, dit_params=shard_params(tts.dit_params, mesh))
    out = {}
    with torch.no_grad():
        out["direct"] = wav_bytes(sample_pipeline(direct, text, None, 1, sc=sc,
                                                  normalize_text=True)[0][0], sr)
        out["direct_batch"] = [wav_bytes(a[0], sr) for a, _n, _t in sample_pipeline_batch(
            direct, [(text, None, 1), (text + " Two.", None, 2)], sc=sc, normalize_text=True)]
        out["direct_stream"] = [c for c in sample_pipeline_stream(
            direct, text, None, 3, sc=sc, block_size=(8, 8), normalize_text=True)]
        lora, lc = load_lora_checkpoint(lora_path, cpu)
        merged = dataclasses.replace(tts, dit_params=shard_params(
            merge_lora(tts.dit_params, lora, lc), mesh))
        out["direct_lora"] = wav_bytes(sample_pipeline(merged, text, None, 1, sc=sc,
                                                       normalize_text=True)[0][0], sr)
    # one engine a path: one-shot, stream and LoRA; then the micro-batcher;
    # then a continuous engine's stream (the body `serve --continuous` sends);
    # then the F7 cases, a request with pipeline overrides and a background
    # warmup tail on one engine, whose rank 1 fails to load any adapter and
    # fails its first pipeline call once its collectives are done
    eng = Engine(tts, mesh=mesh)
    if rank != 0:
        eng.follow()
        Engine(tts, mesh=mesh, max_batch=2, batch_wait_ms=2000.0).follow()
        Engine(tts, mesh=mesh, max_batch=2, continuous=True).follow()

        def unreadable(path, device=None):
            raise OSError(f"adapter {path} unreadable on rank 1")

        engine_mod.load_lora_checkpoint = unreadable
        f7 = Engine(tts, mesh=mesh, max_retries=1)
        f7._op_pipeline = _failing_once(f7._op_pipeline)
        before = _digest(f7.tts.dit_params)
        f7.follow()
        return {"followed": True, "f7_errors": list(f7.follow_errors),
                "f7_digest": (before, _digest(f7.tts.dit_params)),
                "f7_lora_path": f7._current_lora_path}
    try:
        out["one"] = wav_bytes(eng.generate(text, None, seed=1, sc=sc)[0][0], sr)
        out["stream"] = list(eng.generate_stream(text, None, seed=3, sc=sc, block_size=(8, 8)))
        eng.set_lora(lora_path)
        out["lora"] = wav_bytes(eng.generate(text, None, seed=1, sc=sc)[0][0], sr)
        eng.set_lora(None)
        out["back"] = wav_bytes(eng.generate(text, None, seed=1, sc=sc)[0][0], sr)
    finally:
        eng.close()
    eng = Engine(tts, mesh=mesh, max_batch=2, batch_wait_ms=2000.0)
    try:
        got = [None, None]

        def call(i, txt, seed):
            got[i] = wav_bytes(eng.generate(txt, None, seed=seed, sc=sc)[0][0], sr)

        threads = [threading.Thread(target=call, args=(0, text, 1)),
                   threading.Thread(target=call, args=(1, text + " Two.", 2))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        out["batch"], out["batches"] = got, eng.health()["batches"]
    finally:
        eng.close()
    eng = Engine(tts, mesh=mesh, max_batch=2, continuous=True)
    try:
        out["continuous_stream"] = list(eng.generate_stream(text, None, seed=3, sc=sc,
                                                            block_size=(8, 8)))
    finally:
        eng.close()
    eng = Engine(tts, mesh=mesh, max_retries=1)
    try:
        before = _digest(eng.tts.dit_params)
        out["f7_lora_error"] = _bounded(lambda: _error_of(lambda: eng.set_lora(lora_path)),
                                        "set_lora failing on rank 1")
        out["f7_digest"] = (before, _digest(eng.tts.dit_params))
        out["f7_lora_path"] = eng._current_lora_path
        out["f7_retry"] = wav_bytes(_bounded(
            lambda: eng.generate(text, None, seed=1, sc=sc)[0][0], "a retried request"), sr)
        out["f7_health"] = eng.health()
        out["override"] = _bounded(lambda: eng.generate(
            text, voice, seed=5, sc=sc, pipe_overrides=overrides)[0], "an overridden request")
        out["warmup_s"] = _bounded(lambda: eng.warmup(sc, background_tail=True),
                                   "the warmup's first part")
        out["tail_running"] = eng.health()["warmup_tail_running"]
        _bounded(lambda: eng._warmup_tail.join(), "the warmup tail")
        out["tail_after"] = eng.health()["warmup_tail_running"]
        out["tail_combos"] = eng.warmup_combos
    finally:
        eng.close()
    return out


def _timeouts(mesh) -> dict:
    """The timeout (s) of the world group and of each group of the mesh."""
    import torch.distributed as dist

    def of(g):
        return g._get_backend(torch.device("cpu")).options._timeout.total_seconds()

    return {"world": of(dist.group.WORLD), "dp": of(mesh.dp_group), "tp": of(mesh.tp_group),
            "status": of(mesh.status), "control": of(mesh.control)}


def task_idle(rank: int, dirpath: str, bound_s: float) -> dict:
    """F9: a tp=2 engine whose leader stays idle for twice the collective
    bound before its first request, while rank 1 waits in follow()."""
    from echo_tts_tpu_torch.bench.trace import random_tts
    from echo_tts_tpu_torch.serve.engine import Engine

    inp = _load(dirpath)
    mesh = _mesh(1, 2)
    eng = Engine(random_tts(torch.device("cpu"), tiny=True), mesh=mesh)
    out = {"timeouts": _timeouts(mesh)}
    if rank != 0:
        t0 = time.monotonic()
        eng.follow()
        return {**out, "followed_s": time.monotonic() - t0,
                "follow_errors": list(eng.follow_errors)}
    time.sleep(2 * bound_s)
    try:
        out["audio"] = _bounded(lambda: eng.generate(inp["text"], None, seed=1, sc=inp["sc"]),
                                "a request after an idle spell")[0]
    finally:
        eng.close()
    return out


def task_dead(rank: int, dirpath: str, bound_s: float, how: str) -> dict:
    """A rank that leaves (how="exit": os._exit(1)) or stops answering
    (how="hang": it waits, without exiting, until rank 0 is done) at the
    start of its part of a pipeline call of a tp=2 engine: rank 0's
    generate raises, and the engine refuses the next call."""
    from echo_tts_tpu_torch.bench.trace import random_tts
    from echo_tts_tpu_torch.serve.engine import Engine

    inp = _load(dirpath)
    done = os.path.join(dirpath, "done")
    mesh = _mesh(1, 2)
    eng = Engine(random_tts(torch.device("cpu"), tiny=True), mesh=mesh, max_retries=1)
    if rank != 0:
        def leave(*a):
            if how == "exit":
                os._exit(1)
            deadline = time.monotonic() + 120
            while not os.path.exists(done) and time.monotonic() < deadline:
                time.sleep(0.05)
            os._exit(0)

        eng._op_pipeline = leave
        eng.follow()
        return {}
    out = {}
    try:
        for name in ("first", "next"):
            t0 = time.monotonic()
            out[name] = _bounded(lambda: _error_of(lambda: eng.generate(
                inp["text"], None, seed=1, sc=inp["sc"])), f"the {name} request", 60 * bound_s)
            out[name + "_s"] = time.monotonic() - t0
        out["health"] = eng.health()
        t0 = time.monotonic()
        _bounded(eng.close, "close()", 60 * bound_s)
        out["close_s"] = time.monotonic() - t0
    finally:
        open(done, "w").close()
    return out


# ---------------------------------------------------------------------------
# Engine(mesh, continuous=True) at tp=2: rank 0 schedules, rank 1 follows
# ---------------------------------------------------------------------------


WAIT_S = 120.0


def _wait(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _join(threads) -> None:
    for t in threads:
        t.join(timeout=WAIT_S)
    if any(t.is_alive() for t in threads):
        raise TimeoutError("a request did not finish in time")


def _streams(eng, reqs, sc, block: int, hold: bool = False) -> dict:
    """Stream `reqs` {seed: text} on `eng` from threads of their own;
    {seed: audio}. hold: every request queues while the caller holds the
    device lock, so the first boundary admits them all."""
    import threading

    import numpy as np

    got = {}

    def run(seed):
        got[seed] = np.concatenate(list(eng.generate_stream(
            reqs[seed], None, seed=seed, sc=sc, block_size=block)), axis=-1)

    threads = [threading.Thread(target=run, args=(seed,)) for seed in reqs]
    if hold:
        with eng._lock:
            for t in threads:
                t.start()
            _wait(lambda: sum(s.pending.qsize() for s in list(eng._cont_scheds.values()))
                  == len(reqs), "the burst to queue")
    else:
        for t in threads:
            t.start()
    _join(threads)
    return got


def _live(eng, n: int):
    """The scheduler whose group has n active rows, once there is one."""
    def find():
        return next((s for s in list(eng._cont_scheds.values())
                     if s.thread.is_alive() and s.n_active >= n), None)

    _wait(lambda: find() is not None, f"a live group of {n}")
    return find()


def _failing_once(fn):
    """fn, which raises after its first call has run (its collectives
    included)."""
    calls = []

    def wrapped(*a):
        out = fn(*a)
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected failure")
        return out

    return wrapped


def task_continuous(rank: int, dirpath: str) -> dict:
    """The tp=2 continuous engine against the direct tp=2 solo streams:
    staggered rows (a live group, the fast join, a shrink), first_block_steps,
    set_lora under a live group of two, a group step that fails on rank 1
    alone, close() with a live group, warmup, a burst grown in one resize.
    Rank 0 slows each group step so that a group is live while it acts
    (rank 1 waits in the step's collectives)."""
    import dataclasses
    import threading

    import numpy as np

    from echo_tts_tpu_torch.parallel.sharding import shard_params
    from echo_tts_tpu_torch.pipeline import pipeline as pl
    from echo_tts_tpu_torch.serve.engine import Engine
    from echo_tts_tpu_torch.train.lora import load_lora_checkpoint, merge_lora

    inp = _load(dirpath)
    tts, sc, cases = inp["tts"], inp["sc"], inp["cases"]
    mesh = _mesh(1, 2)
    direct = dataclasses.replace(tts, dit_params=shard_params(tts.dit_params, mesh))
    lora, lc = load_lora_checkpoint(inp["lora"], torch.device("cpu"))
    merged = dataclasses.replace(tts, dit_params=shard_params(
        merge_lora(tts.dit_params, lora, lc), mesh))
    sc_fb = dataclasses.replace(sc, first_block_steps=1)
    sc_live = dataclasses.replace(sc, sequence_length=inp["live_len"])
    sc_long = dataclasses.replace(sc, sequence_length=4 * inp["live_len"])

    def solo(t, text, seed, sc_, block):
        return np.concatenate(list(pl.sample_pipeline_stream(
            t, text, None, seed, sc=sc_, block_size=block, normalize_text=True)), axis=-1)

    out, memo = {"direct": {}}, {}
    with torch.no_grad():
        for name, (reqs, which, block) in cases.items():
            sc_ = {"sc": sc, "fb": sc_fb, "live": sc_live}[which]
            lora_on = name == "after_lora"
            for seed, text in reqs.items():
                key = (lora_on, which, block, seed, text)
                if key not in memo:
                    memo[key] = solo(merged if lora_on else direct, text, seed, sc_, block)
            out["direct"][name] = {seed: memo[(lora_on, which, block, seed, text)]
                                   for seed, text in reqs.items()}
    if rank != 0:
        followed = []
        for i, max_batch in enumerate((2, 2, 4)):
            e = Engine(tts, mesh=mesh, max_batch=max_batch, continuous=True)
            if i == 1:
                e._op_group_step = _failing_once(e._op_group_step)
            e.follow()
            followed.append(len(e._groups))
            e.close()
        return {"followed": followed}

    real_step, real_resize = pl._stream_step_rows, pl._resize_group
    resizes = []
    pause = {"s": 0.0}

    def slow_step(*a, **k):
        time.sleep(pause["s"])
        return real_step(*a, **k)

    def resize_spy(gs, perm, keep):
        resizes.append((int(gs["prefix"].shape[0]), len(perm)))
        return real_resize(gs, perm, keep)

    pl._stream_step_rows, pl._resize_group = slow_step, resize_spy
    try:
        # staggered rows, first_block_steps, then the swap under a live group
        eng = Engine(tts, mesh=mesh, max_batch=2, continuous=True)
        try:
            reqs = cases["staggered"][0]
            seeds = list(reqs)
            got = {}

            def run(seed):
                got[seed] = np.concatenate(list(eng.generate_stream(
                    reqs[seed], None, seed=seed, sc=sc, block_size=4)), axis=-1)

            pause["s"] = 0.02
            first = threading.Thread(target=run, args=(seeds[0],))
            first.start()
            _live(eng, 1)
            second = threading.Thread(target=run, args=(seeds[1],))
            second.start()
            _join([first, second])
            out["staggered"] = got
            out["staggered_health"] = eng.health()
            out["fb"] = _streams(eng, cases["fb"][0], sc_fb, cases["fb"][2])

            pause["s"] = 0.1
            live = {}

            def streams():
                live.update(_streams(eng, cases["live"][0], sc_live, 4, hold=True))

            th = threading.Thread(target=streams)
            th.start()
            sched = _live(eng, 2)
            eng.set_lora(inp["lora"])
            out["alive_after_swap"] = th.is_alive() and sched.thread.is_alive()
            out["rows_at_swap"] = sched.n_active
            _join([th, sched.thread])
            out["live"] = live
            pause["s"] = 0.0
            out["after_lora"] = _streams(eng, cases["after_lora"][0], sc, 4)
            _wait(lambda: not any(s.thread.is_alive() for s in list(eng._cont_scheds.values())),
                  "the groups to drain")
            out["groups_left"] = len(eng._groups)
        finally:
            eng.close()

        # a group step that fails on rank 1 alone (after its collectives):
        # the client gets the error, the group is closed on both ranks, and
        # the next stream runs; then close() with a live group
        eng = Engine(tts, mesh=mesh, max_batch=2, continuous=True)
        try:
            list(eng.generate_stream("Fails on rank one.", None, seed=4, sc=sc, block_size=4))
            out["failed"] = None
        except RuntimeError as e:
            out["failed"] = str(e)
        _wait(lambda: not any(s.thread.is_alive() for s in list(eng._cont_scheds.values())),
              "the failed group's scheduler to end")
        out["groups_after_fail"] = len(eng._groups)
        out["after_fail"] = _streams(eng, cases["after_fail"][0], sc, 4)
        result = {}
        pause["s"] = 0.05

        def long_stream():
            chunks = []
            try:
                for c in eng.generate_stream("Close mid stream.", None, seed=3, sc=sc_long,
                                             block_size=4):
                    chunks.append(c)
                result["end"] = "clean"
            except RuntimeError as e:
                result["end"] = f"error: {e}"
            result["chunks"] = len(chunks)

        th = threading.Thread(target=long_stream)
        th.start()
        sched = _live(eng, 1)
        eng.close()
        _join([th, sched.thread])
        out["close"] = dict(result, blocks=sc_long.sequence_length // 4,
                            groups_left=len(eng._groups))
        pause["s"] = 0.0

        # warmup through the group calls, then a burst grown in one resize
        eng = Engine(tts, mesh=mesh, max_batch=4, continuous=True)
        try:
            resizes.clear()
            out["warmup_s"] = eng.warmup(sc, include_streaming=True)
            out["warmup_combos"] = eng.warmup_combos
            out["warmup_resizes"] = list(resizes)
            resizes.clear()
            out["burst"] = _streams(eng, cases["burst"][0], sc, 4, hold=True)
            sched = max(eng._cont_scheds.values(), key=lambda s: s.n_joined)
            out["burst_sched"] = (sched.n_joined, sched.max_b)
            out["burst_resizes"] = list(resizes)
        finally:
            eng.close()
    finally:
        pl._stream_step_rows, pl._resize_group = real_step, real_resize
    return out


TASKS = {"forward": task_forward, "sample_dp": task_sample_dp, "train": task_train,
         "checkpoint": task_checkpoint, "engine": task_engine, "continuous": task_continuous,
         "idle": task_idle, "dead": task_dead}
