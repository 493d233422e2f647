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


def spawn_ranks(task: str, world: int, dirpath, timeout: float = TIMEOUT_S, **kw):
    """Start `task` on `world` ranks; returns collect(), which joins them
    (within `timeout` seconds of the start) and gives their results in rank
    order. Raises with a child's traceback when one fails, TimeoutError
    when one hangs. The parent may compute its references in between."""
    import torch.multiprocessing as mp

    dirpath = str(dirpath)
    os.makedirs(dirpath, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(task, world, dirpath, kw), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout

    def collect() -> list:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{task}: ranks still running after {timeout} s")
        return [torch.load(os.path.join(dirpath, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]

    return collect


def run_ranks(task: str, world: int, dirpath, timeout: float = TIMEOUT_S, **kw) -> list:
    """`spawn_ranks` and join at once."""
    return spawn_ranks(task, world, dirpath, timeout, **kw)()


def _rank_main(rank: int, task: str, world: int, dirpath: str, kw: dict) -> None:
    from echo_tts_tpu_torch.parallel.mesh import destroy, initialize_multihost

    torch.set_num_threads(2)
    initialize_multihost("file://" + os.path.join(dirpath, "store"), world, rank,
                         backend="gloo", device="cpu")
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


def task_engine(rank: int, dirpath: str) -> dict:
    import dataclasses
    import threading

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
    # one engine a path: one-shot, stream and LoRA; then the micro-batcher
    eng = Engine(tts, mesh=mesh)
    if rank != 0:
        eng.follow()
        Engine(tts, mesh=mesh, max_batch=2, batch_wait_ms=2000.0).follow()
        return {"followed": True}
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
    return out


TASKS = {"forward": task_forward, "sample_dp": task_sample_dp, "train": task_train,
         "checkpoint": task_checkpoint, "engine": task_engine}
