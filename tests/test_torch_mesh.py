"""The port's (dp, tp) mesh on torch.distributed (echo_tts_tpu_torch/parallel/)
against the JAX package's unsharded functions on the same weights: ranks of
a gloo group on the CPU (tests/torch_mesh_workers.py, spawned, each join
bounded), the JAX references computed here in the parent.

* tp=2: the text, speaker and latent KV caches (each rank's heads), the
  one-branch forward, the CFG forward with the force-speaker scale, the
  [latent | text | speaker] forward and the incremental latent state, the
  sampler, all fp32 with rel-L2 <= 1e-5; a forward with half-head RoPE over
  the local heads, which must fail that check (the trap the global head
  offset avoids); the int8 trunk and encoders against JAX's
  quantize_dit_params forward (rel-L2 <= 1e-3, as the one-process int8 test
  holds it: a code that rounds the other way) and against the port's
  one-process int8 forward (rel-L2 <= 1e-6), each row-sharded product of a
  layer bit for bit against the unsharded one; a bf16 tree against the
  one-process bf16 forward (rel-L2 <= 2e-2, bf16 rounding);
* dp=2: the sampler's rows against JAX's batch, `sample_pipeline_dp`'s rows
  against one process's `sample_pipeline_batch`, the weak-scaling fields;
* dp=2 x tp=2: one full-param train step against one process (loss rel
  1e-5, every weight within 1e-5, a hundredth of the step size);
* tp=2 checkpoints: torch.distributed.checkpoint save/load and the sharded
  npz/safetensors loads, bit for bit;
* Engine(mesh) at tp=2 (one-shot, stream, LoRA swap and back, micro-batch)
  and `serve --tp 2 --cpu --random-tiny` over HTTP, bodies equal to the
  direct tp=2 call; the status exchange around every call (F7): an adapter
  that only rank 1 cannot load raises on both ranks and leaves both trees
  as they were, a request that fails on rank 1 alone after its collectives
  raises on both and its retry equals the direct call; a request with
  pipeline overrides against tp=1 (rel-L2 <= 1e-5); a background warmup
  tail through the followers; `serve --tp 2 --max-batch 2 --continuous`'s /tts_stream
  equal to a tp=2 continuous Engine's chunks (the continuous group under tp
  is held in tests/test_torch_mesh_continuous.py);
* the bounds (parallel/mesh.py): a follower idle for twice the world
  group's timeout, then a request equal to tp=1's (F9: the control group is
  a group of its own); a rank that leaves or hangs inside a pipeline call,
  rank 0's generate raising within four times the collective bound and
  the engine refusing the next call; a rendezvous that a rank never joins;
* the pieces that need no group: specs, shard_params, auto_mesh_config, the
  nccl refusal, K5's scale-only and codes-at-a-scale modes.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echo_tts_tpu.core import config as jc
from echo_tts_tpu.core.rope import precompute_rope as j_rope
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.models import quant as jquant
from echo_tts_tpu.sampling.euler_cfg import (
    sample_euler_cfg_independent_guidances as j_sample,
)
from echo_tts_tpu_torch.checkpoints.from_jax import dit_params_from_numpy
from echo_tts_tpu_torch.core import config as tc
from echo_tts_tpu_torch.models import dit as tdit
from echo_tts_tpu_torch.models import quant as tquant
from echo_tts_tpu_torch.ops.quant_rows import quant_rows_at, quant_rows_plain, quant_rows_scale
from echo_tts_tpu_torch.parallel import mesh as tmesh
from echo_tts_tpu_torch.parallel import sharding as tsh

from torch_mesh_workers import run_ranks, spawn_ranks
from torch_parity import np_tree, rel_l2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tc.DiTConfig().tiny()
JCFG = jc.DiTConfig().tiny()
SC = dict(num_steps=3, sequence_length=16, truncation_factor=0.8)
TOL = 1e-5


def _arrays(seed=0, b=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, 24)).astype(np.int32)
    text_mask = np.broadcast_to(np.arange(24) < 19, (b, 24)).copy()
    spk = rng.standard_normal((b, 16, 80)).astype(np.float32)
    spk_mask = np.broadcast_to(np.arange(16) < 12, (b, 16)).copy()
    return {"ids": ids, "text_mask": text_mask, "spk": spk, "spk_mask": spk_mask,
            "noise": rng.standard_normal((b, 16, 80)).astype(np.float32)}


@pytest.fixture(scope="module")
def weights():
    jp = jdit.init_dit_params(jax.random.PRNGKey(5), JCFG, dtype=jnp.float32)
    return jp, dit_params_from_numpy(np_tree(jp), CFG, device="cpu")


# ---------------------------------------------------------------------------
# tp=2 forwards
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp_run(weights, tmp_path_factory):
    """Both ranks' results and the JAX references."""
    jp, tp = weights
    rng = np.random.default_rng(1)
    arr = _arrays(1)
    total, start = 24, 8
    arr.update(x=rng.standard_normal((1, 8, 80)).astype(np.float32),
               t=np.full((1,), 0.7, np.float32),
               prefix=rng.standard_normal((1, 20, 80)).astype(np.float32),
               latent_mask=(np.arange(total // 4) * 4 < start)[None],
               h_wo=rng.standard_normal((5, CFG.model_size)).astype(np.float32),
               h_w2=rng.standard_normal((5, CFG.intermediate_size)).astype(np.float32))
    scale = [1.5, 1.0]
    d = tmp_path_factory.mktemp("tp")
    torch.save({"cfg": CFG, "params": tp, "arrays": arr, "scale": scale, "total": total,
                "start_pos": start, "sc": tc.SamplerConfig(**SC)}, d / "inputs.pt")
    collect = spawn_ranks("forward", 2, d / "run")

    j = {k: jnp.asarray(v) for k, v in arr.items()}
    kvt = jdit.get_kv_cache_text(jp, JCFG, j["ids"], j["text_mask"])
    kvs = jdit.get_kv_cache_speaker(jp, JCFG, j["spk"])
    js = jdit.init_latent_kv_state(jp, JCFG, 1, total, jnp.float32)
    js = jdit.extend_latent_kv(jp, JCFG, js, j["prefix"][:, :8], 0)
    js = jdit.extend_latent_kv(jp, JCFG, js, j["prefix"][:, 8:], 8)
    cos, sin = j_rope(JCFG.head_dim, total)
    jscale = jnp.asarray(scale)
    jq = jquant.quantize_dit_params(jp, encoders=True)
    ref = {
        "kv_text": kvt, "kv_speaker": kvs,
        "kv_latent": jdit.get_kv_cache_latent(jp, JCFG, j["prefix"]),
        "fwd": jdit.dit_forward(jp, JCFG, j["x"], j["t"], j["text_mask"], j["spk_mask"],
                                kvt, kvs),
        "fwd_cfg": jdit.dit_forward_cfg(jp, JCFG, j["x"], j["t"], j["text_mask"],
                                        j["spk_mask"], kvt, kvs, speaker_kv_scale=jscale),
        "latent_state": js,
        "fwd_latent": jdit.dit_forward_cfg(
            jp, JCFG, j["x"], j["t"], j["text_mask"], j["spk_mask"], kvt, kvs,
            rope_q=(cos[start:start + 8], sin[start:start + 8]), kv_latent=(js["k"], js["v"]),
            latent_mask=j["latent_mask"], speaker_kv_scale=jscale),
        "fwd_int8": jdit.dit_forward_cfg(
            jq, JCFG, j["x"], j["t"], j["text_mask"], j["spk_mask"],
            jdit.get_kv_cache_text(jq, JCFG, j["ids"], j["text_mask"]),
            jdit.get_kv_cache_speaker(jq, JCFG, j["spk"])),
        "sample": j_sample(jp, JCFG, jc.SamplerConfig(**SC), j["spk"], j["spk_mask"], j["ids"],
                           j["text_mask"], j["noise"], model_dtype=jnp.float32),
    }
    own = {}
    tt = {k: torch.from_numpy(v) for k, v in arr.items()}
    with torch.no_grad():
        tq = tquant.quantize_dit_params(tp, encoders=True)
        own["fwd_int8"] = tdit.dit_forward_cfg(
            tq, CFG, tt["x"], tt["t"], tt["text_mask"], tt["spk_mask"],
            tdit.get_kv_cache_text(tq, CFG, tt["ids"], tt["text_mask"]),
            tdit.get_kv_cache_speaker(tq, CFG, tt["spk"])).numpy()
        q1 = tquant.quantize_dit_params(tp)
        for name, w in (("wo", q1["blocks"]["attention"]["wo"]), ("w2", q1["blocks"]["mlp"]["w2"])):
            own[f"row_{name}"] = tquant.mm(tt[f"h_{name}"], {"q": w["q"][0], "s": w["s"][0]}).numpy()
        bp = _to(tp, torch.bfloat16)
        own["fwd_bf16"] = tdit.dit_forward(
            bp, CFG, tt["x"].bfloat16(), tt["t"].bfloat16(), tt["text_mask"], tt["spk_mask"],
            tdit.get_kv_cache_text(bp, CFG, tt["ids"], tt["text_mask"]),
            tdit.get_kv_cache_speaker(bp, CFG, tt["spk"].bfloat16())).float().numpy()
    return collect(), jax.tree_util.tree_map(np.asarray, ref), own


def _clone(tree):
    return ({k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.detach().clone())


def _to(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _heads(ref, rank, axis, local):
    idx = [slice(None)] * ref.ndim
    idx[axis] = slice(rank * local, (rank + 1) * local)
    return ref[tuple(idx)]


@pytest.mark.parametrize("name", ["kv_text", "kv_speaker", "kv_latent"])
def test_tp_kv_caches_hold_each_ranks_heads(tp_run, name):
    """(L, B, H, T, Dh) caches: rank r holds heads [2r, 2r + 2) of 4."""
    ranks, ref, _ = tp_run
    for r, out in enumerate(ranks):
        assert out["heads"] == CFG.num_heads // 2
        for got, want in zip(out[name], ref[name]):
            assert got.shape[2] == CFG.num_heads // 2
            assert rel_l2(got, _heads(want, r, 2, 2)) <= TOL, (name, r)


@pytest.mark.parametrize("name", ["fwd", "fwd_cfg", "fwd_latent"])
def test_tp_forward_matches_jax(tp_run, name):
    """The one-branch forward, the CFG forward with the force-speaker scale
    and the [latent | text | speaker] forward at start_pos 8: every rank's
    output equals the unsharded JAX forward."""
    ranks, ref, _ = tp_run
    for out in ranks:
        assert out[name].shape == ref[name].shape
        assert rel_l2(out[name], ref[name]) <= TOL, (name, rel_l2(out[name], ref[name]))


def test_tp_latent_state_holds_each_ranks_heads(tp_run):
    """Two appends into the incremental latent state: the encoder buffers
    (L_enc, B, T, H_enc, Dh) and the trunk cache (L, B, H, T, Dh) hold each
    rank's heads of JAX's."""
    ranks, ref, _ = tp_run
    for r, out in enumerate(ranks):
        st, js = out["latent_state"], ref["latent_state"]
        for name, axis, local in (("enc_k", 3, 1), ("enc_v", 3, 1), ("k", 2, 2), ("v", 2, 2)):
            assert rel_l2(st[name], _heads(js[name], r, axis, local)) <= TOL, (name, r)


def test_tp_local_half_heads_rope_fails(tp_run):
    """Half-head RoPE over each rank's local heads (rank 0 rotating one of
    its two heads, rank 1 one of its, where the global first half is rank
    0's two) misses the JAX forward by a hundred times the tolerance and
    the latent cache's keys by far: the global head offset is what makes
    test_tp_forward_matches_jax and the cache tests pass."""
    ranks, ref, _ = tp_run
    for r, out in enumerate(ranks):
        assert rel_l2(out["fwd_local_rope"], ref["fwd"]) > 100 * TOL
        k = _heads(ref["kv_latent"][0], r, 2, 2)
        assert rel_l2(out["kv_latent_local_rope"][0], k) > 0.1


def test_tp_int8_forward(tp_run):
    """int8 trunk and encoders at tp=2 against JAX's quantize_dit_params
    forward and against the port's one-process int8 forward."""
    ranks, ref, own = tp_run
    for out in ranks:
        assert out["int8_q_shape"] == {"wq": (2, 32, 64), "wq_s": (2, 32), "w2": (2, 64, 48),
                                       "w2_s": (2, 64)}
        assert rel_l2(out["fwd_int8"], ref["fwd_int8"]) <= 1e-3
        assert rel_l2(out["fwd_int8"], own["fwd_int8"]) <= 1e-6


@pytest.mark.parametrize("name", ["wo", "w2"])
def test_tp_int8_row_products_bit_for_bit(tp_run, name):
    """A row-sharded int8 product over K split in two (MAX of the ranks'
    scales, codes at it, int32 sums added, K4's epilogue) equals the
    unsharded product bit for bit."""
    ranks, _, own = tp_run
    for out in ranks:
        np.testing.assert_array_equal(out[f"row_{name}"], own[f"row_{name}"])


def test_tp_sampler_matches_jax(tp_run):
    """Three Euler CFG steps at tp=2: latents equal JAX's, with two
    all-reduces a trunk layer and encoder layer."""
    ranks, ref, _ = tp_run
    for out in ranks:
        assert rel_l2(out["sample"], ref["sample"]) <= TOL
        # per forward: 2 a trunk layer; text and speaker encoders 2 a layer
        enc = 2 * (CFG.text_num_layers + CFG.speaker_num_layers)
        assert out["sample_all_reduces"] == enc + 3 * 2 * CFG.num_layers


def test_tp_bf16_forward(tp_run):
    ranks, _, own = tp_run
    for out in ranks:
        assert rel_l2(out["fwd_bf16"], own["fwd_bf16"]) <= 2e-2


# ---------------------------------------------------------------------------
# dp=2 sampling, dp x tp training
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dp_run(weights, tmp_path_factory):
    from echo_tts_tpu_torch.bench.trace import random_tts

    jp, tp = weights
    arr = _arrays(2, b=4)
    tts = random_tts(torch.device("cpu"), tiny=True)
    requests = [(f"Row {i}.", None, 10 + i) for i in range(4)]
    sc = tc.SamplerConfig(**SC)
    d = tmp_path_factory.mktemp("dp")
    torch.save({"cfg": CFG, "params": tp, "arrays": arr, "sc": sc, "tts": tts,
                "requests": requests}, d / "inputs.pt")
    collect = spawn_ranks("sample_dp", 2, d / "run")
    j = {k: jnp.asarray(v) for k, v in arr.items()}
    ref = np.asarray(j_sample(jp, JCFG, jc.SamplerConfig(**SC), j["spk"], j["spk_mask"],
                              j["ids"], j["text_mask"], j["noise"], model_dtype=jnp.float32))
    from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline_batch

    with torch.no_grad():
        one = [a for a, _n, _t in sample_pipeline_batch(tts, requests, sc=sc)]
    return collect(), ref, one


def test_dp_sampler_rows_match_jax(dp_run):
    ranks, ref, _ = dp_run
    got = np.concatenate([r["latents"] for r in ranks])
    assert got.shape == ref.shape and rel_l2(got, ref) <= TOL


def test_dp_pipeline_rows_match_one_process(dp_run):
    """sample_pipeline_dp: rank r samples rows 2r, 2r + 1 of the four; each
    equals its row of one process's batch of four."""
    ranks, _, one = dp_run
    rows = dict(i_a for r in ranks for i_a in r["rows"])
    assert sorted(rows) == [0, 1, 2, 3]
    for i, a in rows.items():
        assert a.shape == one[i].shape and rel_l2(a, one[i]) <= 1e-4, i


def test_weak_scaling_reports_on_every_rank(dp_run):
    ranks, _, _ = dp_run
    s0, s1 = ranks[0]["scaling"], ranks[1]["scaling"]
    assert s0 == s1 and s0["devices"] == 2 and s0["device"] == "cpu"
    assert s0["t_dp1_s"] > 0 and s0["t_dpN_s"] > 0 and s0["weak_scaling_efficiency"] > 0


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    from echo_tts_tpu_torch.models.dit import init_dit_params
    from echo_tts_tpu_torch.train.loop import TrainConfig, make_train_step

    cfg = tc.DiTConfig(has_latent_modules=False).tiny()
    params = init_dit_params(cfg, torch.float32, "cpu", seed=3)
    rng = np.random.default_rng(4)
    lm = np.ones((4, 16), bool)
    lm[1, 12:] = False
    lm[3, 9:] = False
    batch = {"latent": rng.standard_normal((4, 16, 80)).astype(np.float32), "latent_mask": lm,
             "text_input_ids": rng.integers(0, 256, (4, 24)).astype(np.int32),
             "text_mask": np.ones((4, 24), bool),
             "speaker_latent": rng.standard_normal((4, 16, 80)).astype(np.float32),
             "speaker_mask": np.ones((4, 16), bool)}
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)
    d = tmp_path_factory.mktemp("train")
    torch.save({"cfg": cfg, "params": params, "batch": batch, "tc": tcfg, "seed": 7},
               d / "inputs.pt")
    collect = spawn_ranks("train", 4, d / "run")
    ref = _clone(params)
    opt, step = make_train_step(cfg, tcfg, model_dtype=torch.float32)
    ref, _, loss = step(ref, opt.init(ref), torch.Generator().manual_seed(7), batch)
    return collect(), ref, float(loss)


def test_train_step_tp_dp_loss(train_run):
    """The dp=2 x tp=2 step's loss is the global batch's (ragged masks on
    both dp ranks), equal on every rank and to one process's."""
    ranks, _, loss = train_run
    assert np.isfinite(loss)
    for r in ranks:
        assert abs(r["loss"] - loss) <= 1e-5 * abs(loss), (r["loss"], loss)


def test_train_step_tp_dp_params(train_run):
    """After the step every rank holds its tp slice of one process's
    updated params (the dp replicas equal), each within a hundredth of the
    step size (lr 1e-3): the shards sum their gradients in another order,
    and Adam's first step divides each gradient by its own magnitude plus
    1e-8, so a gradient near 1e-8 moves its weight by a part of lr that
    its last bits decide."""
    from echo_tts_tpu_torch.parallel.sharding import spec_for

    ranks, ref, _ = train_run

    def walk(got, want, names):
        if isinstance(want, dict):
            for k in want:
                walk(got[k], want[k], names + (k,))
            return
        w = want.detach().numpy()
        spec = spec_for(names, w.ndim)
        if "tp" in spec:
            w = _heads(w, r["tp_rank"], spec.index("tp"), w.shape[spec.index("tp")] // 2)
        assert got.shape == w.shape and np.abs(got - w).max() <= 1e-5, names

    for r in ranks:
        walk(r["params"], ref, ())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt_run(tmp_path_factory):
    from echo_tts_tpu_torch.checkpoints.io import save_pytree
    from echo_tts_tpu_torch.checkpoints.safetensors import save_file
    from echo_tts_tpu_torch.models.dit import init_dit_params

    params = init_dit_params(CFG, torch.bfloat16, "cpu", seed=6)
    d = tmp_path_factory.mktemp("ckpt")
    save_pytree(str(d / "p.npz"), params)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}//{k}" if prefix else k
            walk(v, key) if isinstance(v, dict) else flat.__setitem__(key, v)

    walk(params, "")
    save_file(flat, str(d / "p.safetensors"))
    torch.save({"params": params, "zeros": _zeros(params), "npz": str(d / "p.npz"),
                "safetensors": str(d / "p.safetensors")}, d / "inputs.pt")
    return run_ranks("checkpoint", 2, d / "run")


def _zeros(tree):
    return ({k: _zeros(v) for k, v in tree.items()} if isinstance(tree, dict)
            else torch.zeros_like(tree))


@pytest.mark.parametrize("how", ["dcp", "npz", "safetensors"])
def test_sharded_checkpoint_round_trip(ckpt_run, how):
    """torch.distributed.checkpoint restores each rank's shards bit for bit
    into a zero template; the sharded loads give shard_params' slices."""
    def eq(a, b, names=()):
        if isinstance(b, dict):
            assert set(a) == set(b), names
            for k in b:
                eq(a[k], b[k], names + (k,))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(names))

    for out in ckpt_run:
        eq(out[how], out["mine"])


# ---------------------------------------------------------------------------
# Engine(mesh) and serve --tp 2
# ---------------------------------------------------------------------------


TEXT = "[S1] Two ranks."
HTTP_SC = {"num_steps": 2, "sequence_length": 32}
# random_tts(tiny)'s buckets are text (768,) and speaker (16, 32): the
# overridden request pads its text to 128 and its 20-latent prompt to 24
OVERRIDES = {"text_buckets": (128,), "speaker_buckets": (24,)}


@pytest.fixture(scope="module")
def engine_run(tmp_path_factory):
    from echo_tts_tpu_torch.bench.trace import random_tts
    from echo_tts_tpu_torch.train.lora import LoRAConfig, init_lora, save_lora_checkpoint

    tts = random_tts(torch.device("cpu"), tiny=True)
    gen = torch.Generator().manual_seed(16)
    lc = LoRAConfig(rank=4, alpha=4.0)
    lora = init_lora(gen, tts.dit_params, lc)
    for ab in lora.values():
        ab["b"].normal_(0.0, 0.5, generator=gen)
    d = tmp_path_factory.mktemp("engine")
    save_lora_checkpoint(str(d / "lora.npz"), lora, lc)
    sc = tc.SamplerConfig(**HTTP_SC)
    voice = (0.2 * np.random.default_rng(7).standard_normal((1, 20 * 16))).astype(np.float32)
    torch.save({"sc": sc, "text": TEXT, "lora": str(d / "lora.npz"), "voice": voice,
                "overrides": OVERRIDES}, d / "inputs.pt")
    collect = spawn_ranks("engine", 2, d / "run")
    # the overridden request at tp=1, while the ranks run
    from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline

    one = dataclasses.replace(tts, pipe_cfg=dataclasses.replace(tts.pipe_cfg, **OVERRIDES))
    with torch.no_grad():
        ref = sample_pipeline(one, TEXT, voice, 5, sc=sc, normalize_text=True)[0]
    out = collect()
    out[0]["override_tp1"] = ref
    return out


def test_engine_tp_one_shot_and_lora(engine_run):
    """Engine(mesh) at tp=2, rank 1 following: the one-shot body equals the
    direct tp=2 call's WAV, set_lora gives the merged model's and None the
    base's again."""
    out = engine_run[0]
    assert engine_run[1]["followed"] is True
    assert out["one"] == out["direct"] and out["back"] == out["direct"]
    assert out["lora"] == out["direct_lora"] and out["lora"] != out["direct"]


def test_engine_tp_stream(engine_run):
    out = engine_run[0]
    assert len(out["stream"]) == len(out["direct_stream"]) > 1
    for a, b in zip(out["stream"], out["direct_stream"]):
        np.testing.assert_array_equal(a, b)


def test_engine_tp_micro_batch(engine_run):
    """Two concurrent requests on Engine(mesh, max_batch=2) run as one batch
    whose rows equal the direct tp=2 batch's."""
    out = engine_run[0]
    assert out["batches"] == 1 and out["batch"] == out["direct_batch"]


def test_engine_tp_f7_set_lora_failing_on_one_rank(engine_run):
    """F7 (a): an adapter that rank 1 alone cannot load raises on both
    ranks, naming rank 1's error, and both keep their params bit for bit:
    no rank commits a tree the other lacks."""
    out, follower = engine_run
    assert "set_lora failed on rank 1" in out["f7_lora_error"]
    assert "unreadable on rank 1" in out["f7_lora_error"]
    ops = [op for op, _ in follower["f7_errors"]]
    assert ops[0] == "set_lora" and "unreadable on rank 1" in follower["f7_errors"][0][1]
    for side in (out, follower):
        assert side["f7_digest"][0] == side["f7_digest"][1]
        assert side["f7_lora_path"] is None


def test_engine_tp_f7_one_shot_failing_on_one_rank(engine_run):
    """F7 (b): a request whose call fails on rank 1 alone, after its
    collectives, raises on both ranks; generate's retry runs on ranks in
    step and gives the direct tp=2 call's bytes."""
    out, follower = engine_run
    assert [op for op, _ in follower["f7_errors"]] == ["set_lora", "pipeline"]
    assert "injected failure" in follower["f7_errors"][1][1]
    assert out["f7_retry"] == out["direct"]
    h = out["f7_health"]
    assert h["retries"] == 1 and h["requests"] == 1 and h["failures"] == 0


def test_engine_tp_pipe_overrides_match_tp1(engine_run):
    """A request with text- and speaker-bucket overrides: the descriptor
    carries them and each rank applies them to its own container; the
    audio equals tp=1's within the suite's tp tolerance."""
    out = engine_run[0]
    got, ref = out["override"], out["override_tp1"]
    assert got.shape == ref.shape and got.shape[-1] > 0
    assert rel_l2(got, ref) <= 1e-5


def test_engine_tp_warmup_background(engine_run):
    """warmup(background_tail=True) on a tp=2 engine: the tail's calls go
    out as descriptors on their thread, health() shows the tail running
    and then done, and the engine goes on serving."""
    out = engine_run[0]
    assert out["warmup_s"] > 0 and out["tail_running"] is True
    assert out["tail_after"] is False and out["tail_combos"] == 3


BOUND_S = 5.0  # the collective bound the tests below give initialize_multihost


def _tp1_request(seed=1):
    from echo_tts_tpu_torch.bench.trace import random_tts
    from echo_tts_tpu_torch.pipeline.pipeline import sample_pipeline

    with torch.no_grad():
        return sample_pipeline(random_tts(torch.device("cpu"), tiny=True), TEXT, None, seed,
                               sc=tc.SamplerConfig(**HTTP_SC), normalize_text=True)[0]


def test_engine_tp_follower_outlives_the_collective_bound(tmp_path):
    """F9: rank 1 of a tp=2 engine waits in follow() for twice the world
    group's timeout while rank 0 is idle, then serves a request whose audio
    equals the tp=1 call's (the suite's tp tolerance), with nothing in
    follow_errors, and close() stops both ranks. The waits of the control
    group are not the world's: under gloo the control group was the world
    group, and this follower left after BOUND_S. Every other group carries
    the bound."""
    torch.save({"sc": tc.SamplerConfig(**HTTP_SC), "text": TEXT}, tmp_path / "inputs.pt")
    collect = spawn_ranks("idle", 2, tmp_path / "run", timeout=120, bound_s=BOUND_S)
    ref = _tp1_request()
    lead, follower = collect()
    assert follower["followed_s"] > 2 * BOUND_S and follower["follow_errors"] == []
    assert lead["audio"].shape == ref.shape and rel_l2(lead["audio"], ref) <= 1e-5
    for side in (lead, follower):
        assert side["timeouts"] == {"world": BOUND_S, "dp": BOUND_S, "tp": BOUND_S,
                                    "status": BOUND_S,
                                    "control": tmesh.CONTROL_TIMEOUT.total_seconds()}


@pytest.mark.parametrize("how", ["exit", "hang"])
def test_engine_tp_dead_rank_raises_within_the_bound(tmp_path, how):
    """Rank 1 leaves (os._exit(1)) or stops answering at the start of its
    part of a pipeline call: rank 0's generate raises a RuntimeError within
    a few times the collective bound (its all-reduce, then the status
    exchange, each wait at most BOUND_S), without a retry; the next
    generate is refused at once, naming the lost tp group; health() says
    so and close() returns."""
    torch.save({"sc": tc.SamplerConfig(**HTTP_SC), "text": TEXT}, tmp_path / "inputs.pt")
    lead, _ = spawn_ranks("dead", 2, tmp_path / "run", timeout=120,
                          exits={1: 1 if how == "exit" else 0}, bound_s=BOUND_S, how=how)()
    assert "the tp group is lost" in lead["first"], lead["first"]
    assert lead["first_s"] <= 4 * BOUND_S
    assert "the tp group is lost" in lead["next"] and lead["next_s"] <= 1.0
    h = lead["health"]
    assert h["status"] == "lost" and h["failures"] == 2 and h["retries"] == 2
    assert lead["close_s"] <= 1.0


def test_initialize_multihost_bounds(tmp_path):
    """The defaults are jax.distributed.initialize's (initialization_timeout
    300 s, heartbeat_timeout_seconds 100 s); a rendezvous that a rank never
    joins fails after init_timeout, and leaves no process group."""
    import datetime
    import inspect

    import torch.distributed as dist

    sig = inspect.signature(tmesh.initialize_multihost).parameters
    assert sig["init_timeout"].default == tmesh.INIT_TIMEOUT == datetime.timedelta(seconds=300)
    assert sig["timeout"].default == tmesh.COLLECTIVE_TIMEOUT == datetime.timedelta(seconds=100)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        tmesh.initialize_multihost("file://" + str(tmp_path / "store"), 2, 0, backend="gloo",
                                   init_timeout=datetime.timedelta(seconds=2))
    assert 1.5 <= time.monotonic() - t0 <= 30 and not dist.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_tp2(flags, path, body):
    """Start `python -m echo_tts_tpu_torch.serve --cpu --random-tiny --tp 2
    <flags>`, POST `body` to `path` once it is up, stop it; the response's
    body. Leaves no process behind."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    proc = subprocess.Popen([sys.executable, "-m", "echo_tts_tpu_torch.serve", "--cpu",
                             "--random-tiny", "--tp", "2", "--port", str(port), *flags],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        deadline = time.monotonic() + 240
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2):
                    break
            except OSError:
                assert time.monotonic() < deadline, "the tp server did not come up"
                time.sleep(0.5)
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=240) as r:
            return r.read()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait(timeout=10)
        assert proc.returncode is not None


def test_serve_tp2_cpu_matches_the_direct_call(engine_run):
    """`python -m echo_tts_tpu_torch.serve --cpu --random-tiny --tp 2`
    starts its follower, serves /tts with the direct tp=2 call's body, and
    leaves no process behind."""
    body = _serve_tp2([], "/tts", {"text": TEXT, "seed": 1, **HTTP_SC})
    assert body == engine_run[0]["direct"]


def test_serve_tp2_continuous_cpu_matches_the_direct_engine(engine_run):
    """`serve --cpu --random-tiny --tp 2 --max-batch 2 --continuous`: the
    follower runs the continuous group's calls, and /tts_stream sends the
    PCM16 of the chunks that the same request gets from a tp=2 continuous
    Engine called directly."""
    from echo_tts_tpu_torch.serve.server import pcm16_bytes

    body = _serve_tp2(["--max-batch", "2", "--continuous"], "/tts_stream",
                      {"text": TEXT, "seed": 3, "block_size": [8, 8], **HTTP_SC})
    chunks = engine_run[0]["continuous_stream"]
    assert len(chunks) > 1 and body == b"".join(pcm16_bytes(c) for c in chunks)


# ---------------------------------------------------------------------------
# no group needed
# ---------------------------------------------------------------------------


def test_param_pspecs_of_int8_leaves(weights):
    """int8 leaves shard by the weight's name in the port's (L, N, K)
    layout: column-sharded q on N with s following, row-sharded q on K with
    s whole; plain weights and head norms as JAX's specs say."""
    _, tp = weights
    specs = tsh.param_pspecs(tquant.quantize_dit_params(tp, encoders=True))
    a, m = specs["blocks"]["attention"], specs["blocks"]["mlp"]
    assert a["wq"] == {"q": (None, "tp", None), "s": (None, "tp")}
    assert a["wk_text"] == {"q": (None, "tp", None), "s": (None, "tp")}
    assert m["w2"] == {"q": (None, None, "tp"), "s": ()}
    assert a["wo"] == {"q": (None, None, "tp"), "s": ()}
    assert a["q_norm"] == (None, "tp", None)
    plain = tsh.param_pspecs(tp)
    assert plain["blocks"]["attention"]["wq"] == (None, None, "tp")
    assert plain["blocks"]["mlp"]["w2"] == (None, "tp", None)
    assert plain["text_encoder"]["blocks"]["attention"]["k_norm"] == (None, "tp", None)
    assert plain["blocks"]["attention_adaln"]["shift_down"] == ()
    assert plain["out_proj"]["w"] == ()


def test_shard_params_refuses_heads_that_do_not_divide(weights):
    _, tp = weights
    mesh3 = tmesh.Mesh(tc.MeshConfig(dp=1, tp=3), torch.device("cpu"), tp_rank=0)
    with pytest.raises(ValueError, match="does not divide"):
        tsh.shard_params(tp, mesh3)
    one = tmesh.make_mesh(tc.MeshConfig(), "cpu")
    try:
        assert tsh.shard_params(tp, one) is not tp
        assert tsh.shard_params(tp, one)["blocks"]["attention"]["wq"] is tp["blocks"][
            "attention"]["wq"]
    finally:
        tmesh.destroy()


def test_mesh_configs_and_backend_rules():
    assert tmesh.auto_mesh_config(8) == tc.MeshConfig(dp=4, tp=2)
    assert tmesh.auto_mesh_config(3) == tc.MeshConfig(dp=3, tp=1)
    assert tmesh.auto_mesh_config(1).num_devices == 1
    assert tmesh.default_backend(torch.device("cpu")) == "gloo"
    assert tmesh.default_backend(torch.device("cuda", 0)) == "nccl"
    tmesh.initialize_multihost()  # one process: nothing to do
    with pytest.raises(RuntimeError, match="process group of 2"):
        tmesh.make_mesh(tc.MeshConfig(dp=1, tp=2), "cpu")
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        tmesh.initialize_multihost("tcp://localhost:1", 2, 0, backend="nccl", device="cpu")


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one device"):
        tmesh.initialize_multihost("tcp://localhost:1", 2, 0, device="cuda:0")


def test_a_sharded_tree_needs_its_mesh(weights):
    from echo_tts_tpu_torch.parallel.tp import current_mesh

    _, tp = weights
    assert current_mesh() is None
    mesh = tmesh.Mesh(tc.MeshConfig(dp=1, tp=2), torch.device("cpu"), tp_rank=1)
    sp = tsh.shard_params(tp, mesh)
    assert sp["blocks"]["attention"]["q_norm"].shape[1] == 2
    np.testing.assert_array_equal(sp["blocks"]["mlp"]["w2"].numpy(),
                                  tp["blocks"]["mlp"]["w2"][:, 48:].numpy())
    with pytest.raises(RuntimeError, match="needs a registered mesh"):
        tdit.get_kv_cache_text(sp, CFG, torch.zeros((1, 4), dtype=torch.int32),
                               torch.ones((1, 4), dtype=torch.bool))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_rows_modes_match_plain_and_split(dtype):
    """K5's scale-only and codes-at-a-scale modes equal quant_rows_plain
    bit for bit, and the max of the parts' scales is the whole row's, so
    codes at it equal the whole row's codes: a row split in two, and wo's
    and w2's K (2048 and 5888) split as at tp = 2 (1024, 2944) and tp = 4
    (512, 1472), widths the kernel holds in registers."""
    from echo_tts_tpu_torch.ops.quant_rows import at_registers

    for d, parts in ((96, 2), (2048, 2), (5888, 2), (2048, 4), (5888, 4)):
        gen = torch.Generator().manual_seed(d + parts)
        h = (torch.randn((7, d), generator=gen) * 3).to(dtype)
        h[2] = 0
        q, s = quant_rows_plain(h)
        assert torch.equal(quant_rows_scale(h), s)
        assert torch.equal(quant_rows_at(h, s), q)
        pieces = list(h.chunk(parts, dim=1))
        assert at_registers(pieces[0].shape[1], dtype)
        s_max = torch.stack([quant_rows_scale(x) for x in pieces]).amax(0)
        assert torch.equal(s_max, s), (d, parts)
        assert torch.equal(torch.cat([quant_rows_at(x, s_max) for x in pieces], dim=1), q)
