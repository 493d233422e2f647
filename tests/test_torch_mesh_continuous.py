"""The port's continuous stream scheduler on a tensor-parallel engine
(`Engine(mesh=<tp=2>, continuous=True)`): two gloo ranks on the CPU in one
spawned run (tests/torch_mesh_workers.py:task_continuous, every join
bounded), rank 0 scheduling and rank 1 following each group call, the tiny
config in fp32 on the JAX package's weights (tiny_pair, as
tests/test_torch_serve_continuous.py builds them).

* staggered rows (a live group, the fast join) within atol 2e-5 of the
  direct tp=2 `sample_pipeline_stream` on the sharded weights, and within
  rel-L2 1e-4 of the JAX package's stream at the uniform block (computed
  here while the ranks run);
* first_block_steps through the fast join;
* set_lora under a live group of two rows: the rows stay on the base
  model, a stream after the swap runs the adapter;
* a group step that fails on rank 1 alone: the client gets the error, the
  group is closed on both ranks, the next stream runs;
* close() with a live group: the client ends with an error within about a
  block and rank 1 returns from follow();
* warmup(include_streaming=True) through the group calls;
* a burst grown to four rows in one resize.
"""
import numpy as np
import pytest
import torch

from echo_tts_tpu.core import config as jc
from echo_tts_tpu.pipeline import pipeline as jpipe
from echo_tts_tpu_torch.core import config as tc

from torch_mesh_workers import spawn_ranks
from torch_parity import rel_l2, tiny_pair

PIPE = dict(text_buckets=(768,), speaker_buckets=(32, 64), audio_chunk_latents=32,
            max_speaker_latent_length=64)
SAMPLER = dict(num_steps=2, sequence_length=16, truncation_factor=0.8)
LIVE_LEN = 32  # the set_lora rows: 8 blocks of 4
STAGGERED = {50: "Continuous row A.", 51: "Continuous row B, joining later."}
CASES = {
    "staggered": (STAGGERED, "sc", 4),
    "fb": ({9: "First block steps."}, "fb", 8),
    "live": ({11: "Live during swap.", 12: "The second live row."}, "live", 4),
    "after_lora": ({13: "After the swap."}, "sc", 4),
    "after_base": ({13: "After the swap."}, "sc", 4),
    "after_fail": ({14: "After a failure."}, "sc", 4),
    "burst": ({**STAGGERED, 52: "A third one in the burst."}, "sc", 4),
}
ATOL = 2e-5


@pytest.fixture(scope="module")
def cont_run(tmp_path_factory):
    from echo_tts_tpu_torch.train.lora import LoRAConfig, init_lora, save_lora_checkpoint

    jtts, ttts = tiny_pair(41, 42, PIPE)
    gen = torch.Generator().manual_seed(16)
    lc = LoRAConfig(rank=4, alpha=4.0)
    lora = init_lora(gen, ttts.dit_params, lc)
    for ab in lora.values():
        ab["b"].normal_(0.0, 0.5, generator=gen)
    d = tmp_path_factory.mktemp("continuous")
    save_lora_checkpoint(str(d / "lora.npz"), lora, lc)
    torch.save({"tts": ttts, "sc": tc.SamplerConfig(**SAMPLER), "cases": CASES,
                "live_len": LIVE_LEN, "lora": str(d / "lora.npz")}, d / "inputs.pt")
    collect = spawn_ranks("continuous", 2, d / "run")
    jsc = jc.SamplerConfig(**SAMPLER)
    jax_rows = {seed: np.concatenate([np.asarray(c) for c in jpipe.sample_pipeline_stream(
        jtts, text, None, seed, sc=jsc, block_size=4, normalize_text=True)], axis=-1)
        for seed, text in STAGGERED.items()}
    ranks = collect()
    return ranks[0], ranks[1], jax_rows


def _close_to_direct(out, name, got=None):
    got = out[name] if got is None else got
    ref = out["direct"][name]
    assert sorted(got) == sorted(ref)
    for seed in ref:
        assert got[seed].shape == ref[seed].shape and got[seed].shape[-1] > 0, (name, seed)
        np.testing.assert_allclose(got[seed], ref[seed], atol=ATOL, rtol=0, err_msg=f"{seed}")


def test_tp2_continuous_rows_match_direct_and_jax(cont_run):
    """Staggered streams on Engine(mesh, max_batch=2, continuous=True): the
    second joins the live group; each row equals the direct tp=2 solo
    stream and the JAX package's stream of its seed."""
    out, _, jax_rows = cont_run
    _close_to_direct(out, "staggered")
    for seed, row in out["staggered"].items():
        assert row.shape == jax_rows[seed].shape
        assert rel_l2(row, jax_rows[seed]) <= 1e-4, seed
    h = out["staggered_health"]
    assert h["requests"] == 2 and h["failures"] == 0 and h["batches"] >= 1


def test_tp2_continuous_first_block_steps(cont_run):
    """first_block_steps reaches the followers with the fast join: the row
    equals the direct tp=2 stream with the same knob."""
    out, _, _ = cont_run
    _close_to_direct(out, "fb")


def test_tp2_set_lora_under_a_live_group_of_two(cont_run):
    """set_lora while a group of two rows is live returns before the group
    ends; both rows finish on the base model (every rank keeps the params
    it took when the group opened), and a stream after the swap runs the
    adapter."""
    out, _, _ = cont_run
    assert out["alive_after_swap"] and out["rows_at_swap"] == 2
    _close_to_direct(out, "live")
    _close_to_direct(out, "after_lora")
    got, base = out["after_lora"][13], out["direct"]["after_base"][13]
    n = min(got.shape[-1], base.shape[-1])
    assert not np.allclose(got[..., :n], base[..., :n])
    assert out["groups_left"] == 0


def test_tp2_a_step_that_fails_on_one_rank(cont_run):
    """A group step that fails on rank 1 alone (after its all-reduces)
    raises on rank 0 too, naming rank 1: the client gets the error, the
    group is closed on every rank, and the next stream is right."""
    out, _, _ = cont_run
    assert out["failed"] is not None and "rank 1" in out["failed"]
    assert "injected failure" in out["failed"]
    assert out["groups_after_fail"] == 0
    _close_to_direct(out, "after_fail")


def test_tp2_close_with_a_live_group(cont_run):
    """close() with a live group: the client ends with "engine closed"
    before its last block, no group is left on rank 0, and rank 1 returns
    from follow() with none left either."""
    out, follower, _ = cont_run
    c = out["close"]
    assert c["end"] == "error: engine closed" and c["chunks"] < c["blocks"]
    assert c["groups_left"] == 0
    assert follower == {"followed": [0, 0, 0]}


def test_tp2_warmup_continuous(cont_run):
    """warmup(include_streaming=True) runs the continuous shapes through
    the group calls on both ranks: a join and a step at 1, 2 and 4 rows
    for each of three prompt shapes (no speaker, two speaker buckets)."""
    out, _, _ = cont_run
    assert out["warmup_s"] > 0
    # 3 one-shot requests, 3 x 3 group shapes, batches of 2 and 4
    assert out["warmup_combos"] == 3 + 9 + 2
    assert out["warmup_resizes"] == [(1, 2), (2, 4)] * 3


def test_tp2_burst_grows_in_one_resize(cont_run):
    """Three arrivals at an idle group on Engine(mesh, max_batch=4): one
    boundary admits them all through one resize 1 -> 4, and each row
    equals the direct stream."""
    out, _, _ = cont_run
    assert out["burst_sched"] == (3, 4)
    assert [(a, b) for a, b in out["burst_resizes"] if b > a] == [(1, 4)]
    _close_to_direct(out, "burst")
