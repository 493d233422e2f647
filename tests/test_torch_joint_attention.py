"""Kernel K1's plain version (echo_tts_tpu_torch.ops.joint_attention) against
the JAX package's Pallas kernel (interpret mode) and its XLA einsum path, at
the shapes of tests/test_pallas_attention.py, fp32 on the CPU, atol 1e-5 /
rtol 1e-4 (the JAX kernel tests' tolerance). The CUDA kernel is held against
the plain version on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.ops.pallas_attention import joint_attention_grouped_pallas
from echo_tts_tpu_torch.models import dit as tdit
from echo_tts_tpu_torch.ops import joint_attention as tja

from torch_parity import assert_close, t


def _mk(g, b, s, h, d, seg_lens, seed=0, scales=None):
    """Head-major q/k_self/v_self (G,B,H,S,D), segments (B,H,T,D) + (G,B,T)
    bool masks, as numpy."""
    rng = np.random.default_rng(seed)
    q, ks, vs = (rng.standard_normal((g, b, h, s, d)).astype(np.float32) for _ in range(3))
    segs = []
    for i, tl in enumerate(seg_lens):
        k = rng.standard_normal((b, h, tl, d)).astype(np.float32)
        v = rng.standard_normal((b, h, tl, d)).astype(np.float32)
        m = rng.random((g, b, tl)) < 0.8
        segs.append((k, v, m, None if scales is None else scales[i]))
    return q, ks, vs, segs


def _jax(segs):
    return [(jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
             None if s is None else jnp.float32(s)) for k, v, m, s in segs]


def _torch(segs):
    return [(t(k), t(v), t(m), s) for k, v, m, s in segs]


@pytest.mark.parametrize("shape", [
    (3, 1, 128, 2, 128, (256,)),
    (3, 2, 100, 2, 128, (200, 96)),
    (1, 1, 64, 4, 128, (384, 128, 64)),
    (3, 1, 64, 2, 128, (128, 1)),       # the no-speaker T=1 segment
    (3, 1, 64, 2, 128, (5, 128)),
])
def test_plain_matches_pallas_and_xla(shape):
    g, b, s, h, d, seg_lens = shape
    q, ks, vs, segs = _mk(g, b, s, h, d, seg_lens)
    ref_xla = jdit._joint_attention_grouped(jnp.asarray(q), jnp.asarray(ks),
                                            jnp.asarray(vs), _jax(segs))
    ref_pl = joint_attention_grouped_pallas(jnp.asarray(q), jnp.asarray(ks),
                                            jnp.asarray(vs), _jax(segs), interpret=True)
    got = tja.joint_attention(t(q), t(ks), t(vs), _torch(segs))
    assert_close(got, ref_xla)
    assert_close(got, ref_pl)


def test_seq_major_layout_and_bias_masks():
    """layout="sm" and fp32 additive-bias masks give the head-major answer."""
    q, ks, vs, segs = _mk(3, 1, 64, 2, 128, (96, 40), seed=2, scales=[None, 1.5])
    ref = jdit._joint_attention_grouped(jnp.asarray(q), jnp.asarray(ks),
                                        jnp.asarray(vs), _jax(segs))
    sm = [t(x).transpose(2, 3).contiguous() for x in (q, ks, vs)]
    bias = [(k, v, torch.where(m, 0.0, -1e30), s) for k, v, m, s in _torch(segs)]
    got = tja.joint_attention(*sm, bias, layout="sm")
    assert_close(got.transpose(2, 3), ref)


def test_kv_scale_equals_scaled_kv():
    q, ks, vs, segs = _mk(3, 1, 64, 2, 128, (128, 256), seed=5, scales=[None, 1.5])
    ref = joint_attention_grouped_pallas(jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
                                         _jax(segs), interpret=True)
    got = tja.joint_attention(t(q), t(ks), t(vs), _torch(segs))
    assert_close(got, ref)
    (k1, v1, m1, _), (k2, v2, m2, _) = segs
    manual = [(t(k1), t(v1), t(m1), None), (t(k2) * 1.5, t(v2) * 1.5, t(m2), None)]
    assert_close(got, tja.joint_attention(t(q), t(ks), t(vs), manual).numpy())


def test_branch_split_matches_mask_only():
    """The port's branch split (per-branch launches without the fully
    masked segment) against JAX's mask-only XLA path and its own
    branch-split Pallas dispatch."""
    q, ks, vs, segs = _mk(3, 1, 64, 2, 128, (96, 160), seed=7, scales=[None, 1.3])
    (k1, v1, m1, s1), (k2, v2, m2, s2) = segs
    m1[1] = False
    m2[2] = False
    segs_mask = [(k1, v1, m1, s1), (k2, v2, m2, s2)]
    jq, jk, jv = jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs)
    ref = jdit._joint_attention_grouped(jq, jk, jv, _jax(segs_mask))
    skip_j = [s + (sk,) for s, sk in zip(_jax(segs_mask), ((1,), (2,)))]
    ref_pl = jdit._joint_attention_grouped(jq, jk, jv, skip_j, attn_impl="pallas_interpret")
    skip_t = [s + (sk,) for s, sk in zip(_torch(segs_mask), ((1,), (2,)))]
    got = tdit._joint_attention_grouped(t(q), t(ks), t(vs), skip_t)
    assert_close(got, ref)
    assert_close(got, ref_pl)


def test_self_len_masks_self_keys():
    q, ks, vs, segs = _mk(1, 2, 64, 2, 128, (128,), seed=11)
    sl = np.array([64, 23], np.int32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs)
    ref = jdit._joint_attention_grouped(jq, jk, jv, _jax(segs), self_len=jnp.asarray(sl))
    ref_pl = joint_attention_grouped_pallas(jq, jk, jv, _jax(segs), interpret=True,
                                            self_len=jnp.asarray(sl))
    got = tja.joint_attention(t(q), t(ks), t(vs), _torch(segs), self_len=t(sl))
    assert_close(got, ref)
    assert_close(got, ref_pl)


def test_fully_masked_context_is_finite():
    q, ks, vs, segs = _mk(2, 1, 64, 2, 128, (256,), seed=3)
    k, v, _, _ = segs[0]
    segs = [(k, v, np.zeros((2, 1, 256), bool), None)]
    ref = jdit._joint_attention_grouped(jnp.asarray(q), jnp.asarray(ks),
                                        jnp.asarray(vs), _jax(segs))
    got = tja.joint_attention(t(q), t(ks), t(vs), _torch(segs))
    assert torch.isfinite(got).all()
    assert_close(got, ref)


def _ragged_case(case):
    """(q, ks, vs, segments, self_len) of one ragged shape the kernel is
    checked at on the card: S no multiple of a 64- or 128-row tile, segment
    lengths no multiples of a 64-key tile, a T=1 all-masked segment, a
    self_len that ends inside a tile."""
    if case == "s200_t700_t1":
        q, ks, vs, segs = _mk(3, 2, 200, 2, 128, (700, 1), seed=21, scales=[None, 1.5])
        k, v, m, s = segs[1]
        return q, ks, vs, [segs[0], (k, v, np.zeros_like(m), s)], None
    if case == "self_len_inside_a_tile":
        q, ks, vs, segs = _mk(1, 2, 200, 2, 128, (160,), seed=22)
        return q, ks, vs, segs, np.array([200, 77], np.int32)
    if case == "s200_three_segments":
        q, ks, vs, segs = _mk(2, 1, 200, 2, 128, (300, 52, 7), seed=23, scales=[None, 1.5, 0.5])
        return q, ks, vs, segs, None
    raise ValueError(case)


RAGGED_CASES = ("s200_t700_t1", "self_len_inside_a_tile", "s200_three_segments")


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_plain_at_ragged_shapes_matches_pallas_and_xla(case):
    """fp32 on the CPU against the Pallas kernel in interpret mode and the
    XLA einsum path, atol 1e-5 / rtol 1e-4 plus 2e-5 absolute for the longer
    sums of 700 keys."""
    q, ks, vs, segs, sl = _ragged_case(case)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs)
    jsl = None if sl is None else jnp.asarray(sl)
    ref_xla = jdit._joint_attention_grouped(jq, jk, jv, _jax(segs), self_len=jsl)
    ref_pl = joint_attention_grouped_pallas(jq, jk, jv, _jax(segs), interpret=True, self_len=jsl)
    got = tja.joint_attention(t(q), t(ks), t(vs), _torch(segs),
                              self_len=None if sl is None else t(sl))
    assert torch.isfinite(got).all()
    assert_close(got, ref_xla, atol=2e-5)
    assert_close(got, ref_pl, atol=2e-5)


@pytest.mark.parametrize("layout", ["hm", "sm"])
@pytest.mark.parametrize("case", RAGGED_CASES[:2])
def test_out_view_and_sliced_branches_match_the_grouped_call(case, layout):
    """`out=` a view of a larger buffer, and one call per branch on q[i:i+1]
    slices that write into out[i:i+1] (what the branch split passes), give
    the grouped answer and touch nothing else."""
    q, ks, vs, segs, sl = _ragged_case(case)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs)
    ref = jdit._joint_attention_grouped(jq, jk, jv, _jax(segs),
                                        self_len=None if sl is None else jnp.asarray(sl))
    tq, tk, tv = (t(x).transpose(2, 3).contiguous() if layout == "sm" else t(x)
                  for x in (q, ks, vs))
    tsl = None if sl is None else t(sl)
    g = tq.shape[0]
    buf = torch.full((g + 2, *tq.shape[1:]), 7.0)
    out = buf[1:g + 1]
    res = tja.joint_attention(tq, tk, tv, _torch(segs), layout=layout, self_len=tsl, out=out)
    assert res.data_ptr() == out.data_ptr()
    assert (buf[0] == 7.0).all() and (buf[-1] == 7.0).all()
    as_hm = (lambda x: x.transpose(2, 3)) if layout == "sm" else (lambda x: x)
    assert_close(as_hm(out), ref, atol=2e-5)
    split = torch.empty_like(tq)
    for i in range(g):
        tja.joint_attention(tq[i:i + 1], tk[i:i + 1], tv[i:i + 1],
                            [(k, v, m[i:i + 1], s) for k, v, m, s in _torch(segs)],
                            layout=layout, self_len=tsl, out=split[i:i + 1])
    assert_close(as_hm(split), ref, atol=2e-5)
