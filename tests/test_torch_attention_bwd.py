"""The backward of joint attention in the port (echo_tts_tpu_torch.ops.
joint_attention): `joint_attention_bwd_plain`, the plain version of kernel
K3, against the JAX package's Pallas backward kernel (interpret mode) and
against jax.vjp of its XLA reference math; and `torch.autograd.grad`
through `joint_attention_trainable` against the same. Shapes of
tests/test_pallas_attention.py (G=3, T=12/20, scale 1.5) plus a T=1 segment;
fp32 on the CPU, atol 2e-4 / rtol 1e-3 (the JAX kernel test's tolerance).
Kernel K3 itself is held against the plain version on the card by
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echo_tts_tpu.ops.pallas_attention import (
    _xla_joint_attention_hm,
    joint_attention_grouped_pallas_bwd,
)
from echo_tts_tpu_torch.ops import joint_attention as tja

from torch_parity import assert_close, t

TOL = dict(atol=2e-4, rtol=1e-3)


def _mk(g, b, h, s, d, seg_lens, scales, seed):
    """Head-major q/k_self/v_self/dO, segments with fp32 0/-1e30 biases."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, ks, vs, do = rnd(g, b, h, s, d), rnd(g, b, h, s, d), rnd(g, b, h, s, d), rnd(g, b, h, s, d)
    segs = []
    for i, (tl, sc) in enumerate(zip(seg_lens, scales)):
        keep = rng.random((g, b, tl)) < 0.8
        if tl == 1:
            keep[:] = False  # the no-speaker patch: one fully masked key
        segs.append((rnd(b, h, tl, d), rnd(b, h, tl, d),
                     np.where(keep, 0.0, -1e30).astype(np.float32), sc))
    return q, ks, vs, do, segs


CASES = [
    (3, 2, 2, 16, 32, (12, 20), (1.0, 1.5)),   # test_pallas_attention's shape
    (3, 1, 2, 16, 32, (12, 1), (1.0, 1.5)),    # a T=1 all-masked segment
    (1, 2, 2, 24, 32, (20,), (1.3,)),
]


def _jax_flat(segs):
    flat = []
    for k, v, bias, sc in segs:
        flat += [jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), jnp.float32(sc)]
    return flat


def _torch_segs(segs):
    return [(t(k), t(v), t(bias), sc) for k, v, bias, sc in segs]


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_matches_pallas_and_vjp(case):
    q, ks, vs, do, segs = _mk(*case, seed=len(case[5]) + case[0])
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, ks, vs, do))
    flat = _jax_flat(segs)
    _, vjp = jax.vjp(lambda q_, k_, v_, *fl: _xla_joint_attention_hm(q_, k_, v_, fl),
                     jq, jk, jv, *flat)
    ref = vjp(jdo)
    dq, dks, dvs, dsegs = joint_attention_grouped_pallas_bwd(jq, jk, jv, flat, jdo,
                                                              interpret=True)
    got = tja.joint_attention_bwd_plain(t(q), t(ks), t(vs), _torch_segs(segs), t(do))
    ref_segs = [r for i in range(len(segs)) for r in ref[3 + 4 * i:5 + 4 * i]]
    for g_, pl_, xla_ in zip([*got[:3], *got[3]], [dq, dks, dvs, *dsegs],
                             [*ref[:3], *ref_segs]):
        assert_close(g_, pl_, **TOL)
        assert_close(g_, xla_, **TOL)


@pytest.mark.parametrize("layout", ["hm", "sm"])
def test_trainable_autograd_matches_vjp(layout):
    """torch.autograd.grad through the trainable Function (plain forward,
    plain backward on the CPU) against jax.vjp, in both layouts; biases get
    zero gradients."""
    q, ks, vs, do, segs = _mk(*CASES[0], seed=3)
    flat = _jax_flat(segs)
    out_j, vjp = jax.vjp(lambda q_, k_, v_, *fl: _xla_joint_attention_hm(q_, k_, v_, fl),
                         *(jnp.asarray(x) for x in (q, ks, vs)), *flat)
    ref = vjp(jnp.asarray(do))

    def lay(x):
        return t(x).transpose(2, 3).contiguous() if layout == "sm" else t(x)

    tq, tk, tv = (lay(x).requires_grad_() for x in (q, ks, vs))
    tsegs = [(t(k).requires_grad_(), t(v).requires_grad_(), t(b).requires_grad_(), sc)
             for k, v, b, sc in segs]
    out = tja.joint_attention_trainable(tq, tk, tv, tsegs, layout=layout)
    back = (lambda x: x.transpose(2, 3)) if layout == "sm" else (lambda x: x)
    assert_close(back(out), out_j, atol=1e-5, rtol=1e-4)
    inputs = [tq, tk, tv] + [x for sg in tsegs for x in sg[:3]]
    grads = torch.autograd.grad(out, inputs, grad_outputs=lay(do))
    assert_close(back(grads[0]), ref[0], **TOL)
    assert_close(back(grads[1]), ref[1], **TOL)
    assert_close(back(grads[2]), ref[2], **TOL)
    for i in range(len(segs)):
        assert_close(grads[3 + 3 * i], ref[3 + 4 * i], **TOL)
        assert_close(grads[4 + 3 * i], ref[4 + 4 * i], **TOL)
        assert not grads[5 + 3 * i].any()


def test_trainable_refuses_self_len():
    q = torch.zeros(1, 1, 2, 8, 32)
    with pytest.raises(ValueError, match="inference-only"):
        tja.joint_attention_trainable(q, q, q, [], self_len=torch.tensor([4]))
