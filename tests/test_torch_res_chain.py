"""Kernel K2's plain version (echo_tts_tpu_torch.ops.res_chain) against the
JAX package's fused Pallas residual chain (interpret mode) and its dispatcher,
with non-zero biases and zero_below as a scalar and per row, fp32 on the CPU,
atol/rtol 2e-5 (the JAX kernel tests' tolerance). The CUDA kernel is held
against the plain version on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from echo_tts_tpu.ops import pallas_conv as jpc
from echo_tts_tpu_torch.ops import res_chain as trc

from torch_parity import assert_close, t


def _units(c, seed):
    rng = np.random.default_rng(seed)

    def f(*shape, lo=None, hi=None, s=1.0):
        if lo is not None:
            return rng.uniform(lo, hi, shape).astype(np.float32)
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return [{"snake1": f(1, c, 1, lo=0.2, hi=1.5), "snake2": f(1, c, 1, lo=0.2, hi=1.5),
             "conv1": {"w": f(c, c, 7, s=0.05), "b": f(c, s=0.1)},
             "conv2": {"w": f(c, c, 1, s=0.05), "b": f(c, s=0.1)}} for _ in range(3)]


def _tree(units, conv):
    return [{k: ({kk: conv(vv) for kk, vv in v.items()} if isinstance(v, dict) else conv(v))
             for k, v in u.items()} for u in units]


@pytest.mark.parametrize("b,tt,c,zero_below", [
    (1, 512, 64, None),
    (2, 300, 32, 80),            # scalar: a stream's carried tail at its start
    (2, 300, 32, [80, 13]),      # per row: rows at different stream positions
])
def test_plain_matches_fused_pallas(b, tt, c, zero_below):
    units = _units(c, seed=c + tt)
    x = np.random.default_rng(9).standard_normal((b, tt, c)).astype(np.float32)
    zb = None if zero_below is None else jnp.asarray(zero_below, jnp.int32)
    ref = jpc.fused_res_chain_cl(jnp.asarray(x), _tree(units, jnp.asarray), (1, 3, 9),
                                 tile_t=256, interpret=True, zero_below=zb)
    got = trc.res_units_cl(t(x), _tree(units, t), (1, 3, 9), zero_below=zero_below)
    assert_close(got, ref, atol=2e-5, rtol=2e-5)
    if zero_below is not None:
        rows = np.broadcast_to(np.asarray(zero_below), (b,))
        for i, n in enumerate(rows):
            assert not got[i, :n].any()


def test_plain_matches_per_unit_dispatch():
    """The JAX dispatcher's per-unit route (forced with a zero weight budget)."""
    units = _units(32, seed=1)
    x = np.random.default_rng(7).standard_normal((1, 320, 32)).astype(np.float32)
    old = jpc._CHAIN_WEIGHT_BYTES
    jpc._CHAIN_WEIGHT_BYTES = 0
    try:
        ref = jpc.res_units_cl(jnp.asarray(x), _tree(units, jnp.asarray), (1, 3, 9),
                               interpret=True, zero_below=jnp.int32(40))
    finally:
        jpc._CHAIN_WEIGHT_BYTES = old
    got = trc.res_units_cl(t(x), _tree(units, t), (1, 3, 9), zero_below=40)
    assert_close(got, ref, atol=2e-5, rtol=2e-5)


def test_chain_ctx_and_sin2():
    assert trc.chain_ctx() == jpc.chain_ctx() == 80
    assert trc.chain_ctx((1, 3), 5) == jpc.chain_ctx((1, 3), 5)
    # round-half-to-even range reduction: r = t/pi lands on .5 exactly
    x = np.concatenate([np.linspace(-40, 40, 4001), np.pi * np.array([0.5, 1.5, -2.5])])
    x = x.astype(np.float32)
    assert_close(trc.sin2_poly(t(x)), jpc._sin2(jnp.asarray(x)), atol=1e-6, rtol=0)
    assert_close(trc.sin2_poly(t(x)), np.sin(x.astype(np.float64)) ** 2, atol=1e-5, rtol=0)



def _tile_matrix(tile):
    """A packed (kc/8, nb, 8) strip tile as the (kc, nb) matrix it holds."""
    s, nb, e = tile.shape
    return tile.permute(0, 2, 1).reshape(s * e, nb)


def _unit_as_kernel_walks(x, ops, c, d, zero_below):
    """One unit from the packed operands, walked as csrc/res_chain.cu walks
    them: each tap's A is the snake1 window moved down j·d rows, B the strip
    tiles pass by pass, tap by tap, k chunk by k chunk; the 1x1 reads the z
    tile by k chunks. fp32 on the bf16-rounded operands."""
    w7p, b7, a1, inv1, a2, inv2, w1p, b1 = ops
    kc, nb, _ = trc.UNIT_TILES[c]
    b, tt, _ = x.shape
    y = (x + inv1 * trc.sin2_poly(a1 * x)).to(torch.bfloat16).float()
    win = torch.nn.functional.pad(y, (0, 0, 6 * d, 0))  # rows t - 6d .. t
    acc = torch.zeros(b, tt, c)
    for p in range(c // nb):
        for j in range(7):
            for k in range(c // kc):
                acc[..., p * nb:(p + 1) * nb] += (
                    win[:, j * d:j * d + tt, k * kc:(k + 1) * kc]
                    @ _tile_matrix(w7p[p, j, k].float()))
    acc = acc + b7
    z = (acc + inv2 * trc.sin2_poly(a2 * acc)).to(torch.bfloat16).float()
    out = torch.zeros(b, tt, c)
    for p in range(c // nb):
        for k in range(c // kc):
            out[..., p * nb:(p + 1) * nb] += (z[..., k * kc:(k + 1) * kc]
                                              @ _tile_matrix(w1p[p, 0, k].float()))
    out = (x + (out + b1)).to(torch.bfloat16).float()
    rows = torch.arange(tt)[None, :, None] < torch.as_tensor(zero_below).reshape(-1, 1, 1)
    return out.masked_fill(rows, 0.0)


@pytest.mark.parametrize("c", sorted(trc.UNIT_TILES))
def test_packed_operands_walked_as_the_kernel_reproduce_plain(c):
    """The wrapper's strip tiles (conv_core.pack_tiles), read back as the
    kernel reads them, give the plain version's unit at every width the
    kernel takes: the packing loses no weight and puts none in the wrong
    place. T no multiple of a tile, B=2, per-row zero_below."""
    th = torch
    gen = th.Generator().manual_seed(c)
    b, tt, d = 2, 37, 3
    units = [{"snake1": 0.2 + th.rand(1, c, 1, generator=gen),
              "snake2": 0.2 + th.rand(1, c, 1, generator=gen),
              "conv1": {"w": th.randn(c, c, 7, generator=gen) / (7 * c) ** 0.5,
                        "b": 0.3 * th.randn(c, generator=gen)},
              "conv2": {"w": th.randn(c, c, 1, generator=gen) / c ** 0.5,
                        "b": 0.3 * th.randn(c, generator=gen)}}]
    units = _tree(units, lambda v: v.to(th.bfloat16).float())
    x = th.randn(b, tt, c, generator=gen).to(th.bfloat16).float()
    ops = trc.unit_operands(units[0], c, "cpu")
    kc, nb, _ = trc.UNIT_TILES[c]
    assert tuple(ops[0].shape) == (c // nb, 7, c // kc, kc // 8, nb, 8)
    assert tuple(ops[6].shape) == (c // nb, 1, c // kc, kc // 8, nb, 8)
    got = _unit_as_kernel_walks(x, ops, c, d, [5, 0])
    # the plain version on bf16 x rounds where the kernel rounds
    ref = trc.res_chain_plain(x.to(th.bfloat16), _tree(units, lambda v: v.to(th.bfloat16)),
                              (d,), zero_below=[5, 0]).float()
    assert_close(got, ref, atol=2e-2, rtol=0)
    assert float((got - ref).abs().gt(1e-6).float().mean()) < 0.01
