"""Kernels K6, K7 and K8 (`ops/trunk_rows.py`): the DiT trunk layer's
elementwise islands fused, and the rule that picks them.

On the card (the `cuda` marker; each skips without one): each kernel against
its plain chain at the trunk's shapes (D = 2048, H = 16 x 128, SwiGLU's
5888), within one bf16 ulp on every element and bit for bit on at least 99 %
of them (the sum of squares is taken in another order, nothing else
differs); K7 with per-row tables and at tp head offsets; a whole CFG forward
fused against plain; the wrappers refusing what the kernels do not take.

On the CPU: the rule (a forward under autograd, on the CPU or in fp32 takes
the plain chain, and the counters say so), and each kernel's arithmetic,
written out here step by step with its rounding points (`*_emulated`),
against the unfused functions of `core/layers.py` and `core/rope.py`.

The file imports no JAX, so it runs on a card's machine without it:

    python -m pytest tests/test_torch_trunk_rows.py --noconftest -q
"""
import types

import pytest
import torch
import torch.nn.functional as F

from echo_tts_tpu_torch.core import layers as tl
from echo_tts_tpu_torch.core import rope as trope
from echo_tts_tpu_torch.core.config import DiTConfig
from echo_tts_tpu_torch.models import dit as tdit
from echo_tts_tpu_torch.ops import trunk_rows as tr
from echo_tts_tpu_torch.utils import profiling

from torch_parity import cuda_device  # noqa: F401

EPS = 1e-5
BF = torch.bfloat16


def ulps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The distance of two bf16 tensors in units in the last place."""
    def ordered(x):
        b = x.contiguous().view(torch.int16).int()
        return torch.where(b < 0, -(b & 0x7FFF), b)

    return (ordered(got) - ordered(ref)).abs()


def _ulp(m: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each magnitude of m (fp32)."""
    _, e = torch.frexp(m.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(m, dtype=torch.float32), e - 8)


def assert_bf16_close(got: torch.Tensor, ref: torch.Tensor, terms=None,
                      share: float = 0.99) -> None:
    """Bit for bit on at least `share` of the elements; everywhere within
    one ulp of the result, plus one ulp of `terms`, the magnitude of the
    terms of the chain's last fp32 sum where one is given (modulation's
    shift, RoPE's rotation): where that sum cancels, the last bit of the norm's
    scale, the one number the kernels sum in another order, moves the result
    by more than one of its own ulps."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == BF
    tol = _ulp(ref) if terms is None else _ulp(ref) + _ulp(terms)
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= tol).all()), f"{int(ulps(got, ref).max())} ulps"
    assert float((diff == 0).float().mean()) >= share, float((diff == 0).float().mean())


def modulation_terms(x, scale):
    """|x / rms(x) * (1 + scale)| in fp32: the product the shift is added to."""
    xf = x.float()
    return (xf * _rms(xf) * (scale.float() + 1.0)).abs()


def rotation_terms(normed: torch.Tensor) -> torch.Tensor:
    """Each lane pair's norm, on both lanes: the size of RoPE's terms."""
    n = normed.float().unflatten(-1, (-1, 2))
    return torch.linalg.vector_norm(n, dim=-1, keepdim=True).expand(n.shape).flatten(-2)


def _rnd(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF).float()


# ---------------------------------------------------------------------------
# Each kernel's arithmetic, one pass, its rounding points written out
# ---------------------------------------------------------------------------


def _rms(xf: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt((xf * xf).sum(-1, keepdim=True) / xf.shape[-1] + EPS)


def k6_emulated(x, y, gate, mul, add):
    xf = x.float()
    if y is not None:
        xf = _rnd(xf + _rnd(gate.float() * y.float()))
    n = xf * _rms(xf)
    h = n * (mul.float() + 1.0) + add.float() if add is not None else n * mul.float()
    return xf.to(BF), h.to(BF)


def k7_emulated(t, w, cos, sin, n_rot):
    n = _rnd(t.float() * _rms(t.float()) * w.float())
    xr, xi = n[..., :n_rot, 0::2], n[..., :n_rot, 1::2]
    c, s = (cos[:, None], sin[:, None]) if cos.dim() == 2 else (cos[:, :, None], sin[:, :, None])
    n[..., :n_rot, 0::2], n[..., :n_rot, 1::2] = xr * c - xi * s, xr * s + xi * c
    return n.to(BF)


def k8_emulated(a, b, act):
    """(the product, the size of its terms); the activation in float64, as
    the CPU's own exp differs in the last bit between its vector and scalar
    paths (which one an element takes moves with the tensor's alignment)."""
    af, bf = a.float(), b.float()
    if act == "sigmoid":
        g = _rnd(1.0 / (1.0 + torch.exp(-b.double())))
        return (af * g).to(BF), (af * g).abs()
    g = _rnd(a.double() / (1.0 + torch.exp(-a.double())))
    return (g * bf).to(BF), (g * bf).abs()


def _inputs(gen, dev, g, b, s, d):
    def n(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(BF)

    return dict(x=n(g, b, s, d, scale=2.0), y=n(g, b, s, d), gate=torch.tanh(n(b, 1, d)),
                shift=n(b, 1, d, scale=0.5), scale=n(b, 1, d, scale=0.5),
                w=(1 + 0.2 * torch.randn(d, generator=gen, device=dev)).to(BF))


def _heads(gen, dev, g, b, s, h, rows):
    q = (torch.randn(g, b, s, h, 128, generator=gen, device=dev) * 3).to(BF)
    k = torch.randn(g, b, s, h, 128, generator=gen, device=dev).to(BF)
    qw, kw = ((1 + 0.3 * torch.randn(h, 128, generator=gen, device=dev)).to(BF) for _ in "qk")
    cos, sin = trope.precompute_rope(128, 1024, device=dev)
    if rows:
        idx = torch.tensor([0, 64, 256, 448, 17, 5, 900, 300][:b], device=dev)[:, None]
        cos, sin = trope.rope_rows(cos, sin, idx + torch.arange(s, device=dev))
    else:
        cos, sin = cos[100:100 + s], sin[100:100 + s]
    return q, k, qw, kw, cos, sin


# ---------------------------------------------------------------------------
# CPU: the kernels' arithmetic against the unfused functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["first", "residual", "norm"])
def test_k6_arithmetic_and_plain_chain_match_the_unfused_functions(case):
    gen = torch.Generator().manual_seed(1)
    i = _inputs(gen, "cpu", 2, 3, 40, 256)
    y, gate = (None, None) if case == "first" else (i["y"], i["gate"])
    ref_x = i["x"] if y is None else i["x"] + gate * y
    if case == "norm":
        ref_h = tl.rms_norm(ref_x, i["w"], EPS)
        got_h = tr.residual_norm_plain(i["x"], y, gate, i["w"], EPS)
        em_x, em_h = k6_emulated(i["x"], y, gate, i["w"], None)
    else:
        ref_h = tl.modulate_rms(ref_x, i["shift"], i["scale"], EPS)
        got_x, got_h = tr.residual_modulate_plain(i["x"], y, gate, i["shift"], i["scale"], EPS)
        assert torch.equal(got_x, ref_x)
        em_x, em_h = k6_emulated(i["x"], y, gate, i["scale"], i["shift"])
    assert torch.equal(got_h, ref_h)
    assert torch.equal(em_x, ref_x)
    assert_bf16_close(em_h, ref_h, None if case == "norm" else modulation_terms(ref_x, i["scale"]))


@pytest.mark.parametrize("rows,heads,offset", [(False, 16, 0), (True, 16, 0), (False, 8, 0),
                                               (True, 8, 8)])
def test_k7_arithmetic_and_plain_chain_match_the_unfused_functions(rows, heads, offset):
    """16 heads (8 rotated), or a tp rank's 8 of 16 at offset 0 (all
    rotated) and 8 (none); tables shared or one a row."""
    gen = torch.Generator().manual_seed(2)
    q, k, qw, kw, cos, sin = _heads(gen, "cpu", 2, 3, 24, heads, rows)
    got = tr.qk_norm_rope_plain(q, k, qw, kw, cos, sin, offset, 16, EPS)
    n_rot = tr._n_rot(heads, offset, 16)
    assert n_rot == {(16, 0): 8, (8, 0): 8, (8, 8): 0}[heads, offset]
    for t, w, g in zip((q, k), (qw, kw), got):
        ref = trope.apply_rope_half_heads(tl.rms_norm(t, w, EPS), cos, sin, offset, 16)
        assert torch.equal(g, ref)
        assert_bf16_close(k7_emulated(t, w, cos, sin, n_rot), ref,
                          rotation_terms(tl.rms_norm(t, w, EPS)))


@pytest.mark.parametrize("act", ["sigmoid", "silu"])
def test_k8_arithmetic_and_plain_chain_match_the_unfused_functions(act):
    gen = torch.Generator().manual_seed(3)
    a = (torch.randn(7, 5888, generator=gen) * 4).to(BF)
    b = torch.randn(7, 5888, generator=gen).to(BF)
    ref = a * torch.sigmoid(b) if act == "sigmoid" else F.silu(a) * b
    got = (tr.sigmoid_gate_plain if act == "sigmoid" else tr.swiglu_plain)(a, b)
    assert torch.equal(got, ref)
    em, terms = k8_emulated(a, b, act)
    assert_bf16_close(em, ref, terms)


# ---------------------------------------------------------------------------
# CPU: the backward formulas against autograd of the plain chains
# ---------------------------------------------------------------------------

K6_CASES = ["first", "residual", "residual, no later use", "norm"]


def rms_bwd_terms(xf: torch.Tensor, dn: torch.Tensor) -> torch.Tensor:
    """The size of the terms of the RMS-norm backward's last fp32 sum,
    |dn r| + |(dv / D) 2 x|, with the row's sum of dn x taken over
    magnitudes: that sum is the one the kernels take in another order, and
    where the last sum cancels its last bits move the result by more than
    one of its own ulps."""
    xf, dn = xf.float(), dn.float()
    r = _rms(xf)
    return (dn * r).abs() + (dn * xf).abs().sum(-1, keepdim=True) * r.pow(3) * xf.abs() \
        / xf.shape[-1]


def k6_grads(i, case, dh, dxi, bwd=None, ops=None):
    """(dx, dy) of K6's chain by autograd through `ops`' islands (PLAIN: the
    plain chain), or by `bwd`, called as `residual_modulate_bwd_plain`; dy
    None for the first case (no residual)."""
    first, norm = case == "first", case == "norm"
    gate, mul = (None if first else i["gate"]), (i["w"] if norm else i["scale"])
    if bwd is not None:
        xo = i["x"] if first else i["x"] + gate * i["y"]
        return bwd(xo, dh, dxi, gate, mul, not norm, EPS)
    ops = ops or tr.PLAIN
    x = i["x"].clone().requires_grad_(True)
    y = i["y"].clone().requires_grad_(True)
    if norm:
        xo, h = None, ops.residual_norm(x, y, gate, mul, EPS)
    else:
        xo, h = ops.residual_modulate(x, None if first else y, gate, i["shift"], mul, EPS)
    outs, grads = ([h, xo], [dh, dxi]) if dxi is not None else ([h], [dh])
    got = torch.autograd.grad(outs, [x] if first else [x, y], grads)
    return got[0], (None if first else got[1])


def k6_case(gen, dev, dtype, case, g=1, b=3, s=40, d=256):
    i = {k: v.to(dtype) for k, v in _inputs(gen, dev, g, b, s, d).items()}
    dh = torch.randn(g, b, s, d, generator=gen, device=dev).to(dtype)
    dxi = None if case in ("residual, no later use", "norm") else \
        torch.randn(g, b, s, d, generator=gen, device=dev).to(dtype)
    return i, dh, dxi


def k7_case(gen, dev, dtype, rows, heads, g=1, b=3, s=24):
    q, k, qw, kw, cos, sin = _heads(gen, dev, g, b, s, heads, rows)
    dq, dk = (torch.randn(q.shape, generator=gen, device=dev).to(dtype) for _ in "qk")
    return [t.to(dtype) for t in (q, k, qw, kw)] + [cos, sin, dq, dk]


def k7_grads(q, k, qw, kw, cos, sin, dq, dk, offset, ops=None):
    qq, kk = q.clone().requires_grad_(True), k.clone().requires_grad_(True)
    outs = (ops or tr.PLAIN).qk_norm_rope(qq, kk, qw, kw, cos, sin, offset, 16, EPS)
    return torch.autograd.grad(outs, [qq, kk], [dq, dk])


def k7_terms(t, g, w, cos, sin, n_rot):
    """`rms_bwd_terms` of one of K7's inputs: the gradient rotated back and
    rounded as the chain rounds it, times the weight."""
    gf = g.float()
    if n_rot:
        c, s_ = tr._tables(cos.float(), sin.float())
        gr, gi = gf[..., :n_rot, 0::2], gf[..., :n_rot, 1::2]
        rot = torch.stack([gr * c + gi * s_, gi * c - gr * s_], dim=-1).flatten(-2)
        gf = torch.cat([rot.to(BF).float(), gf[..., n_rot:, :]], dim=-2)
    return rms_bwd_terms(t.float(), gf * w.float())


def k8_case(gen, dev, dtype, m=7, n=5888):
    a = (torch.randn(m, n, generator=gen, device=dev) * 4).to(dtype)
    b = torch.randn(m, n, generator=gen, device=dev).to(dtype)
    do = torch.randn(m, n, generator=gen, device=dev).to(dtype)
    return a, b, do


def k8_grads(a, b, do, act, ops=None):
    aa, bb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    ops = ops or tr.PLAIN
    out = (ops.sigmoid_gate if act == "sigmoid" else ops.swiglu)(aa, bb)
    return torch.autograd.grad(out, [aa, bb], do)


F64 = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture
def chain_in_float64(monkeypatch):
    """The plain chains cast to fp32 (`x.float()`) for their islands; here a
    float64 tensor stays float64, so autograd runs the chain in float64."""
    to_float = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda t: t if t.dtype == torch.float64 else to_float(t))


@pytest.mark.parametrize("case", K6_CASES)
def test_k6_backward_formula_equals_autograd_of_the_chain_in_float64(case, chain_in_float64):
    gen = torch.Generator().manual_seed(11)
    i, dh, dxi = k6_case(gen, "cpu", torch.float64, case)
    ref = k6_grads(i, case, dh, dxi)
    got = k6_grads(i, case, dh, dxi, tr.residual_modulate_bwd_plain)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            torch.testing.assert_close(g, r, **F64)


@pytest.mark.parametrize("rows,heads,offset", [(False, 16, 0), (True, 16, 0), (False, 8, 8),
                                               (True, 12, 2)])
def test_k7_backward_formula_equals_autograd_of_the_chain_in_float64(rows, heads, offset,
                                                                    chain_in_float64):
    gen = torch.Generator().manual_seed(12)
    q, k, qw, kw, cos, sin, dq, dk = k7_case(gen, "cpu", torch.float64, rows, heads)
    ref = k7_grads(q, k, qw, kw, cos.double(), sin.double(), dq, dk, offset)
    got = tr.qk_norm_rope_bwd_plain(q, k, dq, dk, qw, kw, cos.double(), sin.double(), offset, 16,
                                    EPS)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **F64)


@pytest.mark.parametrize("act", ["sigmoid", "silu"])
def test_k8_backward_formula_equals_autograd_of_the_chain_in_float64(act, chain_in_float64):
    a, b, do = k8_case(torch.Generator().manual_seed(13), "cpu", torch.float64)
    ref = k8_grads(a, b, do, act)
    got = (tr.sigmoid_gate_bwd_plain if act == "sigmoid" else tr.swiglu_bwd_plain)(a, b, do)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **F64)


@pytest.mark.parametrize("case", K6_CASES)
def test_k6_backward_formula_keeps_the_chains_rounding_points(case):
    """In bf16: the formula against autograd of the chain, within one ulp
    of the result plus one of the terms of the norm backward's last sum
    (dy: plus those of dx' carried through the gate's product)."""
    gen = torch.Generator().manual_seed(14)
    i, dh, dxi = k6_case(gen, "cpu", BF, case)
    ref = k6_grads(i, case, dh, dxi)
    got = k6_grads(i, case, dh, dxi, tr.residual_modulate_bwd_plain)
    assert_k6_grads(i, case, dh, got, ref)


def assert_k6_grads(i, case, dh, got, ref):
    xo = i["x"] if case == "first" else i["x"] + i["gate"] * i["y"]
    mul = i["w"].float() if case == "norm" else i["scale"].float() + 1.0
    terms = rms_bwd_terms(xo, dh.float() * mul)
    assert_bf16_close(got[0], ref[0], terms, share=0.98)
    if case != "first":
        carried = 2 * i["gate"].float().abs() * (terms + ref[0].float().abs())
        assert_bf16_close(got[1], ref[1], carried, share=0.98)


@pytest.mark.parametrize("rows,heads,offset", [(False, 16, 0), (True, 8, 0)])
def test_k7_backward_formula_keeps_the_chains_rounding_points(rows, heads, offset):
    gen = torch.Generator().manual_seed(15)
    q, k, qw, kw, cos, sin, dq, dk = k7_case(gen, "cpu", BF, rows, heads)
    ref = k7_grads(q, k, qw, kw, cos, sin, dq, dk, offset)
    got = tr.qk_norm_rope_bwd_plain(q, k, dq, dk, qw, kw, cos, sin, offset, 16, EPS)
    n_rot = tr._n_rot(heads, offset, 16)
    for t, g, w, gt, r in zip((q, k), (dq, dk), (qw, kw), got, ref):
        assert_bf16_close(gt, r, k7_terms(t, g, w, cos, sin, n_rot), share=0.98)


@pytest.mark.parametrize("act", ["sigmoid", "silu"])
def test_k8_backward_formula_keeps_the_chains_rounding_points(act):
    """Bit for bit but where the CPU's exp differs in its last bit between
    its vector and scalar paths (see `k8_emulated`): within one ulp. The
    sigmoid's db follows the card, whose sigmoid_backward rounds 1 - s and
    each product to bf16, where the CPU's keeps them in fp32: within two
    ulps of the CPU's there (the test on the card holds it to one)."""
    a, b, do = k8_case(torch.Generator().manual_seed(16), "cpu", BF)
    ref = k8_grads(a, b, do, act)
    got = (tr.sigmoid_gate_bwd_plain if act == "sigmoid" else tr.swiglu_bwd_plain)(a, b, do)
    for which, g, r in zip("ab", got, ref):
        if act == "sigmoid" and which == "b":
            assert_bf16_close(g, r, terms=r.float().abs(), share=0.5)
        else:
            assert_bf16_close(g, r, share=0.999)


# ---------------------------------------------------------------------------
# CPU: the rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("is_cuda,dtype,grad,width,head_dim,frozen,ops", [
    (True, BF, False, 2048, 128, "frozen", "FUSED"),
    (True, BF, True, 2048, 128, "frozen", "TRAINABLE"),  # autograd: LoRA training
    (True, BF, True, 2048, 128, "none", "TRAINABLE"),
    (True, BF, True, 2048, 128, "a gate trains", "PLAIN"),  # full-parameter training
    (True, BF, True, 2048, 128, "a norm trains", "PLAIN"),
    (True, BF, True, 2048, 128, "adapted norm", "PLAIN"),   # a norm weight that is no tensor
    (True, BF, False, 2048, 128, "a gate trains", "FUSED"),  # outside autograd nothing trains
    (False, BF, False, 2048, 128, "frozen", "PLAIN"),      # the CPU
    (False, BF, True, 2048, 128, "frozen", "PLAIN"),
    (True, torch.float32, False, 2048, 128, "frozen", "PLAIN"),
    (True, torch.float32, True, 2048, 128, "frozen", "PLAIN"),
    (True, BF, False, 2048, 64, "frozen", "PLAIN"),        # K7 takes Dh = 128 alone
    (True, BF, True, 2048, 64, "frozen", "PLAIN"),
    (True, BF, False, 256, 128, "frozen", "PLAIN"),        # K6 takes the trunk's 2048 alone
    (True, BF, True, 256, 128, "frozen", "PLAIN"),
    (True, BF, False, 4096, 128, "frozen", "PLAIN"),
    (True, BF, False, 2056, 128, "frozen", "PLAIN"),
])
def test_ops_for_picks_the_kernels_only_where_they_apply(is_cuda, dtype, grad, width, head_dim,
                                                         frozen, ops):
    x = types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype)
    gate, norm = torch.zeros(2, 1, 8), torch.ones(4, 8)
    operands = {"frozen": [gate, norm], "none": [],
                "a gate trains": [gate.clone().requires_grad_(True), norm],
                "a norm trains": [gate, norm.clone().requires_grad_(True)],
                "adapted norm": [gate, types.SimpleNamespace(w=norm)]}[frozen]
    with torch.set_grad_enabled(grad):
        got = tr.ops_for(x, width, head_dim, operands)
    assert got is getattr(tr, ops) and got.fused == (ops != "PLAIN")
    assert got.h_buffer == (ops == "FUSED")


def _tiny_forward(cfg, params, dtype, dev, joint_uncond=False, rows=False):
    gen = torch.Generator(device=dev).manual_seed(4)
    b, s = 2, 16
    x = torch.randn(b, s, cfg.latent_size, generator=gen, device=dev).to(dtype)
    t_b = torch.full((b,), 0.7, device=dev).to(dtype)
    ids = torch.randint(0, 256, (b, 24), generator=gen, device=dev)
    tm = torch.ones(b, 24, dtype=torch.bool, device=dev)
    spk = torch.randn(b, 32, cfg.latent_size, generator=gen, device=dev).to(dtype)
    sm = torch.ones(b, 32, dtype=torch.bool, device=dev)
    sm[1, 20:] = False
    kt = tdit.get_kv_cache_text(params, cfg, ids, tm)
    ks = tdit.get_kv_cache_speaker(params, cfg, spk)
    rope = None
    if rows:
        cos, sin = trope.precompute_rope(cfg.head_dim, 256, device=dev)
        idx = torch.tensor([0, 96], device=dev)[:, None] + torch.arange(s, device=dev)
        rope = trope.rope_rows(cos, sin, idx)
    return tdit.dit_forward_cfg(params, cfg, x, t_b, tm, sm, kt, ks, rope_q=rope,
                                joint_uncond=joint_uncond)


@pytest.mark.parametrize("dtype,grad", [(torch.float32, False), (BF, False), (BF, True)])
def test_a_cpu_forward_takes_the_plain_chain_and_counts_it(dtype, grad):
    cfg = DiTConfig().tiny()
    params = tdit.init_dit_params(cfg, dtype, torch.device("cpu"), seed=0)
    profiling.enable()
    try:
        before = profiling.counters()
        with torch.set_grad_enabled(grad):
            out = _tiny_forward(cfg, params, dtype, torch.device("cpu"))
        after = profiling.counters()
    finally:
        profiling.disable()
    assert out.shape == (3, 2, 16, cfg.latent_size) and torch.isfinite(out).all()
    assert after.get("trunk.plain_layers", 0) - before.get("trunk.plain_layers", 0) == \
        cfg.num_layers
    assert after.get("trunk.fused_layers", 0) == before.get("trunk.fused_layers", 0)


def _lora_loss_and_grads(cfg, params, dev, dtype, b=2, s=16, seed=5):
    """A LoRA r4 loss on a small batch (every b moved off zero) and the
    adapters' gradients, in `tree_leaves` order."""
    from echo_tts_tpu_torch.train import lora as tlora
    from echo_tts_tpu_torch.train.loop import tree_leaves
    from echo_tts_tpu_torch.train.loss import compute_diffusion_loss

    gen = torch.Generator(device=dev).manual_seed(seed)
    lc = tlora.LoRAConfig(rank=4, alpha=8.0)
    lora = tlora.init_lora(gen, params, lc)
    for ab in lora.values():
        ab["b"].normal_(0.0, 0.05, generator=gen)
    leaves = tree_leaves(lora)
    for x in leaves:
        x.requires_grad_(True)
    lat = torch.randn(b, s, cfg.latent_size, generator=gen, device=dev)
    ids = torch.randint(0, 256, (b, 24), generator=gen, device=dev)
    tm = torch.ones(b, 24, dtype=torch.bool, device=dev)
    tm[1, 17:] = False
    spk = torch.randn(b, 32, cfg.latent_size, generator=gen, device=dev)
    ones = torch.ones(b, s, dtype=torch.bool, device=dev)
    loss = compute_diffusion_loss(tlora.lora_params(params, lora, lc), cfg, gen, lat, ones, ids,
                                  tm, spk, torch.ones(b, 32, dtype=torch.bool, device=dev),
                                  model_dtype=dtype)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]


def test_the_trainable_islands_match_the_plain_chain_in_a_lora_step(monkeypatch):
    """The trunk under autograd through TRAINABLE (the Functions, here with
    their plain forward and formulas: the CPU's path) against PLAIN: the
    same LoRA loss and adapter gradients in fp32, the checkpoint boundary
    carrying each layer's deferred MLP residual."""
    cfg = DiTConfig(has_latent_modules=False).tiny()
    params = tdit.init_dit_params(cfg, torch.float32, torch.device("cpu"), seed=3)
    ref_loss, ref = _lora_loss_and_grads(cfg, params, "cpu", torch.float32)
    chosen = []
    monkeypatch.setattr(tr, "ops_for", lambda *a: chosen.append(1) or tr.TRAINABLE)
    profiling.enable()
    try:
        c0 = profiling.counters()
        loss, got = _lora_loss_and_grads(cfg, params, "cpu", torch.float32)
        c1 = profiling.counters()
    finally:
        profiling.disable()
    assert chosen and c1.get("trunk.fused_layers", 0) - c0.get("trunk.fused_layers", 0) == \
        cfg.num_layers
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=0)
    assert sum(int(g.abs().sum() > 0) for g in ref) > len(ref) // 2
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6 * float(r.abs().max() + 1e-30))


@pytest.mark.parametrize("operand", ["gate", "shift", "scale", "norm weight", "q_weight",
                                     "k_weight"])
def test_the_trainable_islands_refuse_an_operand_they_do_not_differentiate(operand):
    """The backward kernels give no gradient to the modulation or the norms'
    weights: a TRAINABLE island handed one that requires grad raises rather
    than leave its gradient out."""
    gen = torch.Generator().manual_seed(17)
    i = {k: v.clone() for k, v in _inputs(gen, "cpu", 1, 2, 8, 256).items()}
    q, k, qw, kw, cos, sin = _heads(gen, "cpu", 1, 2, 8, 4, False)
    x = i["x"].requires_grad_(True)
    trained = {"gate": i["gate"], "shift": i["shift"], "scale": i["scale"],
               "norm weight": i["w"], "q_weight": qw, "k_weight": kw}[operand]
    trained.requires_grad_(True)
    calls = {
        "norm weight": lambda: tr.residual_norm_trainable(x, i["y"], i["gate"], i["w"], EPS),
        "q_weight": lambda: tr.qk_norm_rope_trainable(q, k, qw, kw, cos, sin, 0, 4, EPS),
    }
    calls["k_weight"] = calls["q_weight"]
    call = calls.get(operand, lambda: tr.residual_modulate_trainable(
        x, i["y"], i["gate"], i["shift"], i["scale"], EPS))
    with pytest.raises(ValueError, match=operand.replace("norm ", "")):
        call()


# ---------------------------------------------------------------------------
# The card: each kernel against its plain chain
# ---------------------------------------------------------------------------

SHAPES = [(1, 1, 64), (2, 8, 192), (3, 8, 640), (3, 1, 192), (1, 8, 640)]  # (G, B, S)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["first", "residual", "norm"])
@pytest.mark.parametrize("g,b,s", SHAPES)
def test_k6_matches_its_plain_chain(cuda_device, g, b, s, case):
    gen = torch.Generator(device=cuda_device).manual_seed(g * 1000 + b * 100 + s)
    i = _inputs(gen, cuda_device, g, b, s, 2048)
    y, gate = (None, None) if case == "first" else (i["y"], i["gate"])
    x = i["x"].clone()
    out = None if case == "first" else torch.empty_like(x)  # h into a new tensor or a buffer
    before = (tr.residual_modulate.launches, tr.residual_norm.launches)
    if case == "norm":
        ref_h = tr.residual_norm_plain(i["x"], y, gate, i["w"], EPS)
        ref_x = i["x"] + gate * y
        got_h = tr.residual_norm(x, y, gate, i["w"], EPS, out)
        assert (tr.residual_modulate.launches, tr.residual_norm.launches) == \
            (before[0], before[1] + 1)
    else:
        ref_x, ref_h = tr.residual_modulate_plain(i["x"], y, gate, i["shift"], i["scale"], EPS)
        got_x, got_h = tr.residual_modulate(x, y, gate, i["shift"], i["scale"], EPS, out)
        assert got_x is x
        assert (tr.residual_modulate.launches, tr.residual_norm.launches) == \
            (before[0] + 1, before[1])
    torch.cuda.synchronize()
    assert out is None or got_h is out
    assert torch.equal(x, ref_x)  # the residual has no sum: bit for bit
    assert_bf16_close(got_h, ref_h, None if case == "norm" else modulation_terms(ref_x, i["scale"]))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("heads,offset", [(16, 0), (8, 0), (8, 8), (12, 2)])
@pytest.mark.parametrize("g,b,s", SHAPES)
def test_k7_matches_its_plain_chain(cuda_device, g, b, s, heads, offset, rows):
    """All 16 heads, a tp=2 rank's 8 at offsets 0 (all rotated) and 8 (none),
    and 12 heads from 2 (six rotated); tables shared or one a row."""
    gen = torch.Generator(device=cuda_device).manual_seed(g * 1000 + b * 100 + s + heads)
    q, k, qw, kw, cos, sin = _heads(gen, cuda_device, g, b, s, heads, rows)
    ref = tr.qk_norm_rope_plain(q, k, qw, kw, cos, sin, offset, 16, EPS)
    terms = [rotation_terms(tl.rms_norm(t, w, EPS)) for t, w in ((q, qw), (k, kw))]
    before = tr.qk_norm_rope.launches
    gq, gk = tr.qk_norm_rope(q, k, qw, kw, cos.contiguous(), sin.contiguous(), offset, 16, EPS)
    torch.cuda.synchronize()
    assert gq is q and gk is k and tr.qk_norm_rope.launches == before + 1
    for got, r, tm in zip((gq, gk), ref, terms):
        assert_bf16_close(got, r, tm)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["sigmoid", "silu"])
@pytest.mark.parametrize("m,n", [(15360, 5888), (15360, 2048), (1536, 5888), (64, 2048),
                                 (3, 40)])
def test_k8_matches_its_plain_chain(cuda_device, m, n, act):
    gen = torch.Generator(device=cuda_device).manual_seed(m + n)
    a = (torch.randn(m, n, generator=gen, device=cuda_device) * 4).to(BF)
    b = torch.randn(m, n, generator=gen, device=cuda_device).to(BF)
    plain, fused = ((tr.sigmoid_gate_plain, tr.sigmoid_gate) if act == "sigmoid"
                    else (tr.swiglu_plain, tr.swiglu))
    ref = plain(a, b)
    before = fused.launches
    a_kept, out = a.clone(), torch.empty_like(a)
    assert fused(a_kept, b, out=out) is out  # into a buffer of its own
    got = fused(a, b)
    torch.cuda.synchronize()
    assert got is a and fused.launches == before + 2
    assert_bf16_close(got, ref)
    assert torch.equal(out, got) and not torch.equal(a_kept, got)


def _card_cfg():
    """The trunk's widths (2048, 16 x 128 heads, 5888) at two layers, with
    small encoders."""
    return DiTConfig(num_layers=2, text_model_size=256, text_num_layers=1, text_num_heads=2,
                     text_intermediate_size=512, speaker_model_size=256,
                     speaker_num_layers=1, speaker_num_heads=2,
                     speaker_intermediate_size=512)


@pytest.mark.cuda
@pytest.mark.parametrize("joint_uncond,rows", [(False, False), (True, False), (False, True)])
def test_a_cfg_forward_fused_matches_plain(cuda_device, joint_uncond, rows):
    """A CFG forward at the trunk's widths: fused (no autograd) against the
    plain chain (the same call under autograd with the out_norm's weight
    trained, as in full-parameter training), with the counters and the
    launches of each kernel; per-row tables for the continuous groups."""
    cfg = _card_cfg()
    params = tdit.init_dit_params(cfg, BF, cuda_device, seed=7)
    params["out_norm"].requires_grad_(True)
    launches = lambda: [w.launches for w in (tr.residual_modulate, tr.qk_norm_rope,  # noqa: E731
                                             tr.sigmoid_gate, tr.swiglu, tr.residual_norm)]
    profiling.enable()
    try:
        c0, l0 = profiling.counters(), launches()
        with torch.no_grad():
            got = _tiny_forward(cfg, params, BF, cuda_device, joint_uncond, rows)
        c1, l1 = profiling.counters(), launches()
        with torch.enable_grad():
            ref = _tiny_forward(cfg, params, BF, cuda_device, joint_uncond, rows)
        c2, l2 = profiling.counters(), launches()
    finally:
        profiling.disable()
    n = cfg.num_layers
    fused = lambda c: c.get("trunk.fused_layers", 0)  # noqa: E731
    plain = lambda c: c.get("trunk.plain_layers", 0)  # noqa: E731
    assert (fused(c1) - fused(c0), plain(c1) - plain(c0)) == (n, 0)
    assert (fused(c2) - fused(c1), plain(c2) - plain(c1)) == (0, n)
    assert [b - a for a, b in zip(l0, l1)] == [2 * n, n, n, n, 1] and l2 == l1
    assert got.shape == ref.shape and torch.isfinite(got).all()
    rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
    assert rel < 1e-2, rel


# The backward kernels under autograd (the TRAINABLE Functions: K6-K8 out of
# place, then K6-K8 bwd) against autograd of the plain chains, at a training
# step's shape: G = 1, B = 8, S = 640, D = 2048, 16 heads of 128, SwiGLU's
# 5888. The bounds and their reasons are the CPU tests' above: each element
# within one ulp of the result plus one ulp of the terms of the norm
# backward's last fp32 sum (its row or head sum of dn x is the one number
# the kernels sum in another order; where the last sum cancels its last
# bits move the result by more than one of its own ulps), dy plus dx''s
# error carried through the gate's product; K8 within one ulp.
TRAIN = (1, 8, 640)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K6_CASES)
def test_k6_bwd_matches_autograd_of_its_plain_chain(cuda_device, case):
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    i, dh, dxi = k6_case(gen, cuda_device, BF, case, *TRAIN, 2048)
    ref = k6_grads(i, case, dh, dxi)
    before = (tr.residual_modulate_bwd.launches, tr.residual_modulate.launches,
              tr.residual_norm.launches)
    got = k6_grads(i, case, dh, dxi, ops=tr.TRAINABLE)
    torch.cuda.synchronize()
    norm = case == "norm"
    assert (tr.residual_modulate_bwd.launches, tr.residual_modulate.launches,
            tr.residual_norm.launches) == (before[0] + 1, before[1] + (not norm),
                                           before[2] + norm)
    assert_k6_grads(i, case, dh, got, ref)
    # the kernel's own entry, with the forward's residual sum
    direct = k6_grads(i, case, dh, dxi, tr.residual_modulate_bwd)
    for d, g in zip(direct, got):
        assert (d is None and g is None) or torch.equal(d, g)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,heads,offset", [(False, 16, 0), (True, 16, 0), (False, 8, 8),
                                               (True, 8, 0)])
def test_k7_bwd_matches_autograd_of_its_plain_chain(cuda_device, rows, heads, offset):
    """All 16 heads (8 rotated), a tp=2 rank's 8 at offsets 8 (none
    rotated) and 0 (all); tables shared and one a row."""
    gen = torch.Generator(device=cuda_device).manual_seed(32 + heads)
    q, k, qw, kw, cos, sin, dq, dk = k7_case(gen, cuda_device, BF, rows, heads, *TRAIN)
    cos, sin = cos.contiguous(), sin.contiguous()
    ref = k7_grads(q, k, qw, kw, cos, sin, dq, dk, offset)
    before = (tr.qk_norm_rope_bwd.launches, tr.qk_norm_rope.launches)
    got = k7_grads(q, k, qw, kw, cos, sin, dq, dk, offset, tr.TRAINABLE)
    torch.cuda.synchronize()
    assert (tr.qk_norm_rope_bwd.launches, tr.qk_norm_rope.launches) == \
        (before[0] + 1, before[1] + 1)
    n_rot = tr._n_rot(heads, offset, 16)
    for t, g, w, gt, r in zip((q, k), (dq, dk), (qw, kw), got, ref):
        assert_bf16_close(gt, r, k7_terms(t, g, w, cos, sin, n_rot), share=0.98)


@pytest.mark.cuda
@pytest.mark.parametrize("act,n", [("sigmoid", 2048), ("silu", 5888)])
def test_k8_bwd_matches_autograd_of_its_plain_chain(cuda_device, act, n):
    gen = torch.Generator(device=cuda_device).manual_seed(33)
    a, b, do = k8_case(gen, cuda_device, BF, TRAIN[1] * TRAIN[2], n)
    ref = k8_grads(a, b, do, act)
    counter = tr.sigmoid_gate_bwd if act == "sigmoid" else tr.swiglu_bwd
    before = counter.launches
    got = k8_grads(a, b, do, act, tr.TRAINABLE)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for g, r in zip(got, ref):
        assert_bf16_close(g, r, share=0.999)


@pytest.mark.cuda
def test_a_lora_step_through_the_kernels_matches_plain(cuda_device, monkeypatch):
    """A LoRA loss and its adapter gradients at the trunk's widths (two
    layers, B = 2, S = 64, remat, K1/K3): TRAINABLE, which the rule picks
    for LoRA training on the card, against the plain chain; the counters
    and every kernel's launches: the forward and remat's recompute of each
    layer, one backward of each island but the first layer's first K6,
    whose input takes no gradient."""
    cfg = _card_cfg()
    params = tdit.init_dit_params(cfg, BF, cuda_device, seed=8)
    fwd = (tr.residual_modulate, tr.residual_norm, tr.qk_norm_rope, tr.sigmoid_gate, tr.swiglu)
    bwd = (tr.residual_modulate_bwd, tr.qk_norm_rope_bwd, tr.sigmoid_gate_bwd, tr.swiglu_bwd)
    profiling.enable()
    try:
        c0, f0, b0 = profiling.counters(), [w.launches for w in fwd], [w.launches for w in bwd]
        loss, got = _lora_loss_and_grads(cfg, params, cuda_device, BF, s=64)
        torch.cuda.synchronize()
        c1, f1, b1 = profiling.counters(), [w.launches for w in fwd], [w.launches for w in bwd]
        monkeypatch.setattr(tr, "ops_for", lambda *a: tr.PLAIN)
        ref_loss, ref = _lora_loss_and_grads(cfg, params, cuda_device, BF, s=64)
    finally:
        profiling.disable()
    n = cfg.num_layers
    assert c1.get("trunk.fused_layers", 0) - c0.get("trunk.fused_layers", 0) == n
    assert c1.get("trunk.plain_layers", 0) == c0.get("trunk.plain_layers", 0)
    assert [b - a for a, b in zip(f0, f1)] == [4 * n, 1, 2 * n, 2 * n, 2 * n]
    assert [b - a for a, b in zip(b0, b1)] == [2 * n, n, n, n]
    assert abs(float(loss) - float(ref_loss)) <= 5e-3 * abs(float(ref_loss))
    moving = [(g, r) for g, r in zip(got, ref) if float(r.float().norm()) > 0]
    assert len(moving) >= len(ref) // 2
    for g, r in moving:
        rel = float((g.float() - r.float()).norm() / r.float().norm())
        assert rel < 2e-2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp32 x", "strided x", "narrow x", "norm alone", "gate shape",
                                  "y alone",
                                  "out is x", "misaligned",
                                  "head dim", "q and k", "weight shape", "table shape",
                                  "fp32 table", "cpu", "gated shapes", "gated fp32",
                                  "gated length"])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(cuda_device, case):
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    i = _inputs(gen, cuda_device, 1, 2, 8, 2048)
    q, k, qw, kw, cos, sin = _heads(gen, cuda_device, 1, 2, 8, 4, False)
    k6 = lambda **o: tr.residual_modulate(**{**dict(x=i["x"], y=i["y"], gate=i["gate"],  # noqa
                                                    shift=i["shift"], scale=i["scale"],
                                                    eps=EPS), **o})
    k7 = lambda **o: tr.qk_norm_rope(**{**dict(q=q, k=k, q_weight=qw, k_weight=kw,  # noqa
                                                cos=cos.contiguous(), sin=sin.contiguous(),
                                                head_offset=0, total_heads=4, eps=EPS), **o})
    calls = {
        "fp32 x": lambda: k6(x=i["x"].float(), y=i["y"].float()),
        "strided x": lambda: k6(x=i["x"].transpose(1, 2), y=i["y"].transpose(1, 2)),
        "narrow x": lambda: k6(**{name: i[name][..., :256].contiguous()
                                  for name in ("x", "y", "gate", "shift", "scale")}),
        "norm alone": lambda: tr.residual_norm(i["x"], None, None, i["w"], EPS),
        "gate shape": lambda: k6(gate=i["gate"][:1]),
        "y alone": lambda: k6(gate=None),
        "out is x": lambda: k6(out=i["x"]),
        "misaligned": lambda: tr.swiglu(i["x"].flatten()[1:-7], i["y"].flatten()[1:-7]),
        "head dim": lambda: k7(q=q[..., :64].contiguous(), k=k[..., :64].contiguous()),
        "q and k": lambda: k7(k=k[:, :, :4].contiguous()),
        "weight shape": lambda: k7(q_weight=qw[:2].contiguous()),
        "table shape": lambda: k7(cos=cos[:4].contiguous()),
        "fp32 table": lambda: k7(cos=cos.double()),
        "cpu": lambda: tr.sigmoid_gate(i["x"].cpu(), i["y"].cpu()),
        "gated shapes": lambda: tr.swiglu(i["x"], i["y"][..., :128].contiguous()),
        "gated fp32": lambda: tr.swiglu(i["x"].float(), i["y"].float()),
        "gated length": lambda: tr.swiglu(i["x"].flatten()[:37], i["y"].flatten()[:37]),
    }
    before = [w.launches for w in (tr.residual_modulate, tr.residual_norm, tr.qk_norm_rope,
                                   tr.sigmoid_gate, tr.swiglu)]
    # the C entry refuses an operand that is not 16-byte aligned
    with pytest.raises(RuntimeError if case == "misaligned" else ValueError):
        calls[case]()
    assert before == [w.launches for w in (tr.residual_modulate, tr.residual_norm,
                                           tr.qk_norm_rope, tr.sigmoid_gate, tr.swiglu)]
