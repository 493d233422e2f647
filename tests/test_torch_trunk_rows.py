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
# CPU: the rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("is_cuda,dtype,grad,width,head_dim,fused", [
    (True, BF, False, 2048, 128, True),
    (True, BF, True, 2048, 128, False),           # autograd: training
    (False, BF, False, 2048, 128, False),         # the CPU
    (True, torch.float32, False, 2048, 128, False),
    (True, BF, False, 2048, 64, False),           # K7 takes Dh = 128 alone
    (True, BF, False, 256, 128, False),           # K6 takes the trunk's 2048 alone
    (True, BF, False, 4096, 128, False),
    (True, BF, False, 2056, 128, False),
])
def test_ops_for_picks_the_kernels_only_where_they_apply(is_cuda, dtype, grad, width, head_dim,
                                                         fused):
    x = types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype)
    with torch.set_grad_enabled(grad):
        ops = tr.ops_for(x, width, head_dim)
    assert ops is (tr.FUSED if fused else tr.PLAIN) and ops.fused == fused


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
    plain chain (the same call under autograd), with the counters and the
    launches of each kernel; per-row tables for the continuous groups."""
    cfg = _card_cfg()
    params = tdit.init_dit_params(cfg, BF, cuda_device, seed=7)
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
