"""The measurement-variant kernels' plain versions (K1v attention_var, K2v-cl
res_chain, K2v-cf res_chain_cf, K2s res_chain_snake) against the measurement
scripts' own Pallas functions in interpret mode, and the port's
speed-of-light counts against the JAX package's.

The scripts' functions take no `interpret` argument, so each script is loaded
from its path and `pallas_call` is patched to interpret mode inside the test;
nothing under scripts/ or echo_tts_tpu/ changes. Inputs come from a numpy
seed, fp32 on the CPU, atol/rtol 2e-5: the two sides sum in another order
(the tolerance of tests/test_pallas_conv.py and test_pallas_attention.py).
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import functools
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from echo_tts_tpu.core.config import DiTConfig as JDiTConfig
from echo_tts_tpu.ops import pallas_conv as jpc
from echo_tts_tpu.utils import profiling as jprof
from echo_tts_tpu_torch.checkpoints.from_jax import res_units_from_numpy
from echo_tts_tpu_torch.core.config import DiTConfig
from echo_tts_tpu_torch.ops import attention_variants as tav
from echo_tts_tpu_torch.ops import res_chain_variants as trv
from echo_tts_tpu_torch.utils import profiling as tprof

from torch_parity import assert_close, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=2e-5)


@functools.lru_cache(maxsize=None)
def _script(name):
    """scripts/<name>.py as a module (its main() never runs)."""
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """pallas_call in interpret mode for the scripts' kernels."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


# ---------------------------------------------------------------------------
# K1v
# ---------------------------------------------------------------------------

G, B, H, S, D = 2, 1, 2, 16, 8


def _attention_inputs(seg_lens, masked=(), seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, ks, vs = f(G, B, H, S, D), f(G, B, H, S, D), f(G, B, H, S, D)
    segs = []
    for i, n in enumerate(seg_lens):
        mask = rng.random((G, B, n)) < 0.7
        if i in masked:
            mask[:] = False
        segs.append((f(B, H, n, D), f(B, H, n, D), mask))
    return q, ks, vs, segs


ATTENTION_CASES = [
    # id, segment lengths, fully masked segments, flags
    ("where", (24, 40), (), dict(mask_mode="where")),
    ("bias", (24, 40), (), dict(mask_mode="bias")),
    ("arith", (24, 40), (), dict(mask_mode="arith")),
    ("none", (24, 40), (), dict(mask_mode="none")),
    ("exp2", (24, 40), (), dict(mask_mode="bias", use_exp2=True)),
    ("hg2", (24, 40), (), dict(mask_mode="bias", hg=2)),
    ("k_t", (24, 40), (), dict(mask_mode="bias", k_t=True)),
    ("tq8", (24, 40), (), dict(mask_mode="bias", tq=8)),
    ("one-segment", (64,), (), dict(mask_mode="bias", use_exp2=True)),
    ("masked-segment", (24, 40), (1,), dict(mask_mode="where")),
    ("masked-segment-bias", (24, 40), (0,), dict(mask_mode="bias", use_exp2=True)),
    ("fold", (24, 40), (), dict(mask_mode="bias", use_exp2=True, probe="fold")),
    ("noav", (24, 40), (), dict(mask_mode="bias", probe="noav")),
    ("dots", (24, 40), (), dict(mask_mode="none", probe="dots")),
    ("dots-k_t", (24, 40), (), dict(mask_mode="none", probe="dots", k_t=True)),
]


@pytest.mark.parametrize("seg_lens,masked,flags", [c[1:] for c in ATTENTION_CASES],
                         ids=[c[0] for c in ATTENTION_CASES])
def test_attention_var_plain_matches_pallas(interpret, seg_lens, masked, flags):
    jav = _script("bench_attention_variants")
    q, ks, vs, segs = _attention_inputs(seg_lens, masked)
    flags = dict(tq=S, **flags) if "tq" not in flags else flags
    ref = jav.attention_var(jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
                            [tuple(jnp.asarray(a) for a in sg) for sg in segs], **flags)
    k_t = flags.get("k_t", False)

    def key(k):  # the port takes transposed keys as they are stored
        return t(k).transpose(-1, -2).contiguous() if k_t else t(k)

    got = tav.attention_var(t(q), key(ks), t(vs), [(key(k), t(v), t(m)) for k, v, m in segs],
                            **flags)
    if flags.get("probe") == "dots":
        # weights are logits * 1e-9: compare at the output's own scale
        scale = float(np.abs(np.asarray(ref)).max())
        assert_close(got / scale, np.asarray(ref) / scale, **TOL)
    else:
        assert_close(got, ref, **TOL)
    for i in masked:  # a fully masked segment carries exactly zero weight
        rest = [sg for j, sg in enumerate(segs) if j != i]
        without = tav.attention_var(t(q), key(ks), t(vs),
                                    [(key(k), t(v), t(m)) for k, v, m in rest], **flags)
        assert torch.equal(got, without)


def test_attention_var_mask_forms_agree():
    """A mask given already in its mode's form is read as such."""
    q, ks, vs, segs = _attention_inputs((24, 40))
    ref = tav.attention_var(t(q), t(ks), t(vs), [(t(k), t(v), t(m)) for k, v, m in segs], tq=S)
    for mode in ("where", "bias", "arith"):
        pre = [(t(k), t(v), tav.mask_operand(t(m), mode)) for k, v, m in segs]
        assert pre[0][2].dtype != torch.bool
        got = tav.attention_var(t(q), t(ks), t(vs), pre, tq=S, mask_mode=mode)
        assert_close(got, ref.numpy(), **TOL)
    with pytest.raises(TypeError, match="mask_mode='bias'"):
        tav.attention_var(t(q), t(ks), t(vs),
                          [(t(k), t(v), t(m).to(torch.uint8)) for k, v, m in segs],
                          tq=S, mask_mode="bias")
    with pytest.raises(ValueError, match="needs at least"):
        tav.attention_var(t(q), t(ks), t(vs), [(t(k[:, :, :4]), t(v[:, :, :4]), t(m[..., :4]))
                                               for k, v, m in segs], tq=S, probe="noav")


RAGGED = dict(g=3, b=2, h=2, s=200, d=128)  # the card's ragged check, two heads of its four

RAGGED_ATTENTION_CASES = [
    # id, segment lengths, fully masked segments, flags
    ("full-bias-exp2", (300, 1), (1,), dict(mask_mode="bias", use_exp2=True)),
    ("fold-where", (300, 1), (1,), dict(mask_mode="where", probe="fold")),
    ("k_t-arith", (300, 1), (1,), dict(mask_mode="arith", k_t=True)),
    ("dots-none", (300, 1), (), dict(mask_mode="none", probe="dots")),
    ("noav-bias", (300, 130), (), dict(mask_mode="bias", probe="noav")),
]


@pytest.mark.parametrize("seg_lens,masked,flags", [c[1:] for c in RAGGED_ATTENTION_CASES],
                         ids=[c[0] for c in RAGGED_ATTENTION_CASES])
def test_attention_var_plain_matches_pallas_at_the_ragged_shape(interpret, seg_lens, masked,
                                                                flags):
    """S = 200 and T = 300 are no multiples of the CUDA kernel's 64-key and
    64- or 128-row tiles, and T = 1 is the absent-speaker segment: the shape
    at which the card's checks hold every variant against this plain version.
    The script's kernel takes the 200 rows as one tile."""
    jav = _script("bench_attention_variants")
    g, b, h, s, d = (RAGGED[k] for k in "gbhsd")
    rng = np.random.default_rng(41)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, ks, vs = f(g, b, h, s, d), f(g, b, h, s, d), f(g, b, h, s, d)
    segs = []
    for i, n in enumerate(seg_lens):
        mask = rng.random((g, b, n)) < 0.7
        if i in masked:
            mask[:] = False
        segs.append((f(b, h, n, d), f(b, h, n, d), mask))
    flags = dict(tq=s, **flags)
    ref = jav.attention_var(jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
                            [tuple(jnp.asarray(a) for a in sg) for sg in segs], **flags)
    k_t = flags.get("k_t", False)

    def key(k):
        return t(k).transpose(-1, -2).contiguous() if k_t else t(k)

    got = tav.attention_var(t(q), key(ks), t(vs), [(key(k), t(v), t(m)) for k, v, m in segs],
                            **flags)
    assert torch.isfinite(got).all()
    scale = float(np.abs(np.asarray(ref)).max()) if flags.get("probe") == "dots" else 1.0
    assert_close(got / scale, np.asarray(ref) / scale, **TOL)


# ---------------------------------------------------------------------------
# K2v-cl, K2v-cf, K2s
# ---------------------------------------------------------------------------

C, T = 16, 300


def _units(seed, bias=0.1):
    rng = np.random.default_rng(seed)

    def f(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return [{"snake1": rng.uniform(0.2, 1.5, (1, C, 1)).astype(np.float32),
             "snake2": rng.uniform(0.2, 1.5, (1, C, 1)).astype(np.float32),
             "conv1": {"w": f(C, C, 7, s=0.05), "b": f(C, s=bias)},
             "conv2": {"w": f(C, C, 1, s=0.05), "b": f(C, s=bias)}} for _ in range(3)]


def _junits(units):
    """The numpy units as the JAX scripts take them."""
    return [{k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else jnp.asarray(v)) for k, v in u.items()} for u in units]


def _tunits(units):
    """The numpy units as the port takes them, through its checkpoint helper."""
    return res_units_from_numpy(units, device="cpu")


def _x(seed=9, b=1):
    return np.random.default_rng(seed).standard_normal((b, T, C)).astype(np.float32)


CHAIN_CASES = [
    ("where-sin", dict(live_mode="where", use_sin=True)),
    ("mult", dict(live_mode="mult", use_sin=True)),
    ("off", dict(live_mode="off", use_sin=True)),
    ("poly", dict(use_sin="poly")),
    ("no-sin", dict(use_sin=False)),
    ("packed", dict(use_sin="poly", pack_taps=True)),
    ("no-tap-offsets", dict(use_sin="poly", tap_offsets=False)),
    ("off-no-tap-offsets-packed", dict(live_mode="off", use_sin=False, tap_offsets=False,
                                       pack_taps=True)),
]


@pytest.mark.parametrize("flags", [c[1] for c in CHAIN_CASES], ids=[c[0] for c in CHAIN_CASES])
def test_res_chain_plain_matches_pallas(interpret, flags):
    """Non-zero biases throughout: they are what makes the pad rows matter."""
    jcv = _script("bench_conv_kernel_variants")
    units, x = _units(3), _x(b=2)
    ref = jcv.res_chain(jnp.asarray(x), _junits(units), tile_t=128, **flags)
    got = trv.res_chain(t(x), _tunits(units), tile_t=128, **flags)
    assert_close(got, ref, **TOL)
    if flags.get("live_mode") == "off":  # the pad rows evolved: not the re-zeroed result
        rezeroed = trv.res_chain(t(x), _tunits(units), **{**flags, "live_mode": "where"})
        assert float((got - rezeroed).abs().max()) > 1e-3


def test_res_chain_bf16_snake_matches_pallas(interpret):
    """snake_dtype=bfloat16 rounds every operation of the snake to bf16 (8
    bits of mantissa) in the port, as eager bf16 arithmetic does. XLA's
    compiled CPU code keeps some of those intermediates in fp32 (measured: a
    jitted bf16 snake differs from the eager one in half its elements by one
    bf16 step), so the two sides can only agree to bf16 rounding: 2e-2 of
    the output's scale after three units, where a wrong snake is O(1) off."""
    jcv = _script("bench_conv_kernel_variants")
    units, x = _units(4), _x()
    ref = np.asarray(jcv.res_chain(jnp.asarray(x), _junits(units), tile_t=128,
                                   snake_dtype=jnp.bfloat16))
    got = trv.res_chain(t(x), _tunits(units), snake_dtype=torch.bfloat16).numpy()
    fp32 = trv.res_chain(t(x), _tunits(units)).numpy()
    assert np.abs(got - ref).max() < 2e-2 * np.abs(ref).max()
    assert np.abs(got - fp32).max() > 1e-4  # the rounding is really applied
    with pytest.raises(NotImplementedError):
        trv.res_chain(t(x), _tunits(units), snake_dtype=torch.bfloat16, use_sin="poly")


@pytest.mark.parametrize("use_sin", [True, False])
def test_res_chain_cf_plain_matches_pallas(interpret, use_sin):
    jcv = _script("bench_conv_kernel_variants")
    units, x = _units(5), _x(b=2)
    xcf = np.ascontiguousarray(x.transpose(0, 2, 1))
    ref = jcv.res_chain_cf(jnp.asarray(xcf), _junits(units), use_sin=use_sin,
                           tile_t=128)
    got = trv.res_chain_cf(t(xcf), _tunits(units), use_sin=use_sin)
    assert_close(got, ref, **TOL)
    # channels first equals channels last on the transposed input
    cl = trv.res_chain(t(x), _tunits(units), live_mode="mult", use_sin=use_sin)
    assert_close(got.transpose(1, 2), cl.numpy(), **TOL)


@pytest.mark.parametrize("snake_mode", ["exact", "none", "poly"])
def test_res_chain_snake_plain_matches_pallas(monkeypatch, snake_mode):
    """K2s: the script replaces the JAX package's kernel body by its own. The
    package's body has since gained a first ref (zero_below) that the
    script's bodies do not take, so the test drops it in a wrapper."""
    jsv = _script("bench_conv_variants")
    kern = jsv.make_kernel(snake_mode)
    monkeypatch.setattr(jpc, "_res_chain_kernel",
                        lambda zb_ref, *refs, **kw: kern(*refs, **kw))
    units, x = _units(6), _x(b=2)
    ref = jpc.fused_res_chain_cl(jnp.asarray(x), _junits(units), (1, 3, 9),
                                 tile_t=128, interpret=True)
    got = trv.res_chain_snake(t(x), _tunits(units), snake_mode)
    assert_close(got, ref, **TOL)


def test_snake_poly_matches_script_and_exact_snake():
    """`snake_poly` against the script's `_snake_poly`, and its error against
    the exact snake on [-20, 20] at alpha 1.3 (the script's accuracy probe)."""
    jsv = _script("bench_conv_variants")
    xs = np.linspace(-20.0, 20.0, 200001, dtype=np.float32)
    ref = np.asarray(jsv._snake_poly(jnp.asarray(xs), jnp.float32(1.3)))
    got = trv.snake_poly(t(xs), torch.tensor(1.3)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    exact = xs + (1.0 / (1.3 + 1e-9)) * np.sin(1.3 * xs.astype(np.float64)) ** 2
    assert np.abs(got - exact).max() < 2e-5


CHAIN_SRC = os.path.join(REPO, "echo_tts_tpu_torch", "csrc", "res_chain_variants.cu")


def _kernel_enum(src, prefix):
    """{name: value} of the `enum { <prefix>_... }` in the kernel source."""
    body = re.search(r"enum\s*\{\s*(%s_[^}]*)\}" % prefix, src).group(1)
    pairs = (item.split("=") for item in body.split(",") if item.strip())
    return {k.strip()[len(prefix) + 1:]: int(v) for k, v in pairs}


def test_wrapper_codes_equal_the_kernels_enums():
    """K2v-cl, K2v-cf and K2s share one C entry point: each wrapper's snake and
    live_mode code is the kernel's enum value of the same meaning, and the
    entry point accepts codes up to the last of each enum."""
    with open(CHAIN_SRC) as f:
        src = f.read()
    snake, live = _kernel_enum(src, "SNAKE"), _kernel_enum(src, "LIVE")
    assert trv._SNAKE_CODE == {True: snake["SIN"], "exact": snake["SIN"], "poly": snake["SIN2"],
                               False: snake["LINEAR"], "none": snake["IDENTITY"],
                               "poly_cos": snake["COS"]}
    assert {m: i for i, m in enumerate(trv.LIVE_MODES)} == {
        "where": live["WHERE"], "mult": live["MULT"], "off": live["OFF"]}
    assert max(snake.values()) == snake["COS"] and max(live.values()) == live["OFF"]
    assert "snake > SNAKE_COS" in src and "live_mode > LIVE_OFF" in src


@pytest.mark.parametrize("use_sin", [True, False])
def test_res_chain_cf_plain_is_the_channels_last_chain_transposed(use_sin):
    """The identity the shared kernel rests on: K2v-cf is K2v-cl with the
    multiply re-zero on the transposed input (B=2, a length that is no
    multiple of 8, non-zero biases)."""
    units, x = _tunits(_units(11, bias=0.3)), t(_x(seed=12, b=2)[:, :293])
    cf = trv.res_chain_cf_plain(x.transpose(1, 2).contiguous(), units, use_sin=use_sin)
    cl = trv.res_chain_plain(x, units, live_mode="mult", use_sin=use_sin)
    assert_close(cf.transpose(1, 2), cl.numpy(), **TOL)


def test_res_chain_snake_exact_plain_is_the_variant_chain_with_sin():
    """K2s "exact" is K2v-cl's chain with the sinf snake and the select
    re-zero (what the shared kernel runs for it)."""
    units, x = _tunits(_units(13, bias=0.3)), t(_x(seed=14, b=2))
    assert_close(trv.res_chain_snake_plain(x, units, "exact"),
                 trv.res_chain_plain(x, units, use_sin=True).numpy(), **TOL)


@pytest.mark.parametrize("c", [96, 192])
def test_res_chain_packed_weights_walked_as_the_kernel(c):
    """K2v-cl's weight buffer, read tile by tile as csrc/res_chain_variants.cu
    reads it (unit u: seven taps of C/32 chunks, then the 1x1's chunks; each
    (32 × C) strip tile holding, per output column, 8 inputs a strip), gives
    back every weight where it belongs."""
    gen = torch.Generator().manual_seed(c)
    w7 = torch.randn(3, 7, c, c, generator=gen).to(torch.bfloat16)
    w1 = torch.randn(3, c, c, generator=gen).to(torch.bfloat16)
    flat = trv.packed_weights(w7, w1)
    kc, kch = 32, c // 32
    assert flat.numel() == 3 * 8 * kch * kc * c
    tiles = flat.reshape(3, 8 * kch, kc // 8, c, 8)

    def matrix(tile):  # (kc/8, C, 8) strips -> (kc, C)
        return tile.permute(0, 2, 1).reshape(kc, c)

    for u in range(3):
        for j in range(7):
            for k in range(kch):
                assert torch.equal(matrix(tiles[u, j * kch + k]), w7[u, j, k * kc:(k + 1) * kc])
        for k in range(kch):
            assert torch.equal(matrix(tiles[u, 7 * kch + k]), w1[u, k * kc:(k + 1) * kc])


def test_wrappers_refuse_grad_and_other_devices():
    """Off the CPU the variant wrappers refuse inputs that require grad, then
    any device but CUDA (meta tensors reach both checks here)."""
    q = torch.zeros(1, 1, 2, 8, 128, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="K1v has no backward"):
        tav.attention_var(q, q, q, [], tq=64)
    x = torch.zeros(1, 8, 96, device="meta", requires_grad=True)
    for call in (lambda v: trv.res_chain(v, []), lambda v: trv.res_chain_cf(v, []),
                 lambda v: trv.res_chain_snake(v, [], "exact")):
        with pytest.raises(RuntimeError, match="no backward"):
            call(x)
        with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):
            call(x)
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):
        tav.attention_var(q, q, q, [], tq=64)
    for bad in (dict(probe="half"), dict(mask_mode="add"), dict(hg=3), dict(block_order="x")):
        with pytest.raises(ValueError):
            tav.attention_var(torch.zeros(1, 1, 2, 8, 8), torch.zeros(1, 1, 2, 8, 8),
                              torch.zeros(1, 1, 2, 8, 8), [], **{"tq": 8, **bad})
    with pytest.raises(ValueError, match="live_mode"):
        trv.res_chain(torch.zeros(1, 8, 16), _tunits(_units(0)), live_mode="never")
    with pytest.raises(ValueError, match="snake_mode"):
        trv.res_chain_snake(torch.zeros(1, 8, 16), _tunits(_units(0)), "cubic")
    bad = _units(0)
    bad[1]["conv1"]["w"] = bad[1]["conv1"]["w"][:, :, :3]
    with pytest.raises(ValueError, match=r"units\[1\].conv1.w"):
        res_units_from_numpy(bad, device="cpu")


# ---------------------------------------------------------------------------
# speed of light
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,seq,ctx", [(1, 640, 768 + 160), (3, 640, 768 + 1600),
                                           (8, 640, 928)])
def test_speed_of_light_counts_match_jax(batch, seq, ctx):
    """The FLOP and byte counts agree with the JAX package's; the times
    differ by the spec table (an H100's peaks in place of a TPU's)."""
    jcfg, tcfg = JDiTConfig(has_latent_modules=False), DiTConfig(has_latent_modules=False)
    assert tprof.dit_step_flops(tcfg, batch, seq, ctx) == jprof.dit_step_flops(jcfg, batch, seq, ctx)
    jsol = jprof.speed_of_light(jcfg, batch, seq, ctx, gen="v5e")
    tsol = tprof.speed_of_light(tcfg, batch, seq, ctx)
    assert tsol["flops"] == jsol["flops"]
    jspec, tspec = jprof.TPU_SPECS["v5e"], tprof.GPU_SPECS["h100_sxm"]
    weight_bytes_j = jsol["t_weights_ms"] * 1e-3 * jspec["hbm_gbps"] * 1e9
    weight_bytes_t = tsol["t_weights_ms"] * 1e-3 * tspec["hbm_gbps"] * 1e9
    assert weight_bytes_t == pytest.approx(weight_bytes_j, rel=1e-9)
    assert tsol["t_compute_ms"] == pytest.approx(
        jsol["t_compute_ms"] * jspec["bf16_tflops"] / tspec["bf16_tflops"], rel=1e-9)
    assert tsol["floor_ms"] == max(tsol["t_compute_ms"], tsol["t_weights_ms"])
    assert (tspec["bf16_tflops"], tspec["hbm_gbps"]) == (989.0, 3350.0)


def test_phase_timer_and_metrics_line(caplog):
    timer = tprof.PhaseTimer()
    with timer.phase("a"):
        pass
    with timer.phase("a"):
        pass
    assert timer.counts == {"a": 2} and set(timer.as_dict()) == {"a"}
    assert timer.json().startswith('{"a":')
    with caplog.at_level("INFO", logger="echo_tts_tpu_torch"):
        tprof.metrics_line("step", {"ms": 1.5})
    assert '"metric": "step"' in caplog.text and '"ms": 1.5' in caplog.text


def test_trace_writes_a_chrome_trace_and_families_are_named(tmp_path):
    """trace() on the CPU: the capture is written and, with no device event,
    the family split is empty; kernel names fall into the port's families."""
    with tprof.trace(str(tmp_path)) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert tprof.device_time_by_family(prof) == {}
    for name, family in (("joint_attention_kernel<128>", "K1 joint_attention"),
                         ("attention_var_kernel<true>", "K1v attention_var"),
                         ("dkdv_kernel", "K3 joint_attention_bwd"),
                         ("res_unit_conv7_kernel<192>", "K2 res_chain"),
                         ("res_chain_cl_kernel<192, 4>", "K2v-cl/K2s res_chain"),
                         ("res_chain_cf_kernel<96, 0>", "K2v-cf res_chain_cf"),
                         ("sm90_xmma_gemm_bf16", "GEMM (cuBLAS)"),
                         ("cudnn::engines::conv", "conv (cuDNN)"),
                         ("vectorized_elementwise_kernel", "other (elementwise, norms, copies)")):
        assert tprof.kernel_family(name) == family


def test_timing_reports_median_and_spread_on_the_host_clock():
    from echo_tts_tpu_torch.bench import timing

    calls = []
    r = timing.cuda_times(lambda: calls.append(1), reps=5, warmup=2, device="cpu")
    assert len(calls) == 2 + 5 and r["reps"] == 5 and r["min_ms"] <= r["ms"] <= r["max_ms"]
    assert timing.timing_device("cpu").startswith("cpu") and timing.card_line("cpu") == "cpu"
    assert timing.entry_device(True).type == "cpu"
