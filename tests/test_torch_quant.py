"""The port's W8A8 int8 trunk (echo_tts_tpu_torch/models/quant.py) against the
JAX package's (echo_tts_tpu/models/quant.py) on the same numpy inputs, on the
CPU: codes and scales of `quantize_weight` and `quant_rows` bit for bit (fp32
and bf16 inputs, an all-zero row, values on .5 ties); `qdot`, `mm`,
`proj_shared` and `swiglu_mlp_q` at rel-L2 <= 1e-6 in fp32 (the int32 sums
are exact, so only the float epilogue's rounding is left); the leaves of
`quantize_dit_params` with and without the encoders, through both routes (a
JAX-quantized tree carried over by checkpoints/from_jax.py, and the port's
own quantization of the carried bf16 weights); the int8 DiT forward and CFG
forward (joint_uncond False and True) against JAX at rel-L2 <= 1e-3 (a code
on a rounding boundary may flip between the frameworks from fp32 summation
order upstream); the int8 forward against the float one (SNR, as the JAX
package's tests/test_quant.py holds its own). The kernels' plain versions
(`ops/int8_gemm.py`, `ops/quant_rows.py`) are what runs here. The JAX
functions run op by op: under jax.jit, XLA on the CPU turns the division of
the amax by 127 into a product with its reciprocal, which moves a scale by
one ulp (and then, rarely, a code); the port divides, as the function's own
operations do and as kernel K5 must."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echo_tts_tpu.core.config import DiTConfig as JDiTConfig
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.models import quant as jquant
from echo_tts_tpu_torch.checkpoints.from_jax import dit_params_from_numpy
from echo_tts_tpu_torch.core.config import DiTConfig
from echo_tts_tpu_torch.models import dit as tdit
from echo_tts_tpu_torch.models import quant as tquant
from echo_tts_tpu_torch.ops import int8_gemm as tig
from echo_tts_tpu_torch.ops import quant_rows as tqr

from torch_parity import np_tree, rel_l2, t

CFG = DiTConfig().tiny()
JCFG = JDiTConfig().tiny()


def _ties(rng, shape):
    """Values whose codes sit on .5 ties: each row (last axis) holds 127, so
    its scale is exactly 1, and then k + 0.5 for k in -10..9."""
    x = rng.standard_normal(shape).astype(np.float32) * 20.0
    x[..., 0] = 127.0
    x[..., 1:21] = np.arange(-10, 10) + 0.5
    return x


def _as(x, dtype):
    """(numpy fp32 holding `dtype`'s values, the JAX array, the port's tensor)."""
    if dtype == "bf16":
        j = jnp.asarray(x, jnp.bfloat16)
        return np.asarray(j, np.float32), j, torch.from_numpy(x).to(torch.bfloat16)
    return x, jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_weight_matches_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 40, 24)).astype(np.float32) * 0.1
    w[1] = np.swapaxes(_ties(rng, (24, 40)), 0, 1)  # one layer of ties, per output column
    w[2, :, 5] = 0.0  # an all-zero output channel
    _, jw, tw = _as(w, dtype)
    ref = jquant.quantize_weight(jw)
    got = tquant.quantize_weight(tw)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert tuple(got["q"].shape) == (3, 24, 40) and got["q"].is_contiguous()
    np.testing.assert_array_equal(got["q"].numpy(), np.swapaxes(np.asarray(ref["q"]), -1, -2))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(ref["s"]))
    assert tquant.out_dim(got) == tquant.out_dim(tw) == jquant.out_dim(ref) == 24
    if dtype == "fp32":  # the ties round half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
        q = got["q"][1, :, 1:21].numpy()
        np.testing.assert_array_equal(q[0], np.round(np.arange(-10, 10) + 0.5))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quant_rows_matches_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3.0
    h[0, 1] = 0.0  # an all-zero row
    h[1, :2] = _ties(rng, (2, 48))
    _, jh, th = _as(h, dtype)
    rq, rs = jquant.quant_rows(jh)
    q, s = tquant.quant_rows(th)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and tuple(s.shape) == (2, 5, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert not q[0, 1].any() and float(s[0, 1, 0]) == np.float32(1e-8) / np.float32(127.0)


def test_int8_gemm_plain_is_exact():
    """The plain version's int32 sums equal numpy's int64 ones, and its
    epilogue is float(acc) * (s_row * s_col)."""
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (7, 96)).astype(np.int8)
    w = rng.integers(-127, 128, (5, 96)).astype(np.int8)
    sr, sc = rng.random(7).astype(np.float32), rng.random(5).astype(np.float32)
    acc = tig.int8_gemm(t(a), t(sr), t(w), t(sc), torch.int32)
    np.testing.assert_array_equal(acc.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)
    out = tig.int8_gemm(t(a), t(sr), t(w), t(sc), torch.float32)
    np.testing.assert_array_equal(out.numpy(), acc.numpy().astype(np.float32)
                                  * (sr[:, None] * sc[None, :]))


def test_gemm_helpers_match_jax():
    """qdot, mm, proj_shared and swiglu_mlp_q, fp32, rel-L2 <= 1e-6."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 6, 32)).astype(np.float32)
    ws = [rng.standard_normal(kn).astype(np.float32) * 0.2
          for kn in ((32, 48), (32, 48), (48, 32))]
    jws = [jquant.quantize_weight(jnp.asarray(w)) for w in ws]
    tws = [tquant.quantize_weight(t(w)) for w in ws]
    jq, js = jquant.quant_rows(jnp.asarray(h))
    tq, ts = tquant.quant_rows(t(h))
    assert rel_l2(tquant.qdot(tq, ts, tws[0], torch.float32).numpy(),
                  jquant.qdot(jq, js, jws[0], jnp.float32)) <= 1e-6
    assert rel_l2(tquant.mm(t(h), tws[0]).numpy(), jquant.mm(jnp.asarray(h), jws[0])) <= 1e-6
    for got, ref in zip(tquant.proj_shared(t(h), tws[:2]),
                        jquant.proj_shared(jnp.asarray(h), jws[:2])):
        assert got.dtype == torch.float32 and rel_l2(got.numpy(), ref) <= 1e-6
    mlp_j = {"w1": jws[0], "w3": jws[1], "w2": jws[2]}
    mlp_t = {"w1": tws[0], "w3": tws[1], "w2": tws[2]}
    assert rel_l2(tquant.swiglu_mlp_q(t(h), mlp_t).numpy(),
                  jquant.swiglu_mlp_q(jnp.asarray(h), mlp_j)) <= 1e-6
    # plain leaves take the plain product
    assert torch.equal(tquant.mm(t(h), t(ws[0])), t(h) @ t(ws[0]))


@pytest.fixture(scope="module")
def bf16_params():
    jp = jax.jit(lambda k: jdit.init_dit_params(k, JCFG, dtype=jnp.bfloat16))(
        jax.random.PRNGKey(4))
    return jp, dit_params_from_numpy(np_tree(jp), CFG, device="cpu", dtype=torch.bfloat16)


def _leaves(tree, prefix=""):
    if tquant.is_quantized(tree):
        return {prefix[:-1]: tree}
    if isinstance(tree, dict):
        return {k: v for n, sub in tree.items() for k, v in _leaves(sub, f"{prefix}{n}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("encoders", [False, True])
def test_quantize_dit_params_both_routes(bf16_params, encoders):
    """The same leaves quantized as the JAX package quantizes them; a
    JAX-quantized tree carried over (int8 and fp32 whatever dtype asks, codes
    transposed to (…, N, K)) equals the port's quantization of the carried
    bf16 weights, bit for bit; the input tree is left as it was."""
    jp, tp = bf16_params
    jq = jquant.quantize_dit_params(jp, encoders=encoders)
    carried = dit_params_from_numpy(np_tree(jq), CFG, device="cpu", dtype=torch.bfloat16)
    own = tquant.quantize_dit_params(tp, encoders=encoders)
    ref_leaves, got_leaves, own_leaves = _leaves(np_tree(jq)), _leaves(carried), _leaves(own)
    assert set(ref_leaves) == set(got_leaves) == set(own_leaves)
    quantized = {k for k, v in ref_leaves.items() if jquant.is_quantized(v)}
    assert quantized == {k for k, v in own_leaves.items() if tquant.is_quantized(v)}
    assert ("blocks.attention.wk_text" in quantized) == encoders
    assert ("text_encoder.blocks.mlp.w2" in quantized) == encoders
    assert {"blocks.attention.wq", "blocks.mlp.w2"} <= quantized
    for k in quantized:
        for leaf in (got_leaves[k], own_leaves[k]):
            assert leaf["q"].dtype == torch.int8 and leaf["s"].dtype == torch.float32
            np.testing.assert_array_equal(leaf["q"].numpy(),
                                          np.swapaxes(ref_leaves[k]["q"], -1, -2))
            np.testing.assert_array_equal(leaf["s"].numpy(), ref_leaves[k]["s"])
    assert not tquant.is_quantized(tp["blocks"]["attention"]["wq"])


def _forward_inputs(seed):
    rng = np.random.default_rng(seed)
    b, seq, txt, spk = 2, 16, 12, 8
    return dict(
        x=rng.standard_normal((b, seq, CFG.latent_size)).astype(np.float32),
        t=np.full((b,), 0.7, np.float32),
        ids=rng.integers(0, CFG.text_vocab_size, (b, txt)).astype(np.int32),
        tmask=np.arange(txt)[None].repeat(b, 0) < np.array([[12], [9]]),
        spk=rng.standard_normal((b, spk, CFG.latent_size)).astype(np.float32),
        smask=np.ones((b, spk), bool))


@pytest.fixture(scope="module")
def fp32_params():
    jp = jax.jit(lambda k: jdit.init_dit_params(k, JCFG, dtype=jnp.float32))(
        jax.random.PRNGKey(5))
    return jp, dit_params_from_numpy(np_tree(jp), CFG, device="cpu")


@pytest.mark.parametrize("joint_uncond", [False, True])
@pytest.mark.parametrize("encoders", [False, True])
def test_int8_forward_matches_jax(fp32_params, encoders, joint_uncond):
    """KV caches (quantized context projections with encoders), the int8
    one-branch forward and the int8 CFG forward: rel-L2 <= 1e-3."""
    jp, tp = fp32_params
    jq = jquant.quantize_dit_params(jp, encoders=encoders)
    tq = tquant.quantize_dit_params(tp, encoders=encoders)
    d = _forward_inputs(6)
    jkt = jdit.get_kv_cache_text(jq, JCFG, jnp.asarray(d["ids"]), jnp.asarray(d["tmask"]))
    jks = jdit.get_kv_cache_speaker(jq, JCFG, jnp.asarray(d["spk"]))
    with torch.no_grad():
        tkt = tdit.get_kv_cache_text(tq, CFG, t(d["ids"]), t(d["tmask"]))
        tks = tdit.get_kv_cache_speaker(tq, CFG, t(d["spk"]))
        for got, ref in zip((*tkt, *tks), (*jkt, *jks)):
            assert rel_l2(got.numpy(), ref) <= 1e-3
        args = (t(d["x"]), t(d["t"]), t(d["tmask"]), t(d["smask"]), tkt, tks)
        got1 = tdit.dit_forward(tq, CFG, *args)
        got = tdit.dit_forward_cfg(tq, CFG, *args, joint_uncond=joint_uncond)
    jargs = (jnp.asarray(d["x"]), jnp.asarray(d["t"]), jnp.asarray(d["tmask"]),
             jnp.asarray(d["smask"]), jkt, jks)
    ref1 = jdit.dit_forward(jq, JCFG, *jargs)
    ref = jdit.dit_forward_cfg(jq, JCFG, *jargs, joint_uncond=joint_uncond)
    assert got.shape == ref.shape == (2 if joint_uncond else 3, 2, 16, CFG.latent_size)
    assert rel_l2(got1.numpy(), ref1) <= 1e-3
    assert rel_l2(got.numpy(), ref) <= 1e-3


@pytest.mark.parametrize("joint_uncond", [False, True])
def test_int8_forward_tracks_float(fp32_params, joint_uncond):
    """The int8 trunk against the fp32 one on the same caches: each branch
    within 5 % (rel-L2), the bound of the JAX package's own test."""
    _, tp = fp32_params
    tq = tquant.quantize_dit_params(tp)
    d = _forward_inputs(7)
    with torch.no_grad():
        kt = tdit.get_kv_cache_text(tp, CFG, t(d["ids"]), t(d["tmask"]))
        ks = tdit.get_kv_cache_speaker(tp, CFG, t(d["spk"]))
        args = (t(d["x"]), t(d["t"]), t(d["tmask"]), t(d["smask"]), kt, ks)
        ref = tdit.dit_forward_cfg(tp, CFG, *args, joint_uncond=joint_uncond).numpy()
        got = tdit.dit_forward_cfg(tq, CFG, *args, joint_uncond=joint_uncond).numpy()
    assert np.isfinite(got).all()
    rel = (np.linalg.norm(got - ref, axis=(-2, -1))
           / (np.linalg.norm(ref, axis=(-2, -1)) + 1e-12))
    assert np.all(rel < 0.05) and np.all(rel > 0), rel


def test_int8_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        tqr.quant_rows(torch.zeros(4, 8, device="meta"))
    a = torch.zeros(4, 16, dtype=torch.int8, device="meta")
    s = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tig.int8_gemm(a, s, a, s, torch.bfloat16)


def _grouped_operands(rng, m, k, ns):
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    sr = rng.random(m).astype(np.float32)
    ws = [(t(rng.integers(-127, 128, (n, k)).astype(np.int8)), t(rng.random(n).astype(np.float32)))
          for n in ns]
    return t(a), t(sr), ws


@pytest.mark.parametrize("ns", [(72,), (48, 48), (200, 128, 72, 203)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16])
def test_int8_gemm_grouped_equals_one_product_a_weight(ns, dtype):
    """int8_gemm_grouped's outputs, each its own tensor, equal int8_gemm once
    a weight bit for bit (unequal N, int32 sums and both float outputs)."""
    a, sr, ws = _grouped_operands(np.random.default_rng(len(ns)), 9, 48, ns)
    got = tig.int8_gemm_grouped(a, sr, ws, dtype)
    assert len(got) == len(ws)
    for out, (w, sc) in zip(got, ws):
        assert out.dtype == dtype and tuple(out.shape) == (9, w.shape[0])
        assert torch.equal(out, tig.int8_gemm(a, sr, w, sc, dtype))
    assert len({o.data_ptr() for o in got}) == len(got)


def test_int8_gemm_grouped_refuses_what_no_launch_takes():
    a, sr, ws = _grouped_operands(np.random.default_rng(7), 4, 32, (16,) * 5)
    with pytest.raises(ValueError, match="1 to 4 weights"):
        tig.int8_gemm_grouped(a, sr, [], torch.float32)
    with pytest.raises(ValueError, match="1 to 4 weights"):
        tig.int8_gemm_grouped(a, sr, ws, torch.float32)
    other_k = (t(np.zeros((16, 48), np.int8)), ws[0][1])
    with pytest.raises(ValueError, match="one K"):
        tig.int8_gemm_grouped(a, sr, [ws[0], other_k], torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        meta = torch.zeros(4, 32, dtype=torch.int8, device="meta")
        tig.int8_gemm_grouped(meta, torch.zeros(4, device="meta"),
                              [(torch.zeros(16, 32, dtype=torch.int8, device="meta"),
                                torch.zeros(16, device="meta"))], torch.float32)


@pytest.mark.parametrize("count", [2, 4, 6])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_proj_shared_grouped_matches_qdot_and_jax(count, dtype):
    """The grouped proj_shared (one quantization, launches of up to four
    weights) equals one qdot a weight bit for bit, and the JAX package's
    proj_shared (run op by op) bit for bit in fp32."""
    rng = np.random.default_rng(10 + count)
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ws = [rng.standard_normal((32, n)).astype(np.float32) * 0.2
          for n in (48, 24, 48, 40, 16, 48)[:count]]
    _, jh, th = _as(h, dtype)
    tws = [tquant.quantize_weight(t(w).to(th.dtype)) for w in ws]
    got = tquant.proj_shared(th, tws)
    q, s = tquant.quant_rows(th)
    for out, w in zip(got, tws):
        assert out.dtype == th.dtype and torch.equal(out, tquant.qdot(q, s, w, th.dtype))
    if dtype == "fp32":
        jws = [jquant.quantize_weight(jnp.asarray(w)) for w in ws]
        for out, ref in zip(got, jquant.proj_shared(jh, jws)):
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_int8_forward_launch_schedule(fp32_params, monkeypatch):
    """A layer of the int8 trunk makes four K4 calls (q/k/v/gate and w1/w3
    grouped, wo and w2 alone) and four K5 calls; the context K/V of each
    layer one grouped call when the encoders are quantized."""
    _, tp = fp32_params
    tq = tquant.quantize_dit_params(tp, encoders=True)
    calls = {"grouped": [], "single": 0, "rows": 0}
    grouped, single, rows = tquant.int8_gemm_grouped, tquant.int8_gemm, tquant.quant_rows

    def count_grouped(a, s, ws, dtype):
        calls["grouped"].append(len(ws))
        return grouped(a, s, ws, dtype)

    def count_single(*args):
        calls["single"] += 1
        return single(*args)

    def count_rows(h):
        calls["rows"] += 1
        return rows(h)

    monkeypatch.setattr(tquant, "int8_gemm_grouped", count_grouped)
    monkeypatch.setattr(tquant, "int8_gemm", count_single)
    monkeypatch.setattr(tquant, "quant_rows", count_rows)
    d = _forward_inputs(8)
    n = CFG.num_layers
    with torch.no_grad():
        kt = tdit.get_kv_cache_text(tq, CFG, t(d["ids"]), t(d["tmask"]))
        ks = tdit.get_kv_cache_speaker(tq, CFG, t(d["spk"]))
        enc = (CFG.text_num_layers + CFG.speaker_num_layers)
        assert calls["grouped"] == [4, 2] * CFG.text_num_layers + [2] * n + \
            [4, 2] * CFG.speaker_num_layers + [2] * n
        assert calls["single"] == 2 * enc and calls["rows"] == 4 * enc + 2 * n
        calls.update(grouped=[], single=0, rows=0)
        tdit.dit_forward_cfg(tq, CFG, t(d["x"]), t(d["t"]), t(d["tmask"]), t(d["smask"]), kt,
                             ks)
    assert calls["grouped"] == [4, 2] * n and calls["single"] == 2 * n
    assert calls["rows"] == 4 * n


@pytest.mark.parametrize("d,dtype,once", [
    (1280, torch.bfloat16, True), (2048, torch.bfloat16, True), (3328, torch.bfloat16, True),
    (5888, torch.bfloat16, True), (1280, torch.float32, True), (5888, torch.float32, True),
    (1000, torch.bfloat16, False), (7000, torch.bfloat16, False), (7000, torch.float32, False),
    (48, torch.float32, False)])
def test_quant_rows_reads_the_paths_widths_once(d, dtype, once):
    """K5 holds a row in registers (one read) at the four widths the trunk
    and the encoders quantize, in both types, and reads any other row twice."""
    assert tqr.one_read(d, dtype) == once
