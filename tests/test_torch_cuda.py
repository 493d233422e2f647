"""The port's CUDA kernels on the card (K1 joint attention and its log-sum-exp,
K2 residual units, K3 the attention backward, and the measurement variants
K1v, K2v-cl, K2v-cf, K2s; the bare checks of the attention and conv cores),
each against its plain
PyTorch version in fp32 on the same bf16 inputs (rel-L2 < 2e-2: bf16
rounding gives ~1e-3, a wrong kernel O(1)). Every test needs a CUDA card and skips without one. The
file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from echo_tts_tpu_torch.bench import conv_kernel_variants as bcv
from echo_tts_tpu_torch.models import dit as tdit
from echo_tts_tpu_torch.ops import attention_variants as tav
from echo_tts_tpu_torch.ops import joint_attention as tja
from echo_tts_tpu_torch.ops import res_chain as trc
from echo_tts_tpu_torch.ops import res_chain_variants as trv

from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def _rel(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


def _k1_inputs(dev, g, b, s, h, seg_lens, seed, scales):
    rng = np.random.default_rng(seed)

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            dev, torch.bfloat16)

    q, ks, vs = bf(g, b, s, h, 128), bf(g, b, s, h, 128), bf(g, b, s, h, 128)
    segs = [(bf(b, h, t, 128), bf(b, h, t, 128),
             torch.from_numpy(rng.random((g, b, t)) < 0.8).to(dev), sc)
            for t, sc in zip(seg_lens, scales)]
    return q, ks, vs, segs


def _f32(segs):
    return [(k.float(), v.float(), m, s) for k, v, m, s in segs]


def test_joint_attention_kernel_matches_plain(cuda_device):
    """Seq-major G=3, B=2, unaligned S, a T=1 segment, a speaker scale and
    per-row self_len."""
    q, ks, vs, segs = _k1_inputs(cuda_device, 3, 2, 100, 4, (200, 1), 13, (None, 1.5))
    sl = torch.tensor([100, 37], dtype=torch.int32, device=cuda_device)
    before = tja.joint_attention.launches
    got = tja.joint_attention(q, ks, vs, segs, layout="sm", self_len=sl)
    assert tja.joint_attention.launches == before + 1
    ref = tja.joint_attention_plain(q.float(), ks.float(), vs.float(), _f32(segs),
                                    layout="sm", self_len=sl)
    assert _rel(got, ref) < 2e-2


def test_branch_split_on_the_card(cuda_device):
    """dit._joint_attention_grouped's per-branch launches (each without its
    fully masked segment) against the mask-only plain version."""
    q, ks, vs, segs = _k1_inputs(cuda_device, 3, 1, 64, 2, (96, 160), 7, (None, 1.3))
    (k1, v1, m1, s1), (k2, v2, m2, s2) = segs
    m1[1] = False
    m2[2] = False
    before = tja.joint_attention.launches
    got = tdit._joint_attention_grouped(
        q, ks, vs, [(k1, v1, m1, s1, (1,)), (k2, v2, m2, s2, (2,))], layout="sm")
    assert tja.joint_attention.launches == before + 3
    ref = tja.joint_attention_plain(q.float(), ks.float(), vs.float(),
                                    _f32([(k1, v1, m1, s1), (k2, v2, m2, s2)]), layout="sm")
    assert _rel(got, ref) < 2e-2


def test_attention_core_products_match_matmul(cuda_device):
    """The shared core's two wgmma products on one tile, keys as (T, D) and
    as (D, T), against torch.matmul."""
    from echo_tts_tpu_torch.ops import attention_core as tac

    rng = np.random.default_rng(3)
    a, b, v = (torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).to(
        cuda_device, torch.bfloat16) for _ in range(3))
    for b_transposed in (False, True):
        bb = b.t().contiguous() if b_transposed else b
        s_ref, o_ref = tac.core_products_plain(a, bb, v, 0.05, b_transposed)
        for a_from_registers in (False, True):
            s, o = tac.core_products(a, bb, v, 0.05, b_transposed, a_from_registers)
            assert _rel(s, s_ref) < 1e-5      # fp32 sums of exact bf16 products
            assert _rel(o, o_ref) < 5e-3      # a weight on a bf16 rounding edge may differ


K1_RAGGED = {
    # g, b, s, h, segment lengths, scales, all-masked segments, self_len
    "s200_t700_t1": (3, 2, 200, 4, (700, 1), (None, 1.5), (1,), None),
    "self_len_inside_a_tile": (1, 2, 200, 4, (160,), (None,), (), (200, 77)),
    "s200_three_segments": (2, 1, 200, 4, (300, 52, 7), (None, 1.5, 0.5), (), None),
    "training_shape_b8": (1, 8, 640, 16, (768, 160), (None, 1.5), (), None),
}


@pytest.mark.parametrize("tq", [64, 128])
@pytest.mark.parametrize("layout", ["sm", "hm"])
@pytest.mark.parametrize("case", sorted(K1_RAGGED))
def test_joint_attention_kernel_at_ragged_shapes(cuda_device, case, layout, tq):
    """K1 with one and with two consumer warpgroups, seq-major and
    head-major, writing into a view of a larger buffer, with its
    log-sum-exp; then branch by branch on q[i:i+1] slices into out[i:i+1]."""
    g, b, s, h, seg_lens, scales, masked, sl = K1_RAGGED[case]
    q, ks, vs, segs = _k1_inputs(cuda_device, g, b, s, h, seg_lens, 41, scales)
    segs = [(k, v, torch.zeros_like(m) if i in masked else m, sc)
            for i, (k, v, m, sc) in enumerate(segs)]
    if layout == "hm":
        q, ks, vs = (x.transpose(2, 3).contiguous() for x in (q, ks, vs))
    if sl is not None:
        sl = torch.tensor(sl, dtype=torch.int32, device=cuda_device)
    ref = tja.joint_attention_plain(q.float(), ks.float(), vs.float(), _f32(segs), layout, sl)
    buf = torch.full((g + 2, *q.shape[1:]), 7.0, dtype=torch.bfloat16, device=cuda_device)
    lse = torch.empty((g, b, h, s), dtype=torch.float32, device=cuda_device)
    tja._joint_attention_cuda(q, ks, vs, segs, layout, sl, buf[1:g + 1], lse, tq)
    assert _rel(buf[1:g + 1], ref) < 2e-2
    assert (buf[0] == 7.0).all() and (buf[-1] == 7.0).all()
    qh, kh = (x.float().transpose(2, 3) if layout == "sm" else x.float() for x in (q, ks))
    l_self = torch.einsum("gbhsd,gbhtd->gbhst", qh, kh) / np.sqrt(128)
    if sl is not None:
        keep = torch.arange(s, device=cuda_device)[None] < sl[:, None]
        l_self = l_self.masked_fill(~keep[None, :, None, None, :], -1e30)
    logits = [l_self]
    for k, _, m, sc in segs:
        l_seg = torch.einsum("gbhsd,bhtd->gbhst", qh, k.float()) / np.sqrt(128) * (sc or 1.0)
        logits.append(l_seg.masked_fill(~m[:, :, None, None, :], -1e30))
    assert float((lse - torch.logsumexp(torch.cat(logits, -1), -1) / np.log(2.0)).abs().max()) < 2e-2
    split = torch.empty_like(q)
    for i in range(g):
        tja._joint_attention_cuda(q[i:i + 1], ks[i:i + 1], vs[i:i + 1],
                                  [(k, v, m[i:i + 1], sc) for k, v, m, sc in segs], layout, sl,
                                  split[i:i + 1], None, tq)
    assert _rel(split, ref) < 2e-2


def test_conv_core_tap_product_matches_matmul(cuda_device):
    """The conv core's shifted-descriptor product on one tile (the strip
    window, the bulk-copied weight ring, every product width it has) at
    d = 1, 3, 9 and row offsets that are no multiple of 8, against
    torch.matmul: fp32 sums of exact bf16 products."""
    from echo_tts_tpu_torch.ops import conv_core as tcc

    rng = np.random.default_rng(5)
    for n in tcc.CHECK_N:
        for d in (1, 3, 9):
            for row0 in (0, 5):
                y, w = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
                    cuda_device, torch.bfloat16)
                    for shape in ((row0 + 64 + 6 * d + 3, 64), (7, 64, n)))
                assert _rel(tcc.tap_product(y, w, row0, d),
                            tcc.tap_product_plain(y, w, row0, d)) < 1e-5


@pytest.mark.parametrize("c,zero_below", [(64, [0, 80]), (96, [80, 7]), (128, 13),
                                          (192, [5, 300]), (256, 80), (384, [80, 0]),
                                          (512, 41), (768, [13, 80])])
def test_res_chain_kernel_matches_plain(cuda_device, c, zero_below):
    """K2 at every width the S1-DAC stacks have, B=2, a length that is no
    multiple of a tile, non-zero biases, zero_below scalar and per row: one
    launch a unit."""
    rng = np.random.default_rng(c)

    def bf(*shape, s=1.0, lo=None):
        a = rng.uniform(lo, 1.5, shape) if lo is not None else rng.standard_normal(shape) * s
        return torch.from_numpy(a.astype(np.float32)).to(cuda_device, torch.bfloat16)

    units = [{"snake1": bf(1, c, 1, lo=0.2), "snake2": bf(1, c, 1, lo=0.2),
              "conv1": {"w": bf(c, c, 7, s=(7 * c) ** -0.5), "b": bf(c, s=0.3)},
              "conv2": {"w": bf(c, c, 1, s=c ** -0.5), "b": bf(c, s=0.3)}} for _ in range(3)]
    x = bf(2, 1003, c)
    before = trc.res_units_cl.launches
    got = trc.res_units_cl(x, units, zero_below=zero_below)
    assert trc.res_units_cl.launches == before + 3
    f32 = [{k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
            for k, v in u.items()} for u in units]
    ref = trc.res_chain_plain(x.float(), f32, zero_below=zero_below)
    assert _rel(got, ref) < 2e-2
    rows = np.broadcast_to(np.asarray(zero_below), (2,))
    for i, n in enumerate(rows):
        assert not got[i, :n].any()


def test_wrappers_refuse_bad_inputs(cuda_device):
    """On the card a wrong dtype or layout raises; it never runs the plain
    version and launches nothing."""
    q = torch.zeros(1, 1, 64, 2, 128, device=cuda_device, dtype=torch.bfloat16)
    k1, k2 = tja.joint_attention.launches, trc.res_units_cl.launches
    with pytest.raises(TypeError):
        tja.joint_attention(q.float(), q, q, [], layout="sm")
    with pytest.raises(ValueError):
        tja.joint_attention(q.transpose(3, 4), q, q, [], layout="sm")
    x = torch.zeros(1, 64, 96, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        trc.res_units_cl(x.float(), [])
    with pytest.raises(ValueError):
        trc.res_units_cl(x.transpose(1, 2), [])
    assert (tja.joint_attention.launches, trc.res_units_cl.launches) == (k1, k2)


def _k3_inputs(dev, g, b, s, h, seg_lens, scales, seed, all_masked=()):
    q, ks, vs, segs = _k1_inputs(dev, g, b, s, h, seg_lens, seed, scales)
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        q.shape).astype(np.float32)).to(dev, torch.bfloat16)
    segs = [(k, v, torch.zeros_like(m) if i in all_masked else m, sc)
            for i, (k, v, m, sc) in enumerate(segs)]
    return q, ks, vs, do, segs


def test_joint_attention_lse_matches_plain(cuda_device):
    """K1's optional output: each row's base-2 log-sum-exp of the logits."""
    q, ks, vs, segs = _k1_inputs(cuda_device, 2, 2, 100, 2, (200, 1), 5, (None, 1.5))
    lse = torch.empty((2, 2, 2, 100), dtype=torch.float32, device=cuda_device)
    tja._joint_attention_cuda(q, ks, vs, segs, "sm", None, None, lse)
    qh, kh = q.float().transpose(2, 3), ks.float().transpose(2, 3)
    logits = [torch.einsum("gbhsd,gbhtd->gbhst", qh, kh) / np.sqrt(128)]
    for k, _, m, sc in segs:
        l_seg = torch.einsum("gbhsd,bhtd->gbhst", qh, k.float()) / np.sqrt(128) * (sc or 1.0)
        logits.append(l_seg.masked_fill(~m[:, :, None, None, :], -1e30))
    ref = torch.logsumexp(torch.cat(logits, -1), -1) / np.log(2.0)
    assert float((lse - ref).abs().max()) < 2e-2


K3_RAGGED = {
    # g, b, s, h, segment lengths, scales, all-masked segments
    "s100_t200_t1": (3, 2, 100, 2, (200, 1), (None, 1.5), (1,)),
    "g3_t700_t1": (3, 2, 200, 2, (700, 1), (None, 1.5), (1,)),
    # one past a 128-row q tile of pass A and a 128-key tile of pass B
    "s130_t129": (1, 2, 130, 2, (129,), (1.5,), ()),
    "training_shape_b8": (1, 8, 640, 16, (768, 160), (None, 1.5), ()),
}


@pytest.mark.parametrize("layout", ["sm", "hm"])
@pytest.mark.parametrize("case", sorted(K3_RAGGED))
def test_joint_attention_bwd_kernel_matches_plain(cuda_device, case, layout):
    """K3 at the edges of its tiles (unaligned S and T, T=1 all-masked, a
    speaker scale), seq-major and head-major; every gradient against the
    fp32 plain backward, the all-masked segment's dk/dv exactly zero."""
    g, b, s, h, seg_lens, scales, masked = K3_RAGGED[case]
    q, ks, vs, do, segs = _k3_inputs(cuda_device, g, b, s, h, seg_lens, scales, 17,
                                     all_masked=masked)
    if layout == "hm":
        q, ks, vs, do = (x.transpose(2, 3).contiguous() for x in (q, ks, vs, do))
    lse = torch.empty((g, b, h, s), dtype=torch.float32, device=cuda_device)
    out = tja._joint_attention_cuda(q, ks, vs, segs, layout, None, None, lse)
    before = tja.joint_attention_bwd.launches
    got = tja.joint_attention_bwd(q, ks, vs, segs, do, layout, out=out, lse=lse)
    assert tja.joint_attention_bwd.launches == before + 1
    ref = tja.joint_attention_bwd_plain(q.float(), ks.float(), vs.float(), _f32(segs),
                                        do.float(), layout)
    for i, (g_, r_) in enumerate(zip([*got[:3], *got[3]], [*ref[:3], *ref[3]])):
        if i >= 3 and (i - 3) // 2 in masked:
            assert not g_.any()  # the all-masked segment
        else:
            assert _rel(g_, r_) < 2e-2


def test_trainable_attention_on_the_card(cuda_device):
    """autograd through joint_attention_trainable: K1 forward, K3 backward,
    one launch each, gradients of every input against the plain backward."""
    q, ks, vs, do, segs = _k3_inputs(cuda_device, 1, 2, 72, 2, (96, 20), (None, 1.5), 23)
    inputs = [x.clone().requires_grad_() for x in (q, ks, vs, segs[0][0], segs[0][1],
                                                    segs[1][0], segs[1][1])]
    k1, k3 = tja.joint_attention.launches, tja.joint_attention_bwd.launches
    out = tja.joint_attention_trainable(
        inputs[0], inputs[1], inputs[2],
        [(inputs[3], inputs[4], segs[0][2], None), (inputs[5], inputs[6], segs[1][2], 1.5)],
        layout="sm")
    grads = torch.autograd.grad(out, inputs, grad_outputs=do)
    assert (tja.joint_attention.launches, tja.joint_attention_bwd.launches) == (k1 + 1, k3 + 1)
    ref = tja.joint_attention_bwd_plain(q.float(), ks.float(), vs.float(), _f32(segs),
                                        do.float(), "sm")
    for g_, r_ in zip(grads, [*ref[:3], *ref[3]]):
        assert _rel(g_, r_) < 2e-2


def test_inference_kernels_refuse_grad_on_the_card(cuda_device):
    q = torch.zeros(1, 1, 64, 2, 128, device=cuda_device, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="joint_attention_trainable"):
        tja.joint_attention(q, q, q, [], layout="sm")
    x = torch.zeros(1, 64, 96, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        trc.res_units_cl(x, [])


# ---------------------------------------------------------------------------
# the measurement variants
# ---------------------------------------------------------------------------


def _var_inputs(dev, g, b, h, s, seg_lens, seed, all_masked=()):
    """Head-major q/k/v (G, B, H, S, 128) and segments with bool masks."""
    rng = np.random.default_rng(seed)

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            dev, torch.bfloat16)

    q, ks, vs = bf(g, b, h, s, 128), bf(g, b, h, s, 128), bf(g, b, h, s, 128)
    segs = []
    for i, t in enumerate(seg_lens):
        mask = torch.from_numpy(rng.random((g, b, t)) < 0.8).to(dev)
        segs.append((bf(b, h, t, 128), bf(b, h, t, 128),
                     torch.zeros_like(mask) if i in all_masked else mask))
    return q, ks, vs, segs


@pytest.mark.parametrize("flags", [
    dict(tq=64, mask_mode="where"),
    dict(tq=128, mask_mode="bias", use_exp2=True),
    dict(tq=64, mask_mode="arith", hg=2, block_order="g_outer"),
    dict(tq=64, mask_mode="bias", k_t=True),
    dict(tq=128, mask_mode="bias", use_exp2=True, probe="fold"),
    dict(tq=64, mask_mode="none", probe="dots"),
], ids=["where", "bias-exp2-tq128", "arith-hg2-g_outer", "k_t", "fold", "dots-none"])
def test_attention_var_kernel_matches_plain(cuda_device, flags):
    """Ragged: S and T no multiples of a tile, a T=1 all-masked segment."""
    q, ks, vs, segs = _var_inputs(cuda_device, 3, 2, 4, 200, (300, 1), 31, all_masked=(1,))
    k_t = flags.get("k_t", False)

    def key(k):
        return k.transpose(-1, -2).contiguous() if k_t else k

    before = tav.attention_var.launches
    got = tav.attention_var(q, key(ks), vs, [(key(k), v, m) for k, v, m in segs], **flags)
    assert tav.attention_var.launches == before + 1
    ref = tav.attention_var_plain(q.float(), key(ks).float(), vs.float(),
                                  [(key(k).float(), v.float(), m) for k, v, m in segs], **flags)
    assert _rel(got, ref) < 2e-2
    if flags.get("probe", "full") != "dots" and flags["mask_mode"] != "none":
        # the all-masked segment carries exactly zero weight
        without = tav.attention_var(q, key(ks), vs, [(key(k), v, m) for k, v, m in segs[:1]],
                                    **flags)
        assert torch.equal(got, without)


@pytest.mark.parametrize("tq", [64, 128])
@pytest.mark.parametrize("flags", [
    dict(mask_mode="bias", use_exp2=True),
    dict(mask_mode="where", probe="fold"),
    dict(mask_mode="arith", k_t=True),
    dict(mask_mode="none", probe="dots"),
    dict(mask_mode="where", k_t=True, probe="fold", hg=2),
], ids=["full-bias-exp2", "fold-where", "k_t-arith", "dots-none", "k_t-fold-hg2"])
def test_attention_var_kernel_at_the_ragged_shape(cuda_device, flags, tq):
    """The CPU tests' ragged shape with a T=700 segment (transposed keys
    whose rows are not 16-byte aligned) and the T=1 all-masked one."""
    q, ks, vs, segs = _var_inputs(cuda_device, 3, 2, 4, 200, (700, 1), 43, all_masked=(1,))
    k_t = flags.get("k_t", False)

    def key(k):
        return k.transpose(-1, -2).contiguous() if k_t else k

    got = tav.attention_var(q, key(ks), vs, [(key(k), v, m) for k, v, m in segs], tq=tq, **flags)
    ref = tav.attention_var_plain(q.float(), key(ks).float(), vs.float(),
                                  [(key(k).float(), v.float(), m) for k, v, m in segs], tq=tq,
                                  **flags)
    assert torch.isfinite(got.float()).all() and _rel(got, ref) < 2e-2


def test_attention_var_noav_kernel_matches_plain(cuda_device):
    """The noav probe needs 128 keys in every block."""
    q, ks, vs, segs = _var_inputs(cuda_device, 2, 1, 2, 200, (300, 130), 37)
    got = tav.attention_var(q, ks, vs, segs, tq=64, mask_mode="bias", probe="noav")
    ref = tav.attention_var_plain(q.float(), ks.float(), vs.float(),
                                  [(k.float(), v.float(), m) for k, v, m in segs], tq=64,
                                  mask_mode="bias", probe="noav")
    assert _rel(got, ref) < 2e-2
    with pytest.raises(ValueError, match="needs at least"):
        tav.attention_var(q, ks, vs, [(k[:, :, :100], v[:, :, :100], m[..., :100])
                                      for k, v, m in segs], tq=64, probe="noav")


def _chain_units(dev, c, seed, t=1003):
    rng = np.random.default_rng(seed)

    def bf(*shape, s=1.0, lo=None):
        a = rng.uniform(lo, 1.5, shape) if lo is not None else rng.standard_normal(shape) * s
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)

    units = [{"snake1": bf(1, c, 1, lo=0.2), "snake2": bf(1, c, 1, lo=0.2),
              "conv1": {"w": bf(c, c, 7, s=(7 * c) ** -0.5), "b": bf(c, s=0.3)},
              "conv2": {"w": bf(c, c, 1, s=c ** -0.5), "b": bf(c, s=0.3)}} for _ in range(3)]
    f32 = [{k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
            for k, v in u.items()} for u in units]
    return units, f32, bf(2, t, c)


@pytest.mark.parametrize("c,flags", [
    (96, dict(use_sin="poly")),
    (192, dict(use_sin=True, live_mode="mult")),
    (96, dict(use_sin="poly", pack_taps=True)),
    (192, dict(use_sin=False, live_mode="off", tile_t=48)),
    (96, dict(use_sin=True, snake_dtype=torch.bfloat16)),
    (96, dict(use_sin="poly", tap_offsets=False)),
], ids=["poly", "sin-mult-c192", "packed", "off-no-sin-tile48-c192", "bf16-snake", "taps-at-0"])
def test_res_chain_variant_kernel_matches_plain(cuda_device, c, flags):
    """K2v-cl at B=2 and a length that is no multiple of any tile."""
    units, f32, x = _chain_units(cuda_device, c, c)
    before = trv.res_chain.launches
    got = trv.res_chain(x, units, **flags)
    assert trv.res_chain.launches == before + 1
    assert _rel(got, trv.res_chain_plain(x.float(), f32, **flags)) < 2e-2


@pytest.mark.parametrize("t", [1003, 1000], ids=["T%8=3", "T%8=0"])
@pytest.mark.parametrize("c", [96, 192])
def test_res_chain_cf_kernel_matches_plain_and_channels_last(cuda_device, c, t):
    """K2v-cf at B=2 with channel rows that are not 16-byte aligned (T=1003:
    loads and stores one bf16 at a time) and that are (T=1000)."""
    units, f32, x = _chain_units(cuda_device, c, c + 1, t=t)
    xcf = x.transpose(1, 2).contiguous()
    before = trv.res_chain_cf.launches
    got = trv.res_chain_cf(xcf, units)
    assert trv.res_chain_cf.launches == before + 1
    assert _rel(got, trv.res_chain_cf_plain(xcf.float(), f32)) < 2e-2
    assert _rel(got.transpose(1, 2), trv.res_chain(x, units, live_mode="mult")) < 2e-2


CF_ROWS = [(c, name, kw) for c in (192, 96) for name, kw in bcv.cf_rows(c)]


@pytest.mark.parametrize("c,name,kw", CF_ROWS, ids=[f"c{c} {n}" for c, n, _ in CF_ROWS])
def test_res_chain_cf_kernel_at_the_entry_points_rows(cuda_device, c, name, kw):
    """Every row of bench/conv_kernel_variants.py:cf_rows, its time tiles
    included, at B=2 and T=1003."""
    units, f32, x = _chain_units(cuda_device, c, 7)
    xcf = x.transpose(1, 2).contiguous()
    got = trv.res_chain_cf(xcf, units, **kw)
    assert _rel(got, trv.res_chain_cf_plain(xcf.float(), f32, **kw)) < 2e-2


@pytest.mark.parametrize("c", [96, 192])
@pytest.mark.parametrize("mode", ["exact", "none", "poly"])
def test_res_chain_snake_kernel_matches_plain(cuda_device, mode, c):
    units, f32, x = _chain_units(cuda_device, c, 5)
    before = trv.res_chain_snake.launches
    got = trv.res_chain_snake(x, units, mode)
    assert trv.res_chain_snake.launches == before + 1
    assert _rel(got, trv.res_chain_snake_plain(x.float(), f32, mode)) < 2e-2
    if mode == "poly":  # the Taylor cosine is the exact snake to fp32 rounding
        assert _rel(got, trv.res_chain_snake(x, units, "exact")) < 2e-2


def test_variant_wrappers_refuse_bad_inputs(cuda_device):
    """Wrong dtype, stride, width, tile or grad raises and launches nothing."""
    q = torch.zeros(1, 1, 2, 64, 128, device=cuda_device, dtype=torch.bfloat16)
    units, _, x = _chain_units(cuda_device, 96, 1)
    wrappers = (tav.attention_var, trv.res_chain, trv.res_chain_cf, trv.res_chain_snake)
    before = [w.launches for w in wrappers]
    with pytest.raises(TypeError):
        tav.attention_var(q.float(), q, q, [], tq=64)
    with pytest.raises(ValueError):
        tav.attention_var(q.transpose(3, 4), q, q, [], tq=64)
    with pytest.raises(ValueError):
        tav.attention_var(q, q, q, [], tq=320)
    with pytest.raises(RuntimeError, match="no backward"):
        tav.attention_var(q.clone().requires_grad_(), q, q, [], tq=64)
    for call in (lambda v: trv.res_chain(v, units), lambda v: trv.res_chain_cf(v, units),
                 lambda v: trv.res_chain_snake(v, units, "exact")):
        with pytest.raises(TypeError):
            call(x.float())
        with pytest.raises(ValueError):
            call(x.transpose(1, 2))
        with pytest.raises(RuntimeError, match="no backward"):
            call(x.clone().requires_grad_())
    with pytest.raises(ValueError):
        trv.res_chain(x[..., :64].contiguous(), units)
    with pytest.raises(ValueError):
        trv.res_chain(x, units, tile_t=4096)
    assert [w.launches for w in wrappers] == before
