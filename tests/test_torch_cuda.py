"""The port's CUDA kernels on the card (K1 joint attention and its log-sum-exp,
K2 residual units, K3 the attention backward, and the measurement variants
K1v, K2v-cl, K2v-cf, K2s; the bare checks of the attention and conv cores;
K1 and K2 at the streaming path's shapes and one stateful decode step, K1
and K2 at a continuous group's B=4 with one position a row, K1 with no
context segment or the latent one alone; the int8 kernels K4 (one weight,
grouped, every tile shape, its bare s8 core) and K5 bit for bit, and an int8
forward against bf16),
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


@pytest.mark.parametrize("visible", [0, 64], ids=["latent_all_masked", "latent_64_visible"])
@pytest.mark.parametrize("s", [64, 192])
def test_joint_attention_kernel_at_the_stream_shapes(cuda_device, s, visible):
    """The streaming CFG group: S=64 or 192 query rows (half a 128-row q
    tile, or one and a half), segments [latent 160 | text 768 | speaker 160
    at scale 1.5], branches split as dit_forward_cfg launches them (cond
    sees all three, the unconds drop text or speaker; none drops the
    latent). At the first block every latent key is masked in every branch:
    the kernel must add exact zeros there, so the output equals the launch
    without the latent segment bit for bit."""
    q, ks, vs, segs = _k1_inputs(cuda_device, 3, 1, s, 16, (160, 768, 160), 29,
                                 (None, None, 1.5))
    (kl, vl, ml, _), (kt, vt, mt, _), (kp, vp, mp, sp) = segs
    ml = (torch.arange(160, device=cuda_device) < visible).expand(3, 1, 160).contiguous()
    mt[1] = False
    mp[2] = False
    seg5 = [(kl, vl, ml, None, ()), (kt, vt, mt, None, (1,)), (kp, vp, mp, sp, (2,))]
    before = tja.joint_attention.launches
    got = tdit._joint_attention_grouped(q, ks, vs, seg5, layout="sm")
    assert tja.joint_attention.launches == before + 3
    ref = tja.joint_attention_plain(q.float(), ks.float(), vs.float(),
                                    _f32([sg[:4] for sg in seg5]), layout="sm")
    assert _rel(got, ref) < 2e-2
    if visible == 0:
        assert torch.equal(got, tdit._joint_attention_grouped(q, ks, vs, seg5[1:], layout="sm"))


@pytest.mark.parametrize("c,rows,ctx,zero_below", [
    (768, 32, 80, 48), (768, 64, 80, 16), (768, 2048, 80, 0), (384, 256, 80, 80),
    (768, 2048, 78, 46), (768, 2048, 78, 14), (96, 1024, 80, 47)])
def test_res_chain_kernel_at_the_stream_zero_below(cuda_device, c, rows, ctx, zero_below):
    """K2 as a streaming decode step runs it: on [tail | chunk], T = rows +
    ctx (no multiple of a tile), with zero_below anywhere from 0 to ctx
    (chain_ctx is 80: the first chain, at 32 rows a z_q frame, re-zeroes
    80, 48, 16, then 0 rows at frame positions 0, 1, 2, 3; 78, 46 and 14
    put the edge one row pair off); non-zero biases."""
    rng = np.random.default_rng(c + rows + zero_below)

    def bf(*shape, sc=1.0, lo=None):
        a = rng.uniform(lo, 1.5, shape) if lo is not None else rng.standard_normal(shape) * sc
        return torch.from_numpy(a.astype(np.float32)).to(cuda_device, torch.bfloat16)

    units = [{"snake1": bf(1, c, 1, lo=0.2), "snake2": bf(1, c, 1, lo=0.2),
              "conv1": {"w": bf(c, c, 7, sc=(7 * c) ** -0.5), "b": bf(c, sc=0.3)},
              "conv2": {"w": bf(c, c, 1, sc=c ** -0.5), "b": bf(c, sc=0.3)}} for _ in range(3)]
    x = bf(1, rows + ctx, c)
    x[:, :zero_below] = 0
    got = trc.res_units_cl(x, units, zero_below=zero_below)
    f32 = [{k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
            for k, v in u.items()} for u in units]
    ref = trc.res_chain_plain(x.float(), f32, zero_below=zero_below)
    assert _rel(got, ref) < 2e-2
    assert not got[0, :zero_below].any()
    assert _rel(got[0, zero_below:], ref[0, zero_below:]) < 2e-2


def test_stream_step_against_the_plain_chain(cuda_device):
    """Two stateful decode steps at full width (AEConfig(), bf16, non-zero
    residual biases): 1 frame, then 2 frames at position 1. Every K2 call
    matches the plain chain (fp32) on its own input, its zero_below rows
    are exactly zero, and the first chain's zero_below is 80 then 48."""
    from echo_tts_tpu_torch.bench.init_ae import init_ae_params
    from echo_tts_tpu_torch.core.config import AEConfig
    from echo_tts_tpu_torch.models import s1dac as ts1

    cfg = AEConfig()
    params = init_ae_params(cfg, torch.bfloat16, cuda_device, seed=3)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for blk in params["decoder"]["blocks"]:
        for u in blk["res_units"]:
            for cv in ("conv1", "conv2"):
                u[cv]["b"] = (0.3 * torch.randn(u[cv]["w"].shape[0], generator=gen,
                                                device=cuda_device)).to(torch.bfloat16)
    calls = []
    kernel = ts1.res_units_cl

    def checked(x, units, dilations=(1, 3, 9), *, zero_below=None):
        out = kernel(x, units, dilations, zero_below=zero_below)
        f32 = [{k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
                    else v.float()) for k, v in u.items()} for u in units]
        ref = trc.res_chain_plain(x.float(), f32, dilations, zero_below)
        calls.append((x.shape[2], zero_below, _rel(out, ref), bool(out[:, :zero_below].any())))
        return out

    z = (0.3 * torch.randn(1, cfg.latent_dim, 3, generator=gen, device=cuda_device)
         ).to(torch.bfloat16)
    state = ts1.streaming_decode_init(params, cfg, 1)
    ts1.res_units_cl = checked
    try:
        with torch.no_grad():
            a1, state = ts1.decode_zq_stream_step(params, cfg, state, z[:, :, :1])
            a2, state = ts1.decode_zq_stream_step(params, cfg, state, z[:, :, 1:])
    finally:
        ts1.res_units_cl = kernel
    assert a1.shape[-1] == cfg.frame_length and a2.shape[-1] == 2 * cfg.frame_length
    assert torch.isfinite(a1).all() and torch.isfinite(a2).all() and state["pos"] == 3
    assert len(calls) == 8
    assert [zb for ch, zb, _, _ in calls if ch == 768] == [80, 48]
    assert all(rel < 2e-2 and not dirty for _, _, rel, dirty in calls), calls


def test_joint_attention_kernel_at_b4_per_row(cuda_device):
    """A continuous group's CFG launch at B=4: one S=64 block a row, each
    row with its own latent-segment extent (0, 16, 64, 112 of 160 patches:
    rows at start_pos 0, 64, 256, 448) and its own self_len (64, 64, 40,
    0), text 768 and speaker 160 with their own masks, branches split as
    dit_forward_cfg launches them. Against the plain version; and each row
    of the B=4 launch equals that row launched alone, bit for bit (every
    block of the kernel is one row's)."""
    dev = cuda_device
    q, ks, vs, segs = _k1_inputs(dev, 3, 4, 64, 16, (160, 768, 160), 31, (None, None, 1.5))
    (kl, vl, _, _), (kt, vt, mt, _), (kp, vp, mp, sp) = segs
    vis = torch.tensor([0, 16, 64, 112], device=dev)
    ml = (torch.arange(160, device=dev)[None] < vis[:, None]).expand(3, 4, 160).contiguous()
    mt[1] = False
    mp[2] = False
    sl = torch.tensor([64, 64, 40, 0], dtype=torch.int32, device=dev)
    seg5 = [(kl, vl, ml, None, ()), (kt, vt, mt, None, (1,)), (kp, vp, mp, sp, (2,))]
    before = tja.joint_attention.launches
    got = tdit._joint_attention_grouped(q, ks, vs, seg5, layout="sm", self_len=sl)
    assert tja.joint_attention.launches == before + 3
    ref = tja.joint_attention_plain(q.float(), ks.float(), vs.float(),
                                    _f32([sg[:4] for sg in seg5]), layout="sm", self_len=sl)
    for b in range(4):
        assert _rel(got[:, b], ref[:, b]) < 2e-2, b
    for b in range(4):
        one = tdit._joint_attention_grouped(
            q[:, b:b + 1], ks[:, b:b + 1], vs[:, b:b + 1],
            [(k[b:b + 1], v[b:b + 1], m[:, b:b + 1], s, sk) for k, v, m, s, sk in seg5],
            layout="sm", self_len=sl[b:b + 1])
        assert torch.equal(got[:, b:b + 1], one), b


@pytest.mark.parametrize("c,rate", [(768, 32), (96, 2048)])
def test_res_chain_kernel_at_b4_per_row_zero_below(cuda_device, c, rate):
    """K2 as a continuous group's decode step runs it: four rows at z_q
    frame positions 0, 1, 2 and 64 on [tail | chunk] (2048 + 80 rows), each
    with its own zero_below clip(80 - pos * rate, 0, 80) (80, 48, 16, 0 on
    the first chain, 80, 0, 0, 0 on the last); non-zero biases. Against the plain chain, each row's re-zeroed
    rows exactly zero, and each row of the B=4 launch equal to that row
    launched alone, bit for bit."""
    rng = np.random.default_rng(c + rate)

    def bf(*shape, sc=1.0, lo=None):
        a = rng.uniform(lo, 1.5, shape) if lo is not None else rng.standard_normal(shape) * sc
        return torch.from_numpy(a.astype(np.float32)).to(cuda_device, torch.bfloat16)

    units = [{"snake1": bf(1, c, 1, lo=0.2), "snake2": bf(1, c, 1, lo=0.2),
              "conv1": {"w": bf(c, c, 7, sc=(7 * c) ** -0.5), "b": bf(c, sc=0.3)},
              "conv2": {"w": bf(c, c, 1, sc=c ** -0.5), "b": bf(c, sc=0.3)}} for _ in range(3)]
    zb = [min(max(80 - p * rate, 0), 80) for p in (0, 1, 2, 64)]
    x = bf(4, 2048 + 80, c)
    for b, z in enumerate(zb):
        x[b, :z] = 0
    zbt = torch.tensor(zb, dtype=torch.int32, device=cuda_device)
    got = trc.res_units_cl(x, units, zero_below=zbt)
    f32 = [{k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
            for k, v in u.items()} for u in units]
    ref = trc.res_chain_plain(x.float(), f32, zero_below=zbt)
    assert _rel(got, ref) < 2e-2
    for b, z in enumerate(zb):
        assert not got[b, :z].any()
        assert torch.equal(got[b:b + 1], trc.res_units_cl(x[b:b + 1].contiguous(), units,
                                                          zero_below=[z]))


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


# -- the joint-uncond shapes of K1, and the int8 kernels K4 and K5 ----------

@pytest.mark.parametrize("self_len", [None, (640, 203)], ids=["no_self_len", "self_len"])
@pytest.mark.parametrize("s", [64, 640])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("latent", [0, 160], ids=["no_context", "latent_alone"])
def test_joint_attention_kernel_with_no_context_segment(cuda_device, latent, g, s, self_len):
    """K1 as the joint-uncond branch launches it: no context segment (the
    one-shot path: text and speaker both skipped) or the latent segment
    alone (a stream), against the plain version."""
    b = 1 if self_len is None else 2
    q, ks, vs, segs = _k1_inputs(cuda_device, g, b, s, 16, (latent,) if latent else (), 31,
                                 (None,))
    sl = None if self_len is None else torch.tensor([min(x, s) for x in self_len],
                                                    dtype=torch.int32, device=cuda_device)
    before = tja.joint_attention.launches
    got = tja.joint_attention(q, ks, vs, segs, layout="sm", self_len=sl)
    assert tja.joint_attention.launches == before + 1
    ref = tja.joint_attention_plain(q.float(), ks.float(), vs.float(), _f32(segs), layout="sm",
                                    self_len=sl)
    assert _rel(got, ref) < 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("m,d", [(1920, 2048), (192, 5888), (37, 2048), (768, 1280), (1600, 3328),
                                 (37, 1000), (64, 7000)])
def test_quant_rows_kernel_matches_plain_bit_for_bit(cuda_device, m, d, dtype):
    """K5's codes and scales equal the plain version's (on the CPU: IEEE
    division, round half to even), an all-zero row included: the four
    widths the paths quantize (one read of a row) and two others (two)."""
    from echo_tts_tpu_torch.ops import quant_rows as tqr

    gen = torch.Generator(device=cuda_device).manual_seed(m + d)
    h = (torch.randn(m, d, generator=gen, device=cuda_device) * 3).to(dtype)
    h[1] = 0
    before = tqr.quant_rows.launches
    q, s = tqr.quant_rows(h)
    torch.cuda.synchronize()
    assert tqr.quant_rows.launches == before + 1
    rq, rs = tqr.quant_rows_plain(h.cpu())
    assert torch.equal(q.cpu(), rq) and torch.equal(s.cpu(), rs)


def _int8_case(device, m, k, ns, seed):
    from echo_tts_tpu_torch.models.quant import quantize_weight
    from echo_tts_tpu_torch.ops.quant_rows import quant_rows_plain

    gen = torch.Generator(device=device).manual_seed(seed)
    a, s_row = quant_rows_plain(torch.randn(m, k, generator=gen, device=device))
    ws = [quantize_weight((torch.rand(k, n, generator=gen, device=device) - 0.5) * k ** -0.5)
          for n in ns]
    return a, s_row.reshape(-1), [(w["q"], w["s"]) for w in ws]


_TRUNK = [(2048, 2048), (2048, 5888), (5888, 2048)]
_ENCODERS = [(1280, 1280), (1280, 3328), (3328, 1280), (1280, 2048)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [2048, 1000])
def test_quant_rows_kernel_at_half_integer_quotients(cuda_device, d, dtype):
    """K5 multiplies by 1 / s and divides only where the product lies within
    1e-4 of a half-integer: rows whose quotients sit on half-integers (s = 1:
    exact ties, half to even) or a few ulps from them still give the plain
    version's codes, in the one-read and the two-read instance."""
    from echo_tts_tpu_torch.ops import quant_rows as tqr

    gen = torch.Generator(device=cuda_device).manual_seed(d)
    m = 256
    amax = torch.rand(m, 1, generator=gen, device=cuda_device) * 10 + 0.01
    amax[: m // 2] = 127.0
    k = torch.randint(-127, 127, (m, d), generator=gen, device=cuda_device).float() + 0.5
    x = k * (amax / 127.0)
    for _ in range(2):
        step = torch.randint(-1, 2, (m, d), generator=gen, device=cuda_device).float()
        x = torch.where(step == 0, x, torch.nextafter(x, step * torch.inf))
    x[:, :1] = amax
    h = x.to(dtype)
    q, s = tqr.quant_rows(h)
    torch.cuda.synchronize()
    rq, rs = tqr.quant_rows_plain(h.cpu())
    assert torch.equal(q.cpu(), rq) and torch.equal(s.cpu(), rs)


@pytest.mark.parametrize("m,k,n", [(1920, 2048, 5888), (192, 5888, 2048), (1, 2048, 2048),
                                   (37, 1040, 200)]
                         + [(m, k, n) for m in (64, 576, 640, 2560, 7680) for k, n in _TRUNK]
                         + [(m, k, n) for m in (768, 1600) for k, n in _ENCODERS]
                         + [(640, 2064, 2048), (37, 1040, 203)])
def test_int8_gemm_kernel_matches_plain_bit_for_bit(cuda_device, m, k, n):
    """K4's int32 sums and its bf16 and fp32 outputs equal the plain
    version's (float64 sums, exact at these K): every M the int8 paths
    launch, the encoders' shapes, K a multiple of 16 and not of 128, an odd
    N."""
    from echo_tts_tpu_torch.ops import int8_gemm as tig

    a, s_row, ((w, s_col),) = _int8_case(cuda_device, m, k, (n,), m + k + n)
    for dtype in (torch.int32, torch.bfloat16, torch.float32):
        before = tig.int8_gemm.launches
        got = tig.int8_gemm(a, s_row, w, s_col, dtype)
        torch.cuda.synchronize()
        assert tig.int8_gemm.launches == before + 1
        assert torch.equal(got, tig.int8_gemm_plain(a, s_row, w, s_col, dtype))


@pytest.mark.parametrize("m,k,ns", [(m, 2048, (2048,) * 4) for m in (64, 192, 576, 1920, 7680)]
                         + [(m, 2048, (5888,) * 2) for m in (64, 576, 1920)]
                         + [(m, 1280, (2048,) * 2) for m in (768, 1600)]
                         + [(37, 1040, (200, 2048, 72, 203))])
def test_int8_gemm_grouped_kernel_matches_plain_bit_for_bit(cuda_device, m, k, ns):
    """One grouped K4 launch (q/k/v/gate, w1/w3, a context's k/v; four
    unequal N) equals the plain GEMM a weight, in every output type."""
    from echo_tts_tpu_torch.ops import int8_gemm as tig

    a, s_row, ws = _int8_case(cuda_device, m, k, ns, m + k + sum(ns))
    for dtype in (torch.int32, torch.bfloat16, torch.float32):
        before = tig.int8_gemm.launches
        got = tig.int8_gemm_grouped(a, s_row, ws, dtype)
        torch.cuda.synchronize()
        assert tig.int8_gemm.launches == before + 1
        for out, ref in zip(got, tig.int8_gemm_grouped_plain(a, s_row, ws, dtype)):
            assert torch.equal(out, ref)


@pytest.mark.parametrize("tile", [(128, 256), (128, 128), (64, 256), (64, 128)])
@pytest.mark.parametrize("m,k,ns", [(1920, 2048, (2048,)), (192, 5888, (2048,)),
                                    (37, 1040, (203,)), (576, 2048, (2048,) * 4)])
def test_int8_gemm_kernel_every_tile(cuda_device, tile, m, k, ns):
    """Each tile shape of K4, forced, gives the plain version's bits."""
    from echo_tts_tpu_torch.ops import int8_gemm as tig

    a, s_row, ws = _int8_case(cuda_device, m, k, ns, 7 + m + k)
    for dtype in (torch.int32, torch.bfloat16):
        got = tig.int8_gemm_grouped(a, s_row, ws, dtype, tile=tile)
        torch.cuda.synchronize()
        for out, ref in zip(got, tig.int8_gemm_grouped_plain(a, s_row, ws, dtype)):
            assert torch.equal(out, ref)


@pytest.mark.parametrize("use_tma", [False, True], ids=["threads", "tma"])
@pytest.mark.parametrize("n", [64, 128, 256])
def test_int8_core_products_match_int_mm(cuda_device, n, use_tma):
    """The s8 wgmma core bare on one tile (csrc/int8_core.cuh through
    int8_gemm.cu's check entry) equals torch._int_mm."""
    from echo_tts_tpu_torch.ops import int8_gemm as tig

    gen = torch.Generator(device=cuda_device).manual_seed(n)
    a = torch.randint(-127, 128, (64, 128), generator=gen, device=cuda_device, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, 128), generator=gen, device=cuda_device, dtype=torch.int8)
    got = tig.core_products_s8(a, b, use_tma)
    torch.cuda.synchronize()
    assert torch.equal(got, torch._int_mm(a, b.t().contiguous()))


def test_int8_wrappers_refuse_bad_inputs(cuda_device):
    from echo_tts_tpu_torch.ops import int8_gemm as tig
    from echo_tts_tpu_torch.ops import quant_rows as tqr

    a = torch.zeros(4, 40, dtype=torch.int8, device=cuda_device)
    s = torch.ones(4, device=cuda_device)
    before = (tig.int8_gemm.launches, tqr.quant_rows.launches)
    with pytest.raises(ValueError):
        tig.int8_gemm(a, s, a, s, torch.bfloat16)  # K not a multiple of 16
    with pytest.raises(TypeError):
        tig.int8_gemm(a[:, :32].float(), s, a[:, :32].contiguous(), s, torch.bfloat16)
    with pytest.raises(ValueError):
        w = torch.zeros(16, 4, dtype=torch.int8, device=cuda_device)
        tig.int8_gemm(a[:, :16].contiguous(), s, w.t(), s, torch.bfloat16)  # not contiguous
    with pytest.raises(ValueError):
        tqr.quant_rows(torch.zeros(4, 12, device=cuda_device))
    with pytest.raises(TypeError):
        tqr.quant_rows(a)
    with pytest.raises(RuntimeError, match="no backward"):
        tqr.quant_rows(torch.zeros(4, 16, device=cuda_device, requires_grad=True))
    a32 = torch.zeros(4, 64, dtype=torch.int8, device=cuda_device)
    w = (torch.zeros(16, 64, dtype=torch.int8, device=cuda_device),
         torch.ones(16, device=cuda_device))
    with pytest.raises(ValueError):
        tig.int8_gemm_grouped(a32, s, [w] * 5, torch.bfloat16)  # more than a launch takes
    with pytest.raises(ValueError):
        tig.int8_gemm_grouped(a32, s, [w, (w[0][:, :32].contiguous(), w[1])], torch.bfloat16)
    with pytest.raises(ValueError):
        tig.int8_gemm(a32, s, *w, torch.bfloat16, tile=(64, 64))  # no such instance
    assert (tig.int8_gemm.launches, tqr.quant_rows.launches) == before


def test_int8_forward_on_the_card_tracks_bf16(cuda_device):
    """A small DiT's joint-uncond CFG forward on the int8 trunk (K4 and K5,
    four K4 launches a layer: q/k/v/gate and w1/w3 grouped, wo, w2) tracks
    the bf16 forward within 5 % a branch, the bound of the JAX package's own
    test."""
    from echo_tts_tpu_torch.core.config import DiTConfig
    from echo_tts_tpu_torch.models.quant import quantize_dit_params
    from echo_tts_tpu_torch.ops import int8_gemm as tig

    cfg = DiTConfig(model_size=256, num_layers=2, num_heads=2, intermediate_size=512,
                    text_model_size=128, text_num_layers=1, text_num_heads=1,
                    text_intermediate_size=256, speaker_model_size=128, speaker_num_layers=1,
                    speaker_num_heads=1, speaker_intermediate_size=256, adaln_rank=16)
    p = tdit.init_dit_params(cfg, torch.bfloat16, cuda_device, seed=3)
    qp = quantize_dit_params(p)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(1, 64, cfg.latent_size, generator=gen, device=cuda_device).to(torch.bfloat16)
    t_b = torch.full((1,), 0.7, device=cuda_device).to(torch.bfloat16)
    ids = torch.randint(0, 256, (1, 32), generator=gen, device=cuda_device)
    tm = torch.ones(1, 32, dtype=torch.bool, device=cuda_device)
    spk = torch.randn(1, 32, cfg.latent_size, generator=gen, device=cuda_device).to(torch.bfloat16)
    sm = torch.ones(1, 32, dtype=torch.bool, device=cuda_device)
    with torch.no_grad():
        kt = tdit.get_kv_cache_text(p, cfg, ids, tm)
        ks = tdit.get_kv_cache_speaker(p, cfg, spk)
        before = tig.int8_gemm.launches
        got = tdit.dit_forward_cfg(qp, cfg, x, t_b, tm, sm, kt, ks, joint_uncond=True)
        assert tig.int8_gemm.launches - before == 4 * cfg.num_layers
        ref = tdit.dit_forward_cfg(p, cfg, x, t_b, tm, sm, kt, ks, joint_uncond=True)
    assert got.shape == (2, 1, 64, cfg.latent_size) and torch.isfinite(got).all()
    for i in range(2):
        assert _rel(got[i], ref[i]) < 5e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", [(1920, 1024), (1920, 2944), (768, 640), (1600, 1664),
                                 (37, 1000)])
def test_quant_rows_tp_modes_match_plain_bit_for_bit(cuda_device, m, d, dtype):
    """K5's scale-only and codes-at-a-scale modes at the widths of the
    row-sharded products at tp=2 (wo's K 1024 and w2's 2944 in the trunk,
    640 and 1664 in the encoders) and a ragged one: equal to the plain
    version bit for bit, an all-zero row included; codes at the max of two
    halves' scales equal the whole row's codes."""
    from echo_tts_tpu_torch.ops import quant_rows as tqr

    gen = torch.Generator(device=cuda_device).manual_seed(m + d)
    h = (torch.randn(m, 2 * d, generator=gen, device=cuda_device) * 3).to(dtype)
    h[1] = 0
    halves = [h[:, :d].contiguous(), h[:, d:].contiguous()]
    b_s, b_a = tqr.quant_rows_scale.launches, tqr.quant_rows_at.launches
    scales = [tqr.quant_rows_scale(x) for x in halves]
    s = torch.maximum(*scales)
    codes = [tqr.quant_rows_at(x, s) for x in halves]
    torch.cuda.synchronize()
    assert tqr.quant_rows_scale.launches == b_s + 2 and tqr.quant_rows_at.launches == b_a + 2
    for x, sx, qx in zip(halves, scales, codes):
        assert torch.equal(sx.cpu(), tqr.quant_rows_scale_plain(x.cpu()))
        assert torch.equal(qx.cpu(), tqr.quant_rows_at_plain(x.cpu(), s.cpu()))
    rq, rs = tqr.quant_rows_plain(h.cpu())
    assert torch.equal(s.cpu(), rs) and torch.equal(torch.cat(codes, 1).cpu(), rq)


@pytest.mark.parametrize("m,k,ns,dtype", [
    (1920, 2048, (1024,) * 4, torch.bfloat16),   # q/k/v/gate at tp=2
    (1920, 1024, (2048,), torch.int32),          # wo's partial sums
    (1920, 2048, (2944,) * 2, torch.bfloat16),   # w1/w3
    (1920, 2944, (2048,), torch.int32),          # w2's partial sums
    (768, 1280, (640,) * 4, torch.bfloat16),     # the encoders
    (768, 640, (1280,), torch.int32),
    (1600, 1280, (1664,) * 2, torch.bfloat16),
    (1600, 1664, (1280,), torch.int32)])
def test_int8_gemm_at_tp2_shapes_matches_plain(cuda_device, m, k, ns, dtype):
    """K4 at every (K, N) a tp=2 rank launches, in the type the path asks
    for (int32 for the row-sharded products), equal to the plain version."""
    from echo_tts_tpu_torch.ops import int8_gemm as tig

    a, s_row, ws = _int8_case(cuda_device, m, k, ns, m + k + sum(ns))
    got = tig.int8_gemm_grouped(a, s_row, ws, dtype)
    torch.cuda.synchronize()
    for out, ref in zip(got, tig.int8_gemm_grouped_plain(a, s_row, ws, dtype)):
        assert torch.equal(out, ref)
