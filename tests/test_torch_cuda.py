"""The port's CUDA kernels on the card (K1 joint attention and its log-sum-exp,
K2 residual units, K3 the attention backward), each against its plain
PyTorch version in fp32 on the same bf16 inputs (rel-L2 < 2e-2: bf16
rounding gives ~1e-3, a wrong kernel O(1)). Every test needs a CUDA card and skips without one. The
file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from echo_tts_tpu_torch.models import dit as tdit
from echo_tts_tpu_torch.ops import joint_attention as tja
from echo_tts_tpu_torch.ops import res_chain as trc

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


@pytest.mark.parametrize("c,zero_below", [(96, [80, 7]), (64, 80)])
def test_res_chain_kernel_matches_plain(cuda_device, c, zero_below):
    rng = np.random.default_rng(c)

    def bf(*shape, s=1.0, lo=None):
        a = rng.uniform(lo, 1.5, shape) if lo is not None else rng.standard_normal(shape) * s
        return torch.from_numpy(a.astype(np.float32)).to(cuda_device, torch.bfloat16)

    units = [{"snake1": bf(1, c, 1, lo=0.2), "snake2": bf(1, c, 1, lo=0.2),
              "conv1": {"w": bf(c, c, 7, s=(7 * c) ** -0.5), "b": bf(c, s=0.3)},
              "conv2": {"w": bf(c, c, 1, s=c ** -0.5), "b": bf(c, s=0.3)}} for _ in range(3)]
    x = bf(2, 1000, c)
    before = trc.res_units_cl.launches
    got = trc.res_units_cl(x, units, zero_below=zero_below)
    assert trc.res_units_cl.launches == before + 6
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


def test_joint_attention_bwd_kernel_matches_plain(cuda_device):
    """K3: G=3, B=2, unaligned S, a T=1 all-masked segment and a speaker
    scale; every gradient against the fp32 plain backward."""
    q, ks, vs, do, segs = _k3_inputs(cuda_device, 3, 2, 100, 2, (200, 1), (None, 1.5), 17,
                                     all_masked=(1,))
    lse = torch.empty((3, 2, 2, 100), dtype=torch.float32, device=cuda_device)
    out = tja._joint_attention_cuda(q, ks, vs, segs, "sm", None, None, lse)
    before = tja.joint_attention_bwd.launches
    got = tja.joint_attention_bwd(q, ks, vs, segs, do, "sm", out=out, lse=lse)
    assert tja.joint_attention_bwd.launches == before + 1
    ref = tja.joint_attention_bwd_plain(q.float(), ks.float(), vs.float(), _f32(segs),
                                        do.float(), "sm")
    for g_, r_ in zip([*got[:3], got[3][0], got[3][1]], [*ref[:3], ref[3][0], ref[3][1]]):
        assert _rel(g_, r_) < 2e-2
    assert not got[3][2].any() and not got[3][3].any()  # the all-masked segment


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
