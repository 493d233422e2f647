"""The port's training path (echo_tts_tpu_torch.train) against the JAX
package's on the same weights (JAX initializer, carried over by
checkpoints/from_jax.py) and the same numpy batch, t and noise: the loss
and its gradients in LoRA, full and train_encoders modes, with JAX's
attention on its XLA path and on its Pallas custom-VJP (interpret mode);
the optimizer against optax's chain fed one gradient sequence; LoRA
identity at init, a falling loss, and npz checkpoints read across packages.
Tiny config, fp32 on the CPU. Tolerances: loss 1e-5, gradients atol 2e-4 /
rtol 1e-3 (the JAX package's own Pallas-vs-XLA gradient test), parameters
after the optimizer rtol 1e-6."""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from echo_tts_tpu.core.config import DiTConfig as JDiTConfig
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.train import lora as jlora
from echo_tts_tpu.train import loop as jloop
from echo_tts_tpu.train.loss import compute_diffusion_loss as j_loss
from echo_tts_tpu_torch.checkpoints.from_jax import dit_params_from_numpy, lora_from_numpy
from echo_tts_tpu_torch.core.config import DiTConfig
from echo_tts_tpu_torch.models import dit as tdit
from echo_tts_tpu_torch.train import lora as tlora
from echo_tts_tpu_torch.train import loop as tloop
from echo_tts_tpu_torch.train.loss import compute_diffusion_loss as t_loss

from torch_parity import assert_close, np_tree, t

CFG = DiTConfig(has_latent_modules=False).tiny()
JCFG = JDiTConfig(has_latent_modules=False).tiny()
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
LC = dict(rank=4, alpha=8.0)


@pytest.fixture(scope="module")
def setup():
    jp = jdit.init_dit_params(jax.random.PRNGKey(8), JCFG, dtype=jnp.float32)
    rng = np.random.default_rng(40)
    b, n, txt, spk = 2, 12, 10, 8
    batch = {
        "latent": rng.standard_normal((b, n, 80)).astype(np.float32),
        "latent_mask": np.ones((b, n), bool),
        "text_input_ids": rng.integers(0, 256, (b, txt)).astype(np.int32),
        "text_mask": np.ones((b, txt), bool),
        "speaker_latent": rng.standard_normal((b, spk, 80)).astype(np.float32),
        "speaker_mask": np.ones((b, spk), bool),
    }
    batch["latent_mask"][1, 9:] = False
    batch["text_mask"][0, 7:] = False
    tt = (rng.random(b) ** 2).astype(np.float32)
    noise = rng.standard_normal((b, n, 80)).astype(np.float32)
    return jp, batch, tt, noise


def _fresh_port_params(jp):
    return dit_params_from_numpy(np_tree(jp), CFG, device="cpu")


def _jax_loss(params, batch, tt, noise, train_encoders):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return j_loss(params, JCFG, jax.random.PRNGKey(0), jb["latent"], jb["latent_mask"],
                  jb["text_input_ids"], jb["text_mask"], jb["speaker_latent"],
                  jb["speaker_mask"], model_dtype=jnp.float32, train_encoders=train_encoders,
                  t=jnp.asarray(tt), noise=jnp.asarray(noise))


def _port_loss(params, batch, tt, noise, train_encoders):
    tb = {k: t(v) for k, v in batch.items()}
    return t_loss(params, CFG, None, tb["latent"], tb["latent_mask"], tb["text_input_ids"],
                  tb["text_mask"], tb["speaker_latent"], tb["speaker_mask"],
                  model_dtype=torch.float32, train_encoders=train_encoders,
                  t=t(tt), noise=t(noise))


def _perturbed_lora(jp, seed):
    """A JAX adapter with b moved off zero (at b = 0, a has no gradient)."""
    lc = jlora.LoRAConfig(**LC)
    lora = jlora.init_lora(jax.random.PRNGKey(seed), jp, lc)
    rng = np.random.default_rng(seed)
    lora = {tgt: {"a": ab["a"],
                  "b": jnp.asarray(0.05 * rng.standard_normal(ab["b"].shape), jnp.float32)}
            for tgt, ab in lora.items()}
    return lora, lc


def _leaves_by_path(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: x for k in sorted(tree) for p, x in _leaves_by_path(
            tree[k], f"{prefix}.{k}" if prefix else k).items()}
    return {prefix: tree}


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_vjp_interpret"])
@pytest.mark.parametrize("mode", ["lora", "full", "train_encoders"])
def test_loss_and_grads_match_jax(setup, mode, jax_impl):
    jp, batch, tt, noise = setup
    train_encoders = mode == "train_encoders"
    tp = _fresh_port_params(jp)
    if mode == "lora":
        jl, jlc = _perturbed_lora(jp, seed=1)
        tl = lora_from_numpy(np_tree(jl), device="cpu")
        tlc = tlora.LoRAConfig(**LC)

        def jfn(lora):
            return _jax_loss(jlora.apply_lora(jp, lora, jlc), batch, tt, noise, False)

        j_arg, t_tree = jl, tl
        t_params = tlora.lora_params(tp, tl, tlc)
    else:
        def jfn(params):
            return _jax_loss(params, batch, tt, noise, train_encoders)

        j_arg, t_tree, t_params = jp, tp, tp

    jdit.set_attention_impl(jax_impl)
    try:
        l_ref, g_ref = jax.value_and_grad(jfn)(j_arg)
    finally:
        jdit.set_attention_impl("auto")

    leaves = _leaves_by_path(t_tree)
    for x in leaves.values():
        x.requires_grad_(True)
    loss = _port_loss(t_params, batch, tt, noise, train_encoders)
    grads = tloop._grads(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), atol=1e-5, rtol=1e-5)

    ref = _leaves_by_path(np_tree(g_ref))
    assert sorted(ref) == sorted(leaves)
    for (path, _), g in zip(leaves.items(), grads):
        assert_close(g, ref[path], **GRAD_TOL)
    by_path = dict(zip(leaves, grads))
    if mode == "lora":
        # the text caches are built without autograd: exactly zero in both
        for path in ("blocks.attention.wk_text.a", "blocks.attention.wv_text.b"):
            assert not by_path[path].any() and not np.asarray(ref[path]).any()
        assert by_path["blocks.attention.wq.a"].abs().sum() > 0
    elif mode == "full":
        assert not by_path["text_encoder.blocks.mlp.w1"].any()
    else:
        assert by_path["text_encoder.blocks.mlp.w1"].abs().sum() > 0


def _grad_sequence(shapes, n, nan_at, seed=0):
    """Gradients for n steps: mostly large (global norm well above 0.4, so
    clipping is active), one step small, "z" always zero, one NaN step."""
    rng = np.random.default_rng(seed)
    seq = []
    for i in range(n):
        scale = 0.01 if i == 2 else 1.0
        g = {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        g["z"] = np.zeros(shapes["z"], np.float32)
        if i == nan_at:
            g["a"][0, 1] = np.nan
        seq.append(g)
    return seq


@pytest.mark.parametrize("accum,nan_at", [(1, 3), (2, None), (2, 5)])
def test_optimizer_matches_optax(accum, nan_at):
    """Warmup (lr 0 on the first applied step), active clipping, a skipped
    non-finite step, accumulation over 2, and a zero-gradient tensor that
    decays; parameters agree after every call."""
    tc_kw = dict(learning_rate=1e-2, warmup_steps=3, total_steps=8,
                 gradient_accumulation_steps=accum)
    shapes = {"a": (3, 4), "b": (5,), "z": (2, 2)}
    rng = np.random.default_rng(1)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    j_opt = jloop.make_optimizer(jloop.TrainConfig(**tc_kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    j_state = j_opt.init(jp)
    t_opt = tloop.make_optimizer(tloop.TrainConfig(**tc_kw))
    tp = {k: t(v) for k, v in p0.items()}
    t_state = t_opt.init(tp)
    for i, g in enumerate(_grad_sequence(shapes, 10, nan_at)):
        upd, j_state = j_opt.update({k: jnp.asarray(v) for k, v in g.items()}, j_state, jp)
        jp = optax.apply_updates(jp, upd)
        t_state = t_opt.apply(tp, {k: t(v) for k, v in g.items()}, t_state)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} after call {i}")
    assert not np.allclose(tp["z"].numpy(), p0["z"])  # decayed with zero gradients
    if accum == 1:
        assert t_state.total_notfinite == 1


def test_lora_identity_at_init(setup):
    """b = 0: the adapted model (merged, or merged per layer inside the
    forward) equals the base; the merge equals the JAX package's."""
    jp, batch, tt, _ = setup
    tp = _fresh_port_params(jp)
    lc = tlora.LoRAConfig(**LC)
    lora = tlora.init_lora(torch.Generator().manual_seed(0), tp, lc)
    assert tlora.count_lora_params(lora) == sum(
        x.numel() for ab in lora.values() for x in ab.values())
    tb = {k: t(v) for k, v in batch.items()}
    outs = []
    for p in (tp, tlora.apply_lora(tp, lora, lc), tlora.lora_params(tp, lora, lc)):
        kvt = tdit.get_kv_cache_text(p, CFG, tb["text_input_ids"], tb["text_mask"])
        kvs = tdit.get_kv_cache_speaker(p, CFG, tb["speaker_latent"])
        outs.append(tdit.dit_forward(p, CFG, tb["latent"], t(tt), tb["text_mask"],
                                     tb["speaker_mask"], kvt, kvs))
    assert_close(outs[1], outs[0].detach().numpy(), atol=1e-6, rtol=0)
    assert_close(outs[2], outs[0].detach().numpy(), atol=1e-6, rtol=0)

    jl, jlc = _perturbed_lora(jp, seed=2)
    merged_j = jlora.merge_lora(jp, jl, jlc)
    merged_t = tlora.merge_lora(tp, lora_from_numpy(np_tree(jl), device="cpu"), lc)
    for tgt in lc.targets:
        assert_close(tlora._get(merged_t, tgt), np.asarray(jlora._get(merged_j, tgt)),
                     atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("train_encoders", [False, True])
def test_lora_side_products_match_the_merged_weights(setup, train_encoders):
    """The adapters applied as rank-r side products (`lora_params`: h @ w +
    s·(h @ a) @ b inside the trunk's products and the context K/V
    projections) against the merged weights w + s·a@b (`apply_lora`,
    differentiable in a and b): the same loss and a/b gradients in fp32;
    with train_encoders the text cache's adapters take gradients too."""
    jp, batch, tt, noise = setup
    tp = _fresh_port_params(jp)
    jl, _ = _perturbed_lora(jp, seed=4)
    lora = lora_from_numpy(np_tree(jl), device="cpu")
    lc = tlora.LoRAConfig(**LC)
    leaves = _leaves_by_path(lora)
    for x in leaves.values():
        x.requires_grad_(True)
    out = {}
    for how, params in (("side", tlora.lora_params(tp, lora, lc)),
                        ("merged", tlora.apply_lora(tp, lora, lc))):
        loss = _port_loss(params, batch, tt, noise, train_encoders)
        out[how] = (float(loss.detach()), tloop._grads(loss, list(leaves.values())))
    np.testing.assert_allclose(out["side"][0], out["merged"][0], rtol=1e-6)
    for path, g, r in zip(leaves, out["side"][1], out["merged"][1]):
        assert_close(g, r.numpy(), atol=1e-6 * float(r.abs().max()), rtol=1e-4)
    by_path = dict(zip(leaves, out["side"][1]))
    assert bool(by_path["blocks.attention.wk_text.b"].any()) == train_encoders
    assert by_path["blocks.mlp.w2.a"].abs().sum() > 0


def test_lora_weight_slices_merge_from_the_fp32_adapter_in_bf16():
    """A bf16 base with an fp32 adapter: a layer's slice (`unbind`) merges
    from the fp32 a and b, bit for bit the stack's merge of that layer, and
    hands the side product a and s·b in bf16, formed once for the stack."""
    from echo_tts_tpu_torch.models.lora_linear import LoRAWeight, side_product

    gen = torch.Generator().manual_seed(9)
    w = torch.randn(3, 64, 48, generator=gen).to(torch.bfloat16)
    a = torch.randn(3, 64, 4, generator=gen) * 0.3
    b = torch.randn(3, 4, 48, generator=gen) * 1e-3  # a delta under half an ulp of w in bf16
    stack = LoRAWeight(w, a, b, 2.0)
    merged = stack.weight()
    h = torch.randn(5, 64, generator=gen).to(torch.bfloat16)
    for l, sl in enumerate(stack.unbind(0)):
        assert sl.a.dtype == sl.b.dtype == torch.float32
        assert torch.equal(sl.weight(), merged[l])
        assert torch.equal(sl.weight(), LoRAWeight(w[l], a[l], b[l], 2.0).weight())
        a_lo, b_lo = sl.side_factors()
        assert a_lo.dtype == b_lo.dtype == torch.bfloat16
        assert torch.equal(a_lo, a[l].to(torch.bfloat16))
        assert torch.equal(b_lo, (2.0 * b[l]).to(torch.bfloat16))
        ref = (h @ w[l]).addmm_(h @ a[l].to(torch.bfloat16), b[l].to(torch.bfloat16), alpha=2.0)
        assert torch.equal(side_product(h, sl), ref)


def test_lora_training_reduces_loss(setup):
    """15 LoRA steps on one batch with fixed t and noise (the same
    generator seed each step): the adapters fit it."""
    jp, batch, _, _ = setup
    tp = _fresh_port_params(jp)
    lc = tlora.LoRAConfig(rank=4)
    tc = tloop.TrainConfig(learning_rate=2e-2, warmup_steps=2, total_steps=30)
    lora = tlora.init_lora(torch.Generator().manual_seed(1), tp, lc)
    opt, step = tloop.make_train_step(CFG, tc, model_dtype=torch.float32, lora_cfg=lc)
    state = opt.init(lora)
    losses = []
    for _ in range(15):
        lora, state, loss = step(tp, lora, state, torch.Generator().manual_seed(7), batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses
    assert state.count == 15


def test_full_train_step_moves_every_parameter(setup):
    """Full mode: one step with warmup 0 updates every non-zero leaf, the
    frozen encoders too (zero gradient, weight decay)."""
    jp, batch, _, _ = setup
    tp = _fresh_port_params(jp)
    before = {k: v.clone() for k, v in _leaves_by_path(tp).items()}
    tc = tloop.TrainConfig(learning_rate=1e-4, warmup_steps=0, total_steps=10)
    opt, step = tloop.make_train_step(CFG, tc, model_dtype=torch.float32)
    state = opt.init(tp)
    tp, state, loss = step(tp, state, torch.Generator().manual_seed(3), batch)
    assert np.isfinite(float(loss))
    after = _leaves_by_path(tp)
    still = [k for k in before if torch.equal(before[k], after[k].detach())]
    assert still and all(not before[k].any() for k in still), still
    assert not torch.equal(before["text_encoder.blocks.mlp.w1"],
                           after["text_encoder.blocks.mlp.w1"].detach())


def test_lora_checkpoints_load_across_packages(tmp_path, setup):
    jp, _, _, _ = setup
    jl, jlc = _perturbed_lora(jp, seed=3)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jlora.save_lora_checkpoint(jpath, jl, jlc)
    tl, tlc = tlora.load_lora_checkpoint(jpath, device="cpu")
    assert (tlc.rank, tlc.alpha, tlc.targets) == (jlc.rank, jlc.alpha, tuple(sorted(jl)))
    for tgt in jl:
        for k in ("a", "b"):
            assert_close(tl[tgt][k], np.asarray(jl[tgt][k]), atol=0, rtol=0)
    tlora.save_lora_checkpoint(tpath, tl, tlc)
    back, blc = jlora.load_lora_checkpoint(tpath)
    assert (blc.rank, blc.alpha, blc.targets) == (tlc.rank, tlc.alpha, tlc.targets)
    for tgt in jl:
        for k in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(back[tgt][k]), np.asarray(jl[tgt][k]))
