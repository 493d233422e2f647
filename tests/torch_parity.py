"""Helpers shared by the tests of the PyTorch port (echo_tts_tpu_torch):
numpy trees between it and the JAX package on the CPU, and the fixture of
the tests that need a CUDA card. Imports JAX only inside `np_tree`, so the
card's tests (tests/test_torch_cuda.py) run where JAX is absent."""
from __future__ import annotations

import numpy as np
import pytest
import torch


def np_tree(tree):
    """A JAX pytree (dicts/lists of arrays) as nested numpy arrays."""
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def t(x, dtype=None) -> torch.Tensor:
    """numpy/JAX array -> CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out.to(dtype) if dtype is not None else out


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_close(got, ref, atol=1e-5, rtol=1e-4):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def perturb_res_biases(tree, seed):
    """Non-zero residual-unit biases in a numpy AE tree (in place; returned):
    with the initializer's zero biases a unit maps zeros to zeros, and the
    streaming re-zero of the chain's causal pad (zero_below) could not be
    seen; a re-zero done only at the stream start once corrupted the second
    chunk of short streams."""
    rng = np.random.default_rng(seed)
    for stack in ("encoder", "decoder"):
        for blk in tree[stack]["blocks"]:
            for u in blk["res_units"]:
                for c in ("conv1", "conv2"):
                    u[c]["b"] = (0.3 * rng.standard_normal(u[c]["b"].shape)).astype(np.float32)
    return tree


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none. Decided
    here, at run time, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def tiny_pair(dit_seed: int, ae_seed: int, pipe: dict, has_latent_modules: bool = True):
    """(JAX EchoTTS, port EchoTTS) on the same fp32 tiny weights (the JAX
    initializers, carried over by checkpoints/from_jax.py) with the same
    PCA state and PipelineConfig(**pipe); the port's on the CPU."""
    import jax
    import jax.numpy as jnp

    from echo_tts_tpu.bench.init_ae import init_ae_params as j_init_ae
    from echo_tts_tpu.core import config as jc
    from echo_tts_tpu.models import dit as jdit
    from echo_tts_tpu.models.pca import PCAState as JPCAState
    from echo_tts_tpu.pipeline import pipeline as jpipe
    from echo_tts_tpu_torch.checkpoints.from_jax import ae_params_from_numpy, dit_params_from_numpy
    from echo_tts_tpu_torch.core import config as tc
    from echo_tts_tpu_torch.models.pca import PCAState
    from echo_tts_tpu_torch.pipeline import pipeline as tpipe

    jcfg = jc.DiTConfig(has_latent_modules=has_latent_modules).tiny()
    jacfg = jc.AEConfig().tiny()
    jp = jax.jit(lambda k: jdit.init_dit_params(k, jcfg, dtype=jnp.float32))(
        jax.random.PRNGKey(dit_seed))
    ja = jax.jit(lambda k: j_init_ae(k, jacfg, dtype=jnp.float32))(jax.random.PRNGKey(ae_seed))
    jtts = jpipe.EchoTTS(jp, jcfg, ja, jacfg, JPCAState.random(0, jacfg.latent_dim),
                         model_dtype=jnp.float32, pipe_cfg=jc.PipelineConfig(**pipe))
    cfg = tc.DiTConfig(has_latent_modules=has_latent_modules).tiny()
    acfg = tc.AEConfig().tiny()
    ttts = tpipe.EchoTTS(dit_params_from_numpy(np_tree(jp), cfg, device="cpu"), cfg,
                         ae_params_from_numpy(np_tree(ja), acfg, device="cpu"), acfg,
                         PCAState.random(0, acfg.latent_dim, device="cpu"),
                         model_dtype=torch.float32, pipe_cfg=tc.PipelineConfig(**pipe),
                         device="cpu")
    return jtts, ttts


# ---------------------------------------------------------------------------
# The reference's tensor names, from a JAX-layout tree (numpy or torch)
# ---------------------------------------------------------------------------


def _lin_ref(out: dict, name: str, w, b=None) -> None:
    """An (in, out) weight as a torch Linear's `<name>.weight` (out, in)."""
    out[f"{name}.weight"] = w.T
    if b is not None:
        out[f"{name}.bias"] = b


def _encoder_blocks_ref(out: dict, prefix: str, blocks: dict) -> None:
    attn, mlp = blocks["attention"], blocks["mlp"]
    for i in range(attn["wq"].shape[0]):
        pre = f"{prefix}.blocks.{i}"
        for k in ("wq", "wk", "wv", "wo", "gate"):
            _lin_ref(out, f"{pre}.attention.{k}", attn[k][i])
        out[f"{pre}.attention.q_norm.weight"] = attn["q_norm"][i]
        out[f"{pre}.attention.k_norm.weight"] = attn["k_norm"][i]
        for k in ("w1", "w3", "w2"):
            _lin_ref(out, f"{pre}.mlp.{k}", mlp[k][i])
        out[f"{pre}.attention_norm.weight"] = blocks["attention_norm"][i]
        out[f"{pre}.mlp_norm.weight"] = blocks["mlp_norm"][i]


def reference_dit_state(tree: dict, cfg=None) -> dict:
    """The inverse of `convert_dit_state`: a JAX-layout DiT tree -> the
    reference EchoDiT's state dict (views where the arrays allow). Pure
    numpy/torch indexing: no JAX. `convert_dit_state(reference_dit_state(p))`
    gives `p` back exactly."""
    out: dict = {}
    out["text_encoder.text_embedding.weight"] = tree["text_encoder"]["embedding"]
    _encoder_blocks_ref(out, "text_encoder", tree["text_encoder"]["blocks"])
    encoders = ["speaker_encoder"] + (["latent_encoder"] if "latent_encoder" in tree else [])
    for enc in encoders:
        _lin_ref(out, f"{enc}.in_proj", tree[enc]["in_proj"]["w"], tree[enc]["in_proj"]["b"])
        _encoder_blocks_ref(out, enc, tree[enc]["blocks"])
    for norm in ("text_norm", "speaker_norm", "out_norm", "latent_norm"):
        if norm in tree:
            out[f"{norm}.weight"] = tree[norm]
    for i, k in enumerate(("w0", "w1", "w2")):
        _lin_ref(out, f"cond_module.{2 * i}", tree["cond_module"][k])
    _lin_ref(out, "in_proj", tree["in_proj"]["w"], tree["in_proj"]["b"])
    _lin_ref(out, "out_proj", tree["out_proj"]["w"], tree["out_proj"]["b"])
    blocks = tree["blocks"]
    attn = blocks["attention"]
    for i in range(attn["wq"].shape[0]):
        pre = f"blocks.{i}"
        for k, w in attn.items():
            if k in ("q_norm", "k_norm"):
                out[f"{pre}.attention.{k}.weight"] = w[i]
            else:
                _lin_ref(out, f"{pre}.attention.{k}", w[i])
        for k in ("w1", "w3", "w2"):
            _lin_ref(out, f"{pre}.mlp.{k}", blocks["mlp"][k][i])
        for which in ("attention_adaln", "mlp_adaln"):
            ad = blocks[which]
            for nm in ("shift", "scale", "gate"):
                _lin_ref(out, f"{pre}.{which}.{nm}_down", ad[f"{nm}_down"][i])
                _lin_ref(out, f"{pre}.{which}.{nm}_up", ad[f"{nm}_up"]["w"][i],
                         ad[f"{nm}_up"]["b"][i])
    return out


def _weight_norm_pair(out: dict, name: str, w) -> None:
    """`<name>.weight` as torch's weight-norm parametrization: original1
    (v) a scaled copy of w and original0 (g) the norm of w over every dim
    but the first, so that g * v / ||v|| folds back to w."""
    v = w * 1.75
    if isinstance(w, torch.Tensor):
        g = torch.linalg.vector_norm(w.double(), dim=tuple(range(1, w.dim())),
                                     keepdim=True).to(w.dtype)
    else:
        w = np.asarray(w)
        g = np.sqrt(np.sum(w.astype(np.float64) ** 2, axis=tuple(range(1, w.ndim)),
                           keepdims=True)).astype(w.dtype)
    out[f"{name}.parametrizations.weight.original0"] = g
    out[f"{name}.parametrizations.weight.original1"] = v


def reference_ae_state(tree: dict, cfg=None, weight_norm: bool = True) -> dict:
    """The inverse of `convert_ae_state` (and of `fold_weight_norm`): a
    JAX-layout S1-DAC tree -> the reference DAC's state dict. With
    weight_norm, the encoder and decoder convs and the codebook projections
    come as weight-norm pairs."""
    out: dict = {}

    def conv(name, p, wn=True):
        if wn and weight_norm:
            _weight_norm_pair(out, name, p["w"])
        else:
            out[f"{name}.weight"] = p["w"]
        if "b" in p:
            out[f"{name}.bias"] = p["b"]

    def res_unit(name, u):
        out[f"{name}.block.0.alpha"] = u["snake1"]
        conv(f"{name}.block.1.conv", u["conv1"])
        out[f"{name}.block.2.alpha"] = u["snake2"]
        conv(f"{name}.block.3.conv", u["conv2"])

    def transformer(name, t):
        for i, layer in enumerate(t["layers"]):
            pre = f"{name}.layers.{i}"
            out[f"{pre}.attention.wqkv.weight"] = layer["attention"]["wqkv"]["w"].T
            out[f"{pre}.attention.wo.weight"] = layer["attention"]["wo"]["w"].T
            for k in ("w1", "w2", "w3"):
                out[f"{pre}.feed_forward.{k}.weight"] = layer["feed_forward"][k]["w"].T
            out[f"{pre}.attention_norm.weight"] = layer["attention_norm"]["w"]
            out[f"{pre}.ffn_norm.weight"] = layer["ffn_norm"]["w"]
            out[f"{pre}.attention_layer_scale.gamma"] = layer["attention_layer_scale"]
            out[f"{pre}.ffn_layer_scale.gamma"] = layer["ffn_layer_scale"]
        out[f"{name}.norm.weight"] = t["norm"]["w"]

    def convnext(name, c):
        conv(f"{name}.dwconv.conv", c["dwconv"], wn=False)
        out[f"{name}.norm.weight"] = c["norm"]["w"]
        out[f"{name}.norm.bias"] = c["norm"]["b"]
        for k in ("pwconv1", "pwconv2"):
            out[f"{name}.{k}.weight"] = c[k]["w"].T
            out[f"{name}.{k}.bias"] = c[k]["b"]
        out[f"{name}.gamma"] = c["gamma"]

    enc, dec, q = tree["encoder"], tree["decoder"], tree["quantizer"]
    conv("encoder.block.0.conv", enc["stem"])
    for i, blk in enumerate(enc["blocks"]):
        base = f"encoder.block.{1 + i}.block"
        for j, u in enumerate(blk["res_units"]):
            res_unit(f"{base}.{j}", u)
        out[f"{base}.3.alpha"] = blk["snake"]
        conv(f"{base}.4.conv", blk["down"])
        if "transformer" in blk:
            transformer(f"{base}.5", blk["transformer"])
    n = len(enc["blocks"])
    out[f"encoder.block.{1 + n}.alpha"] = enc["head_snake"]
    conv(f"encoder.block.{2 + n}.conv", enc["head"])
    conv("decoder.model.0.conv", dec["stem"])
    for i, blk in enumerate(dec["blocks"]):
        base = f"decoder.model.{1 + i}.block"
        out[f"{base}.0.alpha"] = blk["snake"]
        conv(f"{base}.1.conv", blk["up"])
        for j, u in enumerate(blk["res_units"]):
            res_unit(f"{base}.{2 + j}", u)
    n = len(dec["blocks"])
    out[f"decoder.model.{1 + n}.alpha"] = dec["head_snake"]
    conv(f"decoder.model.{2 + n}.conv", dec["head"])
    for kind, vqs in (("semantic_quantizer", q["semantic"]), ("quantizer", q["residual"])):
        for i, vq in enumerate(vqs):
            pre = f"quantizer.{kind}.quantizers.{i}"
            conv(f"{pre}.in_proj", vq["in_proj"])
            conv(f"{pre}.out_proj", vq["out_proj"])
            out[f"{pre}.codebook.weight"] = vq["codebook"]
    for kind in ("downsample", "upsample"):
        for i, st in enumerate(q[kind]):
            conv(f"quantizer.{kind}.{i}.0.conv", st["conv"], wn=False)
            convnext(f"quantizer.{kind}.{i}.1", st["convnext"])
    transformer("quantizer.pre_module", q["pre_module"])
    transformer("quantizer.post_module", q["post_module"])
    return out


def write_tiny_checkpoints(dirpath, dit_seed: int = 0, ae_seed: int = 1,
                           has_latent_modules: bool = True) -> dict:
    """The tiny configs' JAX-initialised weights written as the reference's
    three fp32 safetensors files (the DiT under its names, the AE with
    weight-norm pairs, the PCA state) in `dirpath`. Returns the paths and
    the numpy JAX-layout trees."""
    import os

    import jax
    import jax.numpy as jnp

    from echo_tts_tpu.bench.init_ae import init_ae_params as j_init_ae
    from echo_tts_tpu.core import config as jc
    from echo_tts_tpu.models import dit as jdit
    from echo_tts_tpu_torch.checkpoints.safetensors import save_file

    jcfg = jc.DiTConfig(has_latent_modules=has_latent_modules).tiny()
    jacfg = jc.AEConfig().tiny()
    dit = np_tree(jax.jit(lambda k: jdit.init_dit_params(k, jcfg, dtype=jnp.float32))(
        jax.random.PRNGKey(dit_seed)))
    ae = np_tree(jax.jit(lambda k: j_init_ae(k, jacfg, dtype=jnp.float32))(
        jax.random.PRNGKey(ae_seed)))
    rng = np.random.default_rng(ae_seed)
    pca = {"pca_components": (0.3 * rng.standard_normal((80, jacfg.latent_dim))).astype(np.float32),
           "pca_mean": (0.01 * rng.standard_normal(jacfg.latent_dim)).astype(np.float32),
           "latent_scale": np.asarray(1.5, np.float32)}
    paths = {k: os.path.join(str(dirpath), f"{k}.safetensors") for k in ("dit", "ae", "pca")}
    save_file(reference_dit_state(dit), paths["dit"])
    save_file(reference_ae_state(ae), paths["ae"])
    save_file(pca, paths["pca"])
    return {"paths": paths, "dit": dit, "ae": ae, "pca": pca}


def tree_diffs(got, ref, path: str = "") -> list:
    """The paths of the leaves where two trees (dicts/lists of tensors or
    arrays) differ in structure, dtype, shape or bits."""
    if isinstance(ref, dict):
        if not isinstance(got, dict) or set(got) != set(ref):
            return [f"{path} (keys)"]
        return [d for k in ref for d in tree_diffs(got[k], ref[k], f"{path}/{k}")]
    if isinstance(ref, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(ref):
            return [f"{path} (length)"]
        return [d for i, (a, b) in enumerate(zip(got, ref))
                for d in tree_diffs(a, b, f"{path}/{i}")]
    if isinstance(ref, torch.Tensor):
        ok = (isinstance(got, torch.Tensor) and got.dtype == ref.dtype and got.shape == ref.shape
              and torch.equal(got, ref.to(got.device)))
    else:
        a, b = np.asarray(got), np.asarray(ref)
        ok = a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return [] if ok else [path]


def tree_equal(got, ref) -> None:
    """Two trees equal in structure, dtypes and bits; the AssertionError
    names the leaves that differ."""
    diffs = tree_diffs(got, ref)
    assert not diffs, diffs
