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
