"""Ground rules of the PyTorch port (echo_tts_tpu_torch):

* it imports no JAX and nothing of the JAX package, nor does chip_smoke.py;
* its entry points run on CUDA unless the caller asks for the CPU, and raise
  where CUDA is absent instead of falling back quietly;
* the kernel wrappers take the plain version only for CPU tensors and
  refuse what the kernels do not take, inputs that require grad included.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from echo_tts_tpu_torch.bench.init_ae import init_ae_params
from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig
from echo_tts_tpu_torch.models.dit import init_dit_params
from echo_tts_tpu_torch.models.pca import PCAState
from echo_tts_tpu_torch.ops import joint_attention as tja
from echo_tts_tpu_torch.ops import res_chain as trc
from echo_tts_tpu_torch.pipeline.pipeline import EchoTTS


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import echo_tts_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "echo_tts_tpu" or m.startswith("echo_tts_tpu."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_cuda():
    tiny = DiTConfig(has_latent_modules=False).tiny()
    calls = [
        lambda: EchoTTS({}, tiny, {}, AEConfig().tiny(), PCAState.random(0, 64, device="cpu")),
        lambda: init_dit_params(tiny, dtype=torch.float32),
        lambda: init_ae_params(AEConfig().tiny()),
    ]
    if torch.cuda.is_available():
        tts = calls[0]()
        assert tts.device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    tts = EchoTTS({}, tiny, {}, AEConfig().tiny(), PCAState.random(0, 64, device="cpu"),
                  device="cpu")
    assert tts.device.type == "cpu"


def test_init_refuses_unported_latent_encoder():
    with pytest.raises(NotImplementedError, match="latent encoder"):
        init_dit_params(DiTConfig().tiny(), dtype=torch.float32, device="cpu")


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 1, 8, 2, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tja.joint_attention(q, q, q, [], layout="sm")
    with pytest.raises(ValueError, match="unsupported device"):
        trc.res_units_cl(torch.zeros(1, 8, 32, device="meta"), [])



def test_pca_defaults_to_cuda():
    """PCAState.random/from_arrays resolve their device like every entry
    point: None means cuda, and a missing card raises."""
    comp, mean = np.eye(8, 16, dtype=np.float32), np.zeros(16, np.float32)
    if torch.cuda.is_available():
        assert PCAState.random(0, 64).components.device.type == "cuda"
        assert PCAState.from_arrays(comp, mean, 1.0).mean.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PCAState.random(0, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PCAState.from_arrays(comp, mean, 1.0)
    assert PCAState.from_arrays(comp, mean, 1.0, device="cpu").components.device.type == "cpu"


def test_echo_tts_refuses_weights_on_another_device():
    """EchoTTS checks that the PCA state and every DiT/AE weight lie on its
    device (a CPU PCA state would send the speaker encode to the CPU)."""
    tiny = DiTConfig(has_latent_modules=False).tiny()
    pca_cpu = PCAState.random(0, 64, device="cpu")
    pca_meta = PCAState(pca_cpu.components.to("meta"), pca_cpu.mean, 1.0)
    with pytest.raises(ValueError, match="pca.components is on meta"):
        EchoTTS({}, tiny, {}, AEConfig().tiny(), pca_meta, device="cpu")
    dit = {"blocks": {"attention": {"wq": torch.zeros(2, 4, 4, device="meta")}}}
    with pytest.raises(ValueError, match="dit_params.blocks.attention.wq is on meta"):
        EchoTTS(dit, tiny, {}, AEConfig().tiny(), pca_cpu, device="cpu")
    ae = {"decoder": {"blocks": [{"w": torch.zeros(3)}, {"w": torch.zeros(3, device="meta")}]}}
    with pytest.raises(ValueError, match="ae_params.decoder.blocks.1.w is on meta"):
        EchoTTS({}, tiny, ae, AEConfig().tiny(), pca_cpu, device="cpu")


def test_inference_wrappers_refuse_inputs_that_require_grad():
    """Off the CPU, K1 and K2 write outside autograd: with grad mode on they
    refuse inputs that require grad (the check comes before the device's,
    so meta tensors reach it here); under no_grad they get as far as the
    device check."""
    q = torch.zeros(1, 1, 8, 2, 128, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="joint_attention_trainable"):
        tja.joint_attention(q, q, q, [], layout="sm")
    k = torch.zeros(1, 2, 4, 128, device="meta", requires_grad=True)
    qd = q.detach()
    with pytest.raises(RuntimeError, match="joint_attention_trainable"):
        tja.joint_attention(qd, qd, qd, [(k, k.detach(), torch.ones(1, 1, 4, dtype=torch.bool,
                                                                    device="meta"), None)],
                            layout="sm")
    x = torch.zeros(1, 8, 32, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="K2 has no backward"):
        trc.res_units_cl(x, [])
    w = torch.zeros(32, 32, 7, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="K2 has no backward"):
        trc.res_units_cl(x.detach(), [{"conv1": {"w": w}}])
    with torch.no_grad():
        with pytest.raises(ValueError, match="unsupported device"):
            tja.joint_attention(q, q, q, [], layout="sm")
        with pytest.raises(ValueError, match="unsupported device"):
            trc.res_units_cl(x, [])
