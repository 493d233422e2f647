"""Ground rules of the PyTorch port (echo_tts_tpu_torch):

* it imports no JAX, nothing of the JAX package and nothing of scripts/, nor
  does chip_smoke.py;
* its entry points run on CUDA unless the caller asks for the CPU, and raise
  where CUDA is absent instead of falling back quietly; the measurement
  entry points (echo_tts_tpu_torch/bench/) and the server's
  (echo_tts_tpu_torch/serve/__main__.py) rehearse end to end with --cpu at a
  tiny size through the plain versions; the serving options not ported raise;
* the kernel wrappers take the plain version only for CPU tensors and
  refuse what the kernels do not take, inputs that require grad included.
"""
import importlib
import json
import math
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
from echo_tts_tpu_torch.pipeline.pipeline import (
    EchoTTS,
    sample_pipeline_batch,
    sample_pipeline_stream,
)
from echo_tts_tpu_torch.bench import trace
from echo_tts_tpu_torch.serve import __main__ as serve_main
from echo_tts_tpu_torch.serve.engine import Engine


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import echo_tts_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "tests")
import torch_parity
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "echo_tts_tpu" or m.startswith("echo_tts_tpu.")
             or m == "scripts" or m.startswith("scripts.")
             or m == "safetensors" or m.startswith("safetensors."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
for new in ("bench.attention", "bench.attention_variants", "bench.conv_kernel_variants",
            "bench.conv_variants", "bench.profile_breakdown", "bench.timing",
            "ops.attention_variants", "ops.res_chain_variants", "utils.profiling",
            "ops.conv_core", "sampling.jax_random", "sampling.blockwise", "core.rope",
            "models.s1dac", "pipeline.pipeline", "serve.engine", "serve.continuous",
            "serve.server", "serve.presets", "serve.__main__", "utils.locks", "bench.trace",
            "checkpoints.safetensors", "checkpoints.convert", "checkpoints.io",
            "native.build", "native.resample_py", "native.mp3_py", "bench.fast_init",
            "scripts.convert_checkpoint", "scripts.batch_synthesize", "scripts.finetune_lora",
            "scripts.bench_train"):
    assert "echo_tts_tpu_torch." + new in names, new
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
        lambda: next(sample_pipeline_stream(
            EchoTTS({}, DiTConfig().tiny(), {}, AEConfig().tiny(),
                    PCAState.random(0, 64, device="cpu")), "hi", None, 0)),
        lambda: sample_pipeline_batch(
            EchoTTS({}, tiny, {}, AEConfig().tiny(), PCAState.random(0, 64, device="cpu")),
            [("hi", None, 0)]),
        lambda: Engine(EchoTTS({}, tiny, {}, AEConfig().tiny(),
                               PCAState.random(0, 64, device="cpu"))),
        lambda: serve_main.build_engine(serve_main.parse_args(["--random-tiny"])),
        lambda: trace.main(["--tiny"]),
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


def test_serve_and_trace_entry_points_on_the_cpu_flag(capsys):
    """With --cpu the server's entry point builds its engine on the CPU, and
    the trace bench runs end to end there, naming the CPU as its device and
    launching no kernel."""
    eng = serve_main.build_engine(serve_main.parse_args(["--cpu", "--random-tiny",
                                                         "--max-batch", "2"]))
    try:
        assert eng.tts.device.type == "cpu" and eng.max_batch == 2
    finally:
        eng.close()
    res = trace.main(["--cpu", "--tiny", "--n", "2", "--rate", "50"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert res["device"].startswith("cpu") and res["card"] == "cpu"
    assert res["n_ok"] == 2 and res["n_hung"] == 0 and not any(res["launches"].values())


@pytest.mark.parametrize("argv", [["--random", "--tp", "2"], ["--random", "--gradio"]])
def test_serve_flags_not_ported_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_main.build_engine(serve_main.parse_args(["--cpu"] + argv))


def test_serve_builds_an_engine_from_checkpoint_files(tmp_path):
    """--dit/--ae/--pca load the reference's safetensors (here the tiny
    configs written by tests/torch_parity.py) onto the asked device: the
    one-shot DiT unless --keep-blockwise, fp32 on the CPU; --int8-cache
    writes the quantized base; without a card and without --cpu it raises;
    --dit without --ae and --pca is refused."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_parity import write_tiny_checkpoints

    p = write_tiny_checkpoints(tmp_path, 2, 3)["paths"]
    files = ["--dit", p["dit"], "--ae", p["ae"], "--pca", p["pca"]]
    for extra, latent in (([], False), (["--keep-blockwise", "--int8", "--int8-cache",
                                         str(tmp_path / "q.npz")], True)):
        eng = serve_main.build_engine(serve_main.parse_args(["--cpu"] + files + extra))
        try:
            assert eng.tts.device.type == "cpu" and eng.tts.model_dtype == torch.float32
            assert eng.tts.dit_cfg == DiTConfig(has_latent_modules=latent).tiny()
            assert eng.int8 == latent
        finally:
            eng.close()
    assert os.path.exists(tmp_path / "q.npz")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_main.build_engine(serve_main.parse_args(files))
    with pytest.raises(SystemExit):
        serve_main.parse_args(["--cpu", "--dit", p["dit"]])


def test_native_build_stays_under_build_and_never_loads_the_jax_library(tmp_path, monkeypatch):
    """native/build.py compiles its own copy of resample.cc into the build
    directory it is given (build/echo_tts_tpu_torch/ at the repo root by
    default), names the library by a hash of the source, and loads only
    that file: never echo_tts_tpu/native/libecho_native.so."""
    from echo_tts_tpu_torch.native import build as nb

    assert nb.BUILD_DIR == type(nb.BUILD_DIR)(REPO) / "build" / "echo_tts_tpu_torch"
    assert nb.SRC.parent.name == "native" and nb.SRC.parent.parent.name == "echo_tts_tpu_torch"
    runs, loads = [], []
    real_run, real_cdll = nb.subprocess.run, nb.ctypes.CDLL
    monkeypatch.setattr(nb, "BUILD_DIR", tmp_path / "build" / "echo_tts_tpu_torch")
    monkeypatch.setattr(nb, "_lib", None)
    monkeypatch.setattr(nb.subprocess, "run", lambda cmd, **kw: runs.append(cmd) or
                        real_run(cmd, **kw))
    monkeypatch.setattr(nb.ctypes, "CDLL", lambda path, *a, **kw: loads.append(str(path)) or
                        real_cdll(path, *a, **kw))
    lib = nb.load()
    assert lib.upfirdn_f32 is not None and len(runs) == 1 and len(loads) == 1
    out = runs[0][runs[0].index("-o") + 1]
    assert out.startswith(str(tmp_path / "build" / "echo_tts_tpu_torch"))
    assert loads[0] == str(nb.lib_path()) and loads[0].startswith(str(tmp_path / "build"))
    assert "libecho_native-" in loads[0] and "echo_tts_tpu/native" not in loads[0]
    assert all("echo_tts_tpu/native" not in part for part in runs[0])
    assert sorted(p.name for p in (tmp_path / "build" / "echo_tts_tpu_torch").iterdir()) == \
        [nb.lib_path().name]


BENCH_ENTRY_POINTS = ("attention_variants", "conv_kernel_variants", "conv_variants", "attention",
                      "profile_breakdown")


@pytest.mark.parametrize("name", BENCH_ENTRY_POINTS)
def test_bench_entry_point_needs_a_card_or_cpu_flag(name, capsys):
    """Without a card and without --cpu a measurement entry point raises;
    with --cpu --tiny it runs end to end through the plain versions, names
    the CPU as its device and launches no kernel."""
    mod = importlib.import_module(f"echo_tts_tpu_torch.bench.{name}")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main([])
    res = mod.main(["--cpu", "--tiny"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["bench"] == name == res["bench"]
    assert res["device"].startswith("cpu") and res["card"] == "cpu"
    assert res["ms"] and all(math.isfinite(v) and v > 0 for v in res["ms"].values())
    assert not any(res["launches"].values())


def test_init_builds_latent_encoder():
    """With has_latent_modules (the default) the port's init builds the
    streaming path's latent encoder, latent_norm and wk/wv_latent: the same
    leaves as the JAX package's init, with equal shapes."""
    import jax

    from echo_tts_tpu.core.config import DiTConfig as JDiTConfig
    from echo_tts_tpu.models.dit import init_dit_params as j_init

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for n, sub in tree.items() for k, v in shapes(sub, f"{prefix}{n}.").items()}
        return {prefix[:-1]: tuple(tree.shape)}

    got = shapes(init_dit_params(DiTConfig().tiny(), dtype=torch.float32, device="cpu"))
    ref = shapes(jax.eval_shape(lambda k: j_init(k, JDiTConfig().tiny()), jax.random.PRNGKey(0)))
    assert got == ref
    assert {"latent_norm", "blocks.attention.wk_latent", "latent_encoder.in_proj.w"} <= set(got)


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


@pytest.mark.parametrize("mangled,name", [
    ("_ZN45_GLOBAL__N__f1e66924_12_int8_gemm_cu_9258764416int8_gemm_kernelILi2EEEvPKaS2_PKfS4_Pviii",
     "int8_gemm_kernel<2>"),
    ("_ZN12_GLOBAL__N_117quant_rows_kernelILb1EEEvPKvPaPfii", "quant_rows_kernel<1>"),
    ("_ZN12_GLOBAL__N_115res_unit_kernelILi768ELi1ELi128ELi16ELi5ELi1ELi1EEEvv",
     "res_unit_kernel<768, 1, 128, 16, 5, 1, 1>"),
    ("_Z9dq_kernel6Params", "dq_kernel"),
])
def test_chip_smoke_names_kernels_from_their_mangled_names(mangled, name):
    """chip_smoke.py keys ptxas' registers and spills by kernel: the name is
    the mangled `<length><name>` ending in `_kernel`, with its template
    arguments."""
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke._kernel_name(mangled) == name


def test_quant_snr_entry_point_needs_a_card_or_cpu_flag(capsys):
    """bench/quant_snr.py raises without a card and without --cpu; with --cpu
    --tiny it runs both samplings through the plain versions, names the CPU
    as its device, launches no kernel and prints the JSON line of
    scripts/quant_snr.py (an int8 trunk well inside the 40 dB gate); flag
    combinations the JAX script refuses are refused."""
    from echo_tts_tpu_torch.bench import quant_snr

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            quant_snr.main([])
    for argv in (["--cpu", "--tiny", "--first-steps", "2"], ["--cpu", "--tiny", "--bf16"]):
        with pytest.raises(SystemExit):
            quant_snr.main(argv)
    capsys.readouterr()
    res = quant_snr.main(["--cpu", "--tiny"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == res and res["bench"] == "quant_snr" and res["card"] == "cpu"
    assert res["device"].startswith("cpu") and not any(res["launches"].values())
    assert {"latent_rel_l2", "latent_snr_db", "waveform_rel_l2"} <= set(res)
    assert 40.0 <= res["latent_snr_db"] < 200.0 and res["metric"].startswith("int8 W8A8 trunk")
