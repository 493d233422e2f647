"""The port's checkpoint layer (echo_tts_tpu_torch/checkpoints, models/pca.py
from_safetensors, the int8 cache) against the `safetensors` package and the
JAX package's converter and loaders.

* the safetensors reader and writer against the `safetensors` package for
  every dtype (BF16 against `safetensors.torch`: the JAX package's
  `load_safetensors` cannot read BF16, ROADMAP.md F6), and the metadata;
* the reference-name inverse of tests/torch_parity.py against the JAX
  converter (exact for the DiT, within the float64 fold for the AE);
* the port's converter equal to the JAX converter leaf by leaf, on F32
  files; `infer_*_config`; the DiT loaded both ways, forward at atol 2e-5 /
  rtol 1e-4 (the tolerance of tests/test_torch_dit.py);
* the `//`-keyed npz both ways, the train state (a resumed run equals an
  uninterrupted one bit for bit), PCAState.from_safetensors, the hub entry
  points (download monkeypatched), the int8 cache of the Engine.
Tiny configs, fp32, on the CPU.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import safetensors.numpy as st_numpy
import safetensors.torch as st_torch

from echo_tts_tpu.checkpoints import convert as jcv
from echo_tts_tpu.checkpoints import io as jio
from echo_tts_tpu.core import config as jc
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.models.pca import PCAState as JPCAState
from echo_tts_tpu_torch.checkpoints import convert as tcv
from echo_tts_tpu_torch.checkpoints import io as tio
from echo_tts_tpu_torch.checkpoints import safetensors as tst
from echo_tts_tpu_torch.checkpoints.from_jax import ae_params_from_numpy, dit_params_from_numpy
from echo_tts_tpu_torch.core import config as tc
from echo_tts_tpu_torch.models import dit as tdit
from echo_tts_tpu_torch.models.pca import PCAState

from torch_parity import (
    assert_close,
    reference_ae_state,
    reference_dit_state,
    t,
    tree_equal,
    write_tiny_checkpoints,
)

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
          "U8": torch.uint8, "BOOL": torch.bool}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_tiny_checkpoints(tmp_path_factory.mktemp("ckpt"), 0, 1)


def _tensors(code: str, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    dt = DTYPES[code]

    def mk(*shape):
        if dt.is_floating_point:
            return torch.randn(shape, generator=g).to(dt)
        if dt == torch.bool:
            return torch.rand(shape, generator=g) > 0.5
        return torch.randint(-100 if dt != torch.uint8 else 0, 100, shape, generator=g).to(dt)

    return {"a.weight": mk(3, 5), "b": mk(7), "c.scalar": mk(), "d.empty": mk(0, 4),
            "e.cube": mk(2, 3, 4)}


@pytest.mark.parametrize("code", list(DTYPES))
def test_safetensors_against_the_package(code, tmp_path):
    """Ours written -> the package reads the same tensors; the package's
    file -> ours reads them; numpy reads of both (BF16 upcast to fp32)."""
    ts = _tensors(code)
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    n = tst.save_file(ts, ours, metadata={"format": "pt", "code": code})
    st_torch.save_file(ts, theirs, metadata={"format": "pt", "code": code})
    assert n == os.path.getsize(ours)
    for path in (ours, theirs):
        tree_equal(st_torch.load_file(path), ts)
        tree_equal(tst.load_file(path), ts)
        with tst.SafeTensorsFile(path) as f:
            assert f.metadata == {"format": "pt", "code": code}
        got = tst.load_numpy(path)
        if code == "BF16":
            tree_equal(got, {k: v.float().numpy() for k, v in ts.items()})
        else:
            tree_equal(got, st_numpy.load_file(path))
            tree_equal(got, {k: v.numpy() for k, v in ts.items()})
    if code != "BF16":  # numpy arrays in, the package's numpy reader out
        arrs = {k: v.numpy() for k, v in ts.items()}
        tst.save_file(arrs, ours)
        tree_equal(st_numpy.load_file(ours), arrs)
    with tst.SafeTensorsFile(ours) as f:
        assert f.shape("e.cube") == (2, 3, 4) and f.dtype("b") == code and len(f) == 5


def test_safetensors_bf16_bits_and_header(tmp_path):
    """BF16 upcast on request (torch) and by numpy; raw bf16 bits (2-byte
    void items, how npz holds bf16) are written as BF16; the header is
    padded to 8 bytes; a file whose offsets do not fit is refused."""
    x = torch.randn(4, 6).bfloat16()
    path = str(tmp_path / "b.safetensors")
    tst.save_file({"x": x}, path)
    with tst.SafeTensorsFile(path) as f:
        assert torch.equal(f.tensor("x", upcast_bf16=True), x.float())
        assert f.tensor("x").dtype == torch.bfloat16
        assert np.array_equal(f.numpy("x"), x.float().numpy())
    bits = x.view(torch.int16).numpy().view(tst.BF16_BITS)
    tst.save_file({"x": bits}, str(tmp_path / "c.safetensors"))
    assert torch.equal(st_torch.load_file(str(tmp_path / "c.safetensors"))["x"], x)
    raw = open(path, "rb").read()
    n = int.from_bytes(raw[:8], "little")
    assert n % 8 == 0 and json.loads(raw[8:8 + n])["x"]["dtype"] == "BF16"
    open(path, "wb").write(raw[:-2])
    with pytest.raises(ValueError, match="data offsets"):
        tst.SafeTensorsFile(path)
    with pytest.raises(ValueError, match="unsupported"):
        tst.save_file({"x": torch.zeros(2, dtype=torch.complex64)}, path)


def test_torch_state_to_numpy():
    """A module's or a state dict's tensors as float32 numpy arrays, as the
    JAX package's helper gives them."""
    lin = torch.nn.Linear(3, 2).to(torch.bfloat16)
    got = tcv.torch_state_to_numpy(lin)
    ref = jcv.torch_state_to_numpy(lin)
    assert set(got) == {"weight", "bias"}
    tree_equal(got, ref)
    tree_equal(tcv.torch_state_to_numpy(lin.state_dict()), ref)


def test_reference_inverse_against_the_jax_converter(files):
    """convert_dit_state(reference_dit_state(p)) == p exactly;
    convert_ae_state(fold_weight_norm(reference_ae_state(p))) == p within
    the float64 fold."""
    jcfg, jacfg = jc.DiTConfig().tiny(), jc.AEConfig().tiny()
    tree_equal(jcv.convert_dit_state(reference_dit_state(files["dit"]), jcfg), files["dit"])
    got = jcv.convert_ae_state(jcv.fold_weight_norm(reference_ae_state(files["ae"])), jacfg)
    flat_got, flat_ref = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(files["ae"])
    assert len(flat_got) == len(flat_ref)
    for a, b in zip(flat_got, flat_ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("kind", ["dit", "dit-stripped", "ae"])
def test_converter_equals_jax(files, kind):
    """On the same F32 file, the port's converter's every leaf equals the
    JAX converter's (np.array_equal), and the configs inferred equal."""
    if kind == "ae":
        jstate = jcv.fold_weight_norm(jcv.load_safetensors(files["paths"]["ae"]))
        tstate = tcv.fold_weight_norm(tcv.load_safetensors(files["paths"]["ae"]))
        tree_equal(tstate, jstate)
        jcfg = jcv.infer_ae_config(jstate, jc.AEConfig().tiny())
        tcfg = tcv.infer_ae_config(tstate, tc.AEConfig().tiny())
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg == tc.AEConfig().tiny()
        tree_equal(tcv.convert_ae_state(tstate, tcfg), jcv.convert_ae_state(jstate, jcfg))
        return
    strip = kind == "dit-stripped"
    jstate = jcv.load_safetensors(files["paths"]["dit"])
    tstate = tcv.load_safetensors(files["paths"]["dit"])
    jcfg, tcfg = jcv.infer_dit_config(jstate), tcv.infer_dit_config(tstate)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg == tc.DiTConfig().tiny()
    with tst.SafeTensorsFile(files["paths"]["dit"]) as f:  # from the header alone
        assert tcv.infer_dit_config(f) == tcfg
    got = tcv.convert_dit_state(tstate, tcfg, strip)
    tree_equal(got, jcv.convert_dit_state(jstate, jcfg, strip))
    assert ("latent_encoder" in got) == (not strip)
    no_latent = {k: v for k, v in tstate.items() if not k.startswith("latent_")
                 and "_latent" not in k}
    assert tcv.infer_dit_config(no_latent) == tc.DiTConfig(has_latent_modules=False).tiny()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("strip", [False, True])
def test_loaders_equal_jax(files, dtype, strip):
    """load_dit_from_safetensors (converted leaf by leaf as torch tensors)
    and load_ae_from_safetensors give the JAX loaders' leaves, carried over
    by from_jax, bit for bit, in fp32 and in bf16."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp, jcfg = jio.load_dit_from_safetensors(files["paths"]["dit"], dtype=jdt,
                                             delete_blockwise_modules=strip)
    tp, tcfg = tio.load_dit_from_safetensors(files["paths"]["dit"], dtype=tdt,
                                             delete_blockwise_modules=strip, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    up = jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.float32)), jp)
    tree_equal(tp, dit_params_from_numpy(up, tcfg, device="cpu", dtype=tdt))
    ja, jacfg = jio.load_ae_from_safetensors(files["paths"]["ae"], cfg=jc.AEConfig().tiny(),
                                             dtype=jdt)
    ta, _ = tio.load_ae_from_safetensors(files["paths"]["ae"], cfg=tc.AEConfig().tiny(),
                                         dtype=tdt, device="cpu")
    up = jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.float32)), ja)
    tree_equal(ta, ae_params_from_numpy(up, tc.AEConfig().tiny(), device="cpu", dtype=tdt))


def test_forward_from_loaded_files_matches_jax(files):
    """dit_forward on the port-loaded one-shot DiT against JAX's on its
    own load of the same file, same numpy inputs: atol 2e-5 / rtol 1e-4."""
    jp, jcfg = jio.load_dit_from_safetensors(files["paths"]["dit"], dtype=jnp.float32,
                                             delete_blockwise_modules=True)
    tp, cfg = tio.load_dit_from_safetensors(files["paths"]["dit"], dtype=torch.float32,
                                            delete_blockwise_modules=True, device="cpu")
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 256, (2, 24)).astype(np.int32)
    tmask = np.ones((2, 24), bool)
    tmask[:, 19:] = False
    spk = rng.standard_normal((2, 16, 80)).astype(np.float32)
    smask = np.ones((2, 4), bool)
    smask[1, 3:] = False
    x = rng.standard_normal((2, 12, 80)).astype(np.float32)
    tt = np.asarray([0.7, 0.3], np.float32)
    kt_j = jdit.get_kv_cache_text(jp, jcfg, jnp.asarray(ids), jnp.asarray(tmask))
    ks_j = jdit.get_kv_cache_speaker(jp, jcfg, jnp.asarray(spk))
    ref = jdit.dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(tmask),
                           jnp.asarray(smask), kt_j, ks_j)
    kt_t = tdit.get_kv_cache_text(tp, cfg, t(ids), t(tmask))
    ks_t = tdit.get_kv_cache_speaker(tp, cfg, t(spk))
    got = tdit.dit_forward(tp, cfg, t(x), t(tt), t(tmask), t(smask), kt_t, ks_t)
    assert_close(got, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_npz_interchange(files, tmp_path, dtype):
    """A tree saved by the JAX save_pytree loads here (load_pytree, then
    from_jax) to the same bits, and the port's save_pytree of the same tree
    writes the same entries byte for byte, which the JAX load_pytree reads."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    cfg = tc.DiTConfig().tiny()
    jtree = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), files["dit"])
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jio.save_pytree(jpath, jtree)
    port = dit_params_from_numpy(tio.load_pytree(jpath), cfg, device="cpu", dtype=tdt)
    ref = dit_params_from_numpy(
        jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.float32)), jtree), cfg,
        device="cpu", dtype=tdt)
    tree_equal(port, ref)
    tio.save_pytree(tpath, port)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    back = jio.load_pytree(tpath)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jio.load_pytree(jpath))
    ae_path = str(tmp_path / "ae.npz")
    tio.save_pytree(ae_path, files["ae"])  # lists of blocks: numeric path parts
    tree_equal(jio.load_pytree(ae_path), files["ae"])
    tree_equal(tio.load_pytree(ae_path), files["ae"])


def _train_setup(seed: int):
    from echo_tts_tpu_torch.bench.fast_init import fast_random_like
    from echo_tts_tpu_torch.train.loop import TrainConfig, make_train_step
    from echo_tts_tpu_torch.train.lora import LoRAConfig, init_lora

    cfg = tc.DiTConfig(has_latent_modules=False).tiny()
    params = fast_random_like(lambda d: tdit.init_dit_params(cfg, torch.float32, d), seed=seed,
                              device="cpu")
    lc = LoRAConfig(rank=4, alpha=8.0)
    lora = init_lora(torch.Generator().manual_seed(seed), params, lc)
    opt, step = make_train_step(cfg, TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                                 total_steps=10), model_dtype=torch.float32,
                                lora_cfg=lc)
    return cfg, params, lora, opt, step


def _batch(i: int) -> dict:
    rng = np.random.default_rng(100 + i)
    return {"latent": rng.standard_normal((2, 16, 80)).astype(np.float32),
            "latent_mask": np.ones((2, 16), bool),
            "text_input_ids": rng.integers(0, 256, (2, 24)).astype(np.int32),
            "text_mask": np.ones((2, 24), bool),
            "speaker_latent": rng.standard_normal((2, 8, 80)).astype(np.float32),
            "speaker_mask": np.ones((2, 8), bool)}


def test_train_state_resume_is_bit_exact(tmp_path):
    """Two LoRA steps, save the train state, load it into fresh templates,
    one more step: the adapters, the optimizer moments and count and the
    loss equal three uninterrupted steps bit for bit."""
    _, params, lora, opt, step = _train_setup(0)
    state = opt.init(lora)
    losses = []
    for i in range(3):
        lora, state, loss = step(params, lora, state, torch.Generator().manual_seed(50 + i),
                                 _batch(i))
        losses.append(float(loss))
        if i == 1:
            tio.save_train_state(str(tmp_path / "run"), lora, state, step=2)
    _, params2, lora2, opt2, step2 = _train_setup(0)
    like = opt2.init(lora2)
    lora2, state2, n = tio.load_train_state(str(tmp_path / "run"), lora2, like)
    assert n == 2 and state2.count == 2 and isinstance(state2.count, int)
    lora2, state2, loss = step2(params2, lora2, state2, torch.Generator().manual_seed(52),
                                _batch(2))
    assert float(loss) == losses[2]
    tree_equal(lora2, lora)
    tree_equal(state2.mu, state.mu)
    tree_equal(state2.nu, state.nu)
    assert state2.count == state.count == 3


def test_tree_leaves_format_checks_the_template(tmp_path):
    """load_pytree_like refuses another leaf count or shape, restores bf16
    from its raw bits, puts leaves on the asked device from meta templates,
    and keeps the string beside the leaves."""
    tree = {"b": [torch.randn(3).bfloat16(), torch.arange(4)], "a": torch.randn(2, 2)}
    path = str(tmp_path / "x.npz")
    tio.save_tree_leaves(path, tree, meta="hello")
    assert tio.read_tree_meta(path) == "hello"
    like = {"b": [torch.empty(3, dtype=torch.bfloat16, device="meta"),
                  torch.empty(4, dtype=torch.int64, device="meta")],
            "a": torch.empty(2, 2, device="meta")}
    tree_equal(tio.load_pytree_like(path, like, device="cpu"), tree)
    with pytest.raises(ValueError, match="leaves"):
        tio.load_pytree_like(path, {"a": like["a"]}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tio.load_pytree_like(path, dict(like, a=torch.empty(4, device="meta")), device="cpu")


def test_pca_from_safetensors(files):
    """PCAState.from_safetensors reads the JAX package's three entries."""
    got = PCAState.from_safetensors(files["paths"]["pca"], device="cpu")
    ref = JPCAState.from_safetensors(files["paths"]["pca"])
    assert got.latent_scale == ref.latent_scale == 1.5
    assert np.array_equal(got.components.numpy(), np.asarray(ref.components))
    assert np.array_equal(got.mean.numpy(), np.asarray(ref.mean))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PCAState.from_safetensors(files["paths"]["pca"])


def test_hub_entry_points(files, monkeypatch):
    """The hub loaders fetch through huggingface_hub.hf_hub_download (here
    monkeypatched onto the local files) and build an EchoTTS; without the
    package they raise a clear RuntimeError."""
    import huggingface_hub

    from echo_tts_tpu_torch.pipeline.pipeline import EchoTTS

    calls = []

    def fake_download(repo_id, filename, token=None):
        calls.append((repo_id, filename))
        if filename == "pca_state.safetensors":
            return files["paths"]["pca"]
        return files["paths"]["ae" if repo_id == "jordand/fish-s1-dac-min" else "dit"]

    monkeypatch.setattr(huggingface_hub, "hf_hub_download", fake_download)
    params, cfg = tio.load_model_from_hf(device="cpu", dtype=torch.float32)
    assert cfg == tc.DiTConfig().tiny()
    tts = tio.load_tts_from_hf(device="cpu", dit_dtype=torch.float32,
                               delete_blockwise_modules=True)
    assert isinstance(tts, EchoTTS) and not tts.dit_cfg.has_latent_modules
    assert tts.ae_cfg.latent_dim == tc.AEConfig().tiny().latent_dim
    assert tts.pca.latent_scale == 1.5 and tts.device.type == "cpu"
    assert tts.ae_params["decoder"]["stem"]["w"].dtype == torch.float32
    assert ("jordand/echo-tts-base", "pytorch_model.safetensors") in calls
    assert ("jordand/fish-s1-dac-min", "pytorch_model.safetensors") in calls
    assert ("jordand/echo-tts-base", "pca_state.safetensors") in calls
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub is not installed"):
        tio.maybe_hf_download("jordand/echo-tts-base", "pytorch_model.safetensors")


def test_int8_cache(files, tmp_path):
    """Engine(int8=True, int8_cache_path=p): the first engine quantizes and
    writes p, the second loads p without quantizing, equal bit for bit to
    a fresh quantization, and serves the same bytes; a cache written for
    another config or with the encoders flag is refused."""
    from echo_tts_tpu_torch.models import quant
    from echo_tts_tpu_torch.serve import __main__ as serve_main
    from echo_tts_tpu_torch.serve.server import wav_bytes

    sc = tc.SamplerConfig(num_steps=2, sequence_length=16)
    path = str(tmp_path / "q.npz")
    argv = ["--cpu", "--dit", files["paths"]["dit"], "--ae", files["paths"]["ae"],
            "--pca", files["paths"]["pca"], "--int8", "--int8-cache", path]
    bodies, engines = [], []
    try:
        for _ in range(2):
            eng = serve_main.build_engine(serve_main.parse_args(argv))
            engines.append(eng)
            audio, _, _ = eng.generate("Cache me.", None, seed=3, sc=sc)
            bodies.append(wav_bytes(audio[0], eng.tts.ae_cfg.sample_rate))
        first, second = engines
        assert first.int8_base["how"] == "quantized" and "save_seconds" in first.int8_base
        assert second.int8_base["how"] == "loaded" and os.path.exists(path)
        tree_equal(second.tts.dit_params, quant.quantize_dit_params(second._base_params))
        tree_equal(second.tts.dit_params, first.tts.dit_params)
        assert bodies[0] == bodies[1]
    finally:
        for eng in engines:
            eng.close()
    base = engines[0]._base_params
    with pytest.raises(ValueError, match="does not match"):
        quant.load_quantized(path, base, dataclasses.replace(
            engines[0].tts.dit_cfg, norm_eps=1e-6))
    with pytest.raises(ValueError, match="does not match"):
        quant.load_quantized(path, base, engines[0].tts.dit_cfg, encoders=True)
