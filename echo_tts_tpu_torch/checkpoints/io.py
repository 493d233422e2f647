"""Checkpoint I/O (counterpart of echo_tts_tpu/checkpoints/io.py): the npz
formats and the loaders of the reference's safetensors checkpoints.

Formats:
  * `save_pytree` / `load_pytree`: an npz of a nested dict/list tree, one
    entry a leaf under its path joined by `//` (list indices as numbers).
    The format the two packages share: a DiT or AE npz written by the JAX
    package's `save_pytree` loads here (through `load_pytree` and
    `checkpoints/from_jax.py`), and a JAX-layout tree written here loads in
    the JAX package's `load_pytree`.
  * `save_tree_leaves` / `load_pytree_like` and the train state: the leaves
    of one of the port's trees (dicts in sorted key order, lists, dataclasses
    such as `train/loop.py:OptState`, tensors and numbers) in that order,
    restored into the structure, dtypes and devices of a template. They hold
    the port's own trees, not the JAX package's optax states.
  bf16 leaves go through npz as their raw bytes (numpy has no bf16; the JAX
  package's ml_dtypes leaves land the same way, as 2-byte void items).
  * Reference safetensors (`pytorch_model.safetensors` of the DiT and of
    the Fish S1-DAC, `pca_state.safetensors`), read by the port's own reader
    (`checkpoints/safetensors.py`) and converted by `checkpoints/convert.py`.
    The DiT is converted leaf by leaf on the target device, each source
    tensor copied from the mapped file and cast to the target dtype as it is
    read, so the host never holds a second copy of the weights.

Sharded loading (`load_pytree_sharded`) and Orbax belong to multi-GPU
(ROADMAP.md §1 item 8) and are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from echo_tts_tpu_torch.checkpoints import convert as cv
from echo_tts_tpu_torch.checkpoints.safetensors import BF16_BITS, SafeTensorsFile, bf16_bits_to_f32
from echo_tts_tpu_torch.core.config import AEConfig, DiTConfig
from echo_tts_tpu_torch.core.device import resolve_device
from echo_tts_tpu_torch.train.loop import tree_leaves

SEP = "//"


def to_numpy(x) -> np.ndarray:
    """A leaf as numpy: a bf16 tensor as its raw bits (dtype V2), any other
    tensor through the host, anything else through `np.asarray`."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(BF16_BITS)
        return x.numpy()
    return np.asarray(x)


def _from_numpy(arr: np.ndarray, like: torch.Tensor, device=None) -> torch.Tensor:
    """An npz leaf as a tensor with the template's dtype, on `device` (the
    template's when None)."""
    if arr.dtype.kind == "V":
        if like.dtype != torch.bfloat16 or arr.dtype.itemsize != 2:
            raise ValueError(f"a {arr.dtype} leaf cannot restore a {like.dtype} tensor")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device if device is None else device, dtype=like.dtype)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{SEP}{i}" if prefix else str(i)))
    else:
        out[prefix] = to_numpy(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_pytree(path: str, tree: Any) -> None:
    """A nested dict/list tree of tensors or arrays -> npz with `//` keys."""
    np.savez(path, **_flatten(tree))


def load_pytree(path: str, dtype=None) -> Any:
    """An npz of `save_pytree` (either package's) -> a tree of numpy arrays.
    bf16 leaves (raw 2-byte items) come back as float32, exactly; a numpy
    `dtype` casts every floating leaf. Carry the tree into the port with
    `checkpoints/from_jax.py` (its `dtype` restores bf16 bit for bit)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    for k, v in flat.items():
        if v.dtype.kind == "V" and v.dtype.itemsize == 2:
            v = bf16_bits_to_f32(v)
        if dtype is not None and v.dtype.kind == "f":
            v = v.astype(dtype)
        flat[k] = v
    return _unflatten(flat)


# ---------------------------------------------------------------------------
# Leaf-order formats: the port's own trees and the train state
# ---------------------------------------------------------------------------


def _rebuild(like, leaves: list, device=None):
    """`like`'s structure with the next leaves of `leaves` (consumed)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves, device) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, device) for v in like)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{f.name: _rebuild(getattr(like, f.name), leaves, device)
                                            for f in dataclasses.fields(like)})
    arr = leaves.pop(0)
    shape = tuple(getattr(like, "shape", ()))
    if tuple(arr.shape) != shape:
        raise ValueError(f"a leaf of shape {tuple(arr.shape)} where the template has {shape}")
    if isinstance(like, torch.Tensor):
        return _from_numpy(arr, like, device)
    if isinstance(like, np.ndarray):
        return arr.view(like.dtype) if arr.dtype.kind == "V" else arr.astype(like.dtype)
    return type(like)(arr.item())


def save_tree_leaves(path: str, tree: Any, meta: Optional[str] = None) -> None:
    """A tree by its leaf order, `leaf_000000`, ...; `meta`,
    a string, is kept beside them under `__meta__`."""
    flat = {f"leaf_{i:06d}": to_numpy(x) for i, x in enumerate(tree_leaves(tree))}
    if meta is not None:
        flat["__meta__"] = np.asarray(meta)
    np.savez(path, **flat)


def read_tree_meta(path: str) -> Optional[str]:
    with np.load(path) as z:
        return str(z["__meta__"]) if "__meta__" in z.files else None


def load_pytree_like(path: str, like: Any, device=None) -> Any:
    """A `save_tree_leaves` file restored into the exact structure, dtypes,
    devices and shapes of `like` (a template whose values are not read: with
    `device` given, its tensors may be meta tensors and the leaves go to
    `device`). Raises on a leaf count or shape that differs."""
    with np.load(path) as z:
        names = sorted(k for k in z.files if k.startswith("leaf_"))
        n_like = len(tree_leaves(like))
        if len(names) != n_like:
            raise ValueError(f"{path} has {len(names)} leaves, the template {n_like}")
        leaves = [z[k] for k in names]
    return _rebuild(like, leaves, device)


def save_train_state(path_prefix: str, params: Any, opt_state: Any, step: int = 0) -> None:
    """A whole training checkpoint: params, optimizer state, step counter."""
    save_tree_leaves(path_prefix + ".params.npz", params)
    save_tree_leaves(path_prefix + ".opt.npz", opt_state)
    np.savez(path_prefix + ".meta.npz", step=np.asarray(step))


def load_train_state(path_prefix: str, params_like: Any, opt_state_like: Any):
    params = load_pytree_like(path_prefix + ".params.npz", params_like)
    opt_state = load_pytree_like(path_prefix + ".opt.npz", opt_state_like)
    with np.load(path_prefix + ".meta.npz") as z:
        step = int(z["step"])
    return params, opt_state, step


# ---------------------------------------------------------------------------
# Reference-format loaders
# ---------------------------------------------------------------------------


class _DeviceState(Mapping):
    """A safetensors file as a mapping name -> tensor on `device`: each
    access copies the mapped bytes to the device, floating tensors cast to
    `dtype` on the way. `shape(name)` reads the header alone."""

    def __init__(self, f: SafeTensorsFile, device: torch.device, dtype: torch.dtype):
        self.f, self.device, self.dtype = f, device, dtype

    def __getitem__(self, name: str) -> torch.Tensor:
        t = self.f.tensor(name)
        return t.to(device=self.device, dtype=self.dtype if t.is_floating_point() else None,
                    copy=True)

    def __iter__(self):
        return iter(self.f)

    def __len__(self) -> int:
        return len(self.f)

    def __contains__(self, name) -> bool:
        return name in self.f

    def shape(self, name: str):
        return self.f.shape(name)


def load_dit_from_safetensors(path: str, cfg: Optional[DiTConfig] = None,
                              dtype: torch.dtype = torch.bfloat16,
                              delete_blockwise_modules: bool = False,
                              device=None) -> Tuple[dict, DiTConfig]:
    """The reference's EchoDiT `pytorch_model.safetensors` -> (the port's
    params on `device` (default cuda) in `dtype`, its DiTConfig, inferred
    from the tensor shapes unless given). delete_blockwise_modules drops the
    latent encoder, latent_norm and wk/wv_latent (the one-shot model).
    Leaves equal the JAX package's loader's, cast the same way."""
    dev = resolve_device(device)
    with SafeTensorsFile(path) as f:
        state = _DeviceState(f, dev, dtype)
        cfg = cfg or cv.infer_dit_config(state)
        cfg = dataclasses.replace(
            cfg, has_latent_modules=cfg.has_latent_modules and not delete_blockwise_modules)
        tree = cv.convert_dit_state(state, cfg)
    from echo_tts_tpu_torch.checkpoints.from_jax import dit_params_from_numpy

    return dit_params_from_numpy(tree, cfg, device=dev, dtype=dtype), cfg


def load_ae_from_safetensors(path: str, cfg: Optional[AEConfig] = None,
                             dtype: torch.dtype = torch.float32,
                             device=None) -> Tuple[dict, AEConfig]:
    """The Fish S1-DAC `pytorch_model.safetensors` -> (the port's params on
    `device` (default cuda) in `dtype`, its AEConfig). Weight-norm pairs are
    folded in float64 on the host (`convert.fold_weight_norm`)."""
    from echo_tts_tpu_torch.checkpoints.from_jax import ae_params_from_numpy

    dev = resolve_device(device)
    with SafeTensorsFile(path) as f:
        state = cv.fold_weight_norm(f)
        cfg = cfg or cv.infer_ae_config(state)
        params = ae_params_from_numpy(cv.convert_ae_state(state, cfg), cfg, device=dev,
                                      dtype=dtype)
        del state
    return params, cfg


def maybe_hf_download(repo_id: str, filename: str, token: Optional[str] = None) -> str:
    """`huggingface_hub.hf_hub_download` where the package is installed (and
    the network reachable); a clear error where it is not."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise RuntimeError(
            "huggingface_hub is not installed (the H100 machines this port is run on have "
            "none): download the safetensors by other means and use "
            "load_dit_from_safetensors / load_ae_from_safetensors / "
            "PCAState.from_safetensors on the local files") from e
    return hf_hub_download(repo_id, filename, token=token)


def load_model_from_hf(repo_id: str = "jordand/echo-tts-base",
                       dtype: torch.dtype = torch.bfloat16, token: Optional[str] = None,
                       delete_blockwise_modules: bool = False,
                       device=None) -> Tuple[dict, DiTConfig]:
    """The hub's `pytorch_model.safetensors` of a DiT repo -> (params, cfg)."""
    path = maybe_hf_download(repo_id, "pytorch_model.safetensors", token=token)
    return load_dit_from_safetensors(path, dtype=dtype,
                                     delete_blockwise_modules=delete_blockwise_modules,
                                     device=device)


def load_fish_ae_from_hf(repo_id: str = "jordand/fish-s1-dac-min",
                         dtype: torch.dtype = torch.float32, token: Optional[str] = None,
                         device=None) -> Tuple[dict, AEConfig]:
    """The hub's S1-DAC (fp32 by default; bf16 is the low-memory mode)."""
    path = maybe_hf_download(repo_id, "pytorch_model.safetensors", token=token)
    return load_ae_from_safetensors(path, dtype=dtype, device=device)


def load_pca_state_from_hf(repo_id: str = "jordand/echo-tts-base",
                           filename: str = "pca_state.safetensors",
                           token: Optional[str] = None, device=None):
    """The hub's PCA state -> models.pca.PCAState on `device`."""
    from echo_tts_tpu_torch.models.pca import PCAState

    return PCAState.from_safetensors(maybe_hf_download(repo_id, filename, token=token),
                                     device=device)


def load_tts_from_hf(model_repo: str = "jordand/echo-tts-base",
                     ae_repo: str = "jordand/fish-s1-dac-min",
                     dit_dtype: torch.dtype = torch.bfloat16,
                     ae_dtype: Optional[torch.dtype] = None, token: Optional[str] = None,
                     delete_blockwise_modules: bool = False, device=None):
    """The three hub entry points composed into a pipeline.EchoTTS. The AE
    comes in bf16 on the card (kernel K2 takes bf16 activations) and in
    fp32 on the CPU unless `ae_dtype` says otherwise."""
    from echo_tts_tpu_torch.pipeline.pipeline import EchoTTS

    dev = resolve_device(device)
    if ae_dtype is None:
        ae_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    dit_params, dit_cfg = load_model_from_hf(
        model_repo, dtype=dit_dtype, token=token,
        delete_blockwise_modules=delete_blockwise_modules, device=dev)
    ae_params, ae_cfg = load_fish_ae_from_hf(ae_repo, dtype=ae_dtype, token=token, device=dev)
    pca = load_pca_state_from_hf(model_repo, token=token, device=dev)
    return EchoTTS(dit_params, dit_cfg, ae_params, ae_cfg, pca, model_dtype=dit_dtype,
                   device=dev)
