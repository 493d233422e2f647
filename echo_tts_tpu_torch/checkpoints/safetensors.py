"""A reader and a writer of the safetensors format, on the standard library,
numpy and torch (no `safetensors` package).

A file is an 8-byte little-endian header length, a JSON header mapping each
tensor name to `{"dtype", "shape", "data_offsets": [begin, end]}` (offsets
into the data that follows the header) with an optional `"__metadata__"`
map of strings, then the raw little-endian bytes.

`SafeTensorsFile` reads through `mmap`: nothing is copied until a tensor is
asked for, and a numpy view of a tensor that needs no conversion is the
mapped bytes themselves. BF16 comes back as a torch bf16 tensor, or upcast
to fp32 on request (numpy has no bf16: `numpy()` upcasts). The writer takes
torch tensors and numpy arrays, and raw bf16 bits as 2-byte void items
(`BF16_BITS`, how npz holds bf16).
"""
from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch

_NP = {"F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32,
       "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}
_TORCH = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
          "U8": torch.uint8, "BOOL": torch.bool}
_CODE_OF_TORCH = {v: k for k, v in _TORCH.items()}
_CODE_OF_NP = {np.dtype(v): k for k, v in _NP.items()}
BF16_BITS = np.dtype("V2")  # a bf16 value's raw bits, as numpy cannot hold bf16
_MAX_HEADER = 100 << 20


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Raw bf16 bits (any 2-byte dtype) -> float32, exactly."""
    u = np.ascontiguousarray(bits).view(np.uint16).astype(np.uint32) << 16
    return u.view(np.float32).reshape(np.shape(bits))


class SafeTensorsFile(Mapping):
    """A safetensors file mapped read-only. A Mapping of name -> numpy array
    (`numpy(name)`), with `tensor(name)` for torch and `shape`/`dtype` read
    from the header alone."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", head)
            if n > _MAX_HEADER:
                raise ValueError(f"{path}: header of {n} bytes is not plausible")
            header = json.loads(f.read(n))
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._base = 8 + n
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._info: Dict[str, dict] = header
        size = len(self._mm) - self._base
        for name, info in header.items():
            if info["dtype"] not in _TORCH:
                raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
            b, e = info["data_offsets"]
            want = int(np.prod(info["shape"], dtype=np.int64)) * self._itemsize(name)
            if not 0 <= b <= e <= size or e - b != want:
                raise ValueError(f"{path}: {name} has data offsets {b}..{e}, "
                                 f"expected {want} bytes inside {size}")

    def _itemsize(self, name: str) -> int:
        return torch.empty((), dtype=_TORCH[self._info[name]["dtype"]]).element_size()

    # -- Mapping --------------------------------------------------------------
    def __getitem__(self, name: str) -> np.ndarray:
        return self.numpy(name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._info)

    def __len__(self) -> int:
        return len(self._info)

    def __contains__(self, name) -> bool:
        return name in self._info

    # -- tensors ----------------------------------------------------------------
    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._info[name]["shape"])

    def dtype(self, name: str) -> str:
        """The header's dtype code (F32, BF16, ...)."""
        return self._info[name]["dtype"]

    def _bytes(self, name: str) -> memoryview:
        b, e = self._info[name]["data_offsets"]
        return memoryview(self._mm)[self._base + b:self._base + e]

    def numpy(self, name: str) -> np.ndarray:
        """A read-only view of the mapped bytes; BF16 upcast to float32 (a
        copy: numpy has no bf16)."""
        code, shape = self.dtype(name), self.shape(name)
        if code == "BF16":
            return bf16_bits_to_f32(np.frombuffer(self._bytes(name), BF16_BITS).reshape(shape))
        return np.frombuffer(self._bytes(name), dtype=_NP[code]).reshape(shape)

    def tensor(self, name: str, upcast_bf16: bool = False) -> torch.Tensor:
        """A CPU tensor over the mapped bytes (read-only memory: copy, or
        move it to a device, before writing to it)."""
        code, shape = self.dtype(name), self.shape(name)
        buf = self._bytes(name)
        if len(buf) == 0:
            t = torch.empty(shape, dtype=_TORCH[code])
        else:
            import warnings

            with warnings.catch_warnings():  # torch warns that the buffer is read-only
                warnings.simplefilter("ignore", UserWarning)
                t = torch.frombuffer(buf, dtype=_TORCH[code]).reshape(shape)
        return t.float() if upcast_bf16 and code == "BF16" else t

    def close(self) -> None:
        """Unmap the file; while numpy views of it are still alive, the map
        stays until the last of them is gone."""
        try:
            self._mm.close()
        except BufferError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_file(path: str, device: Union[str, torch.device] = "cpu",
              upcast_bf16: bool = False) -> Dict[str, torch.Tensor]:
    """Every tensor of a file, as torch tensors on `device` (copies; the
    file is closed on return)."""
    with SafeTensorsFile(path) as f:
        return {k: f.tensor(k, upcast_bf16).to(device, copy=True) for k in f}


def load_numpy(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a file as a numpy array (copies), BF16 upcast to
    float32: what the JAX package's `convert.load_safetensors` promises."""
    with SafeTensorsFile(path) as f:
        return {k: np.array(f.numpy(k)) for k in f}


def _np_code(a: np.ndarray) -> str:
    if a.dtype == BF16_BITS:
        return "BF16"
    code = _CODE_OF_NP.get(a.dtype) if a.dtype.byteorder != ">" else None
    if code is None:
        raise ValueError(f"unsupported numpy dtype {a.dtype}")
    return code


def _code_shape_nbytes(x) -> Tuple[str, Tuple[int, ...], int]:
    if isinstance(x, torch.Tensor):
        code = _CODE_OF_TORCH.get(x.dtype)
        if code is None:
            raise ValueError(f"unsupported torch dtype {x.dtype}")
        return code, tuple(x.shape), x.numel() * x.element_size()
    a = np.asarray(x)
    return _np_code(a), tuple(a.shape), a.nbytes


def _raw_bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu().reshape(-1)
        return t.view(torch.uint8).numpy() if t.numel() else np.empty(0, np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write torch tensors or numpy arrays (a BF16_BITS array is written as
    BF16) to `path`, one tensor at a time; returns the file's bytes. The
    header is padded with spaces to a multiple of 8 bytes, as the
    `safetensors` package pads it."""
    names = list(tensors)
    infos, off = {}, 0
    for name in names:
        try:
            code, shape, n = _code_shape_nbytes(tensors[name])
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
        infos[name] = {"dtype": code, "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    header = dict(infos)
    if metadata:
        header = {"__metadata__": {str(k): str(v) for k, v in metadata.items()}, **header}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            f.write(memoryview(_raw_bytes(tensors[name])))
    return 8 + len(blob) + off
