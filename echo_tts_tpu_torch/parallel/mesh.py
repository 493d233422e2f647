"""A (dp, tp) process mesh on torch.distributed (counterpart of
echo_tts_tpu/parallel/mesh.py).

One process a rank. Axes: "dp", independent utterances (sampling needs no
collective); "tp", Megatron sharding of the DiT's heads and MLP columns
(`parallel/sharding.py`), one all-reduce after each row-sharded product
(`parallel/tp.py`).

The backend is always explicit: nccl for CUDA ranks and gloo for CPU ranks
by default, gloo on CUDA when the caller asks for it. NCCL takes one device
a rank, so more ranks than cards under nccl raise; two ranks that share one
card run over gloo, which takes CUDA tensors. No backend or device is ever
changed quietly.

    initialize_multihost("tcp://localhost:29500", world_size=2, rank=r, device=dev)
    mesh = make_mesh(MeshConfig(dp=1, tp=2), dev)   # registers mesh.tp_group
    params = shard_params(params, mesh)             # this rank's slices
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

from echo_tts_tpu_torch.core.config import MeshConfig

# the engine's descriptors may wait for a request for as long as a server
# is idle
CONTROL_TIMEOUT = datetime.timedelta(days=30)


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                         rank: Optional[int] = None, backend: Optional[str] = None,
                         device=None) -> None:
    """`torch.distributed.init_process_group` with an explicit backend and
    init method (`tcp://localhost:<port>` or `file://<path>`). backend None
    takes nccl for a CUDA `device` and gloo for the CPU. A no-op for one
    process (no init_method and world_size None or 1). Raises when nccl is
    asked for more ranks than this host has cards: NCCL refuses two ranks on
    one device; pass backend="gloo" to share a card."""
    if init_method is None and (world_size is None or world_size <= 1):
        return
    if init_method is None or world_size is None or rank is None:
        raise ValueError("initialize_multihost needs init_method, world_size and rank")
    device = torch.device("cpu" if device is None else device)
    backend = backend or default_backend(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"nccl needs CUDA ranks, this rank's device is {device}")
        n = torch.cuda.device_count()
        if world_size > n:
            raise RuntimeError(
                f"nccl with {world_size} ranks needs {world_size} cards, this host has {n}: "
                f"NCCL refuses two ranks on one device; pass backend='gloo' to share a card")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank)


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (dp, tp) mesh: the groups of its two axes, its
    coordinates and its device. `control` is a gloo group of every rank for
    host-side objects (the engine's call descriptors); it is the default
    group when that is gloo. A one-process mesh has no groups."""

    config: MeshConfig
    device: torch.device
    rank: int = 0
    dp_rank: int = 0
    tp_rank: int = 0
    dp_group: Optional[object] = None
    tp_group: Optional[object] = None
    control: Optional[object] = None
    device_mesh: Optional[object] = None

    @property
    def dp(self) -> int:
        return self.config.dp

    @property
    def tp(self) -> int:
        return self.config.tp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}


def make_mesh(mc: MeshConfig, device=None) -> Mesh:
    """The mesh of `mc` over the ranks of the default process group (row-major:
    rank = dp_rank · tp + tp_rank), built with
    `init_device_mesh(..., mesh_dim_names=("dp", "tp"))`, and registered as
    this process's tensor-parallel group (`parallel/tp.py`). Without a
    process group only the one-rank mesh exists."""
    from echo_tts_tpu_torch.parallel import tp as tp_mod

    device = torch.device("cpu" if device is None else device)
    if not dist.is_initialized():
        if mc.num_devices != 1:
            raise RuntimeError(f"a {mc.dp}x{mc.tp} mesh needs a process group of "
                               f"{mc.num_devices} ranks (initialize_multihost)")
        mesh = Mesh(mc, device)
        tp_mod.set_mesh(mesh)
        return mesh
    world = dist.get_world_size()
    if world != mc.num_devices:
        raise ValueError(f"a {mc.dp}x{mc.tp} mesh needs {mc.num_devices} ranks, the process "
                         f"group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, (mc.dp, mc.tp), mesh_dim_names=("dp", "tp"))
    rank = dist.get_rank()
    control = (dist.group.WORLD if dist.get_backend() == "gloo"
               else dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT))
    mesh = Mesh(mc, device, rank=rank, dp_rank=rank // mc.tp, tp_rank=rank % mc.tp,
                dp_group=dm.get_group("dp"), tp_group=dm.get_group("tp"), control=control,
                device_mesh=dm)
    if (dm.get_local_rank("dp"), dm.get_local_rank("tp")) != (mesh.dp_rank, mesh.tp_rank):
        raise RuntimeError("the device mesh is not row-major over the ranks")
    tp_mod.set_mesh(mesh)
    return mesh


def auto_mesh_config(n_devices: int, max_tp: int = 2) -> MeshConfig:
    """Prefer dp (sampling needs no collective); use the largest tp up to
    max_tp that divides the device count."""
    tp = 1
    for cand in range(min(max_tp, n_devices), 0, -1):
        if n_devices % cand == 0:
            tp = cand
            break
    return MeshConfig(dp=n_devices // tp, tp=tp)


def destroy() -> None:
    """Unregister the mesh and tear the process group down (a no-op
    without one)."""
    from echo_tts_tpu_torch.parallel import tp as tp_mod

    tp_mod.set_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()
