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

Bounds, as `jax.distributed.initialize` sets them (initialization_timeout=300,
heartbeat_timeout_seconds=100): the rendezvous fails after INIT_TIMEOUT, and
a collective of the world, dp or tp group, or a status exchange of the
engine, that waits on a dead or absent rank fails after COLLECTIVE_TIMEOUT.
Under gloo the waiting rank raises a RuntimeError (a peer that has exited
is seen at once: its sockets close); under nccl the watchdog tears the
process down with a message that names the collective. Only the control
group, where an idle server's followers wait for the next call, keeps
CONTROL_TIMEOUT.

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
# jax.distributed.initialize's defaults: initialization_timeout=300 and
# heartbeat_timeout_seconds=100
INIT_TIMEOUT = datetime.timedelta(seconds=300)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=100)
# the bounds of this process's group, which make_mesh gives the groups it
# creates (torch's new_group takes its backend's default, not the world's)
_bounds = {"init": INIT_TIMEOUT, "collective": COLLECTIVE_TIMEOUT}


def _bound(group, timeout: datetime.timedelta) -> None:
    """Set `group`'s collective timeout. A group connects its ranks under the
    timeout it was created with (gloo connects when it is created), so each
    is created under the rendezvous bound and then given its own."""
    dist.distributed_c10d._set_pg_timeout(timeout, group)


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                         rank: Optional[int] = None, backend: Optional[str] = None,
                         device=None, init_timeout: datetime.timedelta = INIT_TIMEOUT,
                         timeout: datetime.timedelta = COLLECTIVE_TIMEOUT) -> None:
    """`torch.distributed.init_process_group` with an explicit backend and
    init method (`tcp://localhost:<port>` or `file://<path>`). backend None
    takes nccl for a CUDA `device` and gloo for the CPU. A no-op for one
    process (no init_method and world_size None or 1). Raises when nccl is
    asked for more ranks than this host has cards: NCCL refuses two ranks on
    one device; pass backend="gloo" to share a card.

    init_timeout bounds the rendezvous (every rank joining the store and
    connecting; also the creation of each group of `make_mesh`); timeout
    bounds every collective of the world group and of the dp, tp and status
    groups of `make_mesh`."""
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
                            rank=rank, timeout=init_timeout)
    _bound(None, timeout)
    _bounds.update(init=init_timeout, collective=timeout)


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (dp, tp) mesh: the groups of its two axes, its
    coordinates and its device. `control` and `status` are gloo groups of
    every rank for host-side objects: the engine's call descriptors, which a
    follower waits for as long as the server is idle (CONTROL_TIMEOUT), and
    the status exchanges around each call (the collective bound). A
    one-process mesh has no groups."""

    config: MeshConfig
    device: torch.device
    rank: int = 0
    dp_rank: int = 0
    tp_rank: int = 0
    dp_group: Optional[object] = None
    tp_group: Optional[object] = None
    control: Optional[object] = None
    status: Optional[object] = None

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
    rank = dp_rank · tp + tp_rank), and registered as this process's
    tensor-parallel group (`parallel/tp.py`). Every group it creates carries
    the collective bound given to `initialize_multihost` but the control
    group, which carries CONTROL_TIMEOUT. Without a process group only the
    one-rank mesh exists."""
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
    rank = dist.get_rank()

    def group(ranks, timeout, backend=None):
        # every rank creates every group, in the same order (new_group is
        # collective)
        g = dist.new_group(ranks, timeout=_bounds["init"], backend=backend)
        if rank in ranks:
            _bound(g, timeout)
        return g

    bound, every = _bounds["collective"], list(range(world))
    tps = [group([d * mc.tp + t for t in range(mc.tp)], bound) for d in range(mc.dp)]
    dps = [group([d * mc.tp + t for d in range(mc.dp)], bound) for t in range(mc.tp)]
    mesh = Mesh(mc, device, rank=rank, dp_rank=rank // mc.tp, tp_rank=rank % mc.tp,
                dp_group=dps[rank % mc.tp], tp_group=tps[rank // mc.tp],
                control=group(every, CONTROL_TIMEOUT, "gloo"),
                status=group(every, bound, "gloo"))
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
