"""Meshes: the ``(data, model)`` host and production meshes on
``torch.distributed``'s ``DeviceMesh``, and the ``groups`` mesh of the
groups-sharded dataplane.

``make_host_mesh`` and ``make_production_mesh`` are the counterparts of
``repro.launch.mesh``'s, with the reference's shapes and axis names:

  * host:       (n // mp, mp)  axes (data, model)
  * single-pod: (16, 16)       axes (data, model)       256 ranks
  * multi-pod:  (2, 16, 16)    axes (pod, data, model)  512 ranks

One rank is one process and one device: NCCL over the cards (``device``
``None`` or ``"cuda"``), gloo over CPU processes (``device="cpu"``).  Under
``torchrun`` the process group comes from its environment; with no process
group and no such environment a world of one starts on a local store, so
one process on one card (and the tests) gets a (1, 1) mesh.  A world whose
size is not the mesh's raises ``ValueError``, as ``jax.make_mesh`` refuses.

``make_group_mesh`` is the counterpart of
``repro.launch.mesh.make_group_mesh``.  The reference's sharded round has
no collective: groups share no state, and every per-group
scalar is host-authoritative and enters each dispatch replicated.  So its
``shard_map`` is one controller over the process's local devices, and the
port writes it as one process that loops over the shards (``core.fabric``),
with no ``torch.distributed`` and no copy between cards.  A ``GroupMesh``
names one device per shard: shard ``s`` keeps its slab of the G groups on
``devices[s]``, and ``devices[0]`` is the home device, where the controller
keeps what is its own (the snapshot seals).

``make_group_mesh()`` gives one shard per visible card (``cuda:0`` ...
``cuda:C-1``; a (1,) mesh on a one-card machine), and ``make_group_mesh(S,
device)`` S logical shards on one device, the port's counterpart of the
reference's forced host device count, each with a slab of its own; any
other layout is ``GroupMesh(devices)``.  (The acceptor-sharded consensus,
which does have collectives, runs on a ``DeviceMesh``:
``core.fabric.make_fabric_consensus``.)

Capacity planning is the reference's: G is the capacity of the group axis,
fixed at construction and divisible by the shard count; tenants come and go
over a free-list within it and never re-shard.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class GroupMesh:
    """A 1-D mesh of group shards: shard ``s`` on ``devices[s]``, one device
    type for all.  ``shape`` maps each axis name to its size, as a
    ``jax.sharding.Mesh`` does, so the dataplane validates it with the
    reference's checks and messages."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("groups",)

    def __post_init__(self) -> None:
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one shard, got 0")
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"a mesh's shards share one device type, got {devices}")
        object.__setattr__(self, "devices", devices)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The home device, shard 0's."""
        return self.devices[0]

    @property
    def shape(self) -> dict[str, int]:
        return {name: self.n_shards for name in self.axis_names}


def make_group_mesh(n_shards: int = 0, device: torch.device | str | None = None) -> GroupMesh:
    """A 1-D mesh with one ``groups`` axis.  ``n_shards=0`` gives one shard
    per visible card when ``device`` is ``None`` or ``"cuda"``, else one
    shard on ``device``; ``n_shards=S`` puts S logical shards on ``device``.
    ``device=None`` means the card, and asking for the card where there is
    none raises."""
    from ..core.device import resolve_device

    dev = resolve_device(device)
    if n_shards:
        return GroupMesh((dev,) * n_shards)
    if dev.type == "cuda" and dev.index is None:
        return GroupMesh(tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count())))
    return GroupMesh((dev,))


# ---------------------------------------------------------------------------
# (data, model) meshes on torch.distributed
# ---------------------------------------------------------------------------
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def ensure_process_group(device: torch.device) -> int:
    """The world size, after starting a process group where there is none:
    from ``torchrun``'s environment where it is set, else a world of one on
    a local store.  NCCL on the card, gloo on the CPU."""
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if all(k in os.environ for k in _TORCHRUN_ENV):
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def _device_mesh(shape: tuple[int, ...], names: tuple[str, ...], device):
    from torch.distributed.device_mesh import init_device_mesh

    from ..core.device import resolve_device

    dev = resolve_device(device)
    world = ensure_process_group(dev)
    need = math.prod(shape)
    if world != need:
        raise ValueError(
            f"a {shape} mesh over {names} needs a world of {need} ranks, this one has {world}"
        )
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: torch.device | str | None = None):
    """The (16, 16) ``(data, model)`` mesh, or (2, 16, 16) ``(pod, data,
    model)`` with ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device)


def make_host_mesh(
    n_devices: int = 0, model_parallel: int = 1, device: torch.device | str | None = None
):
    """A ``(n // mp, mp)`` ``(data, model)`` mesh over the world's ranks
    (``n_devices=0``: all of them)."""
    from ..core.device import resolve_device

    n = n_devices or ensure_process_group(resolve_device(device))
    mp = model_parallel
    if mp < 1 or n % mp:
        raise ValueError(f"model_parallel {mp} does not divide {n} devices")
    return _device_mesh((n // mp, mp), ("data", "model"), device)
