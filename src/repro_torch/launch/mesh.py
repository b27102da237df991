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
``shard_map`` is a single-controller loop over shards, and the port writes
it as one (``core.fabric``).  A ``GroupMesh`` says how many shards the G
group slabs partition into and on which device they live.

All shards of a ``GroupMesh`` sit on one device: ``make_group_mesh()`` gives
one shard per visible card, which on a one-card machine is a (1,) mesh, and
``make_group_mesh(n_shards=S)`` puts S logical shards on one device, the
port's counterpart of the reference's forced host device count.  A mesh over
several distinct cards raises ``NotImplementedError`` (ROADMAP.md queue 1,
item 6(a)): the reference's is one controller over the process's local
devices, with no collective, which the port would write as one process
driving each card's slab, with no ``torch.distributed``; that is not
written yet.  (The acceptor-sharded consensus, which does have
collectives, runs on a ``DeviceMesh``: ``core.fabric.make_fabric_consensus``.)

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

_MULTI_CARD = (
    "ROADMAP.md queue 1, item 6 (a groups mesh over several cards: one controller over "
    "the process's cards, with no collective)"
)


@dataclasses.dataclass(frozen=True)
class GroupMesh:
    """A 1-D mesh of ``n_shards`` group shards on ``device``.  ``shape``
    maps each axis name to its size, as a ``jax.sharding.Mesh`` does, so the
    dataplane validates it with the reference's checks and messages."""

    n_shards: int
    device: torch.device
    axis_names: tuple[str, ...] = ("groups",)

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(f"a mesh needs at least one shard, got {self.n_shards}")

    @property
    def shape(self) -> dict[str, int]:
        return {name: self.n_shards for name in self.axis_names}


def make_group_mesh(n_shards: int = 0, device: torch.device | str | None = None) -> GroupMesh:
    """A 1-D mesh with one ``groups`` axis.  ``n_shards=0`` gives one shard
    per visible card; ``device=None`` means the card, and asking for the
    card where there is none raises.  ``n_shards=S`` puts S logical shards
    on ``device``."""
    from ..core.device import resolve_device

    dev = resolve_device(device)
    if n_shards == 0:
        cards = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
        if cards > 1:
            raise NotImplementedError(
                f"a groups mesh over {cards} distinct cards is not ported yet: {_MULTI_CARD}; "
                "pass n_shards and a device for logical shards on one card"
            )
        n_shards = 1
    return GroupMesh(n_shards=n_shards, device=dev)


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
