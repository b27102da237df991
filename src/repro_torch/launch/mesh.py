"""The ``groups`` mesh of the groups-sharded dataplane.

The counterpart of ``repro.launch.mesh.make_group_mesh``.  The reference's
sharded round has no collective: groups share no state, and every per-group
scalar is host-authoritative and enters each dispatch replicated.  So its
``shard_map`` is a single-controller loop over shards, and the port writes
it as one (``core.fabric``).  A ``GroupMesh`` says how many shards the G
group slabs partition into and on which device they live.

All shards of a ``GroupMesh`` sit on one device: ``make_group_mesh()`` gives
one shard per visible card, which on a one-card machine is a (1,) mesh, and
``make_group_mesh(n_shards=S)`` puts S logical shards on one device, the
port's counterpart of the reference's forced host device count.  A mesh over
several distinct cards raises ``NotImplementedError``: it waits for the
slice that runs the fabric consensus on ``torch.distributed`` (ROADMAP.md
queue 1, item 6).

Capacity planning is the reference's: G is the capacity of the group axis,
fixed at construction and divisible by the shard count; tenants come and go
over a free-list within it and never re-shard.
"""

from __future__ import annotations

import dataclasses

import torch

_MULTI_CARD = "ROADMAP.md queue 1, item 6 (meshes over several cards)"


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
    from ..core.api import resolve_device

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
