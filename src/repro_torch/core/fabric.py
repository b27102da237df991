"""The groups-sharded multi-group round: G group slabs partitioned over the
shards of a ``groups`` mesh.

The counterpart of the groups-sharded half of ``repro.core.fabric``:
``make_sharded_multigroup_round`` (the full-width dispatch) and
``make_packed_sharded_round`` (the packed cohort dispatch).  The reference
runs its shard body under ``shard_map``; nothing crosses the mesh axis
during a round, because groups share no state, and every per-group scalar
is host-authoritative and enters the dispatch replicated.  So here a
dispatch is a single-controller loop over the shards, in shard order, each
shard's body on its contiguous ``(Gl, ...)`` slab view of the slot-indexed
``(G, ...)`` state: rows ``[s*Gl, (s+1)*Gl)`` are shard ``s``.  All shards
of a ``launch.mesh.GroupMesh`` sit on one device.

With ``use_kernels`` a full-width shard body is K1's shard slice
(``kernels.ops.shard_slab_round``) and a packed one K6
(``kernels.ops.packed_shard_round``), on the card, with their plain versions
on the CPU; without, the plain engine.  Each dispatch moves its host tables
(per-group or per-lane scalars and the burst) to the device in one copy.

Not ported: the acceptor-sharded consensus (``consensus_round``,
``make_fabric_consensus``) and the training commit
(``quorum_commit_digest``), whose ``psum`` needs a mesh over several cards
(ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from ..kernels import ops as kops
from . import batched
from .types import AcceptorState

INT32_MAX = 2**31 - 1


def _check_axis(mesh, axis: str) -> int:
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no {axis!r} axis: {mesh.axis_names}")
    return mesh.shape[axis]


def _upload(dev: torch.device, *tables: np.ndarray) -> list[torch.Tensor]:
    """Move host int32 tables to ``dev`` in one copy; each comes back as a
    contiguous view of its own shape."""
    flat = np.concatenate([np.ascontiguousarray(t, np.int32).reshape(-1) for t in tables])
    buf = torch.from_numpy(flat).to(dev)
    out, at = [], 0
    for t in tables:
        out.append(buf[at : at + t.size].view(t.shape))
        at += t.size
    return out


def _shard(state, s: int, gl: int):
    """Shard ``s``'s rows of a slab state: contiguous views, updated in
    place by the shard body."""
    return type(state)(*(x[s * gl : (s + 1) * gl] for x in vars(state).values()))


def _windows(next_inst: np.ndarray, b: int) -> np.ndarray:
    """Each row's instance window ``next_inst + [0, B)`` in int32 (wraps)."""
    inst = next_inst.astype(np.int64)[..., None] + np.arange(b)
    return ((inst + 2**31) % 2**32 - 2**31).astype(np.int32)


def make_sharded_multigroup_round(
    mesh,
    *,
    n_groups: int,
    quorum: int,
    axis: str = "groups",
    use_kernels: bool = False,
    group_block: int = 1,
) -> Callable[..., Any]:
    """The groups-sharded full-width dispatch: one call advances all G
    groups one Phase-2 round, shard by shard.  The per-group ``(G,)``
    watermark, round, membership and limit vectors and the ``(G, A)``
    liveness mask enter replicated, in slot order; each shard's body reads
    its window of them at its group offset.  A disabled group rides inert.
    ``group_block`` (the reference kernel's fold) must divide the per-shard
    slab; it changes no result here.

    Returns ``step(next_inst[G], crnd[G], enabled[G], alive[G, A], stack,
    lstate, values[G, B, V], active[G, B], reclaim_limit=None) -> (stack,
    lstate, fresh[G, B], inst[G, B], win[G, B], value[G, B, V])`` with the
    state updated in place; ``inst`` is host int32, the rest device
    tensors.  ``reclaim_limit=None`` is int32 max for every group."""
    n_sh = _check_axis(mesh, axis)
    if n_groups % n_sh:
        raise ValueError(
            f"n_groups={n_groups} must be divisible by the {axis!r} mesh axis size {n_sh}"
        )
    gl = n_groups // n_sh
    if group_block > 1 and gl % group_block:
        raise ValueError(f"group_block={group_block} must divide the per-shard slab {gl}")
    q = quorum

    def step(
        next_inst,
        crnd,
        enabled,
        alive,
        stack: AcceptorState,
        lstate: batched.LearnerState,
        values,
        active,
        reclaim_limit=None,
    ):
        del active  # sequenced fillers vote like P2As
        g = n_groups
        if stack.rnd.shape[0] != g:
            raise ValueError(f"slabs of {stack.rnd.shape[0]} groups for a {g}-group dispatch")
        ni = np.asarray(next_inst, np.int32).reshape((g,))
        if reclaim_limit is None:
            lim = np.full((g,), INT32_MAX, np.int32)
        else:
            lim = np.asarray(reclaim_limit, np.int32).reshape((g,))
        vals = np.asarray(values, np.int32)
        ctl = np.stack(
            [ni, np.asarray(crnd, np.int32).reshape((g,)),
             np.asarray(enabled, np.int32).reshape((g,)), lim]
        )  # fmt: skip
        ctl_d, al_d, vals_d = _upload(stack.rnd.device, ctl, np.asarray(alive, np.int32), vals)
        al_d = al_d != 0
        outs = []
        for s in range(n_sh):
            st, ls = _shard(stack, s, gl), _shard(lstate, s, gl)
            args = (s * gl, ctl_d[0], ctl_d[1], al_d, q, st, ls, vals_d[s * gl : (s + 1) * gl],
                    ctl_d[2], ctl_d[3])  # fmt: skip
            if use_kernels:
                _st, _ls, *out = kops.shard_slab_round(*args, group_block=group_block)
            else:
                _st, _ls, *out = batched.shard_slab_round(*args)
            outs.append(out)
        fresh, win, value = (torch.cat(x) for x in zip(*outs, strict=True))
        return stack, lstate, fresh, _windows(ni, vals.shape[1]), win, value

    return step


def make_packed_sharded_round(
    mesh,
    *,
    quorum: int,
    axis: str = "groups",
    use_kernels: bool = False,
    block_b: int | None = None,
) -> Callable[..., Any]:
    """The packed groups-sharded cohort dispatch: each shard advances only
    its resident, enabled cohort lanes, packed into a uniform ``(S, C)``
    lane table, instead of its full ``Gl``-row slab.  Lane ``j`` of shard
    ``s`` serves local slab row ``segids[s, j]`` with its own scalars; pad
    lanes (``enabled == 0``) are inert.  Every control table is per lane,
    packed by the caller in lane order:

        step(segids[S, C], next_inst[S, C], crnd[S, C], enabled[S, C],
             alive[S, C, A], stack, lstate, values[S, C, B, V],
             reclaim_limit[S, C] | None)
          -> (stack, lstate, fresh[S*C, B], inst[S*C, B], win[S*C, B],
              value[S*C, B, V])

    with shard ``s``'s lane ``j`` at packed row ``s*C + j``, the state
    updated in place as the full-width dispatch would (pads and absent rows
    untouched), ``inst`` host int32 and the rest device tensors.
    ``block_b`` is the reference kernel's batch block, checked on the kernel
    path only (None: 128); it changes no result."""
    n_sh = _check_axis(mesh, axis)
    q = quorum

    def packed_step(
        segids,
        next_inst,
        crnd,
        enabled,
        alive,
        stack: AcceptorState,
        lstate: batched.LearnerState,
        values,
        reclaim_limit=None,
    ):
        vals = np.asarray(values, np.int32)
        s_, c, b = vals.shape[:3]
        if s_ != n_sh or stack.rnd.shape[0] % n_sh:
            raise ValueError(
                f"a packed table of {s_} shards and slabs of {stack.rnd.shape[0]} groups "
                f"for a {n_sh}-shard mesh"
            )
        gl = stack.rnd.shape[0] // n_sh
        seg = np.asarray(segids, np.int32).reshape((n_sh, c))
        ni = np.asarray(next_inst, np.int32).reshape((n_sh, c))
        en = np.asarray(enabled, np.int32).reshape((n_sh, c))
        if reclaim_limit is None:
            lim = np.full((n_sh, c), INT32_MAX, np.int32)
        else:
            lim = np.asarray(reclaim_limit, np.int32).reshape((n_sh, c))
        ctl = np.stack([seg, ni, np.asarray(crnd, np.int32).reshape((n_sh, c)), en, lim], axis=1)
        al = np.asarray(alive, np.int32).reshape((n_sh, c, -1))
        ctl_d, al_d, vals_d = _upload(stack.rnd.device, ctl, al, vals)
        outs = []
        for s in range(n_sh):
            st, ls = _shard(stack, s, gl), _shard(lstate, s, gl)
            t = ctl_d[s]  # (5, C): segids, next_inst, crnd, enabled, limit
            if use_kernels:
                _st, _ls, *out = kops.packed_shard_round(
                    st, ls, t[0], t[1], t[2], al_d[s], q, vals_d[s], t[3], t[4],
                    block_b=block_b, lanes_host=(seg[s], en[s]),
                )  # fmt: skip
            else:
                _st, _ls, *out = batched.packed_multigroup_round(
                    st, ls, t[0], t[1], t[2], al_d[s], q, vals_d[s], t[3], t[4]
                )
            outs.append(out)
        fresh, win, value = (torch.cat(x) for x in zip(*outs, strict=True))
        return stack, lstate, fresh, _windows(ni.reshape(-1), b), win, value

    return packed_step
