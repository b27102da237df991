"""The fabric: the acceptor-sharded consensus and the training commit on
``torch.distributed``, and the groups-sharded multi-group round.

The counterpart of ``repro.core.fabric``, in two halves.

**Acceptor-sharded consensus** (``consensus_round``,
``make_fabric_consensus``), the paper's claim in the reference's words:
consensus runs on the interconnect.  One rank is one acceptor on an axis of
a ``DeviceMesh``, and a round is one collective program that every rank
runs:

  1. all-gather the proposals over the axis (proposers -> coordinator);
  2. sequence them on every rank, identically (K3 on the card);
  3. this rank's acceptor votes on its own register file (K7 on the card);
  4. sum the live agree bits over the axis (acceptors -> learners);
  5. every rank learns the same ``decided``, ``inst`` and ``value``.

The reference's round calls its jnp ``batched`` sequencer and vote, and
reaches no Pallas kernel; the port runs K3 and K7 in their place, with
their plain versions on the CPU.  The reference runs the round under
``shard_map``; here it runs under ``local_map`` on each rank's local
tensors, its collectives on the axis's process group: NCCL between cards,
gloo between CPU processes or between processes that share one card.  As
in the reference, ``alive`` gates only an acceptor's count: a dead
acceptor's registers take the vote too.
``quorum_commit_digest`` decides a training step by digest agreement over
an axis, as the reference's does; no training path calls it, as none of the
reference's does.

**Groups-sharded round** (``make_sharded_multigroup_round``, the
full-width dispatch, and ``make_packed_sharded_round``, the packed cohort
dispatch).  The reference runs its shard body under ``shard_map``; nothing
crosses the mesh axis during a round, because groups share no state, and
every per-group scalar is host-authoritative and enters the dispatch
replicated.  So here a dispatch is one controller's loop over the shards of
a ``launch.mesh.GroupMesh``, in shard order, each shard's body on its own
``(Gl, ...)`` slab on that shard's device, with no collective and no copy
between devices.  Each device gets one upload, in one copy: the control
tables, replicated to every device, and its shards' rows of the burst.
Every shard's body is launched before any is read back, so several cards
work at once; each device's outputs are then joined on it and read back in
one copy, and gathered on the host in shard order.  Logical shards of one
device thus cost one upload and one read-back a dispatch, as one slab
would.

With ``use_kernels`` a full-width shard body is K1's shard slice
(``kernels.ops.shard_slab_round``) and a packed one K6
(``kernels.ops.packed_shard_round``), on the card, with their plain versions
on the CPU; without, the plain engine.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import ops as kops
from . import batched
from .types import MSG_P2B, AcceptorState, CoordinatorState

INT32_MAX = 2**31 - 1


def _axis_dim(mesh, axis: str) -> int:
    """The index of ``axis`` among a ``DeviceMesh``'s dims."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} axis: {names}")
    return names.index(axis)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, in the axis's order, concatenated
    along dim 0: the reference's ``all_gather(tiled=True)``."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def consensus_round(
    astate: AcceptorState,
    cstate: CoordinatorState,
    values: torch.Tensor,  # int32[b_local, V]  this rank's proposals
    active: torch.Tensor,  # bool[b_local]
    alive: torch.Tensor,  # bool[]  this rank's acceptor is alive
    *,
    axis: str,
    quorum: int,
    mesh,
) -> tuple[AcceptorState, CoordinatorState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One round of the acceptor-sharded consensus on this rank's local
    tensors, as the reference's runs inside ``shard_map``: ``astate`` is
    this rank's register file ``(N,)``, ``(N,)``, ``(N, V)``, updated in
    place by the vote of acceptor ``mesh.get_local_rank(axis)``; ``cstate``
    is replicated.

    Returns ``(astate, cstate', decided[B], inst[B], value[B, V])`` with
    ``B = b_local * n_acc``, the same on every rank.  A round must address
    distinct ring slots, so ``B > N`` raises ``ValueError`` on every route
    (the reference's scatter would race in silence)."""
    group = mesh.get_group(axis)
    b = values.shape[0] * mesh.size(_axis_dim(mesh, axis))
    if b > astate.n_instances:
        raise ValueError(
            f"a round of {b} proposals over a ring of {astate.n_instances} instances: "
            "its slots would not be distinct (B must not exceed N)"
        )
    all_values = _gather(values, group)  # [B, V]
    all_active = _gather(active, group)  # [B]
    cstate, p2a = kops.coordinator_sequence(cstate, all_values, all_active)
    astate, votes = kops.acceptor_phase2(astate, p2a, mesh.get_local_rank(axis))
    # a dead acceptor still votes into its registers (the reference's order);
    # only its agree bit is left out of the count
    count = ((votes.msgtype == MSG_P2B) & alive).to(torch.int32)
    dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
    return astate, cstate, count >= quorum, p2a.inst, p2a.value


def make_fabric_consensus(
    mesh,
    *,
    axis: str = "data",
    quorum: int | None = None,
    n_instances: int = 4096,
    value_words: int = 16,
) -> tuple[Callable[[], tuple[AcceptorState, CoordinatorState]], Callable[..., Any]]:
    """The acceptor-sharded consensus over ``mesh[axis]`` of a
    ``DeviceMesh``: ``(init_fn, step_fn)``, the reference's contract.

      * ``init_fn()`` -> ``(astate, cstate)``: ``AcceptorState`` DTensors
        of global shape ``(n_acc, N)``, ``(n_acc, N)``, ``(n_acc, N, V)``,
        ``Shard(0)`` on ``axis`` and replicated on every other mesh dim
        (``vrnd`` at ``NO_ROUND``), and a replicated ``CoordinatorState``;
      * ``step_fn(astate, cstate, values[B, V], active[B], alive[n_acc])``
        -> ``(astate', cstate', decided[B], inst[B], value[B, V])``, the
        proposals and ``alive`` sharded on ``axis``, the last three
        replicated.

    The registers must be the DTensors that ``init_fn`` (or an earlier
    ``step_fn``) gave, and a plain tensor among them raises ``TypeError``:
    a round votes into their local shards in place, and the registers it
    returns share that storage.  So, unlike the reference's, whose ``jit``
    donates nothing, the state from before a round does not survive it.
    Any other plain tensor given to ``step_fn`` is taken as the global
    tensor, the same on every rank, and cut to this rank's share.  The
    quorum defaults
    to ``n_acc // 2 + 1``.  The mesh's device decides the route: on
    ``cuda`` the round runs K3 and K7, on ``cpu`` their plain versions."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dim = _axis_dim(mesh, axis)
    n_acc = mesh.size(dim)
    q = quorum if quorum is not None else n_acc // 2 + 1
    dev = torch.device(mesh.device_type)
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    shard = tuple(Shard(0) if i == dim else Replicate() for i in range(mesh.ndim))

    def placed(x, placements):
        return DTensor.from_local(x, mesh, placements, run_check=False)

    def init_fn() -> tuple[AcceptorState, CoordinatorState]:
        local = AcceptorState.init(n_instances, value_words, dev, n_acceptors=1)
        coord = CoordinatorState.init(device=dev)
        return (
            AcceptorState(*(placed(x, shard) for x in vars(local).values())),
            CoordinatorState(*(placed(x, rep) for x in vars(coord).values())),
        )

    def local_round(rnd, vrnd, value, next_inst, crnd, values, active, alive):
        # strip the per-acceptor dim: views, so the vote lands in the shard
        a = AcceptorState(rnd[0], vrnd[0], value[0])
        c = CoordinatorState(next_inst, crnd)
        _, c, decided, inst, val = consensus_round(
            a, c, values, active, alive[0], axis=axis, quorum=q, mesh=mesh
        )
        return rnd, vrnd, value, c.next_inst, c.crnd, decided, inst, val

    round_fn = local_map(
        local_round,
        out_placements=(shard,) * 3 + (rep,) * 5,
        in_placements=(shard,) * 3 + (rep,) * 2 + (shard,) * 3,
        redistribute_inputs=True,
        device_mesh=mesh,
    )

    def step_fn(astate, cstate, values, active, alive):
        if not all(isinstance(x, DTensor) for x in vars(astate).values()):
            raise TypeError("the registers must be init_fn's DTensors, updated in place")
        if values.shape[0] % n_acc:
            raise ValueError(f"{values.shape[0]} proposals do not split over {n_acc} acceptors")
        args = [
            x if isinstance(x, DTensor) else placed(torch.as_tensor(x, device=dev), rep)
            for x in (*vars(astate).values(), *vars(cstate).values(), values, active, alive)
        ]
        rnd, vrnd, value, next_inst, crnd, decided, inst, val = round_fn(*args)
        return (
            AcceptorState(rnd, vrnd, value),
            CoordinatorState(next_inst, crnd),
            decided,
            inst,
            val,
        )

    return init_fn, step_fn


def quorum_commit_digest(
    digest: torch.Tensor,  # int32[] or int32[k]  this rank's digest
    healthy: torch.Tensor,  # bool[]  this rank voted in time
    *,
    axis: str,
    quorum: int,
    mesh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decide a training step's commit by digest agreement over
    ``mesh[axis]``, on this rank's local tensors: the step commits iff at
    least ``quorum`` healthy ranks hold the same digest, so a straggling or
    dead rank (``healthy`` false) cannot block it.  Returns ``(commit
    bool[], win int32[])``, the same on every rank; ``win`` is the largest
    number of healthy ranks that agree on one digest."""
    group = mesh.get_group(axis)
    all_d = _gather(digest.reshape(1, -1), group)  # [G, k]
    all_h = _gather(healthy.reshape(1), group)  # [G]
    eq = (all_d[:, None, :] == all_d[None, :, :]).all(-1) & all_h[None, :] & all_h[:, None]
    win = eq.sum(1, dtype=torch.int32).max()
    return win >= quorum, win


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


def _slabs(stacks, lstates, n_sh: int) -> list[tuple[AcceptorState, batched.LearnerState]]:
    """Every shard's ``(stack, lstate)`` slab, each ``(Gl, ...)`` on its
    shard's device, in shard order."""
    slabs = list(zip(stacks, lstates, strict=True))
    if len(slabs) != n_sh or len({st.rnd.shape[0] for st, _ in slabs}) != 1:
        raise ValueError(
            f"{len(slabs)} slabs of {[st.rnd.shape[0] for st, _ in slabs]} groups "
            f"for a {n_sh}-shard mesh"
        )
    return slabs


def _by_device(slabs) -> dict[torch.device, list[int]]:
    """The shards of each device, in shard order; devices in the order of
    their first shard."""
    out: dict[torch.device, list[int]] = {}
    for s, (st, _ls) in enumerate(slabs):
        out.setdefault(st.rnd.device, []).append(s)
    return out


def _read_back(outs: list[list[torch.Tensor]], by_dev: dict) -> list[np.ndarray]:
    """Each output of every shard on the host, concatenated in shard order.
    A device's outputs are joined on it into one int32 buffer (``fresh`` is
    bool, read back as such) and come back in one copy, which waits only for
    that device."""
    host: list[list] = [[None] * len(outs) for _ in outs[0]]
    for ss in by_dev.values():
        parts = [outs[s][j] for j in range(len(host)) for s in ss]
        flat = torch.cat([x.reshape(-1) for x in parts]).cpu().numpy()
        at = 0
        for j, col in enumerate(host):
            for s in ss:
                x = outs[s][j]
                piece = flat[at : at + x.numel()].reshape(tuple(x.shape))
                col[s] = piece != 0 if x.dtype == torch.bool else piece
                at += x.numel()
    return [np.concatenate(col) for col in host]


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

    Returns ``step(next_inst[G], crnd[G], enabled[G], alive[G, A], stacks,
    lstates, values[G, B, V], active[G, B], reclaim_limit=None) -> (stacks,
    lstates, fresh[G, B], inst[G, B], win[G, B], value[G, B, V])``:
    ``stacks`` and ``lstates`` are the S per-shard ``(Gl, ...)`` states in
    shard order, each on its shard's device, and come back as given,
    updated in place; the four outputs are host int32 (``fresh`` bool) in
    slot order.  ``reclaim_limit=None`` is int32 max for every group."""
    n_sh = _check_axis(mesh, axis)
    if n_groups % n_sh:
        raise ValueError(
            f"n_groups={n_groups} must be divisible by the {axis!r} mesh axis size {n_sh}"
        )
    gl = n_groups // n_sh
    if group_block > 1 and gl % group_block:
        raise ValueError(f"group_block={group_block} must divide the per-shard slab {gl}")
    q = quorum

    def step(next_inst, crnd, enabled, alive, stacks, lstates, values, active, reclaim_limit=None):
        del active  # sequenced fillers vote like P2As
        g = n_groups
        slabs = _slabs(stacks, lstates, n_sh)
        have = n_sh * slabs[0][0].rnd.shape[0]
        if have != g:
            raise ValueError(f"slabs of {have} groups for a {g}-group dispatch")
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
        al = np.asarray(alive, np.int32)
        by_dev = _by_device(slabs)
        outs: list = [None] * n_sh
        for dev, ss in by_dev.items():
            # one upload a device: the tables replicated, its shards' burst rows
            rows = vals.reshape((n_sh, gl, *vals.shape[1:]))[ss]
            ctl_d, al_d, vals_d = _upload(dev, ctl, al, rows)
            al_d = al_d != 0
            for k, s in enumerate(ss):
                st, ls = slabs[s]
                args = (s * gl, ctl_d[0], ctl_d[1], al_d, q, st, ls, vals_d[k], ctl_d[2], ctl_d[3])
                if use_kernels:
                    _st, _ls, *outs[s] = kops.shard_slab_round(*args, group_block=group_block)
                else:
                    _st, _ls, *outs[s] = batched.shard_slab_round(*args)
        fresh, win, value = _read_back(outs, by_dev)
        return stacks, lstates, fresh, _windows(ni, vals.shape[1]), win, value

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
             alive[S, C, A], stacks, lstates, values[S, C, B, V],
             reclaim_limit[S, C] | None)
          -> (stacks, lstates, fresh[S*C, B], inst[S*C, B], win[S*C, B],
              value[S*C, B, V])

    with shard ``s``'s lane ``j`` at packed row ``s*C + j``, ``stacks`` and
    ``lstates`` as the full-width dispatch takes them, updated in place as
    it would update them (pads and absent rows untouched), and the outputs
    on the host.  ``block_b`` is the reference kernel's batch block,
    checked on the kernel path only (None: 128); it changes no result."""
    n_sh = _check_axis(mesh, axis)
    q = quorum

    def packed_step(
        segids, next_inst, crnd, enabled, alive, stacks, lstates, values, reclaim_limit=None
    ):
        vals = np.asarray(values, np.int32)
        s_, c, b = vals.shape[:3]
        if s_ != n_sh:
            raise ValueError(f"a packed table of {s_} shards for a {n_sh}-shard mesh")
        slabs = _slabs(stacks, lstates, n_sh)
        seg = np.asarray(segids, np.int32).reshape((n_sh, c))
        ni = np.asarray(next_inst, np.int32).reshape((n_sh, c))
        en = np.asarray(enabled, np.int32).reshape((n_sh, c))
        if reclaim_limit is None:
            lim = np.full((n_sh, c), INT32_MAX, np.int32)
        else:
            lim = np.asarray(reclaim_limit, np.int32).reshape((n_sh, c))
        ctl = np.stack([seg, ni, np.asarray(crnd, np.int32).reshape((n_sh, c)), en, lim], axis=1)
        al = np.asarray(alive, np.int32).reshape((n_sh, c, -1))
        by_dev = _by_device(slabs)
        outs: list = [None] * n_sh
        for dev, ss in by_dev.items():
            # one upload a device, of its shards' lane tables
            ctl_d, al_d, vals_d = _upload(dev, ctl[ss], al[ss], vals[ss])
            for k, s in enumerate(ss):
                st, ls = slabs[s]
                t = ctl_d[k]  # (5, C): segids, next_inst, crnd, enabled, limit
                if use_kernels:
                    _st, _ls, *outs[s] = kops.packed_shard_round(
                        st, ls, t[0], t[1], t[2], al_d[k], q, vals_d[k], t[3], t[4],
                        block_b=block_b, lanes_host=(seg[s], en[s]),
                    )  # fmt: skip
                else:
                    _st, _ls, *outs[s] = batched.packed_multigroup_round(
                        st, ls, t[0], t[1], t[2], al_d[k], q, vals_d[k], t[3], t[4]
                    )
        fresh, win, value = _read_back(outs, by_dev)
        return stacks, lstates, fresh, _windows(ni.reshape(-1), b), win, value

    return packed_step
