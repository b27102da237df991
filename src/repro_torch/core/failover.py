"""Coordinator failover (paper §3.1 + §6.4) and acceptor state restore.

The counterpart of ``repro.core.failover``.  When the
hardware coordinator fails, a software coordinator takes over by the safe
procedure: it claims a strictly higher round (rounds are partitioned by
coordinator id, so two coordinators never share one), runs batched Phase 1
over the uncertainty window around its estimate of the watermark, and
re-proposes every value it finds voted.  ``restore_acceptor`` rebuilds an
acceptor that crashed with state loss from the snapshot watermark and the
live suffix of the learner ring before it rejoins the quorum.

The batches go through the dataplane's staged ``prepare``/``vote``: the
Phase-1 scan runs the plain engine on any device, and the re-proposals'
Phase-2 vote runs the acceptor array's vote kernel on the card when the
dataplane uses kernels.  On a multi-group dataplane every batch is built on
the device of the group's slab (``group_view(gid).device``, its shard's on
a sharded one), and every register row is reached through ``_rows(gid)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import I32, MSG_NOP, MSG_P1A, MSG_P1B, MSG_P2A, NO_ROUND, MsgBatch


def allocate_round(epoch: int, coordinator_id: int, n_coordinators: int = 16) -> int:
    """Globally unique, monotonically increasing round for a coordinator:
    rounds = coordinator_id (mod n_coordinators)."""
    return epoch * n_coordinators + coordinator_id


@dataclasses.dataclass
class TakeoverResult:
    crnd: int
    next_inst: int
    reproposed: list[tuple[int, bytes]]  # (inst, value) re-proposed values
    scanned: int


def takeover(
    hw,  # HardwareDataplane
    *,
    coordinator_id: int,
    epoch: int,
    est_next_inst: int,
    window: int,
    quorum: int,
) -> TakeoverResult:
    """Run the safe takeover procedure against the acceptors.

    Scans ``[max(0, est_next_inst - window), est_next_inst + window)`` with
    batched Phase 1, collects promises, and re-proposes discovered values
    with the new round.  Returns the state the new coordinator starts from.
    """
    crnd = allocate_round(epoch, coordinator_id)
    lo = max(0, est_next_inst - window)
    hi = est_next_inst + window
    b = hw.cfg.batch
    vwords = hw.cfg.value_words
    dev = hw.device

    def batch(msgtype: np.ndarray, insts, rnd: np.ndarray, value: np.ndarray) -> MsgBatch:
        return MsgBatch(
            msgtype=torch.from_numpy(msgtype.astype(np.int32)).to(dev),
            inst=torch.from_numpy(insts).to(dev),
            rnd=torch.from_numpy(rnd.astype(np.int32)).to(dev),
            vrnd=torch.full((b,), NO_ROUND, dtype=I32, device=dev),
            swid=torch.full((b,), coordinator_id, dtype=I32, device=dev),
            value=torch.from_numpy(value).to(dev),
        )

    reproposed: list[tuple[int, bytes]] = []
    highest_voted = -1
    scanned = 0
    for base in range(lo, hi, b):
        insts = np.arange(base, base + b, dtype=np.int32)
        # the last batch may overhang the window: out-of-window positions are
        # inert (NOP at NO_ROUND), so they neither promise nor vote
        in_win = insts < hi
        scanned += int(in_win.sum())
        rnd = np.where(in_win, crnd, NO_ROUND)
        p1a = batch(
            np.where(in_win, MSG_P1A, MSG_NOP), insts, rnd, np.zeros((b, vwords), np.int32)
        )
        got = np.zeros((b,), np.int32)
        best_vrnd = np.full((b,), NO_ROUND, np.int32)
        best_val = np.zeros((b, vwords), np.int32)
        for v in hw.prepare(p1a):
            if v is None:
                continue
            is_p1b = v.msgtype.cpu().numpy() == MSG_P1B
            host_vr = v.vrnd.cpu().numpy()
            got += is_p1b.astype(np.int32)
            better = is_p1b & (host_vr > best_vrnd)
            best_vrnd = np.where(better, host_vr, best_vrnd)
            best_val = np.where(better[:, None], v.value.cpu().numpy(), best_val)
        voted = (got >= quorum) & (best_vrnd != NO_ROUND) & in_win
        if voted.any():
            # re-propose discovered values at the new round (value-choice
            # rule); in-window NOP slots at crnd vote like P2As (the designed
            # catch-up), out-of-window slots stay at NO_ROUND
            hw.vote(batch(np.where(voted, MSG_P2A, MSG_NOP), insts, rnd, best_val))
            for i in np.nonzero(voted)[0]:
                reproposed.append((int(insts[i]), best_val[i].tobytes()))
                highest_voted = max(highest_voted, int(insts[i]))

    next_inst = max(est_next_inst, highest_voted + 1)
    return TakeoverResult(crnd=crnd, next_inst=next_inst, reproposed=reproposed, scanned=scanned)


def takeover_group(
    mg,  # MultiGroupDataplane
    gid: int,
    *,
    coordinator_id: int,
    epoch: int,
    est_next_inst: int,
    window: int,
    quorum: int,
) -> TakeoverResult:
    """``takeover`` scoped to one group of a multi-group dataplane through
    its view (``mg.group_view(gid)``): the scan, the re-proposals and the
    catch-up touch only that group's rows; every other group's registers,
    watermark and round are left as they are."""
    return takeover(
        mg.group_view(gid),
        coordinator_id=coordinator_id,
        epoch=epoch,
        est_next_inst=est_next_inst,
        window=window,
        quorum=quorum,
    )


def rebuild_acceptor_rows(
    ld: np.ndarray,
    li: np.ndarray,
    lv: np.ndarray,
    crnd: int,
    lo: int,
    hi: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reconstruct one acceptor's ``(rnd, vrnd, value)`` register rows from
    the learner ring's decided live suffix: every decided instance in
    ``[lo, hi)`` is adopted as a vote at the current round (decided values
    are frozen by quorum, so re-voting them is safe); every other slot is
    reborn fresh."""
    n = ld.shape[0]
    adopt_rnd = max(int(crnd), 0)
    rnd = np.zeros((n,), np.int32)
    vrnd = np.full((n,), NO_ROUND, np.int32)
    val = np.zeros((n, lv.shape[1]), np.int32)
    slots = np.nonzero((ld != 0) & (li >= lo) & (li < hi))[0]
    rnd[slots] = adopt_rnd
    vrnd[slots] = adopt_rnd
    val[slots] = lv[slots]
    return rnd, vrnd, val


def restore_acceptor(hw, aid: int, *, gid: int | None = None, watermark: int = 0) -> int:
    """Rebuild a wiped acceptor from the snapshot watermark and the live ring
    suffix ``[watermark, next_inst)`` of the learner ring, write its rows in
    place and rejoin it to the quorum.  ``gid`` names the group on a
    multi-group dataplane (``hw`` is then a ``MultiGroupDataplane``).
    Returns the number of adopted (decided) instances."""
    if gid is None:
        stack, lstate = hw.stack, hw.lstate
        crnd, hi = int(hw.cstate.crnd), int(hw._next_inst_host)
    else:  # the group's rows of the slabs, as views on its shard's device
        stack, lstate = hw._rows(gid)
        crnd, hi = int(hw.crnd_host[gid]), int(hw.next_inst_host[gid])
    learner, acceptors = vars(lstate).values(), vars(stack).values()
    ld, li, lv = (x.cpu().numpy() for x in learner)
    rnd, vrnd, val = rebuild_acceptor_rows(ld, li, lv, crnd, watermark, hi)
    for dst, src in zip(acceptors, (rnd, vrnd, val), strict=True):
        dst[aid].copy_(torch.from_numpy(src))
    if gid is None:
        hw.revive_acceptor(aid)
    else:
        hw.revive_acceptor(gid, aid)
    return int((vrnd != NO_ROUND).sum())
