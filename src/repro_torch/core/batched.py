"""Batched multi-instance Paxos dataplane in plain PyTorch: the plain engine.

The counterpart of ``repro.core.batched``.  Every function processes a
batch of Paxos headers (``MsgBatch``) in one shot, with the reference's
``vmap`` over acceptors (and over groups) written out as a leading axis.
``fused_round`` is the plain version of the fused round kernel at one group,
``multigroup_fused_round``, ``cohort_fused_round`` and ``shard_slab_round``
at G groups, in cohort form and on one shard's slab,
``persistent_cohort_rounds`` of its K-round persistent form and
``packed_multigroup_round`` of the packed shard round kernel
(``kernels/wirepath.py``): each agrees with its kernel bit for bit.
``persistent_multigroup_rounds`` is the full-width K-round program the
dataplane's plain engine runs for a wave.

Unlike the reference, which returns new immutable arrays, the register
files (``AcceptorState``, ``LearnerState``) are updated in place, as the
kernel updates them; the functions still return them, so callers read like
the reference.  A batch must address distinct ring slots (``inst % N``
pairwise distinct), which the sequencer guarantees for ``B <= N``; only
``acceptor_sequential``, one message at a time, takes any batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import (
    I32,
    MSG_NOP,
    MSG_P1A,
    MSG_P1B,
    MSG_P2A,
    MSG_P2B,
    MSG_REJECT,
    NO_ROUND,
    AcceptorState,
    CoordinatorState,
    MsgBatch,
)


def _slots(inst: torch.Tensor, n: int) -> torch.Tensor:
    # torch's ``%`` is the floored (non-negative) modulo, as jnp's is
    return (inst % n).long()


def coordinator_sequence(
    cstate: CoordinatorState, values: torch.Tensor, active: torch.Tensor
) -> tuple[CoordinatorState, MsgBatch]:
    """Bind a batch of proposals to the contiguous instance window at the
    watermark.  Inactive slots still consume an instance and carry a NOP
    marker (the paper's no-op values)."""
    b = values.shape[0]
    dev = values.device
    inst = cstate.next_inst + torch.arange(b, dtype=I32, device=dev)
    out = MsgBatch(
        msgtype=torch.where(active, MSG_P2A, MSG_NOP).to(I32),
        inst=inst,
        rnd=cstate.crnd.expand(b).clone(),
        vrnd=torch.full((b,), NO_ROUND, dtype=I32, device=dev),
        swid=torch.zeros((b,), dtype=I32, device=dev),
        value=values,
    )
    return CoordinatorState(next_inst=cstate.next_inst + b, crnd=cstate.crnd), out


def _phase2(
    stack: AcceptorState, msgs: MsgBatch, alive: torch.Tensor, aids: torch.Tensor
) -> MsgBatch:
    """Phase-2 vote of the stacked acceptors ``(A, N)`` on one batch, in
    place.  A live acceptor accepts a P2A (or a sequenced NOP filler, which
    votes like one) at a round no lower than its promise; a dead acceptor's
    registers stay frozen and its row is exactly a rejecter's."""
    slots = _slots(msgs.inst, stack.n_instances)
    cur_rnd = stack.rnd[:, slots]  # (A, B)
    cur_vrnd = stack.vrnd[:, slots]
    cur_val = stack.value[:, slots]  # (A, B, V)
    is_p2 = (msgs.msgtype == MSG_P2A) | (msgs.msgtype == MSG_NOP)
    accept = alive[:, None] & is_p2[None, :] & (msgs.rnd[None, :] >= cur_rnd)
    new_rnd = torch.where(accept, msgs.rnd[None, :], cur_rnd)
    new_vrnd = torch.where(accept, msgs.rnd[None, :], cur_vrnd)
    stack.rnd[:, slots] = new_rnd
    stack.vrnd[:, slots] = new_vrnd
    stack.value[:, slots] = torch.where(accept[..., None], msgs.value[None], cur_val)
    a, b = accept.shape
    return MsgBatch(
        msgtype=torch.where(accept, MSG_P2B, MSG_REJECT).to(I32),
        inst=msgs.inst.expand(a, b).clone(),
        rnd=new_rnd,
        vrnd=new_vrnd,
        swid=aids[:, None].expand(a, b).clone(),
        value=torch.where(accept[..., None], msgs.value[None], 0).to(I32),
    )


def _phase1(
    stack: AcceptorState, msgs: MsgBatch, alive: torch.Tensor, aids: torch.Tensor
) -> MsgBatch:
    """Phase-1 promise of the stacked acceptors on one batch, in place."""
    slots = _slots(msgs.inst, stack.n_instances)
    cur_rnd = stack.rnd[:, slots]
    cur_vrnd = stack.vrnd[:, slots]
    cur_val = stack.value[:, slots]
    promise = alive[:, None] & (msgs.msgtype == MSG_P1A)[None, :] & (msgs.rnd[None, :] > cur_rnd)
    new_rnd = torch.where(promise, msgs.rnd[None, :], cur_rnd)
    stack.rnd[:, slots] = new_rnd
    a, b = promise.shape
    return MsgBatch(
        msgtype=torch.where(promise, MSG_P1B, MSG_REJECT).to(I32),
        inst=msgs.inst.expand(a, b).clone(),
        rnd=new_rnd,
        vrnd=cur_vrnd,
        swid=aids[:, None].expand(a, b).clone(),
        value=cur_val,
    )


def _single(fn, astate: AcceptorState, msgs: MsgBatch, aid: int) -> MsgBatch:
    # one register file as a one-row stack: views, so the update lands in place
    stack = AcceptorState(astate.rnd[None], astate.vrnd[None], astate.value[None])
    dev = astate.rnd.device
    out = fn(
        stack,
        msgs,
        torch.ones((1,), dtype=torch.bool, device=dev),
        torch.full((1,), aid, dtype=I32, device=dev),  # no host copy: capturable
    )
    return MsgBatch(*(x[0] for x in out.tensors()))


def acceptor_phase2(
    astate: AcceptorState, msgs: MsgBatch, aid: int = 0
) -> tuple[AcceptorState, MsgBatch]:
    """One acceptor's Phase-2 vote on a batch of P2A requests."""
    return astate, _single(_phase2, astate, msgs, aid)


def acceptor_phase1(
    astate: AcceptorState, msgs: MsgBatch, aid: int = 0
) -> tuple[AcceptorState, MsgBatch]:
    """One acceptor's Phase-1 promise on a batch of P1A prepares."""
    return astate, _single(_phase1, astate, msgs, aid)


def acceptor_phase2_all(
    stack: AcceptorState, msgs: MsgBatch, alive: torch.Tensor
) -> tuple[AcceptorState, MsgBatch]:
    """Phase-2 vote of the whole acceptor array; votes are ``[A, ...]``."""
    aids = torch.arange(stack.rnd.shape[0], dtype=I32, device=stack.rnd.device)
    return stack, _phase2(stack, msgs, alive, aids)


def acceptor_phase1_all(
    stack: AcceptorState, msgs: MsgBatch, alive: torch.Tensor
) -> tuple[AcceptorState, MsgBatch]:
    """Phase-1 promise of the whole acceptor array (recovery / takeover)."""
    aids = torch.arange(stack.rnd.shape[0], dtype=I32, device=stack.rnd.device)
    return stack, _phase1(stack, msgs, alive, aids)


def acceptor_sequential(
    astate: AcceptorState, msgs: MsgBatch, aid: int = 0
) -> tuple[AcceptorState, MsgBatch]:
    """One acceptor, one message at a time in batch order (recovery,
    adversarial batches): any batch, duplicate slots included, where the
    batched functions need distinct slots.  A plain loop over the batch,
    with no kernel; the registers are updated in place."""
    n = astate.n_instances
    msgtype, inst, rnd = (x.tolist() for x in (msgs.msgtype, msgs.inst, msgs.rnd))
    out_type, out_rnd, out_vrnd = [], [], []
    out_value = torch.zeros_like(msgs.value)
    for j, (t, i, r) in enumerate(zip(msgtype, inst, rnd, strict=True)):
        slot = i % n
        cur_rnd, cur_vrnd = int(astate.rnd[slot]), int(astate.vrnd[slot])
        accept = t in (MSG_P2A, MSG_NOP) and r >= cur_rnd
        promise = t == MSG_P1A and r > cur_rnd
        if t == MSG_P1A:
            out_value[j] = astate.value[slot]
        if accept:
            astate.vrnd[slot] = r
            astate.value[slot] = msgs.value[j]
            out_value[j] = msgs.value[j]
        if accept or promise:
            astate.rnd[slot] = r
        out_type.append(MSG_P2B if accept else MSG_P1B if promise else MSG_REJECT)
        out_rnd.append(r if accept or promise else cur_rnd)
        out_vrnd.append(r if accept else cur_vrnd)
    dev = msgs.msgtype.device
    return astate, MsgBatch(
        msgtype=torch.tensor(out_type, dtype=I32, device=dev),
        inst=msgs.inst.clone(),
        rnd=torch.tensor(out_rnd, dtype=I32, device=dev),
        vrnd=torch.tensor(out_vrnd, dtype=I32, device=dev),
        swid=torch.full_like(msgs.swid, aid),
        value=out_value,
    )


def learner_quorum(
    vote_msgtype: torch.Tensor,  # int32[A, B]
    vote_inst: torch.Tensor,  # int32[A, B]
    vote_vrnd: torch.Tensor,  # int32[A, B]
    vote_value: torch.Tensor,  # int32[A, B, V]
    quorum: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Position-aligned quorum over the acceptor axis: ``deliver[b]`` iff at
    least ``quorum`` acceptors voted (P2B) the winning (highest) vrnd; the
    value and instance come from the first acceptor that voted it."""
    is_vote = vote_msgtype == MSG_P2B
    win = torch.where(is_vote, vote_vrnd, NO_ROUND).amax(dim=0)
    agree = is_vote & (vote_vrnd == win[None, :])
    count = agree.to(I32).sum(dim=0)
    deliver = count >= quorum
    first = agree.to(I32).argmax(dim=0)  # first maximal index, as jnp.argmax
    cols = torch.arange(vote_inst.shape[1], device=vote_inst.device)
    return deliver, vote_inst[first, cols], win, vote_value[first, cols]


@dataclasses.dataclass
class LearnerState:
    """Dedup memory over the instance ring: delivered mask (0/1 int32), the
    absolute instance last decided into each slot, and its value.  Keeping
    the absolute instance makes the dedup ring-correct: a later instance
    reusing a slot after wraparound is fresh again."""

    delivered: torch.Tensor  # int32[N]
    inst: torch.Tensor  # int32[N]
    value: torch.Tensor  # int32[N, V]

    @classmethod
    def init(
        cls, n_instances: int, value_words: int, device: torch.device | str = "cpu"
    ) -> LearnerState:
        return cls(
            delivered=torch.zeros((n_instances,), dtype=I32, device=device),
            inst=torch.full((n_instances,), -1, dtype=I32, device=device),
            value=torch.zeros((n_instances, value_words), dtype=I32, device=device),
        )


def learner_update(
    lstate: LearnerState, deliver: torch.Tensor, inst: torch.Tensor, value: torch.Tensor
) -> tuple[LearnerState, torch.Tensor]:
    """Record deliveries in place; returns the mask of fresh (not duplicate)
    deliveries."""
    slots = _slots(inst, lstate.delivered.shape[0])
    ld = lstate.delivered[slots]
    li = lstate.inst[slots]
    fresh = deliver & ~((ld != 0) & (li == inst))
    lstate.delivered[slots] = ld | deliver.to(I32)
    lstate.inst[slots] = torch.where(fresh, inst, li)
    lstate.value[slots] = torch.where(fresh[:, None], value, lstate.value[slots])
    return lstate, fresh


def fused_round(
    cstate: CoordinatorState,
    stack: AcceptorState,
    lstate: LearnerState,
    values: torch.Tensor,  # int32[B, V]
    active: torch.Tensor,  # bool[B]
    alive: torch.Tensor,  # bool[A]
    quorum: int,
    reclaim_limit: int | None = None,
) -> tuple[
    CoordinatorState,
    AcceptorState,
    LearnerState,
    torch.Tensor,
    torch.Tensor,
    torch.Tensor,
    torch.Tensor,
]:
    """The CAANS wire path as one plain program: sequencing, the whole
    acceptor array's Phase-2 vote, the learner quorum and the ring-dedup
    update.  ``reclaim_limit`` is the first instance the ring may not
    sequence into (snapshot watermark + N): lanes at or past it are
    presented at NO_ROUND so every acceptor rejects them.  Returns
    ``(cstate', stack, lstate, fresh[B], inst[B], win_vrnd[B], value[B, V])``.
    """
    cstate, p2a = coordinator_sequence(cstate, values, active)
    if reclaim_limit is not None:
        p2a = p2a.replace(rnd=torch.where(p2a.inst < reclaim_limit, p2a.rnd, NO_ROUND))
    stack, votes = acceptor_phase2_all(stack, p2a, alive)
    deliver, inst, win, value = learner_quorum(
        votes.msgtype, votes.inst, votes.vrnd, votes.value, quorum
    )
    lstate, fresh = learner_update(lstate, deliver, inst, value)
    return cstate, stack, lstate, fresh, inst, win, value


# ---------------------------------------------------------------------------
# Multi-group wire path: G independent Paxos groups, one program
# ---------------------------------------------------------------------------
INT32_MAX = 2**31 - 1


def init_multigroup_state(
    n_groups: int,
    n_acceptors: int,
    n_instances: int,
    value_words: int,
    device: torch.device | str = "cpu",
) -> tuple[CoordinatorState, AcceptorState, LearnerState]:
    """Fresh ``(G,)``-stacked coordinator, acceptor and learner state."""
    g, n, v = n_groups, n_instances, value_words
    cstate = CoordinatorState(
        next_inst=torch.zeros((g,), dtype=I32, device=device),
        crnd=torch.zeros((g,), dtype=I32, device=device),
    )
    stack = AcceptorState.init(n, v, device, n_acceptors=n_acceptors)
    stack = AcceptorState(*(x.expand((g,) + x.shape).clone() for x in vars(stack).values()))
    one = LearnerState.init(n, v, device)
    lstate = LearnerState(*(x.expand((g,) + x.shape).clone() for x in vars(one).values()))
    return cstate, stack, lstate


def group_vector(x, g: int, dev: torch.device) -> torch.Tensor:
    """A per-group int32 vector on ``dev`` from a tensor, array or list."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.int32))
    return x.to(dev, I32).reshape((g,))


def _limits(reclaim_limit, g: int, dev: torch.device) -> torch.Tensor:
    """Per-group reclaim limits.  ``None`` is int32 max, as the reference's
    round kernel has it, so the instance 2**31 - 1 alone is refused (the
    reference's jnp oracle applies no gate there: the two differ at that
    one instance, and the port follows the kernel on every engine)."""
    if reclaim_limit is None:
        return torch.full((g,), INT32_MAX, dtype=I32, device=dev)
    return group_vector(reclaim_limit, g, dev)


def _rows_round(
    stack: AcceptorState,  # (G, A, N[, V]), in place
    lstate: LearnerState,  # (G, N[, V]), in place
    rows: torch.Tensor,  # int64[C]  distinct slab rows
    next_inst: torch.Tensor,  # int32[C]  window bases
    crnd: torch.Tensor,  # int32[C]
    enabled: torch.Tensor,  # bool[C]
    alive: torch.Tensor,  # bool[C, A]
    limit: torch.Tensor,  # int32[C]  first refused instance
    values: torch.Tensor,  # int32[C, B, V]
    quorum: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Phase-2 round for C slab rows at once, the arithmetic of the
    round kernel's lane body broadcast over a leading row axis: a lane is
    accepted by acceptor ``a`` iff its row is enabled, ``a`` is alive, the
    round is no lower than the promise and the instance is below the
    reclaim limit.  A disabled row changes no state and gives fresh 0, win
    NO_ROUND and value 0.  Returns ``(fresh[C, B], inst[C, B], win[C, B],
    value[C, B, V])``."""
    c, b, _v = values.shape
    a, n = stack.rnd.shape[1], stack.rnd.shape[2]
    dev = values.device
    inst = next_inst[:, None] + torch.arange(b, dtype=I32, device=dev)[None, :]  # wraps
    slots = _slots(inst, n)  # (C, B)
    gi, ai, si = rows[:, None, None], torch.arange(a, device=dev)[None, :, None], slots[:, None]
    cur_rnd = stack.rnd[gi, ai, si]  # (C, A, B)
    cur_vrnd = stack.vrnd[gi, ai, si]
    cur_val = stack.value[gi, ai, si]  # (C, A, B, V)
    cr = crnd[:, None, None]
    permit = inst < limit[:, None]
    accept = enabled[:, None, None] & alive[:, :, None] & (cr >= cur_rnd) & permit[:, None, :]
    stack.rnd[gi, ai, si] = torch.where(accept, cr, cur_rnd)
    stack.vrnd[gi, ai, si] = torch.where(accept, cr, cur_vrnd)
    stack.value[gi, ai, si] = torch.where(accept[..., None], values[:, None], cur_val)
    # learner quorum down the acceptor axis: every accepting acceptor votes
    # the row's round and the burst value
    vote_vrnd = torch.where(accept, cr, NO_ROUND)
    win = vote_vrnd.amax(dim=1)  # (C, B)
    agree = accept & (vote_vrnd == win[:, None])
    deliver = agree.to(I32).sum(dim=1) >= quorum
    value = torch.where(agree.any(dim=1)[..., None], values, 0)
    # ring dedup, in place
    ri = rows[:, None]
    ld, li = lstate.delivered[ri, slots], lstate.inst[ri, slots]
    fresh = deliver & ~((ld != 0) & (li == inst))
    lstate.delivered[ri, slots] = ld | deliver.to(I32)
    lstate.inst[ri, slots] = torch.where(fresh, inst, li)
    lstate.value[ri, slots] = torch.where(fresh[..., None], value, lstate.value[ri, slots])
    return fresh, inst, win, value


def multigroup_fused_round(
    cstate: CoordinatorState,  # (G,)
    stack: AcceptorState,  # (G, A, N[, V])
    lstate: LearnerState,  # (G, N[, V])
    values: torch.Tensor,  # int32[G, B, V]
    active: torch.Tensor,  # bool[G, B]
    alive: torch.Tensor,  # bool[G, A]
    quorum: int,
    enabled=None,  # 0/1 per group; None = all
    reclaim_limit=None,  # int32[G]; None = no reclamation
) -> tuple[
    CoordinatorState,
    AcceptorState,
    LearnerState,
    torch.Tensor,
    torch.Tensor,
    torch.Tensor,
    torch.Tensor,
]:
    """``fused_round`` over a leading group axis, as one broadcast program:
    G independent groups advance one Phase-2 round.  A disabled group is
    presented at NO_ROUND and decides nothing.  As in the reference, the
    returned watermark advances for EVERY group (callers mixing enabled and
    disabled groups correct it), and the returned round is the presented
    one.  ``active`` is not read: sequenced NOP fillers vote like P2As.
    Returns the ``fused_round`` tuple with a leading ``(G,)`` axis."""
    del active
    g, b = values.shape[:2]
    dev = values.device
    en = (
        torch.ones((g,), dtype=torch.bool, device=dev)
        if enabled is None
        else group_vector(enabled, g, dev) != 0
    )
    crnd = torch.where(en, cstate.crnd, NO_ROUND)
    limit = _limits(reclaim_limit, g, dev)
    rows = torch.arange(g, device=dev)
    fresh, inst, win, value = _rows_round(
        stack, lstate, rows, cstate.next_inst, crnd, en, alive, limit, values, quorum
    )
    new_c = CoordinatorState(next_inst=cstate.next_inst + b, crnd=crnd)
    return new_c, stack, lstate, fresh, inst, win, value


def cohort_rows(gsel, group_block: int, dev: torch.device) -> torch.Tensor:
    """Slab rows of a cohort dispatch in compact order: row ``j*GB + k`` is
    group ``gsel[j]*GB + k``."""
    if not isinstance(gsel, torch.Tensor):
        gsel = torch.from_numpy(np.asarray(gsel, np.int64))
    ks = torch.arange(group_block, device=dev)
    return (gsel.to(dev, torch.int64)[:, None] * group_block + ks[None, :]).reshape(-1)


def cohort_fused_round(
    stack: AcceptorState,  # (G, A, N[, V])
    lstate: LearnerState,  # (G, N[, V])
    gsel,  # int[NB]  selected group blocks
    next_inst: torch.Tensor,  # int32[G]
    crnd: torch.Tensor,  # int32[G]
    alive: torch.Tensor,  # bool[G, A]
    quorum: int,
    values: torch.Tensor,  # int32[NB*GB, B, V]  compact cohort burst
    enabled,  # 0/1 per group: the cohort's members
    reclaim_limit=None,  # int32[G]; None = no reclamation
    *,
    group_block: int = 1,
) -> tuple[AcceptorState, LearnerState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the cohort round kernel, with its compact-row
    contract: gather the rows of the group blocks ``gsel`` names, run one
    round on them at each group's own window base, write the rows back.
    Members of a selected block that are not enabled ride inert.  Returns
    ``(stack, lstate, fresh[C, B], win[C, B], value[C, B, V])`` with
    ``C = NB * group_block`` rows in compact order."""
    g = stack.rnd.shape[0]
    dev = values.device
    rows = cohort_rows(gsel, group_block, dev)
    en = group_vector(enabled, g, dev) != 0
    limit = _limits(reclaim_limit, g, dev)
    fresh, _inst, win, value = _rows_round(
        stack,
        lstate,
        rows,
        next_inst[rows],
        torch.where(en, crnd, NO_ROUND)[rows],
        en[rows],
        alive[rows],
        limit[rows],
        values,
        quorum,
    )
    return stack, lstate, fresh, win, value


def shard_slab_round(
    group_offset: int,  # first global group id of this slab
    next_inst: torch.Tensor,  # int32[G_global]  replicated watermarks
    crnd: torch.Tensor,  # int32[G_global]
    alive: torch.Tensor,  # bool[G_global, A]
    quorum: int,
    stack: AcceptorState,  # (Gl, A, N[, V])  this shard's slab, in place
    lstate: LearnerState,  # (Gl, N[, V])
    values: torch.Tensor,  # int32[Gl, B, V]
    enabled=None,  # int32[G_global] 0/1; None = all
    reclaim_limit=None,  # int32[G_global]; None = no reclamation
) -> tuple[AcceptorState, LearnerState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the round kernel's shard slice: one round over
    one shard's ``(Gl, ...)`` slab, the replicated per-group vectors sliced
    at ``group_offset``.  A group that is not enabled rides inert.  Returns
    ``(stack, lstate, fresh[Gl, B], win[Gl, B], value[Gl, B, V])``."""
    gl = stack.rnd.shape[0]
    dev = values.device
    g = next_inst.shape[0]
    sl = slice(group_offset, group_offset + gl)
    en = (
        torch.ones((g,), dtype=torch.bool, device=dev)
        if enabled is None
        else group_vector(enabled, g, dev) != 0
    )[sl]
    fresh, _inst, win, value = _rows_round(
        stack,
        lstate,
        torch.arange(gl, device=dev),
        next_inst[sl],
        torch.where(en, crnd[sl], NO_ROUND),
        en,
        alive[sl],
        _limits(reclaim_limit, g, dev)[sl],
        values,
        quorum,
    )
    return stack, lstate, fresh, win, value


def packed_multigroup_round(
    stack: AcceptorState,  # (Gl, A, N[, V])  one shard's slab, in place
    lstate: LearnerState,  # (Gl, N[, V])
    segids,  # int32[C]  per-lane slab row
    next_inst,  # int32[C]  per-lane window base
    crnd,  # int32[C]  per-lane round
    alive,  # bool/int32[C, A]  per-lane liveness
    quorum: int,
    values: torch.Tensor,  # int32[C, B, V]  packed burst, lane order
    enabled,  # int32[C]  0 marks a pad lane
    reclaim_limit=None,  # int32[C]; None = no reclamation
) -> tuple[AcceptorState, LearnerState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the packed shard round kernel: ``C`` lanes, lane
    ``j`` serving slab row ``segids[j]`` with its own watermark, round,
    liveness and limit.  Enabled lanes must name pairwise-distinct rows.
    A pad lane (``enabled == 0``) runs at NO_ROUND on the first row no
    enabled lane names, the reference's redirection: it changes nothing
    there, every pad writes back the row's own bytes, and it gives fresh 0,
    win NO_ROUND and value 0.  With a pad, ``C <= Gl`` leaves such a row.
    No host sync, so a CUDA graph can capture it.  Returns ``(stack,
    lstate, fresh[C, B], win[C, B], value[C, B, V])`` in lane order."""
    gl = stack.rnd.shape[0]
    c = values.shape[0]
    dev = values.device
    en = group_vector(enabled, c, dev) != 0
    seg = group_vector(segids, c, dev).long()
    used = torch.zeros((gl + 1,), dtype=I32, device=dev)
    used.index_fill_(0, torch.where(en, seg, gl), 1)
    rows = torch.where(en, seg, torch.argmin(used[:gl]))
    al = alive if isinstance(alive, torch.Tensor) else torch.from_numpy(np.asarray(alive))
    fresh, _inst, win, value = _rows_round(
        stack,
        lstate,
        rows,
        group_vector(next_inst, c, dev),
        torch.where(en, group_vector(crnd, c, dev), NO_ROUND),
        en,
        al.to(dev).reshape((c, -1)) != 0,
        _limits(reclaim_limit, c, dev),
        values,
        quorum,
    )
    return stack, lstate, fresh, win, value


# ---------------------------------------------------------------------------
# Persistent waves: K rounds in one dispatch
# ---------------------------------------------------------------------------
def persistent_multigroup_rounds(
    cstate: CoordinatorState,  # (G,)
    stack: AcceptorState,  # (G, A, N[, V])
    lstate: LearnerState,  # (G, N[, V])
    values: torch.Tensor,  # int32[K, G, B, V]
    active: torch.Tensor,  # bool[K, G, B]
    alive: torch.Tensor,  # bool[G, A]
    quorum: int,
    enabled_rounds=None,  # bool/int32[K, G]; None = all
    reclaim_limit=None,  # int32[G]; None = no reclamation
) -> tuple[
    CoordinatorState,
    AcceptorState,
    LearnerState,
    torch.Tensor,
    torch.Tensor,
    torch.Tensor,
    torch.Tensor,
]:
    """K Phase-2 rounds unrolled over ``multigroup_fused_round``: round
    ``k`` runs on ``values[k]`` with ``enabled_rounds[k]`` applied as the
    dataplane applies ``enabled`` to one round: a group sitting the round
    out is presented at NO_ROUND and its watermark does not advance, so the
    wave equals K sequential rounds by construction.  Returns ``(cstate',
    stack, lstate, fresh[K, G, B], inst[K, G, B], win_vrnd[K, G, B],
    value[K, G, B, V])``."""
    g = values.shape[1]
    dev = values.device
    outs = []
    for r in range(values.shape[0]):
        en = None if enabled_rounds is None else group_vector(enabled_rounds[r], g, dev) != 0
        eff = cstate
        if en is not None:
            eff = CoordinatorState(cstate.next_inst, torch.where(en, cstate.crnd, NO_ROUND))
        new_c, stack, lstate, *out = multigroup_fused_round(
            eff, stack, lstate, values[r], active[r], alive, quorum, reclaim_limit=reclaim_limit
        )
        marks = new_c.next_inst
        if en is not None:
            marks = torch.where(en, new_c.next_inst, cstate.next_inst)
        cstate = CoordinatorState(marks, cstate.crnd)
        outs.append(out)
    fresh, inst, win, value = (torch.stack(x) for x in zip(*outs, strict=True))
    return cstate, stack, lstate, fresh, inst, win, value


def _wave_table(x, dev: torch.device) -> torch.Tensor:
    """A ``(K, G)`` int32 wave-descriptor table on ``dev``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.int32))
    return x.to(dev, I32)


def persistent_cohort_rounds(
    stack: AcceptorState,  # (G, A, N[, V])
    lstate: LearnerState,  # (G, N[, V])
    gsel,  # int[NB]  selected group blocks
    wni,  # int32[K, G]  per-round window bases
    wen,  # int32[K, G]  per-round participation
    crnd: torch.Tensor,  # int32[G]
    alive: torch.Tensor,  # bool[G, A]
    quorum: int,
    values: torch.Tensor,  # int32[K, NB*GB, B, V]  compact wave values
    reclaim_limit=None,  # int32[G]; None = no reclamation
    *,
    group_block: int = 1,
    block_b: int | None = None,
) -> tuple[AcceptorState, LearnerState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the persistent wave kernel, with its compact-row
    contract: the rows of the group blocks ``gsel`` names run K rounds, row
    ``g`` of round ``k`` at ``wni[k, g]`` and inert where ``wen[k, g] ==
    0``, the rings updated in place.  ``block_b`` is the reference kernel's
    batch block and changes nothing here.  Returns ``(stack, lstate, fresh[K, C,
    B], win[K, C, B], value[K, C, B, V])`` with ``C = NB * group_block``."""
    del block_b
    g, n = stack.rnd.shape[0], stack.rnd.shape[2]
    k, _c, b, _v = values.shape
    if k * b > n:
        raise ValueError(f"a persistent wave of {k} x {b} instances would lap the {n}-slot ring")
    dev = values.device
    rows = cohort_rows(gsel, group_block, dev)
    ni, en = _wave_table(wni, dev)[:, rows], _wave_table(wen, dev)[:, rows] != 0
    cr, al, limit = crnd[rows], alive[rows], _limits(reclaim_limit, g, dev)[rows]
    outs = [
        _rows_round(stack, lstate, rows, ni[r], torch.where(en[r], cr, NO_ROUND), en[r], al,
                    limit, values[r], quorum)  # fmt: skip
        for r in range(k)
    ]
    fresh, _inst, win, value = (torch.stack(x) for x in zip(*outs, strict=True))
    return stack, lstate, fresh, win, value
