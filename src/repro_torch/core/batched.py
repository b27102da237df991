"""Batched multi-instance Paxos dataplane in plain PyTorch: the plain engine.

The counterpart of ``repro.core.batched`` for one Paxos group.  Every
function processes a batch of Paxos headers (``MsgBatch``) in one shot, with
the reference's ``vmap`` over acceptors written out as a leading acceptor
axis ``A``.  ``fused_round`` is also the plain version of the fused round
kernel (``kernels/wirepath.py``): the two agree bit for bit.

Unlike the reference, which returns new immutable arrays, the register
files (``AcceptorState``, ``LearnerState``) are updated in place, as the
kernel updates them; the functions still return them, so callers read like
the reference.  A batch must address distinct ring slots (``inst % N``
pairwise distinct), which the sequencer guarantees for ``B <= N``.
"""

from __future__ import annotations

import dataclasses

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
    return MsgBatch(*(getattr(out, f.name)[0] for f in dataclasses.fields(MsgBatch)))


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
