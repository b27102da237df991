"""Reference (scalar, host-side) Paxos role semantics.

A copy of ``repro.core.paxos``: plain-Python, dictionary-based role state
machines implementing exactly the protocol of the paper (multi-Paxos with
the Phase-1-elision optimization, §2.1/§3).  The batched torch engine
(``core/batched.py``) and the CUDA kernels (``kernels/``) must agree with
these semantics; the port's context uses ``Coordinator`` as its software
coordinator after a failover.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

from .types import (
    MSG_DELIVER,
    MSG_P1A,
    MSG_P1B,
    MSG_P2A,
    MSG_P2B,
    MSG_REJECT,
    MSG_SUBMIT,
)

NO_ROUND = -1


@dataclasses.dataclass
class Msg:
    """One Paxos header (paper Fig. 5), scalar form."""

    msgtype: int
    inst: int = 0
    rnd: int = NO_ROUND
    vrnd: int = NO_ROUND
    swid: int = 0
    value: bytes = b""

    def clone(self, **kw) -> "Msg":
        return dataclasses.replace(self, **kw)


class Proposer:
    """Software proposer: wraps values into SUBMIT headers (paper §3)."""

    def __init__(self, pid: int):
        self.pid = pid
        self.pending: dict[int, bytes] = {}   # seq -> payload (for retransmit)
        self._seq = 0

    def submit(self, payload: bytes) -> Msg:
        self._seq += 1
        self.pending[self._seq] = payload
        return Msg(MSG_SUBMIT, swid=self.pid, value=payload)


class Coordinator:
    """Sequencer: binds proposals to monotonically increasing instances.

    Under the single-coordinator optimization it never runs Phase 1 for fresh
    instances (acceptors are pre-initialized to promise round 0); Phase 1 is
    used only on takeover / recover.
    """

    def __init__(self, cid: int = 0, crnd: int = 0, next_inst: int = 0,
                 n_instances: int = 1 << 16):
        self.cid = cid
        self.crnd = crnd
        self.next_inst = next_inst
        self.n_instances = n_instances
        # Phase-1 bookkeeping for recover/takeover: inst -> {acceptor: (vrnd, value)}
        self.p1b: dict[tuple[int, int], dict[int, tuple[int, bytes]]] = {}

    # -- normal path (hardware fast path in CAANS) --------------------------
    def on_submit(self, msg: Msg) -> Msg:
        inst = self.next_inst
        self.next_inst += 1
        return Msg(MSG_P2A, inst=inst, rnd=self.crnd, swid=self.cid,
                   value=msg.value)

    # -- recovery path (phase 1 then 2) --------------------------------------
    def prepare(self, inst: int, rnd: int | None = None) -> Msg:
        if rnd is None:
            rnd = self.crnd
        return Msg(MSG_P1A, inst=inst, rnd=rnd, swid=self.cid)

    def on_p1b(self, msg: Msg, quorum: int) -> Msg | None:
        """Collect promises; at quorum, issue P2A with the required value.

        Returns the P2A to send once a quorum of promises for (inst, rnd) has
        been gathered, else None.  Chooses the value of the highest ``vrnd``
        among promises, or keeps the no-op the caller will supply.
        """
        key = (msg.inst, msg.rnd)
        acc = self.p1b.setdefault(key, {})
        acc[msg.swid] = (msg.vrnd, msg.value)
        if len(acc) < quorum:
            return None
        vrnd, value = max(acc.values(), key=lambda t: t[0])
        if vrnd == NO_ROUND:
            value = None  # caller substitutes the application no-op
        return Msg(MSG_P2A, inst=msg.inst, rnd=msg.rnd, swid=self.cid,
                   value=value if value is not None else b"")


class Acceptor:
    """The protocol's memory: a bounded ring of (rnd, vrnd, value) slots."""

    def __init__(self, aid: int, n_instances: int = 1 << 16):
        self.aid = aid
        self.n_instances = n_instances
        # slot -> (promised rnd, voted rnd, voted value).  Pre-initialized
        # (lazily) to (0, NO_ROUND, b"") == "promised round 0", eliding Phase 1.
        self.slots: dict[int, tuple[int, int, bytes]] = {}

    def _get(self, inst: int) -> tuple[int, int, bytes]:
        return self.slots.get(inst % self.n_instances, (0, NO_ROUND, b""))

    def _set(self, inst: int, v: tuple[int, int, bytes]) -> None:
        self.slots[inst % self.n_instances] = v

    def on_p1a(self, msg: Msg) -> Msg:
        rnd, vrnd, value = self._get(msg.inst)
        if msg.rnd > rnd:
            self._set(msg.inst, (msg.rnd, vrnd, value))
            return Msg(MSG_P1B, inst=msg.inst, rnd=msg.rnd, vrnd=vrnd,
                       swid=self.aid, value=value)
        return Msg(MSG_REJECT, inst=msg.inst, rnd=rnd, swid=self.aid)

    def on_p2a(self, msg: Msg) -> Msg:
        rnd, vrnd, value = self._get(msg.inst)
        if msg.rnd >= rnd:
            self._set(msg.inst, (msg.rnd, msg.rnd, msg.value))
            return Msg(MSG_P2B, inst=msg.inst, rnd=msg.rnd, vrnd=msg.rnd,
                       swid=self.aid, value=msg.value)
        return Msg(MSG_REJECT, inst=msg.inst, rnd=rnd, swid=self.aid)


class Learner:
    """Counts votes; delivers once a quorum votes the same round.

    Duplicate-safe: a (learner, instance) delivers at most once (paper §3.1,
    "learners detect and discard duplicated delivered values").
    """

    def __init__(self, lid: int, n_acceptors: int,
                 deliver_cb: Callable[[int, bytes], None] | None = None):
        self.lid = lid
        self.quorum = n_acceptors // 2 + 1
        self.votes: dict[int, dict[int, tuple[int, bytes]]] = {}
        self.delivered: dict[int, bytes] = {}
        self.deliver_cb = deliver_cb

    def on_p2b(self, msg: Msg) -> Msg | None:
        if msg.inst in self.delivered:
            return None
        votes = self.votes.setdefault(msg.inst, {})
        votes[msg.swid] = (msg.vrnd, msg.value)
        # quorum = f+1 votes with the same vrnd
        by_rnd: dict[int, int] = {}
        for vrnd, _ in votes.values():
            by_rnd[vrnd] = by_rnd.get(vrnd, 0) + 1
        for vrnd, count in by_rnd.items():
            if count >= self.quorum:
                value = next(v for r, v in votes.values() if r == vrnd)
                self.delivered[msg.inst] = value
                if self.deliver_cb:
                    self.deliver_cb(msg.inst, value)
                return Msg(MSG_DELIVER, inst=msg.inst, rnd=vrnd, value=value)
        return None

    def gaps(self, upto: int | None = None) -> list[int]:
        """Instances below the watermark that this learner has not delivered.

        With an explicit ``upto`` watermark the answer is defined even when
        nothing has been delivered yet: every instance in ``[0, upto]`` is a
        gap.  Only the implicit watermark (max delivered) needs deliveries.
        """
        if upto is None:
            if not self.delivered:
                return []
            hi = max(self.delivered)
        else:
            hi = upto
        return [i for i in range(hi + 1) if i not in self.delivered]
