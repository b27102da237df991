"""Replicated key-value tier over the consensus service (DESIGN.md §10).

A copy of ``repro.serve.kv`` for the port: host code only, over the port's
``serve.service``.

NetChain's thesis (PAPERS.md, arXiv 1802.08236), applied to this dataplane:
the consensus fabric IS the storage system.  Mutations ride the fused wire
path exactly once; reads never touch it while a session's lease holds.

Three layers:

* **Op codec** — versioned binary frames (put / delete / cas / get) small
  enough to ride one consensus value (``PaxosConfig.max_payload_bytes``).
  Every frame carries the issuing session's tag and a per-session op
  counter: the counter is the read-your-writes token the lease machinery
  keys on.
* **GroupReplica** — the deterministic apply loop.  One replica per
  ``(group, generation)`` segment consumes that segment's delivered log
  past its ``applied_len`` watermark; identical logs produce bit-identical
  state on every backend, which the linearizability chaos suite pins
  against unbounded twin oracles.
* **ReplicatedKV / KVSession** — the facade.  Writes submit frames through
  the typed :class:`~repro_torch.serve.service.Session` API; ``get`` is
  **consensus-free** while the session's lease holds (no unapplied writes
  + segment unchanged since validation): it applies already-delivered
  entries host-side and answers from replica state, dispatching nothing to
  the wire path.  A stale lease escalates to ONE serialized read-index op,
  which orders behind every surviving earlier op of the session.

Snapshot integration: a replica's apply cursor runs over
``full_group_log`` — snapshot-store prefix + live log, whose concatenation
is append-only stable under compaction — and ``ConsensusService.
adopt_group`` seeds transferred prefixes into that read.  State transfer
is therefore *applied* host-side, never replayed through the dataplane
(the dispatch-count tests pin this).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any

from .service import ConsensusService, Ticket, session_hash

# ---------------------------------------------------------------------------
# Op codec: versioned frames packed into MsgBatch value payloads
# ---------------------------------------------------------------------------
KV_MAGIC = 0xC5
KV_VERSION = 1
OP_PUT = 1
OP_DELETE = 2
OP_CAS = 3
OP_GET = 4           # serialized read-index marker: applies no state
OP_NAMES = {OP_PUT: "put", OP_DELETE: "delete", OP_CAS: "cas", OP_GET: "get"}
_FLAG_EXPECT = 1     # cas frame carries an expected value (else expect-absent)
# magic, version, opcode, flags, sid_tag, counter, klen, vlen, elen
_HEADER = struct.Struct("<BBBBIIHHH")


class KvCodecError(ValueError):
    """Malformed, truncated, or unsupported KV op frame."""


@dataclasses.dataclass(frozen=True)
class KvOp:
    """One decoded KV operation — the unit the apply loop consumes.

    ``sid_tag`` is the FNV-1a tag of the issuing session and ``counter``
    its per-session op counter: together they make every frame a
    read-your-writes token the lease machinery can look up in replica
    state."""

    op: int
    key: bytes
    value: bytes = b""
    expect: bytes | None = None   # cas only; None = "expect absent"
    sid_tag: int = 0
    counter: int = 0


def encode_op(op: KvOp) -> bytes:
    """Pack one op into its wire frame (raises ``KvCodecError`` on an
    unencodable op, e.g. ``expect`` on a non-cas frame)."""
    if op.op not in OP_NAMES:
        raise KvCodecError(f"unknown opcode {op.op}")
    flags = 0
    expect = b""
    if op.expect is not None:
        if op.op != OP_CAS:
            raise KvCodecError("expect is only meaningful on cas frames")
        flags |= _FLAG_EXPECT
        expect = op.expect
    for name, blob in (("key", op.key), ("value", op.value),
                       ("expect", expect)):
        if len(blob) > 0xFFFF:
            raise KvCodecError(f"{name} is {len(blob)} bytes (u16 max)")
    return (
        _HEADER.pack(
            KV_MAGIC,
            KV_VERSION,
            op.op,
            flags,
            op.sid_tag & 0xFFFFFFFF,
            op.counter & 0xFFFFFFFF,
            len(op.key),
            len(op.value),
            len(expect),
        )
        + op.key
        + op.value
        + expect
    )


def decode_op(buf: bytes) -> KvOp:
    """Decode one wire frame, rejecting anything malformed: wrong magic or
    version, unknown opcode or flags, and any length mismatch (truncation
    AND trailing garbage) — a replica must never guess at a frame."""
    if len(buf) < _HEADER.size:
        raise KvCodecError(
            f"frame truncated: {len(buf)} < header {_HEADER.size}"
        )
    magic, ver, opcode, flags, sid_tag, counter, klen, vlen, elen = (
        _HEADER.unpack_from(buf)
    )
    if magic != KV_MAGIC:
        raise KvCodecError(f"bad magic 0x{magic:02X}")
    if ver != KV_VERSION:
        raise KvCodecError(f"unsupported frame version {ver}")
    if opcode not in OP_NAMES:
        raise KvCodecError(f"unknown opcode {opcode}")
    if flags & ~_FLAG_EXPECT:
        raise KvCodecError(f"unknown flags 0x{flags:02X}")
    if len(buf) != _HEADER.size + klen + vlen + elen:
        raise KvCodecError(
            f"frame length {len(buf)} != header + key {klen} + value {vlen} "
            f"+ expect {elen}"
        )
    ofs = _HEADER.size
    key = buf[ofs : ofs + klen]
    ofs += klen
    value = buf[ofs : ofs + vlen]
    ofs += vlen
    expect_bytes = buf[ofs : ofs + elen]
    if flags & _FLAG_EXPECT:
        if opcode != OP_CAS:
            raise KvCodecError("expect flag on a non-cas frame")
        expect: bytes | None = expect_bytes
    else:
        if elen:
            raise KvCodecError("expect bytes without the expect flag")
        expect = None
    return KvOp(opcode, key, value, expect, sid_tag, counter)


# ---------------------------------------------------------------------------
# Deterministic apply loop, one replica per (group, generation) segment
# ---------------------------------------------------------------------------
class GroupReplica:
    """Deterministic apply loop over one ``(group, generation)`` segment.

    ``state`` maps key -> (value, version); a deleted key stays behind as a
    ``(None, version)`` tombstone so a newer segment's delete masks an older
    segment's value under stitched lookup.  ``applied_len`` is the segment's
    read watermark — the monotone count of log entries applied — and
    ``applied_counter`` the highest per-session op counter applied so far,
    the lease machinery's "has my write landed" oracle.
    """

    def __init__(self) -> None:
        self.state: dict[bytes, tuple[bytes | None, int]] = {}
        self.applied_len = 0
        self.applied_counter: dict[int, int] = {}
        self.final = False           # archived segment, fully applied

    def apply_log(self, log: list[tuple[int, bytes]]) -> int:
        """Apply the suffix past the watermark; returns ops consumed.

        Safe against any later view of the same segment: ``full_group_log``
        is append-only stable (compaction migrates entries into the
        snapshot prefix without reordering), so the cursor never re-applies
        an entry."""
        if len(log) < self.applied_len:
            raise ValueError(
                f"segment log shrank: {len(log)} < applied {self.applied_len}"
            )
        new = log[self.applied_len :]
        for _inst, payload in new:
            self._apply_one(decode_op(payload))
        self.applied_len = len(log)
        return len(new)

    def _apply_one(self, op: KvOp) -> None:
        prev = self.applied_counter.get(op.sid_tag, 0)
        if op.counter > prev:
            self.applied_counter[op.sid_tag] = op.counter
        if op.op == OP_GET:
            return                    # read-index marker: no state change
        if op.op == OP_CAS:
            cur = self.state.get(op.key)
            cur_val = None if cur is None else cur[0]
            if cur_val != op.expect:
                return                # failed cas: committed no-op
        cur = self.state.get(op.key)
        version = (0 if cur is None else cur[1]) + 1
        if op.op == OP_DELETE:
            self.state[op.key] = (None, version)   # tombstone
        else:                         # put, or a cas that matched
            self.state[op.key] = (op.value, version)

    def signature(self) -> tuple[dict[bytes, tuple[bytes | None, int]], int]:
        """Canonical (state, applied_len) for bit-equality across twins."""
        return (dict(self.state), self.applied_len)


# ---------------------------------------------------------------------------
# The facade: ReplicatedKV over a ConsensusService, leased sessions
# ---------------------------------------------------------------------------
class ReplicatedKV:
    """Replicated KV facade over a :class:`ConsensusService`.

    Maintains one :class:`GroupReplica` per ``(group, generation)`` segment
    and hands out stateful :class:`KVSession` clients.  ``refresh()`` is
    the host-side apply pump: archived segments finalize once, live
    segments consume their stitched log's new suffix.  Nothing in this
    class dispatches to the wire path — only session mutations (and
    read-index fallbacks) do, through the service."""

    def __init__(
        self, service: ConsensusService, max_read_rounds: int = 64
    ) -> None:
        self.service = service
        self.max_read_rounds = max_read_rounds
        self._replicas: dict[tuple[int, int], GroupReplica] = {}
        self._sessions: dict[Any, "KVSession"] = {}
        self.stats: dict[str, int] = {"leased_gets": 0, "read_index_gets": 0,
                                      "ops_submitted": 0}
        # per-epoch caches: the live set, current generations, and the
        # retirement archive only change at membership events, which all
        # flow through the service and bump its routing epoch — refresh()
        # is on the leased-get path and must stay O(live groups), not
        # O(history)
        self._snaps = getattr(service.ctx, "snapshots", None)
        self._epoch_seen = -1
        self._live_reps: list[tuple[int, GroupReplica]] = []

    def session(self, session_id: Any) -> "KVSession":
        """The stateful KV client for one session id (cached: unlike the
        stateless routing handles, a KV session owns lease state)."""
        s = self._sessions.get(session_id)
        if s is None:
            s = self._sessions[session_id] = KVSession(self, session_id)
        return s

    def replica(self, gid: int, gen: int | None = None) -> GroupReplica:
        """The segment replica for ``(gid, gen)`` (current generation when
        ``gen`` is omitted), created empty on first touch."""
        if gen is None:
            gen = self.service.group_generation(gid)
        key = (gid, gen)
        rep = self._replicas.get(key)
        if rep is None:
            rep = self._replicas[key] = GroupReplica()
        return rep

    def refresh(self) -> None:
        """Apply everything already delivered — host-side only.

        Snapshot and adopted prefixes are *applied* here exactly like live
        entries (they arrive through the same stitched ``full_group_log``
        read), never replayed through the dataplane."""
        svc = self.service
        ctx = svc.ctx
        if svc.routing_epoch != self._epoch_seen:
            for key, log in svc.archived_segments().items():
                rep = self.replica(*key)
                if not rep.final:
                    rep.apply_log(log)
                    rep.final = True
            self._live_reps = [
                (gid, self.replica(gid)) for gid in ctx.live_groups()
            ]
            self._epoch_seen = svc.routing_epoch
        snaps = self._snaps
        for gid, rep in self._live_reps:
            # cheap steady-state exit: the stitched log is append-only
            # stable, so an unchanged length means no new suffix — skip
            # materializing the prefix+live concatenation (this is what
            # keeps a leased get O(1) in the history length)
            total = len(ctx.group_log[gid])
            if snaps is not None:
                total += len(snaps.log_prefix(gid))
            if total != rep.applied_len:
                rep.apply_log(ctx.full_group_log(gid))

    def read_watermark(self, gid: int) -> int:
        """Applied-entry count of the group's current-generation segment —
        the monotone per-group read watermark leased gets answer behind."""
        return self.replica(gid).applied_len

    def lookup(self, session_id: Any, key: bytes) -> bytes | None:
        """Stitched lookup over the session's segment chain, newest segment
        first; a tombstone in a newer segment masks older values."""
        for seg in reversed(self.service.session_chain(session_id)):
            rep = self._replicas.get(seg)
            if rep is not None and key in rep.state:
                return rep.state[key][0]
        return None


class KVSession:
    """Stateful KV client bound to one session id.

    Tracks the per-session op counter (the RYW token every frame carries),
    the set of unapplied tokens, and the segment/epoch of the last lease
    validation.  The lease rule (DESIGN.md §10): a host-side get is
    read-your-writes safe iff

    * every op this session issued has been applied somewhere on its
      segment chain (no pending tokens), and
    * the session's ``(group, generation)`` segment is unchanged since the
      lease was last validated — a membership event that re-routes the
      session invalidates it (in-flight writes may have died with a
      retired generation).  An epoch bump that did NOT move the session
      (another tenant's membership event) re-validates host-side.

    A stale lease escalates to ONE read-index op through consensus: the op
    serializes behind every surviving earlier op of the session, so once
    it applies the session's writes have too, and the lease re-validates
    at the current epoch."""

    def __init__(self, kv: ReplicatedKV, session_id: Any) -> None:
        self.kv = kv
        self.id = session_id
        self.tag = session_hash(session_id)
        self._counter = 0
        self._pending: dict[int, int] = {}   # counter -> group submitted to
        self._epoch = kv.service.routing_epoch
        self._seg = self._current_seg()
        # segment chain cached per routing epoch: the chain only grows at
        # membership events, and recomputing it hashes the session id per
        # epoch — too hot for a per-get path meant to be O(1)
        self._chain: list[tuple[int, int]] | None = None
        self._chain_epoch = -1

    # -- write path (consensus) ---------------------------------------------
    def put(self, key: bytes, value: bytes) -> Ticket:
        return self._submit(KvOp(OP_PUT, key, value, None, self.tag))

    def delete(self, key: bytes) -> Ticket:
        return self._submit(KvOp(OP_DELETE, key, b"", None, self.tag))

    def cas(self, key: bytes, expect: bytes | None, value: bytes) -> Ticket:
        """Compare-and-set: applies iff the segment's current value equals
        ``expect`` (``None`` = create iff absent).  A failed cas is a
        committed no-op — it still advances the session's RYW token."""
        return self._submit(KvOp(OP_CAS, key, value, expect, self.tag))

    def _submit(self, op: KvOp) -> Ticket:
        self._counter += 1
        op = dataclasses.replace(op, counter=self._counter)
        ticket = self.kv.service.session(self.id).submit(encode_op(op))
        self._pending[self._counter] = ticket.group
        self.kv.stats["ops_submitted"] += 1
        return ticket

    # -- consensus-free read path -------------------------------------------
    def _current_seg(self) -> tuple[int, int]:
        svc = self.kv.service
        gid = svc.group_of(self.id)
        return (gid, svc.group_generation(gid))

    def _segments(self) -> list[tuple[int, int]]:
        svc = self.kv.service
        ep = svc.routing_epoch
        chain = self._chain
        if chain is None or self._chain_epoch != ep:
            chain = svc.session_chain(self.id)
            self._chain = chain
            self._chain_epoch = ep
        return chain

    def _applied_token(self) -> int:
        """Highest op counter of this session applied anywhere on its
        chain (counters are issued in one monotone stream, so the max is
        exactly "everything up to here has landed or died")."""
        best = 0
        for seg in self._segments():
            rep = self.kv._replicas.get(seg)
            if rep is not None:
                c = rep.applied_counter.get(self.tag, 0)
                if c > best:
                    best = c
        return best

    def _revalidate(self) -> None:
        """Cheap host-side lease upkeep: prune tokens at or below the
        applied high-water mark, and absorb epoch bumps that left this
        session's segment in place."""
        if not self._pending and self._epoch == self.kv.service.routing_epoch:
            return                    # lease already valid: nothing to do
        applied = self._applied_token()
        for c in [c for c in self._pending if c <= applied]:
            del self._pending[c]
        svc = self.kv.service
        if self._epoch != svc.routing_epoch:
            seg = self._current_seg()
            if seg == self._seg:
                self._epoch = svc.routing_epoch
            # else: stale until the read-index round re-validates

    @property
    def lease_valid(self) -> bool:
        return not self._pending and self._epoch == self.kv.service.routing_epoch

    def get(self, key: bytes) -> bytes | None:
        """Read one key.

        Leased: host-side only — apply already-delivered entries, answer
        from replica state, ZERO wire-path dispatches (pinned by the
        dispatch-count tests).  Stale: one serialized read-index op (see
        class docstring), then the same replica read."""
        kv = self.kv
        kv.refresh()
        self._revalidate()
        if self.lease_valid:
            kv.stats["leased_gets"] += 1
        else:
            self._read_index()
            kv.stats["read_index_gets"] += 1
        for seg in reversed(self._segments()):
            rep = kv._replicas.get(seg)
            if rep is not None and key in rep.state:
                return rep.state[key][0]
        return None

    def _read_index(self) -> None:
        svc = self.kv.service
        ticket = self._submit(KvOp(OP_GET, b"", b"", None, self.tag))
        target = self._counter
        seg = (ticket.group, svc.group_generation(ticket.group))
        for _ in range(self.kv.max_read_rounds):
            self.kv.refresh()
            rep = self.kv._replicas.get(seg)
            if (
                rep is not None
                and rep.applied_counter.get(self.tag, 0) >= target
            ):
                break
            svc.pump()
        else:
            raise RuntimeError(
                f"read-index op for session {self.id!r} did not apply "
                f"within {self.kv.max_read_rounds} pump rounds"
            )
        # every op this session issued before the read either applied (it
        # sequences ahead of the read in the same group) or died with a
        # retired generation — nothing is still outstanding
        self._pending.clear()
        self._seg = self._current_seg()
        self._epoch = svc.routing_epoch
