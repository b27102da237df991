"""Consensus as a service: session -> group routing over the fused dataplane.

The port of the consensus half of ``repro.serve.engine``.
``ConsensusService`` is the serving tier of the multi-group dataplane
(the reference's DESIGN.md §5): client *sessions* hash-route onto the G
device-resident Paxos groups of a multi-group ``PaxosContext``, so many
independent session streams share one fused dispatch while each session
keeps a total order within its group.  Everything here is host code; the
context it wraps runs on its own device (the card unless it was built with
another), and this module imports neither the models nor the LM half of
``serve.engine``.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193


def session_hash(session_id) -> int:
    """32-bit FNV-1a of a session id (bytes / str / arbitrary-width int).

    Stable across processes and runs (unlike Python's salted ``hash``), cheap
    enough for the submit path, and uniform enough that G groups see balanced
    load from arbitrary session-id distributions.
    """
    if isinstance(session_id, bytes):
        data = session_id
    elif isinstance(session_id, str):
        data = session_id.encode()
    else:
        # variable-length encoding: arbitrary-width ints (uuid4().int is
        # 128-bit) must not overflow a fixed 8-byte window
        sid = int(session_id)
        data = sid.to_bytes(
            max(1, (sid.bit_length() + 8) // 8), "little", signed=True
        )
    h = _FNV_OFFSET
    for byte in data:
        h = ((h ^ byte) * _FNV_PRIME) & 0xFFFFFFFF
    return h


def session_group(session_id, n_groups: int) -> int:
    """Deterministic session -> consensus-group routing over a full group
    axis: ``session_hash % n_groups``."""
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    return session_hash(session_id) % n_groups


def session_group_live(session_id, live_groups: list[int], capacity: int) -> int:
    """Epoch-aware routing: primary slot with deterministic fallback.

    The session's *primary* slot is the capacity routing
    (``session_hash % capacity`` — exactly :func:`session_group`, and
    placement-independent).  While the primary is live the session stays
    pinned to it, so a membership event never moves sessions of surviving
    groups; only sessions whose slot retired re-route, deterministically,
    over the live set (``live_groups[hash % len]``) — and return to their
    primary when the slot is recreated."""
    if not live_groups:
        raise ValueError("no live consensus groups to route onto")
    h = session_hash(session_id)
    primary = h % capacity
    if primary in live_groups:
        return primary
    return live_groups[h % len(live_groups)]


class Ticket(NamedTuple):
    """Structured submit receipt: the group that sequences the value and
    the client sequence within that group's space.  A ``NamedTuple`` so the
    historical ``gid, seq = service.submit(...)`` unpacking keeps working
    while new code reads ``ticket.group`` / ``ticket.seq``."""

    group: int
    seq: int


class Session:
    """Typed per-session client handle — the session-scoped surface of
    ``ConsensusService``, replacing the loose ``(session_id, payload)``
    calling convention.

    Handles are stateless and constructed on demand (``service.session(id)``):
    routing is re-resolved per call, so a handle is always epoch-aware, and
    no per-session host memory accretes in the serving tier — a session
    universe of millions costs nothing here.  Stateful clients (leases,
    counters) layer above; see ``serve.kv.KVSession``.
    """

    __slots__ = ("service", "id")

    def __init__(self, service: "ConsensusService", session_id):
        self.service = service
        self.id = session_id

    @property
    def group(self) -> int:
        """The session's current group (epoch-aware routing)."""
        return self.service.group_of(self.id)

    def submit(self, payload: bytes) -> Ticket:
        """Route one value to the session's group; returns a :class:`Ticket`.

        The value-width door guard runs here as well as in
        ``PaxosContext.submit``: an oversized payload must fail at whichever
        front door the client used, with the limit named."""
        svc = self.service
        limit = svc.ctx.cfg.max_payload_bytes
        if len(payload) > limit:
            raise ValueError(
                f"payload is {len(payload)} bytes; this service carries at "
                f"most {limit} payload bytes per value "
                f"(PaxosConfig.value_words={svc.ctx.cfg.value_words})"
            )
        gid = svc.group_of(self.id)
        seq = svc.ctx.submit(payload, group=gid)
        svc.stats["submitted"] += 1
        svc.submits_per_group[gid] += 1
        return Ticket(gid, seq)

    def delivered(self) -> list[tuple[int, bytes]]:
        """The stitched ``(inst, payload)`` log this session observes."""
        return self.service._delivered(self.id)

    def read(self) -> list[bytes]:
        """Delivered payloads only, in decided order — the common
        application-level read."""
        return [p for _inst, p in self.service._delivered(self.id)]


class ConsensusService:
    """Front door of the multi-group consensus dataplane.

    Wraps a (multi-group) ``PaxosContext``: ``session(id)`` hands out the
    typed per-session handle (submit hash-routes the session's values to
    its group), ``pump``/``run_until_quiescent`` drive the shared fused
    dispatch, and ``Session.delivered`` reads the session's group log — the
    per-group total order every session in that group observes.

    **Routing epochs (dynamic membership, DESIGN.md §7).**  ``cfg.n_groups``
    is a capacity; the routing domain is the *live* group set.  Every
    membership event driven through ``create_group``/``retire_group`` bumps
    the routing epoch: sessions re-resolve via
    :func:`session_group_live` (primary capacity slot with deterministic
    fallback over the live set — placement-independent, and stable for
    sessions of surviving groups), a retiring group's log is archived under
    its ``(gid, generation)``, and ``delivered`` stitches a session's
    pre-retirement logs in front of its current group's log.  Membership
    must flow through this service (not the raw context) for the archive to
    stay complete.
    """

    def __init__(self, ctx):
        self.ctx = ctx
        self.n_groups = ctx.cfg.n_groups
        self.stats = {"submitted": 0}
        # bounded introspection state: G counters, not a per-session map —
        # the hash is pure and cheap, and a session universe of millions
        # must not accrete host memory in the routing tier
        self.submits_per_group = [0] * self.n_groups
        # routing epochs: per-epoch (live gid list, per-slot generation)
        # snapshots; archived logs keyed by (gid, generation)
        self._gen = [0] * self.n_groups
        self._epochs: list[tuple[list[int], list[int]]] = [
            (self._live_now(), list(self._gen))
        ]
        self._archived: dict[tuple[int, int], list[tuple[int, bytes]]] = {}

    # -- membership (drives the context, keeps the epoch history) ------------
    def _live_now(self) -> list[int]:
        live = getattr(self.ctx.hw, "live_host", None)
        if live is None:
            return list(range(self.n_groups))
        return [g for g in range(self.n_groups) if live[g]]

    @property
    def routing_epoch(self) -> int:
        return len(self._epochs) - 1

    def _bump_epoch(self) -> None:
        self._epochs.append((self._live_now(), list(self._gen)))

    def create_group(self) -> int:
        """Admit a tenant: claim a slot on the group axis and bump the
        routing epoch — sessions re-resolve over the grown live set."""
        gid = self.ctx.create_group()
        self._gen[gid] += 1
        self._bump_epoch()
        return gid

    def retire_group(self, gid: int) -> None:
        """Reclaim a tenant's slot: the group's log is archived under its
        (gid, generation) for ``delivered`` stitching, and the routing
        epoch bumps — sessions pinned to the slot re-route
        deterministically over the survivors."""
        log = self.ctx.retire_group(gid)
        self._archived[(gid, self._gen[gid])] = list(log)
        self._bump_epoch()

    def adopt_group(self, snap, log_prefix=None) -> int:
        """Admit a tenant bootstrapping from a transferred snapshot
        (vertical-Paxos state transfer, DESIGN.md §9) *through the serving
        tier*: generation and routing-epoch bookkeeping exactly as
        ``create_group``, with the context seeding its ``SnapshotStore``
        from the sealed transfer.  Returns the new group id."""
        gid = self.ctx.adopt_group(snap, log_prefix)
        self._gen[gid] += 1
        self._bump_epoch()
        return gid

    def migrate_group(self, gid: int, dst_shard: int):
        """Live slab migration through the serving tier (DESIGN.md §13):
        drain -> sealed snapshot -> seal-verified slot swap on the sharded
        dataplane, then a routing-epoch bump so placement-aware routers
        (``shard_of``) re-resolve.  The group's *identity* is untouched —
        no generation bump, session -> group routing and ``delivered``
        stitching are placement-blind.  Returns the sealed snapshot the
        transfer was verified against."""
        snap = self.ctx.migrate_group(gid, dst_shard)
        self._bump_epoch()
        return snap

    def plan_placement(self):
        """The load-weighted ``PlacementMap`` the sharded dataplane would
        adopt for the current ``group_loads()`` snapshot (LPT greedy,
        deterministic) — pure planning; adopt it group-by-group with
        ``migrate_group``."""
        hw = self.ctx.hw
        if not hasattr(hw, "plan_placement"):
            raise ValueError("plan_placement requires the sharded dataplane")
        return hw.plan_placement(self.group_loads())

    def group_of(self, session_id) -> int:
        """Epoch-aware session -> group routing over the live set."""
        live, _gens = self._epochs[-1]
        return session_group_live(session_id, live, self.n_groups)

    # -- group -> shard placement (the sharded dataplane, DESIGN.md §6) ------
    def group_placement(self) -> list[int]:
        """group id -> owning mesh shard.  Routing composes as session ->
        group (FNV-1a, placement-independent) -> shard (dataplane
        placement); an unsharded dataplane is the degenerate one-shard
        placement.  Re-placing groups over a different mesh therefore never
        moves a session between groups — only the group's *shard* changes."""
        hw = self.ctx.hw
        if hasattr(hw, "group_placement"):
            return hw.group_placement()
        return [0] * self.n_groups

    def shard_of(self, session_id) -> int:
        """Mesh shard that serves the session's group (O(1): indexes the
        dataplane's placement directly — no per-request list rebuild)."""
        gid = self.group_of(session_id)
        hw = self.ctx.hw
        if hasattr(hw, "shard_of_group"):
            return hw.shard_of_group(gid)
        return 0

    # -- the typed session surface -------------------------------------------
    def session(self, session_id) -> Session:
        """The typed per-session handle (see :class:`Session`)."""
        return Session(self, session_id)

    def submit(self, session_id, payload: bytes) -> Ticket:
        """Deprecated: use ``service.session(session_id).submit(payload)``.

        Thin shim over the typed surface; the ``Ticket`` it returns unpacks
        exactly like the historical ``(group, client_seq)`` tuple."""
        warnings.warn(
            "ConsensusService.submit(session_id, payload) is deprecated; "
            "use service.session(session_id).submit(payload)",
            DeprecationWarning,
            stacklevel=2,
        )
        return Session(self, session_id).submit(payload)

    def pump(self, rounds: int = 1) -> None:
        """Drive the shared dispatch.  The serving tier feeds the dispatch
        planner its cumulative per-group load snapshot first
        (``group_loads``) — introspection the planner surfaces through
        ``plan_report`` alongside its own per-wave tiering decisions."""
        planner = getattr(self.ctx, "planner", None)
        if planner is not None:
            planner.observe_service_loads(self.group_loads())
        self.ctx.pump(rounds)

    def run_until_quiescent(self, max_rounds: int = 64) -> None:
        """Pump until nothing is pending (or ``max_rounds``), refreshing
        the planner's serving-tier load snapshot *per pumped round* — the
        historical single pre-loop observation left multi-round quiescence
        runs reporting stale load introspection (delivery callbacks can
        change per-group loads between rounds)."""
        for _ in range(max_rounds):
            if self.ctx.quiescent():
                return
            self.pump()

    def plan_report(self) -> dict:
        """The dispatch planner's introspection report (burst-shape
        vocabulary, cohort dispatch counts, full-fold rounds, realignment
        sweeps) — the serving-tier view of DESIGN.md §8."""
        planner = getattr(self.ctx, "planner", None)
        if planner is None:
            return {}
        return planner.report()

    def delivered(self, session_id) -> list[tuple[int, bytes]]:
        """Deprecated: use ``service.session(session_id).delivered()``."""
        warnings.warn(
            "ConsensusService.delivered(session_id) is deprecated; "
            "use service.session(session_id).delivered()",
            DeprecationWarning,
            stacklevel=2,
        )
        return self._delivered(session_id)

    def session_chain(self, session_id) -> list[tuple[int, int]]:
        """The distinct ``(group, generation)`` segments a session's history
        spans, in epoch order — the stitching skeleton ``Session.delivered``
        reads through, exposed so state-machine tiers (``serve.kv``) can
        keep one incremental replica per segment instead of re-reading
        concatenated logs."""
        seen: set = set()
        chain: list[tuple[int, int]] = []
        for live, gens in self._epochs:
            if not live:
                continue
            gid = session_group_live(session_id, live, self.n_groups)
            key = (gid, gens[gid])
            if key not in seen:
                seen.add(key)
                chain.append(key)
        return chain

    def group_generation(self, gid: int) -> int:
        """Current generation (``create_group`` count) of capacity slot
        ``gid`` — the second half of a segment key."""
        return self._gen[gid]

    def log_segment(self, gid: int, gen: int) -> list[tuple[int, bytes]]:
        """One ``(group, generation)`` segment of the stitched history: the
        archived log for retired generations, the live stitched log
        (snapshot prefix + group log, ``PaxosContext.full_group_log``) for
        the current one, empty for a generation this service never saw
        decide."""
        key = (gid, gen)
        if key in self._archived:
            return self._archived[key]
        if gen == self._gen[gid]:
            return self.ctx.full_group_log(gid)
        return []

    def archived_segments(self) -> dict[tuple[int, int], list[tuple[int, bytes]]]:
        """Read-only view of the retirement archive: ``(gid, generation) ->
        drained log``.  Apply loops use it to finalize retired segments."""
        return dict(self._archived)

    def _delivered(self, session_id) -> list[tuple[int, bytes]]:
        """The (inst, payload) log the session observes, in decided order.

        Uniform group-log read — no G == 1 special case (a service can pass
        through G == 1 transiently under dynamic membership, and an
        ungrouped context logs into ``group_log[0]``).  Under routing
        epochs the view is *stitched*: for every distinct (group,
        generation) the session was routed to, the archived pre-retirement
        log (retired generations) or the live group log (the current one),
        concatenated in epoch order.  With snapshots enabled the live read
        is itself stitched — compacted snapshot prefix + live log
        (``PaxosContext.full_group_log``) — so compaction is invisible to
        sessions in steady state, not just at retirement.
        """
        out: list[tuple[int, bytes]] = []
        for key in self.session_chain(session_id):
            out.extend(self.log_segment(*key))
        return out

    def group_loads(self) -> list[int]:
        """Values submitted per group (load-balance introspection)."""
        return list(self.submits_per_group)
