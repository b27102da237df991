"""The cohort dispatch planner: how a round of multi-group load maps onto
device dispatches, on host integers only.

The counterpart of ``repro.core.plan``, bit for bit:

* **Burst quantization.** Every wire burst is a power of two in
  ``[MIN_BURST, batch]``, whatever the engine, so the plain engine and the
  kernels see identical burst shapes and their delivery logs cannot fork.
* **Lockstep cohorts.** The enabled groups of a round split by quantized
  burst into tiers, one dispatch per tier, hot to cold.
* **Fold widths.** ``fold_width_full`` and ``cohort_blocks`` pick the
  reference kernel's group fold and the group blocks a cohort dispatch
  visits.  The port's round kernel maps one group per row at any window
  base, so the fold changes no result here; the dataplane reports it
  (``last_gb``) exactly as the reference does.
* **Realignment.** After ``realign_after`` fragmented rounds the planner
  burns divergent groups forward to a common block boundary.

``wire_block`` and ``window_aligned`` keep the reference kernel's block,
which decides where realignment and the failover restore burn forward to.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import Any

import numpy as np

NO_ROUND = -1
NOP_SENTINEL = -0x7FFFFFFF  # first value word marking an internal filler slot
MIN_BURST = 8  # smallest wire burst (pow2 quantization floor)
# The reference kernel's batch block (``repro.kernels.wirepath``); instance
# numbering after a coordinator restore depends on it, so it is kept here.
DEFAULT_BLOCK_B = 128


def wire_block(b: int) -> int:
    """The reference kernel's batch-block size for a burst of ``b``."""
    return min(DEFAULT_BLOCK_B, b)


def window_aligned(n_instances: int, base: int, b: int) -> bool:
    """True iff a contiguous window [base, base+b) satisfies the reference
    kernel's ring-blocking invariants (BB | base, BB | B, BB | N, B <= N)."""
    bb = wire_block(b)
    return b % bb == 0 and n_instances % bb == 0 and b <= n_instances and base % bb == 0


def quantize_burst(n: int, cap: int) -> int:
    """Wire-burst sizing: next power of two >= ``n`` in [MIN_BURST, cap]."""
    be = MIN_BURST
    while be < n:
        be *= 2
    return min(be, cap)


def _divisors(cap: int) -> list[int]:
    return [d for d in range(1, cap + 1) if cap % d == 0]


def _block_lockstep(gids: Sequence[int], marks: Sequence[int], d: int) -> bool:
    """True iff every ``d``-aligned block's members (of ``gids``) share one
    watermark — the validity condition for folding ``d`` groups per grid
    step with cohort-base substitution for non-members."""
    classes: dict[int, int] = {}
    for g in gids:
        blk = g // d
        if classes.setdefault(blk, marks[g]) != marks[g]:
            return False
    return True


def fold_width_full(
    gids: Sequence[int], marks: Sequence[int], cap: int
) -> int:
    """Fold width for a *full-width* dispatch (every group block on the
    grid): the largest divisor of ``cap`` folding validly over ``gids``.

    Generalizes the historical ``group_block ∈ {cap, 1}`` cliff: cohorts
    that diverged after per-group failovers can still fold block-wise
    (e.g. groups [0..3] at one watermark and [4..7] at another fold at
    width 4), each block deriving its ring offset from its own lockstep
    base."""
    for d in sorted(_divisors(cap), reverse=True):
        if _block_lockstep(gids, marks, d):
            return d
    return 1


def cohort_blocks(
    gids: Sequence[int], marks: Sequence[int], cap: int
) -> tuple[int, list[int]]:
    """Group-axis *compaction* for a cohort dispatch: pick ``(gb, blocks)``
    so the kernel grid visits only the aligned ``gb``-blocks containing
    cohort members.

    Objective: minimize the number of visited blocks (grid steps along the
    group axis), then the fold width (block size — smaller blocks carry
    fewer inert filler rows).  A single hot group therefore costs one
    1-group block; a 7-of-8 cold cohort costs one folded 8-group block."""
    best: tuple[tuple[int, int], int, list[int]] | None = None
    for d in _divisors(cap):
        if not _block_lockstep(gids, marks, d):
            continue
        blocks = sorted({g // d for g in gids})
        key = (len(blocks), d)
        if best is None or key < best[0]:
            best = (key, d, blocks)
    assert best is not None  # d = 1 is always valid
    return best[1], best[2]


def pack_rows(
    rows: Sequence[np.ndarray], be: int, value_words: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pack encoded value rows into a ``(be, V)`` wire burst; unfilled slots
    carry the NOP sentinel and are inactive.  An oversized chunk fails
    before any wire array is built."""
    if len(rows) > be:
        raise ValueError(f"chunk of {len(rows)} rows exceeds quantized burst {be}")
    vals = np.zeros((be, value_words), np.int32)
    active = np.zeros((be,), bool)
    vals[:, 0] = NOP_SENTINEL
    for j, row in enumerate(rows):
        vals[j] = row
        active[j] = True
    return vals, active


def scatter_rows(
    gids: Sequence[int],
    values: np.ndarray,
    active: np.ndarray | None,
    g: int,
    value_words: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Scatter compact cohort rows into a full-width ``(G, BE, V)`` burst:
    non-member rows carry the NOP sentinel and are inactive (they ride any
    dispatch inert).  The single definition of the full-width packing
    convention, used by the plain engine's full-width dispatch."""
    be = values.shape[1]
    vals_f = np.zeros((g, be, value_words), np.int32)
    vals_f[:, :, 0] = NOP_SENTINEL
    act_f = np.zeros((g, be), bool)
    for row, gid in enumerate(gids):
        vals_f[gid] = values[row]
        if active is not None:
            act_f[gid] = active[row]
    return vals_f, act_f


@dataclasses.dataclass(frozen=True)
class Cohort:
    """One dispatch of a round plan: the enabled groups sharing a quantized
    burst size.  ``gids`` may span several watermark classes — the dispatch
    folds block-wise where classes align and degrades to width-1 blocks
    where they don't (``fold_width_full`` / ``cohort_blocks``).

    ``rounds`` > 1 marks a *persistent wave* (DESIGN.md §11): the dispatch
    runs that many back-to-back full-batch Phase-2 rounds device-side,
    consuming ``rounds`` burst-sized chunks per member, and syncs results
    back to the host once."""

    gids: tuple[int, ...]
    burst: int
    rounds: int = 1


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """The resolved plan for one chunk wave.

    ``cohorts`` are ordered hot -> cold (burst descending); ``realign``
    lists ``(gid, target_watermark)`` burns the dataplane must apply before
    dispatching; ``fragmentation`` counts watermark classes among enabled
    groups (after burns); ``full_fold`` marks the highest-amortization
    state — one cohort, one watermark class — where the dispatch folds the
    full width."""

    cohorts: tuple[Cohort, ...]
    enabled: tuple[bool, ...]
    realign: tuple[tuple[int, int], ...]
    fragmentation: int
    full_fold: bool


@dataclasses.dataclass(frozen=True)
class PlacementMap:
    """Load-weighted group -> shard placement for the sharded dataplane
    (DESIGN.md §13): a permutation ``slot_of[gid] -> slot`` where slot
    ``s * Gl + r`` is physical slab row ``r`` on mesh shard ``s``.

    Device slabs are *slot*-indexed; group identity (and therefore session
    routing hashes, log segment names and twin-oracle numbering) never
    changes when a group moves — only its slot does.  The map is a plain
    permutation so membership events compose with placement: every group id,
    live or free, always owns exactly one slot, and a migration is a slot
    swap between a live group and a free one.

    Construction is deterministic and engine-agnostic: ``weighted`` is an
    LPT greedy over ``(-load, gid)`` with ties broken by (shard load sum,
    occupancy, shard id), so equal loads round-robin ``gid i -> shard
    i % n_shards`` and all four backends resolve the identical map from the
    identical ``group_loads()`` snapshot.
    """

    slot_of: tuple[int, ...]
    groups_per_shard: int

    def __post_init__(self) -> None:
        n = len(self.slot_of)
        if n % self.groups_per_shard:
            raise ValueError(
                f"{n} groups not divisible by Gl={self.groups_per_shard}"
            )
        if sorted(self.slot_of) != list(range(n)):
            raise ValueError(f"slot_of is not a permutation: {self.slot_of}")

    @property
    def n_groups(self) -> int:
        return len(self.slot_of)

    @property
    def n_shards(self) -> int:
        return len(self.slot_of) // self.groups_per_shard

    @property
    def group_of(self) -> tuple[int, ...]:
        """Inverse permutation: physical slot -> group id."""
        inv = [0] * len(self.slot_of)
        for gid, slot in enumerate(self.slot_of):
            inv[slot] = gid
        return tuple(inv)

    def shard_of(self, gid: int) -> int:
        return self.slot_of[gid] // self.groups_per_shard

    def row_of(self, gid: int) -> int:
        """Local slab row of ``gid`` within its owning shard."""
        return self.slot_of[gid] % self.groups_per_shard

    def identity_map(self) -> bool:
        return all(s == g for g, s in enumerate(self.slot_of))

    def swapped(self, gid: int, other: int) -> "PlacementMap":
        """The map with ``gid`` and ``other`` exchanging slots — the one
        placement mutation migration performs (both identities keep exactly
        one slot, so the result is again a permutation by construction)."""
        slots = list(self.slot_of)
        slots[gid], slots[other] = slots[other], slots[gid]
        return PlacementMap(tuple(slots), self.groups_per_shard)

    @classmethod
    def identity(cls, n_groups: int, groups_per_shard: int) -> "PlacementMap":
        return cls(tuple(range(n_groups)), groups_per_shard)

    @classmethod
    def weighted(
        cls,
        loads: Sequence[int],
        n_shards: int,
        groups_per_shard: int,
    ) -> "PlacementMap":
        """LPT greedy: heaviest group first onto the least-loaded non-full
        shard.  Ragged by construction — a hot shard may host one tenant
        while a cold shard hosts ``Gl`` — subject only to the ``Gl``-slot
        capacity.  Within a shard, rows fill in assignment order."""
        g = len(loads)
        if g != n_shards * groups_per_shard:
            raise ValueError(
                f"{g} loads for {n_shards} x {groups_per_shard} slots"
            )
        order = sorted(range(g), key=lambda i: (-int(loads[i]), i))
        sums = [0] * n_shards
        rows: list[list[int]] = [[] for _ in range(n_shards)]
        for gid in order:
            s = min(
                (s for s in range(n_shards) if len(rows[s]) < groups_per_shard),
                key=lambda s: (sums[s], len(rows[s]), s),
            )
            sums[s] += int(loads[gid])
            rows[s].append(gid)
        slots = [0] * g
        for s in range(n_shards):
            for r, gid in enumerate(rows[s]):
                slots[gid] = s * groups_per_shard + r
        return cls(tuple(slots), groups_per_shard)


class DispatchPlanner:
    """Owns the per-round dispatch policy for a multi-group context.

    Stateless per round except for the realignment counter (consecutive
    fragmented rounds) and introspection stats; the plan itself is a pure
    function of host-authoritative scalars (loads, watermark mirrors,
    membership, rounds), which is why unsharded, sharded and the plain engine
    resolve every round identically — the parity contract (DESIGN.md §8).
    """

    def __init__(
        self,
        batch: int,
        n_instances: int,
        realign_after: int | None = None,
        persistent_rounds: int = 1,
        sharded: bool = False,
    ) -> None:
        self.batch = batch
        self.n_instances = n_instances
        self.realign_after = realign_after
        self.persistent_rounds = max(1, int(persistent_rounds))
        # the sharded engine executes a K-round wave as K cohort dispatches
        # (DESIGN.md §11's documented fallback); the PLANNER owns that
        # clamp so ``persistent_waves`` telemetry counts only waves that
        # actually ran device-persistent, instead of the dispatch layer
        # silently unrolling K > 1 cohorts after they were counted
        self.sharded = sharded
        self._fragmented_rounds = 0
        self.last_plan: RoundPlan | None = None
        self.stats: dict[str, Any] = {
            "rounds": 0,
            "dispatches": 0,
            "full_fold_rounds": 0,
            "realignments": 0,
            "persistent_waves": 0,
            "burst_shapes": set(),
            "service_loads": None,
        }

    # -- bookkeeping hooks ---------------------------------------------------
    def note_burst(self, be: int) -> None:
        """Record a burst shape minted outside plan_round (staged paths)."""
        self.stats["burst_shapes"].add(be)

    def observe_service_loads(self, loads: Sequence[int]) -> None:
        """Serving-tier load snapshot (``ConsensusService.group_loads``) —
        introspection only; tiering uses per-wave queue depths so that the
        plan stays a pure function of the round's inputs."""
        self.stats["service_loads"] = list(loads)

    def report(self) -> dict[str, Any]:
        # Snapshot-copy every mutable value: a report is an observation,
        # not a window onto live planner state (callers mutating a report
        # must not perturb planning, and later observe_service_loads calls
        # must not rewrite already-returned reports).
        out = dict(self.stats)
        out["burst_shapes"] = sorted(self.stats["burst_shapes"])
        loads = self.stats["service_loads"]
        out["service_loads"] = None if loads is None else list(loads)
        out["fragmented_rounds"] = self._fragmented_rounds
        out["realign_after"] = self.realign_after
        return out

    def _wave_depth(
        self,
        burst: int,
        gids: Sequence[int],
        pending: Sequence[int] | None,
    ) -> int:
        """Persistent-wave depth K for one cohort (DESIGN.md §11).

        K > 1 only when the burst is the full batch — the wave's rounds are
        consecutive batch-sized queue slices, so numbering is identical to
        K single-round waves by construction — and every member has K full
        chunks queued.  Clamped by the ``persistent_rounds`` policy knob and
        by the ring (a wave may not lap itself: K * burst <= N).  On a
        sharded planner K is clamped to 1 up front: the wave would unroll
        into K cohort dispatches anyway (host-authoritative control scalars
        enter every dispatch), so minting K > 1 would only inflate the
        ``persistent_waves`` stat."""
        if (
            self.sharded
            or self.persistent_rounds <= 1
            or pending is None
            or burst != self.batch
        ):
            return 1
        k = min(pending[i] // burst for i in gids)
        k = min(k, self.persistent_rounds, self.n_instances // burst)
        return max(1, k)

    # -- the planner ---------------------------------------------------------
    def plan_round(
        self,
        loads: Sequence[int],
        marks: Sequence[int],
        live: Sequence[bool],
        crnd: Sequence[int],
        pending: Sequence[int] | None = None,
    ) -> RoundPlan:
        """Resolve one chunk wave: membership/frozen masking, the
        realignment sweep, and the hot->cold cohort tiering.

        ``loads`` are this wave's per-group chunk lengths; ``marks`` the
        host watermark mirrors; ``live`` membership; ``crnd`` the host
        round mirrors (``NO_ROUND`` = frozen under a software coordinator).
        ``pending`` gives per-group *total* queued lengths (first chunk
        included); when provided and ``persistent_rounds`` > 1, a cohort
        whose burst is the full batch and whose every member has K full
        batch-sized chunks queued is planned as a K-round persistent wave
        — burst quantization itself never changes, so engine-agnostic
        numbering is preserved round for round.
        """
        g = len(loads)
        enabled = tuple(
            loads[i] > 0 and bool(live[i]) and crnd[i] != NO_ROUND
            for i in range(g)
        )
        en_gids = [i for i in range(g) if enabled[i]]
        marks = list(marks)

        # A round is *fragmented* when it cannot run the highest-amortization
        # mapping: enabled watermarks spread over >1 class (fold breaks), OR
        # some enabled watermark off the full-batch block boundary (the
        # kernel window alignment a quantized sub-batch burst can cost —
        # engine-agnostic on purpose: the burn must fire identically on the
        # plain engine or backends' instance numbering would fork).
        bb = wire_block(self.batch)
        classes = {marks[i] for i in en_gids}
        fragmented = len(classes) > 1 or any(
            marks[i] % bb for i in en_gids
        )
        if fragmented:
            self._fragmented_rounds += 1
        elif en_gids:
            self._fragmented_rounds = 0

        realign: list[tuple[int, int]] = []
        if (
            self.realign_after is not None
            and fragmented
            and self._fragmented_rounds >= self.realign_after
        ):
            # burn every straggling enabled group forward to one common
            # block boundary: the skipped instances are never proposed and
            # are recoverable as no-ops (paper §3.1), and the full-width
            # folded block-aligned mapping re-engages on the next dispatch
            target = -(-max(classes) // bb) * bb
            for i in en_gids:
                if marks[i] != target:
                    realign.append((i, target))
                    marks[i] = target
            self._fragmented_rounds = 0
            self.stats["realignments"] += 1

        tiers: dict[int, list[int]] = {}
        for i in en_gids:
            be = quantize_burst(loads[i], self.batch)
            tiers.setdefault(be, []).append(i)
            self.stats["burst_shapes"].add(be)
        cohorts = tuple(
            Cohort(
                gids=tuple(gids),
                burst=be,
                rounds=self._wave_depth(be, gids, pending),
            )
            for be, gids in sorted(tiers.items(), reverse=True)
        )
        if any(c.rounds > 1 for c in cohorts):
            self.stats["persistent_waves"] += 1
        fragmentation = len({marks[i] for i in en_gids})
        plan = RoundPlan(
            cohorts=cohorts,
            enabled=enabled,
            realign=tuple(realign),
            fragmentation=fragmentation,
            full_fold=len(cohorts) == 1 and fragmentation == 1,
        )
        self.stats["rounds"] += 1
        self.stats["dispatches"] += len(cohorts)
        if plan.full_fold:
            self.stats["full_fold_rounds"] += 1
        self.last_plan = plan
        return plan
