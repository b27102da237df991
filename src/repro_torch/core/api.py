"""The drop-in CAANS application API (paper Fig. 4).

    submit(ctx, value, size)             -> propose a value
    ctx.deliver = cb(value, size, inst)  (registered callback)
    recover(ctx, inst, nop, size)        -> learn a previously decided instance

The PyTorch counterpart of ``repro.core.api``.  A ``PaxosContext`` wires
software proposers and learners to the device dataplane: the coordinator,
the acceptor array and the learner's dedup ring, resident on one device,
for one Paxos group (``HardwareDataplane``) or for G groups that share one
fused dispatch per cohort (``MultiGroupDataplane``, ``PaxosConfig(n_groups=G)``),
whose slabs may partition over the shards of a ``groups`` mesh
(``ShardedMultiGroupDataplane``, ``mesh=launch.mesh.make_group_mesh(...)``).
Messages between the host roles travel over the fault-injected ``SimNet``;
retransmission on timeout and duplicate suppression at the learners
implement the paper's §3.1 failure-handling contract.

Everything runs on the card unless the caller asks for another device
(``device="cpu"``).  With ``use_kernels`` (the default here; the reference
defaults to ``False``) the dataplane runs the hand-written kernels on the
card and their plain versions on the CPU: the round kernel on the fused
wire path, the sequencer and the acceptor array's vote on the staged path
(the default, ``fused=False``), and the round kernel in its multi-group and
cohort forms for every single-round dispatch of a grouped context, and its
persistent K-round form K5 for every wave.
``use_kernels=False`` selects the plain engine on any device.

A grouped context runs at the reference's defaults: a cohort whose members
all have K >= 2 full batches queued rides one persistent wave of K rounds
(``PaxosConfig.persistent_rounds``, 8 by default; K5 on the card), and the
async pump defers each dispatch's read-back through pinned host memory until
the next one is in flight (``PaxosConfig.async_pump``).

A sharded context (``mesh=``) runs every packed cohort dispatch on the
packed shard round kernel K6 and every full-width one on the round kernel's
shard slice, shard by shard.  It plans no persistent waves (the reference's
planner clamp: its dataplane would run a K-round wave as K single-round
dispatches).  ``migrate_group`` moves a tenant's slab between shards.  Each
shard keeps its slab on its own device of the mesh (``mesh.devices[s]``),
and one controller, this process, drives them all.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
from collections.abc import Callable, Sequence
from typing import Any

import numpy as np
import torch

from ..analysis.contracts import mirror_guard
from ..kernels import ops as kops
from . import batched
from . import plan as plan_mod
from .device import resolve_device
from .network import SimNet
from .paxos import Coordinator as SoftCoordinator
from .plan import NO_ROUND, NOP_SENTINEL
from .snapshot import GroupSnapshot, RingReclamationMixin, SnapshotStore
from .types import (
    I32,
    MSG_NOP,
    MSG_P1A,
    MSG_P1B,
    MSG_P2A,
    MSG_P2B,
    AcceptorState,
    CoordinatorState,
    MsgBatch,
    PaxosConfig,
)

INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class _Pending:
    payload: bytes
    age: int = 0
    group: int = 0


class HardwareDataplane(RingReclamationMixin):
    """The coordinator, the acceptor array and the learner dedup memory,
    resident on one device.

    * ``pipeline()`` is the fused wire path: one Phase-2 round (sequence,
      all-A vote, quorum, ring dedup) as one program, the round kernel when
      ``use_kernels`` (``kernels.ops.fused_round``) and the plain engine
      (``batched.fused_round``) otherwise.  State stays resident and is
      updated in place.
    * ``sequence()``/``vote()``/``prepare()`` are the staged path, used when
      votes must surface as messages: the default ``fused=False`` context,
      recovery, and the software coordinator after a failover.  When
      ``use_kernels``, ``sequence()`` runs the sequencer kernel
      (``kernels.ops.coordinator_sequence``) and ``vote()`` the acceptor
      array's vote kernel (``kernels.ops.acceptor_phase2_all``) on the card,
      for every Phase-2 batch: the vote kernel addresses each lane's own
      ring slot, so any window base runs on it.  ``prepare()`` (Phase 1)
      runs the plain engine, as in the reference, which has no Phase-1
      kernel.
    """

    def __init__(
        self,
        cfg: PaxosConfig,
        use_kernels: bool = True,
        device: torch.device | str | None = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        self.cstate = CoordinatorState.init(device=dev)
        self.stack = AcceptorState.init(
            cfg.n_instances, cfg.value_words, dev, n_acceptors=cfg.n_acceptors
        )
        self.lstate = batched.LearnerState.init(cfg.n_instances, cfg.value_words, dev)
        self.alive = [True] * cfg.n_acceptors  # host mirror (introspection)
        self.alive_mask = torch.ones((cfg.n_acceptors,), dtype=torch.bool, device=dev)
        self.use_kernels = use_kernels
        # host mirror of the sequencer watermark: the reclamation guard and
        # the snapshot drain read it without a device sync
        self._next_inst_host = 0
        # monotone count of device programs dispatched
        self.dispatch_count = 0
        eng = kops if use_kernels else batched
        self._fused = eng.fused_round
        self._seq = eng.coordinator_sequence
        self._vote_all = eng.acceptor_phase2_all

    # -- ring reclamation: RingReclamationMixin at G == 1 ---------------------
    def _seq_marks(self) -> list[int]:
        return [self._next_inst_host]

    @property
    def reclaimed_host(self) -> int | None:
        """The reclamation watermark (None while reclamation is disabled)."""
        marks = self._reclaim_marks
        return None if marks is None else marks[0]

    def set_reclaimed(self, upto: int) -> None:
        """Advance the reclamation watermark: instances below ``upto`` have
        been drained to a snapshot and their ring slots may be re-used."""
        self._reclaim_set(0, upto)

    def _guard_capacity(self, base: int, b: int) -> None:
        self._reclaim_guard(0, base, b)

    # -- fused fast path: the whole Phase-2 round in one device program ------
    @mirror_guard
    def pipeline(self, values: np.ndarray, active: np.ndarray):
        """One dispatch: sequence + all acceptor votes + quorum + dedup.
        Returns host ``(fresh, inst, value)``, ``fresh`` masking the
        non-duplicate deliveries."""
        b = values.shape[0]
        self._guard_capacity(self._next_inst_host, b)
        limit = None
        if self.reclaimed_host is not None:
            limit = self.reclaimed_host + self.cfg.n_instances
            if limit > INT32_MAX:
                # the reference raises here too (at its int32 conversion),
                # before any state or counter moves; a wrapped limit would
                # refuse every lane in silence
                raise OverflowError(
                    f"reclaim limit {limit} (watermark {self.reclaimed_host} + "
                    f"N={self.cfg.n_instances}) is past int32 max"
                )
        dev = self.device
        self.dispatch_count += 1
        self.cstate, self.stack, self.lstate, fresh, inst, _win, value = self._fused(
            self.cstate,
            self.stack,
            self.lstate,
            torch.from_numpy(np.ascontiguousarray(values, np.int32)).to(dev),
            torch.from_numpy(np.asarray(active, bool)).to(dev),
            self.alive_mask,
            self.cfg.quorum,
            limit,
        )
        self._next_inst_host += b
        return fresh.cpu().numpy(), inst.cpu().numpy(), value.cpu().numpy()

    def kill_acceptor(self, aid: int) -> None:
        self.alive[aid] = False
        self.alive_mask[aid] = False

    def revive_acceptor(self, aid: int) -> None:
        self.alive[aid] = True
        self.alive_mask[aid] = True

    def wipe_acceptor(self, aid: int) -> None:
        """Model a crash WITH state loss: reset the acceptor's register file
        (its BRAM) in place, unlike ``kill_acceptor``, which freezes it
        intact.  ``core.failover.restore_acceptor`` rebuilds it."""
        self.stack.rnd[aid] = 0
        self.stack.vrnd[aid] = NO_ROUND
        self.stack.value[aid] = 0

    # -- staged path (votes surface as messages) -----------------------------
    @mirror_guard
    def sequence(self, values: np.ndarray, active: np.ndarray) -> MsgBatch:
        """Bind a burst to the next instance window, one dispatch."""
        self._guard_capacity(self._next_inst_host, values.shape[0])
        self.dispatch_count += 1
        self.cstate, p2a = self._seq(
            self.cstate,
            torch.from_numpy(np.ascontiguousarray(values, np.int32)).to(self.device),
            torch.from_numpy(np.asarray(active, bool)).to(self.device),
        )
        self._next_inst_host += values.shape[0]
        return p2a

    def vote(self, p2a: MsgBatch) -> list[MsgBatch | None]:
        """Phase-2 vote of the whole acceptor array, one dispatch, for any
        batch whose lanes address distinct ring slots: sequenced bursts,
        software-coordinator batches, recovery and takeover windows.  Dead
        acceptors come back as ``None``: their votes are never sent."""
        self.dispatch_count += 1
        self.stack, votes = self._vote_all(self.stack, p2a, self.alive_mask)
        return self._split(votes)

    def prepare(self, p1a: MsgBatch) -> list[MsgBatch | None]:
        self.dispatch_count += 1
        self.stack, outs = batched.acceptor_phase1_all(self.stack, p1a, self.alive_mask)
        return self._split(outs)

    def _split(self, stacked: MsgBatch) -> list[MsgBatch | None]:
        """Stacked [A, ...] message batches -> per-acceptor list, None when
        dead (a crashed switch emits nothing)."""
        return [
            MsgBatch(*(x[aid] for x in stacked.tensors())) if self.alive[aid] else None
            for aid in range(self.cfg.n_acceptors)
        ]


class _DeferredRound:
    """Handle for a dispatched cohort round or wave whose host read-back is
    deferred: ``resolve()`` gives the host results and selects the cohort's
    rows (on axis 0 of a round's ``(C, B)`` outputs, axis 1 of a wave's
    ``(K, C, B)``).  The pump dispatches wave N+1 before it resolves wave N;
    the host watermark mirrors advanced at dispatch time, so planning never
    waits on a resolve.

    On the card the read-back is enqueued at once, on the launch's stream:
    ``fresh`` and ``value`` are copied without blocking into pinned host
    buffers of this handle, and an event marks the copies' end, which
    ``resolve()`` waits for.  One stream orders the next dispatch's in-place
    writes after this copy.  On the CPU the outputs are host tensors
    already."""

    def __init__(
        self, fresh, value, inst: np.ndarray, rows: Sequence[int] | None, axis: int = 0
    ):
        self._inst = inst  # host instance windows, already in cohort order
        # the cohort's rows of fresh and value (None: all, in order)
        self._rows = None if rows is None else list(rows)
        self._axis = axis
        self._done: torch.cuda.Event | None = None
        if fresh.device.type != "cuda":
            self._fresh, self._value = fresh, value
            return
        with torch.cuda.device(fresh.device):
            self._fresh = torch.empty(fresh.shape, dtype=fresh.dtype, pin_memory=True)
            self._value = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            self._fresh.copy_(fresh, non_blocking=True)
            self._value.copy_(value, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()

    @classmethod
    def resolved(cls, fresh: np.ndarray, value: np.ndarray, inst: np.ndarray) -> _DeferredRound:
        """A result already read back to the host, in the handle's interface
        (the sharded dataplane reads back at dispatch, as the reference's)."""
        return cls(torch.from_numpy(fresh), torch.from_numpy(value), inst, rows=None)

    def resolve(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._done is not None:
            self._done.synchronize()
        fresh, value = self._fresh.numpy(), self._value.numpy()
        if self._rows is not None:
            fresh = np.take(fresh, self._rows, axis=self._axis)
            value = np.take(value, self._rows, axis=self._axis)
        return fresh, self._inst, value


class _GroupView:
    """The staged single-group surface over one group's rows of the
    ``(G, A, N)`` slabs: the ``prepare``/``vote``/``cfg``/``device`` that
    ``core.failover`` and recovery expect from a ``HardwareDataplane``.  It
    reads and writes only group ``gid``'s rows, through contiguous row views
    updated in place; no other group's registers are touched.  With
    ``use_kernels`` on the card ``vote()`` runs the acceptor array's vote
    kernel on those views; ``prepare()`` (Phase 1) runs the plain engine.
    Recovery and failover traffic only."""

    def __init__(self, mg: MultiGroupDataplane, gid: int):
        self.mg = mg
        self.gid = gid

    @property
    def cfg(self) -> PaxosConfig:
        return self.mg.cfg

    @property
    def device(self) -> torch.device:
        """The device of the group's slab: its shard's on a sharded
        dataplane."""
        return self.mg.device_of(self.gid)

    def _rows(self) -> tuple[AcceptorState, torch.Tensor]:
        mg = self.mg
        stack, _ = mg._rows(self.gid)
        # the slabs are slot-indexed, the liveness mask gid-indexed (a host
        # array on the sharded dataplane)
        alive = mg.alive_mask[self.gid]
        if not isinstance(alive, torch.Tensor):
            alive = torch.from_numpy(alive != 0).to(self.device)
        return stack, alive

    def vote(self, p2a: MsgBatch) -> list[MsgBatch | None]:
        stack, alive = self._rows()
        self.mg.dispatch_count += 1
        _, votes = self.mg._vote_all(stack, p2a, alive)
        return self._split(votes)

    def prepare(self, p1a: MsgBatch) -> list[MsgBatch | None]:
        stack, alive = self._rows()
        self.mg.dispatch_count += 1
        _, outs = batched.acceptor_phase1_all(stack, p1a, alive)
        return self._split(outs)

    def _split(self, stacked: MsgBatch) -> list[MsgBatch | None]:
        alive = self.mg.alive[self.gid]
        return [
            MsgBatch(*(x[aid] for x in stacked.tensors()), gid=self.gid) if alive[aid] else None
            for aid in range(self.cfg.n_acceptors)
        ]


class MultiGroupDataplane(RingReclamationMixin):
    """G device-resident Paxos groups sharing one fused dispatch per cohort:
    consensus as a service.

    State is the single-group layout grown a leading group axis: ``(G,)``
    coordinator watermarks and rounds, ``(G, A, N)`` acceptor rings,
    ``(G, N)`` learner rings and a ``(G, A)`` liveness mask, all updated in
    place.  ``pipeline`` advances every enabled group one Phase-2 round,
    ``pipeline_cohort`` the groups of one cohort and ``pipeline_persistent``
    one cohort K rounds; with ``use_kernels`` they run the round kernel
    (``kernels.ops.multigroup_fused_round``, ``kernels.ops.cohort_fused_round``)
    or its persistent form (``kernels.ops.persistent_cohort_rounds``) on the
    card and the plain versions on the CPU, at any window base.
    ``use_kernels=False`` runs the plain engine, full width, with
    non-members held inert.  The fold width the
    reference kernel would use (``last_gb``), ``dispatch_count`` and the
    planner's decisions do not depend on the engine.

    Per-group failover: ``freeze_group`` parks a group's round at NO_ROUND,
    so the shared dispatch decides nothing for it, and ``restore_group``
    hands it back at the software coordinator's watermark.  ``group_view``
    is one group's staged surface for recovery and takeover.

    Membership: ``cfg.n_groups`` is a capacity; a host free-list over the
    group axis lets tenants come and go (``create_group``, ``adopt_group``,
    ``retire_group``) without touching any other group's slab rows.
    """

    def __init__(
        self,
        cfg: PaxosConfig,
        use_kernels: bool = True,
        device: torch.device | str | None = None,
    ):
        if cfg.n_groups < 1:
            raise ValueError(f"n_groups must be >= 1, got {cfg.n_groups}")
        self.cfg = cfg
        self.device = resolve_device(device)
        g, a = cfg.n_groups, cfg.n_acceptors
        self._init_state()
        self.alive = [[True] * a for _ in range(g)]  # host mirror
        # membership: every slot starts live; the free-list (sorted, lowest
        # first: deterministic allocation) holds vacant slots
        self.live_host: list[bool] = [True] * g
        self._free: list[int] = []
        self.use_kernels = use_kernels
        # host mirrors of each group's watermark and round: the plan, the
        # reclamation guard and the drains read them without a device sync
        self.next_inst_host: list[int] = [0] * g
        self.crnd_host: list[int] = [0] * g
        self.dispatch_count = 0  # monotone count of device programs
        self.last_gb: int | None = None  # fold width of the last dispatch
        self._vote_all = (kops if use_kernels else batched).acceptor_phase2_all

    def _init_state(self) -> None:
        """The device state: ``(G,)`` watermarks and rounds, the slot-indexed
        ``(G, ...)`` slabs and the ``(G, A)`` liveness mask."""
        g, a = self.cfg.n_groups, self.cfg.n_acceptors
        self.cstate, self.stack, self.lstate = batched.init_multigroup_state(
            g, a, self.cfg.n_instances, self.cfg.value_words, self.device
        )
        self.alive_mask = torch.ones((g, a), dtype=torch.bool, device=self.device)

    # -- ring reclamation: RingReclamationMixin per group --------------------
    def _seq_marks(self) -> list[int]:
        return self.next_inst_host

    @property
    def reclaimed_host(self) -> list[int] | None:
        """Per-group reclamation watermarks (None while disabled); the list
        is the mixin's live state."""
        return self._reclaim_marks

    def set_reclaimed(self, gid: int, upto: int) -> None:
        """Advance group ``gid``'s reclamation watermark after a snapshot
        drain of the instances below ``upto``."""
        self._check_gid(gid)
        self._reclaim_set(gid, upto)

    def _guard_capacity(self, gids, b: int) -> None:
        for gid in gids:
            self._reclaim_guard(gid, self.next_inst_host[gid], b)

    # -- the shared pre-dispatch plan ------------------------------------------
    def _fold_width(self) -> int:
        return self.cfg.n_groups

    def _plan_round(self, b: int, enabled: list[bool] | None):
        """Resolve the enabled mask against membership and frozen rounds and
        pick the fold width (``plan.fold_width_full``).  Returns
        ``(enabled, use_k, group_block)``; ``use_k`` is ``use_kernels``:
        the round kernel takes any window base."""
        live, crnd = self.live_host, self.crnd_host
        if enabled is None:
            enabled = [lv and c != NO_ROUND for lv, c in zip(live, crnd, strict=True)]
        else:
            enabled = [
                bool(e) and lv and c != NO_ROUND
                for e, lv, c in zip(enabled, live, crnd, strict=True)
            ]
        en_gids = [i for i, e in enumerate(enabled) if e]
        gb = plan_mod.fold_width_full(en_gids, self.next_inst_host, self._fold_width())
        return enabled, self.use_kernels, gb

    def _check_fold(self, gids: Sequence[int], gb: int) -> None:
        """The reference kernel's fold precondition, from the host mirrors:
        the enabled members of each ``gb``-block share one watermark."""
        if not plan_mod._block_lockstep(gids, self.next_inst_host, gb):
            raise RuntimeError(f"groups {list(gids)} are not in lockstep at fold width {gb}")

    def _empty_round(self, g: int, b: int):
        """The all-disabled result: nothing would decide, no dispatch."""
        return (
            np.zeros((g, b), np.int32),
            np.zeros((g, b), np.int32),
            np.zeros((g, b, self.cfg.value_words), np.int32),
        )

    def _to_dev(self, x: np.ndarray, dtype=np.int32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(self.device)

    # -- fused fast path: all groups advance one round in one dispatch ------
    @mirror_guard
    def pipeline(self, values: np.ndarray, active: np.ndarray, enabled: list[bool] | None = None):
        """One dispatch for all G groups.  ``values`` is ``(G, B, V)``,
        ``active`` ``(G, B)``.  A disabled group (frozen, vacant, or masked
        by ``enabled``) rides inert: presented at NO_ROUND, its watermark
        unmoved.  Returns host ``(fresh, inst, value)`` with a leading group
        axis."""
        g, b = values.shape[0], values.shape[1]
        enabled, use_k, gb = self._plan_round(b, enabled)
        if not any(enabled):
            return self._empty_round(g, b)
        en_gids = [gid for gid in range(g) if enabled[gid]]
        self._guard_capacity(en_gids, b)
        lim = self._reclaim_limits_np()
        en = self._to_dev(np.asarray(enabled), bool)
        cs = self.cstate
        vals, act = self._to_dev(values), self._to_dev(active, bool)
        self.dispatch_count += 1
        if use_k:
            self._check_fold(en_gids, gb)
            new_c, self.stack, self.lstate, fresh, inst, _win, value = kops.multigroup_fused_round(
                cs, self.stack, self.lstate, vals, act, self.alive_mask, self.cfg.quorum,
                en.to(torch.int32), lim, group_block=gb,
            )  # fmt: skip
        else:
            eff = CoordinatorState(next_inst=cs.next_inst, crnd=torch.where(en, cs.crnd, NO_ROUND))
            new_c, self.stack, self.lstate, fresh, inst, _win, value = (
                batched.multigroup_fused_round(
                    eff, self.stack, self.lstate, vals, act, self.alive_mask, self.cfg.quorum,
                    reclaim_limit=lim,
                )
            )  # fmt: skip
        # disabled groups keep their watermark and their true round
        self.cstate = CoordinatorState(
            next_inst=torch.where(en, new_c.next_inst, cs.next_inst), crnd=cs.crnd
        )
        for gid in en_gids:
            self.next_inst_host[gid] += b
        self.last_gb = gb  # the plan's fold width, whatever the engine
        return fresh.cpu().numpy(), inst.cpu().numpy(), value.cpu().numpy()

    # -- cohort dispatch: one tier of a RoundPlan ------------------------------
    def _cohort_prologue(self, gids, values: np.ndarray):
        """Membership mask and per-member instance windows of a cohort."""
        gids = list(gids)
        be = values.shape[1]
        if values.shape[0] != len(gids):
            raise ValueError(f"{values.shape[0]} burst rows for cohort {gids}")
        marks = self.next_inst_host
        member = np.zeros((self.cfg.n_groups,), np.int32)
        member[gids] = 1
        inst = np.stack([np.arange(marks[gid], marks[gid] + be, dtype=np.int32) for gid in gids])
        return gids, member, self.use_kernels, inst

    @mirror_guard
    def pipeline_cohort(self, gids, values: np.ndarray, active: np.ndarray, defer: bool = False):
        """Advance exactly the cohort ``gids`` one ``BE``-sized round.

        ``values`` is compact ``(len(gids), BE, V)`` in cohort order,
        ``active`` ``(len(gids), BE)``.  Non-members neither move nor
        change.  With ``use_kernels`` the round kernel visits only the group
        blocks holding members (``plan.cohort_blocks``).  Returns host
        ``(fresh, inst, value)`` in cohort row order, or with ``defer=True``
        a ``_DeferredRound`` whose ``resolve()`` gives the same; the host
        watermark mirrors advance at dispatch time either way."""
        gids, member, use_k, inst = self._cohort_prologue(gids, values)
        g, v = self.cfg.n_groups, self.cfg.value_words
        be = values.shape[1]
        self._guard_capacity(gids, be)
        lim = self._reclaim_limits_np()
        # the compact mapping is the dispatch plan whichever engine runs it
        gb, blocks = plan_mod.cohort_blocks(gids, self.next_inst_host, self._fold_width())
        self.last_gb = gb
        self.dispatch_count += 1
        en = self._to_dev(member)
        if use_k:
            self._check_fold(gids, gb)
            # compact layout: row j*gb + k <-> group blocks[j]*gb + k
            rowof = {blk * gb + k: j * gb + k for j, blk in enumerate(blocks) for k in range(gb)}
            kvals = np.zeros((len(blocks) * gb, be, v), np.int32)
            kvals[:, :, 0] = NOP_SENTINEL
            for row, gid in enumerate(gids):
                kvals[rowof[gid]] = values[row]
            self.stack, self.lstate, dfresh, _win, dvalue = kops.cohort_fused_round(
                self.stack, self.lstate, blocks, self.cstate.next_inst, self.cstate.crnd,
                self.alive_mask, self.cfg.quorum, self._to_dev(kvals), en, lim, group_block=gb,
            )  # fmt: skip
            rows = [rowof[gid] for gid in gids]
        else:
            # plain engine: full width, non-members presented at NO_ROUND
            vals_f, act_f = plan_mod.scatter_rows(gids, values, active, g, v)
            cs = self.cstate
            eff = CoordinatorState(
                next_inst=cs.next_inst, crnd=torch.where(en != 0, cs.crnd, NO_ROUND)
            )
            _c, self.stack, self.lstate, dfresh, _i, _w, dvalue = batched.multigroup_fused_round(
                eff, self.stack, self.lstate, self._to_dev(vals_f), self._to_dev(act_f, bool),
                self.alive_mask, self.cfg.quorum, reclaim_limit=lim,
            )  # fmt: skip
            rows = gids
        self.cstate = CoordinatorState(
            next_inst=self.cstate.next_inst + en * be, crnd=self.cstate.crnd
        )
        for gid in gids:
            self.next_inst_host[gid] += be
        handle = _DeferredRound(dfresh, dvalue, inst, rows=rows)
        return handle if defer else handle.resolve()

    def _wave_block(self, be: int, bases) -> int:
        """Batch block of a persistent wave, the reference's choice: one
        block per round (``be``) when the ring and every member's base are
        ``be``-aligned (each round then advances by ``be``), else the wire
        block.  K5's wrapper checks it as the reference does; no result and
        no launch depends on it."""
        if self.cfg.n_instances % be == 0 and all(base % be == 0 for base in bases):
            return be
        return plan_mod.wire_block(be)

    @mirror_guard
    def pipeline_persistent(self, gids, values: np.ndarray, active: np.ndarray, defer=False):
        """Advance the cohort ``gids`` K back-to-back full rounds in one
        dispatch: the persistent wave.  ``values`` is ``(K, len(gids), BE,
        V)``, round-major in cohort order, ``active`` ``(K, len(gids),
        BE)``.  Every member takes part in every round, each round's window
        is the next ``BE`` instances of each member, and the result equals
        K sequential ``pipeline_cohort`` calls.  With ``use_kernels`` the
        wave runs K5 (``kernels.ops.persistent_cohort_rounds``), driven by
        the descriptor ``wni``/``wen`` built from the host mirrors; else the
        plain K-round program at full width.  A wave whose last window would
        pass a member's reclaim limit raises before anything moves.  Returns
        host ``(fresh[K, M, BE], inst[K, M, BE], value[K, M, BE, V])``, or
        with ``defer=True`` a ``_DeferredRound`` that gives the same."""
        k, be = values.shape[0], values.shape[2]
        if k * be > self.cfg.n_instances:
            raise ValueError(
                f"persistent wave of {k} x {be} instances would lap the "
                f"{self.cfg.n_instances}-instance ring"
            )
        gids, member, use_k, _inst0 = self._cohort_prologue(gids, values[0])
        g, v = self.cfg.n_groups, self.cfg.value_words
        marks = self.next_inst_host
        # guard the wave's last window up front: a wave past the limit
        # fails before any state or counter moves, never mid-wave
        for gid in gids:
            self._reclaim_guard(gid, marks[gid] + (k - 1) * be, be)
        lim = self._reclaim_limits_np()
        gb, blocks = plan_mod.cohort_blocks(gids, marks, self._fold_width())
        self.last_gb = gb
        self.dispatch_count += 1
        # the wave descriptor: each member's window base per round (numpy
        # int32, so a window past 2**31 wraps as the reference's does) and
        # its participation; non-members' rows stay 0, inert
        wni = np.zeros((k, g), np.int32)
        wen = np.zeros((k, g), np.int32)
        steps = np.arange(k, dtype=np.int32) * be
        for gid in gids:
            wni[:, gid] = marks[gid] + steps
            wen[:, gid] = 1
        inst = np.stack(
            [np.stack([np.arange(w, w + be, dtype=np.int32) for w in wni[r, gids]])
             for r in range(k)]
        )  # fmt: skip
        if use_k:
            self._check_fold(gids, gb)
            rowof = {blk * gb + j: i * gb + j for i, blk in enumerate(blocks) for j in range(gb)}
            kvals = np.zeros((k, len(blocks) * gb, be, v), np.int32)
            kvals[..., 0] = NOP_SENTINEL
            for row, gid in enumerate(gids):
                kvals[:, rowof[gid]] = values[:, row]
            self.stack, self.lstate, dfresh, _win, dvalue = kops.persistent_cohort_rounds(
                self.stack, self.lstate, blocks, wni, wen, self.cstate.crnd, self.alive_mask,
                self.cfg.quorum, self._to_dev(kvals), lim, group_block=gb,
                block_b=self._wave_block(be, [marks[gid] for gid in gids]),
            )  # fmt: skip
            rows = [rowof[gid] for gid in gids]
        else:
            # plain engine: full width per round, K rounds in one program
            per_round = [plan_mod.scatter_rows(gids, values[r], active[r], g, v) for r in range(k)]
            vals_f = np.stack([x for x, _ in per_round])
            act_f = np.stack([a for _, a in per_round])
            _c, self.stack, self.lstate, dfresh, _i, _w, dvalue = (
                batched.persistent_multigroup_rounds(
                    self.cstate, self.stack, self.lstate, self._to_dev(vals_f),
                    self._to_dev(act_f, bool), self.alive_mask, self.cfg.quorum,
                    enabled_rounds=wen != 0, reclaim_limit=lim,
                )
            )  # fmt: skip
            rows = gids
        en = self._to_dev(member)
        self.cstate = CoordinatorState(
            next_inst=self.cstate.next_inst + en * (k * be), crnd=self.cstate.crnd
        )
        for gid in gids:
            self.next_inst_host[gid] += k * be
        handle = _DeferredRound(dfresh, dvalue, inst, rows=rows, axis=1)
        return handle if defer else handle.resolve()

    @mirror_guard
    def burn_forward(self, gid: int, target: int) -> None:
        """Advance a group's watermark to ``target`` without proposing
        anything: the skipped instances are NOP holes, never decided and
        recoverable as no-ops (paper §3.1 gap fill).  The planner's
        realignment sweep uses it."""
        self._check_gid(gid)
        if target < self.next_inst_host[gid]:
            raise ValueError(
                f"burn_forward moves only forward: {target} < "
                f"{self.next_inst_host[gid]} (group {gid})"
            )
        self.cstate.next_inst[gid] = target
        self.next_inst_host[gid] = target

    # -- per-group liveness and failover -------------------------------------
    def _check_gid(self, gid: int) -> None:
        if not 0 <= gid < self.cfg.n_groups:
            raise ValueError(f"group {gid} out of range [0, {self.cfg.n_groups})")

    def kill_acceptor(self, gid: int, aid: int) -> None:
        self._check_gid(gid)
        self.alive[gid][aid] = False
        self.alive_mask[gid, aid] = False

    def revive_acceptor(self, gid: int, aid: int) -> None:
        self._check_gid(gid)
        self.alive[gid][aid] = True
        self.alive_mask[gid, aid] = True

    def wipe_acceptor(self, gid: int, aid: int) -> None:
        """Crash with state loss: reset one acceptor's registers of one
        group in place; ``core.failover.restore_acceptor`` rebuilds them."""
        self._check_gid(gid)
        stack, _ = self._rows(gid)
        stack.rnd[aid] = 0
        stack.vrnd[aid] = NO_ROUND
        stack.value[aid] = 0

    @mirror_guard
    def freeze_group(self, gid: int) -> None:
        """Park a group's hardware round at NO_ROUND while a software
        coordinator owns it: the shared dispatch decides nothing for it."""
        self._check_gid(gid)
        self.cstate.crnd[gid] = NO_ROUND
        self.crnd_host[gid] = NO_ROUND

    @mirror_guard
    def restore_group(self, gid: int, next_inst: int, crnd: int) -> None:
        """Hand a group back to the hardware sequencer at the watermark and
        round the software coordinator reached.  With ``use_kernels`` the
        watermark is burned forward to the reference kernel's block
        boundary, as the reference does: the round kernel here needs no
        alignment, but instance numbers must match the reference's."""
        self._check_gid(gid)
        if self.use_kernels:
            bb = plan_mod.wire_block(self.cfg.batch)
            next_inst = -(-next_inst // bb) * bb
        self.cstate.next_inst[gid] = next_inst
        self.cstate.crnd[gid] = crnd
        self.next_inst_host[gid] = next_inst
        self.crnd_host[gid] = crnd

    def group_view(self, gid: int) -> _GroupView:
        """One group's staged surface (recovery and takeover traffic)."""
        self._check_gid(gid)
        return _GroupView(self, gid)

    # -- membership: a free-list over the group axis --------------------------
    def _check_live(self, gid: int) -> None:
        self._check_gid(gid)
        if not self.live_host[gid]:
            raise ValueError(f"group {gid} is retired")

    def live_groups(self) -> list[int]:
        """Live group ids, ascending (the routing domain)."""
        return [g for g in range(self.cfg.n_groups) if self.live_host[g]]

    def _slab_row(self, gid: int) -> int:
        """Slab row of group ``gid``: the identity here; the sharded
        dataplane translates through its placement."""
        return gid

    def _rows(self, gid: int) -> tuple[AcceptorState, batched.LearnerState]:
        """Group ``gid``'s rows of the slabs, ``(A, N[, V])`` and ``(N[,
        V])`` views on ``device_of(gid)``: every read or write of one
        group's registers goes through them."""
        row = self._slab_row(gid)
        return (
            AcceptorState(*(x[row] for x in vars(self.stack).values())),
            batched.LearnerState(*(x[row] for x in vars(self.lstate).values())),
        )

    def device_of(self, gid: int) -> torch.device:
        """The device that holds group ``gid``'s slab rows."""
        return self.device

    def _reset_group_slab(self, gid: int) -> None:
        """Reset one group's acceptor and learner rows to a fresh tenant's."""
        stack, lstate = self._rows(gid)
        stack.rnd.fill_(0)
        stack.vrnd.fill_(NO_ROUND)
        stack.value.fill_(0)
        lstate.delivered.fill_(0)
        lstate.inst.fill_(-1)
        lstate.value.fill_(0)

    @mirror_guard
    def create_group(self) -> int:
        """Claim the lowest free slot: fresh rings, watermark and round 0,
        every acceptor alive.  Raises at capacity."""
        if not self._free:
            raise RuntimeError(f"no free group slots (capacity n_groups={self.cfg.n_groups})")
        gid = self._free.pop(0)
        self._reset_group_slab(gid)
        self.live_host[gid] = True
        for aid in range(self.cfg.n_acceptors):
            self.revive_acceptor(gid, aid)
        self.restore_group(gid, 0, 0)
        if self.reclaimed_host is not None:
            self.reclaimed_host[gid] = 0
        return gid

    @mirror_guard
    def adopt_group(self, watermark: int) -> int:
        """Claim a free slot for a tenant bootstrapping from a transferred
        snapshot: sequencer and reclamation watermarks start at the
        snapshot's (the sequencer's realigned forward under ``use_kernels``,
        as in ``restore_group``).  Requires reclamation.  Returns the gid."""
        if self.reclaimed_host is None:
            raise ValueError("adopt_group requires reclamation enabled")
        if watermark < 0:
            raise ValueError(f"negative snapshot watermark {watermark}")
        gid = self.create_group()
        self.restore_group(gid, watermark, 0)
        self.reclaimed_host[gid] = watermark
        return gid

    def retire_group(self, gid: int) -> list[tuple[int, bytes]]:
        """Retire a live group: drain its learner ring to host ``(inst,
        value_bytes)`` pairs in instance order, park its round at NO_ROUND
        and free its slot.  No slab row moves; the slot is reset at the
        next ``create_group``."""
        self._check_live(gid)
        ld, li, lv = (x.cpu().numpy() for x in vars(self._rows(gid)[1]).values())
        slots = np.nonzero(ld != 0)[0]
        order = slots[np.argsort(li[slots], kind="stable")]
        drained = [(int(li[s]), lv[s].tobytes()) for s in order]
        self.live_host[gid] = False
        self.freeze_group(gid)
        bisect.insort(self._free, gid)
        return drained


_PER_SHARD = (
    "a sharded dataplane keeps one slab per shard (stacks[s], lstates[s]): read or write "
    "a group's rows through _rows(gid), read the whole through gather()"
)


def _same_device(asked: torch.device, home: torch.device) -> bool:
    """A caller's ``asked`` device names the mesh's ``home`` device: an
    ``asked`` without an index (``"cuda"``) names any card, an index only
    its own card, and a mesh on the current card (no index) only ``"cuda"``."""
    return asked.type == home.type and (asked.index is None or asked.index == home.index)


def _i32(xs) -> np.ndarray:
    """Host marks as int32, wrapping past int32 max as the device's do."""
    return ((np.asarray(xs, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


class ShardedMultiGroupDataplane(MultiGroupDataplane):
    """``MultiGroupDataplane`` with the group axis partitioned over the
    shards of a ``groups`` mesh (``launch.mesh.GroupMesh``): shard ``s``
    owns slots ``[s*Gl, (s+1)*Gl)`` of the ``(G, A, N)`` acceptor rings and
    ``(G, N)`` learner rings, ``Gl = G / n_shards``, as a slab of its own on
    ``mesh.devices[s]``: ``stacks[s]`` and ``lstates[s]``, ``(Gl, ...)``.
    One controller, this process, drives them all: a dispatch launches each
    shard's body on its own slab and device, in shard order, and reads the
    outputs back after the last launch (``core.fabric``).  There is no
    ``(G, ...)`` tensor: ``stack`` and ``lstate`` raise, every row read or
    write goes through ``_rows``, and ``gather()`` reads the slabs back to
    the host in slot order.  The controller's own tensors (the snapshot
    seals) live on the home device ``device``, ``mesh.devices[0]``.

    Per-group control state, the watermark and round vectors (``cstate``)
    and the ``(G, A)`` liveness mask (``alive_mask``), is host-authoritative
    numpy and enters each dispatch replicated: ``freeze_group``,
    ``restore_group``, ``burn_forward`` and ``kill_acceptor`` change host
    scalars only, and the slabs never move for them.  With ``use_kernels``
    a packed cohort dispatch runs K6 and a full-width one K1's shard slice
    on the card, their plain versions on the CPU.

    Placement is a slot permutation (``plan.PlacementMap``), the identity at
    boot and changed only by ``migrate_group``.  The device slabs are
    slot-indexed and every host mirror gid-indexed: every row access goes
    through ``_slab_row``, and a dispatch translates once, at its boundary.
    """

    def __init__(
        self,
        cfg: PaxosConfig,
        mesh=None,
        axis: str = "groups",
        use_kernels: bool = True,
        device: torch.device | str | None = None,
    ):
        if mesh is None:
            from ..launch.mesh import make_group_mesh

            mesh = make_group_mesh(device=device)
        elif device is not None and not _same_device(resolve_device(device), mesh.device):
            raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no {axis!r} axis: {mesh.axis_names}")
        n_sh = mesh.shape[axis]
        if cfg.n_groups % n_sh:
            raise ValueError(
                f"n_groups={cfg.n_groups} must be divisible by the {axis!r} "
                f"mesh axis size {n_sh}"
            )
        self.mesh = mesh
        self.axis = axis
        self.n_shards = n_sh
        self.groups_per_shard = cfg.n_groups // n_sh
        super().__init__(cfg, use_kernels=use_kernels, device=mesh.device)
        self._dispatches: dict[tuple[bool, int], Any] = {}
        self._packed_dispatches: dict[bool, Any] = {}
        self._placement = plan_mod.PlacementMap.identity(cfg.n_groups, self.groups_per_shard)

    def _init_state(self) -> None:
        """Host-authoritative control state, the watermark and round vectors
        and the liveness mask, and one ``(Gl, ...)`` slab per shard on its
        device, each an allocation of its own."""
        g, a, gl = self.cfg.n_groups, self.cfg.n_acceptors, self.groups_per_shard
        self.cstate = CoordinatorState(
            next_inst=np.zeros((g,), np.int32), crnd=np.zeros((g,), np.int32)
        )
        self.alive_mask = np.ones((g, a), np.int32)
        slabs = [
            batched.init_multigroup_state(gl, a, self.cfg.n_instances, self.cfg.value_words, dev)
            for dev in self.mesh.devices
        ]
        self.stacks = tuple(st for _, st, _ in slabs)
        self.lstates = tuple(ls for _, _, ls in slabs)

    @property
    def stack(self):
        raise AttributeError(_PER_SHARD)

    @property
    def lstate(self):
        raise AttributeError(_PER_SHARD)

    def _rows(self, gid: int) -> tuple[AcceptorState, batched.LearnerState]:
        s, row = divmod(self._slab_row(gid), self.groups_per_shard)
        return (
            AcceptorState(*(x[row] for x in vars(self.stacks[s]).values())),
            batched.LearnerState(*(x[row] for x in vars(self.lstates[s]).values())),
        )

    def device_of(self, gid: int) -> torch.device:
        return self.mesh.devices[self.shard_of_group(gid)]

    def gather(self) -> dict[str, np.ndarray]:
        """The slabs read back to the host as ``(G, ...)`` numpy arrays in
        slot order, under ``core.bridge``'s names (``stack.rnd``, ...,
        ``lstate.value``): the reference's global arrays.  A copy: writes
        go through ``_rows``."""
        out = {}
        for name, parts in (("stack", self.stacks), ("lstate", self.lstates)):
            for field in vars(parts[0]):
                out[f"{name}.{field}"] = np.concatenate(
                    [getattr(p, field).cpu().numpy() for p in parts]
                )
        return out

    def scatter(self, arrays: dict[str, np.ndarray]) -> None:
        """``gather``'s inverse: load ``(G, ...)`` arrays in slot order onto
        every shard's slab in place, with the host-held state that comes
        with them: ``cstate.next_inst``, ``cstate.crnd``, ``alive`` and the
        placement ``slot_of`` (the identity without it, as in an unsharded
        dataplane's state)."""
        g, gl = self.cfg.n_groups, self.groups_per_shard
        for name, parts in (("stack", self.stacks), ("lstate", self.lstates)):
            for field in vars(parts[0]):
                key = f"{name}.{field}"
                src = torch.from_numpy(np.asarray(arrays[key], np.int32))
                want = (g, *getattr(parts[0], field).shape[1:])
                if tuple(src.shape) != want:
                    raise ValueError(f"{key}: shape {tuple(src.shape)} != {want}")
                for p, rows in zip(parts, src.split(gl), strict=True):
                    getattr(p, field).copy_(rows)
        self.cstate = CoordinatorState(
            *(np.array(arrays[k], np.int32) for k in ("cstate.next_inst", "cstate.crnd"))
        )
        self.alive_mask = np.asarray(arrays["alive"]).astype(np.int32)
        slot_of = arrays.get("slot_of", range(g))
        self._placement = plan_mod.PlacementMap(tuple(int(x) for x in slot_of), gl)

    def _fold_width(self) -> int:
        # a fold never crosses a shard's slab
        return self.groups_per_shard

    # -- placement -------------------------------------------------------------
    @property
    def placement(self) -> plan_mod.PlacementMap:
        return self._placement

    def _slab_row(self, gid: int) -> int:
        return self._placement.slot_of[gid]

    def shard_of_group(self, gid: int) -> int:
        """Mesh shard owning group ``gid`` under the current placement."""
        self._check_gid(gid)
        return self._placement.shard_of(gid)

    def group_placement(self) -> list[int]:
        """group id -> owning shard, for the whole service."""
        pm = self._placement
        return [pm.shard_of(g) for g in range(self.cfg.n_groups)]

    def plan_placement(self, loads: Sequence[int]) -> plan_mod.PlacementMap:
        """The load-weighted placement this service would adopt for the
        given per-group loads (``PlacementMap.weighted``); pure planning:
        adopting it is a sequence of ``migrate_group`` slot swaps."""
        return plan_mod.PlacementMap.weighted(loads, self.n_shards, self.groups_per_shard)

    # -- dispatch construction -------------------------------------------------
    def _dispatch(self, use_k: bool, gb: int):
        fn = self._dispatches.get((use_k, gb))
        if fn is None:
            from .fabric import make_sharded_multigroup_round

            fn = self._dispatches[(use_k, gb)] = make_sharded_multigroup_round(
                self.mesh, n_groups=self.cfg.n_groups, quorum=self.cfg.quorum,
                axis=self.axis, use_kernels=use_k, group_block=gb,
            )  # fmt: skip
        return fn

    def _packed_dispatch(self, use_k: bool):
        fn = self._packed_dispatches.get(use_k)
        if fn is None:
            from .fabric import make_packed_sharded_round

            fn = self._packed_dispatches[use_k] = make_packed_sharded_round(
                self.mesh, quorum=self.cfg.quorum, axis=self.axis, use_kernels=use_k
            )
        return fn

    # -- fused fast path: every shard advances its slab in one dispatch -------
    @mirror_guard
    def pipeline(self, values: np.ndarray, active: np.ndarray, enabled: list[bool] | None = None):
        """``MultiGroupDataplane.pipeline``'s contract and results, run
        shard by shard over the slot-ordered slabs."""
        g, b = values.shape[0], values.shape[1]
        enabled, use_k, _ = self._plan_round(b, enabled)
        if not any(enabled):
            return self._empty_round(g, b)
        self._guard_capacity([gid for gid in range(g) if enabled[gid]], b)
        pm = self._placement
        # the fold's blocks are SLOT blocks (the kernel walks physical slab
        # rows), so the width derives from slot-ordered marks
        perm = list(pm.group_of)  # slot -> gid
        marks_slot = [self.next_inst_host[gid] for gid in perm]
        slots = [pm.slot_of[gid] for gid in range(g) if enabled[gid]]
        plan_gb = plan_mod.fold_width_full(slots, marks_slot, self._fold_width())
        en = np.asarray(enabled, np.int32)[perm]
        eff_crnd = np.where(en != 0, _i32(self.crnd_host)[perm], NO_ROUND).astype(np.int32)
        lim = self._reclaim_limits_np()
        fn = self._dispatch(use_k, plan_gb if use_k else 1)
        self.dispatch_count += 1
        _st, _ls, fresh, inst, _win, value = fn(
            _i32(self.next_inst_host)[perm], eff_crnd, en, self.alive_mask[perm],
            self.stacks, self.lstates, np.asarray(values)[perm], np.asarray(active)[perm],
            reclaim_limit=None if lim is None else lim[perm],
        )  # fmt: skip
        for gid in range(g):
            if enabled[gid]:
                self.next_inst_host[gid] += b
        self._sync_cstate()
        self.last_gb = plan_gb  # reported engine-agnostically
        inv = list(pm.slot_of)  # gid -> slot: gather back to gid order
        return fresh[inv], inst[inv], value[inv]

    # -- cohort dispatch, packed per shard ---------------------------------------
    @mirror_guard
    def pipeline_cohort(self, gids, values: np.ndarray, active: np.ndarray, defer: bool = False):
        """The unsharded ``pipeline_cohort``'s contract and results, run as
        one packed dispatch: each shard advances ``C`` lanes (the cohort's
        largest per-shard residency, rounded up to a power of two), lane
        ``j`` routed to its slab row by a segment table; a shard with fewer
        members rides pad lanes.  A cohort with ``C >= Gl`` runs full width
        instead (``_cohort_full_width``).  The result is read back at
        dispatch; ``defer=True`` wraps it in a resolved handle."""
        gids, member, use_k, inst = self._cohort_prologue(gids, values)
        be = values.shape[1]
        self._guard_capacity(gids, be)
        marks = self.next_inst_host
        pm = self._placement
        n_sh, gl = self.n_shards, self.groups_per_shard
        lanes: list[list[int]] = [[] for _ in range(n_sh)]
        for row, gid in enumerate(gids):
            lanes[pm.shard_of(gid)].append(row)
        cmax = max(len(ls) for ls in lanes)
        c = min(1 << max(0, cmax - 1).bit_length(), gl)
        if c >= gl:
            # a saturated cohort's packed table visits as many slab rows as
            # the full-width fold, so the full-width dispatch serves it
            return self._cohort_full_width(gids, member, use_k, inst, values, active, defer)
        # the full-width fold over slot-ordered marks stays the reported plan
        marks_slot = [marks[gid] for gid in pm.group_of]
        plan_gb = plan_mod.fold_width_full(
            [pm.slot_of[gid] for gid in gids], marks_slot, self._fold_width()
        )
        a, v = self.cfg.n_acceptors, self.cfg.value_words
        seg = np.zeros((n_sh, c), np.int32)
        enp = np.zeros((n_sh, c), np.int32)
        nip = np.zeros((n_sh, c), np.int32)
        crp = np.full((n_sh, c), NO_ROUND, np.int32)
        alp = np.ones((n_sh, c, a), np.int32)
        limnp = self._reclaim_limits_np()
        limp = np.full((n_sh, c), INT32_MAX, np.int32)
        valsp = np.zeros((n_sh, c, be, v), np.int32)
        valsp[:, :, :, 0] = NOP_SENTINEL
        marks32, crnd32 = _i32(marks), _i32(self.crnd_host)
        lane_of: dict[int, tuple[int, int]] = {}
        for s in range(n_sh):
            for j, row in enumerate(lanes[s]):
                gid = gids[row]
                seg[s, j] = pm.row_of(gid)
                enp[s, j] = 1
                nip[s, j] = marks32[gid]
                crp[s, j] = crnd32[gid]
                alp[s, j] = self.alive_mask[gid]
                if limnp is not None:
                    limp[s, j] = limnp[gid]
                valsp[s, j] = values[row]
                lane_of[gid] = (s, j)
        fn = self._packed_dispatch(use_k)
        self.dispatch_count += 1
        _st, _ls, fresh, _inst, _win, value = fn(
            seg, nip, crp, enp, alp, self.stacks, self.lstates, valsp, reclaim_limit=limp
        )
        fresh = fresh.reshape(n_sh, c, be)
        value = value.reshape(n_sh, c, be, v)
        fresh = np.stack([fresh[lane_of[gid]] for gid in gids])
        value = np.stack([value[lane_of[gid]] for gid in gids])
        for gid in gids:
            self.next_inst_host[gid] += be
        self._sync_cstate()
        self.last_gb = plan_gb
        if defer:
            return _DeferredRound.resolved(fresh, value, inst)
        return fresh, inst, value

    @mirror_guard
    def _cohort_full_width(self, gids, member, use_k, inst, values, active, defer: bool):
        """Full-width execution of a saturated cohort: non-members ride the
        dispatch inert (NOP sentinel rows, membership-masked rounds), the
        unsharded plain engine's packing, permuted into slot order."""
        g = self.cfg.n_groups
        be = values.shape[1]
        pm = self._placement
        marks = self.next_inst_host
        perm = list(pm.group_of)  # slot -> gid
        marks_slot = [marks[gid] for gid in perm]
        plan_gb = plan_mod.fold_width_full(
            [pm.slot_of[gid] for gid in gids], marks_slot, self._fold_width()
        )
        vals_f, act_f = plan_mod.scatter_rows(gids, values, active, g, self.cfg.value_words)
        memp = np.asarray(member, np.int32)[perm]
        eff_crnd = np.where(memp != 0, _i32(self.crnd_host)[perm], NO_ROUND).astype(np.int32)
        lim = self._reclaim_limits_np()
        fn = self._dispatch(use_k, plan_gb if use_k else 1)
        self.dispatch_count += 1
        _st, _ls, fresh, _inst, _win, value = fn(
            _i32(marks)[perm], eff_crnd, memp, self.alive_mask[perm], self.stacks, self.lstates,
            vals_f[perm], act_f[perm], reclaim_limit=None if lim is None else lim[perm],
        )  # fmt: skip
        inv = list(pm.slot_of)  # gid -> slot: gather back to gid order
        fresh = fresh[inv][gids]
        value = value[inv][gids]
        for gid in gids:
            self.next_inst_host[gid] += be
        self._sync_cstate()
        self.last_gb = plan_gb
        if defer:
            return _DeferredRound.resolved(fresh, value, inst)
        return fresh, inst, value

    def pipeline_persistent(self, gids, values: np.ndarray, active: np.ndarray, defer=False):
        """The reference's K=1 fallback: a wave runs as K sequential cohort
        dispatches, so ``dispatch_count`` grows by K; delivery and numbering
        equal the unsharded wave's.  The whole wave is guarded against the
        reclaim limit before any round moves state."""
        k, be = values.shape[0], values.shape[2]
        gids = list(gids)
        if k * be > self.cfg.n_instances:
            raise ValueError(
                f"persistent wave of {k} x {be} instances would lap the "
                f"{self.cfg.n_instances}-instance ring"
            )
        marks = self.next_inst_host
        for gid in gids:
            self._reclaim_guard(gid, marks[gid] + (k - 1) * be, be)
        outs = [self.pipeline_cohort(gids, values[r], active[r]) for r in range(k)]
        fresh, inst, value = (np.stack(x) for x in zip(*outs, strict=True))
        if defer:
            return _DeferredRound.resolved(fresh, value, inst)
        return fresh, inst, value

    @mirror_guard
    def burn_forward(self, gid: int, target: int) -> None:
        """Host-scalar realignment burn: the new watermark reaches the
        owning shard with the next dispatch."""
        self._check_gid(gid)
        if target < self.next_inst_host[gid]:
            raise ValueError(
                f"burn_forward moves only forward: {target} < "
                f"{self.next_inst_host[gid]} (group {gid})"
            )
        self.next_inst_host[gid] = target
        self._sync_cstate()

    # -- per-group control: host scalars only ----------------------------------
    def _sync_cstate(self) -> None:
        self.cstate = CoordinatorState(
            next_inst=_i32(self.next_inst_host), crnd=_i32(self.crnd_host)
        )

    def kill_acceptor(self, gid: int, aid: int) -> None:
        self._check_gid(gid)
        self.alive[gid][aid] = False
        self.alive_mask[gid, aid] = 0

    def revive_acceptor(self, gid: int, aid: int) -> None:
        self._check_gid(gid)
        self.alive[gid][aid] = True
        self.alive_mask[gid, aid] = 1

    @mirror_guard
    def freeze_group(self, gid: int) -> None:
        self._check_gid(gid)
        self.crnd_host[gid] = NO_ROUND
        self._sync_cstate()

    @mirror_guard
    def restore_group(self, gid: int, next_inst: int, crnd: int) -> None:
        self._check_gid(gid)
        if self.use_kernels:
            bb = plan_mod.wire_block(self.cfg.batch)
            next_inst = -(-next_inst // bb) * bb
        self.next_inst_host[gid] = next_inst
        self.crnd_host[gid] = crnd
        self._sync_cstate()

    # -- live slab migration -------------------------------------------------------
    @mirror_guard
    def migrate_group(self, gid: int, dst_shard: int) -> None:
        """Move a live tenant's slab to ``dst_shard`` between waves.

        The caller has drained the group to its reclamation watermark (its
        ring history is in the ``SnapshotStore``; checked here), so its slab
        rows hold nothing the store does not.  The move is a slot swap with
        the lowest vacant (retired) group on ``dst_shard``: the gid keeps
        its identity, only ``_slab_row`` changes.  The adopted slot is reset
        (it holds the vacant group's retired rows) and the sequencer is
        re-seated at the drain watermark (block-realigned under
        ``use_kernels``, as in ``restore_group``).  No other group's slab,
        watermark or placement moves, so the service keeps dispatching."""
        self._check_live(gid)
        if not 0 <= dst_shard < self.n_shards:
            raise ValueError(f"shard {dst_shard} out of range [0, {self.n_shards})")
        if self.reclaimed_host is None:
            raise ValueError("migrate_group requires reclamation enabled")
        wm = self.next_inst_host[gid]
        if self.reclaimed_host[gid] != wm:
            raise ValueError(
                f"group {gid} not drained: reclamation watermark "
                f"{self.reclaimed_host[gid]} != sequencer watermark {wm}"
            )
        pm = self._placement
        if pm.shard_of(gid) == dst_shard:
            return
        vacant = [
            h for h in range(self.cfg.n_groups)
            if pm.shard_of(h) == dst_shard and not self.live_host[h]
        ]  # fmt: skip
        if not vacant:
            raise RuntimeError(
                f"no vacant slot on shard {dst_shard} to migrate group "
                f"{gid} into (retire or migrate a tenant off it first)"
            )
        self._placement = pm.swapped(gid, vacant[0])
        self._reset_group_slab(gid)  # the newly adopted slot
        self.restore_group(gid, wm, self.crnd_host[gid])


class PaxosContext:
    """Drop-in replacement context (the paper's ``paxos_ctx``), for one group
    or, with ``PaxosConfig(n_groups=G)``, for G groups on one dataplane."""

    def __init__(
        self,
        cfg: PaxosConfig | None = None,
        deliver: Callable[[bytes, int, int], None] | None = None,
        net: SimNet | None = None,
        use_kernels: bool = True,
        retransmit_after: int = 3,
        n_learners: int = 1,
        fused: bool = False,
        mesh=None,
        snapshots: bool = False,
        device: torch.device | str | None = None,
    ):
        self.cfg = cfg or PaxosConfig()
        self.deliver_cb = deliver
        self.net = net or SimNet()
        self.n_groups = self.cfg.n_groups
        # the group-keyed surface engages for any multi-group config and for
        # a sharded single-group one (the sharded dataplane is group-keyed)
        self.grouped = self.n_groups > 1 or mesh is not None
        self.planner: plan_mod.DispatchPlanner | None = None
        if self.grouped:
            # the multi-group service is wire-path only: every group rides
            # the fused dispatch; staged traffic exists per group for
            # recovery and failover (group views)
            if n_learners != 1:
                raise ValueError(
                    "multi-group context drives the fused wire path and a "
                    "single learner role per group (n_learners must be 1)"
                )
            if mesh is not None:
                # the groups-sharded service: the G slabs partition over the
                # mesh's ``groups`` axis
                self.hw: Any = ShardedMultiGroupDataplane(
                    self.cfg, mesh=mesh, use_kernels=use_kernels, device=device
                )
            else:
                self.hw = MultiGroupDataplane(self.cfg, use_kernels=use_kernels, device=device)
            self.fused = True
            self._softco_g: dict[int, SoftCoordinator] = {}
            self.learned_g: list[dict[int, bytes]] = [dict() for _ in range(self.n_groups)]
            self._partial_g: list[dict[int, dict[int, tuple[int, bytes]]]] = [
                dict() for _ in range(self.n_groups)
            ]
            # burst sizing, cohort tiering and the realignment sweep
            # a sharded context plans no persistent waves: its engine would
            # run a K-round wave as K dispatches anyway (the reference's clamp)
            self.planner = plan_mod.DispatchPlanner(
                batch=self.cfg.batch,
                n_instances=self.cfg.n_instances,
                realign_after=self.cfg.realign_after,
                persistent_rounds=self.cfg.persistent_rounds,
                sharded=mesh is not None,
            )
        else:
            self.hw = HardwareDataplane(self.cfg, use_kernels=use_kernels, device=device)
            self.fused = fused
        self.group_log: list[list[tuple[int, bytes]]] = [[] for _ in range(self.n_groups)]
        self._delivered_seqs: set = set()
        self.retransmit_after = retransmit_after
        self.n_learners = n_learners
        # learner state (software role), one per learner
        self.learned: list[dict[int, bytes]] = [dict() for _ in range(n_learners)]
        self._partial: list[dict[int, dict[int, tuple[int, bytes]]]] = [
            dict() for _ in range(n_learners)
        ]
        self.delivered_log: list[tuple[int, bytes]] = []
        # client seq -> payload; a grouped context keys by (group, seq): each
        # group is an independent Paxos with its own sequence space
        self._pending: dict[Any, _Pending] = {}
        self._next_client_seq = 0
        self._next_client_seq_g = [0] * self.n_groups
        self._next_epoch = 1  # round-allocator epochs
        self._softco: SoftCoordinator | None = None  # failover coordinator
        # snapshots: the rings are watermark-gated (no silent overwrite on
        # wrap) and ``snapshot_group`` drains the delivered prefix
        self.snapshots: SnapshotStore | None = None
        if snapshots:
            if not self.fused:
                # the drain source is the device learner ring, which only
                # the fused wire path maintains
                raise ValueError(
                    "snapshots require the fused wire path (fused=True, or any grouped context)"
                )
            # seals run on the dataplane's (home) device
            self.snapshots = SnapshotStore(self.hw.device)
            self.hw.enable_reclamation()
        self.stats = {"submitted": 0, "delivered": 0, "retransmits": 0}

    # -- paper API -----------------------------------------------------------
    def _check_group(self, group: int) -> None:
        if not 0 <= group < self.n_groups:
            raise ValueError(f"group {group} out of range [0, {self.n_groups})")
        if self.grouped and not self.hw.live_host[group]:
            raise ValueError(f"group {group} is retired")

    def submit(self, payload: bytes, group: int = 0) -> int:
        """paxos_submit(ctx, value, size).  Oversized payloads fail here, at
        the door, with the limit named."""
        self._check_group(group)
        limit = self.cfg.max_payload_bytes
        if len(payload) > limit:
            raise ValueError(
                f"payload is {len(payload)} bytes but value_words="
                f"{self.cfg.value_words} carries at most {limit} payload "
                f"bytes per value ({self.cfg.value_words * 4}-byte value "
                f"minus the 8-byte seq/len header) — raise "
                f"PaxosConfig.value_words"
            )
        if self.grouped:
            seq = self._next_client_seq_g[group]
            self._next_client_seq_g[group] += 1
            self._pending[(group, seq)] = _Pending(payload, group=group)
        else:
            seq = self._next_client_seq
            self._next_client_seq += 1
            self._pending[seq] = _Pending(payload)
        self.net.send("coordinator", ("submit", seq, payload, group))
        self.stats["submitted"] += 1
        return seq

    def recover(self, inst: int, nop: bytes = b"\x00", group: int = 0) -> None:
        """paxos_recover(ctx, iid, nop_value, size): phase 1+2 with a no-op."""
        self._check_group(group)
        self.net.send("coordinator", ("recover", inst, nop, group))

    # -- event loop ----------------------------------------------------------
    def pump(self, rounds: int = 1) -> None:
        """Drive the fabric: drain submits through the dataplane, route votes
        to learners, fire deliver callbacks, retransmit losses."""
        for _ in range(rounds):
            self._pump_coordinator()
            self._pump_learners()
            self._retransmit()

    def quiescent(self) -> bool:
        """True when no client sequence is pending and nothing is in flight."""
        return not self._pending and self.net.pending() == 0

    def run_until_quiescent(self, max_rounds: int = 64) -> None:
        for _ in range(max_rounds):
            if self.quiescent():
                return
            self.pump()

    # -- internals -----------------------------------------------------------
    def _pump_coordinator(self) -> None:
        inbox = self.net.recv_all("coordinator")
        if self.grouped:
            self._pump_coordinator_groups(
                [(m[1], m[2], m[3]) for m in inbox if m[0] == "submit"],
                [(m[1], m[2], m[3]) for m in inbox if m[0] == "recover"],
            )
            return
        for m in inbox:
            if m[0] == "recover":
                self._run_recover(m[1], m[2])
        submits = [(m[1], m[2]) for m in inbox if m[0] == "submit"]
        b = self.cfg.batch
        for i in range(0, len(submits), b):
            chunk = submits[i : i + b]
            # the fused path right-sizes the burst (engine-agnostic
            # quantization); the staged path keeps the full batch
            be = plan_mod.quantize_burst(len(chunk), b) if self.fused else b
            vals, active = self._pack_chunk(chunk, be)
            if self.fused and self._softco is None:
                # the CAANS wire path: the whole Phase-2 round below the host
                # boundary, one dispatch; votes never surface as messages
                fresh, inst, value = self.hw.pipeline(vals, active)
                for j in np.nonzero(fresh)[0]:
                    raw = value[j].tobytes()
                    for lid in range(self.n_learners):
                        self.learned[lid].setdefault(int(inst[j]), raw)
                    self._deliver(int(inst[j]), raw)
                continue
            if self._softco is not None:
                p2a = self._soft_p2a(self._softco, vals, active)
            else:
                p2a = self.hw.sequence(vals, active)
            for aid, v in enumerate(self.hw.vote(p2a)):
                if v is None:
                    continue
                for lid in range(self.n_learners):
                    self.net.send(("learner", lid), ("votes", aid, _to_host(v)))

    def _pump_learners(self) -> None:
        for lid in range(self.n_learners):
            for _, aid, votes in self.net.recv_all(("learner", lid)):
                self._quorum_learn(
                    self.learned[lid],
                    self._partial[lid],
                    aid,
                    votes,
                    self._deliver if lid == 0 else None,
                )

    def _quorum_learn(
        self,
        learned: dict[int, bytes],
        partial: dict[int, dict[int, tuple[int, bytes]]],
        aid: int,
        votes: dict,
        deliver: Callable[[int, bytes], None] | None,
    ) -> None:
        """The software learner: fold one acceptor's vote batch into the
        partial-quorum table; at quorum, record the decision and (when this
        learner delivers) fire ``deliver(inst, raw)``."""
        quorum = self.cfg.quorum
        for i in range(len(votes["msgtype"])):
            if votes["msgtype"][i] != MSG_P2B:
                continue
            inst = int(votes["inst"][i])
            if inst in learned:
                continue  # duplicate suppression
            slot = partial.setdefault(inst, {})
            slot[aid] = (int(votes["vrnd"][i]), votes["value"][i].tobytes())
            by_rnd: dict[int, int] = {}
            for vr, _ in slot.values():
                by_rnd[vr] = by_rnd.get(vr, 0) + 1
            for vr, cnt in by_rnd.items():
                if cnt >= quorum:
                    raw = next(v for r, v in slot.values() if r == vr)
                    learned[inst] = raw
                    partial.pop(inst, None)
                    if deliver is not None:
                        deliver(inst, raw)
                    break

    def _pack_chunk(self, chunk: list[tuple[int, bytes]], be: int) -> tuple[np.ndarray, np.ndarray]:
        """Pack (seq, payload) pairs into a (BE, V) wire burst; unfilled
        slots carry the NOP sentinel and are inactive."""
        return plan_mod.pack_rows(
            [self._encode(seq, payload) for seq, payload in chunk], be, self.cfg.value_words
        )

    # -- multi-group internals (G groups on one dataplane) -------------------
    def _pump_coordinator_groups(
        self,
        submits: list[tuple[int, bytes, int]],
        recovers: list[tuple[int, bytes, int]],
    ) -> None:
        """Group-keyed coordinator pump: recovery first, then the groups
        under a software coordinator (staged, per group), then the cohort
        waves of the dispatch planner for every hardware-sequenced group.

        Each chunk wave splits the loaded groups into cohorts, one dispatch
        per distinct right-sized burst; frozen, vacant and idle groups are
        members of no cohort and burn no instances.  A cohort planned as a
        K-round persistent wave takes K - 1 further batch slices of its
        members' queues and rides one ``pipeline_persistent`` dispatch.
        With ``async_pump`` a wave's read-back is deferred until the next
        wave is dispatched (planning reads the host mirrors only, and every
        wave is resolved before ``pump`` returns, in the serial loop's
        order)."""
        # traffic to a retired group is dropped at the door: its slot may
        # already belong to the free-list or to a new tenant
        live = self.hw.live_host
        submits = [s for s in submits if live[s[2]]]
        for inst, nop, gid in recovers:
            if live[gid]:
                self._run_recover_group(gid, inst, nop)
        queues: list[list[tuple[int, bytes]]] = [[] for _ in range(self.n_groups)]
        for seq, payload, gid in submits:
            queues[gid].append((seq, payload))
        b = self.cfg.batch

        for gid in list(self._softco_g):
            q, queues[gid] = queues[gid], []
            for i in range(0, len(q), b):
                be = self._burst_size(len(q[i : i + b]))
                vals, active = self._pack_chunk(q[i : i + b], be)
                p2a = self._soft_sequence_group(gid, vals, active)
                for aid, v in enumerate(self.hw.group_view(gid).vote(p2a)):
                    if v is not None:
                        # learners route on the batch's group tag
                        self._learn_group(v.gid, aid, _to_host(v))

        hw = self.hw
        in_flight: list[tuple[tuple[int, ...], _DeferredRound]] = []
        while any(queues):
            pending = [len(q) for q in queues]
            chunks = [q[:b] for q in queues]
            queues = [q[b:] for q in queues]
            rp = self.planner.plan_round(
                [len(c) for c in chunks],
                hw.next_inst_host,
                hw.live_host,
                hw.crnd_host,
                pending=pending,
            )
            for gid, target in rp.realign:
                hw.burn_forward(gid, target)
            wave = []
            for cohort in rp.cohorts:
                kk = self._wave_depth_clamped(cohort)
                # a persistent wave (kk > 1) takes kk - 1 further batch
                # slices of each member's queue into the same dispatch
                rounds = [[chunks[gid] for gid in cohort.gids]]
                for _ in range(kk - 1):
                    rounds.append([queues[gid][:b] for gid in cohort.gids])
                    for gid in cohort.gids:
                        queues[gid] = queues[gid][b:]
                packed = [[self._pack_chunk(c, cohort.burst) for c in row] for row in rounds]
                vals = np.stack([np.stack([v for v, _ in row]) for row in packed])
                act = np.stack([np.stack([a for _, a in row]) for row in packed])
                if kk > 1:
                    handle = hw.pipeline_persistent(cohort.gids, vals, act, defer=True)
                else:
                    handle = hw.pipeline_cohort(cohort.gids, vals[0], act[0], defer=True)
                wave.append((cohort.gids, handle))
            if self.cfg.async_pump:
                # this wave is in flight: deliver the previous one meanwhile
                for gids_, handle in in_flight:
                    self._resolve_wave(gids_, handle)
                in_flight = wave
            else:
                for gids_, handle in wave:
                    self._resolve_wave(gids_, handle)
        for gids_, handle in in_flight:
            self._resolve_wave(gids_, handle)

    def _wave_depth_clamped(self, cohort: plan_mod.Cohort) -> int:
        """A cohort's planned wave depth, clamped by each member's reclaim
        headroom (instances until its first unreclaimed slot, in bursts)."""
        kk = cohort.rounds
        if kk <= 1:
            return kk
        lim = self.hw._reclaim_limits_np()
        if lim is not None:
            for gid in cohort.gids:
                kk = min(kk, (int(lim[gid]) - self.hw.next_inst_host[gid]) // cohort.burst)
        return max(1, kk)

    def _resolve_wave(self, gids: tuple[int, ...], handle: _DeferredRound) -> None:
        """Host read-back and delivery of one dispatched cohort round or
        persistent wave.  A wave delivers rounds first, then rows: the
        order K sequential single-round dispatches would give."""
        fresh, inst, value = handle.resolve()
        if fresh.ndim == 2:  # a single round: (M, BE)
            fresh, inst, value = fresh[None], inst[None], value[None]
        for r in range(fresh.shape[0]):
            for row, gid in enumerate(gids):
                for j in np.nonzero(fresh[r, row])[0]:
                    raw = value[r, row, j].tobytes()
                    ii = int(inst[r, row, j])
                    self.learned_g[gid].setdefault(ii, raw)
                    self._deliver_group(gid, ii, raw)

    def _burst_size(self, longest: int) -> int:
        """Engine-agnostic burst sizing (``plan.quantize_burst``), noted in
        the planner's burst shapes."""
        be = plan_mod.quantize_burst(longest, self.cfg.batch)
        if self.planner is not None:
            self.planner.note_burst(be)
        return be

    def _soft_sequence_group(self, gid: int, vals: np.ndarray, active: np.ndarray) -> MsgBatch:
        """Sequence a burst on group ``gid``'s software coordinator."""
        return self._soft_p2a(self._softco_g[gid], vals, active, gid=gid)

    def _learn_group(self, gid: int, aid: int, votes: dict) -> None:
        """Per-group software learner (staged traffic: failover, recovery)."""
        self._quorum_learn(
            self.learned_g[gid],
            self._partial_g[gid],
            aid,
            votes,
            functools.partial(self._deliver_group, gid),
        )

    def _deliver_group(self, gid: int, inst: int, raw: bytes) -> None:
        self._deliver_value(inst, raw, group=gid)

    def _run_recover_group(self, gid: int, inst: int, nop: bytes) -> None:
        """Per-group recovery against one group's view; decided votes go
        straight to the group's learn surface."""
        votes = self._recover_votes(self.hw.group_view(gid), inst, nop, gid=gid)
        for aid, v in enumerate(votes or []):
            if v is not None:
                self._learn_group(v.gid, aid, _to_host(v))

    def _deliver(self, inst: int, raw: bytes) -> None:
        self._deliver_value(inst, raw)

    def _deliver_value(self, inst: int, raw: bytes, group: int | None = None) -> None:
        """The delivery contract: discard internal fillers, suppress
        duplicates (a retransmit decided twice, paper §3.1), settle the
        pending entry, log, and fire the application callback.  ``group``
        selects the per-group sequence space and delivery log."""
        words = np.frombuffer(raw, "<i4")
        if words[0] == NOP_SENTINEL:
            return  # internal filler, discarded by the library
        seq = int(words[0])
        key: Any = seq if group is None else (group, seq)
        if key in self._delivered_seqs:
            return
        self._delivered_seqs.add(key)
        payload = raw[8 : 8 + int(words[1])]
        self._pending.pop(key, None)
        self.delivered_log.append((inst, payload))
        self.group_log[0 if group is None else group].append((inst, payload))
        self.stats["delivered"] += 1
        if self.deliver_cb:
            self.deliver_cb(payload, len(payload), inst)

    def _retransmit(self) -> None:
        for key, p in list(self._pending.items()):
            p.age += 1
            if p.age >= self.retransmit_after:
                p.age = 0
                self.stats["retransmits"] += 1
                seq = key[1] if isinstance(key, tuple) else key
                self.net.send("coordinator", ("submit", seq, p.payload, p.group))

    def _encode(self, seq: int, payload: bytes) -> np.ndarray:
        nbytes = self.cfg.value_words * 4
        if len(payload) > nbytes - 8:
            raise ValueError(
                f"value too large: {len(payload)} > {nbytes - 8} "
                f"(increase PaxosConfig.value_words)"
            )
        head = np.array([seq, len(payload)], np.int32).tobytes()
        return np.frombuffer((head + payload).ljust(nbytes, b"\x00"), "<i4").copy()

    # -- snapshot / compaction -----------------------------------------------
    def _require_snapshots(self) -> SnapshotStore:
        if self.snapshots is None:
            raise ValueError(
                "snapshots are not enabled on this context (construct with snapshots=True)"
            )
        return self.snapshots

    def full_group_log(self, gid: int = 0) -> list[tuple[int, bytes]]:
        """The complete delivery history: the compacted snapshot prefix (if
        any) stitched before the live ``group_log``; a retired group's too."""
        if not 0 <= gid < self.n_groups:
            raise ValueError(f"group {gid} out of range [0, {self.n_groups})")
        if self.snapshots is None:
            return self.group_log[gid]
        return self.snapshots.log_prefix(gid) + self.group_log[gid]

    def snapshot_group(self, gid: int = 0, upto: int | None = None) -> GroupSnapshot:
        """Drain the decided ring prefix below ``upto`` (default: the
        sequencer watermark) into the ``SnapshotStore``, seal it, move the
        host-log prefix into the store, and advance the reclamation
        watermark so the drained ring slots may be re-sequenced."""
        store = self._require_snapshots()
        self._check_group(gid)
        hw = self.hw
        if self.grouped:
            seq_mark = hw.next_inst_host[gid]
            ld, li, lv = (x.cpu().numpy() for x in vars(hw._rows(gid)[1]).values())
        else:
            seq_mark = hw._next_inst_host
            ld, li, lv = (x.cpu().numpy() for x in vars(hw.lstate).values())
        upto = seq_mark if upto is None else upto
        wm = store.watermark(gid)
        if not wm <= upto <= seq_mark:
            raise ValueError(f"snapshot upto={upto} outside [{wm}, {seq_mark}] (group {gid})")
        # decided entries in [wm, upto), ascending by instance: the raw ring
        # words (NOP fillers included: the seal covers device history)
        slots = np.nonzero((ld != 0) & (li >= wm) & (li < upto))[0]
        order = slots[np.argsort(li[slots], kind="stable")]
        store.absorb(gid, li[order], lv[order], upto)
        # compaction: move the host log's leading run below the watermark
        log = self.group_log[gid]
        cut = 0
        while cut < len(log) and log[cut][0] < upto:
            cut += 1
        store.absorb_log(gid, log[:cut])
        self.group_log[gid] = log[cut:]
        if self.grouped:
            hw.set_reclaimed(gid, upto)
        else:
            hw.set_reclaimed(upto)
        return store.snapshot(gid)

    def crash_acceptor(self, aid: int, group: int = 0) -> None:
        """Crash an acceptor WITH state loss: liveness drops and its register
        file is reset.  Revive with ``restore_acceptor``."""
        self._check_group(group)
        ids = (group, aid) if self.grouped else (aid,)
        self.hw.kill_acceptor(*ids)
        self.hw.wipe_acceptor(*ids)

    def restore_acceptor(self, aid: int, group: int = 0) -> int:
        """Revive a crashed acceptor by state transfer: instances below the
        snapshot watermark are covered by the sealed snapshot, and the live
        ring suffix's decided instances are adopted from the learner ring.
        Returns the number of adopted ring slots."""
        from .failover import restore_acceptor as _restore

        self._check_group(group)
        wm = self.snapshots.watermark(group) if self.snapshots else 0
        return _restore(self.hw, aid, gid=group if self.grouped else None, watermark=wm)

    # -- dynamic membership ----------------------------------------------------
    def _require_grouped(self) -> None:
        if not self.grouped:
            raise ValueError(
                "dynamic membership requires a group-keyed context (n_groups > 1 or mesh=...)"
            )

    def live_groups(self) -> list[int]:
        """Live group ids, ascending: the routing domain."""
        return self.hw.live_groups() if self.grouped else [0]

    def _reset_tenant(self, gid: int) -> None:
        self.learned_g[gid] = {}
        self._partial_g[gid] = {}
        self.group_log[gid] = []
        self._next_client_seq_g[gid] = 0
        if self.snapshots is not None:
            self.snapshots.reset_group(gid)

    def create_group(self) -> int:
        """Admit a tenant on the lowest free slot: fresh rings, watermark,
        round and client-sequence space, empty logs.  Returns its gid."""
        self._require_grouped()
        gid = self.hw.create_group()
        self._reset_tenant(gid)
        return gid

    def adopt_group(
        self, snap: GroupSnapshot, log_prefix: list[tuple[int, bytes]] | None = None
    ) -> int:
        """Admit a tenant bootstrapping from a transferred snapshot: its
        sequencer and reclamation watermarks start at ``snap.watermark``, and
        the store is seeded from the transfer after its seal is verified.
        ``log_prefix`` seeds the stitched history.  Returns the new gid."""
        self._require_grouped()
        store = self._require_snapshots()
        gid = self.hw.adopt_group(int(snap.watermark))
        self._reset_tenant(gid)
        store.seed(gid, snap, log_prefix)
        return gid

    def retire_group(self, gid: int) -> list[tuple[int, bytes]]:
        """Reclaim a tenant's slot: its round parks at NO_ROUND and the slot
        joins the free-list.  Undelivered submissions to it are dropped, its
        in-flight coordinator traffic is purged now (a recreated slot must
        not sequence the old tenant's submits) and its dedup keys are
        forgotten.  Returns the stitched delivery history."""
        self._require_grouped()
        self.hw.retire_group(gid)  # raises unless live
        self._softco_g.pop(gid, None)
        self.net.purge("coordinator", lambda m: m[3] == gid)
        for key in [k for k in self._pending if isinstance(k, tuple) and k[0] == gid]:
            del self._pending[key]
        self._delivered_seqs = {
            k for k in self._delivered_seqs if not (isinstance(k, tuple) and k[0] == gid)
        }
        return self.full_group_log(gid)

    def migrate_group(self, gid: int, dst_shard: int, max_rounds: int = 64) -> GroupSnapshot:
        """Live slab migration: move tenant ``gid`` to ``dst_shard`` between
        waves, without stopping the service.  Pump until the group's
        in-flight submissions drain (the other tenants keep deciding),
        ``snapshot_group`` its full prefix (ring drained into the store,
        reclamation watermark at the sequencer's), let the sharded dataplane
        swap slots, then check that the store's seal and watermark did not
        change.  Returns the sealed snapshot the move was checked against.
        Needs the groups-sharded dataplane (``mesh=...``) and snapshots."""
        self._require_grouped()
        store = self._require_snapshots()
        self._check_group(gid)
        hw = self.hw
        if not hasattr(hw, "migrate_group"):
            raise ValueError(
                "migrate_group requires the groups-sharded dataplane "
                "(construct the context with mesh=...)"
            )
        for _ in range(max_rounds):
            if not any(isinstance(k, tuple) and k[0] == gid for k in self._pending):
                break
            self.pump()
        else:
            raise RuntimeError(f"group {gid} did not drain within {max_rounds} pump rounds")
        snap = self.snapshot_group(gid)
        hw.migrate_group(gid, dst_shard)
        after = store.snapshot(gid)
        if after.seal != snap.seal or after.watermark != snap.watermark:
            raise RuntimeError(
                f"group {gid} snapshot seal changed across migration: "
                f"{snap.seal!r} -> {after.seal!r}"
            )
        return snap

    # -- failover ------------------------------------------------------------
    def fail_coordinator(self, est_next_inst: int | None = None, group: int = 0):
        """The hardware coordinator dies and a software coordinator takes
        over by the safe procedure (``core.failover.takeover``): a unique
        higher round, a Phase-1 scan of the window around the (possibly
        stale) watermark estimate, re-proposal of every voted value found."""
        from .failover import takeover

        self._check_group(group)
        if self.grouped:
            return self._fail_coordinator_group(group, est_next_inst)
        est = est_next_inst if est_next_inst is not None else int(self.hw.cstate.next_inst)
        epoch = self._next_epoch
        self._next_epoch += 1
        res = takeover(
            self.hw,
            coordinator_id=1,
            epoch=epoch,
            est_next_inst=est,
            window=self.cfg.batch * 2,
            quorum=self.cfg.quorum,
        )
        self._softco = SoftCoordinator(cid=1, crnd=res.crnd, next_inst=res.next_inst)
        return res

    def _fail_coordinator_group(self, gid: int, est_next_inst: int | None):
        """Per-group failover: only ``gid`` moves to a software coordinator
        (its hardware round parks at NO_ROUND, inert in the shared
        dispatch); every other group keeps its hardware sequencer."""
        from .failover import takeover_group

        est = est_next_inst if est_next_inst is not None else int(self.hw.cstate.next_inst[gid])
        epoch = self._next_epoch
        self._next_epoch += 1
        res = takeover_group(
            self.hw,
            gid,
            coordinator_id=1,
            epoch=epoch,
            est_next_inst=est,
            window=self.cfg.batch * 2,
            quorum=self.cfg.quorum,
        )
        self._softco_g[gid] = SoftCoordinator(cid=1, crnd=res.crnd, next_inst=res.next_inst)
        self.hw.freeze_group(gid)
        return res

    @mirror_guard
    def restore_hardware_coordinator(self, group: int = 0) -> None:
        self._check_group(group)
        if self.grouped:
            co = self._softco_g.pop(group, None)
            if co is not None:
                # only this group's watermark and round move; the block
                # realignment under use_kernels happens in restore_group
                self.hw.restore_group(group, int(co.next_inst), int(co.crnd))
            return
        if self._softco is None:
            return
        nxt = int(self._softco.next_inst)
        if self.hw.use_kernels:
            # The reference burns the watermark forward to its kernel's block
            # boundary (the skipped instances are never proposed and are
            # recoverable as no-ops, paper §3.1 gap fill).  The round kernel
            # here takes any window, but instance numbers must match the
            # reference's, so the burn-forward is kept.
            bb = plan_mod.wire_block(self.cfg.batch)
            nxt = -(-nxt // bb) * bb
        self.hw.cstate = CoordinatorState.init(
            crnd=int(self._softco.crnd), next_inst=nxt, device=self.hw.device
        )
        self.hw._next_inst_host = nxt  # resync the host watermark mirror
        self._softco = None

    def _soft_p2a(
        self, co: SoftCoordinator, vals: np.ndarray, active: np.ndarray, gid: int | None = None
    ) -> MsgBatch:
        """Software-coordinator sequencing: bind a burst to the coordinator's
        next window; ``gid`` tags the batch with its group, which is built on
        the device of the group's slab."""
        b = vals.shape[0]
        dev = self.hw.device if gid is None else self.hw.device_of(gid)
        inst = np.arange(co.next_inst, co.next_inst + b, dtype=np.int32)
        co.next_inst += b
        return MsgBatch(
            msgtype=torch.from_numpy(np.where(active, MSG_P2A, MSG_NOP).astype(np.int32)).to(dev),
            inst=torch.from_numpy(inst).to(dev),
            rnd=torch.full((b,), co.crnd, dtype=I32, device=dev),
            vrnd=torch.full((b,), NO_ROUND, dtype=I32, device=dev),
            swid=torch.full((b,), co.cid, dtype=I32, device=dev),
            value=torch.from_numpy(np.ascontiguousarray(vals, np.int32)).to(dev),
            gid=gid,
        )

    def _run_recover(self, inst: int, nop: bytes) -> None:
        """Phase 1 + Phase 2 for one instance with a no-op value (paper
        §3.1); decided votes fan out to the software learners over SimNet."""
        for aid, v in enumerate(self._recover_votes(self.hw, inst, nop) or []):
            if v is None:
                continue
            for lid in range(self.n_learners):
                self.net.send(("learner", lid), ("votes", aid, _to_host(v)))

    def _recover_votes(
        self, surface, inst: int, nop: bytes, gid: int | None = None
    ) -> list[MsgBatch | None] | None:
        """Phase-1 scan one instance, choose the required value (a discovered
        vote, else the no-op), Phase-2 it, and return the per-acceptor vote
        batches (None = no quorum of promises).  ``surface`` is the
        dataplane or one group's view; ``gid`` tags the batches, which are
        built on the device of the group's slab."""
        from .failover import allocate_round

        epoch = self._next_epoch
        self._next_epoch += 1
        crnd = allocate_round(epoch, coordinator_id=2)
        b = self.cfg.batch
        dev = self.hw.device if gid is None else self.hw.device_of(gid)
        # fillers carry a contiguous window starting at the target, so the
        # batch addresses distinct ring slots; at NO_ROUND they never accept
        window = torch.arange(inst, inst + b, dtype=I32, device=dev)
        p1a = MsgBatch.nop(b, self.cfg.value_words, dev).replace(inst=window, gid=gid)
        p1a.msgtype[0] = MSG_P1A
        p1a.rnd[0] = crnd
        best: tuple[int, bytes | None] = (NO_ROUND, None)
        got = 0
        for v in surface.prepare(p1a):
            if v is None:
                continue
            host = _to_host(v)
            if host["msgtype"][0] != MSG_P1B:
                continue
            got += 1
            vr = int(host["vrnd"][0])
            if vr > best[0]:
                best = (vr, host["value"][0].tobytes())
        if got < self.cfg.quorum:
            return None  # cannot recover without a quorum
        if best[1] is not None and best[0] != NO_ROUND:
            value_words = np.frombuffer(best[1], "<i4").copy()
        else:
            value_words = self._encode(-1, nop)
            value_words[0] = NOP_SENTINEL
        p2a = MsgBatch.nop(b, self.cfg.value_words, dev).replace(inst=window, gid=gid)
        p2a.msgtype[0] = MSG_P2A
        p2a.rnd[0] = crnd
        p2a.value[0] = torch.from_numpy(value_words)
        return surface.vote(p2a)


def _to_host(m: MsgBatch) -> dict:
    return {
        "msgtype": m.msgtype.cpu().numpy(),
        "inst": m.inst.cpu().numpy(),
        "rnd": m.rnd.cpu().numpy(),
        "vrnd": m.vrnd.cpu().numpy(),
        "swid": m.swid.cpu().numpy(),
        "value": m.value.cpu().numpy(),
    }
