"""The drop-in CAANS application API (paper Fig. 4), single group.

    submit(ctx, value, size)             -> propose a value
    ctx.deliver = cb(value, size, inst)  (registered callback)
    recover(ctx, inst, nop, size)        -> learn a previously decided instance

The PyTorch counterpart of ``repro.core.api`` for one Paxos group.  A
``PaxosContext`` wires software proposers and learners to the device
dataplane (``HardwareDataplane``): the coordinator, the acceptor array and
the learner's dedup ring, resident on one device.  Messages between the host
roles travel over the fault-injected ``SimNet``; retransmission on timeout
and duplicate suppression at the learners implement the paper's §3.1
failure-handling contract.

Everything runs on the card unless the caller asks for another device
(``device="cpu"``).  With ``use_kernels`` (the default here; the reference
defaults to ``False``) the dataplane runs the hand-written kernels on the
card and their plain versions on the CPU: the round kernel on the fused
wire path, the sequencer and the acceptor array's vote on the staged path
(the default, ``fused=False``).  ``use_kernels=False`` selects the plain
engine on any device.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from ..kernels import ops as kops
from . import batched
from . import plan as plan_mod
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

_MULTIGROUP = "ROADMAP.md queue 1, item 2 (multi-group)"
_SHARDED = "ROADMAP.md queue 1, item 6 (sharded dataplane)"


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` means the card; asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port on the CPU"
        )
    return dev


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
    def pipeline(self, values: np.ndarray, active: np.ndarray):
        """One dispatch: sequence + all acceptor votes + quorum + dedup.
        Returns host ``(fresh, inst, value)``, ``fresh`` masking the
        non-duplicate deliveries."""
        b = values.shape[0]
        self._guard_capacity(self._next_inst_host, b)
        limit = None
        if self.reclaimed_host is not None:
            limit = self.reclaimed_host + self.cfg.n_instances
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
        fields = [f.name for f in dataclasses.fields(MsgBatch)]
        return [
            MsgBatch(*(getattr(stacked, f)[aid] for f in fields)) if self.alive[aid] else None
            for aid in range(self.cfg.n_acceptors)
        ]


class PaxosContext:
    """Drop-in replacement context (the paper's ``paxos_ctx``), one group."""

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
        if mesh is not None:
            raise NotImplementedError(f"the sharded dataplane is not ported yet: {_SHARDED}")
        if self.cfg.n_groups != 1:
            raise NotImplementedError(
                f"multi-group contexts are not ported yet: {_MULTIGROUP}"
            )
        self.deliver_cb = deliver
        self.net = net or SimNet()
        self.hw = HardwareDataplane(self.cfg, use_kernels=use_kernels, device=device)
        self.fused = fused
        self.group_log: list[list[tuple[int, bytes]]] = [[]]
        self._delivered_seqs: set = set()
        self.retransmit_after = retransmit_after
        self.n_learners = n_learners
        # learner state (software role), one per learner
        self.learned: list[dict[int, bytes]] = [dict() for _ in range(n_learners)]
        self._partial: list[dict[int, dict[int, tuple[int, bytes]]]] = [
            dict() for _ in range(n_learners)
        ]
        self.delivered_log: list[tuple[int, bytes]] = []
        self._pending: dict[Any, _Pending] = {}  # client seq -> payload
        self._next_client_seq = 0
        self._next_epoch = 1  # round-allocator epochs
        self._softco: SoftCoordinator | None = None  # failover coordinator
        # snapshots: the rings are watermark-gated (no silent overwrite on
        # wrap) and ``snapshot_group`` drains the delivered prefix
        self.snapshots: SnapshotStore | None = None
        if snapshots:
            if not self.fused:
                # the drain source is the device learner ring, which only
                # the fused wire path maintains
                raise ValueError("snapshots require the fused wire path (fused=True)")
            self.snapshots = SnapshotStore(self.hw.device)
            self.hw.enable_reclamation()
        self.stats = {"submitted": 0, "delivered": 0, "retransmits": 0}

    # -- paper API -----------------------------------------------------------
    def _check_group(self, group: int) -> None:
        if group != 0:
            raise ValueError(f"group {group} out of range [0, 1)")

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

    def _deliver(self, inst: int, raw: bytes) -> None:
        """The delivery contract: discard internal fillers, suppress
        duplicates (a retransmit decided twice, paper §3.1), settle the
        pending entry, log, and fire the application callback."""
        words = np.frombuffer(raw, "<i4")
        if words[0] == NOP_SENTINEL:
            return  # internal filler, discarded by the library
        seq = int(words[0])
        if seq in self._delivered_seqs:
            return
        self._delivered_seqs.add(seq)
        payload = raw[8 : 8 + int(words[1])]
        self._pending.pop(seq, None)
        self.delivered_log.append((inst, payload))
        self.group_log[0].append((inst, payload))
        self.stats["delivered"] += 1
        if self.deliver_cb:
            self.deliver_cb(payload, len(payload), inst)

    def _retransmit(self) -> None:
        for seq, p in list(self._pending.items()):
            p.age += 1
            if p.age >= self.retransmit_after:
                p.age = 0
                self.stats["retransmits"] += 1
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
        any) stitched before the live ``group_log``."""
        self._check_group(gid)
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
        seq_mark = hw._next_inst_host
        ld = hw.lstate.delivered.cpu().numpy()
        li = hw.lstate.inst.cpu().numpy()
        lv = hw.lstate.value.cpu().numpy()
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
        hw.set_reclaimed(upto)
        return store.snapshot(gid)

    def crash_acceptor(self, aid: int, group: int = 0) -> None:
        """Crash an acceptor WITH state loss: liveness drops and its register
        file is reset.  Revive with ``restore_acceptor``."""
        self._check_group(group)
        self.hw.kill_acceptor(aid)
        self.hw.wipe_acceptor(aid)

    def restore_acceptor(self, aid: int, group: int = 0) -> int:
        """Revive a crashed acceptor by state transfer: instances below the
        snapshot watermark are covered by the sealed snapshot, and the live
        ring suffix's decided instances are adopted from the learner ring.
        Returns the number of adopted ring slots."""
        from .failover import restore_acceptor as _restore

        self._check_group(group)
        wm = self.snapshots.watermark(group) if self.snapshots else 0
        return _restore(self.hw, aid, watermark=wm)

    # -- failover ------------------------------------------------------------
    def fail_coordinator(self, est_next_inst: int | None = None, group: int = 0):
        """The hardware coordinator dies and a software coordinator takes
        over by the safe procedure (``core.failover.takeover``): a unique
        higher round, a Phase-1 scan of the window around the (possibly
        stale) watermark estimate, re-proposal of every voted value found."""
        from .failover import takeover

        self._check_group(group)
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

    def restore_hardware_coordinator(self, group: int = 0) -> None:
        self._check_group(group)
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

    def _soft_p2a(self, co: SoftCoordinator, vals: np.ndarray, active: np.ndarray) -> MsgBatch:
        """Software-coordinator sequencing: bind a burst to the coordinator's
        next window."""
        b = vals.shape[0]
        dev = self.hw.device
        inst = np.arange(co.next_inst, co.next_inst + b, dtype=np.int32)
        co.next_inst += b
        return MsgBatch(
            msgtype=torch.from_numpy(np.where(active, MSG_P2A, MSG_NOP).astype(np.int32)).to(dev),
            inst=torch.from_numpy(inst).to(dev),
            rnd=torch.full((b,), co.crnd, dtype=I32, device=dev),
            vrnd=torch.full((b,), NO_ROUND, dtype=I32, device=dev),
            swid=torch.full((b,), co.cid, dtype=I32, device=dev),
            value=torch.from_numpy(np.ascontiguousarray(vals, np.int32)).to(dev),
        )

    def _run_recover(self, inst: int, nop: bytes) -> None:
        """Phase 1 + Phase 2 for one instance with a no-op value (paper
        §3.1); decided votes fan out to the software learners over SimNet."""
        for aid, v in enumerate(self._recover_votes(inst, nop) or []):
            if v is None:
                continue
            for lid in range(self.n_learners):
                self.net.send(("learner", lid), ("votes", aid, _to_host(v)))

    def _recover_votes(self, inst: int, nop: bytes) -> list[MsgBatch | None] | None:
        """Phase-1 scan one instance, choose the required value (a discovered
        vote, else the no-op), Phase-2 it, and return the per-acceptor vote
        batches (None = no quorum of promises)."""
        from .failover import allocate_round

        epoch = self._next_epoch
        self._next_epoch += 1
        crnd = allocate_round(epoch, coordinator_id=2)
        b = self.cfg.batch
        dev = self.hw.device
        # fillers carry a contiguous window starting at the target, so the
        # batch addresses distinct ring slots; at NO_ROUND they never accept
        window = torch.arange(inst, inst + b, dtype=I32, device=dev)
        p1a = MsgBatch.nop(b, self.cfg.value_words, dev).replace(inst=window)
        p1a.msgtype[0] = MSG_P1A
        p1a.rnd[0] = crnd
        best: tuple[int, bytes | None] = (NO_ROUND, None)
        got = 0
        for v in self.hw.prepare(p1a):
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
        p2a = MsgBatch.nop(b, self.cfg.value_words, dev).replace(inst=window)
        p2a.msgtype[0] = MSG_P2A
        p2a.rnd[0] = crnd
        p2a.value[0] = torch.from_numpy(value_words)
        return self.hw.vote(p2a)


def _to_host(m: MsgBatch) -> dict:
    return {
        "msgtype": m.msgtype.cpu().numpy(),
        "inst": m.inst.cpu().numpy(),
        "rnd": m.rnd.cpu().numpy(),
        "vrnd": m.vrnd.cpu().numpy(),
        "swid": m.swid.cpu().numpy(),
        "value": m.value.cpu().numpy(),
    }
