"""Host-side snapshot / log-compaction store (the reference's DESIGN.md §9).

The fixed-N instance rings of the CAANS dataplane wrap: instance ``i`` lives
in ring slot ``i % N``, so a service that runs forever re-uses every slot once
per N instances.  Historically nothing reclaimed slots — sequencing past an
undrained slot silently overwrote the learner's dedup state, corrupting the
log.  This module is the host half of the fix:

* ``SnapshotStore`` drains each group's *delivered* ring prefix below a
  watermark into host memory and seals it with
  the digest kernel (``kernels.ops.tree_digest``) so replicas can compare
  snapshots by one
  integer instead of trusting a transfer (the BFT-motivated divergence
  check).  The sealed prefix is also the compaction substrate: the context
  moves its host ``group_log`` prefix here and ``delivered()`` stitches
  ``snapshot prefix + live log`` uniformly in steady state.

* ``RingOverflowError`` is the device half's host surface: the reclamation
  limit threaded through the fused round refuses to sequence lanes at
  or past ``watermark + N``, and the dataplane door raises this *before*
  dispatch, naming the boundary instance, so callers schedule a snapshot
  instead of corrupting state.

A snapshot's seal is computed over the **full** drained prefix (instances and
raw value words), never incrementally per drain chunk — replicas that
snapshot at different cadences still agree bit-for-bit once their watermarks
match, which is what makes the seal a divergence check rather than a
drain-schedule fingerprint.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..kernels import ops
from .device import resolve_device


class RingOverflowError(RuntimeError):
    """A burst would sequence into ring slots whose decisions have not been
    drained below the snapshot watermark — explicit backpressure at the
    dataplane door instead of the historical silent dedup-state overwrite.

    ``boundary`` is the first instance the ring cannot hold
    (``reclaimed + N``); ``attempted`` is one past the last instance of the
    refused burst.  ``context`` carries the same facts as a machine-readable
    dict so schedulers can react (snapshot-and-retry, shed the group, alert)
    without parsing the message.
    """

    def __init__(
        self, group: int, base: int, burst: int, boundary: int
    ) -> None:
        self.group = group
        self.base = base
        self.burst = burst
        self.boundary = boundary
        self.attempted = base + burst
        self.context = {
            "group": group,
            "base": base,
            "burst": burst,
            "boundary": boundary,
            "attempted": base + burst,
        }
        super().__init__(
            f"ring overflow: group {group} burst [{base}, {base + burst}) "
            f"passes the reclaim boundary {boundary} — snapshot the "
            f"delivered prefix to advance the watermark"
        )


class RingReclamationMixin:
    """Watermark-gated ring reclamation: the ONE door-guard contract every
    dataplane shares (DESIGN.md §9).

    Contract:

    * Disabled by default (``_reclaim_marks is None``): rings silently
      overwrite on wrap — the legacy mode unbounded-twin oracles rely on.
    * ``enable_reclamation()`` arms one watermark per group at 0.  From
      then on only instances in ``[mark, mark + N)`` may sequence; a burst
      whose window crosses ``mark + N`` raises :class:`RingOverflowError`
      at the host door *before* any device dispatch, and the reclamation-
      limit vector threaded through the kernels refuses the same lanes
      (defense in depth).
    * ``_reclaim_set`` advances a group's mark after a snapshot drain.
      Marks are monotone and can never pass the group's sequencer
      watermark; both violations raise ``ValueError``.

    A single-group dataplane is the G == 1 degenerate case (group id 0)
    whose public scalar surface adapts onto this vector core.  Subclasses
    provide ``cfg`` and ``_seq_marks()`` — the per-group sequencer
    watermark host mirrors the window validation reads.
    """

    _reclaim_marks: list[int] | None = None
    # provided by the concrete dataplane (PaxosConfig); declared loose so
    # the mixin stays independent of the host class hierarchy
    cfg: Any

    def _seq_marks(self) -> list[int]:
        raise NotImplementedError

    @property
    def reclamation_enabled(self) -> bool:
        return self._reclaim_marks is not None

    def enable_reclamation(self) -> None:
        """Switch from silent overwrite-on-wrap to watermark-gated rings."""
        if self._reclaim_marks is None:
            self._reclaim_marks = [0] * len(self._seq_marks())

    def _reclaim_set(self, gid: int, upto: int) -> None:
        if self._reclaim_marks is None:
            raise ValueError("reclamation is not enabled on this dataplane")
        lo, hi = self._reclaim_marks[gid], self._seq_marks()[gid]
        if not lo <= upto <= hi:
            raise ValueError(
                f"reclaim watermark {upto} outside [{lo}, {hi}] (group {gid})"
            )
        self._reclaim_marks[gid] = upto

    def _reclaim_limits_np(self) -> np.ndarray | None:
        """int32[G] first-refused-instance vector, or None when disabled:
        the reference's expression, so a mark within N of int32 max wraps
        to a negative limit (numpy int32 addition) exactly as it does."""
        if self._reclaim_marks is None:
            return None
        return np.asarray(self._reclaim_marks, np.int32) + self.cfg.n_instances

    def _reclaim_guard(self, gid: int, base: int, burst: int) -> None:
        if self._reclaim_marks is None:
            return
        boundary = self._reclaim_marks[gid] + self.cfg.n_instances
        if base + burst > boundary:
            raise RingOverflowError(gid, base, burst, boundary)


@dataclasses.dataclass
class GroupSnapshot:
    """One group's sealed snapshot: every decided instance below the
    watermark (including NOP fillers — the seal covers the raw ring words)
    plus the ``tree_digest`` seal over the full prefix."""

    watermark: int
    insts: np.ndarray    # int32[K]     absolute instances, ascending
    values: np.ndarray   # int32[K, V]  raw decided value words
    seal: int


def _seal(insts: np.ndarray, values: np.ndarray, device: torch.device | str) -> int:
    """The digest seal of a drained prefix, computed on ``device`` (the card,
    through the digest kernel, or the CPU, through its plain version)."""
    if insts.size == 0:
        return 0
    leaves = [
        torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device) for a in (insts, values)
    ]
    return ops.tree_digest(leaves)


class SnapshotStore:
    """Per-group sealed snapshot prefixes + compacted host log prefixes.

    Two parallel stores per group id:

    * ``entries`` — the raw drained ring prefix ``(insts, values)``: every
      decided instance below the watermark with its raw value words, NOP
      fillers included.  This is what the seal covers and what a reborn
      group member bootstraps from (it is exactly the device-visible
      history).
    * ``log_prefix`` — the application-level ``(inst, payload)`` list moved
      out of the context's ``group_log``: the compacted half of the stitched
      ``delivered()`` view.

    Seals are computed on ``device``: the card unless the caller passes
    another (the context passes its own).
    """

    def __init__(self, device: torch.device | str | None = None) -> None:
        self.device = resolve_device(device)
        self._insts: dict[int, np.ndarray] = {}
        self._values: dict[int, np.ndarray] = {}
        self._watermark: dict[int, int] = {}
        self._log: dict[int, list[tuple[int, bytes]]] = {}

    # -- watermarks ---------------------------------------------------------
    def watermark(self, gid: int = 0) -> int:
        """First instance NOT covered by this group's snapshot."""
        return self._watermark.get(gid, 0)

    # -- drain --------------------------------------------------------------
    def absorb(
        self, gid: int, insts: np.ndarray, values: np.ndarray, upto: int
    ) -> None:
        """Append a drained ring chunk ``[watermark, upto)`` and advance the
        watermark.  ``insts`` must be ascending and inside the window; gaps
        are legal (undecided instances below the watermark are permanent
        holes — they can never be proposed again)."""
        wm = self.watermark(gid)
        if upto < wm:
            raise ValueError(f"snapshot watermark may not move back: "
                             f"{upto} < {wm} (group {gid})")
        insts = np.asarray(insts, np.int32).reshape((-1,))
        values = np.asarray(values, np.int32)
        if insts.size:
            values = values.reshape((insts.size, -1))
            if np.any(np.diff(insts) <= 0):
                raise ValueError("drained instances must be ascending")
            if int(insts[0]) < wm or int(insts[-1]) >= upto:
                raise ValueError(
                    f"drained instances [{int(insts[0])}, {int(insts[-1])}] "
                    f"outside the window [{wm}, {upto}) (group {gid})"
                )
            if gid in self._insts:
                self._insts[gid] = np.concatenate([self._insts[gid], insts])
                self._values[gid] = np.concatenate(
                    [self._values[gid], values]
                )
            else:
                self._insts[gid] = insts
                self._values[gid] = values
        self._watermark[gid] = upto

    def absorb_log(
        self, gid: int, entries: list[tuple[int, bytes]]
    ) -> None:
        """Append compacted ``(inst, payload)`` host-log entries."""
        self._log.setdefault(gid, []).extend(entries)

    # -- reads --------------------------------------------------------------
    def entries(self, gid: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """The full drained prefix ``(insts, values)`` below the watermark."""
        if gid not in self._insts:
            return (np.zeros((0,), np.int32), np.zeros((0, 0), np.int32))
        return (self._insts[gid], self._values[gid])

    def log_prefix(self, gid: int = 0) -> list[tuple[int, bytes]]:
        """The compacted host-log prefix (for ``delivered()`` stitching)."""
        return self._log.get(gid, [])

    def seal(self, gid: int = 0) -> int:
        """``tree_digest`` over the FULL prefix — chunking-invariant, so two
        replicas agree iff their drained histories agree bit-for-bit."""
        insts, values = self.entries(gid)
        return _seal(insts, values, self.device)

    def snapshot(self, gid: int = 0) -> GroupSnapshot:
        """Sealed, self-contained snapshot of this group (transfer unit)."""
        insts, values = self.entries(gid)
        return GroupSnapshot(
            watermark=self.watermark(gid),
            insts=insts.copy(),
            values=values.copy(),
            seal=_seal(insts, values, self.device),
        )

    # -- transfer / lifecycle ----------------------------------------------
    def seed(
        self,
        gid: int,
        snap: GroupSnapshot,
        log_prefix: list[tuple[int, bytes]] | None = None,
    ) -> None:
        """Install a transferred snapshot under ``gid``, verifying its seal
        (the divergence check: a corrupted or diverged transfer is rejected,
        not trusted).  Used when a freshly created group member bootstraps
        from a peer's snapshot (vertical-Paxos state transfer)."""
        if gid in self._insts or self.watermark(gid):
            raise ValueError(f"group {gid} already has snapshot state")
        insts = np.asarray(snap.insts, np.int32).reshape((-1,))
        values = np.asarray(snap.values, np.int32)
        if insts.size:
            values = values.reshape((insts.size, -1))
        if _seal(insts, values, self.device) != snap.seal:
            raise ValueError(
                f"snapshot seal mismatch for group {gid}: transfer is "
                f"corrupt or replicas diverged"
            )
        if insts.size:
            self._insts[gid] = insts
            self._values[gid] = values
        self._watermark[gid] = int(snap.watermark)
        if log_prefix:
            self._log[gid] = list(log_prefix)

    def reset_group(self, gid: int) -> None:
        """Forget a group's snapshot state (slot retired / recreated)."""
        self._insts.pop(gid, None)
        self._values.pop(gid, None)
        self._watermark.pop(gid, None)
        self._log.pop(gid, None)
