"""Replicated log on top of the consensus layer.

The paper's memory-limitation discussion (§3.1): acceptors keep a bounded
instance ring; applications checkpoint and then ``trim`` the log once ``f+1``
learners acknowledge an instance watermark.  This module provides the ordered
log view a state-machine-replication application consumes, gap detection
(feeding ``recover``), and the trim protocol.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable


@dataclasses.dataclass
class LogEntry:
    inst: int
    payload: bytes


class ReplicatedLog:
    """In-order delivery + gap tracking + quorum trim."""

    def __init__(self, n_learners: int = 1, quorum: int = 2):
        self.entries: dict[int, bytes] = {}
        self.apply_watermark = 0          # next instance to apply, in order
        self.trim_watermark = 0           # everything below is trimmed
        self.quorum = quorum
        self._trim_acks: dict[int, set] = {}
        self.applied: list[LogEntry] = []
        self.on_apply: Callable[[int, bytes], None] | None = None

    def offer(self, inst: int, payload: bytes) -> None:
        """A learner delivered (inst, payload)."""
        if inst < self.trim_watermark or inst in self.entries:
            return
        self.entries[inst] = payload
        self._drain()

    def _drain(self) -> None:
        while self.apply_watermark in self.entries:
            inst = self.apply_watermark
            payload = self.entries[inst]
            self.applied.append(LogEntry(inst, payload))
            if self.on_apply:
                self.on_apply(inst, payload)
            self.apply_watermark += 1

    def gaps(self, horizon: int) -> list[int]:
        """Instances < horizon not yet offered — candidates for recover()."""
        return [
            i
            for i in range(self.apply_watermark, horizon)
            if i not in self.entries and i >= self.trim_watermark
        ]

    # -- trim protocol (paper: f+1 learners ack a checkpointed watermark) ----
    def ack_trim(self, learner_id: int, upto: int) -> bool:
        """Record a learner's checkpoint ack; trims once quorum is reached."""
        acks = self._trim_acks.setdefault(upto, set())
        acks.add(learner_id)
        if len(acks) >= self.quorum and upto <= self.apply_watermark:
            self._trim(upto)
            return True
        return False

    def _trim(self, upto: int) -> None:
        for i in range(self.trim_watermark, upto):
            self.entries.pop(i, None)
        self.trim_watermark = max(self.trim_watermark, upto)
        self._trim_acks = {k: v for k, v in self._trim_acks.items() if k > upto}
