"""Deterministic simulated message fabric with UDP-like fault injection.

The paper's deployment carries Paxos headers in UDP datagrams: messages can
be dropped, duplicated, and reordered.  The device dataplane is reliable, so
loss lives at the host boundary — which is exactly where this simulator sits
(between host-side role steps).  Faults are driven by a seeded RNG so every
adversarial schedule is reproducible; this is a copy of ``repro.core.network``,
so equal seeds give equal fault schedules in both packages.

Two fault modes:

* **Legacy (default)** — one shared RNG stream; each send consumes draws in
  arrival order.  Reproducible for a fixed schedule, but any change to the
  *interleaving* of sends (e.g. one multi-group fabric vs. G single-group
  twins) shifts every later decision.

* **Keyed** (pass ``key_fn``) — fault decisions are a pure function of
  ``(seed, message key, occurrence index)``: the same logical message suffers
  the same fate no matter how traffic from other endpoints interleaves.
  This is what lets chaos tests bit-compare a lossy multi-group fabric
  against independent per-group twins — ``key_fn`` must exclude any
  group-routing tag that differs between the two topologies while the
  payloads themselves stay distinct.  Keyed reordering is a deterministic
  defer-one-pump: the message sits out the current ``recv_all`` and rejoins
  the front of the queue for the next one (UDP reordering collapsed to its
  observable effect — a message overtaken by its successors).
"""
from __future__ import annotations

import dataclasses
import random
from collections import defaultdict, deque
from typing import Any
from collections.abc import Callable, Hashable


@dataclasses.dataclass
class FaultSpec:
    drop: float = 0.0       # probability a message is dropped
    dup: float = 0.0        # probability a message is duplicated
    reorder: float = 0.0    # probability a message is queued out of order

    def __post_init__(self) -> None:
        for name in ("drop", "dup", "reorder"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"FaultSpec.{name} must be a probability in [0, 1], "
                    f"got {p!r}"
                )


class SimNet:
    """Point-to-point queues between named endpoints with fault injection."""

    def __init__(
        self,
        faults: FaultSpec | None = None,
        seed: int = 0,
        key_fn: Callable[[Hashable, Any], Hashable] | None = None,
    ):
        self.faults = faults or FaultSpec()
        self.seed = seed
        self.rng = random.Random(seed)
        self.key_fn = key_fn
        self.queues: dict[Hashable, deque[Any]] = defaultdict(deque)
        # keyed mode: per-(dst-key) occurrence counters (retransmits of the
        # same logical message get independent fates) and the defer-one-pump
        # side queue that realizes reordering
        self._occurrence: dict[Hashable, int] = defaultdict(int)
        self._deferred: dict[Hashable, list[Any]] = defaultdict(list)
        self.sent = 0
        self.dropped = 0
        self.partitioned: set = set()   # endpoints cut off from the fabric

    def partition(self, endpoint: Hashable, cut: bool = True) -> None:
        if cut:
            self.partitioned.add(endpoint)
        else:
            self.partitioned.discard(endpoint)

    # -- keyed fault decisions ----------------------------------------------
    def _fate(self, dst: Hashable, msg: Any) -> tuple[bool, bool, bool]:
        """(drop, dup, reorder) for one keyed send — a pure function of the
        seed, the message key and its occurrence index, independent of how
        other endpoints' traffic interleaves."""
        key = self.key_fn(dst, msg)  # type: ignore[misc]
        occ = self._occurrence[(dst, key)]
        self._occurrence[(dst, key)] = occ + 1
        # str seeds hash process-stably (unlike object identity); one fresh
        # Random per decision keeps draws independent of draw *order*
        r = random.Random(f"{self.seed}|{occ}|{key!r}")
        return (
            r.random() < self.faults.drop,
            r.random() < self.faults.dup,
            r.random() < self.faults.reorder,
        )

    def send(self, dst: Hashable, msg: Any) -> None:
        self.sent += 1
        if dst in self.partitioned:
            self.dropped += 1
            return
        if self.key_fn is not None:
            drop, dup, reorder = self._fate(dst, msg)
            if drop:
                self.dropped += 1
                return
            copies = 2 if dup else 1
            target = self._deferred[dst] if reorder else self.queues[dst]
            for _ in range(copies):
                target.append(msg)
            return
        if self.rng.random() < self.faults.drop:
            self.dropped += 1
            return
        copies = 2 if self.rng.random() < self.faults.dup else 1
        q = self.queues[dst]
        for _ in range(copies):
            if q and self.rng.random() < self.faults.reorder:
                pos = self.rng.randrange(len(q) + 1)
                q.insert(pos, msg)
            else:
                q.append(msg)

    def purge(self, dst: Hashable, predicate) -> int:
        """Drop every queued message at ``dst`` matching ``predicate``;
        returns the number dropped.  Models an endpoint flushing traffic
        that became undeliverable (e.g. addressed to a retired consensus
        group) without disturbing queue order for the survivors."""
        q = self.queues[dst]
        keep = [m for m in q if not predicate(m)]
        n = len(q) - len(keep)
        q.clear()
        q.extend(keep)
        d = self._deferred.get(dst)
        if d:
            dkeep = [m for m in d if not predicate(m)]
            n += len(d) - len(dkeep)
            self._deferred[dst] = dkeep
        self.dropped += n
        return n

    def recv(self, dst: Hashable) -> Any | None:
        q = self.queues[dst]
        return q.popleft() if q else None

    def recv_all(self, dst: Hashable) -> list[Any]:
        q = self.queues[dst]
        out = list(q)
        q.clear()
        # deferred (reordered) messages sat out this pump; they lead the
        # next one — overtaken by everything delivered above
        d = self._deferred.get(dst)
        if d:
            q.extend(d)
            d.clear()
        return out

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values()) + sum(
            len(d) for d in self._deferred.values()
        )
