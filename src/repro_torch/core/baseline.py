"""The software baseline — a "libpaxos-like" all-software deployment.

The paper benchmarks CAANS against libpaxos (Fig. 2, Fig. 7): every role runs
as a software process exchanging UDP messages.  Here, every role runs as a
scalar-Python state machine (``core.paxos``) exchanging messages over the same
``SimNet``.  Per-role processing time is instrumented so the benchmark suite
can reproduce the paper's CPU-utilization plots (coordinator/acceptor as the
software bottleneck) and the end-to-end comparison.

A copy of ``repro.core.baseline`` for the port, on the port's copies of
``core.paxos`` and ``core.network``: host code only, no device.
"""
from __future__ import annotations

import time
from collections import defaultdict
from collections.abc import Callable

from .network import SimNet
from .paxos import Acceptor, Coordinator, Learner, Proposer
from .types import MSG_P1B, MSG_P2A, MSG_P2B, MSG_SUBMIT, PaxosConfig


class SoftwarePaxos:
    """A full software deployment: 1 proposer, 1 coordinator, 2f+1 acceptors,
    n learners, wired through SimNet.  The comparison baseline."""

    def __init__(
        self,
        cfg: PaxosConfig | None = None,
        deliver: Callable[[bytes, int, int], None] | None = None,
        net: SimNet | None = None,
        n_learners: int = 1,
    ):
        self.cfg = cfg or PaxosConfig()
        self.net = net or SimNet()
        self.proposer = Proposer(pid=0)
        self.coordinator = Coordinator(cid=0, n_instances=self.cfg.n_instances)
        self.acceptors = [
            Acceptor(aid=i, n_instances=self.cfg.n_instances)
            for i in range(self.cfg.n_acceptors)
        ]
        self.alive = [True] * self.cfg.n_acceptors
        self.deliver_cb = deliver
        self.learners = [
            Learner(lid=i, n_acceptors=self.cfg.n_acceptors)
            for i in range(n_learners)
        ]
        self.learners[0].deliver_cb = self._on_deliver
        self.delivered: list[tuple[int, bytes]] = []
        # per-role busy seconds — reproduces the paper's Fig. 2 methodology
        self.busy: dict[str, float] = defaultdict(float)

    def _on_deliver(self, inst: int, value: bytes) -> None:
        self.delivered.append((inst, value))
        if self.deliver_cb:
            self.deliver_cb(value, len(value), inst)

    # -- API ------------------------------------------------------------------
    def submit(self, payload: bytes) -> None:
        t0 = time.perf_counter()
        msg = self.proposer.submit(payload)
        self.busy["proposer"] += time.perf_counter() - t0
        self.net.send("coordinator", msg)

    def pump(self, rounds: int = 1) -> None:
        for _ in range(rounds):
            self._pump_coordinator()
            self._pump_acceptors()
            self._pump_learners()

    def run_until_quiescent(self, max_rounds: int = 64) -> None:
        for _ in range(max_rounds):
            if self.net.pending() == 0:
                return
            self.pump()

    # -- role pumps ------------------------------------------------------------
    def _pump_coordinator(self) -> None:
        for msg in self.net.recv_all("coordinator"):
            t0 = time.perf_counter()
            out = None
            if msg.msgtype == MSG_SUBMIT:
                out = self.coordinator.on_submit(msg)
            elif msg.msgtype == MSG_P1B:
                out = self.coordinator.on_p1b(msg, self.cfg.quorum)
            self.busy["coordinator"] += time.perf_counter() - t0
            if out is not None and out.msgtype == MSG_P2A:
                for aid in range(self.cfg.n_acceptors):
                    self.net.send(("acceptor", aid), out)

    def _pump_acceptors(self) -> None:
        for aid, acc in enumerate(self.acceptors):
            msgs = self.net.recv_all(("acceptor", aid))
            if not self.alive[aid]:
                continue
            for msg in msgs:
                t0 = time.perf_counter()
                if msg.msgtype == MSG_P2A:
                    out = acc.on_p2a(msg)
                else:
                    out = acc.on_p1a(msg)
                self.busy["acceptor"] += time.perf_counter() - t0
                if out.msgtype == MSG_P2B:
                    for lid in range(len(self.learners)):
                        self.net.send(("learner", lid), out)
                elif out.msgtype == MSG_P1B:
                    self.net.send("coordinator", out)

    def _pump_learners(self) -> None:
        for lid, ln in enumerate(self.learners):
            for msg in self.net.recv_all(("learner", lid)):
                t0 = time.perf_counter()
                ln.on_p2b(msg)
                self.busy["learner"] += time.perf_counter() - t0

    # -- fault injection ---------------------------------------------------------
    def kill_acceptor(self, aid: int) -> None:
        self.alive[aid] = False

    def revive_acceptor(self, aid: int) -> None:
        self.alive[aid] = True
