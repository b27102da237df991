"""Elastic scaling: membership views and mesh rebuilds.

At 1000+-node scale, node churn is routine.  The membership *view* (the set
of live hosts and the mesh shape built from them) is itself a decided value:
every view change is proposed through the consensus log, so all survivors
agree on the same new mesh before any collective runs on it (a disagreeing
straggler would hang a collective; an agreed view cannot).

`replan_mesh` picks the largest usable mesh from the surviving device
count.  A copy of ``repro.train.elastic`` for the port: ``ViewManager``
wraps the ``deliver_cb`` of any of the port's ``PaxosContext``s.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class MembershipView:
    epoch: int
    hosts: tuple[str, ...]
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]

    def encode(self) -> bytes:
        return json.dumps(
            {
                "epoch": self.epoch,
                "hosts": list(self.hosts),
                "shape": list(self.mesh_shape),
                "axes": list(self.mesh_axes),
            }
        ).encode()

    @classmethod
    def decode(cls, raw: bytes) -> "MembershipView":
        d = json.loads(raw.decode())
        return cls(d["epoch"], tuple(d["hosts"]), tuple(d["shape"]), tuple(d["axes"]))


def replan_mesh(
    n_devices: int, *, model_parallel: int = 16
) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest (data, model) mesh from the surviving device count.

    Keeps the model axis fixed (TP degree is architecture-bound) and shrinks
    the data axis — dropping up to model_parallel-1 devices if the survivor
    count is not a multiple.
    """
    mp = min(model_parallel, n_devices)
    data = max(n_devices // mp, 1)
    return (data, mp), ("data", "model")


class ViewManager:
    """Drives membership-view agreement through the consensus layer."""

    def __init__(self, paxos_ctx, initial: MembershipView):
        self.ctx = paxos_ctx
        self.view = initial
        self._decided: list[MembershipView] = [initial]
        if paxos_ctx is not None:
            orig = paxos_ctx.deliver_cb

            def _cb(value: bytes, size: int, inst: int, _orig=orig):
                if value.startswith(b"view:"):
                    self._on_view(MembershipView.decode(value[5:]))
                if _orig:
                    _orig(value, size, inst)

            paxos_ctx.deliver_cb = _cb

    def _on_view(self, view: MembershipView) -> None:
        if view.epoch > self.view.epoch:
            self.view = view
            self._decided.append(view)

    def propose_view(self, hosts: list[str], model_parallel: int = 16) -> MembershipView:
        shape, axes = replan_mesh(len(hosts), model_parallel=model_parallel)
        view = MembershipView(
            epoch=self.view.epoch + 1,
            hosts=tuple(sorted(hosts)),
            mesh_shape=shape,
            mesh_axes=axes,
        )
        if self.ctx is not None:
            self.ctx.submit(b"view:" + view.encode())
            self.ctx.run_until_quiescent()
        else:
            self._on_view(view)
        return self.view
