"""Carry a dataplane's state across packages through numpy.

``export_state`` reads a ``HardwareDataplane`` or a ``MultiGroupDataplane``
into a dict of numpy arrays under the reference's field names;
``import_state`` loads such a dict into the port's dataplane of the same
kind in place.  ``export_state`` only reads attributes by those names, so
it reads the reference's dataplanes just as well: their state, loaded into
the port, runs on identically.

Keys of both: ``cstate.next_inst``, ``cstate.crnd``, ``stack.rnd``,
``stack.vrnd``, ``stack.value``, ``lstate.delivered``, ``lstate.inst``,
``lstate.value``, ``alive``, ``next_inst_host`` (the host watermark mirror)
and ``reclaimed_host`` (the reclamation marks, -1 while reclamation is off).
A multi-group dataplane's arrays carry a leading group axis, and it adds its
host mirrors ``crnd_host``, ``live_host`` and ``free`` (the free-list).

A groups-sharded dataplane keeps one slab per shard, each on its shard's
device: ``export_state`` reads them through its ``gather``, into ``(G,
...)`` arrays in slot order, the reference's global arrays, and adds
``slot_of`` (its placement); ``import_state`` writes such arrays back
through its ``scatter``, onto each shard's device in place, under the
placement ``slot_of`` gives (the identity without it, as in an unsharded
dataplane's state).
"""

from __future__ import annotations

import numpy as np
import torch

from .types import CoordinatorState

_TENSORS = (
    "stack.rnd",
    "stack.vrnd",
    "stack.value",
    "lstate.delivered",
    "lstate.inst",
    "lstate.value",
)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)  # any array with __array__ (the reference's), copied


def _get(hw, key: str):
    obj, field = key.split(".")
    return getattr(getattr(hw, obj), field)


def _grouped(hw) -> bool:
    return hasattr(hw, "next_inst_host")


def _sharded(hw) -> bool:
    """The port's groups-sharded dataplane: one slab per shard."""
    return hasattr(hw, "stacks")


def export_state(hw) -> dict[str, np.ndarray]:
    """The dataplane's device state and host marks as numpy copies."""
    out = {key: _np(_get(hw, key)) for key in ("cstate.next_inst", "cstate.crnd")}
    if _sharded(hw):
        out.update(hw.gather(), slot_of=np.array(hw.placement.slot_of, np.int64))
    else:
        out.update({key: _np(_get(hw, key)) for key in _TENSORS})
    out["alive"] = _np(hw.alive_mask).astype(bool)
    marked = hw.reclaimed_host
    if not _grouped(hw):
        out["next_inst_host"] = np.array(hw._next_inst_host, np.int64)
        out["reclaimed_host"] = np.array(-1 if marked is None else marked, np.int64)
        return out
    g = len(hw.next_inst_host)
    out["next_inst_host"] = np.array(hw.next_inst_host, np.int64)
    out["crnd_host"] = np.array(hw.crnd_host, np.int64)
    out["live_host"] = np.array(hw.live_host, bool)
    out["free"] = np.array(hw._free, np.int64)
    out["reclaimed_host"] = np.array([-1] * g if marked is None else marked, np.int64)
    return out


def _load_device_state(hw, arrays: dict[str, np.ndarray]) -> None:
    """An unsharded dataplane's device state: its slabs, its liveness mask
    and its watermark and round."""
    for key in _TENSORS:
        dst = _get(hw, key)
        src = torch.from_numpy(np.asarray(arrays[key], np.int32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
        dst.copy_(src)
    hw.alive_mask.copy_(torch.from_numpy(np.asarray(arrays["alive"], bool)))
    cstate = [np.asarray(arrays[k], np.int32) for k in ("cstate.next_inst", "cstate.crnd")]
    if _grouped(hw):
        hw.cstate = CoordinatorState(*(torch.from_numpy(x).to(hw.device) for x in cstate))
    else:
        hw.cstate = CoordinatorState.init(
            next_inst=int(cstate[0]), crnd=int(cstate[1]), device=hw.device
        )


def import_state(hw, arrays: dict[str, np.ndarray]) -> None:
    """Load ``arrays`` (as ``export_state`` gives them) into the port's
    ``hw`` in place; shapes must match its configuration."""
    if _sharded(hw):
        hw.scatter(arrays)  # its slabs, placement, host-held cstate and liveness
    else:
        _load_device_state(hw, arrays)
    alive = np.asarray(arrays["alive"], bool)
    marks = [int(m) for m in np.asarray(arrays["reclaimed_host"]).reshape(-1)]
    hw._reclaim_marks = None if marks[0] < 0 else marks
    if not _grouped(hw):
        hw.alive = [bool(a) for a in alive]
        hw._next_inst_host = int(arrays["next_inst_host"])
        return
    hw.alive = [[bool(a) for a in row] for row in alive]
    hw.next_inst_host = [int(x) for x in arrays["next_inst_host"]]
    hw.crnd_host = [int(x) for x in arrays["crnd_host"]]
    hw.live_host = [bool(x) for x in arrays["live_host"]]
    hw._free = [int(x) for x in arrays["free"]]
