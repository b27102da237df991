"""Carry a single-group dataplane's state across packages through numpy.

``export_state`` reads a ``HardwareDataplane`` into a dict of numpy arrays
under the reference's field names; ``import_state`` loads such a dict into
the port's dataplane in place.  ``export_state`` only reads attributes by
those names, so it reads the reference's ``repro.core.HardwareDataplane``
just as well: its state, loaded into the port, runs on identically.

Keys: ``cstate.next_inst``, ``cstate.crnd``, ``stack.rnd``, ``stack.vrnd``,
``stack.value``, ``lstate.delivered``, ``lstate.inst``, ``lstate.value``,
``alive``, ``next_inst_host`` (the host watermark mirror) and
``reclaimed_host`` (the reclamation mark, -1 while reclamation is off).
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


def export_state(hw) -> dict[str, np.ndarray]:
    """The dataplane's device state and host marks as numpy copies."""
    out = {key: _np(_get(hw, key)) for key in ("cstate.next_inst", "cstate.crnd", *_TENSORS)}
    out["alive"] = _np(hw.alive_mask).astype(bool)
    out["next_inst_host"] = np.array(hw._next_inst_host, np.int64)
    marked = hw.reclaimed_host
    out["reclaimed_host"] = np.array(-1 if marked is None else marked, np.int64)
    return out


def import_state(hw, arrays: dict[str, np.ndarray]) -> None:
    """Load ``arrays`` (as ``export_state`` gives them) into the port's
    ``hw`` in place; shapes must match its configuration."""
    for key in _TENSORS:
        dst = _get(hw, key)
        src = torch.from_numpy(np.asarray(arrays[key], np.int32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
        dst.copy_(src)
    hw.cstate = CoordinatorState.init(
        crnd=int(arrays["cstate.crnd"]),
        next_inst=int(arrays["cstate.next_inst"]),
        device=hw.device,
    )
    alive = np.asarray(arrays["alive"], bool)
    hw.alive = [bool(a) for a in alive]
    hw.alive_mask.copy_(torch.from_numpy(alive))
    hw._next_inst_host = int(arrays["next_inst_host"])
    mark = int(arrays["reclaimed_host"])
    hw._reclaim_marks = None if mark < 0 else [mark]
