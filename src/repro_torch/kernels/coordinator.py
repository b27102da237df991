"""K3: the CAANS coordinator (monotonic sequencer), a CUDA kernel.

``coordinator_sequence_window`` launches ``csrc/coordinator.cu``, which
replaces the TPU kernel ``repro.kernels.coordinator.coordinator_sequence_window``:
it stamps a burst of B proposals with ``msgtype = active ? P2A : NOP``,
``inst = next_inst + iota(B)`` (int32, wrapping), ``rnd = crnd``,
``vrnd = NO_ROUND`` and ``swid = 0``, and writes the advanced watermark
``next_inst + B``, all in one launch.  Its plain version is
``repro_torch.core.batched.coordinator_sequence``; ``kernels.ops.coordinator_sequence``
chooses between the two by the device of the tensors.  Any B is served,
one thread a lane, in the launch that ``sequence_geometry`` lays out.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.analysis.contracts import Binding

from . import _build

THREADS = 128  # threads a block at most

# launches of the kernel in this process; reset by whoever reads it
launches = 0

_fn = None


@dataclass(frozen=True)
class SequenceGeometry:
    """How K3 launches: threads a block and the grid, a thread a lane."""

    block: int
    grid: tuple[int]


def sequence_geometry(b: int) -> SequenceGeometry:
    """The launch that sequences a burst of ``b`` lanes: whole warps a
    block, at most ``THREADS``, as few blocks as cover the burst."""
    if b < 1:
        raise ValueError("coordinator_sequence_window needs a burst of at least one lane")
    block = min(THREADS, -(-b // 32) * 32)
    return SequenceGeometry(block, (-(-b // block),))


def _bind(lib, entry: str):
    fn = getattr(lib, entry)
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_int, p, p, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


BINDINGS = (Binding("coordinator", "coordinator_sequence", _bind),)


def _kernel():
    global _fn
    if _fn is None:
        _fn = BINDINGS[0].load(_build.library)
    return _fn


def coordinator_sequence_window(
    next_inst: torch.Tensor,  # int32[]  watermark
    crnd: torch.Tensor,  # int32[]  coordinator round
    active: torch.Tensor,  # bool[B]
) -> tuple[torch.Tensor, ...]:
    """Sequence one burst on the card.  Returns ``(msgtype[B], inst[B],
    rnd[B], vrnd[B], swid[B], next_inst')``, all new int32 tensors (the
    five fields are rows of one ``(5, B)`` tensor); ``next_inst'`` is the
    0-d advanced watermark."""
    global launches
    dev = active.device
    _build.on_card("coordinator_sequence_window", dev)
    (b,) = active.shape
    geo = sequence_geometry(b)
    i32 = torch.int32
    for name, t, dtype, shape in (
        ("next_inst", next_inst, i32, ()),
        ("crnd", crnd, i32, ()),
        ("active", active, torch.bool, (b,)),
    ):
        _build.require("coordinator_sequence_window", name, t, dtype, shape, dev)
    out = torch.empty((5, b), dtype=i32, device=dev)
    next_out = torch.empty((), dtype=i32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(next_inst.data_ptr(), crnd.data_ptr(), active.data_ptr(), b, out.data_ptr(),
                next_out.data_ptr(), geo.block, geo.grid[0], stream)  # fmt: skip
    _build.check(rc, "coordinator_sequence_window launch")
    launches += 1
    return (*out.unbind(0), next_out)
