"""K3: the CAANS coordinator (monotonic sequencer), a CUDA kernel.

``coordinator_sequence_window`` launches ``csrc/coordinator.cu``, which
replaces the TPU kernel ``repro.kernels.coordinator.coordinator_sequence_window``:
it stamps a burst of B proposals with ``msgtype = active ? P2A : NOP``,
``inst = next_inst + iota(B)`` (int32, wrapping), ``rnd = crnd``,
``vrnd = NO_ROUND`` and ``swid = 0``, and writes the advanced watermark
``next_inst + B``, all in one launch.  Its plain version is
``repro_torch.core.batched.coordinator_sequence``; ``kernels.ops.coordinator_sequence``
chooses between the two by the device of the tensors.  Any B is served.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of the kernel in this process; reset by whoever reads it
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("coordinator").coordinator_sequence
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def coordinator_sequence_window(
    next_inst: torch.Tensor,  # int32[]  watermark
    crnd: torch.Tensor,  # int32[]  coordinator round
    active: torch.Tensor,  # bool[B]
) -> tuple[torch.Tensor, ...]:
    """Sequence one burst on the card.  Returns ``(msgtype[B], inst[B],
    rnd[B], vrnd[B], swid[B], next_inst')``, all new int32 tensors;
    ``next_inst'`` is the 0-d advanced watermark."""
    global launches
    dev = active.device
    _build.on_card("coordinator_sequence_window", dev)
    (b,) = active.shape
    if b < 1:
        raise ValueError("coordinator_sequence_window needs a burst of at least one lane")
    i32 = torch.int32
    for name, t, dtype, shape in (
        ("next_inst", next_inst, i32, ()),
        ("crnd", crnd, i32, ()),
        ("active", active, torch.bool, (b,)),
    ):
        _build.require("coordinator_sequence_window", name, t, dtype, shape, dev)
    msgtype, inst, rnd, vrnd, swid = torch.empty((5, b), dtype=i32, device=dev).unbind(0)
    next_out = torch.empty((), dtype=i32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            next_inst.data_ptr(), crnd.data_ptr(), active.data_ptr(), b,
            msgtype.data_ptr(), inst.data_ptr(), rnd.data_ptr(), vrnd.data_ptr(),
            swid.data_ptr(), next_out.data_ptr(), stream,
        )  # fmt: skip
    _build.check(rc, "coordinator_sequence_window launch")
    launches += 1
    return msgtype, inst, rnd, vrnd, swid, next_out
