"""K8: the learner's quorum over the acceptors' vote batches, a CUDA kernel,
with its plain version.

``learner_quorum_window`` launches ``csrc/learner.cu``, which replaces the
TPU kernel ``repro.kernels.learner.learner_quorum_window``: for each lane of
A position-aligned vote batches, ``win`` is the highest vrnd among the P2B
votes (NO_ROUND if none), ``deliver`` (int32 0/1) says whether at least
``quorum`` P2B votes carry ``win``, and ``value`` is the first agreeing
acceptor's value, **0 where no acceptor agrees**.  A team of threads
serves a lane and loads every vote, and its value chunk of the first
``VOTE_CAP`` acceptors' values, before it decides (``csrc/learner.cu``'s
header), in the variant, team and block that
``kernels.wirepath.lane_geometry`` chooses from V and the alignment of the
vote values and the output (``geometry``); its launches count in
``kernels.wirepath.vector_launches`` and ``scalar_launches`` too.

``learner_quorum_plain`` is the same function in plain PyTorch, a twin of
the reference's ``repro.kernels.ref.learner_quorum_window``.  It is not
``repro_torch.core.batched.learner_quorum``, which twins the reference's
``batched.learner_quorum`` and returns acceptor 0's value on a lane where
no acceptor agrees; votes the system makes carry value 0 on REJECT, so the
two differ only on foreign inputs.  ``kernels.ops.learner_quorum`` chooses
between kernel and plain version by the device of the tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.contracts import Binding
from repro_torch.core.types import MSG_P2B, NO_ROUND

from . import _build
from . import wirepath as _wirepath

# acceptors whose votes and value chunk a thread loads before it decides
# (csrc/learner.cu's VOTE_CAP); above it the kernel reloads where it must
VOTE_CAP = 8

# launches of the kernel in this process; reset by whoever reads it
launches = 0

_fn = None


def _bind(lib, entry: str):
    fn = getattr(lib, entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, i, i, p, p, p, p, p, p, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


BINDINGS = (Binding("learner", "learner_quorum", _bind),)


def _kernel():
    global _fn
    if _fn is None:
        _fn = BINDINGS[0].load(_build.library)
    return _fn


def geometry(vote_val: torch.Tensor, value: torch.Tensor) -> _wirepath.LaneGeometry:
    """K8's launch for these value tensors: ``lane_geometry`` at one row of
    ``B`` lanes, the vector variant only where the vote values and the
    output both start on 16 bytes."""
    _, b, v = vote_val.shape
    return _wirepath._lanes(v, b, 1, vote_val, value)


def learner_quorum_window(
    quorum: int,
    vote_type: torch.Tensor,  # int32[A, B]
    vote_vrnd: torch.Tensor,  # int32[A, B]
    vote_val: torch.Tensor,  # int32[A, B, V]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The quorum on the card, a team of threads a lane.  Returns
    ``(deliver[B] int32 0/1, win_vrnd[B], value[B, V])``, new tensors."""
    global launches
    what = "learner_quorum_window"
    dev = vote_val.device
    _build.on_card(what, dev)
    a, b, v = vote_val.shape
    if a < 1 or b < 1:
        raise ValueError(f"{what} needs at least one acceptor and one lane, got {a}, {b}")
    _build.require(what, "vote_type", vote_type, torch.int32, (a, b), dev)
    _build.require(what, "vote_vrnd", vote_vrnd, torch.int32, (a, b), dev)
    _build.require(what, "vote_val", vote_val, torch.int32, (a, b, v), dev)
    deliver, win = torch.empty((2, b), dtype=torch.int32, device=dev).unbind(0)
    value = torch.empty((b, v), dtype=torch.int32, device=dev)
    geo = geometry(vote_val, value)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            int(quorum), a, b, v, vote_type.data_ptr(), vote_vrnd.data_ptr(),
            vote_val.data_ptr(), deliver.data_ptr(), win.data_ptr(), value.data_ptr(),
            geo.variant == "vector", geo.team, geo.block, stream,
        )  # fmt: skip
    _wirepath._launched(geo, rc, f"{what} launch")
    launches += 1
    return deliver, win, value


def learner_quorum_plain(
    quorum: int,
    vote_type: torch.Tensor,  # int32[A, B]
    vote_vrnd: torch.Tensor,  # int32[A, B]
    vote_val: torch.Tensor,  # int32[A, B, V]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same quorum in plain PyTorch, on any device."""
    is_vote = vote_type == MSG_P2B
    win = torch.where(is_vote, vote_vrnd, NO_ROUND).amax(dim=0)
    agree = is_vote & (vote_vrnd == win[None, :])
    deliver = (agree.to(torch.int32).sum(dim=0) >= quorum).to(torch.int32)
    first = agree.to(torch.int32).argmax(dim=0)  # first agreeing acceptor, if any
    cols = torch.arange(vote_val.shape[1], device=vote_val.device)
    value = torch.where(agree.any(dim=0)[:, None], vote_val[first, cols], 0)
    return deliver, win, value
