"""K7: one acceptor's Phase-2 vote, a CUDA kernel.

``acceptor_phase2_window`` launches the ``acceptor_phase2`` entry point of
``csrc/vote.cu``, which replaces the TPU kernel
``repro.kernels.acceptor.acceptor_phase2_window``: the paper's per-role
acceptor (Table 1) voting on a batch of Phase-2 headers, its register file
``(N,)``, ``(N,)``, ``(N, V)`` updated in place, ``swid = aid``.  It runs
K2's team body (``kernels.wirepath.acceptor_vote_all_window``) at A = 1 for
an acceptor that is alive, a team of threads a lane, in the variant,
team and block that ``kernels.wirepath.lane_geometry`` chooses from V and
the alignment of the burst, the register file's values and the vote
values (``geometry``); its launches count in
``kernels.wirepath.vector_launches`` and ``scalar_launches`` too.  Its
plain version is ``repro_torch.core.batched.acceptor_phase2``;
``kernels.ops.acceptor_phase2`` chooses between the two by the device of
the tensors.

``acceptor_phase2_witness`` launches the first design, one thread a lane
(``vote_lane``), which no path runs: the card checks hold the team body
against it.

Lane j addresses ring slot ``inst[j] mod N``, so any window base and any
batch of distinct slots is served.  Precondition, as the plain engine's:
the slots are pairwise distinct (so ``B <= N``, which is checked).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.contracts import Binding

from . import _build
from . import wirepath as _wirepath

# launches of the kernel and of the witness in this process; reset by
# whoever reads them
launches = 0
witness_launches = 0

_fns: dict = {}  # entry name -> its ctypes function


def _bind(lib, entry: str):
    """``acceptor_phase2`` (with its launch shape) or
    ``acceptor_phase2_witness``, both of ``csrc/vote.cu``."""
    fn = getattr(lib, entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    shape = [i, i, i] if entry == "acceptor_phase2" else []
    fn.argtypes = [i, i, i, i, *[p] * 13, *shape, p]
    fn.restype = ctypes.c_int
    return fn


BINDINGS = tuple(Binding("vote", e, _bind) for e in ("acceptor_phase2", "acceptor_phase2_witness"))


def _kernel(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        fn = _fns[entry] = next(b for b in BINDINGS if b.entry == entry).load(_build.library)
    return fn


def geometry(
    msg_val: torch.Tensor, st_val: torch.Tensor, vote_val: torch.Tensor
) -> _wirepath.LaneGeometry:
    """K7's launch for these value tensors: ``lane_geometry`` at one row,
    the vector variant only where all three start on 16 bytes."""
    b, v = msg_val.shape
    return _wirepath._lanes(v, b, 1, msg_val, st_val, vote_val)


def _io(what, st_rnd, st_vrnd, st_val, msgtype, inst, msg_rnd, msg_val) -> list[torch.Tensor]:
    (n,) = st_rnd.shape
    votes = _wirepath.vote_io(what, (), n, msgtype, inst, msg_rnd, msg_val)
    dev, v = msg_val.device, msg_val.shape[1]
    _build.require(what, "st_rnd", st_rnd, torch.int32, (n,), dev)
    _build.require(what, "st_vrnd", st_vrnd, torch.int32, (n,), dev)
    _build.require(what, "st_val", st_val, torch.int32, (n, v), dev)
    return votes


def _launch(entry, shape, aid, st, msgtype, inst, msg_rnd, msg_val, votes) -> int:
    dev, (b, v) = msg_val.device, msg_val.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return _kernel(entry)(
            int(aid), st[0].shape[0], v, b,
            msgtype.data_ptr(), inst.data_ptr(), msg_rnd.data_ptr(), msg_val.data_ptr(),
            *(t.data_ptr() for t in st), *(t.data_ptr() for t in votes), *shape, stream,
        )  # fmt: skip


def acceptor_phase2_window(
    st_rnd: torch.Tensor,  # int32[N]  register file, in place
    st_vrnd: torch.Tensor,  # int32[N]
    st_val: torch.Tensor,  # int32[N, V]
    aid: int,
    msgtype: torch.Tensor,  # int32[B]
    inst: torch.Tensor,  # int32[B]
    msg_rnd: torch.Tensor,  # int32[B]
    msg_val: torch.Tensor,  # int32[B, V]
) -> tuple[torch.Tensor, ...]:
    """One acceptor's vote on the card, a team of threads a lane.  Returns
    ``(st_rnd, st_vrnd, st_val, vote_type[B], vote_inst[B], vote_rnd[B],
    vote_vrnd[B], vote_swid[B], vote_value[B, V])``: the register file is
    the input, updated in place."""
    global launches
    what = "acceptor_phase2_window"
    st = (st_rnd, st_vrnd, st_val)
    votes = _io(what, *st, msgtype, inst, msg_rnd, msg_val)
    geo = geometry(msg_val, st_val, votes[5])
    shape = (geo.variant == "vector", geo.team, geo.block)
    rc = _launch("acceptor_phase2", shape, aid, st, msgtype, inst, msg_rnd, msg_val, votes)
    _wirepath._launched(geo, rc, f"{what} launch")
    launches += 1
    return (*st, *votes)


def acceptor_phase2_witness(
    st_rnd: torch.Tensor,  # int32[N]  register file, in place
    st_vrnd: torch.Tensor,  # int32[N]
    st_val: torch.Tensor,  # int32[N, V]
    aid: int,
    msgtype: torch.Tensor,  # int32[B]
    inst: torch.Tensor,  # int32[B]
    msg_rnd: torch.Tensor,  # int32[B]
    msg_val: torch.Tensor,  # int32[B, V]
) -> tuple[torch.Tensor, ...]:
    """The same vote by the first design, one thread a lane: the witness
    that the card checks hold K7's and K2's team body against.  Returns as
    ``acceptor_phase2_window`` does."""
    global witness_launches
    what = "acceptor_phase2_witness"
    st = (st_rnd, st_vrnd, st_val)
    votes = _io(what, *st, msgtype, inst, msg_rnd, msg_val)
    rc = _launch(what, (), aid, st, msgtype, inst, msg_rnd, msg_val, votes)
    _build.check(rc, f"{what} launch")
    witness_launches += 1
    return (*st, *votes)
