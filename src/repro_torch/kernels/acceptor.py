"""K7: one acceptor's Phase-2 vote, a CUDA kernel.

``acceptor_phase2_window`` launches the ``acceptor_phase2`` entry point of
``csrc/vote.cu``, which replaces the TPU kernel
``repro.kernels.acceptor.acceptor_phase2_window``: the paper's per-role
acceptor (Table 1) voting on a batch of Phase-2 headers, its register file
``(N,)``, ``(N,)``, ``(N, V)`` updated in place, ``swid = aid``.  It runs the
lane body of K2 (``kernels.wirepath.acceptor_vote_all_window``) for one
acceptor that is alive.  Its plain version is
``repro_torch.core.batched.acceptor_phase2``; ``kernels.ops.acceptor_phase2``
chooses between the two by the device of the tensors.

Lane j addresses ring slot ``inst[j] mod N``, so any window base and any
batch of distinct slots is served.  Precondition, as the plain engine's:
the slots are pairwise distinct (so ``B <= N``, which is checked).
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
        fn = _build.library("vote").acceptor_phase2
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, i, p, p, p, p, p, p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def vote_io(
    what: str,
    lead: tuple,
    n: int,
    msgtype: torch.Tensor,
    inst: torch.Tensor,
    msg_rnd: torch.Tensor,
    msg_val: torch.Tensor,
) -> list[torch.Tensor]:
    """Check a Phase-2 batch for a vote kernel and allocate its votes: five
    int32 ``lead + (B,)`` fields (type, inst, rnd, vrnd, swid) and the
    ``lead + (B, V)`` values.  ``B <= N`` keeps the lanes' slots distinct
    for a contiguous window; the kernels need distinct slots in general."""
    dev = msg_val.device
    _build.on_card(what, dev)
    b, v = msg_val.shape
    if not 1 <= b <= n:
        raise ValueError(f"{what} needs 1 <= B <= N, got B={b}, N={n}")
    for name, t in (("msgtype", msgtype), ("inst", inst), ("rnd", msg_rnd)):
        _build.require(what, name, t, torch.int32, (b,), dev)
    _build.require(what, "value", msg_val, torch.int32, (b, v), dev)
    fields = torch.empty((5, *lead, b), dtype=torch.int32, device=dev).unbind(0)
    return [*fields, torch.empty((*lead, b, v), dtype=torch.int32, device=dev)]


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
    """One acceptor's vote on the card.  Returns ``(st_rnd, st_vrnd, st_val,
    vote_type[B], vote_inst[B], vote_rnd[B], vote_vrnd[B], vote_swid[B],
    vote_value[B, V])``: the register file is the input, updated in place."""
    global launches
    what = "acceptor_phase2_window"
    (n,) = st_rnd.shape
    votes = vote_io(what, (), n, msgtype, inst, msg_rnd, msg_val)
    dev, v = msg_val.device, msg_val.shape[1]
    _build.require(what, "st_rnd", st_rnd, torch.int32, (n,), dev)
    _build.require(what, "st_vrnd", st_vrnd, torch.int32, (n,), dev)
    _build.require(what, "st_val", st_val, torch.int32, (n, v), dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            int(aid), n, v, msg_val.shape[0],
            msgtype.data_ptr(), inst.data_ptr(), msg_rnd.data_ptr(), msg_val.data_ptr(),
            st_rnd.data_ptr(), st_vrnd.data_ptr(), st_val.data_ptr(),
            *(t.data_ptr() for t in votes), stream,
        )  # fmt: skip
    _build.check(rc, f"{what} launch")
    launches += 1
    return (st_rnd, st_vrnd, st_val, *votes)
