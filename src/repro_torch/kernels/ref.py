"""Plain oracles of every kernel, under the reference's names.

The counterpart of ``repro.kernels.ref``: each function takes the
reference oracle's parameters in its order and returns its tuple in its
order, so a test or a card check can hold a kernel against its oracle by
the reference's contract.  Each delegates to the port's plain code
(``core.batched``, ``learner.learner_quorum_plain``, ``digest.digest_plain``,
``flash_attention.flash_attention_plain``); none writes the arithmetic a
second time.

The port's plain engine updates state in place where the reference's
returns new arrays, so each function here clones the state it is given:
its inputs are left as they were, as the reference's are.  Plain PyTorch,
on any device.
"""

from __future__ import annotations

import torch

from repro_torch.core import batched
from repro_torch.core.types import I32, NO_ROUND, AcceptorState, CoordinatorState, MsgBatch

from .digest import digest_plain
from .learner import learner_quorum_plain


def _scalar(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=I32, device=dev).reshape(())


def _window(base, n: int, msgtype, msg_rnd, msg_val) -> MsgBatch:
    """A P2A batch on the ring window at ``base``: lane ``j`` at slot
    ``(base + j) % N``, as the reference's window kernels address it."""
    b, dev = msgtype.shape[0], msgtype.device
    inst = (_scalar(base, dev) + torch.arange(b, dtype=I32, device=dev)) % n
    return MsgBatch(
        msgtype=msgtype,
        inst=inst,
        rnd=msg_rnd,
        vrnd=torch.full((b,), NO_ROUND, dtype=I32, device=dev),
        swid=torch.zeros((b,), dtype=I32, device=dev),
        value=msg_val,
    )


def _copy(*tensors: torch.Tensor) -> list[torch.Tensor]:
    return [t.clone() for t in tensors]


def acceptor_phase2_window(
    st_rnd, st_vrnd, st_val, base, aid, msgtype, msg_rnd, msg_val
) -> tuple[torch.Tensor, ...]:
    """Oracle of K7 (``kernels.acceptor.acceptor_phase2_window``): one
    acceptor's vote on the window at ``base``.  Returns ``(st_rnd, st_vrnd,
    st_val, vote_type, vote_rnd, vote_vrnd, vote_swid, vote_value)``."""
    astate = AcceptorState(*_copy(st_rnd, st_vrnd, st_val))
    msgs = _window(base, st_rnd.shape[0], msgtype, msg_rnd, msg_val)
    astate, votes = batched.acceptor_phase2(astate, msgs, aid=int(aid))
    return (
        astate.rnd, astate.vrnd, astate.value,
        votes.msgtype, votes.rnd, votes.vrnd, votes.swid, votes.value,
    )  # fmt: skip


def coordinator_sequence_window(next_inst, crnd, active) -> tuple[torch.Tensor, ...]:
    """Oracle of K3 (``kernels.coordinator.coordinator_sequence_window``).
    Returns ``(msgtype, inst, rnd, vrnd, next_inst')``."""
    b, dev = active.shape[0], active.device
    cstate = CoordinatorState(next_inst=_scalar(next_inst, dev), crnd=_scalar(crnd, dev))
    no_values = torch.empty((b, 0), dtype=I32, device=dev)
    cstate, out = batched.coordinator_sequence(cstate, no_values, active.bool())
    return out.msgtype, out.inst, out.rnd, out.vrnd, cstate.next_inst


def learner_quorum_window(quorum, vote_type, vote_vrnd, vote_val) -> tuple[torch.Tensor, ...]:
    """Oracle of K8 (``kernels.learner.learner_quorum_window``).  Returns
    ``(deliver int32 0/1, win_vrnd, value)``; the value is 0 on a lane where
    no acceptor voted P2B at the winning round, as the kernel gives it."""
    return learner_quorum_plain(int(quorum), vote_type, vote_vrnd, vote_val)


def wirepath_round(
    next_inst, crnd, quorum, alive, st_rnd, st_vrnd, st_val, ldel, linst, lval, values
) -> tuple[torch.Tensor, ...]:
    """Oracle of K1 (``kernels.wirepath.wirepath_round``): the plain fused
    round with no reclamation.  Returns ``(st_rnd, st_vrnd, st_val, ldel,
    linst, lval, fresh int32 0/1, win_vrnd, value)``."""
    b, dev = values.shape[0], values.device
    cstate = CoordinatorState(next_inst=_scalar(next_inst, dev), crnd=_scalar(crnd, dev))
    stack = AcceptorState(*_copy(st_rnd, st_vrnd, st_val))
    lstate = batched.LearnerState(*_copy(ldel, linst, lval))
    _, stack, lstate, fresh, _, win, value = batched.fused_round(
        cstate, stack, lstate, values, torch.ones((b,), dtype=torch.bool, device=dev),
        torch.as_tensor(alive, device=dev).bool(), int(quorum),
    )  # fmt: skip
    return (
        stack.rnd, stack.vrnd, stack.value, lstate.delivered, lstate.inst, lstate.value,
        fresh.to(I32), win, value,
    )  # fmt: skip


def acceptor_vote_all_window(
    st_rnd, st_vrnd, st_val, base, alive, msgtype, msg_rnd, msg_val
) -> tuple[torch.Tensor, ...]:
    """Oracle of K2 (``kernels.wirepath.acceptor_vote_all_window``): the
    acceptor array's vote on the window at ``base``.  Returns ``(st_rnd,
    st_vrnd, st_val, vote_type, vote_rnd, vote_vrnd, vote_swid,
    vote_value)``, the votes ``(A, B)`` and ``(A, B, V)``."""
    stack = AcceptorState(*_copy(st_rnd, st_vrnd, st_val))
    msgs = _window(base, st_rnd.shape[1], msgtype, msg_rnd, msg_val)
    alive = torch.as_tensor(alive, device=msgtype.device).bool()
    stack, votes = batched.acceptor_phase2_all(stack, msgs, alive)
    return (
        stack.rnd, stack.vrnd, stack.value,
        votes.msgtype, votes.rnd, votes.vrnd, votes.swid, votes.value,
    )  # fmt: skip


def digest(x: torch.Tensor) -> torch.Tensor:
    """Oracle of K4 (``kernels.digest.digest``): a 0-d int32 tensor.  On
    int32 and float32 arrays it is the reference's fold bit for bit.  A
    16-bit array raises ``TypeError``, as the port's digest does: the
    reference's ``view(int32)`` would fold pairs of its elements as one
    word, a fold no caller of the port makes."""
    return digest_plain(x)


def flash_attention(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KVH, Sk, D)
    v: torch.Tensor,
    *,
    window: int = 0,
    causal: bool = True,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Oracle of K9 (``kernels.flash_attention``): the direct softmax over
    every key, no tiling."""
    # imported here: kernels.flash_attention registers this function as
    # its oracle, so it imports this module first
    from .flash_attention import flash_attention_plain

    return flash_attention_plain(q, k, v, window=window, causal=causal, softmax_scale=softmax_scale)
