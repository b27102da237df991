"""The dispatch between each kernel and its plain version.

A wrapper here looks at the device of the tensors it is given: a CPU tensor
goes to the plain PyTorch version, a CUDA tensor to the hand-written kernel
(which raises if it cannot launch).  There is no fallback from the card to
the plain version.  The signatures are the reference's
(``repro.kernels.ops``), so ``core`` calls either engine the same way.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from repro_torch.core import batched as _batched
from repro_torch.core.batched import LearnerState
from repro_torch.core.types import AcceptorState, CoordinatorState

from . import digest as _digest
from . import wirepath as _wirepath


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for device {t.device}")


def fused_round(
    cstate: CoordinatorState,
    stack: AcceptorState,
    lstate: LearnerState,
    values: torch.Tensor,
    active: torch.Tensor,
    alive: torch.Tensor,
    quorum: int,
    reclaim_limit: int | None = None,
) -> tuple[
    CoordinatorState,
    AcceptorState,
    LearnerState,
    torch.Tensor,
    torch.Tensor,
    torch.Tensor,
    torch.Tensor,
]:
    """One fused Phase-2 round: K1 on the card, ``batched.fused_round`` on
    the CPU.  State is updated in place either way.  ``active`` never reaches
    the kernel: sequenced NOP fillers vote exactly like P2As."""
    if not _route(values, "fused_round"):
        return _batched.fused_round(
            cstate, stack, lstate, values, active, alive, quorum, reclaim_limit
        )
    *_, next_inst, inst, fresh, win, value = _wirepath.wirepath_round(
        cstate.next_inst,
        cstate.crnd,
        quorum,
        alive,
        stack.rnd,
        stack.vrnd,
        stack.value,
        lstate.delivered,
        lstate.inst,
        lstate.value,
        values,
        reclaim_limit,
    )
    new_c = CoordinatorState(next_inst=next_inst, crnd=cstate.crnd)
    return new_c, stack, lstate, fresh, inst, win, value


def digest(x: torch.Tensor) -> torch.Tensor:
    """The weighted fold of one array: K4 on the card, plain on the CPU."""
    return _digest.digest(x) if _route(x, "digest") else _digest.digest_plain(x)


def tree_digest(leaves: Sequence[torch.Tensor]) -> int:
    """Digest a sequence of arrays, combining leaf digests in order; one
    device-to-host read for all leaves."""
    if not leaves:
        return _digest.combine([])
    ds = torch.stack([digest(leaf) for leaf in leaves])
    return _digest.combine(ds.tolist())
