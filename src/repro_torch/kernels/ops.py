"""The dispatch between each kernel and its plain version.

A wrapper here looks at the device of the tensors it is given: a CPU tensor
goes to the plain PyTorch version, a CUDA tensor to the hand-written kernel
(which raises if it cannot launch).  There is no fallback from the card to
the plain version.  The signatures are the reference's
(``repro.kernels.ops``), so ``core`` calls either engine the same way.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.analysis.contracts import dataplane_contract
from repro_torch.core import batched as _batched
from repro_torch.core.batched import LearnerState
from repro_torch.core.types import AcceptorState, CoordinatorState, MsgBatch

from . import acceptor as _acceptor
from . import coordinator as _coordinator
from . import digest as _digest
from . import learner as _learner
from . import ref as _ref
from . import wirepath as _wirepath


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for device {t.device}")


@dataplane_contract(
    oracle=_batched.coordinator_sequence,
    plain=_batched.coordinator_sequence,
    jax_oracle="repro.core.batched.coordinator_sequence",
)
def coordinator_sequence(
    cstate: CoordinatorState, values: torch.Tensor, active: torch.Tensor
) -> tuple[CoordinatorState, MsgBatch]:
    """Sequence one burst: K3 on the card, ``batched.coordinator_sequence``
    on the CPU.  The P2A batch carries ``values`` as its value field."""
    if not _route(values, "coordinator_sequence"):
        return _batched.coordinator_sequence(cstate, values, active)
    msgtype, inst, rnd, vrnd, swid, next_inst = _coordinator.coordinator_sequence_window(
        cstate.next_inst, cstate.crnd, active
    )
    out = MsgBatch(msgtype=msgtype, inst=inst, rnd=rnd, vrnd=vrnd, swid=swid, value=values)
    return CoordinatorState(next_inst=next_inst, crnd=cstate.crnd), out


@dataplane_contract(
    oracle=_batched.acceptor_phase2,
    plain=_batched.acceptor_phase2,
    jax_oracle="repro.core.batched.acceptor_phase2",
    state_args=("astate",),
)
def acceptor_phase2(
    astate: AcceptorState, msgs: MsgBatch, aid: int = 0
) -> tuple[AcceptorState, MsgBatch]:
    """One acceptor's Phase-2 vote, its register file updated in place: K7
    on the card, ``batched.acceptor_phase2`` on the CPU.  The batch's slots
    must be pairwise distinct."""
    if not _route(msgs.value, "acceptor_phase2"):
        return _batched.acceptor_phase2(astate, msgs, aid)
    _, _, _, *votes = _acceptor.acceptor_phase2_window(
        astate.rnd, astate.vrnd, astate.value, aid, msgs.msgtype, msgs.inst, msgs.rnd, msgs.value
    )
    return astate, MsgBatch(*votes)


@dataplane_contract(
    oracle=_batched.acceptor_phase2_all,
    plain=_batched.acceptor_phase2_all,
    jax_oracle="repro.core.batched.acceptor_phase2_all",
    state_args=("stack",),
)
def acceptor_phase2_all(
    stack: AcceptorState, msgs: MsgBatch, alive: torch.Tensor
) -> tuple[AcceptorState, MsgBatch]:
    """The whole acceptor array's Phase-2 vote, the stacked rings updated in
    place, votes ``[A, ...]``: K2 on the card, ``batched.acceptor_phase2_all``
    on the CPU.  The batch's slots must be pairwise distinct."""
    if not _route(msgs.value, "acceptor_phase2_all"):
        return _batched.acceptor_phase2_all(stack, msgs, alive)
    _, _, _, *votes = _wirepath.acceptor_vote_all_window(
        stack.rnd, stack.vrnd, stack.value, alive, msgs.msgtype, msgs.inst, msgs.rnd, msgs.value
    )
    return stack, MsgBatch(*votes)


@dataplane_contract(
    oracle=_batched.learner_quorum,
    plain=_learner.learner_quorum_plain,
    jax_oracle="repro.core.batched.learner_quorum",
)
def learner_quorum(
    vote_msgtype: torch.Tensor,
    vote_inst: torch.Tensor,
    vote_vrnd: torch.Tensor,
    vote_value: torch.Tensor,
    quorum: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The learner's quorum over ``(A, B)`` vote batches: K8 on the card,
    ``learner.learner_quorum_plain`` on the CPU.  Returns ``(deliver[B]
    bool, inst[B], win[B], value[B, V])``; the value is 0 on a lane where no
    acceptor agrees, as the TPU kernel gives it."""
    quorum_fn = (
        _learner.learner_quorum_window
        if _route(vote_value, "learner_quorum")
        else _learner.learner_quorum_plain
    )
    deliver, win, value = quorum_fn(quorum, vote_msgtype, vote_vrnd, vote_value)
    # position-aligned batches: the instance is the same across acceptors
    return deliver.bool(), vote_inst[0], win, value


@dataplane_contract(
    oracle=_batched.fused_round,
    plain=_batched.fused_round,
    jax_oracle="repro.core.batched.fused_round",
    state_args=("stack", "lstate"),
)
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


@dataplane_contract(
    oracle=_batched.multigroup_fused_round,
    plain=_batched.multigroup_fused_round,
    jax_oracle="repro.core.batched.multigroup_fused_round",
    state_args=("stack", "lstate"),
    extra=("group_block",),
)
def multigroup_fused_round(
    cstate: CoordinatorState,
    stack: AcceptorState,
    lstate: LearnerState,
    values: torch.Tensor,
    active: torch.Tensor,
    alive: torch.Tensor,
    quorum: int,
    enabled=None,
    reclaim_limit=None,
    *,
    group_block: int = 1,
) -> tuple[
    CoordinatorState,
    AcceptorState,
    LearnerState,
    torch.Tensor,
    torch.Tensor,
    torch.Tensor,
    torch.Tensor,
]:
    """One fused Phase-2 round of all G groups: K1 in multi-group form on
    the card, ``batched.multigroup_fused_round`` on the CPU, state updated
    in place either way.  ``enabled`` (0/1 per group) holds groups inert;
    ``reclaim_limit`` is the per-group limit vector (it may hold wrapped,
    negative limits).  The returned watermark advances for every group and
    the returned round is the presented one (NO_ROUND where disabled).
    ``group_block`` is the reference kernel's fold, accepted for its
    signature: K1 maps one group per row at any window base."""
    if not _route(values, "multigroup_fused_round"):
        return _batched.multigroup_fused_round(
            cstate, stack, lstate, values, active, alive, quorum, enabled, reclaim_limit
        )
    g, b = values.shape[:2]
    dev = values.device
    en = None if enabled is None else _batched.group_vector(enabled, g, dev)
    lim = None if reclaim_limit is None else _batched.group_vector(reclaim_limit, g, dev)
    *_, fresh, win, value = _wirepath.multigroup_wirepath_round(
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
        en,
        lim,
        group_block=group_block,
    )
    inst = cstate.next_inst[:, None] + torch.arange(b, dtype=torch.int32, device=dev)[None, :]
    crnd = cstate.crnd if en is None else torch.where(en != 0, cstate.crnd, -1)
    return CoordinatorState(cstate.next_inst + b, crnd), stack, lstate, fresh, inst, win, value


@dataplane_contract(
    oracle=_batched.cohort_fused_round,
    plain=_batched.cohort_fused_round,
    jax_oracle="repro.core.batched.multigroup_fused_round",
    state_args=("stack", "lstate"),
    reason=(
        "the reference has no standalone oracle: its parity path is the full-width "
        "multigroup_fused_round over scatter-expanded cohort rows"
    ),
)
def cohort_fused_round(
    stack: AcceptorState,
    lstate: LearnerState,
    gsel,
    next_inst: torch.Tensor,
    crnd: torch.Tensor,
    alive: torch.Tensor,
    quorum: int,
    values: torch.Tensor,
    enabled,
    reclaim_limit=None,
    *,
    group_block: int = 1,
) -> tuple[AcceptorState, LearnerState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cohort-compacted fused round: K1 in cohort form on the card,
    ``batched.cohort_fused_round`` on the CPU.  Only the group blocks
    ``gsel`` names are visited; ``values`` and the outputs are compact (row
    ``j*GB + k`` is group ``gsel[j]*GB + k``), ``enabled`` marks the cohort's
    members.  Stateless for the coordinator: the dataplane advances its own
    watermarks.  Returns ``(stack, lstate, fresh[C, B], win[C, B],
    value[C, B, V])``."""
    if not _route(values, "cohort_fused_round"):
        return _batched.cohort_fused_round(
            stack, lstate, gsel, next_inst, crnd, alive, quorum, values, enabled,
            reclaim_limit, group_block=group_block,
        )  # fmt: skip
    g = stack.rnd.shape[0]
    dev = values.device
    lim = None if reclaim_limit is None else _batched.group_vector(reclaim_limit, g, dev)
    *_, fresh, win, value = _wirepath.cohort_wirepath_round(
        gsel,
        next_inst,
        crnd,
        quorum,
        alive,
        stack.rnd,
        stack.vrnd,
        stack.value,
        lstate.delivered,
        lstate.inst,
        lstate.value,
        values,
        _batched.group_vector(enabled, g, dev),
        lim,
        group_block=group_block,
    )
    return stack, lstate, fresh, win, value


@dataplane_contract(
    oracle=_batched.shard_slab_round,
    plain=_batched.shard_slab_round,
    jax_oracle="repro.kernels.wirepath.shard_slab_round",
    state_args=("stack", "lstate"),
    extra=("group_block",),
    reason=(
        "the reference has no ops entry or jnp oracle for the shard slice: its kernel entry "
        "takes the state as leaves, and the port's tests hold this entry against it"
    ),
)
def shard_slab_round(
    group_offset: int,
    next_inst: torch.Tensor,
    crnd: torch.Tensor,
    alive: torch.Tensor,
    quorum: int,
    stack: AcceptorState,
    lstate: LearnerState,
    values: torch.Tensor,
    enabled=None,
    reclaim_limit=None,
    *,
    group_block: int = 1,
) -> tuple[AcceptorState, LearnerState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One round over one shard's ``(Gl, ...)`` slab with the replicated
    ``(G,)`` vectors sliced at ``group_offset``: K1's shard slice on the
    card, ``batched.shard_slab_round`` on the CPU, the slab updated in place
    either way.  ``group_block`` is the reference kernel's fold, accepted
    for its signature.  Returns ``(stack, lstate, fresh[Gl, B], win[Gl, B],
    value[Gl, B, V])``."""
    if not _route(values, "shard_slab_round"):
        return _batched.shard_slab_round(
            group_offset, next_inst, crnd, alive, quorum, stack, lstate, values, enabled,
            reclaim_limit,
        )  # fmt: skip
    g = next_inst.shape[0]
    dev = values.device
    en = None if enabled is None else _batched.group_vector(enabled, g, dev)
    lim = None if reclaim_limit is None else _batched.group_vector(reclaim_limit, g, dev)
    *_, fresh, win, value = _wirepath.shard_slab_round(
        group_offset,
        next_inst,
        crnd,
        quorum,
        alive,
        stack.rnd,
        stack.vrnd,
        stack.value,
        lstate.delivered,
        lstate.inst,
        lstate.value,
        values,
        en,
        lim,
        group_block=group_block,
    )
    return stack, lstate, fresh, win, value


@dataplane_contract(
    oracle=_batched.packed_multigroup_round,
    plain=_batched.packed_multigroup_round,
    jax_oracle="repro.core.batched.packed_multigroup_round",
    state_args=("stack", "lstate"),
    extra=("block_b", "lanes_host"),
)
def packed_shard_round(
    stack: AcceptorState,
    lstate: LearnerState,
    segids,
    next_inst,
    crnd,
    alive,
    quorum: int,
    values: torch.Tensor,
    enabled,
    reclaim_limit=None,
    *,
    block_b: int | None = None,
    lanes_host=None,
) -> tuple[AcceptorState, LearnerState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The packed shard round: K6 on the card,
    ``batched.packed_multigroup_round`` on the CPU, the shard's slab updated
    in place either way.  ``C`` lanes, lane ``j`` serving slab row
    ``segids[j]`` with its own scalars; pads (``enabled == 0``) are inert.
    The preconditions (``C <= Gl``, ``B <= N``, the block dividing B and N,
    enabled lanes on distinct rows) are checked on the host on both routes;
    ``lanes_host`` gives host copies of ``segids`` and ``enabled`` for that
    check where the caller has them.  ``block_b`` (default: the reference's
    128) is the reference kernel's batch block, checked as the reference
    checks it; it changes no result.  Returns ``(stack, lstate, fresh[C,
    B], win[C, B], value[C, B, V])`` in lane order."""
    block_b = _wirepath.DEFAULT_BLOCK_B if block_b is None else block_b
    gl, n = stack.rnd.shape[0], stack.rnd.shape[2]
    c, b = values.shape[:2]
    if not _route(values, "packed_shard_round"):
        seg_h, en_h = lanes_host if lanes_host is not None else (segids, enabled)
        _wirepath.check_packed_lanes("packed_shard_round", seg_h, en_h, gl, c, b, n, block_b)
        return _batched.packed_multigroup_round(
            stack, lstate, segids, next_inst, crnd, alive, quorum, values, enabled, reclaim_limit
        )
    dev = values.device

    def lane(x):
        return _batched.group_vector(x, c, dev)

    if not isinstance(alive, torch.Tensor):
        alive = torch.from_numpy(np.asarray(alive))
    al = alive.to(dev, torch.int32).reshape((c, -1))
    *_, fresh, win, value = _wirepath.packed_shard_round(
        lane(segids),
        lane(next_inst),
        lane(crnd),
        quorum,
        al,
        stack.rnd,
        stack.vrnd,
        stack.value,
        lstate.delivered,
        lstate.inst,
        lstate.value,
        values,
        lane(enabled),
        None if reclaim_limit is None else lane(reclaim_limit),
        block_b=block_b,
        lanes_host=lanes_host,
    )
    return stack, lstate, fresh, win, value


@dataplane_contract(
    oracle=_batched.persistent_multigroup_rounds,
    plain=_batched.persistent_cohort_rounds,
    jax_oracle="repro.core.batched.persistent_multigroup_rounds",
    state_args=("stack", "lstate"),
    extra=("gsel", "wni", "wen", "crnd", "group_block", "block_b"),
    oracle_extra=("cstate", "active", "enabled_rounds"),
    strict_order=False,
)
def persistent_cohort_rounds(
    stack: AcceptorState,
    lstate: LearnerState,
    gsel,
    wni,
    wen,
    crnd: torch.Tensor,
    alive: torch.Tensor,
    quorum: int,
    values: torch.Tensor,
    reclaim_limit=None,
    *,
    group_block: int = 1,
    block_b: int | None = None,
) -> tuple[AcceptorState, LearnerState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """A persistent K-round wave: K5 on the card,
    ``batched.persistent_cohort_rounds`` on the CPU, state updated in place
    either way.  The wave descriptor ``wni``/``wen`` (``(K, G)``, host
    arrays or tensors) gives each group's window base and participation per
    round; ``values`` and the outputs are compact per round (row ``j*GB +
    k`` is group ``gsel[j]*GB + k``).  Coordinator-stateless: the dataplane
    advances its own watermarks.  ``block_b`` (default: the reference's
    128) is the reference kernel's batch block, checked by K5's wrapper; it
    changes no result.  Returns
    ``(stack, lstate, fresh[K, C, B], win[K, C, B], value[K, C, B, V])``."""
    if not _route(values, "persistent_cohort_rounds"):
        return _batched.persistent_cohort_rounds(
            stack, lstate, gsel, wni, wen, crnd, alive, quorum, values, reclaim_limit,
            group_block=group_block, block_b=block_b,
        )  # fmt: skip
    g = stack.rnd.shape[0]
    dev = values.device
    lim = None if reclaim_limit is None else _batched.group_vector(reclaim_limit, g, dev)
    *_, fresh, win, value = _wirepath.persistent_wirepath_round(
        gsel,
        wni,
        wen,
        crnd,
        quorum,
        alive,
        stack.rnd,
        stack.vrnd,
        stack.value,
        lstate.delivered,
        lstate.inst,
        lstate.value,
        values,
        lim,
        block_b=_wirepath.DEFAULT_BLOCK_B if block_b is None else block_b,
        group_block=group_block,
    )
    return stack, lstate, fresh, win, value


@dataplane_contract(
    oracle=_ref.digest, plain=_digest.digest_plain, jax_oracle="repro.kernels.ref.digest"
)
def digest(x: torch.Tensor) -> torch.Tensor:
    """The weighted fold of one array: K4 on the card, plain on the CPU."""
    return _digest.digest(x) if _route(x, "digest") else _digest.digest_plain(x)


@dataplane_contract(
    plain=_digest.tree_digest_plain,
    jax_oracle="repro.kernels.ref.digest",
    reason=(
        "leaf-wise composition of ``digest``: ref.digest on each leaf, folded by "
        "``digest.combine``; it takes the leaves in order (`leaves`) where the reference "
        "flattens a pytree (`tree`): the port's callers hold their leaves as a list"
    ),
)
def tree_digest(leaves: Sequence[torch.Tensor]) -> int:
    """Digest a sequence of arrays, combining leaf digests in order: on the
    card one K4 launch for every leaf (at most ``MAX_LEAVES``) and one
    device-to-host read, on the CPU the plain fold."""
    if not leaves:
        return _digest.combine([])
    if _route(leaves[0], "tree_digest"):
        ds = _digest.tree_digest(leaves)
    else:
        ds = _digest.tree_digest_plain(leaves)
    return _digest.combine(ds.tolist())
