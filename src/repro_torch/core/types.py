"""Paxos message / state types as structure-of-arrays int32 tensors.

The PyTorch counterpart of ``repro.core.types``.  The paper's Paxos header
(Fig. 5) becomes a batch of headers stored field by field, each field an
int32 tensor on one device; ``value`` is a fixed number of 32-bit words
(16 words = the paper's 64-byte values).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Message types (paper: phase 1A/1B/2A/2B + housekeeping)
MSG_NOP = 0  # no-op filler slot in a batch
MSG_P1A = 1  # prepare            (coordinator -> acceptor)
MSG_P1B = 2  # promise            (acceptor -> coordinator)
MSG_P2A = 3  # accept request     (coordinator -> acceptor)
MSG_P2B = 4  # vote               (acceptor -> learner/coordinator)
MSG_SUBMIT = 5  # proposer -> coordinator
MSG_DELIVER = 6  # learner decision (synthesized at quorum)
MSG_REJECT = 7  # acceptor NACK (promised higher round)

# Default sizing (paper: 65,535 instances in BRAM, 64B values).
DEFAULT_INSTANCES = 1 << 16
DEFAULT_VALUE_WORDS = 16  # 16 x int32 = 64 bytes

NO_ROUND = -1
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class PaxosConfig:
    """Static protocol configuration, with the reference's defaults."""

    n_acceptors: int = 3  # 2f+1
    n_instances: int = DEFAULT_INSTANCES
    value_words: int = DEFAULT_VALUE_WORDS
    batch: int = 128  # dataplane batch ("packets per burst")
    n_groups: int = 1  # device-resident Paxos groups (G)
    # consecutive fragmented rounds (enabled groups over more than one
    # watermark class) after which the planner burns divergent groups
    # forward to a common block boundary; None = never realign, so instance
    # numbering stays identical to independent per-group deployments
    realign_after: int | None = None
    # persistent-wave depth cap: up to K full rounds of a cohort in one
    # dispatch (K5 on the card); 1 turns waves off
    persistent_rounds: int = 8
    # double-buffered pump: plan and pack wave N+1 before wave N's host
    # read-back; pump() stays synchronous and delivery order is unchanged
    async_pump: bool = True

    @property
    def f(self) -> int:
        return (self.n_acceptors - 1) // 2

    @property
    def quorum(self) -> int:
        return self.f + 1

    @property
    def max_payload_bytes(self) -> int:
        """Widest application payload one value carries: the value minus the
        8-byte (seq, len) header ``PaxosContext`` packs in front of it."""
        return self.value_words * 4 - 8


@dataclasses.dataclass
class MsgBatch:
    """A batch of Paxos headers: every field ``[..., B]``, ``value``
    ``[..., B, V]``.  ``gid`` is the consensus group the batch belongs to on
    a multi-group dataplane (a plain int; ``None`` = group 0, untagged)."""

    msgtype: torch.Tensor
    inst: torch.Tensor
    rnd: torch.Tensor
    vrnd: torch.Tensor
    swid: torch.Tensor
    value: torch.Tensor
    gid: int | None = None

    FIELDS = ("msgtype", "inst", "rnd", "vrnd", "swid", "value")

    def tensors(self) -> list[torch.Tensor]:
        """The six header fields, in order (``gid`` left out)."""
        return [getattr(self, f) for f in self.FIELDS]

    @classmethod
    def nop(
        cls,
        batch: int,
        value_words: int = DEFAULT_VALUE_WORDS,
        device: torch.device | str = "cpu",
    ) -> MsgBatch:
        z = torch.zeros((batch,), dtype=I32, device=device)
        return cls(
            msgtype=z,
            inst=z.clone(),
            rnd=torch.full((batch,), NO_ROUND, dtype=I32, device=device),
            vrnd=torch.full((batch,), NO_ROUND, dtype=I32, device=device),
            swid=z.clone(),
            value=torch.zeros((batch, value_words), dtype=I32, device=device),
        )

    def replace(self, **kw) -> MsgBatch:
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class AcceptorState:
    """The acceptor's ring of instance registers (the paper's BRAM): ``rnd``
    promised round, ``vrnd`` voted round (-1 = none), ``value`` voted value.
    Instance ``i`` lives in slot ``i % N``.  A stacked acceptor array carries
    a leading ``A`` axis on every field."""

    rnd: torch.Tensor  # int32[..., N]
    vrnd: torch.Tensor  # int32[..., N]
    value: torch.Tensor  # int32[..., N, V]

    @property
    def n_instances(self) -> int:
        return self.rnd.shape[-1]

    @classmethod
    def init(
        cls,
        n_instances: int = DEFAULT_INSTANCES,
        value_words: int = DEFAULT_VALUE_WORDS,
        device: torch.device | str = "cpu",
        n_acceptors: int | None = None,
    ) -> AcceptorState:
        """Fresh registers (round-0 promises, no votes); ``n_acceptors``
        stacks that many register files on a leading axis."""
        lead = () if n_acceptors is None else (n_acceptors,)
        return cls(
            rnd=torch.zeros(lead + (n_instances,), dtype=I32, device=device),
            vrnd=torch.full(lead + (n_instances,), NO_ROUND, dtype=I32, device=device),
            value=torch.zeros(lead + (n_instances, value_words), dtype=I32, device=device),
        )


@dataclasses.dataclass
class CoordinatorState:
    """Sequencer state: next instance and current round, 0-d int32 tensors."""

    next_inst: torch.Tensor
    crnd: torch.Tensor

    @classmethod
    def init(
        cls, crnd: int = 0, next_inst: int = 0, device: torch.device | str = "cpu"
    ) -> CoordinatorState:
        return cls(
            next_inst=torch.tensor(next_inst, dtype=I32, device=device),
            crnd=torch.tensor(crnd, dtype=I32, device=device),
        )


def encode_value(payload: bytes, value_words: int = DEFAULT_VALUE_WORDS) -> np.ndarray:
    """Pack an application byte buffer into int32 value words (host side)."""
    nbytes = value_words * 4
    if len(payload) > nbytes:
        raise ValueError(f"value too large: {len(payload)} > {nbytes}")
    buf = payload.ljust(nbytes, b"\x00")
    return np.frombuffer(buf, dtype="<i4").copy()


def decode_value(words: np.ndarray) -> bytes:
    """Unpack int32 value words back to a byte buffer (host side)."""
    return np.asarray(words, dtype="<i4").tobytes()
