"""Serving: ``service`` (consensus as a service: sessions routed onto groups),
``kv`` (the replicated KV tier over it) and ``engine`` (the LM half: prefill
and serve steps, ``ServeLoop``).

The LM names load ``engine``, and with it the models, on first use only, so
importing the consensus or KV tier never loads ``repro_torch.models``.
"""

from .kv import (  # noqa: F401
    OP_CAS,
    OP_DELETE,
    OP_GET,
    OP_PUT,
    GroupReplica,
    KvCodecError,
    KvOp,
    KVSession,
    ReplicatedKV,
    decode_op,
    encode_op,
)
from .service import ConsensusService, Session, Ticket, session_hash  # noqa: F401

_ENGINE = ("Request", "ServeLoop", "make_prefill_step", "make_serve_step")


def __getattr__(name: str):
    if name in _ENGINE:
        from . import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
