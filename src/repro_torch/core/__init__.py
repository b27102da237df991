"""CAANS core: consensus as a device service, one group or G groups.

Layers:
  * ``types``     — Paxos header/state as structure-of-arrays tensors
  * ``paxos``     — scalar reference role semantics (a copy of the reference's)
  * ``batched``   — the plain batched engine (plain version of the round kernel)
  * ``plan``      — the cohort dispatch planner, burst quantization, packing
  * ``api``       — drop-in submit / deliver / recover (paper Fig. 4), single-,
                    multi-group and groups-sharded dataplanes
  * ``fabric``    — the groups-sharded round, shard by shard over a mesh
  * ``snapshot``  — sealed snapshot store + ring reclamation
  * ``failover``  — coordinator takeover and acceptor restore
  * ``network``   — seeded lossy message fabric (a copy of the reference's)
  * ``bridge``    — state export/import through numpy, in the reference's names
"""

from .api import (  # noqa: F401
    HardwareDataplane,
    MultiGroupDataplane,
    PaxosContext,
    ShardedMultiGroupDataplane,
)
from .network import FaultSpec, SimNet  # noqa: F401
from .snapshot import GroupSnapshot, RingOverflowError, SnapshotStore  # noqa: F401
from .types import (  # noqa: F401
    AcceptorState,
    CoordinatorState,
    MsgBatch,
    PaxosConfig,
    decode_value,
    encode_value,
)
