"""Replicated key-value store on the PyTorch port — the paper's LevelDB case
study (§5), served by the KV tier (DESIGN.md §10).

    python examples/torch_replicated_kv.py                 # on the card
    python examples/torch_replicated_kv.py --device cpu    # no card

Clients speak the typed session API: ``put`` / ``cas`` / ``delete`` ride the
consensus wire path exactly once, while ``get`` is **consensus-free** under
the session's read-your-writes lease.  When membership churn moves a session
between groups, its lease goes stale and ONE serialized read-index op
re-validates it; the session's view stitches across the generations it
spanned.  The groups' slabs live on one device: on the card each dispatch is
a kernel launch.  Without ``--device`` the card is used, and the script
raises where there is none.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import PaxosConfig, PaxosContext  # noqa: E402
from repro_torch.serve import ConsensusService, ReplicatedKV  # noqa: E402


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)
    cfg = PaxosConfig(n_acceptors=3, n_instances=256, batch=16, n_groups=2)
    svc = ConsensusService(PaxosContext(cfg, device=args.device))
    kv = ReplicatedKV(svc)
    print(f"dataplane on {svc.ctx.hw.device}")

    # -- writes ride consensus ----------------------------------------------
    alice = kv.session("alice")
    alice.put(b"user", b"alice")
    alice.put(b"city", b"lugano")
    alice.put(b"user", b"bob")  # overwrite decided later wins
    alice.delete(b"city")
    alice.cas(b"paper", None, b"caans")  # create iff absent
    svc.run_until_quiescent()

    # -- leased reads never touch the wire path -----------------------------
    before = svc.ctx.hw.dispatch_count
    assert alice.get(b"user") == b"bob"
    assert alice.get(b"city") is None  # tombstoned
    assert alice.get(b"paper") == b"caans"
    assert svc.ctx.hw.dispatch_count == before, "leased get dispatched!"
    print(
        f"3 leased gets, {svc.ctx.hw.dispatch_count - before} wire-path "
        f"dispatches — reads are consensus-free under the lease"
    )

    # -- cas semantics ------------------------------------------------------
    alice.cas(b"paper", b"caans", b"netchain")  # matches: applies
    alice.cas(b"paper", b"caans", b"stale")  # stale expect: no-op
    svc.run_until_quiescent()
    assert alice.get(b"paper") == b"netchain"
    print(f"cas applied once: paper={alice.get(b'paper').decode()}")

    # -- churn: the lease breaks, the read-index heals it -------------------
    svc.retire_group(svc.group_of("alice"))  # alice's group retires
    value = alice.get(b"user")  # stale lease -> read-index
    assert value == b"bob"  # stitched across generations
    assert alice.lease_valid  # re-validated, leased again
    assert kv.stats["read_index_gets"] == 1
    print(
        f"after membership churn: user={value.decode()} "
        f"(read-index fallbacks: {kv.stats['read_index_gets']}, "
        f"leased gets: {kv.stats['leased_gets']})"
    )


if __name__ == "__main__":
    main()
