"""Quickstart on the PyTorch port: the drop-in CAANS API (paper Fig. 4).

    python examples/torch_quickstart.py                 # on the card
    python examples/torch_quickstart.py --device cpu    # plain versions, no card

An application that wants replicated, totally-ordered operations:
  1. builds a PaxosContext (the consensus service),
  2. registers a deliver callback,
  3. calls submit() — exactly the libpaxos API the paper preserves.
The coordinator and acceptor dataplane lives on one device: on the card
every fused round is one launch of the round kernel; on the CPU it runs the
kernel's plain PyTorch version.  Without ``--device`` the card is used, and
the script raises where there is none.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import PaxosConfig, PaxosContext  # noqa: E402


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)
    decided = []

    def deliver(value: bytes, size: int, instance: int) -> None:
        """Application callback: called exactly once per decided instance."""
        decided.append((instance, value))
        print(f"  deliver(inst={instance}): {value!r}")

    ctx = PaxosContext(
        PaxosConfig(n_acceptors=3, n_instances=4096, batch=16),
        deliver=deliver,
        fused=True,  # whole Phase-2 round in one launch
        device=args.device,
    )
    print(f"dataplane on {ctx.hw.device}")

    print("submitting 5 commands...")
    for i in range(5):
        ctx.submit(f"command-{i}".encode())
    ctx.run_until_quiescent()

    print("\nkilling acceptor 2 (f=1 of 2f+1=3 may fail)...")
    ctx.hw.kill_acceptor(2)
    ctx.submit(b"still-works")
    ctx.run_until_quiescent()

    print("\nhardware coordinator fails -> software takeover (paper §6.4)...")
    ctx.fail_coordinator()
    ctx.submit(b"after-failover")
    ctx.run_until_quiescent()

    assert [v for _, v in decided] == [
        b"command-0",
        b"command-1",
        b"command-2",
        b"command-3",
        b"command-4",
        b"still-works",
        b"after-failover",
    ]
    insts = [i for i, _ in decided]
    assert len(insts) == len(set(insts)), "agreement: one value per instance"
    print(f"\nOK: {len(decided)} values decided in order, none lost.")


if __name__ == "__main__":
    main()
