"""Failure-handling walkthrough on the PyTorch port (paper §6.4 / Fig. 8):

  1. steady state through the device dataplane,
  2. acceptor failure (f of 2f+1): throughput holds,
  3. hardware-coordinator failure -> safe software takeover with Phase-1
     re-scan (re-proposing voted instances),
  4. learner gap + recover(),
  5. elastic membership view change decided through the log.

    python examples/torch_failover_demo.py                 # on the card
    python examples/torch_failover_demo.py --device cpu    # no card

The context runs the staged path (the default, ``fused=False``): on the card
the sequencer and the acceptor array's vote are kernel launches.  Without
``--device`` the card is used, and the script raises where there is none.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import PaxosConfig, PaxosContext  # noqa: E402
from repro_torch.train import elastic  # noqa: E402


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)
    cfg = PaxosConfig(n_acceptors=3, n_instances=4096, batch=16)
    got = {}
    ctx = PaxosContext(cfg, deliver=lambda v, s, i: got.__setitem__(i, v), device=args.device)
    print(f"dataplane on {ctx.hw.device}")

    print("1) steady state: 10 values")
    for k in range(10):
        ctx.submit(f"steady-{k}".encode())
    ctx.run_until_quiescent()
    assert len(got) == 10

    print("2) acceptor 1 dies (tolerated: quorum 2 of 3 remains)")
    ctx.hw.kill_acceptor(1)
    for k in range(5):
        ctx.submit(f"degraded-{k}".encode())
    ctx.run_until_quiescent()
    assert len(got) == 15

    print("3) hardware coordinator dies -> software takeover w/ Phase-1 scan")
    # stale estimate on purpose: the scan catches the sequencer up safely
    res = ctx.fail_coordinator(est_next_inst=8)
    print(
        f"   scanned {res.scanned} instances, re-proposed "
        f"{len(res.reproposed)}, next_inst={res.next_inst}, crnd={res.crnd}"
    )
    for k in range(5):
        ctx.submit(f"takeover-{k}".encode())
    ctx.run_until_quiescent()
    assert len(got) == 20

    print("4) learner misses instance -> recover() refetches decided value")
    inst = sorted(got)[3]
    lost = ctx.learned[0].pop(inst)
    ctx.recover(inst)
    ctx.run_until_quiescent()
    assert ctx.learned[0][inst] == lost
    print(f"   instance {inst} recovered: {lost!r}")

    print("5) membership view change decided through the consensus log")
    view_ctx = PaxosContext(dataclasses.replace(cfg, value_words=64), device=args.device)
    v0 = elastic.MembershipView(0, ("h0", "h1", "h2", "h3"), (4, 1), ("data", "model"))
    vm = elastic.ViewManager(view_ctx, v0)
    new = vm.propose_view(["h0", "h1", "h3"], model_parallel=1)
    print(f"   epoch {new.epoch}: hosts={new.hosts} mesh={new.mesh_shape}")
    assert new.epoch == 1
    assert new.hosts == ("h0", "h1", "h3") and new.mesh_shape == (3, 1)
    assert [raw[:5] for _inst, raw in view_ctx.delivered_log] == [b"view:"]

    print("\nall failure paths exercised; no value lost, no double delivery")


if __name__ == "__main__":
    main()
