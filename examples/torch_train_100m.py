"""Training on the PyTorch port: a ~100M-param qwen3-family model, with every
fault-tolerance feature live:

  * quorum step-commit (straggler groups abstain; step still commits)
  * consensus-committed checkpoints (+ restart from the committed manifest)
  * coordinator failover after the run

    python examples/torch_train_100m.py                 # on the card
    python examples/torch_train_100m.py --device cpu    # no card (slow)

The port of ``examples/train_100m.py``: the same model, stream, straggler
rate, checkpoint cadence and fused consensus context, and the same closing
assertions.  Every step's attention runs K9 on the card and every step and
checkpoint commit is a fused round of the round kernel.  Without
``--device`` the card is used, and the script raises where there is none.
"""

import argparse
import dataclasses
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PaxosConfig, PaxosContext  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.train import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.train import data as data_mod  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402


def build_100m_config():
    """A ~100M-parameter member of the qwen3 family."""
    cfg = get_config("qwen3-4b")
    return dataclasses.replace(
        cfg,
        name="qwen3-100m",
        n_layers=8,
        d_model=896,
        n_heads=14,
        n_kv_heads=7,
        head_dim=64,
        d_ff=3584,
        vocab=512,  # tiny vocab: convergence visible in ~30 steps
        dtype="float32",
    )


def main(argv: list[str] | None = None) -> dict[str, list]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_100m_config()
    n = registry.count_params(cfg)
    print(f"model: {cfg.name}, {n / 1e6:.1f}M params, on {dev}")

    state = train_loop.init_state(cfg, torch.Generator(device=dev).manual_seed(0))
    ocfg = opt_mod.OptConfig(lr=1e-3, warmup_steps=3, total_steps=args.steps)
    step_fn = train_loop.make_train_step(cfg, ocfg)

    stream = data_mod.SyntheticStream(
        data_mod.DataConfig(vocab=cfg.vocab, global_batch=args.batch, seq_len=args.seq,
                            mode="arith")  # fmt: skip
    )
    paxos = PaxosContext(
        PaxosConfig(n_acceptors=3, n_instances=8192, batch=16), fused=True, device=dev
    )
    with tempfile.TemporaryDirectory() as d:
        mgr = ckpt_mod.CheckpointManager(d, paxos_ctx=paxos)
        loop = train_loop.LoopConfig(
            steps=args.steps,
            checkpoint_every=max(args.steps // 3, 5),
            straggler_prob=0.1,  # 10% of groups miss the deadline
        )
        t0 = time.time()
        state, hist = train_loop.run_loop(
            cfg, state, iter(stream), loop=loop, train_step=step_fn,
            paxos_ctx=paxos, checkpoint_mgr=mgr,
        )  # fmt: skip
        dt = time.time() - t0
        committed = sum(hist["committed"])
        straggled = sum(hist["straggled"])
        k = max(min(4, args.steps // 3), 1)
        first, last = hist["loss"][:k], hist["loss"][-k:]
        print(
            f"{args.steps} steps in {dt:.1f}s "
            f"({dt / args.steps * 1e3:.0f} ms/step); "
            f"loss {sum(first) / k:.3f} -> {sum(last) / k:.3f} "
            f"(window mean of {k}); "
            f"committed {committed}/{args.steps} steps despite "
            f"{straggled} straggler events"
        )
        assert sum(last) / k < sum(first) / k, (first, last)
        assert committed == args.steps  # quorum always reached w/ p=0.1

        # crash + restart from the committed checkpoint
        ck = mgr.latest_committed()
        assert ck is not None
        restored, at_step = mgr.restore(state)
        print(f"restart OK from committed checkpoint at step {at_step} ({ck})")

        # mid-run coordinator failover does not lose commit records
        paxos.fail_coordinator()
        paxos.submit(b"post-failover-probe")
        paxos.run_until_quiescent()
        print(
            f"consensus log: {paxos.stats['delivered']} records delivered "
            f"(step commits + checkpoint commits), coordinator failover OK"
        )
    return hist


if __name__ == "__main__":
    main()
