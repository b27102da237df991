#!/usr/bin/env python
"""Time the groups-sharded dataplane's dispatch beside the unsharded one's,
on the card, at the paper's deployment (``PaxosConfig(n_groups=8)``: 3
acceptors, a 65,536-instance ring, 16-word values, bursts of 128), the
sharded one over two logical shards of the card:

    python tools/time_group_dispatch.py [--src DIR] [--reps N]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two commits can be compared in one
machine's run, each in a process of its own.  Only what both sides of such
a comparison have is used: ``MultiGroupDataplane`` and
``ShardedMultiGroupDataplane`` with ``use_kernels=True``, their
``pipeline`` (a full-width dispatch) and ``pipeline_cohort`` (three
groups), each returning host arrays.  The unsharded and sharded calls
alternate, each after the card is synchronised; 20 of each go unmeasured.
Prints one JSON line: the card's name and power limit, and the p25, p50
and p75 in ms on the host clock of each kind on each dataplane.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(_REPO, "src"))
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("time_group_dispatch needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import MultiGroupDataplane, PaxosConfig, ShardedMultiGroupDataplane
    from repro_torch.launch.mesh import make_group_mesh

    dev = torch.device("cuda")
    cfg = PaxosConfig(n_groups=8)
    g, b, v = cfg.n_groups, cfg.batch, cfg.value_words
    planes = {
        "unsharded": MultiGroupDataplane(cfg, use_kernels=True, device=dev),
        "sharded": ShardedMultiGroupDataplane(cfg, mesh=make_group_mesh(2, dev), use_kernels=True),
    }
    rng = np.random.default_rng(7)
    vals = rng.integers(-(2**31), 2**31 - 1, (g, b, v), dtype=np.int32)
    act = np.ones((g, b), bool)
    gids = [0, 3, g - 2]
    kinds = {
        "full_width": lambda hw: hw.pipeline(vals, act),
        "cohort_of_3": lambda hw: hw.pipeline_cohort(gids, vals[:3], act[:3]),
    }
    # every group advances a burst a full-width dispatch and the cohort's
    # three one more a cohort dispatch: 2 * (20 + reps) bursts stay inside
    # one lap of the ring, so no instance is overwritten
    if 2 * (20 + args.reps) * b > cfg.n_instances:
        raise SystemExit(f"--reps {args.reps} would wrap the {cfg.n_instances}-instance ring")
    times: dict[str, list[float]] = {}
    for kind, fn in kinds.items():
        for i in range(20 + args.reps):
            for name, hw in planes.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn(hw)
                spent = time.perf_counter() - t
                if i >= 20:
                    times.setdefault(f"{kind}.{name}", []).append(spent)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()  # fmt: skip
    out = {"card": card, "src": args.src, "reps": args.reps}
    for key, ts in times.items():
        ms = np.asarray(ts) * 1e3
        out[key] = {f"p{q}": float(np.percentile(ms, q)) for q in (25, 50, 75)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
