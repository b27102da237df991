"""Read the numbers ``correct`` compares, over many seeds, for a cell's limits.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 --faults 3 --out FILE

On the card, at the cell's own sizes.  For every seed: the program's first
steps, exactly as a run's set-up drives them, against the reference's (the
program's readings, from which a limit's lower end is read).  For the first
``--faults`` seeds also the control, the reference in float8 in the
program's place, and a planted fault, the reference with half of each
batch left out (the upper end).  A state left unchanged reads 1 on
``grad_gap`` and ``delta_gap`` by their definition and needs no run.  One
JSON line a reading, on standard output and appended to ``--out``.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from perfbench.harness import checks  # noqa: E402
from perfbench.harness import manifest as mf  # noqa: E402
from perfbench.kinds import train  # noqa: E402
from perfbench.reference.lowp import FP8  # noqa: E402
from perfbench.run import card  # noqa: E402


def _leaves(side, ref) -> dict[str, dict[str, float]]:
    """Each leaf's ``grad_gap`` and ``delta_gap`` measure, for a look at which
    leaf sets the worst."""
    grad = checks.leaf_gaps(side.grad1, ref.grad1)
    delta = checks.leaf_gaps(side.delta, ref.delta, checks.moving(ref))
    return {k: {"grad": grad[k], "delta": delta.get(k)} for k in grad}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate.py reads the card; there is none", file=sys.stderr)
        return 3
    man = mf.load(ROOT)
    cell = mf.cell(man, args.workload)
    conf, traffic = mf.config(ROOT, man, cell["config"]), mf.traffic(ROOT, cell["traffic"])
    dev = card()
    torch.empty(0, device=dev)  # the card's context, before its memory statistics are reset
    with open(args.out, "a") as out:

        def emit(**row):
            line = json.dumps({"workload": args.workload, **row})
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()

        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            spec = train.Spec(conf=conf, traffic=traffic, limits={}, seed=seed, seconds=0.0,
                              trace=False, device=dev, t0=time.perf_counter())  # fmt: skip
            torch.cuda.reset_peak_memory_stats(dev)
            prog = train.Program(spec)
            ours, witnessed = prog.first_steps()
            digests_ok = witnessed == prog.digests()[: train.CHECK_STEPS]
            prog_peak = torch.cuda.max_memory_allocated(dev)
            del prog
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            ref = train.reference_readings(spec)
            ref_s = time.perf_counter() - t
            ref_peak = torch.cuda.max_memory_allocated(dev)
            emit(seed=seed, side="program", gaps=checks.gaps(ours, ref), losses=ours.losses,
                 ref_losses=ref.losses, digests_ok=digests_ok, reference_s=ref_s,
                 program_peak_bytes=prog_peak, reference_peak_bytes=ref_peak,
                 excluded=sorted(set(ref.raw1) - set(checks.moving(ref))),
                 leaves=_leaves(ours, ref), ref_delta=ref.delta, ref_grad1=ref.grad1)  # fmt: skip
            if i < args.faults:
                for side, kw in (("control", {"prec": FP8}), ("half_batch", {"half_batch": True})):
                    other = train.reference_readings(spec, **kw)
                    emit(seed=seed, side=side, gaps=checks.gaps(other, ref), losses=other.losses,
                         leaves=_leaves(other, ref))  # fmt: skip
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
