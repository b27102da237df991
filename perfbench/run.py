"""Run one cell of the benchmark on the card and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root.  The cell, its configuration, traffic, limits and
metrics are found by name from ``BENCHMARK.json`` (``harness.manifest``);
the traffic's ``kind`` names the module under ``kinds/`` that runs it.  With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones.  The last lines on standard error, and
the result's last key ``checks``, give each number ``correct`` compared
beside its limit.  The result is the last line on standard output.

Exit codes: 0 with a result (``correct`` true or false); 2 for a manifest
that breaks the benchmark's rules; 3 without the card or cards the cell asks for; 4
when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# Top-level module names that may not be loaded: the JAX package beside the
# port is ``repro``, a prefix of the port's own ``repro_torch``, so names are
# compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list[str]:
    """The forbidden top-level names among the module ``names``."""
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def card():
    """The card a one-chip cell runs on."""
    import torch

    return torch.device("cuda", 0)


def _number(x):
    return x if not isinstance(x, float) or math.isfinite(x) else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.harness import manifest as mf

    man = mf.load(ROOT)
    bad = mf.problems(man, ROOT)
    if bad:
        print("BENCHMARK.json breaks the benchmark's rules:\n  " + "\n  ".join(bad), file=sys.stderr)
        return 2
    cell = mf.cell(man, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)  # fmt: skip
        return 3
    traffic = mf.traffic(ROOT, cell["traffic"])
    kind = mf.kind_module(ROOT, traffic["kind"])
    readers = {m["name"]: (m["unit"], mf.reader(ROOT, m["name"]))
               for m in mf.metrics_of(man, cell["name"], traced=bool(args.trace))}  # fmt: skip
    spec = kind.Spec(
        conf=mf.config(ROOT, man, cell["config"]), traffic=traffic,
        limits=mf.limits(ROOT, cell["name"]), seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=card(), t0=T0,
    )  # fmt: skip
    result = kind.run(spec, readers)
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 4
    for name, s in result.get("setup_phases", {}).items():
        print(f"setup {name} {s:.4f} s", file=sys.stderr)
    rows = result["checks"]
    result["checks"] = {k: {"value": _number(r["value"]), "limit": r["limit"]}
                        for k, r in rows.items()}  # fmt: skip
    for k, r in rows.items():
        verdict = "ok" if r["value"] <= r["limit"] else "FAIL"
        print(f"check {k} {r['value']!r} limit {r['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
