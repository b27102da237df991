"""The numbers ``correct`` compares, each against its limit.

Training cells compare the program's first steps with the reference's
(``reference.Readings``):

    loss_gap   the widest relative gap of a step's loss
    grad_gap   by the worst leaf: the gap between the two sides' norms of the
               first gradient as the optimizer got it, over the reference's
               norm of that leaf or of the median leaf, whichever is larger
    delta_gap  the same measure of each leaf's change over the steps; leaves
               whose first reference gradient is under a thousandth of the
               median leaf's are left out (Adam moves them by round-off alone)

Their limits come from the cell's ``limits/<cell>.json``; a limit of None
there leaves that number uncompared in the cell.  Exact counts
(digests, commit records, kernel launches) have the limit 0.
"""

from __future__ import annotations

import math
import statistics

NEGLIGIBLE = 1e-3  # a leaf's gradient under this share of the median leaf's moves by round-off


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], keep=None) -> dict[str, float]:
    """Each leaf's gap between the two sides' norms, over the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    keep = sorted(ref if keep is None else keep)
    floor = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keep}


def worst_leaf_gap(prog: dict[str, float], ref: dict[str, float], keep=None) -> float:
    if set(prog) != set(ref):
        return math.inf
    return max(leaf_gaps(prog, ref, keep).values())


def moving(ref) -> list[str]:
    """The leaves whose first gradient is not nought to rounding."""
    med = statistics.median(ref.raw1.values())
    return [k for k, g in ref.raw1.items() if g >= NEGLIGIBLE * med]


def gaps(prog, ref) -> dict[str, float]:
    losses = list(zip(prog.losses, ref.losses, strict=True))
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in losses),
        "grad_gap": worst_leaf_gap(prog.grad1, ref.grad1),
        "delta_gap": worst_leaf_gap(prog.delta, ref.delta, moving(ref)),
    }


def judge(numbers: dict[str, float], limits: dict[str, float | None]) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit, in ``numbers``' order;
    a number passes when it is at most its limit (and not NaN).  A number
    whose limit is None is not compared: its cell's readings gave it no
    upper end (the limits file says so, with the readings)."""
    rows = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()
            if limits[k] is not None}  # fmt: skip
    return all(r["value"] <= r["limit"] for r in rows.values()), rows
