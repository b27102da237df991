"""The port's dispatch planner (``repro_torch.core.plan``) against the
reference's (``repro.core.plan``).

The planner is host integers only, so the port must decide exactly what the
reference decides: the policy cases of ``tests/test_plan.py`` that need no
mesh, run on the port's module; the same functions and a ``DispatchPlanner``
fed random schedules (loads, watermarks, membership, frozen rounds, queue
depths) in both packages, compared decision by decision; and the
context-level cases, the port's grouped context against the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import plan as rplan  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.core.plan import (  # noqa: E402
    MIN_BURST,
    NO_ROUND,
    DispatchPlanner,
    cohort_blocks,
    fold_width_full,
    quantize_burst,
)


# ---------------------------------------------------------------------------
# policy units (the reference's cases, on the port's module)
# ---------------------------------------------------------------------------
def test_quantize_burst_pow2_floor_and_cap():
    assert quantize_burst(0, 128) == MIN_BURST
    assert quantize_burst(1, 128) == MIN_BURST
    assert quantize_burst(8, 128) == 8
    assert quantize_burst(9, 128) == 16
    assert quantize_burst(100, 128) == 128
    assert quantize_burst(1000, 128) == 128
    assert quantize_burst(3, 4) == 4


def test_fold_width_full_generalizes_the_binary_cliff():
    assert fold_width_full([0, 1, 2, 3], [8, 8, 8, 8], 4) == 4
    assert fold_width_full(list(range(8)), [0, 0, 0, 0, 8, 8, 8, 8], 8) == 4
    assert fold_width_full([0, 1], [0, 8], 2) == 1
    assert fold_width_full([1, 2, 3], [99, 8, 8, 8], 4) == 4  # non-members never constrain
    assert fold_width_full([], [0, 1, 2, 3], 4) == 4


def test_cohort_blocks_compacts_the_group_axis():
    assert cohort_blocks([2], [0] * 8, 8) == (1, [2])
    assert cohort_blocks(list(range(1, 8)), [0] * 8, 8) == (8, [0])
    assert cohort_blocks(list(range(8)), [0, 0, 0, 0, 8, 8, 8, 8], 8) == (4, [0, 1])
    assert cohort_blocks([0, 1], [0, 8], 2) == (1, [0, 1])


def test_window_aligned_is_the_reference_kernels_rule():
    for n, base, b in ((4096, 0, 128), (4096, 64, 128), (512, 8, 16), (512, 0, 1024), (96, 0, 64)):
        assert plan_mod.window_aligned(n, base, b) == rplan.window_aligned(n, base, b)


def test_plan_round_tiers_hot_to_cold():
    p = DispatchPlanner(batch=128, n_instances=4096)
    rp = p.plan_round(loads=[128, 2, 0, 7, 128, 1], marks=[0] * 6, live=[True] * 6, crnd=[0] * 6)
    assert [c.burst for c in rp.cohorts] == [128, 8]
    assert rp.cohorts[0].gids == (0, 4)
    assert rp.cohorts[1].gids == (1, 3, 5)
    assert rp.enabled == (True, True, False, True, True, True)
    assert not rp.full_fold and rp.fragmentation == 1


def test_plan_round_masks_frozen_and_vacant():
    p = DispatchPlanner(batch=32, n_instances=512)
    rp = p.plan_round(
        loads=[4, 4, 4, 4],
        marks=[0, 0, 0, 0],
        live=[True, False, True, True],
        crnd=[0, 0, NO_ROUND, 0],
    )
    assert rp.enabled == (True, False, False, True)
    assert rp.cohorts == (plan_mod.Cohort(gids=(0, 3), burst=8),)
    assert rp.full_fold


def test_realignment_sweep_triggers_after_k_fragmented_rounds():
    p = DispatchPlanner(batch=128, n_instances=4096, realign_after=3)
    marks = [128, 256, 128, 128]
    for _ in range(2):
        rp = p.plan_round([4] * 4, marks, [True] * 4, [0] * 4)
        assert rp.realign == () and rp.fragmentation == 2
    rp = p.plan_round([4] * 4, marks, [True] * 4, [0] * 4)
    burned = dict(rp.realign)
    assert set(burned) == {0, 2, 3} and all(t == 256 for t in burned.values())
    assert rp.fragmentation == 1 and rp.full_fold
    assert p.stats["realignments"] == 1
    assert p.plan_round([4] * 4, [0, 64, 0, 0], [True] * 4, [0] * 4).realign == ()


def test_realignment_fires_on_lockstep_but_misaligned_watermarks():
    p = DispatchPlanner(batch=32, n_instances=512, realign_after=2)
    assert p.plan_round([4] * 4, [8] * 4, [True] * 4, [0] * 4).realign == ()
    rp = p.plan_round([4] * 4, [8] * 4, [True] * 4, [0] * 4)
    burned = dict(rp.realign)
    assert set(burned) == {0, 1, 2, 3} and all(t == 32 for t in burned.values())
    assert rp.full_fold
    rp = p.plan_round([4] * 4, [32] * 4, [True] * 4, [0] * 4)
    assert rp.realign == () and p._fragmented_rounds == 0


def test_realignment_disabled_by_default():
    p = DispatchPlanner(batch=128, n_instances=4096)
    for _ in range(50):
        assert p.plan_round([4] * 4, [0, 64, 0, 0], [True] * 4, [0] * 4).realign == ()
    assert p.stats["realignments"] == 0


def test_pack_rows_oversized_chunk_fails_up_front():
    rows = [np.full((4,), 7, np.int32) for _ in range(9)]
    with pytest.raises(ValueError) as ei:
        plan_mod.pack_rows(rows, 8, 4)
    assert "9" in str(ei.value) and "8" in str(ei.value)
    vals, active = plan_mod.pack_rows(rows[:8], 8, 4)
    assert active.all() and (vals == 7).all()


def test_report_snapshots_service_loads_not_aliases():
    p = DispatchPlanner(batch=32, n_instances=512)
    p.observe_service_loads([3, 1, 4])
    r1 = p.report()
    r1["service_loads"].append(99)
    r1["burst_shapes"].append(77)
    assert p.stats["service_loads"] == [3, 1, 4]
    r2 = p.report()
    p.observe_service_loads([0, 0, 0])
    assert r2["service_loads"] == [3, 1, 4]
    assert p.report()["service_loads"] == [0, 0, 0]


@pytest.mark.parametrize("sharded", [False, True])
def test_wave_depth_policy(sharded):
    """K > 1 only for full-batch cohorts whose every member has K full
    chunks queued, clamped by the knob and the ring; never when sharded
    or with the knob at 1.  The port plans waves it does not run yet."""
    p = DispatchPlanner(batch=32, n_instances=128, persistent_rounds=8, sharded=sharded)
    rp = p.plan_round(
        loads=[32, 32], marks=[0, 0], live=[True] * 2, crnd=[0, 0], pending=[160, 96]
    )
    k = 1 if sharded else 3
    assert rp.cohorts == (plan_mod.Cohort(gids=(0, 1), burst=32, rounds=k),)
    assert p.stats["persistent_waves"] == int(k > 1)
    rp = p.plan_round(loads=[8, 8], marks=[0, 0], live=[True] * 2, crnd=[0, 0], pending=[64, 64])
    assert all(c.rounds == 1 for c in rp.cohorts)
    p1 = DispatchPlanner(batch=32, n_instances=128, persistent_rounds=1)
    rp = p1.plan_round(loads=[32], marks=[0], live=[True], crnd=[0], pending=[320])
    assert rp.cohorts[0].rounds == 1 and p1.stats["persistent_waves"] == 0


def test_placement_map_matches_the_reference():
    pm = plan_mod.PlacementMap.identity(8, 4)
    assert pm.identity_map() and pm.n_groups == 8 and pm.n_shards == 2
    assert [pm.shard_of(g) for g in range(8)] == [0] * 4 + [1] * 4
    assert [pm.row_of(g) for g in range(8)] == [0, 1, 2, 3] * 2
    for bad in (((0, 0, 1, 3), 2), ((0, 1, 2), 2)):
        with pytest.raises(ValueError):
            plan_mod.PlacementMap(*bad)
    rng = np.random.default_rng(0)
    for loads in ([100, 1, 1, 1, 1, 1, 1, 1], [0] * 8, [5] * 8, *rng.integers(0, 50, (5, 8))):
        got = plan_mod.PlacementMap.weighted([int(x) for x in loads], 2, 4)
        want = rplan.PlacementMap.weighted([int(x) for x in loads], 2, 4)
        assert got.slot_of == want.slot_of and got.group_of == want.group_of
    moved = plan_mod.PlacementMap.identity(4, 2).swapped(0, 3)
    assert moved.slot_of == (3, 1, 2, 0) and moved.swapped(0, 3).identity_map()


# ---------------------------------------------------------------------------
# random schedules: the port's decisions are the reference's
# ---------------------------------------------------------------------------
def _plan_tuple(rp) -> tuple:
    return (
        tuple(dataclasses.astuple(c) for c in rp.cohorts),
        rp.enabled,
        rp.realign,
        rp.fragmentation,
        rp.full_fold,
    )


@pytest.mark.parametrize("seed", range(4))
def test_fold_and_blocks_match_the_reference_on_random_marks(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        cap = int(rng.choice([1, 2, 4, 6, 8, 12]))
        marks = [int(m) for m in rng.choice([0, 16, 32, 48], cap)]
        gids = sorted(int(x) for x in rng.choice(cap, int(rng.integers(1, cap + 1)), False))
        assert fold_width_full(gids, marks, cap) == rplan.fold_width_full(gids, marks, cap)
        assert cohort_blocks(gids, marks, cap) == rplan.cohort_blocks(gids, marks, cap)


@pytest.mark.parametrize("seed", range(4))
def test_planner_matches_the_reference_on_random_schedules(seed):
    rng = np.random.default_rng(100 + seed)
    g, batch = 8, 32
    kw = dict(
        batch=batch,
        n_instances=1024,
        realign_after=[None, 1, 3][seed % 3],
        persistent_rounds=[1, 4][seed % 2],
    )
    ours, theirs = DispatchPlanner(**kw), rplan.DispatchPlanner(**kw)
    marks = [0] * g
    for _ in range(300):
        loads = [int(x) for x in rng.choice([0, 1, 5, 9, 17, 32], g)]
        pending = [ld + int(rng.integers(0, 4)) * batch for ld in loads]
        live = [bool(x) for x in rng.random(g) < 0.9]
        crnd = [NO_ROUND if x < 0.1 else 0 for x in rng.random(g)]
        args = (loads, list(marks), live, crnd)
        got = ours.plan_round(*args, pending=pending)
        want = theirs.plan_round(*args, pending=pending)
        assert _plan_tuple(got) == _plan_tuple(want)
        for gid, target in got.realign:
            marks[gid] = target
        for c in got.cohorts:
            for gid in c.gids:
                marks[gid] += c.burst * c.rounds
        be = quantize_burst(int(rng.integers(1, 40)), batch)
        ours.note_burst(be)
        theirs.note_burst(be)
    assert ours.report() == theirs.report()


# ---------------------------------------------------------------------------
# context level: the port's grouped context against the reference's
# ---------------------------------------------------------------------------
def _pair(cfg: dict, **kw):
    ref = R.PaxosContext(R.PaxosConfig(persistent_rounds=1, **cfg), **kw)
    got = T.PaxosContext(T.PaxosConfig(persistent_rounds=1, **cfg), device="cpu", **kw)
    return ref, got


def test_skewed_submit_run_mints_the_references_burst_shapes():
    """About 400 submits with per-group loads swept across every level and
    a stretch under a software coordinator: pow2 bursts in [MIN_BURST,
    batch] only, and the same plan, shapes and logs as the reference."""
    ref, got = _pair(dict(n_acceptors=3, n_instances=2048, batch=64, n_groups=4), use_kernels=True)
    for ctx in (ref, got):
        rng = np.random.default_rng(0)
        for wave in range(10):
            if wave == 3:
                ctx.fail_coordinator(group=1)
            if wave == 6:
                ctx.restore_hardware_coordinator(group=1)
            for gid in range(4):
                k = int(rng.integers(0, 65)) if gid else 64
                for j in range(k):
                    ctx.submit(f"w{wave}g{gid}j{j}".encode(), group=gid)
            ctx.run_until_quiescent()
    assert got.stats == ref.stats and got.stats["delivered"] == got.stats["submitted"]
    assert set(got.planner.stats["burst_shapes"]) <= {8, 16, 32, 64}
    assert got.planner.report() == ref.planner.report()
    assert got.group_log == ref.group_log
    assert got.hw.dispatch_count == ref.hw.dispatch_count and got.hw.last_gb == ref.hw.last_gb


@pytest.mark.parametrize("use_kernels", [False, True])
def test_realignment_restores_full_width_fold_after_failover(use_kernels):
    """A divergent failover, then the realignment sweep: the full-width fold
    re-engages, burned instances are never delivered, and every decision
    equals the reference's (both with ``use_kernels``, the reference's
    Pallas kernels in interpret mode)."""
    g = 4
    ref, got = _pair(
        dict(n_acceptors=3, n_instances=512, batch=32, n_groups=g, realign_after=2),
        use_kernels=use_kernels,
    )
    for ctx in (ref, got):
        sent = [[] for _ in range(g)]

        def wave(tag, extra=0, ctx=ctx, sent=sent):
            for gid in range(g):
                for j in range(1 + (extra if gid == 1 else 0)):
                    p = f"{tag}g{gid}j{j}".encode()
                    sent[gid].append(p)
                    ctx.submit(p, group=gid)
            ctx.run_until_quiescent()

        wave("w0")
        ctx.fail_coordinator(group=1)
        wave("w1", extra=8)
        wave("w2")
        ctx.restore_hardware_coordinator(group=1)
        assert len(set(ctx.hw.next_inst_host)) > 1
        for k in range(3):
            wave(f"r{k}")
        assert ctx.planner.stats["realignments"] >= 1
        assert len(set(ctx.hw.next_inst_host)) == 1 and ctx.hw.last_gb == g
        assert ctx.planner.last_plan.full_fold
        wave("post")
        for gid in range(g):
            assert [p for _i, p in ctx.group_log[gid]] == sent[gid]
    assert got.group_log == ref.group_log
    assert got.hw.next_inst_host == ref.hw.next_inst_host
    assert got.planner.report() == ref.planner.report()


def test_burn_forward_is_monotone():
    ctx = T.PaxosContext(
        T.PaxosConfig(n_acceptors=3, n_instances=256, batch=16, n_groups=2, persistent_rounds=1),
        device="cpu",
    )
    ctx.hw.burn_forward(1, 32)
    assert ctx.hw.next_inst_host == [0, 32]
    assert ctx.hw.cstate.next_inst.tolist() == [0, 32]
    with pytest.raises(ValueError):
        ctx.hw.burn_forward(1, 16)
    ctx.submit(b"x", group=1)
    ctx.run_until_quiescent()
    assert ctx.group_log[1] == [(32, b"x")]
