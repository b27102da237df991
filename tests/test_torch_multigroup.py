"""The port's multi-group service against the reference's, bit for bit.

``repro_torch.core.PaxosContext(PaxosConfig(n_groups=G, persistent_rounds=1))``
and the reference's, both with ``use_kernels=True`` (the reference runs its
Pallas kernels in interpret mode, the port its plain versions on the CPU),
get the same schedules over the same seeded lossy ``SimNet``: uniform and
skewed load, snapshots under ring reclamation, per-group acceptor kills,
coordinator failover and recovery, crash and restore, retire, create and
adopt.  Group logs, retired logs, seals, the final slabs and host mirrors,
``dispatch_count``, every dispatch's fold width and the planner's report
must be equal.  The cases of ``tests/test_multigroup.py`` (independent
twins, failover isolation, idle groups under skew, recovery, the membership
free-list, retire drains, a vacant slot folded inert) run on the port too,
and the state bridge carries a mid-run reference dataplane into the port.
These run at ``persistent_rounds=1``; the defaults, with persistent waves,
run in ``tests/test_torch_persistent.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.bridge import export_state, import_state  # noqa: E402

FAULTS = dict(drop=0.05, dup=0.05, reorder=0.1)


def _cfg(pkg, g: int, **kw):
    base = dict(n_acceptors=3, n_instances=512, batch=16, n_groups=g, persistent_rounds=1)
    return pkg.PaxosConfig(**{**base, **kw})


def _pair(g: int, seed: int | None = None, cfg_kw=None, **kw):
    """The reference's and the port's grouped contexts, on equal nets."""
    out = []
    for pkg, extra in ((R, {}), (T, {"device": "cpu"})):
        net = pkg.SimNet() if seed is None else pkg.SimNet(pkg.FaultSpec(**FAULTS), seed)
        ctx = pkg.PaxosContext(_cfg(pkg, g, **(cfg_kw or {})), net=net, use_kernels=True,
                               **kw, **extra)  # fmt: skip
        out.append(ctx)
    return out


def _record_folds(hw) -> list[int]:
    """Every cohort dispatch's fold width, in order."""
    seen: list[int] = []
    dispatch = hw.pipeline_cohort

    def recorded(*args, **kw):
        out = dispatch(*args, **kw)
        seen.append(hw.last_gb)
        return out

    hw.pipeline_cohort = recorded
    return seen


def _group_state(hw, gid: int | None = None) -> list[np.ndarray]:
    leaves = [*vars(hw.stack).values(), *vars(hw.lstate).values()]
    return [np.asarray(x if gid is None else x[gid]) for x in leaves]


def _assert_same(ref, got) -> None:
    for gid in range(ref.n_groups):
        assert got.full_group_log(gid) == ref.full_group_log(gid), gid
    assert got.group_log == ref.group_log
    assert got.stats == ref.stats
    want, have = export_state(ref.hw), export_state(got.hw)
    assert want.keys() == have.keys()
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)
    assert got.hw.dispatch_count == ref.hw.dispatch_count
    assert got.hw.last_gb == ref.hw.last_gb
    assert got.planner.report() == ref.planner.report()
    assert got.quiescent() and ref.quiescent()


def _service_schedule(ctx, g: int) -> list:
    """Uniform load (the full-width fold), skewed load with snapshots (hot
    group 0, a lockstep pair 2-3, an idle group 1), a kill and revive, a
    failover with others under load, a recovery, a crash and restore, then
    retire + create and retire + adopt.  Returns what each step returned."""
    out = []
    hw = ctx.hw

    def wave(tag, loads):
        for gid, k in enumerate(loads):
            for j in range(k):
                ctx.submit(f"{tag}g{gid}j{j}-{'x' * (j % 30)}".encode(), group=gid)
        ctx.run_until_quiescent()

    def snap_all():
        out.extend(ctx.snapshot_group(gid).seal for gid in ctx.live_groups())

    for w in range(3):
        wave(f"u{w}", [16] * g)
    snap_all()
    for w in range(4):
        wave(f"s{w}", [40, 0, 5, 5] + [w % 3] * (g - 4))
        out.append(ctx.snapshot_group(0).seal)
    hw.kill_acceptor(1, 2)
    wave("k", [3] * g)
    hw.revive_acceptor(1, 2)
    gap = hw.next_inst_host[2]
    out.append(ctx.fail_coordinator(est_next_inst=gap + 16, group=2).next_inst)
    wave("f", [6] * g)
    ctx.restore_hardware_coordinator(group=2)
    ctx.recover(gap + 1, group=2)
    wave("r", [2] * g)
    ctx.crash_acceptor(0, group=3)
    wave("c", [7] * g)
    snap_all()
    out.append(ctx.restore_acceptor(0, group=3))
    out.append(ctx.retire_group(g - 1))
    out.append(ctx.create_group())
    out.append(ctx.retire_group(g - 2))
    snap = ctx.snapshot_group(1)
    out.append(ctx.adopt_group(snap, ctx.full_group_log(1)))
    for w in range(2):
        wave(f"e{w}", [9] * g)
    snap_all()
    return out


@pytest.mark.parametrize("g", [4, 8])
def test_service_matches_reference(g):
    ref, got = _pair(g, seed=g, snapshots=True)
    folds = [_record_folds(ref.hw), _record_folds(got.hw)]
    want = _service_schedule(ref, g)
    have = _service_schedule(got, g)
    assert have == want
    _assert_same(ref, got)
    assert folds[1] == folds[0]
    assert {1, 2, g} <= set(folds[1]), sorted(set(folds[1]))


def test_single_group_dataplane_matches_reference():
    """G=1 as a multi-group dataplane (no context is grouped at G=1): full
    width and cohort rounds, a frozen round, reclamation, kill and wipe."""
    ref = R.MultiGroupDataplane(_cfg(R, 1), use_kernels=True)
    got = T.MultiGroupDataplane(_cfg(T, 1), use_kernels=True, device="cpu")
    rng = np.random.default_rng(1)
    for hw in (ref, got):
        hw.enable_reclamation()
    for step in range(40):
        b = int(rng.choice([8, 16]))
        values = rng.integers(-(2**31), 2**31, (1, b, 16), dtype=np.int32)
        active = rng.random((1, b)) < 0.8
        for hw in (ref, got):
            if step == 10:
                hw.kill_acceptor(0, 1)
            if step == 20:
                hw.wipe_acceptor(0, 1)
                hw.revive_acceptor(0, 1)
            if step == 25:
                hw.set_reclaimed(0, hw.next_inst_host[0])
            if step == 30:
                hw.freeze_group(0)
            if step == 35:
                hw.restore_group(0, hw.next_inst_host[0] + 5, 3)
            if step % 2:
                res = hw.pipeline_cohort([0], values, active)
            else:
                res = hw.pipeline(values, active)
            if hw is ref:
                want = res
        for w, h in zip(want, res, strict=True):
            np.testing.assert_array_equal(h, w)
    for key, arr in export_state(ref).items():
        np.testing.assert_array_equal(export_state(got)[key], arr, err_msg=key)
    assert got.dispatch_count == ref.dispatch_count and got.last_gb == ref.last_gb


@pytest.mark.parametrize("use_kernels", [False, True])
def test_groups_match_independent_contexts(use_kernels):
    """G fused groups == G independent single-group contexts of the port,
    bit for bit, a dead acceptor in one group included; and == the
    reference's grouped context."""
    g = 4
    ref = R.PaxosContext(_cfg(R, g), use_kernels=True)
    mg = T.PaxosContext(_cfg(T, g), use_kernels=use_kernels, device="cpu")
    singles = [
        T.PaxosContext(_cfg(T, 1), fused=True, use_kernels=use_kernels, device="cpu")
        for _ in range(g)
    ]
    for ctx in (ref, mg):
        ctx.hw.kill_acceptor(2, 1)
    singles[2].hw.kill_acceptor(1)
    for w in range(3):
        for gid in range(g):
            for ctx in (ref, mg):
                ctx.submit(f"w{w}g{gid}".encode(), group=gid)
            singles[gid].submit(f"w{w}g{gid}".encode())
        for ctx in (ref, mg, *singles):
            ctx.run_until_quiescent()
    for gid, single in enumerate(singles):
        assert mg.group_log[gid] == single.delivered_log
        for a, b in zip(_group_state(mg.hw, gid), _group_state(single.hw), strict=True):
            np.testing.assert_array_equal(a, b)
    assert mg.group_log == ref.group_log


def test_group_failover_does_not_perturb_others():
    """A failover in one group: every other group stays equal to an
    independent twin that never saw one, and the victim equals its twin
    that failed over too."""
    g, victim = 4, 1
    mg = T.PaxosContext(_cfg(T, g), device="cpu")
    singles = [T.PaxosContext(_cfg(T, 1), fused=True, device="cpu") for _ in range(g)]

    def waves(n, tag):
        for w in range(n):
            for gid in range(g):
                mg.submit(f"{tag}{w}g{gid}".encode(), group=gid)
                singles[gid].submit(f"{tag}{w}g{gid}".encode())
            for ctx in (mg, *singles):
                ctx.run_until_quiescent()

    waves(2, "a")
    mg.fail_coordinator(group=victim)
    singles[victim].fail_coordinator()
    waves(2, "b")
    mg.restore_hardware_coordinator(group=victim)
    singles[victim].restore_hardware_coordinator()
    waves(2, "c")
    for gid, single in enumerate(singles):
        assert mg.group_log[gid] == single.delivered_log
        for a, b in zip(_group_state(mg.hw, gid), _group_state(single.hw), strict=True):
            np.testing.assert_array_equal(a, b)
    assert all(len(log) == 6 for log in mg.group_log)


def test_idle_group_unperturbed_under_skewed_load():
    """Group 0 laps its 64-slot ring three times; idle group 1 burns nothing
    and equals a deployment never pumped, then serves, as the reference."""
    ref, got = _pair(2, seed=3, cfg_kw=dict(n_instances=64))
    fresh = T.MultiGroupDataplane(_cfg(T, 1, n_instances=64), device="cpu")
    for ctx in (ref, got):
        for w in range(12):
            for k in range(16):
                ctx.submit(f"w{w}k{k}".encode(), group=0)
            ctx.run_until_quiescent()
        assert len(ctx.group_log[0]) == 192 and ctx.group_log[1] == []
        assert ctx.hw.next_inst_host[1] == 0 and not ctx.learned_g[1]
    for a, b in zip(_group_state(got.hw, 1), _group_state(fresh, 0), strict=True):
        np.testing.assert_array_equal(a, b)
    for ctx in (ref, got):
        ctx.submit(b"late", group=1)
        ctx.run_until_quiescent()
    assert [p for _i, p in got.group_log[1]] == [b"late"]
    _assert_same(ref, got)


def test_group_recover_targets_one_group():
    """``recover`` decides a no-op into the addressed group only."""
    g = 4
    ref, got = _pair(g)
    for ctx in (ref, got):
        for w in range(2):
            for gid in range(g):
                ctx.submit(f"w{w}g{gid}".encode(), group=gid)
            ctx.run_until_quiescent()
    before = [_group_state(got.hw, gid) for gid in range(g)]
    for ctx in (ref, got):
        ctx.recover(100, group=3)
        ctx.pump()
    for gid in range(3):
        for a, b in zip(before[gid], _group_state(got.hw, gid), strict=True):
            np.testing.assert_array_equal(a, b)
    assert got.hw.stack.vrnd[3, :, 100].max() >= 0
    assert all(len(log) == 2 for log in got.group_log)
    _assert_same(ref, got)


def test_membership_freelist_deterministic_and_bounded():
    hw = T.MultiGroupDataplane(_cfg(T, 4, n_instances=64, batch=8), device="cpu")
    with pytest.raises(RuntimeError):
        hw.create_group()  # at capacity
    hw.retire_group(3)
    hw.retire_group(1)
    assert hw.live_groups() == [0, 2]
    with pytest.raises(ValueError):
        hw.retire_group(1)
    assert hw.create_group() == 1 and hw.create_group() == 3
    assert hw.live_groups() == [0, 1, 2, 3]
    ctx = T.PaxosContext(_cfg(T, 4, n_instances=64, batch=8), device="cpu")
    ctx.retire_group(2)
    for call in (
        lambda: ctx.submit(b"x", group=2),
        lambda: ctx.recover(0, group=2),
        lambda: ctx.fail_coordinator(group=2),
        lambda: ctx.retire_group(2),
    ):
        with pytest.raises(ValueError):
            call()


def test_retire_flushes_in_flight_traffic_before_slot_reuse():
    ctx = T.PaxosContext(_cfg(T, 2, n_instances=64, batch=8), device="cpu")
    ctx.submit(b"stale", group=1)  # queued, never pumped
    ctx.retire_group(1)
    assert ctx.create_group() == 1
    ctx.pump()
    assert ctx.group_log[1] == []
    ctx.submit(b"fresh", group=1)
    ctx.run_until_quiescent()
    assert [p for _i, p in ctx.group_log[1]] == [b"fresh"] and not ctx._pending
    ctx.submit(b"keep", group=0)
    ctx.recover(5, group=1)
    ctx.retire_group(1)
    ctx.run_until_quiescent()
    assert [p for _i, p in ctx.group_log[0]] == [b"keep"]


def test_retire_drains_learner_ring_and_touches_no_other_group():
    g = 4
    ref, got = _pair(g)
    for ctx in (ref, got):
        for w in range(2):
            for gid in range(g):
                ctx.submit(f"w{w}g{gid}".encode(), group=gid)
            ctx.run_until_quiescent()
    others = [_group_state(got.hw, gid) for gid in (0, 2, 3)]
    drained = got.hw.retire_group(1)
    assert drained == ref.hw.retire_group(1)
    values = [(i, np.frombuffer(raw, "<i4")[0]) for i, raw in drained]
    client = [i for i, seq in values if seq != -0x7FFFFFFF]  # NOP fillers left out
    assert client == sorted(client) and len(client) == 2
    assert got.hw.create_group() == ref.hw.create_group() == 1
    for before, gid in zip(others, (0, 2, 3), strict=True):
        for a, b in zip(before, _group_state(got.hw, gid), strict=True):
            np.testing.assert_array_equal(a, b)
    fresh = T.MultiGroupDataplane(_cfg(T, 1), device="cpu")
    for a, b in zip(_group_state(got.hw, 1), _group_state(fresh, 0), strict=True):
        np.testing.assert_array_equal(a, b)


def test_vacant_slot_rides_folded_dispatch_inert():
    """A recreated slot at a divergent watermark does not break the fold of
    the others, and its rows stay untouched while they decide."""
    ref, got = _pair(4, cfg_kw=dict(n_instances=64, batch=8))
    for ctx in (ref, got):
        for gid in range(4):
            ctx.submit(f"a{gid}".encode(), group=gid)
        ctx.run_until_quiescent()
        ctx.retire_group(0)
        assert ctx.create_group() == 0
        assert ctx.hw.next_inst_host == [0, 8, 8, 8]
        assert ctx.hw._plan_round(8, [False, True, True, True])[2] == 4
    vacant = _group_state(got.hw, 0)
    for ctx in (ref, got):
        for gid in range(1, 4):
            ctx.submit(f"b{gid}".encode(), group=gid)
        ctx.run_until_quiescent()
    assert got.hw.last_gb == ref.hw.last_gb == 4
    for a, b in zip(vacant, _group_state(got.hw, 0), strict=True):
        np.testing.assert_array_equal(a, b)
    for ctx in (ref, got):
        ctx.submit(b"late", group=0)
        ctx.run_until_quiescent()
    assert [p for _i, p in got.group_log[0]] == [b"late"]
    _assert_same(ref, got)


def test_group_view_votes_in_place_on_row_views():
    """One group's staged vote writes that group's rows of the slabs in
    place: the slabs keep their storage and the other groups' rows their
    values."""
    hw = T.MultiGroupDataplane(_cfg(T, 4), device="cpu")
    ptrs = [x.data_ptr() for x in (*vars(hw.stack).values(), *vars(hw.lstate).values())]
    others = [_group_state(hw, gid) for gid in (0, 1, 3)]
    view = hw.group_view(2)
    p2a = T.MsgBatch.nop(16, 16).replace(
        msgtype=torch.full((16,), 3, dtype=torch.int32),
        inst=torch.arange(16, dtype=torch.int32),
        rnd=torch.full((16,), 5, dtype=torch.int32),
    )
    votes = view.vote(p2a)
    assert all(v.gid == 2 for v in votes)
    assert [x.data_ptr() for x in (*vars(hw.stack).values(), *vars(hw.lstate).values())] == ptrs
    assert (hw.stack.vrnd[2, :, :16] == 5).all() and (hw.stack.vrnd[2, :, 16:] == -1).all()
    for before, gid in zip(others, (0, 1, 3), strict=True):
        for a, b in zip(before, _group_state(hw, gid), strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rounds_before", [3, 6])
def test_bridge_carries_a_mid_run_reference_dataplane(rounds_before):
    """A reference multi-group dataplane runs cohort and full-width rounds
    (a retire, a freeze, reclamation marks); its exported state, loaded
    into the port, runs on identically."""
    g = 4
    ref = R.MultiGroupDataplane(_cfg(R, g), use_kernels=True)
    ref.enable_reclamation()
    rng = np.random.default_rng(rounds_before)

    def rounds(hws, count):
        for k in range(count):
            gids = sorted(int(x) for x in rng.choice([0, 1, 3], int(rng.integers(1, 4)), False))
            b = int(rng.choice([8, 16]))
            values = rng.integers(-(2**31), 2**31, (len(gids), b, 16), dtype=np.int32)
            active = np.ones((len(gids), b), bool)
            outs = [hw.pipeline_cohort(gids, values, active) for hw in hws]
            for out in outs[1:]:
                for w, h in zip(outs[0], out, strict=True):
                    np.testing.assert_array_equal(h, w)

    rounds([ref], rounds_before)
    ref.retire_group(2)
    ref.freeze_group(3)
    ref.set_reclaimed(0, ref.next_inst_host[0])
    got = T.MultiGroupDataplane(_cfg(T, g), use_kernels=True, device="cpu")
    import_state(got, export_state(ref))
    rounds([ref, got], 6)
    for hw in (ref, got):
        hw.restore_group(3, hw.next_inst_host[3], 7)
        hw.create_group()
    rounds([ref, got], 4)
    for key, arr in export_state(ref).items():
        np.testing.assert_array_equal(export_state(got)[key], arr, err_msg=key)


def test_persistent_waves_are_refused():
    """Persistent waves are ported: ``PaxosConfig(n_groups=2)`` (its
    defaults ``persistent_rounds=8`` and ``async_pump=True``) runs, forms
    waves and equals the reference's context on a lossy net: logs, state,
    ``dispatch_count``, fold width and plan."""
    ref, got = (
        pkg.PaxosContext(pkg.PaxosConfig(n_groups=2, n_instances=1024), use_kernels=True,
                         net=pkg.SimNet(pkg.FaultSpec(**FAULTS), 2), **extra)
        for pkg, extra in ((R, {}), (T, {"device": "cpu"}))
    )  # fmt: skip
    for ctx in (ref, got):
        assert ctx.cfg.persistent_rounds == 8 and ctx.cfg.async_pump
        for gid, k in ((0, 600), (1, 300)):
            for j in range(k):
                ctx.submit(f"g{gid}j{j}".encode(), group=gid)
        ctx.run_until_quiescent()
    assert got.planner.report()["persistent_waves"] > 0
    _assert_same(ref, got)
