"""The port's groups-sharded service against the reference, bit for bit.

``repro_torch.core.ShardedMultiGroupDataplane`` and ``PaxosContext(cfg,
mesh=make_group_mesh(S, "cpu"))`` run on the port's mesh at S in {1, 2, 4}
logical shards on the CPU (each shard's body a plain version: K6's and K1's
shard slice's under ``use_kernels``, the plain engine without).  The
reference's own sharded dataplane fails under jax 0.9.0 (ROADMAP.md queue
3), its 1-device mesh included, so the port is held against the reference's
unsharded ``MultiGroupDataplane`` and ``PaxosContext(n_groups=G)``, against
G scalar ``core.paxos`` oracles and against per-group single-group twins:
the triangle ``tests/test_sharded_multigroup.py`` asserts.  Where the
sharded engine differs by design (a persistent wave is K dispatches; the
fold width is capped at the per-shard slab ``Gl``), the test says so and
checks the value the reference's sharded code computes.
Tolerance: none, every int32 equal.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.paxos import Acceptor, Coordinator, Learner, Msg  # noqa: E402
from repro.core.types import MSG_P2A, MSG_P2B  # noqa: E402
from repro.core import plan as rplan  # noqa: E402
from repro_torch.core import batched, fabric  # noqa: E402
from repro_torch.core.bridge import export_state  # noqa: E402
from repro_torch.core.plan import NO_ROUND, NOP_SENTINEL  # noqa: E402
from repro_torch.launch.mesh import GroupMesh, make_group_mesh  # noqa: E402

FAULTS = dict(drop=0.05, dup=0.05, reorder=0.1)
V = 4  # value words: a 16-byte value holds the tests' payloads and their header


class _ScalarGroup:
    """One group's scalar-oracle run of the fused Phase-2 round, on the
    reference's unmodified ``core.paxos`` roles."""

    def __init__(self, n_acceptors: int, n_instances: int):
        self.co = Coordinator(cid=0, n_instances=n_instances)
        self.acceptors = [Acceptor(aid=i, n_instances=n_instances) for i in range(n_acceptors)]
        self.learner = Learner(lid=0, n_acceptors=n_acceptors)

    def round(self, values: np.ndarray, alive) -> list:
        decided = []
        for j in range(values.shape[0]):
            p2a = self.co.on_submit(Msg(5, value=values[j]))
            d = None
            for aid, acc in enumerate(self.acceptors):
                if not alive[aid]:
                    continue
                out = acc.on_p2a(Msg(MSG_P2A, inst=p2a.inst, rnd=p2a.rnd, value=values[j]))
                if out.msgtype == MSG_P2B:
                    got = self.learner.on_p2b(
                        Msg(MSG_P2B, inst=out.inst, rnd=out.rnd, vrnd=out.vrnd, swid=aid,
                            value=out.value)
                    )  # fmt: skip
                    if got is not None:
                        d = got
            decided.append(d)
        return decided

    def check(self, values, alive, fresh, inst, value) -> None:
        for j, d in enumerate(self.round(values, alive)):
            assert (d is not None) == bool(fresh[j]), j
            if d is not None:
                assert d.inst == inst[j]
                np.testing.assert_array_equal(d.value, value[j])


def _leaves(hw, rows=None) -> list[np.ndarray]:
    """The slabs in slot order: the port's sharded dataplane through its
    gather, any other through its ``(G, ...)`` state."""
    if isinstance(hw, T.ShardedMultiGroupDataplane):
        out = list(hw.gather().values())
    else:
        out = [np.asarray(x) for x in (*vars(hw.stack).values(), *vars(hw.lstate).values())]
    return out if rows is None else [x[rows] for x in out]


def _same(a, b) -> None:
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _cfg(pkg, g, **kw):
    base = dict(n_acceptors=3, n_instances=128, batch=16, n_groups=g, value_words=V)
    return pkg.PaxosConfig(**{**base, **kw})


def _sharded_fold(sh, gids) -> int:
    """The fold width the reference's sharded dataplane reports for a
    dispatch of ``gids`` (``api.py:1151-1154``, ``:1235-1238``): the
    reference's ``plan.fold_width_full`` over slot-ordered watermarks,
    capped at the per-shard slab."""
    pm = sh.placement
    marks = [sh.next_inst_host[gid] for gid in pm.group_of]
    return rplan.fold_width_full([pm.slot_of[gid] for gid in gids], marks, sh.groups_per_shard)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_matches_unsharded_and_scalar_oracle(shards, use_kernels):
    """Sharded == the reference's unsharded dataplane == G scalar oracles,
    full-width rounds and ragged cohorts alike, through a frozen group, a
    dead acceptor and two laps of the ring; every dispatch's ``last_gb``
    is the fold the reference's sharded code computes."""
    g = 4
    ref = R.MultiGroupDataplane(_cfg(R, g))
    sh = T.ShardedMultiGroupDataplane(
        _cfg(T, g), mesh=make_group_mesh(shards, "cpu"), use_kernels=use_kernels
    )
    twins = [ref]
    oracles = [_ScalarGroup(3, 128) for _ in range(g)]
    alive = np.ones((g, 3), bool)
    for hw in (*twins, sh):
        hw.kill_acceptor(g - 1, 2)
    alive[g - 1, 2] = False
    rng = np.random.default_rng(7)
    frozen = None
    rounds = 2 * 128 // 16 + 2  # laps the ring twice
    cohorts = [[1, 3], [2], [1, 2, 3], [3]]
    for r in range(rounds):
        if r == 2:
            frozen = 0
            for hw in (*twins, sh):
                hw.freeze_group(frozen)
        if frozen is not None and r == rounds - 3:
            back = sh.next_inst_host[frozen]
            for hw in (*twins, sh):
                hw.restore_group(frozen, back, 0)
            frozen = None
        vals = rng.integers(-99, 99, (g, 16, V)).astype(np.int32)
        act = np.ones((g, 16), bool)
        gb = _sharded_fold(sh, [gid for gid in range(g) if gid != frozen])
        have = sh.pipeline(vals, act)
        assert sh.last_gb == gb
        for hw in twins:
            _same(hw.pipeline(vals, act), have)
        for gid in range(g):
            if gid == frozen:
                assert not have[0][gid].any()
                continue
            oracles[gid].check(vals[gid], alive[gid], *(x[gid] for x in have))
        gids = cohorts[r % len(cohorts)]
        be = 8 if r % 2 else 16
        cv = rng.integers(-99, 99, (len(gids), be, V)).astype(np.int32)
        ca = np.ones((len(gids), be), bool)
        gb = _sharded_fold(sh, gids)
        have = sh.pipeline_cohort(gids, cv, ca)
        assert sh.last_gb == gb
        for hw in twins:
            _same(hw.pipeline_cohort(gids, cv, ca), have)
        for row, gid in enumerate(gids):
            oracles[gid].check(cv[row], alive[gid], *(x[row] for x in have))
        assert sh.dispatch_count == ref.dispatch_count
    for hw in twins:
        _same(_leaves(hw), _leaves(sh))
    slabs = sh.gather()
    h_rnd, h_vrnd = slabs["stack.rnd"], slabs["stack.vrnd"]
    for gid, oracle in enumerate(oracles):
        for aid, acc in enumerate(oracle.acceptors):
            for slot, (rnd, vrnd, _val) in acc.slots.items():
                assert h_rnd[gid, aid, slot] == rnd, (gid, aid, slot)
                assert h_vrnd[gid, aid, slot] == vrnd, (gid, aid, slot)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_packed_dispatch_equals_full_width(use_kernels):
    """The packed cohort dispatch == the full-width sharded dispatch with
    only the cohort enabled, in slabs and outputs, on a 2-shard mesh with a
    ragged cohort (two lanes on shard 0, one lane and one pad on shard 1)
    and a dead acceptor."""
    rng = np.random.default_rng(0)
    g, a, n, v, b = 8, 3, 256, 2, 16
    gl = g // 2
    mesh = make_group_mesh(2, "cpu")
    _cs, stack, lstate = batched.init_multigroup_state(g, a, n, v)

    def halves(st):  # each shard's slab: its rows of the (G, ...) state, as views
        return [type(st)(*(x[s * gl : (s + 1) * gl] for x in vars(st).values())) for s in (0, 1)]

    full = fabric.make_sharded_multigroup_round(mesh, n_groups=g, quorum=2, use_kernels=False)
    ni = np.zeros((g,), np.int32)
    for _ in range(2):  # prime every ring with two full-width rounds
        vals = rng.integers(0, 100, (g, b, v)).astype(np.int32)
        full(ni, np.full((g,), 7), np.ones((g,)), np.ones((g, a)), halves(stack), halves(lstate),
             vals, None)  # fmt: skip
        ni = ni + b
    gids, c = [1, 2, 6], 2
    seg, enp, nip = (np.zeros((2, c), np.int32) for _ in range(3))
    crp = np.full((2, c), NO_ROUND, np.int32)
    alp = np.ones((2, c, a), np.int32)
    valsp = np.full((2, c, b, v), NOP_SENTINEL, np.int32)
    cohort_vals = rng.integers(0, 100, (len(gids), b, v)).astype(np.int32)
    lanes: dict[int, list[int]] = {0: [], 1: []}
    for i, gid in enumerate(gids):
        s, j = gid // gl, len(lanes[gid // gl])
        lanes[s].append(gid)
        seg[s, j], enp[s, j], nip[s, j], crp[s, j] = gid % gl, 1, ni[gid], 7
        valsp[s, j] = cohort_vals[i]
    alp[0, 1, 0] = 0  # a dead acceptor on group 2
    alive_full = np.ones((g, a), np.int32)
    alive_full[2, 0] = 0
    en_r = np.zeros((g,), np.int32)
    cr_r = np.full((g,), NO_ROUND, np.int32)
    vals_r = np.full((g, b, v), NOP_SENTINEL, np.int32)
    for i, gid in enumerate(gids):
        en_r[gid], cr_r[gid], vals_r[gid] = 1, 7, cohort_vals[i]

    def copy(st):
        return type(st)(*(x.clone() for x in vars(st).values()))

    st, ls = copy(stack), copy(lstate)
    _, _, fresh_r, _i, win_r, val_r = full(ni, cr_r, en_r, alive_full, halves(st), halves(ls),
                                           vals_r, None)  # fmt: skip
    ref = (*vars(st).values(), *vars(ls).values())
    packed = fabric.make_packed_sharded_round(mesh, quorum=2, use_kernels=use_kernels)
    st, ls = copy(stack), copy(lstate)
    _, _, fresh, inst, win, val = packed(seg, nip, crp, enp, alp, halves(st), halves(ls), valsp)
    _same((*vars(st).values(), *vars(ls).values()), ref)
    fresh, win, val = (x.reshape((2, c, *x.shape[1:])) for x in (fresh, win, val))
    for gid in gids:
        s, j = gid // gl, lanes[gid // gl].index(gid)
        _same((fresh[s, j], win[s, j], val[s, j]), (fresh_r[gid], win_r[gid], val_r[gid]))
        np.testing.assert_array_equal(inst.reshape(2, c, b)[s, j], ni[gid] + np.arange(b))
    assert fresh_r[[1, 6]].all() and not fresh[1, 1].any() and (win[1, 1] == -1).all()


@pytest.mark.parametrize("shards", [1, 2])
def test_persistent_wave_is_k_cohort_dispatches(shards):
    """``pipeline_persistent`` on the sharded dataplane == K sequential
    ``pipeline_cohort`` calls == the reference's unsharded wave, in results
    and slabs, with ``dispatch_count`` grown by K (the reference's K=1
    fallback); a wave whose last window passes a reclaim limit raises
    before anything moves."""
    g, k, be = 4, 3, 16
    cfg_kw = dict(n_instances=256)
    ref = R.MultiGroupDataplane(_cfg(R, g, **cfg_kw))
    wave, seq = (
        T.ShardedMultiGroupDataplane(_cfg(T, g, **cfg_kw), mesh=make_group_mesh(shards, "cpu"))
        for _ in range(2)
    )
    rng = np.random.default_rng(5)
    for gids in ([0, 2], [1, 2, 3], [3]):
        vals = rng.integers(-50, 50, (k, len(gids), be, V)).astype(np.int32)
        act = np.ones((k, len(gids), be), bool)
        before = wave.dispatch_count
        have = wave.pipeline_persistent(gids, vals, act, defer=True).resolve()
        assert wave.dispatch_count - before == k
        _same(ref.pipeline_persistent(gids, vals, act), have)
        outs = [seq.pipeline_cohort(gids, vals[r], act[r]) for r in range(k)]
        _same([np.stack(x) for x in zip(*outs, strict=True)], have)
    _same(_leaves(ref), _leaves(wave))
    _same(_leaves(seq), _leaves(wave))
    wave.enable_reclamation()
    wave.set_reclaimed(1, 0)
    state, count = _leaves(wave), wave.dispatch_count
    vals = np.zeros((16, 1, be, V), np.int32)  # its last window passes 0 + N
    with pytest.raises(T.RingOverflowError):
        wave.pipeline_persistent([1], vals, np.ones((16, 1, be), bool))
    assert wave.dispatch_count == count
    _same(_leaves(wave), state)


def test_placement_and_validation():
    cfg = _cfg(T, 4)
    sh = T.ShardedMultiGroupDataplane(cfg, mesh=make_group_mesh(2, "cpu"))
    assert sh.group_placement() == [0, 0, 1, 1]
    assert [sh.shard_of_group(gid) for gid in range(4)] == sh.group_placement()
    assert sh.plan_placement([5, 1, 1, 5]).slot_of == (0, 1, 3, 2)
    with pytest.raises(ValueError, match="out of range"):
        sh.shard_of_group(4)
    with pytest.raises(ValueError, match="must be divisible by the 'groups' mesh axis size 2"):
        T.ShardedMultiGroupDataplane(_cfg(T, 3), mesh=make_group_mesh(2, "cpu"))
    bad_axis = GroupMesh((torch.device("cpu"),), axis_names=("data",))
    with pytest.raises(ValueError, match="mesh has no 'groups' axis"):
        T.ShardedMultiGroupDataplane(cfg, mesh=bad_axis)
    with pytest.raises(ValueError, match="mesh has no 'groups' axis"):
        fabric.make_packed_sharded_round(bad_axis, quorum=2)
    with pytest.raises(ValueError, match="group_block=4 must divide the per-shard slab 2"):
        fabric.make_sharded_multigroup_round(
            make_group_mesh(2, "cpu"), n_groups=4, quorum=2, group_block=4
        )
    with pytest.raises(ValueError, match="not the mesh's device"):
        T.ShardedMultiGroupDataplane(cfg, mesh=make_group_mesh(2, "cpu"), device="meta")
    with pytest.raises(ValueError, match="n_learners must be 1"):
        T.PaxosContext(cfg, mesh=make_group_mesh(2, "cpu"), n_learners=2, device="cpu")
    flat = T.PaxosContext(cfg, snapshots=True, device="cpu")
    with pytest.raises(ValueError, match="groups-sharded dataplane"):
        flat.migrate_group(0, 1)
    # migration refuses an undrained group, a shard out of range and a full
    # destination; without reclamation it refuses outright
    with pytest.raises(ValueError, match="requires reclamation"):
        sh.migrate_group(0, 1)
    sh.enable_reclamation()
    sh.pipeline_cohort([0], np.zeros((1, 16, V), np.int32), np.ones((1, 16), bool))
    with pytest.raises(ValueError, match="not drained"):
        sh.migrate_group(0, 1)
    sh.set_reclaimed(0, 16)
    with pytest.raises(ValueError, match="out of range"):
        sh.migrate_group(0, 2)
    with pytest.raises(RuntimeError, match="no vacant slot on shard 1"):
        sh.migrate_group(0, 1)
    assert sh.placement.identity_map()


def test_mesh_over_several_cards_is_not_ported(monkeypatch):
    """``make_group_mesh()`` over C visible cards is a C-shard ``groups``
    mesh, shard ``s`` on ``cuda:s`` and ``cuda:0`` its home; a card index
    or ``n_shards`` gives logical shards on one device, ``GroupMesh`` any
    layout, and a mesh mixes no device types."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = make_group_mesh()
    assert mesh.shape == {"groups": 4} and mesh.n_shards == 4
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert mesh.device == torch.device("cuda", 0)
    assert make_group_mesh(device="cuda").devices == mesh.devices
    assert make_group_mesh(device="cuda:2").devices == (torch.device("cuda", 2),)
    assert make_group_mesh(2).devices == (torch.device("cuda"),) * 2
    assert make_group_mesh(2, "cpu").shape == {"groups": 2}
    assert make_group_mesh(2, "cpu").devices == (torch.device("cpu"),) * 2
    pair = GroupMesh(("cuda:1", "cuda:3"))
    assert pair.devices == (torch.device("cuda", 1), torch.device("cuda", 3))
    assert pair.n_shards == 2 and pair.device == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="one device type"):
        GroupMesh(("cpu", "cuda:1"))
    with pytest.raises(ValueError, match="at least one shard"):
        GroupMesh(())


def _ctx_trio(g, shards, use_kernels, seed):
    """The reference's unsharded grouped context at the defaults and at
    ``persistent_rounds=1``, and the port's sharded one at the defaults, on
    equal lossy nets."""

    def ctx(pkg, rounds=8, **kw):
        cfg = _cfg(pkg, g, n_instances=512, persistent_rounds=rounds)
        net = pkg.SimNet(pkg.FaultSpec(**FAULTS), seed)
        return pkg.PaxosContext(cfg, net=net, use_kernels=use_kernels, **kw)

    got = ctx(T, mesh=make_group_mesh(shards, "cpu"), device="cpu")
    assert isinstance(got.hw, T.ShardedMultiGroupDataplane)
    return ctx(R), ctx(R, rounds=1), got


def _record_waves(hw) -> list[int]:
    """The depth of every ``pipeline_persistent`` call, in order."""
    depths: list[int] = []
    wave = hw.pipeline_persistent

    def recorded(gids, values, *args, **kw):
        depths.append(values.shape[0])
        return wave(gids, values, *args, **kw)

    hw.pipeline_persistent = recorded
    return depths


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_context_matches_unsharded_with_failover(shards, use_kernels):
    """A sharded context plans no persistent waves (the reference's planner
    clamp: its engine would run a K-round wave as K dispatches), so it
    equals the reference's unsharded context at ``persistent_rounds=1`` in
    everything (logs, the order of ``deliver`` callbacks, slabs and
    mirrors, ``dispatch_count``, the plan) and the one at the defaults in
    every group's log; and it delivers each group's payloads once, as G
    single-group twins do.  Through a lossy net, a per-group failover, a
    dead acceptor and a queue deep enough for a wave of three rounds."""
    g = 4
    calls: list[list] = [[], [], []]
    ref8, ref1, got = _ctx_trio(g, shards, use_kernels, seed=shards)
    for ctx, c in zip((ref8, ref1, got), calls, strict=True):
        ctx.deliver_cb = lambda p, s, i, c=c: c.append((p, i))
    singles = [
        R.PaxosContext(_cfg(R, 1, n_instances=512), use_kernels=use_kernels, fused=True)
        for _ in range(g)
    ]
    depths = _record_waves(got.hw)
    victim, casualty = 1, g - 1
    for ctx in (ref8, ref1, got):
        ctx.hw.kill_acceptor(casualty, 0)
    singles[casualty].hw.kill_acceptor(0)

    def wave(w, hot=1):
        for gid in range(g):
            for j in range(hot if gid == 0 else 1):
                p = f"w{w}g{gid}j{j}".encode()
                for ctx in (ref8, ref1, got):
                    ctx.submit(p, group=gid)
                singles[gid].submit(p)
        for ctx in (ref8, ref1, got, *singles):
            ctx.run_until_quiescent()

    for w in range(2):
        wave(w)
    wave(2, hot=3 * 16 + 5)  # the unsharded context runs a wave of three rounds here
    for ctx in (ref8, ref1, got):
        ctx.fail_coordinator(group=victim)
    singles[victim].fail_coordinator()
    for w in range(3, 5):
        wave(w)
    for ctx in (ref8, ref1, got):
        ctx.restore_hardware_coordinator(group=victim)
    singles[victim].restore_hardware_coordinator()
    for w in range(5, 7):
        wave(w)

    assert got.group_log == ref1.group_log == ref8.group_log
    for gid in range(g):  # the twins' nets are lossless: the same payloads, once each
        assert sorted(p for _, p in got.group_log[gid]) == sorted(
            p for _, p in singles[gid].delivered_log
        )  # fmt: skip
    assert calls[2] == calls[1] and sorted(calls[2]) == sorted(calls[0])
    assert got.stats == ref1.stats
    want, have = export_state(ref1.hw), export_state(got.hw)
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)
    assert got.planner.report() == ref1.planner.report()
    assert got.hw.dispatch_count == ref1.hw.dispatch_count
    assert ref8.planner.report()["persistent_waves"] > 0 and not depths


def test_sharded_g1_context_serves():
    """A sharded single-group context engages the group-keyed surface and
    decides what the reference's single-group fused context decides."""
    cfg = dict(n_acceptors=3, n_instances=128, batch=16, value_words=V)
    ctx = T.PaxosContext(T.PaxosConfig(**cfg), mesh=make_group_mesh(device="cpu"), device="cpu")
    ref = R.PaxosContext(R.PaxosConfig(**cfg), fused=True, use_kernels=True)
    assert ctx.grouped and isinstance(ctx.hw, T.ShardedMultiGroupDataplane)
    for k in range(5):
        for c in (ctx, ref):
            c.submit(f"x{k}".encode())
    for c in (ctx, ref):
        c.run_until_quiescent()
    assert [p for _i, p in ctx.group_log[0]] == [f"x{k}".encode() for k in range(5)]
    assert ctx.group_log[0] == ref.delivered_log
    assert ctx.live_groups() == [0] and ctx.hw.group_placement() == [0]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_live_migration_matches_twins_then_failover_snapshot_retire(use_kernels):
    """Live slab migration on 2 shards: skewed load, a retire on the
    destination shard, then the hot tenant moves from shard 0 to shard 1
    while the service runs.  Decided payload streams match per-group
    single-group twins, and every (instance, payload) matches the
    reference's unsharded context on the same schedule, where the move is
    the drain and re-seat it reduces to.  Then the migrated group is failed
    over, crashed and restored, snapshotted and retired, through its new
    slot: its retired log and seals match the reference's, and no other
    group's slab rows changed."""
    g = 4
    kw = dict(n_acceptors=3, n_instances=256, batch=16, value_words=4)
    ctx = T.PaxosContext(T.PaxosConfig(n_groups=g, **kw), mesh=make_group_mesh(2, "cpu"),
                         use_kernels=use_kernels, snapshots=True, device="cpu")  # fmt: skip
    ref = R.PaxosContext(R.PaxosConfig(n_groups=g, **kw), use_kernels=use_kernels,
                         snapshots=True)  # fmt: skip
    twins = [R.PaxosContext(R.PaxosConfig(**kw), use_kernels=use_kernels, fused=True,
                            snapshots=True) for _ in range(g)]  # fmt: skip
    rng = np.random.default_rng(1)

    def waves(n, groups, hot=0):
        for w in range(n):
            for gid in groups:
                for _ in range(12 if gid == hot else (2 if w % 2 == 0 else 1)):
                    p = bytes(rng.integers(0, 255, 6).astype(np.uint8))
                    for c in (ctx, ref):
                        c.submit(p, group=gid)
                    twins[gid].submit(p)
            for c in (ctx, ref):
                c.run_until_quiescent()
            for gid in groups:
                twins[gid].run_until_quiescent()

    waves(4, [0, 1, 2, 3])
    hw = ctx.hw
    assert hw.placement.identity_map()
    seals = [[], []]
    for c, out in ((ctx, seals[0]), (ref, seals[1])):
        out.append(c.retire_group(3))  # vacates a slot on shard 1
    assert hw.shard_of_group(0) == 0
    snap = ctx.migrate_group(0, 1)
    # the reference's unsharded equivalent: drain, snapshot, re-seat
    ref.run_until_quiescent()
    seals[1].append(ref.snapshot_group(0))
    ref.hw.restore_group(0, ref.hw.next_inst_host[0], ref.hw.crnd_host[0])
    assert snap.seal == seals[1][-1].seal and snap.watermark == seals[1][-1].watermark
    seals[1].pop()
    assert hw.shard_of_group(0) == 1 and hw._slab_row(0) == 3, hw.group_placement()
    assert hw.group_placement() == [1, 0, 1, 0]
    waves(3, [0, 1, 2])  # serving on after the move
    for gid in (0, 1, 2):
        assert [p for _, p in ctx.full_group_log(gid)] == [
            p for _, p in twins[gid].full_group_log(0)
        ]  # fmt: skip
        assert ctx.full_group_log(gid) == ref.full_group_log(gid), gid
    # the migrated group through its new slot: failover, crash and restore,
    # a snapshot and a retire; groups 1 and 2 keep their slab rows
    others = _leaves(hw, [1, 2])
    for c in (ctx, ref):
        c.fail_coordinator(group=0)
    waves(1, [0])
    for c in (ctx, ref):
        c.restore_hardware_coordinator(group=0)
        c.crash_acceptor(2, group=0)
    waves(1, [0])
    for c, out in ((ctx, seals[0]), (ref, seals[1])):
        out.append(c.snapshot_group(0).seal)
        out.append(c.restore_acceptor(2, group=0))
    waves(1, [0])
    for c, out in ((ctx, seals[0]), (ref, seals[1])):
        out.append(c.snapshot_group(0).seal)
        out.append(c.retire_group(0))
    assert seals[0] == seals[1]
    _same(_leaves(hw, [1, 2]), others)
    for gid in (1, 2):
        assert ctx.full_group_log(gid) == ref.full_group_log(gid)
    assert ctx.stats == ref.stats
