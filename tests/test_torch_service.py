"""The port's consensus service against the reference's, bit for bit.

``repro_torch.serve.service`` (``session_hash``, the routing functions,
``Ticket``, ``Session``, ``ConsensusService``) against
``repro.serve.engine``: the hash and both routings by hypothesis over str,
bytes and ints (negative and 128-bit); one schedule of sessions through
create, retire and adopt on ``repro.core.PaxosContext(cfg,
use_kernels=True)`` (its Pallas kernels in interpret mode) and on the
port's ``PaxosContext(cfg, device="cpu")`` (the kernels' plain versions),
where every delivered view, session chain, log segment, routing epoch,
load, planner report and dispatch count must be equal; the deprecation
shims; and the placement consumers on the port's sharded context
(``make_group_mesh(2, "cpu")``), held against the reference's unsharded
context and per-group twins, because the reference's own sharded path fails
under jax 0.9.0 (ROADMAP.md queue 3).  Tolerance: none.
"""

from __future__ import annotations

import warnings

import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import plan as rplan  # noqa: E402
from repro.serve import engine as rsvc  # noqa: E402
from repro_torch.launch.mesh import make_group_mesh  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import service as tsvc  # noqa: E402

BASE = dict(n_acceptors=3, n_instances=256, batch=8)
IDS = [f"sess-{i}" for i in range(24)] + [b"\x00\xff", b"", "", -7, -1, 0, 2**100 + 3]
UUID_LIKE = [0x6F1C2B3A4D5E6F708192A3B4C5D6E7F8, -(2**127), 2**128 - 1, -(2**128)]


def _svc(pkg, cfg_kw: dict, **kw):
    """A service over the reference's or the port's grouped context."""
    cfg = pkg.PaxosConfig(**{**BASE, **cfg_kw})
    extra = {"device": "cpu"} if pkg is T else {}
    ctx = pkg.PaxosContext(cfg, use_kernels=True, **kw, **extra)
    return (tsvc if pkg is T else rsvc).ConsensusService(ctx)


# ---------------------------------------------------------------------------
# session -> group routing
# ---------------------------------------------------------------------------
def _routes(mod, sid) -> tuple:
    return (
        mod.session_hash(sid),
        [mod.session_group(sid, n) for n in (1, 3, 8, 1024)],
        mod.session_group_live(sid, [0, 2, 5], 8),
        mod.session_group_live(sid, [1], 4),
        mod.session_group_live(sid, list(range(8)), 8),
    )


@settings(max_examples=200, deadline=None)
@given(
    sid=st.one_of(
        st.text(max_size=64),
        st.binary(max_size=64),
        st.integers(min_value=-(2**130), max_value=2**130),
    )
)
def test_session_hash_and_routing_equal_the_reference(sid):
    assert _routes(tsvc, sid) == _routes(rsvc, sid)


@pytest.mark.parametrize("sid", IDS + UUID_LIKE, ids=repr)
def test_session_hash_and_routing_on_fixed_ids(sid):
    """Hypothesis-free cases: empty ids, negative and 128-bit ints (the
    variable-length signed encoding), and a ``uuid4().int``-sized id."""
    assert _routes(tsvc, sid) == _routes(rsvc, sid)
    assert 0 <= tsvc.session_hash(sid) < 2**32


def test_routing_refuses_what_the_reference_refuses():
    for mod in (tsvc, rsvc):
        with pytest.raises(ValueError, match="n_groups must be >= 1"):
            mod.session_group("s", 0)
        with pytest.raises(ValueError, match="no live consensus groups"):
            mod.session_group_live("s", [], 4)
    assert tengine.ConsensusService is tsvc.ConsensusService
    assert tengine.session_hash is tsvc.session_hash


# ---------------------------------------------------------------------------
# one schedule through create, retire and adopt on both services
# ---------------------------------------------------------------------------
def _wave(svc, sids, w: int) -> list:
    tickets = []
    for s in sids:
        tickets.append(tuple(svc.session(s).submit(f"{s!r}:{w}".encode()[:40])))
    svc.run_until_quiescent()
    return tickets


def _observe(svc, sids) -> dict:
    segments = {key for s in sids for key in svc.session_chain(s)}
    return dict(
        routes=[svc.group_of(s) for s in sids],
        groups=[svc.session(s).group for s in sids],
        delivered=[svc.session(s).delivered() for s in sids],
        reads=[svc.session(s).read() for s in sids],
        chains=[svc.session_chain(s) for s in sids],
        segments={key: svc.log_segment(*key) for key in sorted(segments)},
        archived=svc.archived_segments(),
        generations=[svc.group_generation(g) for g in range(svc.n_groups)],
        epoch=svc.routing_epoch,
        loads=svc.group_loads(),
        report=svc.plan_report(),
        dispatch_count=svc.ctx.hw.dispatch_count,
        placement=svc.group_placement(),
        shards=[svc.shard_of(s) for s in sids],
        stats=dict(svc.stats),
        live=svc.ctx.live_groups(),
    )


def _membership_schedule(pkg) -> list[dict]:
    svc = _svc(pkg, dict(n_groups=4), snapshots=True)
    ctx = svc.ctx
    sids = IDS
    seen = []
    tickets = [_wave(svc, sids, 0), _wave(svc, sids, 1)]
    ctx.snapshot_group(0)  # compaction: log_segment stitches prefix + live log
    seen.append(_observe(svc, sids))
    svc.retire_group(svc.group_of(sids[0]))
    tickets.append(_wave(svc, sids, 2))
    seen.append(_observe(svc, sids))
    assert svc.create_group() == svc.group_of(sids[0])
    tickets.append(_wave(svc, sids, 3))
    # adopt group 1's sealed snapshot into the slot group 2 vacates
    snap = ctx.snapshot_group(1)
    prefix = list(ctx.snapshots.log_prefix(1))
    svc.retire_group(2)
    assert svc.adopt_group(snap, prefix) == 2
    tickets.append(_wave(svc, sids, 4))
    seen.append(_observe(svc, sids))
    seen.append({"tickets": tickets})
    return seen


def test_service_schedule_equals_the_reference():
    ref, got = _membership_schedule(R), _membership_schedule(T)
    for want, have in zip(ref, got, strict=True):
        assert have.keys() == want.keys()
        for key in want:
            assert have[key] == want[key], key
    assert got[-2]["epoch"] == 4 and got[-2]["archived"]


def test_run_until_quiescent_observes_loads_per_round():
    """A deliver callback that submits more mid-run: the planner's load
    snapshot is taken per pumped round, in both packages alike."""
    out = []
    for pkg in (R, T):
        svc = _svc(pkg, dict(n_instances=512, value_words=4, batch=16, n_groups=2))
        fired = []

        def follow_up(payload, size, inst, svc=svc, fired=fired):
            if not fired:
                fired.append(inst)
                for j in range(5):
                    svc.session("load-b").submit(f"follow-{j}".encode())

        svc.ctx.deliver_cb = follow_up
        for i in range(24):
            svc.session("load-a").submit(f"lead-{i}".encode())
        before = svc.group_loads()
        svc.run_until_quiescent()
        report = svc.plan_report()
        assert report["service_loads"] == svc.group_loads() != before
        out.append((report, svc.session("load-b").delivered(), svc.ctx.hw.dispatch_count))
    assert out[0] == out[1]


def test_deprecation_shims_warn_and_equal_the_typed_surface():
    got = []
    for pkg in (R, T):
        svc = _svc(pkg, dict(n_groups=2))
        t = svc.session("u1").submit(b"op0")
        with pytest.warns(DeprecationWarning, match="session_id"):
            t2 = svc.submit("u1", b"op1")
        assert isinstance(t2, tuple) and t2.group == t.group
        gid, seq = t2
        assert (gid, seq) == (t2.group, t2.seq)
        svc.run_until_quiescent()
        with pytest.warns(DeprecationWarning, match="session_id"):
            shim = svc.delivered("u1")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            typed = svc.session("u1").delivered()
        assert shim == typed
        got.append((tuple(t), tuple(t2), typed))
    assert got[0] == got[1]
    assert isinstance(svc.session("u1"), tsvc.Session)
    assert isinstance(t, tsvc.Ticket)


def test_delivered_reads_the_group_log_on_every_context_shape():
    """An ungrouped fused context and a sharded single-group one: a
    session's view is the group log, equal to the reference's ungrouped."""
    cfg = dict(n_acceptors=3, n_instances=128, batch=16)
    ref = rsvc.ConsensusService(R.PaxosContext(R.PaxosConfig(**cfg), fused=True))
    ports = [
        T.PaxosContext(T.PaxosConfig(**cfg), fused=True, device="cpu"),
        T.PaxosContext(T.PaxosConfig(**cfg), mesh=make_group_mesh(1, "cpu"), device="cpu"),
    ]
    for svc in (ref, *map(tsvc.ConsensusService, ports)):
        for k in range(3):
            svc.session("sess").submit(f"op{k}".encode())
        svc.run_until_quiescent()
        log = svc.session("sess").delivered()
        assert log == ref.session("sess").delivered() == list(svc.ctx.delivered_log)
        assert [p for _i, p in log] == [f"op{k}".encode() for k in range(3)]


# ---------------------------------------------------------------------------
# placement: the port's sharded service against the unsharded reference
# ---------------------------------------------------------------------------
def test_sharded_service_placement_and_migration():
    """On ``make_group_mesh(2, "cpu")`` (two shards of two groups) the port's
    service routes every session to the group the reference's unsharded
    service picks, and ``shard_of`` is that group's placement.  Under skew,
    ``plan_placement`` is the reference's ``PlacementMap.weighted`` over the
    same loads; a retire on the planned shard and ``migrate_group`` then
    move the hot group there: session routing and every session's view stay
    as they were, every group log equals the reference's, where the move is
    the drain, snapshot and re-seat it reduces to, and each group's
    payloads equal a single-group twin's."""
    g = 4
    cfg_kw = dict(n_groups=g, persistent_rounds=1, value_words=8)
    got = _svc(T, cfg_kw, mesh=make_group_mesh(2, "cpu"), snapshots=True)
    ref = _svc(R, cfg_kw, snapshots=True)
    kw = dict(BASE, value_words=8)
    twins = [
        R.PaxosContext(R.PaxosConfig(**kw), use_kernels=True, fused=True, snapshots=True)
        for _ in range(g)
    ]
    sids = [f"user-{i}" for i in range(40)]
    assert [got.group_of(s) for s in sids] == [ref.group_of(s) for s in sids]
    assert got.group_placement() == [0, 0, 1, 1] and ref.group_placement() == [0] * g
    with pytest.raises(ValueError, match="requires the sharded dataplane"):
        ref.plan_placement()
    hot = ref.group_of(sids[0])

    def wave(w: int, skew: int = 1) -> None:
        for s in sids:
            for j in range(skew if ref.group_of(s) == hot else 1):
                p = f"{s}:{w}:{j}".encode()
                for svc in (got, ref):
                    t = svc.session(s).submit(p)
                twins[t.group].submit(p)
        for ctx in (got.ctx, ref.ctx, *(t for t in twins if t is not None)):
            ctx.run_until_quiescent()

    for w in range(3):
        wave(w, skew=3)
    for s in sids:
        assert got.shard_of(s) == got.group_placement()[got.group_of(s)]
        assert ref.shard_of(s) == 0
    plan = got.plan_placement()
    want = rplan.PlacementMap.weighted(ref.group_loads(), 2, 2)
    assert plan.slot_of == want.slot_of and got.group_loads() == ref.group_loads()
    dst = plan.shard_of(hot)
    if dst == got.shard_of(sids[0]):  # the plan keeps the hot group: move it across
        dst = 1 - dst
    gone = next(h for h in range(g) if h != hot and got.group_placement()[h] == dst)
    for svc in (got, ref):
        svc.retire_group(gone)
    twins[gone] = None
    views = [got.session(s).delivered() for s in sids]
    epoch = got.routing_epoch
    snap = got.migrate_group(hot, dst)
    ref.ctx.run_until_quiescent()  # the unsharded equivalent: drain, snapshot, re-seat
    want_snap = ref.ctx.snapshot_group(hot)
    ref.ctx.hw.restore_group(hot, ref.ctx.hw.next_inst_host[hot], ref.ctx.hw.crnd_host[hot])
    assert (snap.seal, snap.watermark) == (want_snap.seal, want_snap.watermark)
    assert got.routing_epoch == epoch + 1
    assert got.group_placement()[hot] == dst and got.shard_of(sids[0]) == dst
    assert [got.session(s).delivered() for s in sids] == views
    assert [got.group_of(s) for s in sids] == [ref.group_of(s) for s in sids]
    for w in range(3, 5):
        wave(w)
    for gid in got.ctx.live_groups():
        assert got.ctx.full_group_log(gid) == ref.ctx.full_group_log(gid), gid
        assert [p for _, p in got.ctx.full_group_log(gid)] == [
            p for _, p in twins[gid].full_group_log()
        ]  # fmt: skip
    for s in sids:
        assert got.session(s).delivered() == ref.session(s).delivered()
        assert got.shard_of(s) == got.group_placement()[got.group_of(s)]
    assert got.ctx.stats == ref.ctx.stats
