"""The port's replicated KV tier against the reference's, bit for bit.

The cases of ``tests/test_kv.py``, each run on ``repro.serve.kv`` over
``repro.core.PaxosContext(cfg, use_kernels=True)`` (its Pallas kernels in
interpret mode) and on ``repro_torch.serve.kv`` over the port's
``PaxosContext(cfg, device="cpu")`` (the kernels' plain versions) with the
same inputs: codec bytes and rejections, cas and tombstone semantics, the
read watermark, leases (a leased get dispatches nothing; a pending write or
the session's own retire forces one read-index op), the payload door, the
typed session surface, and a snapshot made by the reference adopted by the
port's service, applied and never replayed.  Then the unsharded cases of
``tests/test_kv_linearizable.py`` (twins under chaos; sessions that never
read stale), the port's run held against a fresh apply loop of the
reference's ``GroupReplica`` over the port's twins' logs.
Tolerance: none, every byte and count equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.serve.engine as rsvc  # noqa: E402
import repro.serve.kv as RK  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.serve.kv as TK  # noqa: E402
import repro_torch.serve.service as tsvc  # noqa: E402

A = 3
PKGS = [(R, RK, rsvc), (T, TK, tsvc)]


def _svc(pkg, **cfg_kw):
    core, _kv, svc_mod = pkg
    base = dict(n_acceptors=A, n_instances=64, batch=8, n_groups=2)
    cfg = core.PaxosConfig(**{**base, **cfg_kw})
    extra = {"device": "cpu"} if core is T else {}
    return svc_mod.ConsensusService(core.PaxosContext(cfg, use_kernels=True, **extra))


def _both(scenario):
    """``scenario(pkg)`` on the reference and on the port; returns both."""
    return [scenario(pkg) for pkg in PKGS]


# ---------------------------------------------------------------------------
# Op codec
# ---------------------------------------------------------------------------
def _ops(K):
    return [
        K.KvOp(K.OP_PUT, b"key", b"value", None, 0xDEADBEEF, 7),
        K.KvOp(K.OP_PUT, b"", b"", None, 0, 0),
        K.KvOp(K.OP_DELETE, b"gone", b"", None, 1, 2),
        K.KvOp(K.OP_CAS, b"k", b"new", b"old", 42, 3),
        K.KvOp(K.OP_CAS, b"k", b"new", b"", 42, 4),  # expect empty value
        K.KvOp(K.OP_CAS, b"k", b"new", None, 42, 5),  # expect ABSENT
        K.KvOp(K.OP_GET, b"", b"", None, 99, 6),
        K.KvOp(K.OP_PUT, b"k" * 0xFFFF, b"v", None, 2**32 + 5, -1),  # u16 max, tags wrap
    ]


def test_codec_bytes_and_round_trip_equal_the_reference():
    for want, have in zip(_ops(RK), _ops(TK), strict=True):
        frame = TK.encode_op(have)
        assert frame == RK.encode_op(want)
        assert dataclasses.astuple(TK.decode_op(frame)) == dataclasses.astuple(
            RK.decode_op(frame)
        )  # fmt: skip
    assert TK.encode_op(_ops(TK)[4]) != TK.encode_op(_ops(TK)[5])
    names = ("KV_MAGIC", "KV_VERSION", "OP_PUT", "OP_DELETE", "OP_CAS", "OP_GET", "OP_NAMES",
             "_FLAG_EXPECT")  # fmt: skip
    assert [getattr(TK, n) for n in names] == [getattr(RK, n) for n in names]
    assert TK._HEADER.format == RK._HEADER.format == "<BBBBIIHHH"
    assert issubclass(TK.KvCodecError, ValueError)


def _good(K) -> bytes:
    return K.encode_op(K.KvOp(K.OP_CAS, b"key", b"val", b"old", 5, 9))


def _flags(frame: bytes, flags: int) -> bytes:
    return frame[:3] + bytes([flags]) + frame[4:]


MALFORMED = {
    "truncated": lambda K: _good(K)[:10],
    "empty": lambda K: b"",
    "magic": lambda K: b"\x00" + _good(K)[1:],
    "version": lambda K: _good(K)[:1] + b"\x7f" + _good(K)[2:],
    "opcode": lambda K: _good(K)[:2] + b"\x7f" + _good(K)[3:],
    "opcode zero": lambda K: _good(K)[:2] + b"\x00" + _good(K)[3:],
    "flags": lambda K: _good(K)[:3] + b"\x80" + _good(K)[4:],
    "trailing bytes": lambda K: _good(K) + b"extra",
    "short body": lambda K: _good(K)[:-1],
    "expect flag on a put": lambda K: _flags(K.encode_op(K.KvOp(K.OP_PUT, b"k", b"v")), 1),
    "expect bytes without the flag": lambda K: _flags(_good(K), 0),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_codec_rejects_malformed_frames_alike(case):
    errors = []
    for K in (RK, TK):
        with pytest.raises(K.KvCodecError) as ei:
            K.decode_op(MALFORMED[case](K))
        errors.append(str(ei.value))
    assert errors[0] == errors[1]
    assert MALFORMED[case](RK) == MALFORMED[case](TK)


@pytest.mark.parametrize(
    "op",
    [
        lambda K: K.KvOp(99, b"k"),
        lambda K: K.KvOp(K.OP_PUT, b"k", b"v", expect=b"x"),
        lambda K: K.KvOp(K.OP_PUT, b"k" * 0x10000, b"v"),
        lambda K: K.KvOp(K.OP_CAS, b"k", b"v", expect=b"e" * 0x10000),
    ],
    ids=["opcode", "expect on a put", "key too long", "expect too long"],
)
def test_codec_refuses_unencodable_ops_alike(op):
    errors = []
    for K in (RK, TK):
        with pytest.raises(K.KvCodecError) as ei:
            K.encode_op(op(K))
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# Apply loop: cas semantics, tombstones, versions, RYW counters
# ---------------------------------------------------------------------------
def _replica_run(K):
    def log(*ops):
        return [(i, K.encode_op(op)) for i, op in enumerate(ops)]

    first = [
        K.KvOp(K.OP_CAS, b"k", b"v0", None, 1, 1),
        K.KvOp(K.OP_CAS, b"k", b"xx", None, 1, 2),
        K.KvOp(K.OP_CAS, b"k", b"v1", b"v0", 1, 3),
        K.KvOp(K.OP_CAS, b"k", b"xx", b"v0", 1, 4),
        K.KvOp(K.OP_PUT, b"d", b"x", None, 2, 1),
        K.KvOp(K.OP_DELETE, b"d", b"", None, 2, 2),
        K.KvOp(K.OP_GET, b"", b"", None, 3, 1),
        K.KvOp(K.OP_CAS, b"e", b"", b"", 5, 1),  # expect empty on an absent key
        K.KvOp(K.OP_PUT, b"e", b"", None, 5, 2),
        K.KvOp(K.OP_CAS, b"e", b"full", b"", 5, 3),  # expect empty on an empty value
    ]
    rep = K.GroupReplica()
    seen = [rep.apply_log(log(*first)), rep.signature(), dict(rep.applied_counter)]
    rep.apply_log(log(*first, K.KvOp(K.OP_CAS, b"d", b"back", None, 4, 1)))
    seen += [rep.signature(), dict(rep.applied_counter)]
    with pytest.raises(ValueError, match="shrank") as ei:
        rep.apply_log([])
    return seen + [str(ei.value)]


def test_replica_cas_and_tombstone_semantics_equal_the_reference():
    ref, got = _replica_run(RK), _replica_run(TK)
    assert got == ref
    state = got[3][0]
    assert state[b"k"] == (b"v1", 2) and state[b"d"] == (b"back", 3)
    assert state[b"e"] == (b"full", 2)


def test_read_watermark_is_monotone_and_tracks_the_log():
    def run(pkg):
        svc = _svc(pkg)
        kv = pkg[1].ReplicatedKV(svc)
        s = kv.session("mono")
        gid = svc.group_of("mono")
        seen = [kv.read_watermark(gid)]
        for wave in range(3):
            for k in range(4):
                s.put(f"w{wave}k{k}".encode(), b"v")
            svc.run_until_quiescent()
            kv.refresh()
            seen.append(kv.read_watermark(gid))
            assert seen[-1] == len(svc.ctx.full_group_log(gid))
        kv.refresh()
        seen.append(kv.read_watermark(gid))
        return seen, kv.replica(gid).signature(), svc.ctx.full_group_log(gid)

    ref, got = _both(run)
    assert got == ref
    assert got[0] == sorted(got[0]) and got[0][-1] == got[0][-2] == 12


# ---------------------------------------------------------------------------
# Consensus-free reads: lease validity and the dispatch-count pin
# ---------------------------------------------------------------------------
def test_leased_get_dispatches_nothing():
    def run(pkg):
        svc = _svc(pkg)
        kv = pkg[1].ReplicatedKV(svc)
        s = kv.session("alice")
        s.put(b"k", b"v1")
        svc.run_until_quiescent()
        base = svc.ctx.hw.dispatch_count
        assert s.lease_valid is False  # pending until refresh prunes it
        reads = [s.get(b"k") for _ in range(5)] + [s.get(b"missing")]
        assert s.lease_valid
        assert svc.ctx.hw.dispatch_count == base  # zero wire-path launches
        return reads, dict(kv.stats), base

    ref, got = _both(run)
    assert got == ref
    assert got[1] == {"leased_gets": 6, "read_index_gets": 0, "ops_submitted": 1}


def test_pending_write_forces_one_read_index_op():
    def run(pkg):
        svc = _svc(pkg)
        kv = pkg[1].ReplicatedKV(svc)
        s = kv.session("alice")
        s.put(b"k", b"v1")
        svc.run_until_quiescent()
        out = [s.get(b"k")]
        s.put(b"k", b"v2")  # in flight: the lease breaks
        base = svc.ctx.hw.dispatch_count
        out.append(s.get(b"k"))  # read-index waits out the write
        moved = svc.ctx.hw.dispatch_count - base
        assert moved > 0 and kv.stats["read_index_gets"] == 1 and s.lease_valid
        out.append(s.get(b"k"))
        return out, moved, dict(kv.stats), svc.session("alice").delivered()

    ref, got = _both(run)
    assert got == ref
    assert got[0] == [b"v1", b"v2", b"v2"] and got[2]["leased_gets"] == 2


def test_lease_survives_unrelated_retire_but_not_own():
    def run(pkg):
        svc = _svc(pkg, n_groups=4)
        kv = pkg[1].ReplicatedKV(svc)
        sid = "alice"
        mine = svc.group_of(sid)
        other = next(g for g in range(4) if g != mine)
        s = kv.session(sid)
        s.put(b"k", b"v1")
        svc.run_until_quiescent()
        out = [s.get(b"k")]
        svc.retire_group(other)  # does not move the session: revalidated host-side
        base = svc.ctx.hw.dispatch_count
        out.append(s.get(b"k"))
        assert svc.ctx.hw.dispatch_count == base and kv.stats["read_index_gets"] == 0
        svc.retire_group(mine)  # moves it: one read-index op, value from the archive
        out.append(s.get(b"k"))
        assert svc.ctx.hw.dispatch_count > base and kv.stats["read_index_gets"] == 1
        assert s.lease_valid
        return out, dict(kv.stats), svc.session_chain(sid), svc.ctx.hw.dispatch_count

    ref, got = _both(run)
    assert got == ref
    assert got[0] == [b"v1"] * 3


# ---------------------------------------------------------------------------
# Payload-width door guards, the typed surface
# ---------------------------------------------------------------------------
def test_oversized_payload_rejected_at_every_door():
    def run(pkg):
        svc = _svc(pkg)
        limit = svc.ctx.cfg.max_payload_bytes
        fat = b"x" * (limit + 1)
        errors = []
        for door in (
            lambda: svc.ctx.submit(fat, group=0),
            lambda: svc.session("s").submit(fat),
        ):
            with pytest.raises(ValueError, match=f"at most {limit} payload") as ei:
                door()
            errors.append(str(ei.value))
        with pytest.raises(ValueError, match=f"at most {limit} payload"):
            with pytest.warns(DeprecationWarning):
                svc.submit("s", fat)
        svc.session("s").submit(b"x" * limit)  # the limit itself still fits
        svc.run_until_quiescent()
        assert svc.session("s").read() == [b"x" * limit]
        return limit, errors

    ref, got = _both(run)
    assert got == ref and got[0] == 16 * 4 - 8


def test_session_handle_and_ticket():
    def run(pkg):
        svc = _svc(pkg)
        sess = svc.session("u1")
        assert sess.group == svc.group_of("u1")
        t = sess.submit(b"op0")
        gid, seq = t
        assert (gid, seq) == (t.group, t.seq) and t.group == sess.group
        svc.run_until_quiescent()
        with pytest.warns(DeprecationWarning, match="session_id"):
            t2 = svc.submit("u1", b"op1")
        svc.run_until_quiescent()
        with pytest.warns(DeprecationWarning):
            shim = svc.delivered("u1")
        return tuple(t), tuple(t2), sess.read(), sess.delivered(), shim

    ref, got = _both(run)
    assert got == ref and got[2] == [b"op0", b"op1"]


def test_ring_overflow_context_dict():
    contexts = []
    for core, extra in ((R, {}), (T, {"device": "cpu"})):
        cfg = core.PaxosConfig(n_acceptors=A, n_instances=16, batch=8)
        ctx = core.PaxosContext(cfg, fused=True, snapshots=True, use_kernels=True, **extra)
        for i in range(16):
            ctx.submit(f"m{i}".encode())
        ctx.run_until_quiescent()
        with pytest.raises(core.RingOverflowError) as ei:
            ctx.submit(b"overflow")
            ctx.pump()
        e = ei.value
        assert e.context == {"group": e.group, "base": e.base, "burst": e.burst,
                             "boundary": e.boundary, "attempted": e.attempted}  # fmt: skip
        contexts.append(e.context)
    assert contexts[0] == contexts[1]
    assert contexts[1]["attempted"] > contexts[1]["boundary"]


# ---------------------------------------------------------------------------
# Snapshot state transfer: applied host-side, never replayed
# ---------------------------------------------------------------------------
def _snapshot_source(pkg):
    core, K, svc_mod = pkg
    cfg = core.PaxosConfig(n_acceptors=A, n_instances=16, batch=8, n_groups=2)
    extra = {"device": "cpu"} if core is T else {}
    ctx = core.PaxosContext(cfg, snapshots=True, use_kernels=True, **extra)
    svc = svc_mod.ConsensusService(ctx)
    kv = K.ReplicatedKV(svc)
    sid = next(f"s{i}" for i in range(64) if svc.group_of(f"s{i}") == 1)
    s = kv.session(sid)
    for k in range(8):
        s.put(f"k{k}".encode(), f"v{k}".encode())
    svc.run_until_quiescent()
    ctx.snapshot_group(1)  # compact below the watermark
    for k in range(8):
        s.put(f"k{k}".encode(), f"w{k}".encode())
    svc.run_until_quiescent()
    kv.refresh()
    return kv, ctx.snapshot_group(1), list(ctx.snapshots.log_prefix(1))


def test_reference_snapshot_adopted_by_the_port_is_applied_not_replayed():
    """A ``GroupSnapshot`` sealed by the reference (Pallas digest in
    interpret mode) is adopted by the port's service: its seal verifies
    under the port's digest, the port's replica reaches the reference's
    signature, and the port's dataplane dispatches nothing."""
    (rkv, rsnap, rprefix), (tkv, tsnap, tprefix) = _both(_snapshot_source)
    sig = rkv.replica(1).signature()
    assert sig[1] == 16 and tkv.replica(1).signature() == sig
    assert (tsnap.seal, tsnap.watermark) == (rsnap.seal, rsnap.watermark)
    assert tprefix == rprefix
    snap = T.GroupSnapshot(
        watermark=int(rsnap.watermark),
        insts=np.asarray(rsnap.insts),
        values=np.asarray(rsnap.values),
        seal=int(rsnap.seal),
    )
    cfg = T.PaxosConfig(n_acceptors=A, n_instances=16, batch=8, n_groups=2)
    svc = tsvc.ConsensusService(T.PaxosContext(cfg, snapshots=True, device="cpu"))
    kv = TK.ReplicatedKV(svc)
    svc.retire_group(1)  # free the slot for the transfer
    assert svc.adopt_group(snap, log_prefix=rprefix) == 1
    kv.refresh()
    assert kv.replica(1).signature() == sig
    assert svc.ctx.hw.dispatch_count == 0
    with pytest.raises(ValueError, match="seal mismatch"):
        tampered = dataclasses.replace(snap, seal=snap.seal ^ 1)
        svc.retire_group(1)
        svc.adopt_group(tampered, log_prefix=rprefix)


# ---------------------------------------------------------------------------
# The unsharded chaos cases of tests/test_kv_linearizable.py on the port
# ---------------------------------------------------------------------------
KEYS = [f"key{i}".encode() for i in range(4)]


def _cfg(g: int) -> T.PaxosConfig:
    return T.PaxosConfig(n_acceptors=A, n_instances=256, batch=8, n_groups=g)


def _oracle_sig(log):
    """The reference's apply loop, fresh, over a whole twin log."""
    rep = RK.GroupReplica()
    rep.apply_log(list(log))
    return rep.signature()


def run_kv_twins(seed: int, g: int, use_kernels: bool, waves: int = 12) -> None:
    ctx = T.PaxosContext(_cfg(g), use_kernels=use_kernels, snapshots=True, device="cpu")
    svc = tsvc.ConsensusService(ctx)
    kv = TK.ReplicatedKV(svc)
    cfg1 = T.PaxosConfig(n_acceptors=A, n_instances=256, batch=8)
    twins = [
        T.PaxosContext(cfg1, use_kernels=use_kernels, fused=True, snapshots=True, device="cpu")
        for _ in range(g)
    ]
    rng = np.random.default_rng(seed)
    counters = [0] * g

    def submit(gid: int) -> None:
        counters[gid] += 1
        c = counters[gid]
        key = KEYS[int(rng.integers(len(KEYS)))]
        r = rng.random()
        if r < 0.5:
            op = TK.KvOp(TK.OP_PUT, key, f"g{gid}c{c}".encode(), None, 1000 + gid, c)
        elif r < 0.7:
            op = TK.KvOp(TK.OP_DELETE, key, b"", None, 1000 + gid, c)
        else:
            expect = None if r < 0.8 else f"g{gid}c{int(rng.integers(c))}".encode()
            op = TK.KvOp(TK.OP_CAS, key, f"cas{c}".encode(), expect, 1000 + gid, c)
        p = TK.encode_op(op)
        ctx.submit(p, group=gid)
        twins[gid].submit(p)

    def pump() -> None:
        ctx.pump()
        for t in twins:
            if t is not None:
                t.pump()

    churn_gid = g - 1
    for w in range(waves):
        if w == 3:
            ctx.fail_coordinator(group=0)
            twins[0].fail_coordinator()
        if w == 5:
            ctx.restore_hardware_coordinator(group=0)
            twins[0].restore_hardware_coordinator()
        if w == 6:
            ctx.crash_acceptor(2, group=0)
            twins[0].crash_acceptor(2)
        if w == 9:
            assert ctx.snapshots.watermark(0) > 0
            assert ctx.restore_acceptor(2, group=0) == twins[0].restore_acceptor(2), seed
        if w == 7:
            gen = svc.group_generation(churn_gid)
            svc.retire_group(churn_gid)
            kv.refresh()
            assert kv.replica(churn_gid, gen).signature() == _oracle_sig(
                twins[churn_gid].delivered_log
            ), (seed, churn_gid)  # fmt: skip
            twins[churn_gid] = None
            counters[churn_gid] = 0
        if w == 10:
            assert svc.create_group() == churn_gid
            twins[churn_gid] = T.PaxosContext(
                cfg1, use_kernels=use_kernels, fused=True, snapshots=True, device="cpu"
            )
        for gid in ctx.live_groups():
            for _ in range(int(rng.integers(1, 5))):
                submit(gid)
        pump()
        if (w + 1) % 4 == 0:
            for gid in ctx.live_groups():
                snap = ctx.snapshot_group(gid)
                tsnap = twins[gid].snapshot_group()
                assert snap.watermark == tsnap.watermark, (seed, gid)
                assert snap.seal == tsnap.seal, (seed, gid)
        kv.refresh()
    for _ in range(30):
        pump()
    kv.refresh()
    for gid in ctx.live_groups():
        assert ctx.full_group_log(gid) == twins[gid].full_group_log(), (seed, gid)
        assert kv.replica(gid).signature() == _oracle_sig(twins[gid].full_group_log()), (seed, gid)
    assert not ctx._pending


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_kv_twins_unsharded(seed, use_kernels):
    run_kv_twins(seed, g=3, use_kernels=use_kernels)


def _oracle_get(svc, sid, key):
    """The session's stitched segment chain, decoded by the reference."""
    val = None
    for seg in svc.session_chain(sid):
        for _inst, payload in svc.log_segment(*seg):
            op = RK.decode_op(payload)
            if op.key != key:
                continue
            if op.op == RK.OP_PUT:
                val = op.value
            elif op.op == RK.OP_DELETE:
                val = None
    return val


def run_kv_sessions(seed: int, g: int, use_kernels: bool, waves: int = 6) -> None:
    ctx = T.PaxosContext(_cfg(g), use_kernels=use_kernels, snapshots=True, device="cpu")
    svc = tsvc.ConsensusService(ctx)
    kv = TK.ReplicatedKV(svc)
    rng = np.random.default_rng(seed)
    sids = [f"user-{i}" for i in range(2 * g)]
    last: dict = {}
    for w in range(waves):
        for sid in sids:
            s = kv.session(sid)
            key = f"k-{sid}".encode()
            if rng.random() < 0.8:
                v = f"{sid}w{w}".encode()
                s.put(key, v)
                last[sid] = v
            else:
                s.delete(key)
                last[sid] = None
        svc.run_until_quiescent()
        for sid in sids:
            s = kv.session(sid)
            before = dict(kv.stats)
            base = ctx.hw.dispatch_count
            v = s.get(f"k-{sid}".encode())
            assert v == last[sid], (seed, w, sid)
            assert v == _oracle_get(svc, sid, f"k-{sid}".encode()), (seed, w, sid)
            if kv.stats["leased_gets"] > before["leased_gets"]:
                assert ctx.hw.dispatch_count == base, (seed, w, sid)
        if w == 1:
            svc.retire_group(svc.group_of(sids[0]))
        if w == 3 and len(ctx.live_groups()) < g:
            svc.create_group()
    assert kv.stats["leased_gets"] > 0
    assert kv.stats["read_index_gets"] > 0


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_kv_sessions_unsharded(seed, use_kernels):
    run_kv_sessions(seed, g=3, use_kernels=use_kernels)
