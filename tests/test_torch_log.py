"""The port's host-only modules against the reference's, on the same inputs.

``repro_torch.core.log.ReplicatedLog`` (in-order delivery, ``gaps``, the
quorum trim) and ``repro_torch.train.elastic`` (``MembershipView``'s JSON
bytes, ``replan_mesh``, ``ViewManager`` over a port context) against
``repro.core.log`` and ``repro.train.elastic``; ``SoftwarePaxos``, the
libpaxos-like software deployment, against the port's ``PaxosContext(
device="cpu")`` as ``tests/test_paxos_properties.py`` holds the two in the
reference, and against the reference's ``SoftwarePaxos``; and
``batched.acceptor_sequential`` (one message at a time, duplicate slots
allowed) against the reference's ``lax.scan`` version.  Tolerance: none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import batched as rbatched  # noqa: E402
from repro.core import log as rlog  # noqa: E402
from repro.train import elastic as relastic  # noqa: E402
from repro_torch.core import batched as tbatched  # noqa: E402
from repro_torch.core import log as tlog  # noqa: E402
from repro_torch.core.types import MSG_NOP, MSG_P1A, MSG_P2A, MSG_P2B  # noqa: E402
from repro_torch.train import elastic as telastic  # noqa: E402

SMALL = dict(n_acceptors=3, n_instances=256, batch=8)


# ---------------------------------------------------------------------------
# ReplicatedLog
# ---------------------------------------------------------------------------
def _drive_log(mod, ops, quorum: int) -> list:
    log = mod.ReplicatedLog(quorum=quorum)
    applied: list = []
    log.on_apply = lambda i, p: applied.append((i, p))
    seen = []
    for op in ops:
        if op[0] == "offer":
            log.offer(op[1], op[2])
            seen.append(None)
        elif op[0] == "ack":
            seen.append(log.ack_trim(op[1], op[2]))
        else:
            seen.append(log.gaps(op[1]))
        seen.append((log.apply_watermark, log.trim_watermark, dict(log.entries)))
    seen.append([dataclasses.astuple(e) for e in log.applied])
    seen.append(applied)
    return seen


_LOG_OPS = st.lists(
    st.one_of(
        st.tuples(st.just("offer"), st.integers(0, 24), st.binary(max_size=4)),
        st.tuples(st.just("ack"), st.integers(0, 3), st.integers(0, 24)),
        st.tuples(st.just("gaps"), st.integers(0, 30)),
    ),
    max_size=60,
)


@settings(max_examples=150, deadline=None)
@given(ops=_LOG_OPS, quorum=st.integers(1, 3))
def test_replicated_log_equals_the_reference(ops, quorum):
    assert _drive_log(tlog, ops, quorum) == _drive_log(rlog, ops, quorum)


def test_replicated_log_order_gaps_trim():
    """The reference's own case, then the same sequence through both."""
    ops = [("offer", 0, b"a"), ("offer", 2, b"c"), ("gaps", 3), ("offer", 1, b"b"),
           ("ack", 0, 2), ("ack", 1, 2), ("offer", 1, b"zz"), ("gaps", 5),
           ("ack", 0, 9), ("ack", 1, 9), ("offer", 4, b"e"), ("offer", 3, b"d"),
           ("ack", 2, 9)]  # fmt: skip
    got = _drive_log(tlog, ops, 2)
    assert got == _drive_log(rlog, ops, 2)
    assert got[4] == [1]  # gaps(3) with 0 and 2 offered
    assert got[10] is True and got[11][1] == 2  # the second ack trims below 2
    assert got[16] is got[18] is got[24] is False  # 9 is past the apply watermark
    assert got[-1] == [(0, b"a"), (1, b"b"), (2, b"c"), (3, b"d"), (4, b"e")]
    assert T.ReplicatedLog is tlog.ReplicatedLog


# ---------------------------------------------------------------------------
# elastic: membership views agreed through the log
# ---------------------------------------------------------------------------
def test_membership_view_bytes_and_replan_equal_the_reference():
    for epoch, hosts, shape, axes in [
        (0, ("h0", "h1", "h2", "h3"), (2, 2), ("data", "model")),
        (7, (), (1, 1), ("data", "model")),
        (2**40, ("é", 'q"uote'), (31, 16), ("data", "model")),
    ]:
        want = relastic.MembershipView(epoch, hosts, shape, axes)
        have = telastic.MembershipView(epoch, hosts, shape, axes)
        assert have.encode() == want.encode()
        assert dataclasses.astuple(telastic.MembershipView.decode(want.encode())) == (
            dataclasses.astuple(want)
        )  # fmt: skip
    for n in range(1, 600, 7):
        for mp in (1, 4, 16, 64):
            assert telastic.replan_mesh(n, model_parallel=mp) == relastic.replan_mesh(
                n, model_parallel=mp
            )  # fmt: skip
    assert telastic.replan_mesh(512)[0] == (32, 16) and telastic.replan_mesh(496)[0] == (31, 16)


def _views(pkg, mod, host_sets) -> list:
    cfg = pkg.PaxosConfig(**{**SMALL, "value_words": 64})
    extra = {"device": "cpu"} if pkg is T else {}
    seen: list = []
    ctx = pkg.PaxosContext(cfg, deliver=lambda v, s, i: seen.append((i, v)), **extra)
    v0 = mod.MembershipView(0, ("h0", "h1", "h2", "h3"), (2, 2), ("data", "model"))
    vm = mod.ViewManager(ctx, v0)
    out = []
    for k, hosts in enumerate(host_sets):
        ctx.submit(f"app-{k}".encode())  # the wrapped callback still sees these
        out.append(dataclasses.astuple(vm.propose_view(hosts, model_parallel=2)))
    off = mod.ViewManager(None, v0)  # no context: decided locally
    out.append(dataclasses.astuple(off.propose_view(["a", "b", "c"], model_parallel=1)))
    return out, [dataclasses.astuple(v) for v in vm._decided], seen


def test_view_manager_over_a_port_context_equals_the_reference():
    host_sets = [["h0", "h1", "h3"], ["h3", "h2", "h1", "h0", "h4"], ["h1"]]
    got = _views(T, telastic, host_sets)
    assert got == _views(R, relastic, host_sets)
    views, decided, seen = got
    assert [v[0] for v in views] == [1, 2, 3, 1] and len(decided) == 4
    assert views[1][1] == ("h0", "h1", "h2", "h3", "h4") and views[1][2] == (2, 2)
    assert [v for _i, v in seen][:2] == [b"app-0", seen[1][1]] and seen[1][1][:5] == b"view:"


# ---------------------------------------------------------------------------
# SoftwarePaxos: the software baseline
# ---------------------------------------------------------------------------
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(1, 12))
def test_software_baseline_agrees_with_the_port_dataplane(seed, n):
    """The software deployment and the port's dataplane deliver the same
    values under the same submissions; the reference's baseline delivers
    the same ``(inst, payload)`` log as the port's."""
    sw = T.SoftwarePaxos(T.PaxosConfig(**SMALL), net=T.SimNet(seed=seed))
    ref = R.SoftwarePaxos(R.PaxosConfig(**SMALL), net=R.SimNet(seed=seed))
    hw_delivered = []
    hw = T.PaxosContext(T.PaxosConfig(**SMALL), deliver=lambda v, s, i: hw_delivered.append(v),
                        net=T.SimNet(seed=seed), device="cpu")  # fmt: skip
    payloads = [f"p{k}".encode() for k in range(n)]
    for p in payloads:
        for ctx in (sw, ref, hw):
            ctx.submit(p)
    for ctx in (sw, ref, hw):
        ctx.run_until_quiescent()
    assert [v for _, v in sw.delivered] == payloads == hw_delivered
    assert sw.delivered == ref.delivered


@pytest.mark.parametrize("seed", [0, 3])
def test_software_baseline_under_faults_and_a_dead_acceptor(seed):
    faults = dict(drop=0.0, dup=0.2, reorder=0.3)
    calls = [[], []]
    runs = []
    for pkg, got in ((R, calls[0]), (T, calls[1])):
        sw = pkg.SoftwarePaxos(
            pkg.PaxosConfig(**SMALL),
            deliver=lambda v, s, i, got=got: got.append((i, v, s)),
            net=pkg.SimNet(pkg.FaultSpec(**faults), seed=seed),
            n_learners=2,
        )
        sw.kill_acceptor(2)
        for k in range(10):
            sw.submit(f"x{k}".encode())
        sw.run_until_quiescent()
        sw.revive_acceptor(2)
        sw.submit(b"after")
        sw.run_until_quiescent()
        runs.append((sw.delivered, sorted(sw.busy), sw.alive))
    assert runs[0] == runs[1] and calls[0] == calls[1]
    assert set(runs[1][1]) == {"proposer", "coordinator", "acceptor", "learner"}
    # a duplicated vote may deliver twice (the baseline's learner keeps no
    # dedup ring), in both packages alike; every value is delivered
    assert {v for _i, v in runs[1][0]} == {f"x{k}".encode() for k in range(10)} | {b"after"}


# ---------------------------------------------------------------------------
# acceptor_sequential and MsgBatch.batch
# ---------------------------------------------------------------------------
N, V = 32, 4
_MSG = st.fixed_dictionaries(
    {
        "t": st.sampled_from([MSG_P2A, MSG_P1A, MSG_NOP, MSG_P2B]),
        "i": st.integers(0, 3 * N),
        "r": st.integers(0, 4),
        "val": st.integers(-100, 100),
    }
)


def _batch(pkg, msgs):
    cols = {
        "msgtype": np.array([m["t"] for m in msgs], np.int32),
        "inst": np.array([m["i"] for m in msgs], np.int32),
        "rnd": np.array([m["r"] for m in msgs], np.int32),
        "vrnd": np.full(len(msgs), -1, np.int32),
        "swid": np.zeros(len(msgs), np.int32),
        "value": np.array([[m["val"] + w for w in range(V)] for m in msgs], np.int32),
    }
    if pkg is T:
        return T.MsgBatch(**{k: torch.from_numpy(v) for k, v in cols.items()})
    import jax.numpy as jnp

    return R.MsgBatch(**{k: jnp.asarray(v) for k, v in cols.items()})


def _state(pkg, seed: int):
    rng = np.random.default_rng(seed)
    rnd = rng.integers(0, 3, N).astype(np.int32)
    vrnd = np.where(rng.random(N) < 0.5, -1, rng.integers(0, 3, N)).astype(np.int32)
    value = rng.integers(-9, 9, (N, V)).astype(np.int32)
    if pkg is T:
        return T.AcceptorState(*(torch.from_numpy(x.copy()) for x in (rnd, vrnd, value)))
    import jax.numpy as jnp

    return R.AcceptorState(*(jnp.asarray(x) for x in (rnd, vrnd, value)))


def _fields(astate, out) -> list[np.ndarray]:
    return [np.asarray(x) for x in (astate.rnd, astate.vrnd, astate.value, out.msgtype,
                                    out.inst, out.rnd, out.vrnd, out.swid, out.value)]  # fmt: skip


def _check_sequential(msgs, seed: int, aid: int = 2) -> None:
    want = _fields(*rbatched.acceptor_sequential(_state(R, seed), _batch(R, msgs), aid=aid))
    have = _fields(*tbatched.acceptor_sequential(_state(T, seed), _batch(T, msgs), aid=aid))
    for w, h in zip(want, have, strict=True):
        np.testing.assert_array_equal(h, w)


@settings(max_examples=25, deadline=None)
@given(msgs=st.lists(_MSG, min_size=24, max_size=24), seed=st.integers(0, 99))
def test_acceptor_sequential_equals_the_reference_on_duplicate_slots(msgs, seed):
    _check_sequential(msgs, seed)


@pytest.mark.parametrize("n", [1, 8, 24])
def test_acceptor_sequential_on_one_slot_hit_repeatedly(n):
    """Every message on the same slot (instances N apart), rounds up and
    down, prepares between votes: each sees the previous one's write."""
    kinds = [MSG_P2A, MSG_P1A, MSG_NOP, MSG_P2A]
    msgs = [{"t": kinds[j % 4], "i": 5 + N * (j % 3), "r": (j * 7) % 5, "val": j}
            for j in range(n)]  # fmt: skip
    _check_sequential(msgs, seed=n, aid=1)


def test_acceptor_sequential_equals_the_vectorised_vote_on_distinct_slots():
    rng = np.random.default_rng(4)
    msgs = [{"t": MSG_P2A, "i": 40 + j, "r": 2, "val": int(rng.integers(-9, 9))}
            for j in range(16)]  # fmt: skip
    a1, v1 = tbatched.acceptor_phase2(_state(T, 4), _batch(T, msgs), aid=1)
    a2, v2 = tbatched.acceptor_sequential(_state(T, 4), _batch(T, msgs), aid=1)
    for x, y in zip(_fields(a1, v1), _fields(a2, v2), strict=True):
        np.testing.assert_array_equal(x, y)
    batch = _batch(T, msgs)
    assert batch.batch == 16 == _batch(R, msgs).batch
