"""The port's staged path against the reference's, bit for bit.

The staged path is ``PaxosContext`` with its default ``fused=False``: the
coordinator sequences a burst (``ops.coordinator_sequence``, K3 on the
card), the acceptor array votes (``ops.acceptor_phase2_all``, K2 on the
card) and the votes travel over ``SimNet`` to software learners.  On the
CPU the port runs the kernels' plain versions; the reference, with
``use_kernels=True``, runs its Pallas kernels in interpret mode, as its own
tests run them.  Every int32 output and register must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import batched as rb  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core import batched as tb  # noqa: E402
from repro_torch.core.bridge import export_state, import_state  # noqa: E402
from repro_torch.kernels import coordinator as tcoord  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

CFG = dict(n_acceptors=3, n_instances=256, value_words=16, batch=16)
FAULTS = dict(drop=0.08, dup=0.05, reorder=0.1)
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
FIELDS = ("msgtype", "inst", "rnd", "vrnd", "swid", "value")


def _contexts(seed: int, n_learners: int):
    ref = R.PaxosContext(
        R.PaxosConfig(**CFG),
        net=R.SimNet(R.FaultSpec(**FAULTS), seed),
        use_kernels=True,
        n_learners=n_learners,
    )
    got = T.PaxosContext(
        T.PaxosConfig(**CFG),
        net=T.SimNet(T.FaultSpec(**FAULTS), seed),
        n_learners=n_learners,
        device="cpu",
    )
    assert not ref.fused and not got.fused  # the staged path is the default
    return ref, got


def _step(ctx, op, arg, tag):
    """Apply one schedule step; returns what the step reports, if anything."""
    hw = ctx.hw
    if op == "submit":
        for i in range(arg):
            ctx.submit(f"{tag}-{i}-{'y' * (i % 41)}".encode())
    elif op == "drain":
        ctx.run_until_quiescent()
    elif op == "pump":
        ctx.pump(arg)
    elif op == "kill":
        hw.kill_acceptor(arg)
    elif op == "revive":
        hw.revive_acceptor(arg)
    elif op == "fail":  # the software coordinator's estimate, ahead by arg
        res = ctx.fail_coordinator(est_next_inst=hw._next_inst_host + arg)
        return res.next_inst, res.reproposed
    elif op == "restore_hw":
        ctx.restore_hardware_coordinator()
    elif op == "recover":  # an instance arg below the watermark
        ctx.recover(hw._next_inst_host - arg)
    else:
        raise ValueError(op)
    return None


SCHEDULES = {
    # 6 x 60 payloads in full bursts of 16 lanes: well past 256 instances
    "ring_wrap": [("submit", 60), ("drain", None)] * 6,
    "kill_to_quorum_boundary_and_below": [
        ("submit", 40), ("drain", None),
        ("kill", 2), ("submit", 40), ("drain", None),  # at the boundary
        ("kill", 0), ("submit", 5), ("pump", 4),  # below quorum: nothing decides
        ("revive", 0), ("drain", None),
        ("revive", 2), ("submit", 40), ("drain", None),
    ],
    "failover_restore_recover": [
        ("submit", 50), ("drain", None),
        ("submit", 30), ("pump", 1), ("fail", 0),  # takeover re-proposes votes in flight
        ("submit", 30), ("drain", None),
        ("restore_hw", None), ("submit", 40), ("drain", None),
        ("fail", 24), ("kill", 1), ("submit", 20), ("drain", None),  # a gap, misaligned
        ("restore_hw", None), ("revive", 1),  # burns forward to the block boundary
        ("recover", 100), ("recover", 3), ("drain", None),  # a decided one, a skipped one
        ("submit", 120), ("drain", None),
    ],
}  # fmt: skip


@pytest.mark.parametrize("seed,n_learners", [(1, 1), (7, 2)])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_staged_context_matches_reference(name, seed, n_learners):
    ref, got = _contexts(seed + len(name), n_learners)
    for n, (op, arg) in enumerate(SCHEDULES[name]):
        r = _step(ref, op, arg, f"{n}")
        g = _step(got, op, arg, f"{n}")
        assert r == g, (n, op, r, g)
    assert got.delivered_log == ref.delivered_log
    assert got.learned == ref.learned
    assert got.stats == ref.stats
    assert got.quiescent() and ref.quiescent()
    assert len(got.delivered_log) == got.stats["submitted"]
    want, have = export_state(ref.hw), export_state(got.hw)
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)
    assert got.hw.dispatch_count == ref.hw.dispatch_count


# ---------------------------------------------------------------------------
# the staged path's dispatch entries against the reference's kernels
# ---------------------------------------------------------------------------
def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize(
    "next_inst,b",
    [(0, 8), (1000, 16), (3 * 128, 128), (I32_MAX - 5, 8), (I32_MAX - 100, 256)],
)
def test_coordinator_sequence_matches_tpu_kernel(next_inst, b):
    """K3's dispatch entry against the reference's, the watermark wrapping
    through int32 max as int32 arithmetic does."""
    rng = np.random.default_rng([next_inst % 1000, b])
    active = rng.random(b) < 0.7
    vals = rng.integers(I32_MIN, I32_MAX, (b, 4), dtype=np.int32, endpoint=True)
    rc, rp = rops.coordinator_sequence(
        R.CoordinatorState(jnp.int32(next_inst), jnp.int32(9)),
        jnp.asarray(vals),
        jnp.asarray(active),
    )
    tc, tp = tops.coordinator_sequence(
        T.CoordinatorState.init(crnd=9, next_inst=next_inst), _t(vals), _t(active)
    )
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(rp, f)), f)
    assert int(tc.next_inst) == int(rc.next_inst) and int(tc.crnd) == 9


@pytest.mark.parametrize("b", [1, 3, 129, 4096])
@pytest.mark.parametrize("next_inst", [0, I32_MAX - 1, I32_MAX - 2048, -7])
def test_coordinator_sequence_matches_tpu_kernel_at_any_burst(next_inst, b):
    """K3's bursts: any B, watermarks at and near int32 max, where the
    instances and the advanced watermark wrap.  The reference's kernel
    takes B only as a multiple of its block (128 above 128); at B = 129 the
    oracle is the reference's jnp sequencer."""
    rng = np.random.default_rng([b, next_inst % 1009])
    active = rng.random(b) < 0.5
    vals = rng.integers(I32_MIN, I32_MAX, (b, 4), dtype=np.int32, endpoint=True)
    ref = rops.coordinator_sequence if b <= 128 or b % 128 == 0 else rb.coordinator_sequence
    rc, rp = ref(
        R.CoordinatorState(jnp.int32(next_inst), jnp.int32(3)),
        jnp.asarray(vals),
        jnp.asarray(active),
    )
    tc, tp = tops.coordinator_sequence(
        T.CoordinatorState.init(crnd=3, next_inst=next_inst), _t(vals), _t(active)
    )
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(rp, f)), f)
    assert int(tc.next_inst) == int(rc.next_inst)


@pytest.mark.parametrize("b", [1, 3, 4, 8, 127, 128, 129, 132, 4096, 4097])
def test_sequence_geometry_covers_the_burst_in_whole_warps(b):
    """K3's launch: a thread a lane, whole warps a block, at most THREADS,
    and as few blocks as cover the burst."""
    geo = tcoord.sequence_geometry(b)
    assert geo.block % 32 == 0 and 32 <= geo.block <= tcoord.THREADS
    (blocks,) = geo.grid
    assert blocks * geo.block >= b > (blocks - 1) * geo.block
    if b <= tcoord.THREADS:
        assert blocks == 1 and geo.block - 32 < b
    if b == 128:
        assert (geo.block, geo.grid) == (128, (1,))


def test_sequence_geometry_refuses_an_empty_burst():
    with pytest.raises(ValueError, match="at least one lane"):
        tcoord.sequence_geometry(0)


def test_sequencer_kernel_refuses_cpu_tensors():
    one = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tcoord.coordinator_sequence_window(one, one, torch.ones(8, dtype=torch.bool))


def _stack_state(rng, a: int, n: int, v: int, hi: int = 9):
    return dict(
        rnd=rng.integers(0, hi, (a, n), dtype=np.int32),
        vrnd=rng.integers(-1, hi, (a, n), dtype=np.int32),
        val=rng.integers(I32_MIN, I32_MAX, (a, n, v), dtype=np.int32, endpoint=True),
    )


def _phase2_batch(rng, inst: np.ndarray, v: int, hi: int = 9):
    """A Phase-2 batch mixing P2As, NOP fillers and other types (never
    accepted), at rounds below, at and above the promises."""
    b = inst.shape[0]
    return dict(
        msgtype=rng.choice([0, 1, 3, 3, 3, 4, 7], b).astype(np.int32),
        inst=inst.astype(np.int32),
        rnd=rng.integers(-1, hi + 2, b, dtype=np.int32),
        vrnd=np.full(b, -1, np.int32),
        swid=np.zeros(b, np.int32),
        value=rng.integers(I32_MIN, I32_MAX, (b, v), dtype=np.int32, endpoint=True),
    )


def _both_stacks(s):
    ref = R.AcceptorState(*(jnp.asarray(s[k]) for k in ("rnd", "vrnd", "val")))
    got = T.AcceptorState(*(_t(s[k].copy()) for k in ("rnd", "vrnd", "val")))
    return ref, got


def _assert_votes(rv, tv):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tv, f).numpy(), np.asarray(getattr(rv, f)), f)


def _assert_stack(rs, ts):
    for f in ("rnd", "vrnd", "value"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(rs, f)), f)


@pytest.mark.parametrize(
    "alive,n,b,base",
    [
        ([1, 1, 1], 256, 16, 64),  # aligned
        ([1, 1, 1], 512, 256, 3 * 512 - 128),  # a 128-block window across the ring end
        ([1, 0, 1], 256, 8, 2 * 256 + 40),  # a dead acceptor
        ([0, 1, 0], 256, 16, 96),  # below the quorum: the rows still come back
        ([1, 1, 0, 1, 0], 512, 128, 512 + 384),
    ],
)
def test_vote_all_matches_tpu_kernel(alive, n, b, base):
    """K2's dispatch entry against the reference's K2 (interpret mode) on
    windows it takes (block-aligned), three consecutive windows, the state
    updated in place."""
    a, v = len(alive), 8
    rng = np.random.default_rng([a, n, b, base])
    ref, got = _both_stacks(_stack_state(rng, a, n, v))
    ptrs = [x.data_ptr() for x in vars(got).values()]
    alv = np.asarray(alive, bool)
    for r in range(3):
        m = _phase2_batch(rng, base + r * b + np.arange(b), v)
        ref, rv = rops.acceptor_phase2_all(
            ref, R.MsgBatch(**{k: jnp.asarray(x) for k, x in m.items()}), jnp.asarray(alv)
        )
        got, tv = tops.acceptor_phase2_all(
            got, T.MsgBatch(**{k: _t(x) for k, x in m.items()}), _t(alv)
        )
        _assert_votes(rv, tv)
        _assert_stack(ref, got)
    assert [x.data_ptr() for x in vars(got).values()] == ptrs


@pytest.mark.parametrize("a,b", [(3, 8), (3, 64), (5, 256)])
def test_plain_vote_all_on_scattered_distinct_slots(a, b):
    """The plain K2 on batches whose lanes address distinct but scattered
    slots, at arbitrary laps and some negative instances (int32 wrap),
    against the reference's jnp engine: the shape of the recovery and
    takeover batches the port's K2 serves at any base."""
    n, v = 256, 4
    rng = np.random.default_rng([a, b, 11])
    ref, got = _both_stacks(_stack_state(rng, a, n, v))
    alv = rng.random(a) < 0.75
    for _ in range(3):
        slots = rng.permutation(n)[:b]
        laps = rng.integers(-3, 40, b)
        m = _phase2_batch(rng, slots + laps * n, v)
        ref, rv = rb.acceptor_phase2_all(
            ref, R.MsgBatch(**{k: jnp.asarray(x) for k, x in m.items()}), jnp.asarray(alv)
        )
        got, tv = tops.acceptor_phase2_all(
            got, T.MsgBatch(**{k: _t(x) for k, x in m.items()}), _t(alv)
        )
        _assert_votes(rv, tv)
        _assert_stack(ref, got)


@pytest.mark.parametrize("rounds_before", [2, 5])
def test_bridge_carries_a_staged_reference_context_into_the_port(rounds_before):
    """A reference staged context, run mid-stream (lossy net, a dead
    acceptor, a failover), exports its dataplane; the port loads it and both
    sequence and vote on identically: votes and registers equal."""
    ref = R.PaxosContext(
        R.PaxosConfig(**CFG), net=R.SimNet(R.FaultSpec(**FAULTS), rounds_before), use_kernels=True
    )
    for i in range(rounds_before * 16):
        ref.submit(f"pre-{i}".encode())
    ref.run_until_quiescent()
    ref.hw.kill_acceptor(0)
    ref.fail_coordinator()
    ref.submit(b"soft")
    ref.run_until_quiescent()
    ref.restore_hardware_coordinator()
    got = T.HardwareDataplane(T.PaxosConfig(**CFG), device="cpu")
    import_state(got, export_state(ref.hw))
    rng = np.random.default_rng(rounds_before)
    for r in range(4):
        vals = rng.integers(I32_MIN, I32_MAX, (16, 16), dtype=np.int32, endpoint=True)
        active = rng.random(16) < 0.8
        if r == 2:
            ref.hw.revive_acceptor(0)
            got.revive_acceptor(0)
        rvotes = ref.hw.vote(ref.hw.sequence(vals, active))
        tvotes = got.vote(got.sequence(vals, active))
        for rv, tv in zip(rvotes, tvotes, strict=True):
            assert (rv is None) == (tv is None)
            if rv is not None:
                _assert_votes(rv, tv)
        want, have = export_state(ref.hw), export_state(got)
        for key in want:
            np.testing.assert_array_equal(have[key], want[key], err_msg=key)


def test_staged_entries_are_the_plain_engine_on_the_cpu():
    """On CPU tensors the staged dispatch entries are the plain engine's
    functions: a context with ``use_kernels=False`` and one with kernels
    decide identically."""
    ctxs = [
        T.PaxosContext(T.PaxosConfig(**CFG), use_kernels=k, device="cpu") for k in (True, False)
    ]
    for ctx in ctxs:
        for i in range(40):
            ctx.submit(f"p-{i}".encode())
        ctx.run_until_quiescent()
    assert ctxs[0].delivered_log == ctxs[1].delivered_log
    assert ctxs[0].hw._vote_all is tops.acceptor_phase2_all
    assert ctxs[1].hw._vote_all is tb.acceptor_phase2_all
