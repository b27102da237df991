"""The port's plain engine against the reference's, bit for bit.

``repro_torch.core.batched`` (PyTorch, on the CPU) and ``repro.core.batched``
(jnp) get the same inputs, made from a seed with numpy, and must return the
same outputs and leave the same register files: random and adversarial
batches, dead acceptors below and at the quorum boundary, windows that cross
the ring end, misaligned bases, NO_ROUND, a reclaim limit inside the window
and ``limit=None``, A in {3, 5}.  Also the types, the codec and the burst
planning helpers.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import batched as rb  # noqa: E402
from repro.core import plan as rplan  # noqa: E402
from repro.core import types as rt  # noqa: E402
from repro_torch.core import batched as tb  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import types as tt  # noqa: E402

N, V = 256, 4
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _eq(ref, got) -> None:
    np.testing.assert_array_equal(np.asarray(ref), got.cpu().numpy())


def _rand_state(rng, a: int, n: int = N, v: int = V) -> dict[str, np.ndarray]:
    return dict(
        rnd=rng.integers(0, 9, (a, n), dtype=np.int32),
        vrnd=rng.integers(-1, 9, (a, n), dtype=np.int32),
        val=rng.integers(I32_MIN, I32_MAX, (a, n, v), dtype=np.int32, endpoint=True),
        ldel=rng.integers(0, 2, (n,), dtype=np.int32),
        linst=rng.integers(-1, 4 * n, (n,), dtype=np.int32),
        lval=rng.integers(I32_MIN, I32_MAX, (n, v), dtype=np.int32, endpoint=True),
    )


def _stacks(s: dict[str, np.ndarray]):
    ref = rt.AcceptorState(jnp.asarray(s["rnd"]), jnp.asarray(s["vrnd"]), jnp.asarray(s["val"]))
    got = tt.AcceptorState(
        torch.from_numpy(s["rnd"].copy()),
        torch.from_numpy(s["vrnd"].copy()),
        torch.from_numpy(s["val"].copy()),
    )
    return ref, got


def _learners(s: dict[str, np.ndarray]):
    ref = rb.LearnerState(jnp.asarray(s["ldel"]), jnp.asarray(s["linst"]), jnp.asarray(s["lval"]))
    got = tb.LearnerState(
        torch.from_numpy(s["ldel"].copy()),
        torch.from_numpy(s["linst"].copy()),
        torch.from_numpy(s["lval"].copy()),
    )
    return ref, got


def _msgs(rng, base: int, b: int, rnd: np.ndarray, types: tuple[int, ...]):
    fields = dict(
        msgtype=rng.choice(np.asarray(types, np.int32), b),
        inst=(base + np.arange(b)).astype(np.int32),
        rnd=rnd.astype(np.int32),
        vrnd=np.full((b,), -1, np.int32),
        swid=np.zeros((b,), np.int32),
        value=rng.integers(I32_MIN, I32_MAX, (b, V), dtype=np.int32, endpoint=True),
    )
    ref = rt.MsgBatch(**{k: jnp.asarray(x) for k, x in fields.items()})
    got = tt.MsgBatch(**{k: torch.from_numpy(x.copy()) for k, x in fields.items()})
    return ref, got


def _eq_msgs(ref, got) -> None:
    for name in ("msgtype", "inst", "rnd", "vrnd", "swid", "value"):
        _eq(getattr(ref, name), getattr(got, name))


def _eq_stack(ref, got) -> None:
    _eq(ref.rnd, got.rnd)
    _eq(ref.vrnd, got.vrnd)
    _eq(ref.value, got.value)


def _eq_learner(ref, got) -> None:
    _eq(ref.delivered, got.delivered)
    _eq(ref.inst, got.inst)
    _eq(ref.value, got.value)


# windows: aligned, misaligned, crossing the ring end, far past several laps
BASES = [0, 37, N - 5, 7 * N + 250]
# alive masks at A=3 (quorum 2) and A=5 (quorum 3): all, below the boundary
# (f dead: still a quorum), at it (f+1 dead: none), all dead
ALIVE = [
    [1, 1, 1],
    [1, 0, 1],
    [0, 1, 0],
    [1, 1, 1, 1, 1],
    [0, 1, 1, 0, 1],
    [1, 0, 0, 1, 0],
    [0, 0, 0, 0, 0],
]


def test_types_codec_and_config_match():
    for kw in ({}, dict(n_acceptors=5, n_instances=512, value_words=8, batch=32)):
        ref, got = rt.PaxosConfig(**kw), tt.PaxosConfig(**kw)
        assert (ref.f, ref.quorum, ref.max_payload_bytes) == (
            got.f,
            got.quorum,
            got.max_payload_bytes,
        )
    _eq_stack(rt.AcceptorState.init(N, V), tt.AcceptorState.init(N, V))
    _eq_learner(rb.LearnerState.init(N, V), tb.LearnerState.init(N, V))
    _eq_msgs(rt.MsgBatch.nop(16, V), tt.MsgBatch.nop(16, V))
    rc, tc = rt.CoordinatorState.init(crnd=3, next_inst=9), tt.CoordinatorState.init(3, 9)
    _eq(rc.next_inst, tc.next_inst)
    _eq(rc.crnd, tc.crnd)
    for payload in (b"", b"x", bytes(range(64))):
        words = tt.encode_value(payload)
        np.testing.assert_array_equal(words, rt.encode_value(payload))
        assert tt.decode_value(words) == rt.decode_value(words)
    with pytest.raises(ValueError):
        tt.encode_value(bytes(65))


def test_plan_helpers_match():
    for n, cap in [(0, 128), (1, 128), (8, 128), (9, 128), (100, 128), (500, 128), (3, 16)]:
        assert tplan.quantize_burst(n, cap) == rplan.quantize_burst(n, cap)
    for b in (8, 64, 128, 256):
        assert tplan.wire_block(b) == rplan.wire_block(b)
    rows = [np.full((V,), i, np.int32) for i in range(5)]
    for x, y in zip(tplan.pack_rows(rows, 8, V), rplan.pack_rows(rows, 8, V), strict=True):
        np.testing.assert_array_equal(x, y)
    assert (tplan.NO_ROUND, tplan.NOP_SENTINEL, tplan.MIN_BURST) == (
        rplan.NO_ROUND,
        rplan.NOP_SENTINEL,
        rplan.MIN_BURST,
    )


@pytest.mark.parametrize("base", BASES)
def test_coordinator_sequence_matches(base):
    rng = np.random.default_rng(base)
    vals = rng.integers(I32_MIN, I32_MAX, (16, V), dtype=np.int32, endpoint=True)
    active = rng.random(16) < 0.5
    rc, rm = rb.coordinator_sequence(
        rt.CoordinatorState.init(crnd=4, next_inst=base), jnp.asarray(vals), jnp.asarray(active)
    )
    tc, tm = tb.coordinator_sequence(
        tt.CoordinatorState.init(4, base), torch.from_numpy(vals), torch.from_numpy(active)
    )
    _eq(rc.next_inst, tc.next_inst)
    _eq(rc.crnd, tc.crnd)
    _eq_msgs(rm, tm)


@pytest.mark.parametrize("alive", ALIVE)
@pytest.mark.parametrize("base", BASES)
def test_acceptor_phase2_all_matches(alive, base):
    a, b = len(alive), 16
    rng = np.random.default_rng([a, base, sum(alive)])
    s = _rand_state(rng, a)
    # message rounds around the promises, NO_ROUND among them
    rnd = rng.integers(-1, 9, (b,))
    rm, tm = _msgs(rng, base, b, rnd, (rt.MSG_P2A, rt.MSG_NOP, rt.MSG_P1A))
    rs, ts = _stacks(s)
    alv = np.asarray(alive, bool)
    rs, rv = rb.acceptor_phase2_all(rs, rm, jnp.asarray(alv))
    ts, tv = tb.acceptor_phase2_all(ts, tm, torch.from_numpy(alv))
    _eq_stack(rs, ts)
    _eq_msgs(rv, tv)


@pytest.mark.parametrize("alive", ALIVE)
@pytest.mark.parametrize("base", BASES)
def test_acceptor_phase1_all_matches(alive, base):
    a, b = len(alive), 16
    rng = np.random.default_rng([a, base, sum(alive), 1])
    s = _rand_state(rng, a)
    rnd = rng.integers(-1, 12, (b,))
    rm, tm = _msgs(rng, base, b, rnd, (rt.MSG_P1A, rt.MSG_NOP, rt.MSG_P2A))
    rs, ts = _stacks(s)
    alv = np.asarray(alive, bool)
    rs, rv = rb.acceptor_phase1_all(rs, rm, jnp.asarray(alv))
    ts, tv = tb.acceptor_phase1_all(ts, tm, torch.from_numpy(alv))
    _eq_stack(rs, ts)
    _eq_msgs(rv, tv)


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("aid", [0, 2])
def test_single_acceptor_matches(phase, aid):
    rng = np.random.default_rng([phase, aid])
    s = _rand_state(rng, 1)
    types = (rt.MSG_P1A, rt.MSG_P2A, rt.MSG_NOP)
    rm, tm = _msgs(rng, N - 3, 16, rng.integers(-1, 12, (16,)), types)
    rs, ts = _stacks(s)
    rone = rt.AcceptorState(rs.rnd[0], rs.vrnd[0], rs.value[0])
    tone = tt.AcceptorState(ts.rnd[0], ts.vrnd[0], ts.value[0])
    rfn = rb.acceptor_phase1 if phase == 1 else rb.acceptor_phase2
    tfn = tb.acceptor_phase1 if phase == 1 else tb.acceptor_phase2
    rone, rv = rfn(rone, rm, aid=aid)
    tone, tv = tfn(tone, tm, aid=aid)
    _eq_stack(rone, tone)
    _eq_msgs(rv, tv)


@pytest.mark.parametrize("a", [3, 5])
@pytest.mark.parametrize("seed", range(4))
def test_learner_quorum_matches(a, seed):
    rng = np.random.default_rng([a, seed, 2])
    b = 32
    mt = rng.choice(np.asarray([rt.MSG_P2B, rt.MSG_REJECT], np.int32), (a, b))
    inst = np.broadcast_to(np.arange(b, dtype=np.int32), (a, b)).copy()
    vrnd = rng.integers(-1, 3, (a, b), dtype=np.int32)
    val = rng.integers(I32_MIN, I32_MAX, (a, b, V), dtype=np.int32, endpoint=True)
    q = a // 2 + 1
    ref = rb.learner_quorum(*(jnp.asarray(x) for x in (mt, inst, vrnd, val)), q)
    got = tb.learner_quorum(*(torch.from_numpy(x) for x in (mt, inst, vrnd, val)), q)
    for r, g in zip(ref, got, strict=True):
        _eq(r, g)


@pytest.mark.parametrize("base", BASES)
def test_learner_update_matches(base):
    rng = np.random.default_rng([base, 3])
    s = _rand_state(rng, 1)
    b = 16
    inst = (base + np.arange(b)).astype(np.int32)
    s["linst"][inst % N] = np.where(rng.random(b) < 0.5, inst, s["linst"][inst % N])
    deliver = rng.random(b) < 0.7
    val = rng.integers(I32_MIN, I32_MAX, (b, V), dtype=np.int32, endpoint=True)
    rl, tl = _learners(s)
    rl, rf = rb.learner_update(rl, jnp.asarray(deliver), jnp.asarray(inst), jnp.asarray(val))
    tl, tf = tb.learner_update(
        tl, torch.from_numpy(deliver), torch.from_numpy(inst), torch.from_numpy(val)
    )
    _eq_learner(rl, tl)
    _eq(rf, tf)


_ref_fused = jax.jit(rb.fused_round, static_argnums=(6,))

FUSED_CASES = [
    # (alive, base, crnd, limit offset from base or None, burst)
    ([1, 1, 1], 0, 0, None, 16),
    ([1, 0, 1], 37, 5, None, 16),  # one dead: still a quorum
    ([0, 1, 0], 64, 5, None, 8),  # quorum boundary crossed: no delivery
    ([1, 1, 1], N - 5, 7, None, 16),  # window crosses the ring end
    ([1, 1, 1], 3 * N + 11, 6, 7, 16),  # reclaim limit inside the window
    ([1, 1, 1], 100, -1, None, 16),  # NO_ROUND: every acceptor rejects
    ([1, 1, 1, 1, 1], N - 9, 8, None, 32),
    ([0, 1, 1, 0, 1], 5 * N + 1, 4, 20, 32),  # A=5 at the boundary, limit
    ([1, 0, 0, 1, 0], 200, 4, None, 8),  # A=5 below the quorum
]


@pytest.mark.parametrize("alive,base,crnd,lim,b", FUSED_CASES)
def test_fused_round_matches_over_rounds(alive, base, crnd, lim, b):
    """Four consecutive rounds from one random state: every output and the
    final registers equal the reference's."""
    a = len(alive)
    rng = np.random.default_rng([a, base, crnd + 1, b])
    s = _rand_state(rng, a)
    # part of the window is already in the learner ring (duplicates)
    inst = (base + np.arange(4 * b)) % N
    s["linst"][inst[::3]] = (base + np.arange(4 * b))[::3]
    rs, ts = _stacks(s)
    rl, tl = _learners(s)
    rc, tc = rt.CoordinatorState.init(crnd, base), tt.CoordinatorState.init(crnd, base)
    alv = np.asarray(alive, bool)
    q = a // 2 + 1
    limit = None if lim is None else base + lim
    for _ in range(4):
        vals = rng.integers(I32_MIN, I32_MAX, (b, V), dtype=np.int32, endpoint=True)
        act = rng.random(b) < 0.8
        ref = _ref_fused(
            rc,
            rs,
            rl,
            jnp.asarray(vals),
            jnp.asarray(act),
            jnp.asarray(alv),
            q,
            None if limit is None else jnp.int32(limit),
        )
        got = tb.fused_round(
            tc, ts, tl, torch.from_numpy(vals), torch.from_numpy(act), torch.from_numpy(alv), q,
            limit,
        )  # fmt: skip
        rc, rs, rl = ref[:3]
        tc, ts, tl = got[:3]
        _eq(rc.next_inst, tc.next_inst)
        _eq_stack(rs, ts)
        _eq_learner(rl, tl)
        for r, g in zip(ref[3:], got[3:], strict=True):
            _eq(r, g)
