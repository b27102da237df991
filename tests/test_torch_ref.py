"""The port's kernel oracles (``repro_torch.kernels.ref``) against the
reference's (``repro.kernels.ref``), on the same seeded numpy inputs.

Every function is called with the reference's parameters in its order and
must return the reference's tuple in its order: the int32 functions bit for
bit, ``digest`` bit for bit on int32 and float32 arrays, ``flash_attention``
within 1e-5 in float32 and 2e-2 in bfloat16 (one rounding of p and of the
output).  Each port function must also leave its inputs as they were (the
port's plain engine updates state in place; its oracles clone) and equal
the port's plain route, the ``ops`` entry on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.batched import LearnerState  # noqa: E402
from repro_torch.core.types import AcceptorState, CoordinatorState, MsgBatch  # noqa: E402
from repro_torch.kernels import flash_attention as k_flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

F32_ATOL, BF16_ATOL = 1e-5, 2e-2
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
P2B = 4


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _same(got, want) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and w.dtype == np.int32, (i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {i}")


def _unchanged(tensors, arrays) -> None:
    for t, a in zip(tensors, arrays, strict=True):
        np.testing.assert_array_equal(t.numpy(), a)


def _ring(rng, lead: tuple, n: int, v: int):
    return (
        rng.integers(0, 9, lead + (n,), dtype=np.int32),
        rng.integers(-1, 9, lead + (n,), dtype=np.int32),
        rng.integers(I32_MIN, I32_MAX, lead + (n, v), dtype=np.int32, endpoint=True),
    )


def _burst(rng, b: int, v: int):
    return (
        rng.choice([0, 1, 3, 3, 3, 4, 7], b).astype(np.int32),
        rng.integers(-1, 11, b, dtype=np.int32),
        rng.integers(I32_MIN, I32_MAX, (b, v), dtype=np.int32, endpoint=True),
    )


def _window_inst(base: int, b: int, n: int) -> np.ndarray:
    return ((base + np.arange(b)) % n).astype(np.int32)


# (seed, n, b, v, base): base + b past N wraps the window
WINDOWS = [
    (0, 16, 8, 1, 0),
    (1, 16, 8, 4, 12),
    (2, 32, 32, 3, 7),
    (3, 64, 20, 16, 60),
    (4, 8, 8, 2, 2**31 - 5),
]


@pytest.mark.parametrize("seed,n,b,v,base", WINDOWS)
@pytest.mark.parametrize("aid", [0, 2])
def test_acceptor_phase2_window_matches_reference(seed, n, b, v, base, aid):
    rng = np.random.default_rng(seed)
    ring, burst = _ring(rng, (), n, v), _burst(rng, b, v)
    args = [_t(x) for x in (*ring, *burst)]
    got = tref.acceptor_phase2_window(*args[:3], base, aid, *args[3:])
    want = jref.acceptor_phase2_window(
        *(jnp.asarray(x) for x in ring), base, aid, *(jnp.asarray(x) for x in burst)
    )
    _same(got, want)
    _unchanged(args, (*ring, *burst))
    # the plain route: ops.acceptor_phase2 on the same window
    astate = AcceptorState(*(_t(x) for x in ring))
    msgs = MsgBatch(args[3], _t(_window_inst(base, b, n)), args[4], _t(np.full(b, -1, np.int32)),
                    _t(np.zeros(b, np.int32)), args[5])  # fmt: skip
    astate, votes = ops.acceptor_phase2(astate, msgs, aid)
    plain = (astate.rnd, astate.vrnd, astate.value, votes.msgtype, votes.rnd, votes.vrnd,
             votes.swid, votes.value)  # fmt: skip
    _same(got, [p.numpy() for p in plain])


@pytest.mark.parametrize("seed,n,b,v,base", WINDOWS)
@pytest.mark.parametrize("alive", ["all", "partial", "none"])
def test_acceptor_vote_all_window_matches_reference(seed, n, b, v, base, alive):
    rng = np.random.default_rng(seed)
    a = 5
    live = {"all": [1] * a, "partial": [1, 0, 1, 1, 0], "none": [0] * a}[alive]
    live = np.array(live, np.bool_)
    ring, burst = _ring(rng, (a,), n, v), _burst(rng, b, v)
    args = [_t(x) for x in (*ring, *burst)]
    alive_t = _t(live)
    got = tref.acceptor_vote_all_window(*args[:3], base, alive_t, *args[3:])
    want = jref.acceptor_vote_all_window(
        *(jnp.asarray(x) for x in ring), base, jnp.asarray(live), *(jnp.asarray(x) for x in burst)
    )
    _same(got, want)
    _unchanged([*args, alive_t], (*ring, *burst, live))
    stack = AcceptorState(*(_t(x) for x in ring))
    msgs = MsgBatch(args[3], _t(_window_inst(base, b, n)), args[4], _t(np.full(b, -1, np.int32)),
                    _t(np.zeros(b, np.int32)), args[5])  # fmt: skip
    stack, votes = ops.acceptor_phase2_all(stack, msgs, _t(live))
    plain = (stack.rnd, stack.vrnd, stack.value, votes.msgtype, votes.rnd, votes.vrnd,
             votes.swid, votes.value)  # fmt: skip
    _same(got, [p.numpy() for p in plain])


@pytest.mark.parametrize(
    "next_inst,crnd,b", [(0, 0, 1), (5, 3, 8), (2**31 - 4, 7, 16), (-3, -1, 5), (1000, 2, 129)]
)
@pytest.mark.parametrize("seed", [0, 1])
def test_coordinator_sequence_window_matches_reference(next_inst, crnd, b, seed):
    active = np.random.default_rng(seed).integers(0, 2, b).astype(np.bool_)
    ni, cr, act = _t(np.int32(next_inst)), _t(np.int32(crnd)), _t(active)
    got = tref.coordinator_sequence_window(ni, cr, act)
    want = jref.coordinator_sequence_window(
        jnp.int32(next_inst), jnp.int32(crnd), jnp.asarray(active)
    )
    _same(got, want)
    _unchanged([ni, cr, act], (np.int32(next_inst), np.int32(crnd), active))
    cstate, out = ops.coordinator_sequence(
        CoordinatorState(_t(np.int32(next_inst)), _t(np.int32(crnd))),
        _t(np.zeros((b, 2), np.int32)), _t(active),
    )  # fmt: skip
    _same(got, [x.numpy() for x in (out.msgtype, out.inst, out.rnd, out.vrnd, cstate.next_inst)])


def _votes(rng, a: int, b: int, v: int, case: str):
    """Vote batches where some lanes reach the quorum, some fall short, and
    some have no P2B at the winning round (rejections only, or none at
    all): K8 gives value 0 there."""
    lane_rnd = rng.integers(0, 4, b, dtype=np.int32)
    vrnd = (lane_rnd[None] - (rng.random((a, b)) < 0.2)).astype(np.int32)
    vtype = rng.choice([P2B, P2B, P2B, P2B, P2B, 7, 0], (a, b)).astype(np.int32)
    val = rng.integers(I32_MIN, I32_MAX, (a, b, v), dtype=np.int32, endpoint=True)
    if case == "no_p2b":
        vtype[:, : b // 2] = 7  # half the lanes: no vote at all
        vrnd[:, : b // 2] = rng.integers(5, 9, (a, b // 2), dtype=np.int32)
    return vtype, vrnd, val


@pytest.mark.parametrize("a,b,v", [(1, 8, 1), (3, 16, 4), (5, 33, 2), (9, 64, 16)])
@pytest.mark.parametrize("case", ["mixed", "no_p2b"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_learner_quorum_window_matches_reference(a, b, v, case, seed):
    rng = np.random.default_rng(seed)
    vtype, vrnd, val = _votes(rng, a, b, v, case)
    quorum = a // 2 + 1
    args = [_t(x) for x in (vtype, vrnd, val)]
    got = tref.learner_quorum_window(quorum, *args)
    want = jref.learner_quorum_window(quorum, *(jnp.asarray(x) for x in (vtype, vrnd, val)))
    _same(got, want)
    _unchanged(args, (vtype, vrnd, val))
    deliver = got[0].numpy()
    assert 0 < deliver.sum() < b or a == 1, deliver  # partial quorums
    empty = ~((vtype == P2B) & (vrnd == got[1].numpy()[None])).any(axis=0)
    if case == "no_p2b":
        assert empty.any()
        assert not got[2].numpy()[empty].any()
    inst = _t(np.tile(np.arange(b, dtype=np.int32), (a, 1)))
    d, _, win, value = ops.learner_quorum(args[0], inst, args[1], args[2], quorum)
    _same(got, [d.to(torch.int32).numpy(), win.numpy(), value.numpy()])


# (seed, a, n, b, v, next_inst, alive, quorum): ring bases that wrap past N,
# partial liveness and quorums both reached and missed
ROUNDS = [
    (0, 3, 16, 8, 1, 0, (1, 1, 1), 2),
    (1, 3, 16, 8, 4, 12, (1, 0, 1), 2),
    (2, 5, 32, 32, 3, 7, (1, 1, 0, 0, 1), 3),
    (3, 5, 64, 24, 16, 60, (0, 1, 1, 0, 0), 3),
    (4, 1, 8, 8, 2, 2**31 - 5, (1,), 1),
    (5, 3, 16, 16, 2, 40, (0, 0, 0), 2),
]


@pytest.mark.parametrize("seed,a,n,b,v,next_inst,alive,quorum", ROUNDS)
def test_wirepath_round_matches_reference(seed, a, n, b, v, next_inst, alive, quorum):
    rng = np.random.default_rng(seed)
    ring = _ring(rng, (a,), n, v)
    learner = (
        rng.integers(0, 2, n, dtype=np.int32),
        rng.integers(-1, 80, n, dtype=np.int32),
        rng.integers(I32_MIN, I32_MAX, (n, v), dtype=np.int32, endpoint=True),
    )
    values = rng.integers(I32_MIN, I32_MAX, (b, v), dtype=np.int32, endpoint=True)
    crnd = int(rng.integers(0, 9))
    live = np.array(alive, np.bool_)
    scalars = (np.int32(next_inst), np.int32(crnd))
    args = [_t(x) for x in (*scalars, live, *ring, *learner, values)]
    got = tref.wirepath_round(args[0], args[1], quorum, *args[2:])
    want = jref.wirepath_round(
        jnp.int32(next_inst), jnp.int32(crnd), quorum,
        *(jnp.asarray(x) for x in (live, *ring, *learner, values)),
    )  # fmt: skip
    _same(got, want)
    _unchanged(args, (*scalars, live, *ring, *learner, values))
    stack = AcceptorState(*(_t(x) for x in ring))
    lstate = LearnerState(*(_t(x) for x in learner))
    cstate = CoordinatorState(*(_t(x) for x in scalars))
    _, stack, lstate, fresh, _, win, value = ops.fused_round(
        cstate, stack, lstate, _t(values), _t(np.ones(b, np.bool_)), _t(live), quorum
    )
    plain = (*stack.__dict__.values(), *lstate.__dict__.values(), fresh.to(torch.int32), win, value)
    _same(got, [p.numpy() for p in plain])


@pytest.mark.parametrize("n", [0, 1, 7, 128, 1000])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_digest_matches_reference(n, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        x = rng.integers(I32_MIN, I32_MAX, (n, 3), dtype=np.int32, endpoint=True)
    else:
        x = rng.standard_normal((n, 3)).astype(np.float32)
    t = _t(x)
    got = tref.digest(t)
    want = jref.digest(jnp.asarray(x))
    _same([got], [want])
    _unchanged([t], [x])
    _same([got], [ops.digest(_t(x)).numpy()])


def test_digest_refuses_16_bit_arrays():
    """The port takes int32 and float32 leaves; the reference would fold a
    16-bit array's elements in pairs."""
    with pytest.raises(TypeError):
        tref.digest(torch.zeros(8, dtype=torch.bfloat16))


# (seed, b, h, kvh, sq, sk, d, window, causal): causal, windowed,
# non-causal, GQA (h > kvh) and Sq != Sk
ATTENTION = [
    (0, 1, 4, 4, 32, 32, 16, 0, True),
    (1, 2, 4, 2, 48, 48, 32, 8, True),
    (2, 1, 2, 2, 24, 40, 16, 0, False),
    (3, 1, 8, 2, 16, 16, 64, 0, True),
    (4, 2, 6, 3, 40, 24, 16, 5, False),
    (5, 1, 4, 1, 64, 32, 32, 16, True),
]


@pytest.mark.parametrize("seed,b,h,kvh,sq,sk,d,window,causal", ATTENTION)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_reference(seed, b, h, kvh, sq, sk, d, window, causal, dtype):
    rng = np.random.default_rng(seed)
    arrays = [
        rng.standard_normal(s).astype(np.float32)
        for s in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))
    ]
    jd, td, atol = {
        "f32": (jnp.float32, torch.float32, F32_ATOL),
        "bf16": (jnp.bfloat16, torch.bfloat16, BF16_ATOL),
    }[dtype]
    ts = [torch.from_numpy(x).to(td) for x in arrays]
    before = [t.clone() for t in ts]
    scale = None if seed % 2 else 0.3
    kw = dict(window=window, causal=causal, softmax_scale=scale)
    got = tref.flash_attention(*ts, **kw)
    want = jref.flash_attention(*(jnp.asarray(x).astype(jd) for x in arrays), **kw)
    assert got.dtype == td and tuple(got.shape) == (b, h, sq, d)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=atol, rtol=0
    )
    for t, t0 in zip(ts, before, strict=True):
        assert torch.equal(t, t0)
    assert torch.equal(got, k_flash.flash_attention(*ts, **kw))
