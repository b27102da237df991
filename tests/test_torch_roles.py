"""The paper's per-role kernels in the port against the reference's, bit for
bit: one acceptor's Phase-2 vote (``ops.acceptor_phase2``, K7 on the card)
and the learner's quorum (``ops.learner_quorum``, K8 on the card).

On the CPU the port runs the kernels' plain versions; the reference's
``ops`` entries run its Pallas kernels in interpret mode.  K8 follows the
TPU kernel where the reference's declared oracle,
``repro.core.batched.learner_quorum``, differs from it: on a lane where no
acceptor agrees, the value is 0, not acceptor 0's vote value.
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
from repro_torch.kernels import acceptor as tacc  # noqa: E402
from repro_torch.kernels import coordinator as tcoord  # noqa: E402
from repro_torch.kernels import learner as tlearn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import wirepath as twire  # noqa: E402

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
FIELDS = ("msgtype", "inst", "rnd", "vrnd", "swid", "value")
P2B, REJECT = 4, 7


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _msgs(m: dict[str, np.ndarray]):
    """The same batch for the reference and for the port."""
    ref = R.MsgBatch(**{k: jnp.asarray(x) for k, x in m.items()})
    return ref, T.MsgBatch(**{k: _t(x) for k, x in m.items()})


def _batch(rng, inst: np.ndarray, v: int) -> dict[str, np.ndarray]:
    b = inst.shape[0]
    return dict(
        msgtype=rng.choice([0, 1, 3, 3, 3, 4, 7], b).astype(np.int32),
        inst=inst.astype(np.int32),
        rnd=rng.integers(-1, 11, b, dtype=np.int32),
        vrnd=np.full(b, -1, np.int32),
        swid=np.zeros(b, np.int32),
        value=rng.integers(I32_MIN, I32_MAX, (b, v), dtype=np.int32, endpoint=True),
    )


def _registers(rng, n: int, v: int):
    s = dict(
        rnd=rng.integers(0, 9, n, dtype=np.int32),
        vrnd=rng.integers(-1, 9, n, dtype=np.int32),
        val=rng.integers(I32_MIN, I32_MAX, (n, v), dtype=np.int32, endpoint=True),
    )
    ref = R.AcceptorState(*(jnp.asarray(s[k]) for k in ("rnd", "vrnd", "val")))
    got = T.AcceptorState(*(_t(s[k].copy()) for k in ("rnd", "vrnd", "val")))
    return ref, got


def _assert_same(ref_state, got_state, rv, tv):
    for f in ("rnd", "vrnd", "value"):
        np.testing.assert_array_equal(
            getattr(got_state, f).numpy(), np.asarray(getattr(ref_state, f)), f
        )
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tv, f).numpy(), np.asarray(getattr(rv, f)), f)


@pytest.mark.parametrize(
    "n,b,base,aid",
    [
        (256, 8, 0, 0),
        (256, 16, 2 * 256 + 48, 2),
        (512, 128, 384, 1),  # the last block of the ring
        (512, 256, 5 * 512 - 128, 4),  # a 128-block window across the ring end
    ],
)
def test_acceptor_phase2_matches_tpu_kernel(n, b, base, aid):
    """K7's dispatch entry against the reference's K7 (interpret mode) on
    the block-aligned windows it takes, three windows in a row, the register
    file updated in place."""
    v = 8
    rng = np.random.default_rng([n, b, base, aid])
    ref, got = _registers(rng, n, v)
    ptrs = [x.data_ptr() for x in vars(got).values()]
    for r in range(3):
        rm, tm = _msgs(_batch(rng, base + r * b + np.arange(b), v))
        ref, rv = rops.acceptor_phase2(ref, rm, aid)
        got, tv = tops.acceptor_phase2(got, tm, aid)
        _assert_same(ref, got, rv, tv)
    assert [x.data_ptr() for x in vars(got).values()] == ptrs


@pytest.mark.parametrize("b,aid", [(8, 0), (100, 3), (256, 1)])
def test_acceptor_phase2_on_any_window_matches_reference_engine(b, aid):
    """The port's K7 entry takes any batch of distinct slots (misaligned
    bases, scattered slots, negative instances); the reference's jnp engine
    is the yardstick there, since its kernel takes aligned windows only."""
    n, v = 256, 4
    rng = np.random.default_rng([b, aid, 3])
    ref, got = _registers(rng, n, v)
    for r in range(3):
        if r == 0:
            inst = 1001 + np.arange(b)  # misaligned, across the ring end
        else:
            inst = rng.permutation(n)[:b] + rng.integers(-2, 30, b) * n
        rm, tm = _msgs(_batch(rng, inst, v))
        ref, rv = rb.acceptor_phase2(ref, rm, aid)
        got, tv = tops.acceptor_phase2(got, tm, aid)
        _assert_same(ref, got, rv, tv)


def _votes(rng, a: int, b: int, v: int) -> dict[str, np.ndarray]:
    """Foreign vote batches: mixed types and vrnds (some P2B at vrnd below
    NO_ROUND), and every fourth lane all-REJECT with non-zero values, so no
    acceptor agrees there."""
    vtype = rng.choice([P2B, P2B, P2B, REJECT, 2], (a, b)).astype(np.int32)
    vtype[:, ::4] = REJECT
    return dict(
        msgtype=vtype,
        inst=np.broadcast_to(rng.integers(0, 1 << 20, b, dtype=np.int32), (a, b)).copy(),
        vrnd=rng.integers(-3, 4, (a, b), dtype=np.int32),
        value=rng.integers(1, I32_MAX, (a, b, v), dtype=np.int32),
    )


@pytest.mark.parametrize("a,b,quorum", [(1, 8, 1), (3, 8, 2), (3, 128, 2), (5, 256, 3)])
def test_learner_quorum_matches_tpu_kernel(a, b, quorum):
    """K8's dispatch entry against the reference's K8 (interpret mode),
    including the lanes where no acceptor agrees: value 0 there."""
    rng = np.random.default_rng([a, b, quorum])
    m = _votes(rng, a, b, 4)
    keys = ("msgtype", "inst", "vrnd", "value")
    want = rops.learner_quorum(*(jnp.asarray(m[k]) for k in keys), quorum)
    got = tops.learner_quorum(*(_t(m[k]) for k in keys), quorum)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.bool
    no_agree = ~(m["msgtype"] == P2B).any(axis=0)
    assert no_agree[::4].all() and not got[3][no_agree].any()


def test_batched_learner_quorum_keeps_the_reference_engines_choice():
    """On lanes where no acceptor agrees, the reference's jnp engine (K8's
    declared oracle) returns acceptor 0's value and the TPU kernel 0.  The
    port keeps each: its ``batched.learner_quorum`` (the plain fused round's
    quorum) twins the engine, its K8 the kernel."""
    rng = np.random.default_rng(5)
    m = _votes(rng, 3, 64, 4)
    keys = ("msgtype", "inst", "vrnd", "value")
    want = rb.learner_quorum(*(jnp.asarray(m[k]) for k in keys), 2)
    got = tb.learner_quorum(*(_t(m[k]) for k in keys), 2)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    k8 = tops.learner_quorum(*(_t(m[k]) for k in keys), 2)
    no_agree = ~(m["msgtype"] == P2B).any(axis=0)
    np.testing.assert_array_equal(got[3].numpy()[no_agree], m["value"][0][no_agree])
    assert not k8[3][no_agree].any() and m["value"][0][no_agree].all()
    for i in (0, 1, 2):  # deliver, inst, win agree everywhere
        np.testing.assert_array_equal(k8[i].numpy(), got[i].numpy())


@pytest.mark.parametrize("alive", [[1, 1, 1], [1, 0, 1], [0, 0, 1]])
def test_per_role_path_equals_the_staged_vote(alive):
    """Sequencer, A single acceptors and the learner (K3 -> K7 x A -> K8)
    against the same bursts through the acceptor array's vote (K2) and the
    plain engine's quorum: equal registers, votes and decisions.  A dead
    acceptor is one that is not asked."""
    cfg = T.PaxosConfig(n_acceptors=3, n_instances=64, value_words=4, batch=16)
    a, n, v, b = cfg.n_acceptors, cfg.n_instances, cfg.value_words, cfg.batch
    rng = np.random.default_rng(alive)
    single = [T.AcceptorState.init(n, v) for _ in range(a)]
    stack = T.AcceptorState.init(n, v, n_acceptors=a)
    cstate = T.CoordinatorState.init(crnd=2)
    alv = torch.tensor(alive, dtype=torch.bool)
    for _ in range(2 * n // b):  # two ring laps
        vals = _t(rng.integers(I32_MIN, I32_MAX, (b, v), dtype=np.int32, endpoint=True))
        cstate, p2a = tops.coordinator_sequence(cstate, vals, _t(rng.random(b) < 0.8))
        per = {i: tops.acceptor_phase2(single[i], p2a, int(i))[1] for i in np.nonzero(alive)[0]}
        stack, votes = tops.acceptor_phase2_all(stack, p2a, alv)
        for i, mine in per.items():
            for f in FIELDS:
                assert torch.equal(getattr(mine, f), getattr(votes, f)[i]), f
        st = {f: torch.stack([getattr(p, f) for p in per.values()]) for f in FIELDS}
        got = tops.learner_quorum(st["msgtype"], st["inst"], st["vrnd"], st["value"], 2)
        want = tb.learner_quorum(votes.msgtype, votes.inst, votes.vrnd, votes.value, 2)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
        assert bool(got[0].all()) == (sum(alive) >= 2)
    for i in range(a):  # a dead acceptor's registers stay as they were in both
        for f in ("rnd", "vrnd", "value"):
            assert torch.equal(getattr(single[i], f), getattr(stack, f)[i]), f


def test_kernel_wrappers_refuse_cpu_tensors():
    """On CPU tensors only the dispatch's plain versions run: each kernel's
    own wrapper raises instead of computing anything."""
    i32 = dict(dtype=torch.int32)
    z8, z84 = torch.zeros(8, **i32), torch.zeros((8, 4), **i32)
    calls = [
        lambda: tcoord.coordinator_sequence_window(
            torch.zeros((), **i32), torch.zeros((), **i32), torch.ones(8, dtype=torch.bool)
        ),
        lambda: tacc.acceptor_phase2_window(
            torch.zeros(16, **i32), torch.zeros(16, **i32), torch.zeros((16, 4), **i32), 0,
            z8, z8, z8, z84,
        ),
        lambda: tacc.acceptor_phase2_witness(
            torch.zeros(16, **i32), torch.zeros(16, **i32), torch.zeros((16, 4), **i32), 0,
            z8, z8, z8, z84,
        ),
        lambda: twire.acceptor_vote_all_window(
            torch.zeros((3, 16), **i32), torch.zeros((3, 16), **i32),
            torch.zeros((3, 16, 4), **i32), torch.ones(3, dtype=torch.bool), z8, z8, z8, z84,
        ),
        lambda: tlearn.learner_quorum_window(
            2, torch.zeros((3, 8), **i32), torch.zeros((3, 8), **i32), torch.zeros((3, 8, 4), **i32)
        ),
    ]  # fmt: skip
    def counts():
        return (tcoord.launches, tacc.launches, tacc.witness_launches, twire.vote_all_launches,
                tlearn.launches, twire.vector_launches, twire.scalar_launches)  # fmt: skip

    before = counts()
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert counts() == before
