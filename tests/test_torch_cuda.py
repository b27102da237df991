"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA card and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Without a card every test here skips (the ``cuda`` fixture decides, at run
time).  This file imports no ``jax``: the card's machine need not have it.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    FaultSpec,
    HardwareDataplane,
    MultiGroupDataplane,
    PaxosConfig,
    PaxosContext,
    SimNet,
)
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.bridge import export_state  # noqa: E402
from repro_torch.core.types import AcceptorState, CoordinatorState, MsgBatch  # noqa: E402
from repro_torch.kernels import acceptor as k_acceptor  # noqa: E402
from repro_torch.kernels import coordinator as k_coordinator  # noqa: E402
from repro_torch.kernels import digest as k_digest  # noqa: E402
from repro_torch.kernels import learner as k_learner  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wirepath as k_wirepath  # noqa: E402

pytestmark = pytest.mark.gpu

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(rng, a, n, v, base, crnd, dev):
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    linst = rng.integers(-1, 1 << 20, (n,), dtype=np.int32)
    inst = base + np.arange(256)
    linst[inst[::3] % n] = inst[::3]
    return dict(
        cstate=CoordinatorState.init(crnd, base, device=dev),
        stack=AcceptorState(
            t(rng.integers(0, crnd + 3, (a, n), dtype=np.int32)),
            t(rng.integers(-1, crnd + 3, (a, n), dtype=np.int32)),
            t(rng.integers(I32_MIN, I32_MAX, (a, n, v), dtype=np.int32, endpoint=True)),
        ),
        lstate=batched.LearnerState(
            t(rng.integers(0, 2, (n,), dtype=np.int32)),
            t(linst),
            t(rng.integers(I32_MIN, I32_MAX, (n, v), dtype=np.int32, endpoint=True)),
        ),
    )


def _clone(s):
    c, st, ls = s["cstate"], s["stack"], s["lstate"]
    return dict(
        cstate=CoordinatorState(c.next_inst.clone(), c.crnd.clone()),
        stack=AcceptorState(*(x.clone() for x in vars(st).values())),
        lstate=batched.LearnerState(*(x.clone() for x in vars(ls).values())),
    )


def _flat(res):
    c, st, ls, *outs = res
    return [c.next_inst, *vars(st).values(), *vars(ls).values(), *outs]


@pytest.mark.parametrize(
    "a,b,base,limit,alive",
    [
        (3, 128, 4096, None, [1, 1, 1]),
        (3, 128, 3 * 65536 - 50, None, [1, 1, 1]),  # crosses the ring end
        (3, 8, 1001, None, [0, 1, 1]),  # misaligned, a dead acceptor
        (3, 128, 999, 999 + 77, [1, 1, 1]),  # reclaim limit inside the window
        (5, 128, 65536 - 9, None, [1, 1, 0, 0, 1]),
    ],
)
def test_round_kernel_matches_plain_at_full_width(cuda, a, b, base, limit, alive):
    rng = np.random.default_rng([a, b, base])
    n, v = 65536, 16
    s = _state(rng, a, n, v, base, 5, cuda)
    twin = _clone(s)
    ptrs = [x.data_ptr() for x in (*vars(s["stack"]).values(), *vars(s["lstate"]).values())]
    alv = torch.tensor(alive, dtype=torch.bool, device=cuda)
    before = k_wirepath.launches
    for r in range(3):
        vals = torch.from_numpy(
            rng.integers(I32_MIN, I32_MAX, (b, v), dtype=np.int32, endpoint=True)
        ).to(cuda)
        act = torch.ones(b, dtype=torch.bool, device=cuda)
        lim = None if limit is None else limit + r * b
        got = ops.fused_round(**s, values=vals, active=act, alive=alv, quorum=a // 2 + 1, reclaim_limit=lim)  # fmt: skip
        want = batched.fused_round(**twin, values=vals, active=act, alive=alv, quorum=a // 2 + 1, reclaim_limit=lim)  # fmt: skip
        for g, w in zip(_flat(got), _flat(want), strict=True):
            assert torch.equal(g.to(w.dtype), w)
        s["cstate"], twin["cstate"] = got[0], want[0]
    assert k_wirepath.launches == before + 3
    assert [x.data_ptr() for x in (*vars(s["stack"]).values(), *vars(s["lstate"]).values())] == ptrs


@pytest.mark.parametrize("n", [524_287, 524_288 + 3, 1, 0])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_digest_kernel_matches_plain(cuda, n, dtype):
    rng = np.random.default_rng(n)
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(I32_MIN, I32_MAX, n, dtype=np.int32, endpoint=True))
    else:
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    x = x.to(cuda)
    before = k_digest.launches
    assert int(ops.digest(x)) == int(k_digest.digest_plain(x)) == int(k_digest.digest_plain(x.cpu()))
    assert k_digest.launches == before + 1


def _digest_leaf(rng, n, dtype, off, dev):
    """A leaf of ``n`` words on the card, int32 or float32, whose data start
    ``off`` bytes past a 16-byte boundary."""
    if dtype == torch.int32:
        host = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int32, endpoint=True)
    else:
        host = rng.standard_normal(n).astype(np.float32)
    buf = torch.empty(n + 4, dtype=dtype, device=dev)
    start = ((off - buf.data_ptr()) % 16) // 4
    x = buf[start : start + n]
    x.copy_(torch.from_numpy(host))
    assert x.is_contiguous() and (n == 0 or x.data_ptr() % 16 == off)  # an empty view has none
    return x


I32, F32 = torch.int32, torch.float32
# (words, dtype, bytes past 16) of each leaf: the seal's two leaves, odd
# lengths, empty leaves mixed with full ones, float32 leaves, views 4, 8
# and 12 bytes off 16, and eight leaves
TREE_CASES = [
    [(16_384, I32, 0), (16_384 * 16, I32, 0)],
    [(16_384, I32, 4), (16_384 * 16, I32, 4)],
    [(524_287, F32, 4)],
    [(524_288 + 3, I32, 12)],
    [(0, I32, 0), (1_000_001, I32, 4), (0, F32, 0), (7, I32, 12)],
    [(1, I32, 8)],
    [(0, I32, 0)],
    [(0, I32, 0), (0, F32, 4)],
    [(5, F32, 4), (6, I32, 8), (3, I32, 12)],
    [(70_001, F32, 4), (1, I32, 12), (4096 * 256 + 3, I32, 8), (9, F32, 0), (33, I32, 4),
     (1 << 20, I32, 0), (12, F32, 8), (255, I32, 12)],
]  # fmt: skip


@pytest.mark.parametrize("case", TREE_CASES)
def test_tree_digest_kernel_matches_plain(cuda, case):
    """One launch a seal, each leaf's digest equal to the plain fold's."""
    rng = np.random.default_rng(len(case) * 1000 + sum(n for n, _, _ in case) % 997)
    leaves = [_digest_leaf(rng, n, dtype, off, cuda) for n, dtype, off in case]
    before = k_digest.launches
    got = k_digest.tree_digest(leaves)
    assert k_digest.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (len(case),) and got.device == leaves[0].device
    want = k_digest.tree_digest_plain(leaves)
    on_cpu = k_digest.tree_digest_plain([x.cpu() for x in leaves])
    assert got.tolist() == want.tolist() == on_cpu.tolist()
    assert ops.tree_digest(leaves) == k_digest.combine(want.tolist())
    assert k_digest.launches == before + 2


@pytest.mark.parametrize("count", range(1, 9))
def test_tree_digest_kernel_folds_one_to_eight_leaves(cuda, count):
    rng = np.random.default_rng(count)
    leaves = [
        _digest_leaf(rng, int(rng.integers(0, 300_000)), (I32, F32)[i % 2], 4 * (i % 4), cuda)
        for i in range(count)
    ]
    before = k_digest.launches
    assert k_digest.tree_digest(leaves).tolist() == k_digest.tree_digest_plain(leaves).tolist()
    assert k_digest.launches == before + 1


def test_tree_digest_kernel_refuses_nine_leaves(cuda):
    leaves = [torch.zeros(4, dtype=I32, device=cuda)] * 9
    before = k_digest.launches
    with pytest.raises(ValueError, match="1 to 8 leaves"):
        k_digest.tree_digest(leaves)
    with pytest.raises(ValueError, match="1 to 8 leaves"):
        ops.tree_digest(leaves)
    assert k_digest.launches == before


def test_tree_digest_kernel_replays_in_a_cuda_graph(cuda):
    """Two launches in one CUDA graph, replayed twice on new data: each
    launch leaves its stream's ticket at 0 for the next."""
    rng = np.random.default_rng(23)
    leaves = [_digest_leaf(rng, 16_384, I32, 0, cuda), _digest_leaf(rng, 16_384 * 16, I32, 0, cuda)]
    k_digest.tree_digest(leaves)  # the device's tickets are zeroed outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        first = k_digest.tree_digest(leaves)
        second = k_digest.tree_digest(leaves[::-1])
    for _ in range(2):
        for x in leaves:
            x.copy_(torch.from_numpy(rng.integers(I32_MIN, I32_MAX, x.numel(), dtype=np.int32)))
        g.replay()
        torch.cuda.synchronize()
        want = k_digest.tree_digest_plain(leaves).tolist()
        assert first.tolist() == want and second.tolist() == want[::-1]
    assert k_digest.tree_digest(leaves).tolist() == want


def test_tree_digest_kernel_graphs_replay_at_once_on_two_streams(cuda):
    """Two seals captured in two CUDA graphs on ``torch.cuda.graph``'s one
    capture stream, replayed at once on two streams, beside an eager seal
    on a third: no two of the launches share a ticket word."""
    rng = np.random.default_rng(29)
    seals = [
        [_digest_leaf(rng, 16_384, I32, 0, cuda), _digest_leaf(rng, 16_384 * 16, I32, 4, cuda)]
        for _ in range(3)
    ]
    k_digest.tree_digest(seals[2])  # the device's tickets are zeroed outside the capture
    torch.cuda.synchronize()
    graphs, outs = [], []
    for leaves in seals[:2]:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            outs.append([k_digest.tree_digest(leaves) for _ in range(4)])
        graphs.append(g)
    want = [k_digest.tree_digest_plain(leaves).tolist() for leaves in seals]
    streams = [torch.cuda.Stream() for _ in range(3)]
    for _ in range(20):
        for g, s in zip(graphs, streams, strict=False):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                g.replay()
        with torch.cuda.stream(streams[2]):
            eager = [k_digest.tree_digest(seals[2]) for _ in range(4)]
        torch.cuda.synchronize()
        for got, w in zip(outs, want, strict=False):
            assert [d.tolist() for d in got] == [w] * 4
        assert [d.tolist() for d in eager] == [want[2]] * 4


FIELDS = ("msgtype", "inst", "rnd", "vrnd", "swid", "value")


@pytest.mark.parametrize("next_inst,b", [(0, 8), (1001, 128), (I32_MAX - 60, 128), (77, 300)])
def test_sequencer_kernel_matches_plain(cuda, next_inst, b):
    rng = np.random.default_rng([next_inst % 997, b])
    vals = torch.from_numpy(rng.integers(0, 9, (b, 16), dtype=np.int32)).to(cuda)
    active = torch.from_numpy(rng.random(b) < 0.6).to(cuda)
    cstate = CoordinatorState.init(crnd=4, next_inst=next_inst, device=cuda)
    before = k_coordinator.launches
    gc, gp = ops.coordinator_sequence(cstate, vals, active)
    wc, wp = batched.coordinator_sequence(cstate, vals, active)
    assert k_coordinator.launches == before + 1
    for f in FIELDS:
        assert torch.equal(getattr(gp, f), getattr(wp, f)), f
    assert int(gc.next_inst) == int(wc.next_inst) and int(gc.crnd) == 4


@pytest.mark.parametrize("next_inst", [0, I32_MAX, I32_MAX - 2, I32_MAX - 64, -5])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("b", [1, 3, 8, 128, 129, 4096])
def test_sequencer_kernel_matches_plain_at_any_burst(cuda, b, off, next_inst):
    """K3 at any B, on ``active`` views 0 to 3 bytes past 4; the instances
    wrap through int32 max."""
    rng = np.random.default_rng([b, off, next_inst % 1013])
    buf = torch.empty(b + 8, dtype=torch.bool, device=cuda)
    start = (off - buf.data_ptr()) % 4
    active = buf[start : start + b]
    active.copy_(torch.from_numpy(rng.random(b) < 0.6))
    assert active.data_ptr() % 4 == off
    vals = torch.from_numpy(rng.integers(0, 9, (b, 16), dtype=np.int32)).to(cuda)
    cstate = CoordinatorState.init(crnd=7, next_inst=next_inst, device=cuda)
    before = k_coordinator.launches
    gc, gp = ops.coordinator_sequence(cstate, vals, active)
    assert k_coordinator.launches == before + 1
    wc, wp = batched.coordinator_sequence(cstate, vals, active)
    for f in FIELDS:
        assert torch.equal(getattr(gp, f), getattr(wp, f)), f
    assert int(gc.next_inst) == int(wc.next_inst) and int(gc.crnd) == 7


def _phase2(rng, inst, v, dev):
    b = inst.shape[0]
    return MsgBatch(
        msgtype=torch.from_numpy(rng.choice([0, 1, 3, 3, 3, 7], b).astype(np.int32)).to(dev),
        inst=torch.from_numpy(inst.astype(np.int32)).to(dev),
        rnd=torch.from_numpy(rng.integers(-1, 8, b, dtype=np.int32)).to(dev),
        vrnd=torch.full((b,), -1, dtype=torch.int32, device=dev),
        swid=torch.zeros(b, dtype=torch.int32, device=dev),
        value=torch.from_numpy(
            rng.integers(I32_MIN, I32_MAX, (b, v), dtype=np.int32, endpoint=True)
        ).to(dev),
    )


def _windows(rng, n, b):
    """An aligned, a misaligned and a ring-end window, then scattered slots."""
    yield 4096 + np.arange(b)
    yield 1003 + np.arange(b)
    yield 3 * n - b // 2 + np.arange(b)
    yield rng.permutation(n)[:b] + rng.integers(0, 50, b) * n


@pytest.mark.parametrize(
    "a,b,alive", [(3, 8, [1, 1, 1]), (3, 128, [1, 0, 1]), (5, 128, [0, 1, 1, 0, 1])]
)
def test_vote_kernels_match_plain(cuda, a, b, alive):
    """K2 on the stacked rings and K7 on each acceptor's own file against the
    plain engine, in place, over windows of every shape the dataplane votes."""
    n, v = 65536, 16
    rng = np.random.default_rng([a, b])
    s = _state(rng, a, n, v, 0, 5, cuda)["stack"]
    twin = AcceptorState(*(x.clone() for x in vars(s).values()))
    files = [AcceptorState(*(x[i].clone() for x in vars(s).values())) for i in range(a)]
    ptrs = [x.data_ptr() for x in vars(s).values()]
    alv = torch.tensor(alive, dtype=torch.bool, device=cuda)
    k2, k7 = k_wirepath.vote_all_launches, k_acceptor.launches
    for inst in _windows(rng, n, b):
        msgs = _phase2(rng, inst, v, cuda)
        _, got = ops.acceptor_phase2_all(s, msgs, alv)
        _, want = batched.acceptor_phase2_all(twin, msgs, alv)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        for i in np.nonzero(alive)[0]:
            _, mine = ops.acceptor_phase2(files[i], msgs, int(i))
            for f in FIELDS:
                assert torch.equal(getattr(mine, f), getattr(want, f)[i]), f
    for x, y in zip(vars(s).values(), vars(twin).values(), strict=True):
        assert torch.equal(x, y)
    for i in np.nonzero(alive)[0]:
        for f in ("rnd", "vrnd", "value"):
            assert torch.equal(getattr(files[i], f), getattr(s, f)[i]), f
    assert [x.data_ptr() for x in vars(s).values()] == ptrs
    assert k_wirepath.vote_all_launches == k2 + 4
    assert k_acceptor.launches == k7 + 4 * sum(alive)


@pytest.mark.parametrize("a,b", [(3, 8), (3, 128), (5, 128)])
def test_quorum_kernel_matches_plain(cuda, a, b):
    """K8 against its plain version, with lanes where no acceptor agrees and
    whose REJECT votes carry non-zero values: value 0 there."""
    rng = np.random.default_rng([a, b, 8])
    vtype = rng.choice([4, 4, 4, 7], (a, b)).astype(np.int32)
    vtype[:, ::4] = 7
    args = [
        torch.from_numpy(x).to(cuda)
        for x in (
            vtype,
            rng.integers(-3, 5, (a, b), dtype=np.int32),
            rng.integers(1, I32_MAX, (a, b, 16), dtype=np.int32),
        )
    ]
    before = k_learner.launches
    got = k_learner.learner_quorum_window(a // 2 + 1, *args)
    want = k_learner.learner_quorum_plain(a // 2 + 1, *args)
    assert k_learner.launches == before + 1
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert not got[2][::4].any()


def test_staged_context_on_the_card_matches_the_cpu(cuda):
    """The staged path (the default ``fused=False``) through K3 and K2 on the
    card and through their plain versions on the CPU: lossy net, a kill, a
    failover with a gap, ``recover()`` and ring wrap; equal logs, learners'
    tables and state.  K3 runs once per ``sequence()``, K2 once per
    ``vote()``."""

    def run(dev):
        ctx = PaxosContext(
            PaxosConfig(n_instances=1024, batch=32),
            net=SimNet(FaultSpec(drop=0.05, dup=0.05, reorder=0.05), seed=9),
            n_learners=2,
            device=dev,
        )
        calls = {"sequence": 0, "vote": 0}
        for name in calls:
            fn = getattr(ctx.hw, name)

            def counted(*args, _fn=fn, _name=name):
                calls[_name] += 1
                return _fn(*args)

            setattr(ctx.hw, name, counted)
        k3, k2 = k_coordinator.launches, k_wirepath.vote_all_launches
        for lap in range(4):
            if lap == 1:
                ctx.hw.kill_acceptor(2)
            if lap == 2:
                ctx.fail_coordinator(est_next_inst=ctx.hw._next_inst_host + 32)
            for i in range(400):
                ctx.submit(f"{lap}-{i}".encode())
            ctx.run_until_quiescent()
            if lap == 2:
                ctx.restore_hardware_coordinator()
                ctx.hw.revive_acceptor(2)
                ctx.recover(ctx.hw._next_inst_host - 1)
        launched = (k_coordinator.launches - k3, k_wirepath.vote_all_launches - k2)
        return ctx, calls, launched

    on_card, calls, launched = run(cuda)
    on_cpu, _, cpu_launched = run("cpu")
    assert launched == (calls["sequence"], calls["vote"]) and cpu_launched == (0, 0)
    assert on_card.delivered_log == on_cpu.delivered_log
    assert len(on_card.delivered_log) == 1600
    assert on_card.learned == on_cpu.learned
    want, have = export_state(on_cpu.hw), export_state(on_card.hw)
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)


def test_context_on_the_card_matches_the_cpu(cuda):
    """The same lossy schedule through the kernels on the card and through
    the plain versions on the CPU: equal logs, seals and state."""

    def run(dev):
        ctx = PaxosContext(
            PaxosConfig(n_instances=1024, batch=32),
            net=SimNet(FaultSpec(drop=0.05, dup=0.05, reorder=0.05), seed=4),
            fused=True,
            snapshots=True,
            device=dev,
        )
        seals = []
        for lap in range(6):
            if lap == 2:
                ctx.crash_acceptor(0)
            for i in range(300):
                ctx.submit(f"{lap}-{i}".encode())
            ctx.run_until_quiescent()
            seals.append(ctx.snapshot_group().seal)
            if lap == 2:
                ctx.restore_acceptor(0)
        return ctx, seals

    on_card, card_seals = run(cuda)
    on_cpu, cpu_seals = run("cpu")
    assert card_seals == cpu_seals
    assert on_card.full_group_log() == on_cpu.full_group_log()
    assert len(on_card.full_group_log()) == 1800
    want, have = export_state(on_cpu.hw), export_state(on_card.hw)
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)


def _slabs(rng, g, a, n, v, top, dev):
    def t(*shape, lo=I32_MIN, hi=I32_MAX):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int32, endpoint=True)).to(dev)

    stack = AcceptorState(t(g, a, n, lo=0, hi=top), t(g, a, n, lo=-1, hi=top), t(g, a, n, v))
    lstate = batched.LearnerState(t(g, n, lo=0, hi=1), t(g, n, lo=-1, hi=1 << 20), t(g, n, v))
    return stack, lstate


@pytest.mark.parametrize(
    "gb,gsel,bases,enabled",
    [
        (1, [5], [0] * 8, [1] * 8),
        (1, [0, 3, 6], [9, 4096, 2**31 - 64, 3 * 4096 - 60, 5, 6, 7, 8], [1, 1, 1, 0, 1, 1, 1, 1]),
        (2, [1, 2], [0, 0, 2**31 - 64, 999, 640, 640, 0, 0], [1, 1, 1, 0, 1, 1, 1, 1]),
        (8, [0], [4096] * 8, [1, 1, 0, 1, 1, 1, 0, 1]),
    ],
)
def test_cohort_round_kernel_matches_plain(cuda, gb, gsel, bases, enabled):
    """K1 in cohort form against ``batched.cohort_fused_round``: one block,
    a subset and all; inert members; a window across 2**31 and one across
    the ring end; dead acceptors; a wrapped reclaim limit; state in place;
    one launch counted in ``cohort_launches``."""
    g, a, n, v, b = 8, 3, 4096, 16, 128
    rng = np.random.default_rng([gb, len(gsel)])
    stack, lstate = _slabs(rng, g, a, n, v, 8, cuda)
    twin = (AcceptorState(*(x.clone() for x in vars(stack).values())),
            batched.LearnerState(*(x.clone() for x in vars(lstate).values())))  # fmt: skip
    ptrs = [x.data_ptr() for x in (*vars(stack).values(), *vars(lstate).values())]
    i32 = dict(dtype=torch.int32, device=cuda)
    ni = torch.tensor(bases, **i32)
    crnd = torch.from_numpy(rng.integers(1, 6, g, dtype=np.int32)).to(cuda)
    alive = torch.ones((g, a), dtype=torch.bool, device=cuda)
    alive[2, 0] = alive[4, 1] = alive[4, 2] = False
    limit = np.asarray([0] * 7 + [2**31 - 100], np.int32) + n  # group 7's wraps
    values = torch.from_numpy(
        rng.integers(I32_MIN, I32_MAX, (len(gsel) * gb, b, v), dtype=np.int32, endpoint=True)
    ).to(cuda)
    en = torch.tensor(enabled, **i32)
    before = k_wirepath.cohort_launches
    got = ops.cohort_fused_round(stack, lstate, gsel, ni, crnd, alive, 2, values, en, limit,
                                 group_block=gb)  # fmt: skip
    want = batched.cohort_fused_round(*twin, gsel, ni, crnd, alive, 2, values, en, limit,
                                      group_block=gb)  # fmt: skip
    assert k_wirepath.cohort_launches == before + 1
    mine = (*vars(got[0]).values(), *vars(got[1]).values(), *got[2:])
    plain = (*vars(want[0]).values(), *vars(want[1]).values(), *want[2:])
    for x, y in zip(mine, plain, strict=True):
        assert torch.equal(x, y)
    assert [x.data_ptr() for x in (*vars(stack).values(), *vars(lstate).values())] == ptrs
    with pytest.raises(ValueError, match="distinct"):
        ops.cohort_fused_round(stack, lstate, gsel * 2, ni, crnd, alive, 2,
                               torch.cat([values, values]), en, group_block=gb)  # fmt: skip


def test_round_kernel_refuses_a_limit_outside_int32(cuda):
    """A limit past int32 max is refused before the launch, not wrapped by
    ctypes; the dataplane raises the reference's OverflowError there too
    and leaves state, mirrors and dispatch_count as they were."""
    a, n, v, b = 3, 256, 16, 16
    s = _state(np.random.default_rng(0), a, n, v, 0, 5, cuda)
    alive = torch.ones(a, dtype=torch.bool, device=cuda)
    args = (s["cstate"].next_inst, s["cstate"].crnd, 2, alive,
            *vars(s["stack"]).values(), *vars(s["lstate"]).values(),
            torch.zeros((b, v), dtype=torch.int32, device=cuda))  # fmt: skip
    before = k_wirepath.launches
    with pytest.raises(OverflowError):
        k_wirepath.wirepath_round(*args, 2**31)
    assert k_wirepath.launches == before
    hw = HardwareDataplane(PaxosConfig(n_instances=n, batch=b), device=cuda)
    wm = 2**31 - 200
    hw.cstate = CoordinatorState.init(next_inst=wm, device=cuda)
    hw._next_inst_host = wm
    hw.enable_reclamation()
    hw.set_reclaimed(wm)
    state, count = export_state(hw), hw.dispatch_count
    with pytest.raises(OverflowError):
        hw.pipeline(np.zeros((b, v), np.int32), np.ones(b, bool))
    for key, arr in export_state(hw).items():
        np.testing.assert_array_equal(arr, state[key], err_msg=key)
    assert hw.dispatch_count == count and k_wirepath.launches == before


def test_group_view_votes_through_k2_in_place(cuda):
    """A group's staged vote runs K2 on its contiguous row views of the
    ``(G, A, N)`` slabs: one launch, the slabs' storage unchanged, only that
    group's rows written, equal to the plain engine on the CPU."""
    cfg = PaxosConfig(n_instances=1024, batch=32, n_groups=4, persistent_rounds=1)
    hws = [MultiGroupDataplane(cfg, device=dev) for dev in (cuda, "cpu")]
    ptrs = [x.data_ptr() for x in vars(hws[0].stack).values()]
    votes = []
    for hw in hws:
        dev = hw.device
        p2a = MsgBatch.nop(32, 16, dev).replace(
            msgtype=torch.full((32,), 3, dtype=torch.int32, device=dev),
            inst=torch.arange(500, 532, dtype=torch.int32, device=dev),
            rnd=torch.full((32,), 3, dtype=torch.int32, device=dev),
        )
        before = k_wirepath.vote_all_launches
        votes.append(hw.group_view(2).vote(p2a))
        assert k_wirepath.vote_all_launches == before + (dev.type == "cuda")
    assert [x.data_ptr() for x in vars(hws[0].stack).values()] == ptrs
    for x, y in zip(vars(hws[0].stack).values(), vars(hws[1].stack).values(), strict=True):
        assert torch.equal(x.cpu(), y)
    assert int((hws[0].stack.vrnd[2] == 3).sum()) == 3 * 32
    assert int((hws[0].stack.vrnd[[0, 1, 3]] != -1).sum()) == 0
    for mine, plain in zip(*votes, strict=True):
        assert mine.gid == plain.gid == 2
        for x, y in zip(mine.tensors(), plain.tensors(), strict=True):
            assert torch.equal(x.cpu(), y)


def test_grouped_context_on_the_card_matches_the_cpu(cuda):
    """The multi-group service through K1's cohort form on the card and the
    plain versions on the CPU: lossy net, skew, a failover, a crash and
    restore, snapshots, retire and create; equal logs, seals, state and
    plan; one cohort launch per fused dispatch."""

    def run(dev):
        cfg = PaxosConfig(n_instances=1024, batch=32, n_groups=4, persistent_rounds=1)
        ctx = PaxosContext(
            cfg, net=SimNet(FaultSpec(drop=0.05, dup=0.05, reorder=0.05), seed=6),
            snapshots=True, device=dev,
        )  # fmt: skip
        dispatches = [0]
        cohort = ctx.hw.pipeline_cohort

        def counted(*args, **kw):
            dispatches[0] += 1
            return cohort(*args, **kw)

        ctx.hw.pipeline_cohort = counted
        before = k_wirepath.cohort_launches
        seals = []
        for lap in range(6):
            if lap == 2:
                ctx.fail_coordinator(group=1)
                ctx.crash_acceptor(0, group=3)
            if lap == 3:
                ctx.restore_hardware_coordinator(group=1)
                ctx.restore_acceptor(0, group=3)
            if lap == 4:
                ctx.retire_group(2)
                ctx.create_group()
            for gid in range(4):
                for i in range(150 if gid == 0 else 20 * lap):
                    ctx.submit(f"{lap}-{gid}-{i}".encode(), group=gid)
            ctx.run_until_quiescent()
            seals += [ctx.snapshot_group(gid).seal for gid in range(4)]
        return ctx, seals, dispatches[0], k_wirepath.cohort_launches - before

    on_card, card_seals, card_dispatches, card_launches = run(cuda)
    on_cpu, cpu_seals, _, cpu_launches = run("cpu")
    assert card_launches == card_dispatches > 0 and cpu_launches == 0
    assert card_seals == cpu_seals
    for gid in range(4):
        assert on_card.full_group_log(gid) == on_cpu.full_group_log(gid)
    assert on_card.planner.report() == on_cpu.planner.report()
    assert on_card.hw.dispatch_count == on_cpu.hw.dispatch_count
    want, have = export_state(on_cpu.hw), export_state(on_card.hw)
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)


def _walk(bases, wen, b):
    """Window bases of a wave descriptor, ``wni[k+1] = wni[k] + B*wen[k]``,
    in int32."""
    wni = np.zeros(wen.shape, np.int64)
    wni[0] = bases
    for r in range(1, wen.shape[0]):
        wni[r] = wni[r - 1] + b * wen[r - 1]
    return ((wni + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.parametrize(
    "gb,gsel,bases,k,b",
    [
        (1, [5], [0] * 8, 8, 128),
        (1, [0, 3, 6], [9, 4096, 2**31 - 300, 3 * 4096 - 60, 5, 6, 7, 8], 4, 128),
        (2, [1, 2], [0, 0, 2**31 - 40, 999, 640, 640, 0, 0], 8, 16),
        (8, [0], [4096 - 256] * 8, 32, 128),  # K * B = N
    ],
)
def test_persistent_kernel_matches_plain(cuda, gb, gsel, bases, k, b):
    """K5 against ``batched.persistent_cohort_rounds``: one block, a subset
    and all; a freeze from round 2 on and an inert member per folded block;
    windows across 2**31 and across the ring end; dead acceptors; a limit
    inside the wave and a wrapped one; the state in place; the same result
    at two ``block_b`` values; one launch counted in ``persistent_launches``."""
    g, a, n, v = 8, 3, 4096, 16
    rng = np.random.default_rng([gb, k])
    rows = [blk * gb + j for blk in gsel for j in range(gb)]
    wen = np.zeros((k, g), np.int32)
    wen[:, rows] = 1
    wen[2:, rows[0]] = 0  # frozen from round 2
    if gb > 1:
        wen[:, rows[1]] = 0  # an inert member of a folded block
    wni = _walk(bases, wen, b)
    i32 = dict(dtype=torch.int32, device=cuda)
    crnd = torch.from_numpy(rng.integers(1, 6, g, dtype=np.int32)).to(cuda)
    alive = torch.ones((g, a), dtype=torch.bool, device=cuda)
    alive[2, 0] = alive[4, 1] = alive[4, 2] = False
    limit = np.asarray([0] * 7 + [2**31 - 100], np.int32) + n  # group 7's wraps
    limit[rows[-1]] = np.int32(bases[rows[-1]] + b + 7)
    values = torch.from_numpy(
        rng.integers(I32_MIN, I32_MAX, (k, len(rows), b, v), dtype=np.int32, endpoint=True)
    ).to(cuda)
    stack, lstate = _slabs(rng, g, a, n, v, 8, cuda)
    twin = (AcceptorState(*(x.clone() for x in vars(stack).values())),
            batched.LearnerState(*(x.clone() for x in vars(lstate).values())))  # fmt: skip
    want = batched.persistent_cohort_rounds(*twin, gsel, wni, wen, crnd, alive, 2, values, limit,
                                            group_block=gb)  # fmt: skip
    plain = (*vars(want[0]).values(), *vars(want[1]).values(), *want[2:])
    for block_b in (128, 32):
        mine_state = (AcceptorState(*(x.clone() for x in vars(stack).values())),
                      batched.LearnerState(*(x.clone() for x in vars(lstate).values())))  # fmt: skip
        ptrs = [x.data_ptr() for part in mine_state for x in vars(part).values()]
        before = k_wirepath.persistent_launches
        got = ops.persistent_cohort_rounds(*mine_state, gsel, wni, wen, crnd, alive, 2, values,
                                           limit, group_block=gb, block_b=block_b)  # fmt: skip
        torch.cuda.synchronize()
        assert k_wirepath.persistent_launches == before + 1
        mine = (*vars(got[0]).values(), *vars(got[1]).values(), *got[2:])
        for x, y in zip(mine, plain, strict=True):
            assert torch.equal(x, y)
        assert [x.data_ptr() for x in (*vars(got[0]).values(), *vars(got[1]).values())] == ptrs
    assert not got[2][2:, 0].any() and bool((got[3][2:, 0] == -1).all())


def test_persistent_kernel_equals_k_cohort_launches(cuda):
    """One K5 wave against K sequential K1-cohort launches over the same
    descriptor (the freeze applied between launches as an enabled mask and
    a watermark that stops walking), as the reference's chaos parity test."""
    g, a, n, v, b, k = 8, 3, 4096, 16, 128, 8
    rng = np.random.default_rng(11)
    gsel = [0, 1]
    wen = np.zeros((k, g), np.int32)
    wen[:, :8] = 1
    wen[3:, 5] = 0
    wni = _walk([2**31 - 512] * 4 + [64] * 4, wen, b)
    crnd = torch.from_numpy(rng.integers(1, 6, g, dtype=np.int32)).to(cuda)
    alive = torch.ones((g, a), dtype=torch.bool, device=cuda)
    alive[6, 0] = False
    values = torch.from_numpy(
        rng.integers(I32_MIN, I32_MAX, (k, g, b, v), dtype=np.int32, endpoint=True)
    ).to(cuda)
    stack, lstate = _slabs(rng, g, a, n, v, 8, cuda)
    seq = (AcceptorState(*(x.clone() for x in vars(stack).values())),
           batched.LearnerState(*(x.clone() for x in vars(lstate).values())))  # fmt: skip
    got = ops.persistent_cohort_rounds(stack, lstate, gsel, wni, wen, crnd, alive, 2, values,
                                       group_block=4)  # fmt: skip
    outs = []
    for r in range(k):
        ni = torch.from_numpy(wni[r]).to(cuda)
        *_, fresh, win, value = ops.cohort_fused_round(
            *seq, gsel, ni, crnd, alive, 2, values[r], wen[r], group_block=4
        )
        outs.append((fresh, win, value))
    for x, y in zip(got[2:], (torch.stack(o) for o in zip(*outs, strict=True)), strict=True):
        assert torch.equal(x, y)
    for x, y in zip((*vars(stack).values(), *vars(lstate).values()),
                    (*vars(seq[0]).values(), *vars(seq[1]).values()), strict=True):  # fmt: skip
        assert torch.equal(x, y)


def test_persistent_kernel_refuses_before_launch(cuda):
    """The wrapper's host-side checks: K * B > N, a repeated block, and a
    descriptor whose bases do not walk by B over enabled rounds each raise
    before any launch."""
    g, a, n, v, b = 4, 3, 256, 16, 16
    stack, lstate = _slabs(np.random.default_rng(0), g, a, n, v, 8, cuda)
    crnd = torch.ones(g, dtype=torch.int32, device=cuda)
    alive = torch.ones((g, a), dtype=torch.bool, device=cuda)
    state = (*vars(stack).values(), *vars(lstate).values())
    before = k_wirepath.persistent_launches

    def wave(gsel, k, wni=None, wen=None):
        wen = np.ones((k, g), np.int32) if wen is None else wen
        wni = _walk([0] * g, wen, b) if wni is None else wni
        vals = torch.zeros((k, len(gsel), b, v), dtype=torch.int32, device=cuda)
        return k_wirepath.persistent_wirepath_round(gsel, wni, wen, crnd, 2, alive, *state, vals)

    with pytest.raises(ValueError, match="K \\* B <= N"):
        wave([0], n // b + 1)
    with pytest.raises(ValueError, match="distinct"):
        wave([1, 1], 2)
    bad = _walk([0] * g, np.ones((3, g), np.int32), b)
    bad[2, 2] += b
    with pytest.raises(ValueError, match="walk"):
        wave([2], 3, wni=bad)
    assert k_wirepath.persistent_launches == before
    wave([0, 1, 3], 3, wni=bad)  # group 2 is not selected: its row is not read
    assert k_wirepath.persistent_launches == before + 1


@pytest.mark.parametrize("async_pump", [True, False])
def test_default_grouped_context_on_the_card_matches_the_cpu(cuda, async_pump):
    """The multi-group service at the reference's defaults
    (``persistent_rounds=8``) on the card and on the CPU: lossy net, waves
    of several depths, a failover, snapshots, retire and create; equal logs,
    deliveries, seals, state and plan; one K5 launch per wave and one
    K1-cohort launch per single-round dispatch."""

    def run(dev):
        cfg = PaxosConfig(n_instances=1024, batch=32, n_groups=4, async_pump=async_pump)
        order = []
        ctx = PaxosContext(
            cfg, net=SimNet(FaultSpec(drop=0.05, dup=0.05, reorder=0.05), seed=7),
            snapshots=True, device=dev, deliver=lambda p, s, i: order.append((p, i)),
        )  # fmt: skip
        depths = []
        for kind in ("pipeline_cohort", "pipeline_persistent"):
            dispatch = getattr(ctx.hw, kind)

            def counted(gids, values, *args, _d=dispatch, _kind=kind, **kw):
                depths.append(values.shape[0] if _kind == "pipeline_persistent" else 1)
                return _d(gids, values, *args, **kw)

            setattr(ctx.hw, kind, counted)
        before = (k_wirepath.cohort_launches, k_wirepath.persistent_launches)
        seals = []
        rng = np.random.default_rng(3)
        for lap in range(6):
            if lap == 2:
                ctx.fail_coordinator(group=1)
            if lap == 3:
                ctx.restore_hardware_coordinator(group=1)
            if lap == 4:
                ctx.retire_group(2)
                ctx.create_group()
            for gid in range(4):  # every group deep on laps 0 and 5: waves of K=8
                load = 300 if gid == 0 or lap % 5 == 0 else int(rng.integers(0, 9 * 32))
                for i in range(load):
                    ctx.submit(f"{lap}-{gid}-{i}".encode(), group=gid)
            ctx.run_until_quiescent()
            seals += [ctx.snapshot_group(gid).seal for gid in range(4)]
        launches = (k_wirepath.cohort_launches - before[0],
                    k_wirepath.persistent_launches - before[1])  # fmt: skip
        return ctx, seals, order, depths, launches

    on_card, card_seals, card_order, depths, (cohorts, waves) = run(cuda)
    on_cpu, cpu_seals, cpu_order, cpu_depths, cpu_launches = run("cpu")
    assert cpu_launches == (0, 0) and depths == cpu_depths
    assert waves == sum(d > 1 for d in depths) > 0 and cohorts == depths.count(1) > 0
    assert 8 in depths, depths
    assert card_seals == cpu_seals and card_order == cpu_order
    for gid in range(4):
        assert on_card.full_group_log(gid) == on_cpu.full_group_log(gid)
    assert on_card.planner.report() == on_cpu.planner.report()
    assert on_card.hw.dispatch_count == on_cpu.hw.dispatch_count
    want, have = export_state(on_cpu.hw), export_state(on_card.hw)
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)


@pytest.mark.parametrize(
    "gl,lanes,block_b",
    [
        (8, [(5, 4096, 1)], 128),
        (8, [(0, 9, 1), (7, 2**31 - 64, 1)], 32),
        (4, [(3, 3 * 4096 - 60, 1), (1, 640, 1), (3, 0, 0), (0, 0, 0)], 128),
        (4, [(2, 0, 1), (0, 128, 1), (1, 4096 - 64, 1), (3, 77, 1)], 32),
    ],
)
def test_packed_shard_kernel_matches_plain(cuda, gl, lanes, block_b):
    """K6 against ``batched.packed_multigroup_round``: C in {1, 2, Gl},
    ragged tables whose pads name enabled lanes' rows, windows across 2**31
    and across the ring end, a dead acceptor, a limit inside a window; the
    state in place; one launch counted in ``packed_launches``; rows no
    enabled lane names untouched."""
    a, n, v, b = 3, 4096, 16, 128
    c = len(lanes)
    rng = np.random.default_rng([gl, c, block_b])
    stack, lstate = _slabs(rng, gl, a, n, v, 8, cuda)
    twin = (AcceptorState(*(x.clone() for x in vars(stack).values())),
            batched.LearnerState(*(x.clone() for x in vars(lstate).values())))  # fmt: skip
    ptrs = [x.data_ptr() for x in (*vars(stack).values(), *vars(lstate).values())]
    i32 = dict(dtype=torch.int32, device=cuda)
    seg = torch.tensor([r for r, _, _ in lanes], **i32)
    ni = torch.tensor([x for _, x, _ in lanes], **i32)
    en = torch.tensor([e for _, _, e in lanes], **i32)
    crnd = torch.from_numpy(rng.integers(1, 6, c, dtype=np.int32)).to(cuda)
    alive = torch.ones((c, a), **i32)
    alive[0, 1] = 0
    limit = torch.full((c,), I32_MAX, **i32)
    limit[-1] = ni[-1] + b // 2
    values = torch.from_numpy(
        rng.integers(I32_MIN, I32_MAX, (c, b, v), dtype=np.int32, endpoint=True)
    ).to(cuda)
    before = k_wirepath.packed_launches
    got = ops.packed_shard_round(stack, lstate, seg, ni, crnd, alive, 2, values, en, limit,
                                 block_b=block_b)  # fmt: skip
    want = batched.packed_multigroup_round(*twin, seg, ni, crnd, alive, 2, values, en, limit)
    assert k_wirepath.packed_launches == before + 1
    mine = (*vars(got[0]).values(), *vars(got[1]).values(), *got[2:])
    plain = (*vars(want[0]).values(), *vars(want[1]).values(), *want[2:])
    for x, y in zip(mine, plain, strict=True):
        assert torch.equal(x, y)
    assert [x.data_ptr() for x in (*vars(stack).values(), *vars(lstate).values())] == ptrs
    pads = en == 0
    assert not got[2][pads].any() and bool((got[3][pads] == -1).all())


def test_packed_shard_kernel_refuses_before_launch(cuda):
    """Duplicate enabled rows, C > Gl and a block that does not divide B are
    refused on the host; nothing launches and no state moves."""
    gl, a, n, v, b = 2, 3, 256, 4, 16
    stack, lstate = _slabs(np.random.default_rng(3), gl, a, n, v, 8, cuda)
    state = [x.clone() for x in (*vars(stack).values(), *vars(lstate).values())]
    i32 = dict(dtype=torch.int32, device=cuda)

    def call(seg, en, c=2, block_b=128, bb=b):
        z = torch.zeros((c,), **i32)
        return ops.packed_shard_round(
            stack, lstate, torch.tensor(seg, **i32), z, z + 1, torch.ones((c, a), **i32), 2,
            torch.zeros((c, bb, v), **i32), torch.tensor(en, **i32), block_b=block_b,
        )  # fmt: skip

    before = k_wirepath.packed_launches
    with pytest.raises(ValueError, match="distinct rows"):
        call([1, 1], [1, 1])
    with pytest.raises(ValueError, match="C <= Gl"):
        call([0, 1, 1], [1, 1, 0], c=3)
    with pytest.raises(ValueError, match="dividing B"):
        call([0, 1], [1, 1], block_b=12)
    assert k_wirepath.packed_launches == before
    for x, y in zip((*vars(stack).values(), *vars(lstate).values()), state, strict=True):
        assert torch.equal(x, y)
    call([1, 1], [1, 0])  # a pad may share an enabled lane's row
    assert k_wirepath.packed_launches == before + 1


@pytest.mark.parametrize("offset", [0, 4])
def test_shard_slab_kernel_matches_plain(cuda, offset):
    """K1's shard slice against ``batched.shard_slab_round`` on one shard's
    row views of a G=8 slab at offsets 0 and Gl=4: the other shard's rows
    untouched, one launch counted in ``shard_launches``."""
    g, gl, a, n, v, b = 8, 4, 3, 4096, 16, 128
    rng = np.random.default_rng(offset)
    stack, lstate = _slabs(rng, g, a, n, v, 8, cuda)
    twin = (AcceptorState(*(x.clone() for x in vars(stack).values())),
            batched.LearnerState(*(x.clone() for x in vars(lstate).values())))  # fmt: skip
    i32 = dict(dtype=torch.int32, device=cuda)
    ni = torch.tensor([0, 9, 2**31 - 64, 4096 - 60, 640, 5, 77, 4096], **i32)
    crnd = torch.from_numpy(rng.integers(1, 6, g, dtype=np.int32)).to(cuda)
    crnd[offset + 1] = -1  # a frozen group
    alive = torch.ones((g, a), dtype=torch.bool, device=cuda)
    alive[offset + 2, 0] = False
    en = torch.tensor([1, 1, 1, 0, 1, 1, 1, 0], **i32)
    limit = torch.tensor(np.asarray([0] * 7 + [2**31 - 100], np.int32) + n).to(cuda)
    values = torch.from_numpy(
        rng.integers(I32_MIN, I32_MAX, (gl, b, v), dtype=np.int32, endpoint=True)
    ).to(cuda)

    def rows(st):
        return type(st)(*(x[offset : offset + gl] for x in vars(st).values()))

    before = k_wirepath.shard_launches
    got = ops.shard_slab_round(offset, ni, crnd, alive, 2, rows(stack), rows(lstate), values,
                               en, limit, group_block=2)  # fmt: skip
    want = batched.shard_slab_round(offset, ni, crnd, alive, 2, rows(twin[0]), rows(twin[1]),
                                    values, en, limit)  # fmt: skip
    assert k_wirepath.shard_launches == before + 1
    for x, y in zip(got[2:], want[2:], strict=True):
        assert torch.equal(x, y)
    for x, y in zip((*vars(stack).values(), *vars(lstate).values()),
                    (*vars(twin[0]).values(), *vars(twin[1]).values()), strict=True):  # fmt: skip
        assert torch.equal(x, y)


def test_sharded_context_on_the_card_matches_the_cpu(cuda):
    """A 2-shard context on the card (K6 and K1's shard slice) against the
    same context on the CPU: logs, slabs, mirrors and placement equal
    through waves, a failover, a retire and a migration."""
    from repro_torch.launch.mesh import make_group_mesh

    cfg = PaxosConfig(n_instances=1024, batch=32, n_groups=4)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        ctx = PaxosContext(cfg, mesh=make_group_mesh(2, dev), snapshots=True, device=dev,
                           net=SimNet(FaultSpec(drop=0.02, dup=0.02, reorder=0.05), 4))  # fmt: skip
        before = (k_wirepath.packed_launches, k_wirepath.shard_launches)
        for w in range(6):
            for gid in ctx.live_groups():
                for j in range(3 * 32 + 5 if gid == 0 else 7 + w):
                    ctx.submit(f"w{w}g{gid}j{j}".encode(), group=gid)
            ctx.run_until_quiescent()
            if w == 1:
                ctx.fail_coordinator(group=1)
            if w == 2:
                ctx.restore_hardware_coordinator(group=1)
                ctx.retire_group(3)
                ctx.migrate_group(0, 1)
        grew = (k_wirepath.packed_launches - before[0], k_wirepath.shard_launches - before[1])
        assert all(grew) == (dev.type == "cuda"), grew
        runs.append(ctx)
    on_card, on_cpu = runs
    for gid in range(4):
        assert on_card.full_group_log(gid) == on_cpu.full_group_log(gid)
    assert on_card.hw.group_placement() == on_cpu.hw.group_placement() == [1, 0, 1, 0]
    want, have = export_state(on_cpu.hw), export_state(on_card.hw)
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)
    assert on_card.hw.dispatch_count == on_cpu.hw.dispatch_count


def test_eight_shard_mesh_on_the_card_equals_the_cpu(cuda):
    """An 8-shard groups mesh on the card at the paper's widths (A=3,
    N=65,536, V=16, bursts of 128, G=8: one group a shard): each shard's
    slab an allocation of its own on the card, K1's shard slice launched
    once a shard a dispatch, and full-width rounds and cohorts, through a
    dead acceptor, a frozen group and a crash and restore, equal to the
    same dataplane on the CPU in outputs and gathered slabs."""
    from repro_torch.core import ShardedMultiGroupDataplane
    from repro_torch.core.failover import restore_acceptor
    from repro_torch.launch.mesh import make_group_mesh

    cfg = PaxosConfig(n_groups=8)
    g, b, v = cfg.n_groups, cfg.batch, cfg.value_words
    hws = [
        ShardedMultiGroupDataplane(cfg, mesh=make_group_mesh(8, dev), device=dev)
        for dev in (cuda, torch.device("cpu"))
    ]
    ptrs = set()
    for st, ls in zip(hws[0].stacks, hws[0].lstates, strict=True):
        for x in (*vars(st).values(), *vars(ls).values()):
            assert x.device.type == "cuda" and x.shape[0] == 1
            ptrs.add(x.untyped_storage().data_ptr())
    assert len(ptrs) == 6 * 8
    rng = np.random.default_rng(36)
    for hw in hws:
        hw.kill_acceptor(6, 2)
        hw.freeze_group(3)
    for r in range(4):
        vals = rng.integers(I32_MIN, I32_MAX, (g, b, v), dtype=np.int32, endpoint=True)
        act = np.ones((g, b), bool)
        before = k_wirepath.shard_launches
        outs = [hw.pipeline(vals, act) for hw in hws]
        assert k_wirepath.shard_launches == before + 8
        for x, y in zip(*outs, strict=True):
            np.testing.assert_array_equal(x, y)
        gids = [[0, 5], [1, 2, 7], [4], [0, 1, 2, 4, 5, 6, 7]][r]
        cv = rng.integers(I32_MIN, I32_MAX, (len(gids), b, v), dtype=np.int32, endpoint=True)
        outs = [hw.pipeline_cohort(gids, cv, np.ones((len(gids), b), bool)) for hw in hws]
        for x, y in zip(*outs, strict=True):
            np.testing.assert_array_equal(x, y)
        if r == 1:
            for hw in hws:
                hw.wipe_acceptor(5, 1)
                restore_acceptor(hw, 1, gid=5)
    want, have = export_state(hws[1]), export_state(hws[0])
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# K1 and K6: the team lane body, both variants
# ---------------------------------------------------------------------------
def _off16(x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary: the kernels must take their scalar variant on it."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 4 and y.is_contiguous()
    return y


def _variants():
    return k_wirepath.vector_launches, k_wirepath.scalar_launches


def _ran(before) -> str:
    """The variant of the one launch made since ``before = _variants()``."""
    vec, sca = (now - was for now, was in zip(_variants(), before, strict=True))
    assert (vec, sca) in ((1, 0), (0, 1))
    return "vector" if vec else "scalar"


def _held(stack, lstate, off):
    """``stack`` and ``lstate`` with the value slab named ``off`` moved 4
    bytes off 16 (the same values)."""
    if off == "st_val":
        stack = AcceptorState(stack.rnd, stack.vrnd, _off16(stack.value))
    if off == "lval":
        lstate = batched.LearnerState(lstate.delivered, lstate.inst, _off16(lstate.value))
    return stack, lstate


def _states(stack, lstate):
    return [*vars(stack).values(), *vars(lstate).values()]


@pytest.mark.parametrize(
    "a,v,off,base,lim,threads,variant",
    [
        (3, 16, None, 4096, None, 128, "vector"),
        (3, 16, None, 4096 - 20, None, 64, "vector"),  # the window wraps inside a block
        (3, 5, None, 1001, 77, 128, "scalar"),
        (3, 1, None, 4096 - 9, None, 64, "scalar"),
        (3, 16, "values", 77, None, 128, "scalar"),
        (3, 16, "st_val", 4096 - 3, 40, 64, "scalar"),
        (3, 16, "lval", 2 * 4096 - 5, None, 128, "scalar"),
        (5, 16, None, 999, 100, 64, "vector"),  # more acceptors than the team of 4
        (8, 16, None, 4096 - 30, None, 128, "vector"),
        (8, 5, None, 300, None, 64, "scalar"),
        (3, 130, None, 640, 90, 64, "scalar"),  # 5 words a thread: value stores in 3 passes
    ],
)
def test_team_round_kernel_matches_plain(
    cuda, monkeypatch, a, v, off, base, lim, threads, variant
):
    """K1 at G=1 against ``batched.fused_round`` in both variants: V in {16,
    5, 1}, each value tensor 4 bytes off 16, windows across the ring end
    inside a block, A up to 8 (more acceptors than the team), a reclaim
    limit, blocks of 64 and 128 threads; the variant asserted by its
    counter, the state in place.  (No window across 2**31 here: without a
    limit the kernel refuses instance 2**31 - 1, as the reference's kernel
    does, and its plain version does not.)"""
    n, b, q = 4096, 128, a // 2 + 1
    rng = np.random.default_rng([a, v, base % 997, threads])
    s = _state(rng, a, n, v, base, 5, cuda)
    twin = _clone(s)
    stack, lstate = _held(s["stack"], s["lstate"], off)
    ptrs = [x.data_ptr() for x in _states(stack, lstate)]
    values = torch.from_numpy(
        rng.integers(I32_MIN, I32_MAX, (b, v), dtype=np.int32, endpoint=True)
    ).to(cuda)
    alive = torch.ones(a, dtype=torch.bool, device=cuda)
    alive[1] = a > 1 and a != 3
    limit = None if lim is None else base + lim
    monkeypatch.setattr(k_wirepath, "LANE_THREADS", threads)
    before, count = _variants(), k_wirepath.launches
    got = k_wirepath.wirepath_round(s["cstate"].next_inst, s["cstate"].crnd, q, alive,
                                    *_states(stack, lstate), values if off != "values"
                                    else _off16(values), limit)  # fmt: skip
    want = batched.fused_round(**twin, values=values, active=torch.ones(b, dtype=torch.bool,
                               device=cuda), alive=alive, quorum=q, reclaim_limit=limit)  # fmt: skip
    assert _ran(before) == variant and k_wirepath.launches == count + 1
    c, st, ls, fresh, inst, win, value = want
    for x, y in zip(got, [*_states(st, ls), c.next_inst, inst, fresh, win, value], strict=True):
        assert torch.equal(x, y)
    assert [x.data_ptr() for x in got[:6]] == ptrs


@pytest.mark.parametrize(
    "a,v,off,gb,threads,variant",
    [
        (3, 16, None, 1, 128, "vector"),
        (3, 5, None, 2, 64, "scalar"),
        (3, 1, None, 8, 128, "scalar"),
        (3, 16, "values", 1, 64, "scalar"),
        (5, 16, None, 2, 128, "vector"),
        (8, 16, "lval", 1, 64, "scalar"),
        (8, 16, None, 8, 64, "vector"),
    ],
)
def test_team_cohort_kernel_matches_plain(cuda, monkeypatch, a, v, off, gb, threads, variant):
    """K1 in cohort form against ``batched.cohort_fused_round`` in both
    variants at G=8: a subset and all blocks, an inert member, windows
    across the ring end inside a block and across 2**31, dead acceptors, a
    wrapped limit, blocks of 64 and 128 threads; the variant asserted by
    its counter."""
    g, n, b, q = 8, 4096, 128, a // 2 + 1
    rng = np.random.default_rng([a, v, gb, threads])
    gsel = {1: [0, 3, 6], 2: [1, 2], 8: [0]}[gb]
    block_base = [n - 20, I32_MAX - 63, 640, 9, 3 * n - 60, 77, 1003, 4096]
    bases = [block_base[gi // gb] for gi in range(g)]
    enabled = [1] * g
    enabled[gsel[-1] * gb + gb - 1] = 0  # an inert member
    bases[gsel[-1] * gb + gb - 1] = 7 * n + 5  # at a divergent base
    stack, lstate = _slabs(rng, g, a, n, v, 8, cuda)
    twin = (AcceptorState(*(x.clone() for x in vars(stack).values())),
            batched.LearnerState(*(x.clone() for x in vars(lstate).values())))  # fmt: skip
    stack, lstate = _held(stack, lstate, off)
    i32 = dict(dtype=torch.int32, device=cuda)
    ni, en = torch.tensor(bases, **i32), torch.tensor(enabled, **i32)
    crnd = torch.from_numpy(rng.integers(1, 6, g, dtype=np.int32)).to(cuda)
    alive = torch.ones((g, a), dtype=torch.bool, device=cuda)
    alive[0, 0] = False
    alive[3, 1:] = False  # below quorum
    limit = torch.from_numpy(np.asarray([0] * 6 + [2**31 - 100, 0], np.int32) + n).to(cuda)
    values = torch.from_numpy(
        rng.integers(I32_MIN, I32_MAX, (len(gsel) * gb, b, v), dtype=np.int32, endpoint=True)
    ).to(cuda)
    monkeypatch.setattr(k_wirepath, "LANE_THREADS", threads)
    before, count = _variants(), k_wirepath.cohort_launches
    got = k_wirepath.cohort_wirepath_round(
        gsel, ni, crnd, q, alive, *_states(stack, lstate),
        _off16(values) if off == "values" else values, en, limit, group_block=gb,
    )  # fmt: skip
    want = batched.cohort_fused_round(*twin, gsel, ni, crnd, alive, q, values, en, limit,
                                      group_block=gb)  # fmt: skip
    assert _ran(before) == variant and k_wirepath.cohort_launches == count + 1
    for x, y in zip(got, [*_states(*want[:2]), *want[2:]], strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize(
    "offset,a,v,off,threads,variant",
    [
        (0, 3, 16, None, 128, "vector"),
        (4, 3, 5, None, 64, "scalar"),
        (0, 5, 16, "st_val", 64, "scalar"),
        (4, 8, 1, None, 128, "scalar"),
        (4, 8, 16, None, 64, "vector"),
    ],
)
def test_team_shard_kernel_matches_plain(cuda, monkeypatch, offset, a, v, off, threads, variant):
    """K1's shard slice against ``batched.shard_slab_round`` in both
    variants on a shard's row views of a G=8 slab; the other shard's rows
    untouched; the variant asserted by its counter."""
    g, gl, n, b, q = 8, 4, 4096, 128, a // 2 + 1
    rng = np.random.default_rng([offset, a, v, threads])
    stack, lstate = _slabs(rng, g, a, n, v, 8, cuda)
    twin = (AcceptorState(*(x.clone() for x in vars(stack).values())),
            batched.LearnerState(*(x.clone() for x in vars(lstate).values())))  # fmt: skip
    stack, lstate = _held(stack, lstate, off)
    i32 = dict(dtype=torch.int32, device=cuda)
    ni = torch.tensor([n - 20, 9, I32_MAX - 63, 4096 - 60, n - 7, 5, 77, 4096], **i32)
    crnd = torch.from_numpy(rng.integers(1, 6, g, dtype=np.int32)).to(cuda)
    alive = torch.ones((g, a), dtype=torch.bool, device=cuda)
    alive[offset + 2, 0] = False
    en = torch.tensor([1, 1, 1, 0, 1, 1, 1, 0], **i32)
    limit = torch.tensor(np.asarray([0] * 7 + [2**31 - 100], np.int32) + n).to(cuda)
    values = torch.from_numpy(
        rng.integers(I32_MIN, I32_MAX, (gl, b, v), dtype=np.int32, endpoint=True)
    ).to(cuda)

    def rows(st):
        return type(st)(*(x[offset : offset + gl] for x in vars(st).values()))

    monkeypatch.setattr(k_wirepath, "LANE_THREADS", threads)
    before, count = _variants(), k_wirepath.shard_launches
    got = k_wirepath.shard_slab_round(offset, ni, crnd, q, alive, *_states(rows(stack),
                                      rows(lstate)), values, en, limit)  # fmt: skip
    want = batched.shard_slab_round(offset, ni, crnd, alive, q, rows(twin[0]), rows(twin[1]),
                                    values, en, limit)  # fmt: skip
    assert _ran(before) == variant and k_wirepath.shard_launches == count + 1
    for x, y in zip(got[6:], want[2:], strict=True):
        assert torch.equal(x, y)
    for x, y in zip(_states(stack, lstate), _states(*twin), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize(
    "a,v,off,lanes,threads,variant",
    [
        (3, 16, None, [(5, 4096 - 20, 1)], 128, "vector"),  # C=1, the window wraps
        (3, 16, None, [(3, 3 * 4096 - 60, 1), (1, 640, 1), (3, 0, 0), (0, 0, 0)], 64, "vector"),
        (3, 5, None, [(2, 0, 1), (0, 128, 1), (1, 4096 - 64, 1), (3, 77, 1)], 128, "scalar"),
        (5, 16, "values", [(0, 9, 1), (7, I32_MAX - 63, 1)], 64, "scalar"),
        (8, 1, None, [(1, 300, 1), (1, 0, 0)], 128, "scalar"),
        (8, 16, "st_val", [(2, 1003, 1), (6, 5, 1), (4, 0, 0), (0, 4096 - 1, 1)], 64, "scalar"),
        (8, 16, None, [(2, 1003, 1), (6, 5, 1), (0, 0, 0)], 64, "vector"),
    ],
)
def test_team_packed_kernel_matches_plain(
    cuda, monkeypatch, a, v, off, lanes, threads, variant
):
    """K6 against ``batched.packed_multigroup_round`` in both variants at
    Gl=8: C in {1, 2, 3, 4}, pads (one naming an enabled lane's row), windows
    across the ring end and across 2**31, A up to 8, a limit inside a
    window, blocks of 64 and 128 threads; pads inert; the variant asserted
    by its counter."""
    gl, n, b, q = 8, 4096, 128, a // 2 + 1
    c = len(lanes)
    rng = np.random.default_rng([a, v, c, threads])
    stack, lstate = _slabs(rng, gl, a, n, v, 8, cuda)
    twin = (AcceptorState(*(x.clone() for x in vars(stack).values())),
            batched.LearnerState(*(x.clone() for x in vars(lstate).values())))  # fmt: skip
    stack, lstate = _held(stack, lstate, off)
    i32 = dict(dtype=torch.int32, device=cuda)
    seg, ni, en = (torch.tensor([lane[i] for lane in lanes], **i32) for i in range(3))
    crnd = torch.from_numpy(rng.integers(1, 6, c, dtype=np.int32)).to(cuda)
    alive = torch.ones((c, a), **i32)
    alive[0, 0] = 0
    limit = torch.full((c,), I32_MAX, **i32)
    limit[-1] = ni[-1] + b // 2
    values = torch.from_numpy(
        rng.integers(I32_MIN, I32_MAX, (c, b, v), dtype=np.int32, endpoint=True)
    ).to(cuda)
    monkeypatch.setattr(k_wirepath, "LANE_THREADS", threads)
    before, count = _variants(), k_wirepath.packed_launches
    got = k_wirepath.packed_shard_round(
        seg, ni, crnd, q, alive, *_states(stack, lstate),
        _off16(values) if off == "values" else values, en, limit,
    )  # fmt: skip
    want = batched.packed_multigroup_round(*twin, seg, ni, crnd, alive, q, values, en, limit)
    assert _ran(before) == variant and k_wirepath.packed_launches == count + 1
    for x, y in zip(got, [*_states(*want[:2]), *want[2:]], strict=True):
        assert torch.equal(x, y)
    pads = en == 0
    assert not got[6][pads].any() and not got[8][pads].any()
    assert bool((got[7][pads] == -1).all())


# ---------------------------------------------------------------------------
# K5: the team body with the rounds over the grid; K2: a team per
# (acceptor, lane)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "a,v,off,gb,k,b,threads,variant",
    [
        (3, 16, None, 1, 8, 128, 128, "vector"),
        (3, 16, None, 2, 8, 16, 64, "vector"),
        (3, 16, None, 8, 32, 128, 256, "vector"),  # K * B = N
        (3, 5, None, 2, 4, 128, 128, "scalar"),
        (3, 16, "values", 1, 8, 128, 64, "scalar"),
        (5, 16, "st_val", 2, 8, 16, 256, "scalar"),
        (3, 16, "lval", 8, 4, 128, 128, "scalar"),
        (8, 1, None, 1, 16, 64, 256, "scalar"),
        (8, 16, None, 2, 8, 128, 64, "vector"),
    ],
)
def test_team_persistent_kernel_matches_plain(cuda, monkeypatch, a, v, off, gb, k, b, threads,
                                              variant):  # fmt: skip
    """K5's team body against ``batched.persistent_cohort_rounds`` in both
    variants (value tensors at offset 0 and 4 bytes off 16) at 64, 128 and
    256 threads a block, G=8: a subset and all blocks, a freeze from round 2
    on and an inert member, windows across 2**31 and across the ring end,
    dead acceptors (one group below quorum), a limit inside the wave and a
    wrapped one; the variant asserted by its counter, the state in place."""
    g, n, q = 8, 4096, a // 2 + 1
    rng = np.random.default_rng([a, v, gb, k, threads])
    gsel = {1: [0, 3, 6], 2: [1, 2], 8: [0]}[gb]
    rows = [blk * gb + j for blk in gsel for j in range(gb)]
    block_base = [n - 20, I32_MAX - 63, 640, 9, 3 * n - 60, 77, 1003, 4096]
    bases = [block_base[gi // gb] for gi in range(g)]
    wen = np.zeros((k, g), np.int32)
    wen[:, rows] = 1
    wen[2:, rows[0]] = 0  # frozen from round 2
    if gb > 1:
        wen[:, rows[1]] = 0  # an inert member of a folded block
    wni = _walk(bases, wen, b)
    crnd = torch.from_numpy(rng.integers(1, 6, g, dtype=np.int32)).to(cuda)
    alive = torch.ones((g, a), dtype=torch.bool, device=cuda)
    alive[rows[-1], 0] = False
    alive[3, 1:] = False  # below quorum
    limit = np.asarray([0] * 7 + [2**31 - 100], np.int32) + n  # group 7's wraps
    limit[rows[-1]] = np.int32(bases[rows[-1]] + b + 7)
    values = torch.from_numpy(
        rng.integers(I32_MIN, I32_MAX, (k, len(rows), b, v), dtype=np.int32, endpoint=True)
    ).to(cuda)
    stack, lstate = _slabs(rng, g, a, n, v, 8, cuda)
    twin = (AcceptorState(*(x.clone() for x in vars(stack).values())),
            batched.LearnerState(*(x.clone() for x in vars(lstate).values())))  # fmt: skip
    stack, lstate = _held(stack, lstate, off)
    ptrs = [x.data_ptr() for x in _states(stack, lstate)]
    want = batched.persistent_cohort_rounds(*twin, gsel, wni, wen, crnd, alive, q, values, limit,
                                            group_block=gb)  # fmt: skip
    monkeypatch.setattr(k_wirepath, "LANE_THREADS", threads)
    before, count = _variants(), k_wirepath.persistent_launches
    got = k_wirepath.persistent_wirepath_round(
        gsel, wni, wen, crnd, q, alive, *_states(stack, lstate),
        _off16(values) if off == "values" else values, torch.from_numpy(limit).to(cuda),
        group_block=gb,
    )  # fmt: skip
    assert _ran(before) == variant and k_wirepath.persistent_launches == count + 1
    for x, y in zip(got, [*_states(*want[:2]), *want[2:]], strict=True):
        assert torch.equal(x, y)
    assert [x.data_ptr() for x in got[:6]] == ptrs


@pytest.mark.parametrize(
    "k,n,v,variant",
    [(65_535, 65_536, 16, "vector"), (65_536, 65_536, 16, "vector"),
     (140_000, 1 << 18, 5, "scalar")],  # fmt: skip
)
def test_persistent_kernel_at_the_grid_z_edge(cuda, k, n, v, variant):
    """Every K the wrapper admits runs: at B = 1, K * B <= N admits K = N,
    past the grid's z extent of 65,535, where a block serves rounds z, z +
    65,535, ...  A wave of K enabled rounds of one lane is one K-lane
    window, so it is held against one ``batched.cohort_fused_round`` of
    B = K (outputs transposed), the state compared whole."""
    g, a, q, base = 2, 3, 2, n - 7  # the wave crosses the ring end
    rng = np.random.default_rng([k, v])
    stack, lstate = _slabs(rng, g, a, n, v, 8, cuda)
    twin = (AcceptorState(*(x.clone() for x in vars(stack).values())),
            batched.LearnerState(*(x.clone() for x in vars(lstate).values())))  # fmt: skip
    wen = np.ones((k, g), np.int32)
    wni = _walk([base] * g, wen, 1)
    crnd = torch.full((g,), 6, dtype=torch.int32, device=cuda)
    alive = torch.ones((g, a), dtype=torch.bool, device=cuda)
    alive[1, 0] = False
    values = torch.from_numpy(
        rng.integers(I32_MIN, I32_MAX, (k, 1, 1, v), dtype=np.int32, endpoint=True)
    ).to(cuda)
    assert k_wirepath.wave_geometry(v, 1, 1, k, n, True).grid[2] == min(k, 65_535)
    before = _variants()
    got = k_wirepath.persistent_wirepath_round([1], wni, wen, crnd, q, alive,
                                               *_states(stack, lstate), values)  # fmt: skip
    want = batched.cohort_fused_round(*twin, [1], torch.from_numpy(wni[0]).to(cuda), crnd,
                                      alive, q, values.reshape(1, k, v), [1] * g)  # fmt: skip
    assert _ran(before) == variant
    assert torch.equal(got[6].reshape(1, k), want[2])
    assert torch.equal(got[7].reshape(1, k), want[3])
    assert torch.equal(got[8].reshape(1, k, v), want[4])
    for x, y in zip(got[:6], _states(*want[:2]), strict=True):
        assert torch.equal(x, y)


def _burst_view(value):
    """``value`` (B, V) as rows 1..B of a (B + 1)-row burst that starts 4
    bytes off 16: a contiguous view, 4 bytes off 16 where V % 4 == 0."""
    b, v = value.shape
    whole = _off16(torch.cat([value[:1], value]).reshape(-1))
    view = whole[v:].view(b, v)
    assert view.is_contiguous() and torch.equal(view, value)
    return view


@pytest.mark.parametrize(
    "a,v,off,alive,threads,variant",
    [
        (3, 16, None, [1, 1, 1], 128, "vector"),
        (3, 16, None, [1, 0, 1], 64, "vector"),
        (5, 16, None, [0, 1, 1, 0, 1], 256, "vector"),
        (3, 16, "msg_val", [1, 1, 1], 128, "scalar"),  # a view into a burst, 4 bytes off 16
        (3, 16, "st_val", [1, 0, 1], 64, "scalar"),
        (3, 5, None, [1, 1, 0], 256, "scalar"),
        (8, 1, None, [1, 0, 1, 1, 1, 0, 1, 1], 128, "scalar"),
        (3, 130, None, [1, 1, 1], 64, "scalar"),  # 5 words a thread: stores in 3 passes
        (3, 256, None, [1, 1, 0], 128, "vector"),  # 2 int4 a thread at T = 32
    ],
)
def test_team_vote_kernel_matches_plain(cuda, monkeypatch, a, v, off, alive, threads, variant):
    """K2's team body against ``batched.acceptor_phase2_all`` in both
    variants, over an aligned, a misaligned, a ring-end and a scattered
    window (P2As, NOPs and other types, rounds below and above the
    promises), blocks of 64, 128 and 256 threads; the variant asserted by
    its counter, the stacked rings in place."""
    n = 4096
    rng = np.random.default_rng([a, v, threads, len(alive)])
    s = _state(rng, a, n, v, 0, 5, cuda)["stack"]
    twin = AcceptorState(*(x.clone() for x in vars(s).values()))
    if off == "st_val":
        s = AcceptorState(s.rnd, s.vrnd, _off16(s.value))
    ptrs = [x.data_ptr() for x in vars(s).values()]
    alv = torch.tensor(alive, dtype=torch.bool, device=cuda)
    monkeypatch.setattr(k_wirepath, "LANE_THREADS", threads)
    for inst in _windows(rng, n, 128):
        msgs = _phase2(rng, inst, v, cuda)
        if off == "msg_val":
            msgs = msgs.replace(value=_burst_view(msgs.value))
            assert msgs.value.data_ptr() % 16 == 4
        before, count = _variants(), k_wirepath.vote_all_launches
        _, got = ops.acceptor_phase2_all(s, msgs, alv)
        _, want = batched.acceptor_phase2_all(twin, msgs, alv)
        assert _ran(before) == variant and k_wirepath.vote_all_launches == count + 1
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        for x, y in zip(vars(s).values(), vars(twin).values(), strict=True):
            assert torch.equal(x, y)
    assert [x.data_ptr() for x in vars(s).values()] == ptrs


@pytest.mark.parametrize("v", [16, 5])
def test_vote_all_equals_k7_per_acceptor(cuda, v):
    """K2's and K7's team body against the first design's one-thread
    ``vote_lane`` (``acceptor_phase2_witness``): each alive acceptor's vote
    row and registers from K2, and from K7 on a clone of that acceptor's
    own file, equal the witness's on another clone, window after window;
    the dead acceptor's row and registers equal the plain version's."""
    a, n, b, alive = 3, 65536, 128, [1, 0, 1]
    rng = np.random.default_rng([v, 7])
    s = _state(rng, a, n, v, 0, 5, cuda)["stack"]
    twin = AcceptorState(*(x.clone() for x in vars(s).values()))

    def clones():
        return {i: AcceptorState(*(x[i].clone() for x in vars(s).values())) for i in (0, 2)}

    files, witness = clones(), clones()
    alv = torch.tensor(alive, dtype=torch.bool, device=cuda)
    for inst in _windows(rng, n, b):
        msgs = _phase2(rng, inst, v, cuda)
        _, got = ops.acceptor_phase2_all(s, msgs, alv)
        _, want = batched.acceptor_phase2_all(twin, msgs, alv)
        for i, f in files.items():
            before, seen = k_acceptor.launches, k_acceptor.witness_launches
            _, k7 = ops.acceptor_phase2(f, msgs, i)
            w = k_acceptor.acceptor_phase2_witness(*vars(witness[i]).values(), i, msgs.msgtype,
                                                   msgs.inst, msgs.rnd, msgs.value)  # fmt: skip
            assert k_acceptor.launches == before + 1
            assert k_acceptor.witness_launches == seen + 1
            for name, theirs in zip(FIELDS, w[3:], strict=True):
                assert torch.equal(getattr(got, name)[i], theirs), (i, name)
                assert torch.equal(getattr(k7, name), theirs), (i, name)
        for name in FIELDS:
            assert torch.equal(getattr(got, name)[1], getattr(want, name)[1]), name
    for i, f in files.items():
        for name in ("rnd", "vrnd", "value"):
            assert torch.equal(getattr(s, name)[i], getattr(f, name)), (i, name)
            assert torch.equal(getattr(witness[i], name), getattr(f, name)), (i, name)
    for name in ("rnd", "vrnd", "value"):
        assert torch.equal(getattr(s, name)[1], getattr(twin, name)[1]), name


@pytest.mark.parametrize(
    "v,b,off,threads,variant",
    [
        (16, 128, None, 128, "vector"),  # the per-role walk: 4 blocks of 32 lanes
        (16, 512, None, 128, "vector"),  # Table 1's burst
        (16, 100, None, 64, "vector"),  # B not a multiple of a block's lanes
        (16, 128, "msg_val", 128, "scalar"),  # a view into a burst, 4 bytes off 16
        (16, 100, "st_val", 256, "scalar"),
        (5, 128, None, 128, "scalar"),
        (3, 77, None, 64, "scalar"),
        (64, 128, None, 256, "vector"),
        (130, 128, None, 128, "scalar"),  # 5 words a thread: stores in 3 passes
    ],
)
def test_team_acceptor_kernel_matches_plain(cuda, monkeypatch, v, b, off, threads, variant):
    """K7 on K2's team body against ``batched.acceptor_phase2`` in both
    variants, over an aligned, a misaligned, a ring-end and a scattered
    window, blocks of 64, 128 and 256 threads; the variant asserted by its
    counter, the register file in place."""
    n = 4096
    rng = np.random.default_rng([v, b, threads, 24])
    s = _state(rng, 1, n, v, 0, 5, cuda)["stack"]
    file = AcceptorState(*(x[0] for x in vars(s).values()))
    twin = AcceptorState(*(x.clone() for x in vars(file).values()))
    if off == "st_val":
        file = AcceptorState(file.rnd, file.vrnd, _off16(file.value))
    ptrs = [x.data_ptr() for x in vars(file).values()]
    monkeypatch.setattr(k_wirepath, "LANE_THREADS", threads)
    for inst in _windows(rng, n, b):
        msgs = _phase2(rng, inst, v, cuda)
        if off == "msg_val":
            msgs = msgs.replace(value=_burst_view(msgs.value))
            assert msgs.value.data_ptr() % 16 == 4
        before, count = _variants(), k_acceptor.launches
        _, got = ops.acceptor_phase2(file, msgs, 3)
        _, want = batched.acceptor_phase2(twin, msgs, 3)
        assert _ran(before) == variant and k_acceptor.launches == count + 1
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        for x, y in zip(vars(file).values(), vars(twin).values(), strict=True):
            assert torch.equal(x, y)
    assert [x.data_ptr() for x in vars(file).values()] == ptrs


def _quorum_votes(rng, a, b, v, dev):
    """Votes whose first agreeing acceptor cycles over the lanes: 0, 1, A-1
    and none, then foreign lanes (mixed types and vrnds); acceptors before
    the first agreeing one REJECT with non-zero values, after it P2B at the
    winning round or one below."""
    vtype = np.full((a, b), 4, np.int32)
    vrnd = np.where(rng.random((a, b)) < 0.5, 7, 6).astype(np.int32)
    kinds = [0, min(1, a - 1), a - 1, None, "foreign"]
    for j in range(b):
        kind = kinds[j % len(kinds)]
        if kind is None:
            vtype[:, j] = 7
        elif kind == "foreign":
            vtype[:, j] = rng.choice([4, 4, 7, 2], a)
            vrnd[:, j] = rng.integers(-3, 4, a)
        else:
            vtype[:kind, j] = 7
            vrnd[kind, j] = 7
    value = rng.integers(1, I32_MAX, (a, b, v), dtype=np.int32)
    return [torch.from_numpy(x).to(dev) for x in (vtype, vrnd, value)]


@pytest.mark.parametrize(
    "a,v,b,off,threads,variant",
    [
        (3, 16, 128, False, 128, "vector"),  # the per-role walk: 4 blocks of 32 lanes
        (3, 16, 512, False, 128, "vector"),  # Table 1's burst
        (3, 16, 100, False, 64, "vector"),  # B not a multiple of a block's lanes
        (1, 16, 128, False, 128, "vector"),
        (5, 16, 77, True, 256, "scalar"),  # the vote values 4 bytes off 16
        (3, 5, 128, False, 128, "scalar"),
        (8, 16, 128, False, 128, "vector"),  # every acceptor loaded up front
        (9, 16, 128, False, 128, "vector"),  # one above VOTE_CAP: reloads past it
        (9, 5, 100, False, 64, "scalar"),
        (12, 64, 128, True, 256, "scalar"),
        (3, 130, 128, False, 128, "scalar"),  # 5 words a thread: the rest after deciding
        (3, 256, 64, False, 128, "vector"),  # 2 int4 a thread at T = 32
    ],
)
def test_team_quorum_kernel_matches_plain(cuda, monkeypatch, a, v, b, off, threads, variant):
    """K8's team body against ``learner.learner_quorum_plain`` in both
    variants, on lanes whose first agreeing acceptor is 0, 1, A-1 or none
    and on foreign lanes, at A up to and past ``VOTE_CAP``, blocks of 64,
    128 and 256 threads; the variant asserted by its counter, value 0
    where no acceptor agrees."""
    rng = np.random.default_rng([a, v, b, threads])
    vtype, vrnd, value = _quorum_votes(rng, a, b, v, cuda)
    if off:
        value = _off16(value)
    monkeypatch.setattr(k_wirepath, "LANE_THREADS", threads)
    before, count = _variants(), k_learner.launches
    got = k_learner.learner_quorum_window(a // 2 + 1, vtype, vrnd, value)
    want = k_learner.learner_quorum_plain(a // 2 + 1, vtype, vrnd, value)
    assert _ran(before) == variant and k_learner.launches == count + 1
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert not got[2][3::5].any()  # the lanes where no acceptor agrees


# ---------------------------------------------------------------------------
# K9: attention
# ---------------------------------------------------------------------------
def _qkv(rng, b, h, kvh, sq, sk, d, dtype, dev):
    def t(shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(dtype).to(dev)

    return t((b, h, sq, d)), t((b, kvh, sk, d)), t((b, kvh, sk, d))


@pytest.fixture
def full_f32(cuda):
    """float32 products in full float32: the kernel never uses TF32, and the
    plain version must not either."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


# (b, h, kvh, sq, sk, d, window, causal): the cases of tests/test_flash_kernel.py,
# the fully masked rows (causal, window 64, Sq 256 > Sk 128), ragged lengths and
# head dims that fill no whole register tile; then ragged lengths across a
# 128-row and a 128-key tile edge, a Whisper-shaped cross-attention, D=256 (64-key
# tiles) ringing through many stages, and S=8192 at window 1024, where the K/V
# ring wraps many times within an item and across items; the MoE path's
# shape, llama4-scout's G = 40/8 = 5 heads a kv head; griffin's (recurrentgemma:
# G = 10, D = 256, window 2048, S past the window) and whisper's encoder (1500
# frames, non-causal)
K9_CASES = [
    (1, 4, 2, 256, 256, 64, 0, True),
    (2, 4, 4, 128, 128, 128, 0, True),
    (1, 8, 1, 256, 256, 64, 0, True),
    (1, 2, 2, 384, 384, 128, 0, True),
    (1, 4, 2, 256, 256, 64, 64, True),
    (1, 4, 2, 256, 256, 64, 128, True),
    (1, 4, 2, 256, 256, 64, 1024, True),
    (1, 2, 1, 128, 128, 64, 0, False),
    (1, 4, 2, 128, 128, 128, 0, True),
    (1, 4, 2, 256, 128, 64, 64, True),
    (1, 4, 2, 200, 200, 64, 0, True),
    (2, 4, 2, 77, 200, 32, 0, False),
    (1, 2, 1, 200, 131, 16, 50, False),
    (1, 4, 2, 150, 150, 80, 0, True),
    (1, 2, 1, 100, 100, 256, 33, True),
    (1, 4, 2, 200, 333, 128, 0, True),
    (1, 8, 8, 448, 1500, 64, 0, False),
    (1, 4, 2, 1024, 1024, 256, 512, True),
    (1, 2, 1, 8192, 8192, 128, 1024, True),
    (2, 40, 8, 2048, 2048, 128, 0, True),
    (1, 10, 1, 2304, 2304, 256, 2048, True),
    (1, 8, 8, 1500, 1500, 64, 0, False),
]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,kvh,sq,sk,d,window,causal", K9_CASES)
def test_attention_kernel_matches_plain(full_f32, dtype, atol, b, h, kvh, sq, sk, d, window,
                                        causal):  # fmt: skip
    from repro_torch.kernels import flash_attention as k_flash

    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, b, h, kvh, sq, sk, d, dtype, full_f32)
    before = k_flash.launches
    got = k_flash.flash_attention(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert k_flash.launches == before + 1
    want = k_flash.flash_attention_plain(q, k, v, window=window, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("sq,sk,window,causal", [(384, 384, 0, True), (384, 384, 100, True),
                                                  (200, 333, 0, False)])  # fmt: skip
def test_attention_kernel_reads_model_layout_views(full_f32, dtype, atol, sq, sk, window, causal):
    """q, k, v made as the models make them, (B, S, H, D), and handed over as
    (B, H, S, D) views: K9 reads them in place and writes an output laid out
    as q is, equal to the plain version on contiguous copies."""
    from repro_torch.kernels import flash_attention as k_flash

    rng = np.random.default_rng(9)
    b, h, kvh, d = 2, 8, 4, 128

    def t(shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(dtype).to(full_f32)

    q, k, v = (x.permute(0, 2, 1, 3) for x in (t((b, sq, h, d)), t((b, sk, kvh, d)),
                                                  t((b, sk, kvh, d))))  # fmt: skip
    assert not any(x.is_contiguous() for x in (q, k, v))
    before = k_flash.launches
    got = k_flash.flash_attention(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert k_flash.launches == before + 1
    assert got.stride() == q.stride() and got.permute(0, 2, 1, 3).is_contiguous()
    want = k_flash.flash_attention_plain(*(x.contiguous() for x in (q, k, v)), window=window,
                                         causal=causal)  # fmt: skip
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol)


def test_attention_kernel_averages_v_where_a_row_sees_no_key(cuda):
    """Causal with window 64 and Sq 256 > Sk 128: rows 191 and up see no key
    and must come out as the mean of V over all 128 keys."""
    from repro_torch.kernels import flash_attention as k_flash

    q, k, v = _qkv(np.random.default_rng(3), 1, 4, 2, 256, 128, 64, torch.float32, cuda)
    got = k_flash.flash_attention(q, k, v, window=64, causal=True).cpu()
    mean = v.mean(dim=2).repeat_interleave(2, dim=1).cpu()  # (1, 4, 64)
    for row in (191, 200, 255):
        np.testing.assert_allclose(got[:, :, row].numpy(), mean.numpy(), atol=2e-5)


@pytest.mark.parametrize(
    "shape_k,dtype,why",
    [
        ((1, 2, 64, 20), torch.float32, "multiple of 16"),
        ((1, 2, 64, 272), torch.float32, "multiple of 16"),
        ((1, 2, 64, 64), torch.float16, "float32 or bfloat16"),
        ((1, 3, 64, 64), torch.float32, "does not fit"),
    ],
)
def test_attention_kernel_refuses_before_launch(cuda, shape_k, dtype, why):
    from repro_torch.kernels import flash_attention as k_flash

    d = shape_k[3]
    q = torch.zeros((1, 4, 64, d), dtype=dtype, device=cuda)
    k = torch.zeros(shape_k, dtype=dtype, device=cuda)
    before = k_flash.launches
    with pytest.raises((ValueError, TypeError), match=why):
        k_flash.flash_attention(q, k, k.clone())
    strided = torch.zeros((1, 4, 64, 128), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        k_flash.flash_attention(strided, strided, strided)
    assert k_flash.launches == before


def test_attention_kernel_refuses_a_negative_window(cuda):
    from repro_torch.kernels import flash_attention as k_flash

    q = torch.zeros((1, 4, 64, 64), device=cuda)
    k = torch.zeros((1, 2, 64, 64), device=cuda)
    before = k_flash.launches
    for call in (k_flash.flash_attention, k_flash.flash_attention_kernel):
        with pytest.raises(ValueError, match="window >= 0"):
            call(q, k, k.clone(), window=-64)
    assert k_flash.launches == before


def _k9_misfits(got: torch.Tensor, want: np.ndarray, atol: float) -> str:
    """Where the elements of a (B, S, KVH, G, D) attention output that are
    more than ``atol`` off ``want`` lie: their count by (b, h, q tile), h =
    kv head * G + g, the tile K9's block of rows (32 in float32, 128 in
    bfloat16).  A block-level race shows as whole tiles, a fault of the
    inputs' ordering as scattered elements."""
    rows = 32 if got.dtype == torch.float32 else 128
    bad = np.argwhere(np.abs(got.float().cpu().numpy() - want) > atol)
    _, _, _, g, _ = got.shape
    tiles: dict[tuple[int, int, int], int] = {}
    for b, s, kv, gi, _ in bad:
        key = (int(b), int(kv * g + gi), int(s) // rows)
        tiles[key] = tiles.get(key, 0) + 1
    return f"{len(bad)} elements off by more than {atol}; by (b, h, q tile): {tiles}"


def _k9_case(dtype):
    """The model-layout case (B=2, S=300, KVH=2, G=2, D=64, seed 6) on the
    CPU: q, k, v in ``dtype`` and the CPU path's float32 output."""
    from repro_torch.models import layers

    rng = np.random.default_rng(6)
    b, s, kvh, g, d = 2, 300, 2, 2, 64
    q = torch.from_numpy(rng.standard_normal((b, s, kvh, g, d)).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kvh, d)).astype(np.float32)).to(dtype)
            for _ in range(2))  # fmt: skip
    return (q, k, v), layers.flash_attention(q.float(), k.float(), v.float(), window=40).numpy()


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_model_attention_hands_k9_views_not_copies(full_f32, dtype, atol):
    """``layers.flash_attention``'s card route passes K9 (B, H, S, D) views of
    the models' (B, S, ., D) tensors, their own storage, and launches once;
    the output comes back as the models' layout without a copy.  A second
    launch on the same inputs is bitwise the first, and both are within
    ``atol`` of the CPU path; a failure names the (b, h, q tile) of every
    element off."""
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.models import layers

    (q, k, v), want = _k9_case(dtype)
    card = [x.to(full_f32) for x in (q, k, v)]
    seen = []
    router = k_flash.flash_attention

    def spy(*args, **kw):
        seen.append(args)
        return router(*args, **kw)

    before = k_flash.launches
    k_flash.flash_attention = spy
    try:
        got = layers.flash_attention(*card, window=40)
    finally:
        k_flash.flash_attention = router
    assert k_flash.launches == before + 1 and len(seen) == 1
    for arg, src in zip(seen[0], card):
        assert not arg.is_contiguous() and arg.data_ptr() == src.data_ptr()
    assert got.is_contiguous() and got.shape == q.shape
    again = layers.flash_attention(*card, window=40)
    assert k_flash.launches == before + 2
    assert torch.equal(again, got), _k9_misfits(again, got.float().cpu().numpy(), 0.0)
    np.testing.assert_allclose(got.float().cpu().numpy(), want, atol=atol,
                               err_msg=_k9_misfits(got, want, atol))  # fmt: skip


def test_model_attention_float32_repeats_bitwise(full_f32):
    """K9's float32 route on the model-layout case, 200 times, each time from
    new copies of the inputs on the card and into a new output, the CPU
    path's output computed anew beside it: every card output bitwise the
    first, every CPU output bitwise the first, and the first within 2e-5 of
    each other; a failure counts the runs that differ and names where their
    elements lie."""
    from repro_torch.models import layers

    (q, k, v), want = _k9_case(torch.float32)
    first = None
    differ, cpu_differ = [], []
    for i in range(200):
        got = layers.flash_attention(*(x.to(full_f32) for x in (q, k, v)), window=40)
        again = layers.flash_attention(q, k, v, window=40).numpy()
        if not np.array_equal(again, want):
            cpu_differ.append((i, float(np.abs(again - want).max())))
        if first is None:
            first = got
            np.testing.assert_allclose(got.cpu().numpy(), want, atol=2e-5,
                                       err_msg=_k9_misfits(got, want, 2e-5))  # fmt: skip
        elif not torch.equal(got, first):
            differ.append((i, _k9_misfits(got, first.cpu().numpy(), 0.0)))
    assert not cpu_differ, f"{len(cpu_differ)} of 200 CPU outputs differ: {cpu_differ[:5]}"
    assert not differ, f"{len(differ)} of 199 launches differ from the first: {differ[:5]}"


def test_model_attention_runs_k9_on_the_card(full_f32):
    """``models.layers.flash_attention`` on a CUDA tensor launches K9 once and
    equals its CPU path (the reference's chunked softmax); offsets and key
    positions, which no path of the card takes yet, raise there."""
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.models import layers

    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 100, 2, 2, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 100, 2, 32)).astype(np.float32))
            for _ in range(2))  # fmt: skip
    want = layers.flash_attention(q, k, v, window=24, chunk_q=32, chunk_k=48)
    before = k_flash.launches
    got = layers.flash_attention(*(t.to(full_f32) for t in (q, k, v)), window=24)
    assert k_flash.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-5)
    card = [t.to(full_f32) for t in (q, k, v)]
    with pytest.raises(NotImplementedError, match="q_offset"):
        layers.flash_attention(*card, q_offset=3)
    with pytest.raises(NotImplementedError, match="k_positions"):
        layers.flash_attention(*card, k_positions=torch.arange(100, device=full_f32))
    assert k_flash.launches == before + 1


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "dbrx-132b", "internvl2-76b"])
def test_moe_and_vlm_prefill_on_the_card_equals_the_cpu(full_f32, arch):
    """The reduced MoE and VLM models (internvl2 with seeded patches) in
    float32: the prefill step on the card (K9 once a layer) against the CPU
    within 1e-4 (float32 sums in other orders, logits of order 1), with the
    same experts chosen in every layer."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.models import layers, registry
    from repro_torch.serve.engine import make_prefill_step

    cfg = get_config(arch).reduced()
    on_cpu = registry.init_params(cfg, torch.Generator().manual_seed(3))
    on_card = layers.tree_map(lambda t: t.to(full_f32), on_cpu)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))}
    if cfg.n_patches:
        shape = (2, cfg.n_patches, cfg.d_model)
        batch["patches"] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    routes = {"cpu": [], "cuda": []}
    route = layers.moe_route

    def recorded(router, xt, k):
        gate, idx = route(router, xt, k)
        routes[xt.device.type].append(idx.cpu())
        return gate, idx

    step = make_prefill_step(cfg)
    layers.moe_route = recorded
    try:
        want, _ = step(on_cpu, batch)
        before = k_flash.launches
        got, _ = step(on_card, {key: t.to(full_f32) for key, t in batch.items()})
        torch.cuda.synchronize()
    finally:
        layers.moe_route = route
    assert k_flash.launches == before + cfg.n_layers
    assert len(routes["cuda"]) == len(routes["cpu"]) == (cfg.n_layers if cfg.n_experts else 0)
    for a, b in zip(routes["cuda"], routes["cpu"], strict=True):
        assert torch.equal(a, b)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b", "whisper-base"])
def test_recurrent_and_encdec_models_on_the_card_equal_the_cpu(full_f32, arch):
    """The reduced griffin, rwkv6 and whisper (seeded frames) in float32: the
    prefill step on the card (K9 once an attention layer: griffin's 2
    superblocks, whisper's 2 encoder and 2 x 4 decoder attentions, none in
    rwkv6) against the CPU within 1e-4 (float32 sums in other orders,
    logits of order 1), and ``ServeLoop``'s tokens equal, griffin's through
    its 8-slot attention ring.  Griffin's and whisper's ``wq`` and ``wk`` at
    unit spread, as their CPU tests take them."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.models import layers, registry
    from repro_torch.serve.engine import Request, ServeLoop, make_prefill_step

    cfg = get_config(arch).reduced()
    on_cpu = registry.init_params(cfg, torch.Generator().manual_seed(5))

    def unit_qk(tree):
        if "wq" in tree and "wk" in tree:
            for name in ("wq", "wk"):
                tree[name].mul_(math.sqrt(tree[name].shape[-2] / cfg.d_model))
        for sub in tree.values():
            if isinstance(sub, dict):
                unit_qk(sub)

    unit_qk(on_cpu)
    on_card = layers.tree_map(lambda t: t.to(full_f32), on_cpu)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))}
    if cfg.family == "encdec":
        shape = (2, cfg.src_len, cfg.d_model)
        batch["frames"] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    step = make_prefill_step(cfg)
    want, _ = step(on_cpu, batch)
    before = k_flash.launches
    got, _ = step(on_card, {key: t.to(full_f32) for key, t in batch.items()})
    torch.cuda.synchronize()
    assert k_flash.launches == before + registry.attention_calls(cfg)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, n).astype(np.int32), max_new=6)
            for i, n in enumerate([5, 12, 0, 9, 3])]  # fmt: skip
    tokens = ServeLoop(cfg, on_card, 4, 24, device=full_f32).run(reqs)
    assert tokens == ServeLoop(cfg, on_cpu, 4, 24, device="cpu").run(reqs)


def test_model_attention_on_the_card_refuses_offsets_and_key_positions(cuda):
    """The card route takes the models' call only (``q_offset`` 0, no key
    positions), and says so, citing ``ROADMAP.md`` queue 1, item 8."""
    from repro_torch.models import layers

    q = torch.zeros((1, 8, 1, 2, 16), device=cuda)
    k = torch.zeros((1, 8, 1, 16), device=cuda)
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        layers.flash_attention(q, k, k, q_offset=3)
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        layers.flash_attention(q, k, k, k_positions=torch.arange(8, device=cuda))


def test_mixed_dtype_attention_runs_k9_in_the_wider_dtype(full_f32):
    """whisper's bf16 queries on float32 encoder keys and values (float32
    frames over bf16 weights): one K9 launch in float32 and a bf16 output
    that equals the CPU path's (the reference's promotion) within bf16's
    rounding of outputs of order 1 (2e-2); and the encoder on such frames
    equals the CPU's within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.models import layers, registry, whisper

    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((2, 20, 2, 2, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 16)).astype(np.float32))
            for _ in range(2))  # fmt: skip
    q = q.to(torch.bfloat16)
    want = layers.flash_attention(q, k, v, causal=False)
    before = k_flash.launches
    got = layers.flash_attention(q.to(full_f32), k.to(full_f32), v.to(full_f32), causal=False)
    torch.cuda.synchronize()
    assert k_flash.launches == before + 1 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), atol=2e-2)

    cfg = get_config("whisper-base").reduced()
    on_cpu = registry.init_params(cfg, torch.Generator().manual_seed(6), torch.bfloat16)
    on_card = layers.tree_map(lambda t: t.to(full_f32), on_cpu)
    frames = torch.from_numpy(rng.standard_normal((2, cfg.src_len, cfg.d_model)).astype(np.float32))
    want = whisper.encode(cfg, on_cpu, frames)
    got = whisper.encode(cfg, on_card, frames.to(full_f32))
    assert got.dtype == want.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)


# K9's float32 tolerance (2e-5 on outputs of order 1) carried through the
# layers above it into the gradients, relative to each gradient's largest
# entry: the CPU path with noise of that size on every attention output moves
# the reduced qwen3-4b's gradients by 1.2e-5 of their largest entry
MODEL_GRAD_RTOL = 1e-4


def _attention_grads(cfg, params, tokens, labels, plain: bool):
    """The loss of ``transformer.forward`` and its gradient with respect to
    every layer's ``wq``, ``wk`` and ``wv`` (None where none reaches one);
    with ``plain`` the model's attention runs the chunked softmax
    (``layers._chunked_attention``) under autograd on the card instead of
    ``K9Attention``, so neither K9 nor ``attention_vjp`` is on that side."""
    import torch.nn.functional as F

    from repro_torch.models import layers, transformer

    def chunked(q, k, v, *, causal=True, window=0, q_offset=0, k_positions=None,
                chunk_q=512, chunk_k=512, softmax_scale=None):  # fmt: skip
        scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
        return layers._chunked_attention(q, k, v, causal, int(window), int(q_offset),
                                         k_positions, chunk_q, chunk_k, scale)  # fmt: skip

    attn = params["blocks"]["attn"]
    watched = {name: w.detach().requires_grad_() for name, w in attn.items()}
    model = dict(params, blocks=dict(params["blocks"], attn=watched))
    router = layers.flash_attention
    if plain:
        layers.flash_attention = chunked
    try:
        logits, _ = transformer.forward(cfg, model, {"tokens": tokens})
        loss = F.cross_entropy(logits.reshape(-1, cfg.vocab).float(), labels.reshape(-1).long())
        names = ("wq", "wk", "wv")
        grads = torch.autograd.grad(loss, [watched[n] for n in names], allow_unused=True)
    finally:
        layers.flash_attention = router
    return loss.detach(), dict(zip(names, grads, strict=True))


def test_attention_on_the_card_carries_its_gradient(full_f32):
    """One step's gradients of the reduced qwen3-4b (float32, remat on) on
    the card: every layer's ``wq``, ``wk`` and ``wv`` get a non-zero
    gradient through K9's attention (``K9Attention``: K9 forward,
    ``attention_vjp`` backward), within ``MODEL_GRAD_RTOL`` of the same
    model's with autograd through the chunked attention on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_map

    cfg = get_config("qwen3-4b").reduced()
    params = tree_map(lambda t: t.to(full_f32),
                      registry.init_params(cfg, torch.Generator().manual_seed(0)))  # fmt: skip
    toks = torch.from_numpy(np.random.default_rng(12).integers(0, cfg.vocab, (2, 97))).to(full_f32)
    before = k_flash.launches
    loss, got = _attention_grads(cfg, params, toks[:, :-1], toks[:, 1:], plain=False)
    assert k_flash.launches - before >= cfg.n_layers
    launched = k_flash.launches
    want_loss, want = _attention_grads(cfg, params, toks[:, :-1], toks[:, 1:], plain=True)
    assert k_flash.launches == launched
    assert abs(float(loss) - float(want_loss)) <= 1e-5
    for name, w in want.items():
        g = got[name]
        assert g is not None, f"no gradient reaches {name} through attention on the card"
        assert bool(g.isfinite().all()), name
        for layer in range(cfg.n_layers):
            assert float(g[layer].abs().max()) > 0, (name, layer)
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   atol=MODEL_GRAD_RTOL * scale, err_msg=name)  # fmt: skip


@pytest.mark.parametrize("window,causal", [(0, True), (40, True), (0, False)])
def test_k9_attention_gradients_match_the_plain_route(full_f32, window, causal):
    """``layers.flash_attention`` on the card under autograd (``K9Attention``):
    one K9 launch, an output with a ``grad_fn`` within 2e-5 of the plain
    version, and gradients for q, k and v within 2e-5 of their largest
    entry of autograd through K9's plain version (the direct softmax) on the
    same inputs; in bfloat16 too, the output keeps its ``grad_fn``."""
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.models import layers

    rng = np.random.default_rng(13)
    b, s, kvh, g, d = 2, 300, 2, 2, 64

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(full_f32)

    q, k, v = t((b, s, kvh, g, d)), t((b, s, kvh, d)), t((b, s, kvh, d))
    dout = t((b, s, kvh, g, d))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = k_flash.launches
    out = layers.flash_attention(*leaves, window=window, causal=causal)
    assert k_flash.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, dout)
    assert k_flash.launches == before + 1  # the backward pass launches nothing

    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    qh = plain[0].reshape(b, s, kvh * g, d).transpose(1, 2)
    kh, vh = (x.transpose(1, 2) for x in plain[1:])
    want_out = k_flash.flash_attention_plain(qh, kh, vh, window=window, causal=causal)
    want_out = want_out.transpose(1, 2).reshape(b, s, kvh, g, d)
    want = torch.autograd.grad(want_out, plain, dout)
    np.testing.assert_allclose(out.detach().cpu().numpy(), want_out.detach().cpu().numpy(),
                               atol=2e-5)  # fmt: skip
    for name, a, w in zip("qkv", got, want, strict=True):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(),
                                   atol=2e-5 * float(w.abs().max()), err_msg=name)  # fmt: skip

    half = [x.to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    out16 = layers.flash_attention(*half, window=window, causal=causal)
    assert out16.grad_fn is not None and k_flash.launches == before + 2
    grads16 = torch.autograd.grad(out16, half, dout.to(torch.bfloat16))
    assert all(x.dtype == torch.bfloat16 and bool(x.isfinite().all()) for x in grads16)


# ---------------------------------------------------------------------------
# the replicated KV tier on the card
# ---------------------------------------------------------------------------
def _kv_schedule(dev) -> dict:
    """Sessions over ``ReplicatedKV`` on a grouped context at the defaults
    (persistent waves, snapshots): puts, deletes and cas, a read-index get
    after a pending write, leased gets, a compaction, a retire and a create."""
    from repro_torch.serve.kv import ReplicatedKV
    from repro_torch.serve.service import ConsensusService

    cfg = PaxosConfig(n_acceptors=3, n_instances=256, batch=8, n_groups=3)
    ctx = PaxosContext(cfg, snapshots=True, device=dev)
    svc = ConsensusService(ctx)
    kv = ReplicatedKV(svc)
    rng = np.random.default_rng(11)
    sids = [f"user-{i}" for i in range(12)]
    answers, seals = [], []
    for w in range(6):
        for i, sid in enumerate(sids):
            s = kv.session(sid)
            for _ in range(int(rng.integers(1, 5))):
                key = b"k%d" % int(rng.integers(3))
                r = rng.random()
                if r < 0.5:
                    s.put(key, b"%s:%d" % (sid.encode(), w))
                elif r < 0.7:
                    s.delete(key)
                else:
                    s.cas(key, None if r < 0.8 else b"%s:%d" % (sid.encode(), w - 1), b"c%d" % w)
        s = kv.session(sids[0])
        s.put(b"k0", b"probe%d" % w)
        answers.append(s.get(b"k0"))  # a pending write: one read-index op
        svc.run_until_quiescent()
        answers += [kv.session(sid).get(b"k%d" % (i % 3)) for i, sid in enumerate(sids)]
        if w == 2:
            seals += [ctx.snapshot_group(gid).seal for gid in ctx.live_groups()]
            svc.retire_group(svc.group_of(sids[1]))
        if w == 4:
            svc.create_group()
    return dict(
        logs=[ctx.full_group_log(gid) for gid in range(cfg.n_groups)],
        signatures={key: rep.signature() for key, rep in kv._replicas.items()},
        answers=answers,
        stats=dict(kv.stats),
        dispatch_count=ctx.hw.dispatch_count,
        seals=seals,
        report=svc.plan_report(),
        state=export_state(ctx.hw),
    )


def test_replicated_kv_on_the_card_equals_the_cpu(cuda):
    """The same KV schedule on the card (K5, K1's cohort form, K4) and on
    the CPU (their plain versions): logs, every replica, every answer, the
    tier's stats, the dispatch count, seals, the plan and the slabs."""
    for name in ("persistent_launches", "cohort_launches"):
        setattr(k_wirepath, name, 0)
    k_digest.launches = 0
    got = _kv_schedule(cuda)
    assert k_wirepath.persistent_launches > 0 and k_wirepath.cohort_launches > 0
    assert k_digest.launches == len(got["seals"]) > 0
    want = _kv_schedule(torch.device("cpu"))
    for key in ("logs", "signatures", "answers", "stats", "dispatch_count", "seals", "report"):
        assert got[key] == want[key], key
    for key, arr in want["state"].items():
        np.testing.assert_array_equal(got["state"][key], arr, err_msg=key)
    assert got["stats"]["leased_gets"] and got["stats"]["read_index_gets"] >= 6


def test_contracts_hold_on_the_card(cuda):
    """BIND-ARITY on the built libraries (every binding made on the real
    ``ctypes`` functions, 12 entries bound right) and STATE-INPLACE through
    every state entry on the card, each launching its kernel."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import _build

    violations, bound = contracts.check_bindings(contracts._default_root(), _build.library)
    assert violations == [] and bound == 12, violations
    names = ("launches", "cohort_launches", "shard_launches", "packed_launches",
             "persistent_launches", "vote_all_launches")  # fmt: skip
    before = [getattr(k_wirepath, n) for n in names] + [k_acceptor.launches]
    violations, ran = contracts.check_inplace(cuda, a=3, n=4096, v=16, b=128, g=8)
    torch.cuda.synchronize()
    assert violations == [] and ran == 8, violations
    after = [getattr(k_wirepath, n) for n in names] + [k_acceptor.launches]
    assert all(x > y for x, y in zip(after, before, strict=True)), (before, after)


def test_fabric_consensus_on_the_card_equals_the_plain_rounds(cuda):
    """``core.fabric.make_fabric_consensus`` in a world of one on NCCL, a
    (1,) mesh, over 48 rounds of 128 on a 4,096-slot ring (it laps): every
    round launches K3 and K7 once, and its ``decided``, ``inst`` and
    ``value`` and the final registers equal the same rounds through the
    plain sequencer and vote on the CPU, with a dead stretch, rounds at a
    lower ``crnd`` than the slots' promise (rejected) and a higher one
    after; ``quorum_commit_digest`` on the card too."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.fabric import make_fabric_consensus, quorum_commit_digest
    from repro_torch.core.types import MSG_P2B
    from repro_torch.launch.mesh import ensure_process_group

    n, v, b, rounds = 4096, 16, 128, 48
    rng = np.random.default_rng(35)
    values = rng.integers(I32_MIN, I32_MAX, (rounds, b, v), endpoint=True).astype(np.int32)
    active = rng.random((rounds, b)) < 0.8
    alive = np.ones(rounds, bool)
    alive[10:14] = False
    crnd = [2] * 32 + [1] * 8 + [3] * 8  # the second lap meets promises of round 2
    owned = not dist.is_initialized()
    ensure_process_group(cuda)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("acc",))
        init_fn, step = make_fabric_consensus(mesh, axis="acc", n_instances=n, value_words=v)
        astate, cstate = init_fn()
        before = (k_coordinator.launches, k_acceptor.launches)
        got = []
        for r in range(rounds):
            c = torch.tensor(crnd[r], dtype=torch.int32, device=cuda)
            astate, cstate, *out = step(
                astate, CoordinatorState(cstate.next_inst, c),
                torch.from_numpy(values[r]).to(cuda), torch.from_numpy(active[r]).to(cuda),
                torch.tensor([bool(alive[r])], device=cuda),
            )  # fmt: skip
            got.append([x.to_local().cpu().numpy() for x in out])
        launches = (k_coordinator.launches - before[0], k_acceptor.launches - before[1])
        regs = [x.to_local()[0].cpu().numpy() for x in vars(astate).values()]
        d = torch.tensor([7, -8], dtype=torch.int32, device=cuda)
        commit, win = quorum_commit_digest(d, torch.tensor(True, device=cuda), axis="acc",
                                           quorum=1, mesh=mesh)  # fmt: skip
        commit, win = bool(commit), int(win)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    assert launches == (rounds, rounds) and (commit, win) == (True, 1)
    st, cs = AcceptorState.init(n, v, "cpu"), CoordinatorState.init()
    for r in range(rounds):
        cs = CoordinatorState(cs.next_inst, torch.tensor(crnd[r], dtype=torch.int32))
        cs, p2a = batched.coordinator_sequence(
            cs, torch.from_numpy(values[r]), torch.from_numpy(active[r])
        )
        _, votes = batched.acceptor_phase2(st, p2a, 0)
        decided = ((votes.msgtype == MSG_P2B) & bool(alive[r])).numpy()
        for x, y in zip(got[r], (decided, p2a.inst.numpy(), values[r]), strict=True):
            np.testing.assert_array_equal(x, y, err_msg=f"round {r}")
        assert decided.all() if alive[r] and crnd[r] != 1 else not decided.any(), r
    for x, y in zip(regs, vars(st).values(), strict=True):
        np.testing.assert_array_equal(x, y.numpy())


def test_meshed_train_step_on_the_card_matches_the_unmeshed(full_f32):
    """Two train steps of the reduced qwen3-4b (float32) on a (1, 1)
    ``make_host_mesh()`` over NCCL in a world of one, state and batches
    placed as DTensors by ``BASE_RULES`` and the activation sharder
    installed, against the same steps unmeshed: losses within 1e-3
    relative, the sharder taken, K9 launched through ``local_map``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import train_loop

    cfg = get_config("qwen3-4b").reduced()
    toks = np.random.default_rng(21).integers(0, cfg.vocab, (2, 4, 65)).astype(np.int32)
    batches = [{"tokens": torch.from_numpy(t[:, :-1]).to(full_f32),
                "labels": torch.from_numpy(t[:, 1:]).to(full_f32)} for t in toks]  # fmt: skip

    def losses(place=lambda t: t, place_batch=lambda b: b):
        state = place(train_loop.init_state(cfg, torch.Generator(device=full_f32).manual_seed(3)))
        step, out = train_loop.make_train_step(cfg), []
        for batch in batches:
            state, m = step(state, place_batch(batch))
            out.append(float(m["loss"]))
        return out

    want = losses()
    owned = not dist.is_initialized()
    try:
        mesh = make_host_mesh(device=full_f32)
        rules = sh.BASE_RULES
        ssh = sh.tree_shardings(train_loop.state_shapes(cfg), train_loop.state_axes(cfg), rules,
                                mesh)  # fmt: skip
        bsh = sh.batch_shardings(batches[0], cfg, rules, mesh)
        sh.calls, before = 0, k_flash.launches
        with sh.use_rules(mesh, rules):
            got = losses(lambda s: sh.place_tree(s, ssh),
                         lambda b: {k: bsh[k].place(v) for k, v in b.items()})  # fmt: skip
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
        assert sh.calls > 0 and k_flash.launches - before >= 2 * cfg.n_layers
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    for a, b in zip(got, want, strict=True):
        assert abs(a - b) <= 1e-3 * abs(b), (got, want)
