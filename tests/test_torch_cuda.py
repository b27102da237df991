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

from repro_torch.core import PaxosConfig, PaxosContext, SimNet, FaultSpec  # noqa: E402
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
