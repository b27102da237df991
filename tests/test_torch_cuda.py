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
from repro_torch.core.types import AcceptorState, CoordinatorState  # noqa: E402
from repro_torch.kernels import digest as k_digest  # noqa: E402
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


def test_staged_kernels_raise_on_the_card(cuda):
    hw = PaxosContext(PaxosConfig(n_instances=1024, batch=16), device=cuda).hw
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hw.sequence(np.zeros((16, 16), np.int32), np.ones(16, bool))


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
