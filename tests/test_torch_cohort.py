"""K1 in its multi-group and cohort forms: the port's plain versions against
the reference, bit for bit.

``batched.cohort_fused_round`` (reached through ``kernels.ops``, which routes
CPU tensors to it) is held against the reference's Pallas kernel
``cohort_wirepath_round`` in interpret mode, at G=4 and GB in {1, 2, G},
with gsel a single block, a subset and all blocks, inert members inside
folded blocks at divergent watermarks (the reference substitutes the
block's base for them; the port leaves them untouched), dead acceptors, a
frozen group, a reclaim limit inside a window and one that wrapped past
int32 max, and a window that crosses 2**31 (the int32 wrap of ``ni +
lane``, addressed with the floored modulo).  ``multigroup_fused_round`` is
held against the reference's kernel entry and its jnp oracle, the latter at
a window base no block divides.  Tolerance: none, every int32 equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import CoordinatorState as RCoord  # noqa: E402
from repro.core import batched as rbatched  # noqa: E402
from repro.core.batched import LearnerState as RLearner  # noqa: E402
from repro.core.types import AcceptorState as RAcc  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import wirepath as rwp  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.types import AcceptorState, CoordinatorState  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wirepath as k_wirepath  # noqa: E402

G, A, N, V = 4, 3, 512, 4
I32 = 2**31
CROSS = I32 - 128  # a 256-lane window from here crosses 2**31


def _slabs(rng, g, b, bases, top, v=V):
    """Protocol-valid random ``(G, ...)`` slabs as numpy: promises straddle
    the rounds, and part of each learner ring holds its window (dups)."""
    linst = rng.integers(-1, 1 << 20, (g, N), dtype=np.int32)
    for gi, base in enumerate(bases):
        inst = ((np.int64(base) + np.arange(b) + I32) % 2**32 - I32).astype(np.int32)
        dup = rng.random(b) < 0.3
        linst[gi, inst[dup].astype(np.int64) % N] = inst[dup]
    return [
        rng.integers(0, top, (g, A, N), dtype=np.int32),
        rng.integers(-1, top, (g, A, N), dtype=np.int32),
        rng.integers(-I32, I32, (g, A, N, v), dtype=np.int32),
        rng.integers(0, 2, (g, N), dtype=np.int32),
        linst,
        rng.integers(-I32, I32, (g, N, v), dtype=np.int32),
    ]


def _t(x, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _port_state(slabs):
    t = [_t(x) for x in slabs]
    return AcceptorState(*t[:3]), batched.LearnerState(*t[3:])


def _flat(stack, lstate):
    return [x.numpy() for x in (*vars(stack).values(), *vars(lstate).values())]


# (group_block, gsel, per-group bases, enabled): enabled members of a block
# share its base; an inert member sits at a divergent base
CASES = {
    "gb1-single": (1, [2], [0, CROSS, 1664, -I32], [1, 1, 1, 1]),
    "gb1-subset": (1, [0, 3], [0, CROSS, 1664, -I32], [1, 1, 1, 0]),
    "gb1-all": (1, [0, 1, 2, 3], [0, CROSS, 1664, -I32], [1, 1, 0, 1]),
    "gb2-single": (2, [1], [0, CROSS, 1664, 1664], [1, 1, 1, 1]),
    "gb2-inert-member": (2, [0], [CROSS, 7 * N + 5, 1664, 1664], [1, 0, 1, 1]),
    "gb2-all": (2, [0, 1], [CROSS, CROSS, -I32, 3 * N + 99], [1, 1, 1, 0]),
    "gbG-all": (4, [0], [CROSS, CROSS, 11, CROSS], [1, 1, 0, 1]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cohort_round_matches_tpu_kernel(name):
    _cohort_matches_tpu_kernel(name, V)


@pytest.mark.parametrize("name", ["gb1-all", "gb2-inert-member", "gbG-all"])
def test_cohort_round_matches_tpu_kernel_at_v5(name):
    """The same at V = 5, where the card's kernel takes its scalar variant."""
    _cohort_matches_tpu_kernel(name, 5)


def _cohort_matches_tpu_kernel(name, v):
    gb, gsel, bases, enabled = CASES[name]
    b = 256  # two 128-lane blocks of the reference kernel
    rng = np.random.default_rng(sorted(CASES).index(name))
    crnd = rng.integers(1, 7, G).astype(np.int32)
    crnd[2] = -1 if name.endswith("all") else crnd[2]  # a frozen group
    alive = np.ones((G, A), bool)
    alive[0, 1] = False  # a dead acceptor: still a quorum
    alive[3, [0, 2]] = False  # below quorum: nothing decides
    marks = np.array([0, I32 - 200, 0, 0], np.int32)
    limit = marks + N  # group 1's limit wraps negative, as the reference computes it
    limit[2] = np.int32(bases[2] + 100)  # refuses the window's upper lanes
    assert limit[1] < 0
    slabs = _slabs(rng, G, b, bases, int(crnd.max()) + 3, v)
    values = rng.integers(-I32, I32, (len(gsel) * gb, b, v), dtype=np.int32)
    want = rwp.cohort_wirepath_round(
        jnp.asarray(gsel, jnp.int32), jnp.asarray(np.asarray(bases, np.int64).astype(np.int32)),
        jnp.asarray(crnd), jnp.int32(2), jnp.asarray(alive, jnp.int32),
        *(jnp.asarray(x) for x in slabs), jnp.asarray(values),
        jnp.asarray(enabled, jnp.int32), jnp.asarray(limit),
        group_block=gb, interpret=True,
    )  # fmt: skip
    stack, lstate = _port_state(slabs)
    ni = _t(np.asarray(bases, np.int64).astype(np.int32))
    _, _, fresh, win, value = ops.cohort_fused_round(
        stack, lstate, gsel, ni, _t(crnd), _t(alive, torch.bool), 2, _t(values), enabled, limit,
        group_block=gb,
    )  # fmt: skip
    have = [*_flat(stack, lstate), fresh.numpy().astype(np.int32), win.numpy(), value.numpy()]
    for w, h, what in zip(want, have, ("rnd", "vrnd", "val", "ldel", "linst", "lval",
                                       "fresh", "win", "value"), strict=True):  # fmt: skip
        np.testing.assert_array_equal(h, np.asarray(w), err_msg=what)
    if name == "gb1-all":  # the crossing window under the wrapped limit
        lanes = np.asarray(want[6])[1]
        assert not lanes[:128].any() and lanes[128:].any()


@pytest.mark.parametrize("gb", [1, 2, 4])
def test_multigroup_round_matches_tpu_kernel_entry(gb):
    """``ops.multigroup_fused_round`` against the reference's kernel entry
    (every block selected), groups in lockstep per block, one disabled."""
    b = 128
    rng = np.random.default_rng(10 + gb)
    bases = {1: [0, 256, 3 * N, CROSS], 2: [256, 256, 640, 640], 4: [640] * 4}[gb]
    enabled = np.array([1, 1, 0, 1], np.int32)
    crnd = rng.integers(1, 7, G).astype(np.int32)
    alive = np.ones((G, A), bool)
    alive[1, 2] = False
    limit = np.array([0, 0, 0, I32 - 100], np.int32) + N
    slabs = _slabs(rng, G, b, bases, 9)
    values = rng.integers(-I32, I32, (G, b, V), dtype=np.int32)
    ni = np.asarray(bases, np.int32)
    r_c, r_st, r_ls, *r_out = rops.multigroup_fused_round(
        RCoord(jnp.asarray(ni), jnp.asarray(crnd)), RAcc(*(jnp.asarray(x) for x in slabs[:3])),
        RLearner(*(jnp.asarray(x) for x in slabs[3:])), jnp.asarray(values),
        jnp.ones((G, b), bool), jnp.asarray(alive), 2, jnp.asarray(enabled), jnp.asarray(limit),
        group_block=gb,
    )  # fmt: skip
    stack, lstate = _port_state(slabs)
    t_c, _, _, *t_out = ops.multigroup_fused_round(
        CoordinatorState(_t(ni), _t(crnd)), stack, lstate, _t(values),
        torch.ones((G, b), dtype=torch.bool), _t(alive, torch.bool), 2, enabled, limit,
        group_block=gb,
    )  # fmt: skip
    want = [np.asarray(r_c.next_inst), *(np.asarray(x) for x in (*vars(r_st).values(),
            *vars(r_ls).values())), *(np.asarray(x) for x in r_out)]  # fmt: skip
    have = [t_c.next_inst.numpy(), *_flat(stack, lstate), *(x.numpy() for x in t_out)]
    for w, h in zip(want, have, strict=True):
        np.testing.assert_array_equal(h, w)
    assert not have[7][3].any()  # group 3's wrapped limit refuses every lane


@pytest.mark.parametrize("base", [I32 - 8, 1003, 2 * N - 5])
def test_multigroup_round_matches_jnp_oracle_at_any_base(base):
    """``batched.multigroup_fused_round`` against the reference's jnp oracle
    at window bases no block divides, one across 2**31, with an enabled
    mask and a wrapped limit; the returned round is the presented one."""
    b = 16
    rng = np.random.default_rng(base % 97)
    bases = [base, base + 3, 0, 77]
    enabled = np.array([1, 0, 1, 1], np.int32)
    crnd = rng.integers(1, 7, G).astype(np.int32)
    alive = np.ones((G, A), bool)
    alive[2, 0] = False
    limit = np.array([0, 0, I32 - 10, 0], np.int32) + N
    slabs = _slabs(rng, G, b, bases, 9)
    values = rng.integers(-I32, I32, (G, b, V), dtype=np.int32)
    active = rng.random((G, b)) < 0.7
    ni = np.asarray(bases, np.int64).astype(np.int32)
    r_c, r_st, r_ls, *r_out = rbatched.multigroup_fused_round(
        RCoord(jnp.asarray(ni), jnp.asarray(crnd)), RAcc(*(jnp.asarray(x) for x in slabs[:3])),
        RLearner(*(jnp.asarray(x) for x in slabs[3:])), jnp.asarray(values), jnp.asarray(active),
        jnp.asarray(alive), 2, jnp.asarray(enabled), jnp.asarray(limit),
    )  # fmt: skip
    stack, lstate = _port_state(slabs)
    t_c, _, _, *t_out = batched.multigroup_fused_round(
        CoordinatorState(_t(ni), _t(crnd)), stack, lstate, _t(values), _t(active, torch.bool),
        _t(alive, torch.bool), 2, enabled, limit,
    )  # fmt: skip
    r_leaves = (*vars(r_st).values(), *vars(r_ls).values(), *r_out)
    want = [np.asarray(r_c.next_inst), np.asarray(r_c.crnd), *(np.asarray(x) for x in r_leaves)]
    have = [t_c.next_inst.numpy(), t_c.crnd.numpy(), *_flat(stack, lstate),
            *(x.numpy() for x in t_out)]  # fmt: skip
    for w, h in zip(want, have, strict=True):
        np.testing.assert_array_equal(h, w)


def test_cohort_gsel_must_be_distinct_and_in_range():
    """Two rows on one group would race in place on the card: the wrapper
    refuses such a selection before it launches."""
    assert k_wirepath._host_gsel([3, 0], 4).tolist() == [3, 0]
    for bad in ([0, 0], [4], [-1], []):
        with pytest.raises(ValueError, match="distinct"):
            k_wirepath._host_gsel(bad, 4)


def test_cohort_wrapper_launches_only_on_the_card():
    stack, lstate = _port_state(_slabs(np.random.default_rng(0), G, 8, [0] * G, 3))
    i32 = torch.zeros(G, dtype=torch.int32)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        k_wirepath.cohort_wirepath_round(
            [0], i32, i32, 2, torch.ones((G, A), dtype=torch.bool), *vars(stack).values(),
            *vars(lstate).values(), torch.zeros((1, 8, V), dtype=torch.int32),
        )  # fmt: skip
