"""The port's fused round (``kernels.ops.fused_round``) against the TPU
kernel's reference, run as the reference's own tests run it.

On CPU tensors ``ops.fused_round`` runs the kernel's plain version; here it
is held against ``repro.kernels.wirepath.wirepath_round(..., interpret=True)``
over several consecutive rounds, and all nine outputs (six state tensors,
fresh, win, value) must match bit for bit.  The state must be updated in
place: the tensors keep their storage across rounds.  The same cases run at
V = 5 (no multiple of 4: the card's kernel takes its scalar variant there),
so the plain version the card is held against is proved at such a V too.
``lane_geometry``, the host's choice of K1's and K6's launch, is pinned here.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import wirepath as rwire  # noqa: E402
from repro_torch.core import batched as tb  # noqa: E402
from repro_torch.core import types as tt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import wirepath as twire  # noqa: E402

N, V, BB = 1024, 8, 8  # BB: the reference kernel's batch block here
I32_MIN, I32_MAX = -(2**31), 2**31 - 1

CASES = [
    # (alive, base, crnd, limit offset from base or None, burst); the
    # reference kernel needs BB-aligned bases, the port takes any
    ([1, 1, 1], 0, 0, None, 8),
    ([1, 1, 1], 8 * 37, 3, None, 128),
    ([1, 1, 1], N - 8, 5, None, 16),  # crosses the ring end
    ([1, 0, 1], 2 * N + 64, 6, None, 32),  # a dead acceptor, still a quorum
    ([0, 0, 1], 4 * N - 64, 6, None, 128),  # below the quorum
    ([1, 1, 1], 1000, 7, 13, 64),  # reclaim limit inside the window
    ([1, 1, 1], 512, -1, None, 8),  # NO_ROUND
    ([1, 1, 1, 1, 1], N - 16, 9, None, 32),
    ([1, 0, 1, 0, 1], 3 * N + 8, 2, 30, 128),  # A=5 at the boundary, limit
]


@pytest.mark.parametrize("alive,base,crnd,lim,b", CASES)
def test_fused_round_matches_tpu_kernel_interpret(alive, base, crnd, lim, b):
    _rounds_match_tpu_kernel(alive, base, crnd, lim, b, V)


@pytest.mark.parametrize("alive,base,crnd,lim,b", CASES[1::2])
def test_fused_round_matches_tpu_kernel_interpret_at_v5(alive, base, crnd, lim, b):
    _rounds_match_tpu_kernel(alive, base, crnd, lim, b, 5)


def _rounds_match_tpu_kernel(alive, base, crnd, lim, b, v):
    a = len(alive)
    rng = np.random.default_rng([a, base, crnd + 1, b, 7])
    s = dict(
        rnd=rng.integers(0, 10, (a, N), dtype=np.int32),
        vrnd=rng.integers(-1, 10, (a, N), dtype=np.int32),
        val=rng.integers(I32_MIN, I32_MAX, (a, N, v), dtype=np.int32, endpoint=True),
        ldel=rng.integers(0, 2, (N,), dtype=np.int32),
        linst=rng.integers(-1, 8 * N, (N,), dtype=np.int32),
        lval=rng.integers(I32_MIN, I32_MAX, (N, v), dtype=np.int32, endpoint=True),
    )
    rounds = 3
    inst = base + np.arange(rounds * b)
    s["linst"][inst[::4] % N] = inst[::4]  # duplicates in the learner ring
    ref = [jnp.asarray(s[k]) for k in ("rnd", "vrnd", "val", "ldel", "linst", "lval")]
    stack = tt.AcceptorState(*(torch.from_numpy(s[k].copy()) for k in ("rnd", "vrnd", "val")))
    lstate = tb.LearnerState(*(torch.from_numpy(s[k].copy()) for k in ("ldel", "linst", "lval")))
    cstate = tt.CoordinatorState.init(crnd, base)
    alv = np.asarray(alive, bool)
    ptrs = [t.data_ptr() for t in (*vars(stack).values(), *vars(lstate).values())]
    limit = None if lim is None else base + lim
    for r in range(rounds):
        vals = rng.integers(I32_MIN, I32_MAX, (b, v), dtype=np.int32, endpoint=True)
        want = rwire.wirepath_round(
            jnp.int32(base + r * b),
            jnp.int32(crnd),
            jnp.int32(a // 2 + 1),
            jnp.asarray(alv.astype(np.int32)),
            *ref,
            jnp.asarray(vals),
            None if limit is None else jnp.int32(limit),
            block_b=BB,
            interpret=True,
        )
        ref = list(want[:6])
        cstate, stack, lstate, fresh, inst_out, win, value = tops.fused_round(
            cstate,
            stack,
            lstate,
            torch.from_numpy(vals),
            torch.ones(b, dtype=torch.bool),
            torch.from_numpy(alv),
            a // 2 + 1,
            limit,
        )
        got = [*vars(stack).values(), *vars(lstate).values(), fresh.to(torch.int32), win, value]
        for w, g in zip(want, got, strict=True):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        np.testing.assert_array_equal(inst_out.numpy(), base + r * b + np.arange(b))
        assert int(cstate.next_inst) == base + (r + 1) * b
        assert [t.data_ptr() for t in (*vars(stack).values(), *vars(lstate).values())] == ptrs


def test_kernel_wrapper_refuses_cpu_tensors():
    """On CPU tensors only the dispatch's plain version runs: the kernel's
    own wrapper raises instead of computing anything."""
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        twire.wirepath_round(
            z((), dtype=torch.int32), z((), dtype=torch.int32), 2, torch.ones(3, dtype=torch.bool),
            z((3, 16), dtype=torch.int32), z((3, 16), dtype=torch.int32),
            z((3, 16, 4), dtype=torch.int32), z(16, dtype=torch.int32),
            z(16, dtype=torch.int32), z((16, 4), dtype=torch.int32), z((8, 4), dtype=torch.int32),
        )  # fmt: skip


# (V, B, rows, aligned, LANE_THREADS) -> (variant, team, grid): a team is the
# power of two at or above the lane's words (int4 where aligned and V % 4 ==
# 0, else int32), at most 32; a block holds threads // team lanes
GEOMETRY = [
    ((16, 128, 1, True, 128), ("vector", 4, (4, 1))),  # the paths' V: G=1 on 4 SMs
    ((16, 128, 1, True, 64), ("vector", 4, (8, 1))),
    ((16, 128, 8, True, 128), ("vector", 4, (4, 8))),  # cohort G=8, K6 C=8
    ((16, 128, 1, False, 128), ("scalar", 16, (16, 1))),  # a view 4 bytes off 16
    ((5, 128, 1, True, 128), ("scalar", 8, (8, 1))),
    ((1, 128, 4, True, 64), ("scalar", 1, (2, 4))),
    ((4, 300, 2, True, 128), ("vector", 1, (3, 2))),
    ((12, 16, 1, True, 64), ("vector", 4, (1, 1))),
    ((64, 128, 1, True, 128), ("vector", 16, (16, 1))),
    ((64, 128, 1, False, 128), ("scalar", 32, (32, 1))),
    ((301, 8, 3, True, 96), ("scalar", 32, (3, 3))),
    ((300, 8, 3, True, 96), ("vector", 32, (3, 3))),
]


@pytest.mark.parametrize("args,want", GEOMETRY)
def test_lane_geometry_chooses_variant_team_block_and_grid(monkeypatch, args, want):
    monkeypatch.setattr(twire, "LANE_THREADS", args[4])
    geo = twire.lane_geometry(*args[:4])
    assert (geo.variant, geo.team, geo.grid) == want
    assert geo.block == args[4] and geo.block % geo.team == 0 and 32 % geo.team == 0


def test_lane_geometry_reads_alignment_from_the_tensors(monkeypatch):
    """The wrapper's choice from ``data_ptr() % 16``: every value tensor on
    16 bytes gives the vector variant, one contiguous view 4 bytes off
    gives the scalar one; blocks that are not whole warps are refused."""
    b, v = 128, 16
    whole = torch.zeros((b * v + 4,), dtype=torch.int32)
    aligned = whole[: b * v].view(b, v)
    off = whole[1 : b * v + 1].view(b, v)
    assert aligned.data_ptr() % 16 == 0 and off.data_ptr() % 16 == 4 and off.is_contiguous()
    assert twire._lanes(v, b, 1, aligned, aligned).variant == "vector"
    assert twire._lanes(v, b, 1, aligned, off).variant == "scalar"
    assert twire._lanes(5, b, 1, aligned).variant == "scalar"
    for threads in (48, 16, 2048):
        monkeypatch.setattr(twire, "LANE_THREADS", threads)
        with pytest.raises(ValueError, match="whole warps"):
            twire.lane_geometry(v, b, 1, True)


# K5: (V, B, rows, K, N, aligned) -> (variant, team, grid).  The rounds are
# the grid's z extent, capped at 65,535; K * B <= N admits K = N at B = 1
WAVE_GEOMETRY = [
    ((16, 128, 8, 8, 65536, True), ("vector", 4, (4, 8, 8))),  # the defaults' wave, GB=8
    ((16, 128, 1, 8, 65536, True), ("vector", 4, (4, 1, 8))),  # one group
    ((16, 128, 8, 512, 65536, True), ("vector", 4, (4, 8, 512))),  # K * B = N
    ((16, 128, 2, 8, 65536, False), ("scalar", 16, (16, 2, 8))),  # a view 4 bytes off 16
    ((5, 16, 3, 4, 4096, True), ("scalar", 8, (1, 3, 4))),
    ((16, 1, 1, 65534, 65536, True), ("vector", 4, (1, 1, 65534))),
    ((16, 1, 1, 65535, 65536, True), ("vector", 4, (1, 1, 65535))),  # the z edge
    ((16, 1, 1, 65536, 65536, True), ("vector", 4, (1, 1, 65535))),  # one block serves 2
    ((5, 1, 2, 140_000, 1 << 18, True), ("scalar", 8, (1, 2, 65535))),
]


@pytest.mark.parametrize("args,want", WAVE_GEOMETRY)
def test_wave_geometry_spreads_rounds_over_a_3d_grid(args, want):
    geo = twire.wave_geometry(*args)
    assert (geo.variant, geo.team, geo.grid) == want
    v, b, rows, k, n, aligned = args
    flat = twire.lane_geometry(v, b, rows, aligned)
    assert (geo.variant, geo.team, geo.block, geo.grid[:2]) == (
        flat.variant, flat.team, flat.block, flat.grid
    )


@pytest.mark.parametrize("k", [1, 8, 65_534, 65_535, 65_536, 140_000, 3 * 65_535 + 1])
def test_wave_geometry_covers_every_round_once(k):
    """K5's blocks at z serve rounds z, z + gz, ... (gz the grid's z extent):
    every round of the wave exactly once, in one pass a block unless K >
    65,535."""
    gz = twire.wave_geometry(16, 1, 1, k, max(k, 16), True).grid[2]
    served = [r for z in range(gz) for r in range(z, k, gz)]
    assert len(served) == k and set(served) == set(range(k))
    assert max(len(range(z, k, gz)) for z in range(gz)) == -(-k // 65_535)


@pytest.mark.parametrize(
    "v,b,rows,k,n",
    [
        (16, 128, 8, 513, 65536),  # K * B > N: the wave would lap the ring
        (16, 1, 1, 65537, 65536),
        (16, 128, 8, 0, 65536),  # no round
        (16, 128, 0, 8, 65536),  # no row
        (16, 128, 65_536, 8, 65536),  # more rows than the grid's y extent
    ],
)
def test_wave_geometry_refuses_what_the_kernel_cannot_take(v, b, rows, k, n):
    with pytest.raises(ValueError, match="K \\* B <= N"):
        twire.wave_geometry(v, b, rows, k, n, True)


# K2: a team per (acceptor, lane) on a (lane blocks, A) grid, the variant
# from V and the alignment of the burst, st_val and the vote values
VOTE_GEOMETRY = [
    # (A, V, the tensor held 4 bytes off 16) -> (variant, team, grid)
    ((3, 16, None), ("vector", 4, (4, 3))),  # the paths' shape: 12 blocks
    ((3, 16, "msg_val"), ("scalar", 16, (16, 3))),  # a burst view 4 bytes off 16
    ((3, 16, "st_val"), ("scalar", 16, (16, 3))),
    ((3, 16, "vote_value"), ("scalar", 16, (16, 3))),
    ((5, 16, None), ("vector", 4, (4, 5))),
    ((3, 5, None), ("scalar", 8, (8, 3))),
    ((8, 1, None), ("scalar", 1, (1, 8))),
]


@pytest.mark.parametrize("args,want", VOTE_GEOMETRY)
def test_vote_geometry_from_the_tensors_alignment(args, want):
    """What K2's wrapper launches: ``_lanes`` over the burst, st_val and the
    vote values, with rows = A."""
    a, v, off = args
    b, n = 128, 1024

    def words(*shape, moved=False):
        whole = torch.zeros((int(np.prod(shape)) + 4,), dtype=torch.int32)
        x = whole[1 : 1 + int(np.prod(shape))] if moved else whole[: int(np.prod(shape))]
        return x.view(shape)

    msg_val = words(b, v, moved=off == "msg_val")
    st_val = words(a, n, v, moved=off == "st_val")
    vote_value = words(a, b, v, moved=off == "vote_value")
    assert all(t.is_contiguous() for t in (msg_val, st_val, vote_value))
    geo = twire._lanes(v, b, a, msg_val, st_val, vote_value)
    assert (geo.variant, geo.team, geo.grid) == want
    assert geo.block == twire.LANE_THREADS
