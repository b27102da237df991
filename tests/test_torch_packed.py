"""K6 (the packed shard round) and K1's shard slice: the port's plain
versions against the reference, bit for bit.

``batched.packed_multigroup_round`` and ``ops.packed_shard_round`` (whose CPU
route is that plain version) are held against the reference's jnp oracle
``batched.packed_multigroup_round`` and its Pallas kernel
``kernels.wirepath.packed_shard_round`` in interpret mode, on plain
(unsharded) arrays of one shard's slab: Gl in {2, 4}, A=3, N in {128, 256},
V in {2, 4, 5}, B=16 (and one B=32 window across the ring's end, at the
kernel's block of 16), C in {1, 2, Gl}, ragged tables with pad lanes, a dead
acceptor, laps of the ring and a limit that refuses part of a window.
``ops.shard_slab_round`` is held against the reference's
``shard_slab_round`` at offsets 0 and Gl of a G = 2 Gl vector, at V in
{2, 5}.  V = 5 is no multiple of 4, where the card's kernels take their
scalar variant.  Tolerance:
none, every int32 equal.  Inputs come from a numpy seed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batched as rbatched  # noqa: E402
from repro.core.batched import LearnerState as RLearner  # noqa: E402
from repro.core.types import AcceptorState as RAcc  # noqa: E402
from repro.kernels import wirepath as rwp  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.types import AcceptorState  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wirepath as k_wirepath  # noqa: E402

A, Q = 3, 2
I32 = 2**31
FIELDS = ("rnd", "vrnd", "val", "ldel", "linst", "lval", "fresh", "win", "value")


def _slabs(rng, gl, n, v, top):
    """Random protocol-valid ``(Gl, ...)`` slabs as numpy: promises straddle
    the rounds; part of each learner ring holds instances of every lap."""
    linst = rng.integers(-1, 8 * n, (gl, n), dtype=np.int32)
    return [
        rng.integers(0, top, (gl, A, n), dtype=np.int32),
        rng.integers(-1, top, (gl, A, n), dtype=np.int32),
        rng.integers(-I32, I32, (gl, A, n, v), dtype=np.int32),
        rng.integers(0, 2, (gl, n), dtype=np.int32),
        linst,
        rng.integers(-I32, I32, (gl, n, v), dtype=np.int32),
    ]


def _t(x, dtype=torch.int32):
    return torch.from_numpy(np.array(x)).to(dtype)  # a copy: the state updates in place


def _port(slabs):
    t = [_t(x) for x in slabs]
    return AcceptorState(*t[:3]), batched.LearnerState(*t[3:])


def _flat(stack, lstate):
    return [x.numpy() for x in (*vars(stack).values(), *vars(lstate).values())]


# name -> (Gl, N, V, B, block_b, lanes); a lane is (row, base, enabled); a
# pad lane names a row that an enabled lane also names, as a packer's zeroed
# table does.  Bases are multiples of the kernel's block (its index maps
# address whole blocks).
CASES = {
    "c1-gl2": (2, 128, 2, 16, 16, [(1, 48, 1)]),
    "c2-gl2-laps": (2, 128, 4, 16, 16, [(1, 3 * 128 + 32, 1), (0, 128 - 16, 1)]),
    "cgl-gl4": (4, 256, 2, 16, 16, [(2, 0, 1), (0, 512, 1), (3, 16, 1), (1, 7 * 256, 1)]),
    "ragged-gl4": (4, 256, 4, 16, 16, [(3, 96, 1), (1, 1024 + 48, 1), (3, 0, 0), (0, 0, 0)]),
    "pad-gl2": (2, 128, 2, 16, 16, [(0, 64, 1), (0, 0, 0)]),
    "ring-end-gl4": (4, 128, 2, 32, 16, [(1, 128 - 16, 1), (2, 2 * 128 - 16, 1)]),
}
# the same at V = 5, where the card's kernel takes its scalar variant
V5_CASES = {
    "c2-gl2-v5": (2, 128, 5, 16, 16, [(1, 3 * 128 + 32, 1), (0, 128 - 16, 1)]),
    "ragged-gl4-v5": (4, 256, 5, 16, 16, [(3, 96, 1), (1, 1024 + 48, 1), (3, 0, 0), (0, 0, 0)]),
}


def _case(name):
    if name in CASES:
        gl, n, v, b, block_b, lanes = CASES[name]
        rng = np.random.default_rng(sorted(CASES).index(name))
    else:
        gl, n, v, b, block_b, lanes = V5_CASES[name]
        rng = np.random.default_rng(100 + sorted(V5_CASES).index(name))
    c = len(lanes)
    seg = np.array([r for r, _, _ in lanes], np.int32)
    ni = np.array([x for _, x, _ in lanes], np.int32)
    en = np.array([e for _, _, e in lanes], np.int32)
    crnd = rng.integers(1, 7, c).astype(np.int32)
    alive = np.ones((c, A), np.int32)
    alive[0, 1] = 0  # a dead acceptor: still a quorum
    limit = np.full((c,), I32 - 1, np.int32)
    limit[-1] = ni[-1] + b // 2  # refuses the window's upper half
    slabs = _slabs(rng, gl, n, v, int(crnd.max()) + 3)
    values = rng.integers(-I32, I32, (c, b, v), dtype=np.int32)
    return dict(gl=gl, b=b, block_b=block_b, seg=seg, ni=ni, en=en, crnd=crnd, alive=alive,
                limit=limit, slabs=slabs, values=values)  # fmt: skip


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_round_matches_tpu_kernel_and_oracle(name):
    _packed_matches_tpu_kernel_and_oracle(name)


@pytest.mark.parametrize("name", sorted(V5_CASES))
def test_packed_round_matches_tpu_kernel_and_oracle_at_v5(name):
    _packed_matches_tpu_kernel_and_oracle(name)


def _packed_matches_tpu_kernel_and_oracle(name):
    k = _case(name)
    rs = [jnp.asarray(x) for x in k["slabs"]]
    args = [jnp.asarray(k[x]) for x in ("seg", "ni", "crnd")]
    kern = rwp.packed_shard_round(
        *args, jnp.int32(Q), jnp.asarray(k["alive"]), *rs, jnp.asarray(k["values"]),
        jnp.asarray(k["en"]), jnp.asarray(k["limit"]), block_b=k["block_b"], interpret=True,
    )  # fmt: skip
    o_st, o_ls, *o_out = rbatched.packed_multigroup_round(
        RAcc(*rs[:3]), RLearner(*rs[3:]), *args, jnp.asarray(k["alive"]), Q,
        jnp.asarray(k["values"]), jnp.asarray(k["en"]), jnp.asarray(k["limit"]),
    )  # fmt: skip
    oracle = [*vars(o_st).values(), *vars(o_ls).values(), *o_out]
    for route in (batched.packed_multigroup_round, ops.packed_shard_round):
        stack, lstate = _port(k["slabs"])
        kw = {"block_b": k["block_b"]} if route is ops.packed_shard_round else {}
        _, _, fresh, win, value = route(
            stack, lstate, k["seg"], k["ni"], k["crnd"], k["alive"], Q, _t(k["values"]),
            k["en"], k["limit"], **kw,
        )  # fmt: skip
        have = [*_flat(stack, lstate), fresh.numpy().astype(np.int32), win.numpy(), value.numpy()]
        for w, o, h, what in zip(kern, oracle, have, FIELDS, strict=True):
            np.testing.assert_array_equal(h, np.asarray(w), err_msg=f"{route.__name__} {what}")
            np.testing.assert_array_equal(h, np.asarray(o).astype(h.dtype), err_msg=what)
    pads = k["en"] == 0
    assert not have[6][pads].any() and (have[7][pads] == -1).all() and not have[8][pads].any()
    b = k["b"]
    assert not have[6][-1][b // 2 :].any()  # the limit refuses the upper half


def test_packed_round_touches_only_enabled_rows():
    """Rows no enabled lane names keep their bytes; a pad naming a row of
    its own leaves it alone too."""
    k = _case("ragged-gl4")
    stack, lstate = _port(k["slabs"])
    ops.packed_shard_round(stack, lstate, k["seg"], k["ni"], k["crnd"], k["alive"], Q,
                           _t(k["values"]), k["en"], k["limit"])  # fmt: skip
    for after, before in zip(_flat(stack, lstate), k["slabs"], strict=True):
        np.testing.assert_array_equal(after[[0, 2]], before[[0, 2]])


@pytest.mark.parametrize("offset_shard", [0, 1])
def test_shard_slab_round_matches_tpu_kernel(offset_shard):
    _shard_slab_matches_tpu_kernel(offset_shard, 2)


@pytest.mark.parametrize("offset_shard", [0, 1])
def test_shard_slab_round_matches_tpu_kernel_at_v5(offset_shard):
    _shard_slab_matches_tpu_kernel(offset_shard, 5)


def _shard_slab_matches_tpu_kernel(offset_shard, v):
    gl, n, b = 2, 128, 16
    g = 2 * gl
    off = offset_shard * gl
    rng = np.random.default_rng(40 + offset_shard)
    ni = np.array([0, 3 * n + 32, 96, 7 * n], np.int32)
    crnd = rng.integers(1, 7, g).astype(np.int32)
    crnd[off + 1] = -1  # a frozen group
    alive = np.ones((g, A), np.int32)
    alive[off, 2] = 0
    enabled = np.array([1, 1, 1, 0], np.int32)
    limit = np.array([0, 0, 0, 0], np.int32) + n
    limit[off] = ni[off] + b // 2
    slabs = _slabs(rng, gl, n, v, 9)
    values = rng.integers(-I32, I32, (gl, b, v), dtype=np.int32)
    want = rwp.shard_slab_round(
        jnp.int32(off), jnp.asarray(ni), jnp.asarray(crnd), jnp.int32(Q), jnp.asarray(alive),
        *(jnp.asarray(x) for x in slabs), jnp.asarray(values), jnp.asarray(enabled),
        jnp.asarray(limit), block_b=16, interpret=True,
    )  # fmt: skip
    stack, lstate = _port(slabs)
    _, _, fresh, win, value = ops.shard_slab_round(
        off, _t(ni), _t(crnd), _t(alive, torch.bool), Q, stack, lstate, _t(values), enabled,
        limit,
    )  # fmt: skip
    have = [*_flat(stack, lstate), fresh.numpy().astype(np.int32), win.numpy(), value.numpy()]
    for w, h, what in zip(want, have, FIELDS, strict=True):
        np.testing.assert_array_equal(h, np.asarray(w), err_msg=what)
    assert have[6][0].any() and not have[6][0][b // 2 :].any()


def test_packed_wrapper_refuses_bad_tables():
    """Two enabled lanes on one row would race in place on the card, and
    C > Gl cannot be packed: the wrapper refuses both on either route,
    before anything moves."""
    k = _case("cgl-gl4")
    stack, lstate = _port(k["slabs"])
    before = _flat(stack, lstate)
    vals = _t(k["values"])
    dup = k["seg"].copy()
    dup[1] = dup[0]
    with pytest.raises(ValueError, match="distinct rows"):
        ops.packed_shard_round(stack, lstate, dup, k["ni"], k["crnd"], k["alive"], Q, vals,
                               k["en"])  # fmt: skip
    out_of_range = k["seg"].copy()
    out_of_range[2] = 4
    with pytest.raises(ValueError, match="distinct rows"):
        ops.packed_shard_round(stack, lstate, out_of_range, k["ni"], k["crnd"], k["alive"], Q,
                               vals, k["en"])  # fmt: skip
    five = np.arange(5, dtype=np.int32) % 4
    with pytest.raises(ValueError, match="C <= Gl"):
        ops.packed_shard_round(
            stack, lstate, five, np.zeros(5, np.int32), np.ones(5, np.int32),
            np.ones((5, A), np.int32), Q, torch.zeros((5, 16, 2), dtype=torch.int32),
            np.ones(5, np.int32),
        )  # fmt: skip
    for after, was in zip(_flat(stack, lstate), before, strict=True):
        np.testing.assert_array_equal(after, was)
    # a pad may share a row with an enabled lane
    k_wirepath.check_packed_lanes("t", [1, 1], [1, 0], 2, 2, 16, 128, 128)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        k_wirepath.packed_shard_round(
            _t(k["seg"]), _t(k["ni"]), _t(k["crnd"]), 2, _t(k["alive"]),
            *vars(stack).values(), *vars(lstate).values(), vals,
        )  # fmt: skip
