"""The port's fused round (``kernels.ops.fused_round``) against the TPU
kernel's reference, run as the reference's own tests run it.

On CPU tensors ``ops.fused_round`` runs the kernel's plain version; here it
is held against ``repro.kernels.wirepath.wirepath_round(..., interpret=True)``
over several consecutive rounds, and all nine outputs (six state tensors,
fresh, win, value) must match bit for bit.  The state must be updated in
place: the tensors keep their storage across rounds.
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
    a = len(alive)
    rng = np.random.default_rng([a, base, crnd + 1, b, 7])
    s = dict(
        rnd=rng.integers(0, 10, (a, N), dtype=np.int32),
        vrnd=rng.integers(-1, 10, (a, N), dtype=np.int32),
        val=rng.integers(I32_MIN, I32_MAX, (a, N, V), dtype=np.int32, endpoint=True),
        ldel=rng.integers(0, 2, (N,), dtype=np.int32),
        linst=rng.integers(-1, 8 * N, (N,), dtype=np.int32),
        lval=rng.integers(I32_MIN, I32_MAX, (N, V), dtype=np.int32, endpoint=True),
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
        vals = rng.integers(I32_MIN, I32_MAX, (b, V), dtype=np.int32, endpoint=True)
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
