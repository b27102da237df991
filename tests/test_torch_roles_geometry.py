"""The per-role kernels K7 and K8 on their team body: the launch the host
chooses for them, and their plain versions against the reference's Pallas
kernels (interpret mode) on the lanes where the team bodies branch.

K7 (``kernels.acceptor``) runs K2's team body at A = 1 and K8
(``kernels.learner``) a team a lane that loads every vote first; both take
``kernels.wirepath.lane_geometry``'s variant, team and grid from V and the
alignment of their value tensors.  The kernels themselves run only on the
card (``tests/test_torch_cuda.py``); here the geometry is read from CPU
tensors and the plain versions, which the card checks hold the kernels to,
are held to the reference.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.acceptor import acceptor_phase2_window as ref_acceptor  # noqa: E402
from repro.kernels.learner import learner_quorum_window as ref_learner  # noqa: E402
from repro_torch.core.types import AcceptorState, MsgBatch  # noqa: E402
from repro_torch.kernels import acceptor as tacc  # noqa: E402
from repro_torch.kernels import learner as tlearn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import wirepath as twire  # noqa: E402

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
P2B, REJECT = 4, 7


def _placed(shape, off: bool) -> torch.Tensor:
    """A contiguous int32 tensor of ``shape`` that starts on 16 bytes, or 4
    bytes past 16 where ``off``."""
    numel = int(np.prod(shape))
    buf = torch.zeros(numel + 8, dtype=torch.int32)
    start = (-buf.data_ptr() // 4) % 4 + (1 if off else 0)
    t = buf[start : start + numel].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == (4 if off else 0)
    return t


# (V, B, which tensor starts 4 bytes off 16) -> (variant, team, grid) at 128
# threads a block: int4 chunks where V % 4 == 0 and every value tensor is on
# 16 bytes, a team of the power of two at or above the lane's words
GEOMETRY = [
    ((16, 128, None), ("vector", 4, (4, 1))),  # the per-role walk: 4 blocks
    ((16, 512, None), ("vector", 4, (16, 1))),  # Table 1's burst: 16 blocks
    ((16, 100, None), ("vector", 4, (4, 1))),  # B not a multiple of 32 lanes
    ((16, 128, 0), ("scalar", 16, (16, 1))),
    ((16, 128, 1), ("scalar", 16, (16, 1))),
    ((5, 128, None), ("scalar", 8, (8, 1))),
    ((3, 128, None), ("scalar", 4, (4, 1))),
    ((64, 128, None), ("vector", 16, (16, 1))),
    ((64, 128, 2), ("scalar", 32, (32, 1))),
]


@pytest.mark.parametrize("args,want", GEOMETRY)
def test_acceptor_geometry_follows_v_and_alignment(monkeypatch, args, want):
    """K7's launch from its burst, register file values and vote values
    (``off`` 0, 1, 2 names the one that starts 4 bytes off 16)."""
    monkeypatch.setattr(twire, "LANE_THREADS", 128)
    v, b, off = args
    msg_val, st_val, vote_val = (_placed(s, off == i) for i, s in
                                 enumerate(((b, v), (4 * b, v), (b, v))))  # fmt: skip
    geo = tacc.geometry(msg_val, st_val, vote_val)
    assert (geo.variant, geo.team, geo.grid) == want
    assert geo.block == 128


@pytest.mark.parametrize("args,want", GEOMETRY)
def test_learner_geometry_follows_v_and_alignment(monkeypatch, args, want):
    """K8's launch from its vote values (A = 3) and its output values
    (``off`` 0 or 1 names the one that starts 4 bytes off 16; 2 moves
    neither, and then only V decides)."""
    monkeypatch.setattr(twire, "LANE_THREADS", 128)
    v, b, off = args
    vote_val, value = _placed((3, b, v), off == 0), _placed((b, v), off == 1)
    geo = tlearn.geometry(vote_val, value)
    if off == 2:  # nothing K8 reads or writes is off 16
        want = twire.lane_geometry(v, b, 1, True)
        want = (want.variant, want.team, want.grid)
    assert (geo.variant, geo.team, geo.grid) == want


@pytest.mark.parametrize("v", [16, 5, 3, 64])
def test_acceptor_plain_version_matches_tpu_kernel(v):
    """K7's plain version, which the card holds the team body to, against
    the reference's K7 in interpret mode at every V the geometry tests
    name: three windows of 128 lanes in a row, one across the ring end,
    register file in place."""
    n, b, aid = 512, 128, 2
    rng = np.random.default_rng([v, 24])
    regs = dict(
        rnd=rng.integers(0, 9, n, dtype=np.int32),
        vrnd=rng.integers(-1, 9, n, dtype=np.int32),
        val=rng.integers(I32_MIN, I32_MAX, (n, v), dtype=np.int32, endpoint=True),
    )
    ref = tuple(jnp.asarray(regs[k]) for k in ("rnd", "vrnd", "val"))
    got = AcceptorState(*(torch.from_numpy(regs[k].copy()) for k in ("rnd", "vrnd", "val")))
    for base in (256, 384, 512):  # the last block, then across the ring end
        mt = rng.choice([0, 1, 3, 3, 3, 4, 7], b).astype(np.int32)
        mr = rng.integers(-1, 11, b, dtype=np.int32)
        mv = rng.integers(I32_MIN, I32_MAX, (b, v), dtype=np.int32, endpoint=True)
        out = ref_acceptor(*ref, base, aid, jnp.asarray(mt), jnp.asarray(mr), jnp.asarray(mv),
                           interpret=True)  # fmt: skip
        ref, (vt, vr, vv, vs, vval) = out[:3], out[3:]
        msgs = MsgBatch(
            msgtype=torch.from_numpy(mt), inst=torch.arange(base, base + b, dtype=torch.int32),
            rnd=torch.from_numpy(mr), vrnd=torch.full((b,), -1, dtype=torch.int32),
            swid=torch.zeros(b, dtype=torch.int32), value=torch.from_numpy(mv),
        )  # fmt: skip
        got, votes = tops.acceptor_phase2(got, msgs, aid)
        for mine, theirs in zip((votes.msgtype, votes.rnd, votes.vrnd, votes.swid, votes.value),
                                (vt, vr, vv, vs, vval), strict=True):  # fmt: skip
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
        for mine, theirs in zip(vars(got).values(), ref, strict=True):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def _first_agreeing_votes(rng, a: int, b: int, v: int):
    """Votes whose first agreeing acceptor cycles over the lanes: 0, 1, A-1
    and none (every vote REJECT), then foreign lanes (mixed types and
    vrnds).  Acceptors before the first agreeing one REJECT with non-zero
    values; after it, P2B at the winning round or one below."""
    vtype = np.full((a, b), P2B, np.int32)
    vrnd = np.where(rng.random((a, b)) < 0.5, 7, 6).astype(np.int32)
    kinds = [0, min(1, a - 1), a - 1, None, "foreign"]
    for j in range(b):
        kind = kinds[j % len(kinds)]
        if kind is None:
            vtype[:, j] = REJECT
        elif kind == "foreign":
            vtype[:, j] = rng.choice([P2B, P2B, REJECT, 2], a)
            vrnd[:, j] = rng.integers(-3, 4, a)
        else:
            vtype[:kind, j] = REJECT
            vrnd[kind, j] = 7
    value = rng.integers(1, I32_MAX, (a, b, v), dtype=np.int32)
    return vtype, vrnd, value, kinds


@pytest.mark.parametrize("a", [1, 3, 5, tlearn.VOTE_CAP + 1])
@pytest.mark.parametrize("v", [16, 5])
def test_learner_plain_version_matches_tpu_kernel_where_k8_branches(a, v):
    """K8's plain version against the reference's K8 in interpret mode on
    lanes whose first agreeing acceptor is 0, 1, A-1 or none, at A = 1, 3,
    5 and one above the acceptors a thread of the team body loads before it
    decides (``VOTE_CAP``); value 0 where none agrees."""
    b, q = 128, a // 2 + 1
    rng = np.random.default_rng([a, v, 24])
    vtype, vrnd, value, kinds = _first_agreeing_votes(rng, a, b, v)
    want = ref_learner(jnp.int32(q), jnp.asarray(vtype), jnp.asarray(vrnd), jnp.asarray(value),
                       interpret=True)  # fmt: skip
    got = tlearn.learner_quorum_plain(q, *(torch.from_numpy(x) for x in (vtype, vrnd, value)))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lanes = np.arange(b)
    for i, kind in enumerate(kinds):
        on = lanes % len(kinds) == i
        if kind is None:
            assert not got[2][on].any() and not got[0][on].any()
        elif kind != "foreign":
            np.testing.assert_array_equal(got[2][on].numpy(), value[kind][on])
