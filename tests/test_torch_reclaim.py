"""The reclaim limit near int32 max: the port against the reference.

Single group: the limit ``reclaimed + N`` is a host integer.  Past int32 max
the reference raises ``OverflowError`` at its int32 conversion, after the
capacity guard and before any state or counter moves; the port raises the
same error at the same point, on every device, and leaves state, host
mirrors and ``dispatch_count`` as they were.  A watermark just low enough
(``2**31 - 1 - N - B``) delivers the whole burst on both.

Multi group: the limits are an int32 vector (``marks + N`` in numpy int32),
so a mark within N of int32 max wraps to a negative limit and that group's
lanes are all refused, with no error.  The port wraps the same way, on
purpose: it is the reference's behaviour, bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.bridge import export_state  # noqa: E402

N, B, V = 256, 16, 16
CFG = dict(n_acceptors=3, n_instances=N, value_words=V, batch=B)
I32_MAX = 2**31 - 1


def _at_watermark(wm: int):
    """The reference's and the port's single-group dataplanes with the
    sequencer and the reclamation watermark both at ``wm``."""
    ref = R.HardwareDataplane(R.PaxosConfig(**CFG), use_kernels=True)
    got = T.HardwareDataplane(T.PaxosConfig(**CFG), device="cpu")
    ref.cstate = R.CoordinatorState(next_inst=jnp.int32(wm), crnd=jnp.int32(0))
    got.cstate = T.CoordinatorState.init(next_inst=wm, device="cpu")
    for hw in (ref, got):
        hw._next_inst_host = wm
        hw.enable_reclamation()
        hw.set_reclaimed(wm)
    return ref, got


def _burst(seed: int, b: int = B):
    rng = np.random.default_rng(seed)
    return rng.integers(-(2**31), 2**31, (b, V), dtype=np.int32), np.ones(b, bool)


def _same_state(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def test_single_group_limit_past_int32_max_raises_like_the_reference():
    wm = 2**31 - 200  # wm + N = 2**31 + 56: past int32 max
    ref, got = _at_watermark(wm)
    values, active = _burst(0)
    for hw in (ref, got):
        before, count = export_state(hw), hw.dispatch_count
        with pytest.raises(OverflowError):
            hw.pipeline(values, active)
        _same_state(before, export_state(hw))
        assert hw.dispatch_count == count
        assert hw._next_inst_host == wm and hw.reclaimed_host == wm
    _same_state(export_state(ref), export_state(got))


def test_single_group_limit_at_int32_max_delivers_like_the_reference():
    wm = I32_MAX - N - B  # the limit is int32 max - B: every lane passes
    ref, got = _at_watermark(wm)
    values, active = _burst(1)
    want = ref.pipeline(values, active)
    have = got.pipeline(values, active)
    for w, h in zip(want, have, strict=True):
        np.testing.assert_array_equal(h, w)
    assert int(have[0].sum()) == B == int(want[0].sum())
    _same_state(export_state(ref), export_state(got))
    assert got.dispatch_count == ref.dispatch_count == 1


def test_context_raises_and_keeps_its_logs_like_the_reference():
    """The same fault through the fused context: the pump raises, and the
    dataplane and the delivery log are as they were."""
    wm = 2**31 - 200
    ctxs = []
    for pkg, kw in ((R, {}), (T, {"device": "cpu"})):
        ctx = pkg.PaxosContext(pkg.PaxosConfig(**CFG), fused=True, use_kernels=True,
                               snapshots=True, **kw)  # fmt: skip
        hw = ctx.hw
        if pkg is R:
            hw.cstate = R.CoordinatorState(next_inst=jnp.int32(wm), crnd=jnp.int32(0))
        else:
            hw.cstate = T.CoordinatorState.init(next_inst=wm, device="cpu")
        hw._next_inst_host = wm
        hw.set_reclaimed(wm)
        ctx.snapshots._watermark[0] = wm
        ctx.submit(b"past the limit")
        before, count = export_state(hw), hw.dispatch_count
        with pytest.raises(OverflowError):
            ctx.pump()
        _same_state(before, export_state(hw))
        assert hw.dispatch_count == count and ctx.delivered_log == []
        ctxs.append(ctx)
    _same_state(export_state(ctxs[0].hw), export_state(ctxs[1].hw))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_multigroup_limit_vector_wraps_like_the_reference(use_kernels):
    """Group 1's mark sits 128 below 2**31: its limit wraps negative in the
    int32 vector, so every lane of its window is refused and nothing is
    raised; the other groups decide.  Outputs and state equal the
    reference's (its Pallas cohort kernel in interpret mode when
    ``use_kernels``: the window is block-aligned)."""
    g, mark = 4, 2**31 - 128
    cfg = dict(CFG, n_groups=g, persistent_rounds=1)
    ref = R.MultiGroupDataplane(R.PaxosConfig(**cfg), use_kernels=use_kernels)
    got = T.MultiGroupDataplane(T.PaxosConfig(**cfg), use_kernels=use_kernels, device="cpu")
    marks = [0, mark, 0, 0]
    ref.cstate = R.CoordinatorState(
        next_inst=jnp.asarray(marks, jnp.int32), crnd=jnp.zeros((g,), jnp.int32)
    )
    got.cstate = T.CoordinatorState(
        next_inst=torch.tensor(marks, dtype=torch.int32), crnd=torch.zeros(g, dtype=torch.int32)
    )
    for hw in (ref, got):
        hw.next_inst_host = list(marks)
        hw.enable_reclamation()
        hw.set_reclaimed(1, mark)
        lim = hw._reclaim_limits_np()
        assert lim.dtype == np.int32 and lim[1] == mark + N - 2**32 < 0  # wrapped
    rng = np.random.default_rng(2)
    gids = [0, 1, 3]
    values = rng.integers(-(2**31), 2**31, (len(gids), B, V), dtype=np.int32)
    active = np.ones((len(gids), B), bool)
    want = ref.pipeline_cohort(gids, values, active)
    have = got.pipeline_cohort(gids, values, active)
    for w, h in zip(want, have, strict=True):
        np.testing.assert_array_equal(h, w)
    fresh = have[0]
    assert not fresh[1].any()  # group 1: every lane refused, no error
    assert fresh[0].all() and fresh[2].all()
    _same_state(export_state(ref), export_state(got))
    assert got.next_inst_host == ref.next_inst_host and got.last_gb == ref.last_gb
