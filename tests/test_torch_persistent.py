"""Persistent K-round waves and the async pump: the port against the
reference, bit for bit (tolerance: none, every int32 equal).

The unsharded cases of ``tests/test_persistent.py``, each held against the
reference on the same seeded numpy inputs:

1. ``batched.persistent_multigroup_rounds`` (the plain full-width K-round
   program) against the reference's and against K sequential plain
   rounds, with and without a mid-wave freeze.
2. ``batched.persistent_cohort_rounds`` (K5's plain version, reached
   through ``kernels.ops``) against the reference's K5 in interpret mode at
   aligned bases, GB in {1, 2, G}, and against the reference's jnp oracle at
   misaligned bases and a window across 2**31.
3. ``MultiGroupDataplane.pipeline_persistent`` against K ``pipeline_cohort``
   calls and against the reference's, with its ring-lap ``ValueError`` and
   its up-front reclaim guard; ``_wave_block`` on random inputs.
4. The grouped ``PaxosContext`` at the reference's defaults
   (``persistent_rounds=8``, ``async_pump=True``) against the reference's:
   a lossy ``SimNet``, uniform and skewed load, a failover, a crash,
   membership changes, a reclaim-clamped wave; equal logs, ``deliver``
   order, slabs, ``dispatch_count``, fold widths and planner report, with
   the async pump on and off and with submissions made mid-drain.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import batched as rbatched  # noqa: E402
from repro.core.batched import LearnerState as RLearner  # noqa: E402
from repro.core.types import AcceptorState as RAcc  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.bridge import export_state  # noqa: E402
from repro_torch.core.plan import NOP_SENTINEL  # noqa: E402
from repro_torch.core.types import AcceptorState, CoordinatorState  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wirepath as k_wirepath  # noqa: E402

A, N, V, Q = 3, 512, 4, 2
I32 = 2**31
FAULTS = dict(drop=0.05, dup=0.05, reorder=0.1)


def _wrap(x) -> np.ndarray:
    return ((np.asarray(x, np.int64) + I32) % 2**32 - I32).astype(np.int32)


def _walk(bases, wen: np.ndarray, b: int) -> np.ndarray:
    """The wave descriptor's window bases: ``wni[k+1] = wni[k] + B*wen[k]``,
    in int32."""
    wni = np.zeros(wen.shape, np.int64)
    wni[0] = bases
    for r in range(1, wen.shape[0]):
        wni[r] = wni[r - 1] + b * wen[r - 1]
    return _wrap(wni)


def _slabs(rng, g, windows, top):
    """Protocol-valid random ``(G, ...)`` slabs as numpy: promises straddle
    the rounds, and part of each learner ring holds instances of the wave's
    windows (duplicates).  ``windows[g]`` lists group g's instances."""
    linst = rng.integers(-1, 1 << 20, (g, N), dtype=np.int32)
    for gi, inst in enumerate(windows):
        inst = _wrap(inst)
        dup = rng.random(inst.size) < 0.3
        linst[gi, inst[dup].astype(np.int64) % N] = inst[dup]
    return [
        rng.integers(0, top, (g, A, N), dtype=np.int32),
        rng.integers(-1, top, (g, A, N), dtype=np.int32),
        rng.integers(-I32, I32, (g, A, N, V), dtype=np.int32),
        rng.integers(0, 2, (g, N), dtype=np.int32),
        linst,
        rng.integers(-I32, I32, (g, N, V), dtype=np.int32),
    ]


def _t(x, dtype=torch.int32):
    """A tensor copy: the port updates state in place, the numpy inputs
    stay as they were."""
    return torch.from_numpy(np.array(x)).to(dtype)


def _port_state(slabs):
    t = [_t(x) for x in slabs]
    return AcceptorState(*t[:3]), batched.LearnerState(*t[3:])


def _ref_state(slabs):
    j = [jnp.asarray(x) for x in slabs]
    return RAcc(*j[:3]), RLearner(*j[3:])


def _flat(stack, lstate):
    return [x.numpy() for x in (*vars(stack).values(), *vars(lstate).values())]


def _wave_values(rng, k, c, b, fill=0.8):
    """Random wave values in the wire convention: inactive slots carry the
    NOP sentinel in word 0."""
    vals = rng.integers(-I32, I32, (k, c, b, V), dtype=np.int32)
    active = rng.random((k, c, b)) < fill
    vals[~active, 0] = NOP_SENTINEL
    return vals, active


def _equal(want, have, names) -> None:
    for w, h, name in zip(want, have, names, strict=True):
        np.testing.assert_array_equal(np.asarray(h), np.asarray(w), err_msg=name)


STATE = ("rnd", "vrnd", "val", "ldel", "linst", "lval")


# ---------------------------------------------------------------------------
# 1. the plain K-round program
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("freeze_at", [None, 2])
def test_plain_persistent_rounds_match_reference_and_sequential_rounds(freeze_at):
    """``persistent_multigroup_rounds`` against the reference's (one group's
    windows cross 2**31, one group has a dead acceptor, one a limit inside
    the wave) and against K sequential ``multigroup_fused_round`` calls with
    the freeze applied between rounds."""
    g, b, k = 3, 16, 4
    rng = np.random.default_rng(7 if freeze_at is None else 8)
    bases = np.array([0, I32 - 40, 1003], np.int64)
    wen = np.ones((k, g), np.int32)
    if freeze_at is not None:
        wen[freeze_at:, 1] = 0
    wni = _walk(bases, wen, b)
    windows = [np.concatenate([wni[r, gi] + np.arange(b) for r in range(k)]) for gi in range(g)]
    slabs = _slabs(rng, g, windows, 9)
    vals, active = _wave_values(rng, k, g, b)
    crnd = rng.integers(1, 7, g).astype(np.int32)
    alive = np.ones((g, A), bool)
    alive[2, 0] = False
    limit = _wrap([N, I32 - 40 + N, 1003 + 40])  # group 1's wraps, group 2's bites
    ni = _wrap(bases)
    enabled = None if freeze_at is None else wen

    r_c, r_st, r_ls, *r_out = rbatched.persistent_multigroup_rounds(
        R.CoordinatorState(jnp.asarray(ni), jnp.asarray(crnd)), *_ref_state(slabs),
        jnp.asarray(vals), jnp.asarray(active), jnp.asarray(alive), Q,
        enabled_rounds=None if enabled is None else jnp.asarray(enabled),
        reclaim_limit=jnp.asarray(limit),
    )  # fmt: skip
    stack, lstate = _port_state(slabs)
    t_c, _, _, *t_out = batched.persistent_multigroup_rounds(
        CoordinatorState(_t(ni), _t(crnd)), stack, lstate, _t(vals), _t(active, torch.bool),
        _t(alive, torch.bool), Q, enabled_rounds=enabled, reclaim_limit=limit,
    )  # fmt: skip
    names = ("next_inst", "crnd", *STATE, "fresh", "inst", "win", "value")
    want = [r_c.next_inst, r_c.crnd, *vars(r_st).values(), *vars(r_ls).values(), *r_out]
    have = [t_c.next_inst, t_c.crnd, *_flat(stack, lstate), *(x.numpy() for x in t_out)]
    _equal(want, have, names)
    np.testing.assert_array_equal(t_c.next_inst.numpy(), _wrap(wni[-1] + b * wen[-1]))

    # K sequential plain rounds, the freeze applied between them
    s_stack, s_lstate = _port_state(slabs)
    cs = CoordinatorState(_t(ni), _t(crnd))
    outs = []
    for r in range(k):
        en = torch.from_numpy(wen[r] != 0)
        eff = CoordinatorState(cs.next_inst, torch.where(en, cs.crnd, -1))
        nc, s_stack, s_lstate, *out = batched.multigroup_fused_round(
            eff, s_stack, s_lstate, _t(vals[r]), _t(active[r], torch.bool),
            _t(alive, torch.bool), Q, reclaim_limit=limit,
        )  # fmt: skip
        cs = CoordinatorState(torch.where(en, nc.next_inst, cs.next_inst), cs.crnd)
        outs.append(out)
    seq = [torch.stack(x).numpy() for x in zip(*outs, strict=True)]
    seq_names = names[:1] + names[2:]
    _equal([cs.next_inst, *_flat(s_stack, s_lstate), *seq], have[:1] + have[2:], seq_names)
    if freeze_at is not None:
        assert not np.asarray(t_out[0])[freeze_at:, 1].any()


# ---------------------------------------------------------------------------
# 2. K5's plain version against the reference's K5 and its oracle
# ---------------------------------------------------------------------------
# (group_block, gsel, per-group bases, frozen group and round, inert group):
# aligned bases (the reference's K5 runs only there); enabled members of a
# folded block in lockstep; an inert member sits at a divergent base
KERNEL_CASES = {
    "gb1-single": (1, [2], [0, 96, 480, 32], None, None),
    "gb1-subset-freeze": (1, [0, 3], [480, 96, 0, 32], (3, 2), None),
    "gb2-all-inert-member": (2, [0, 1], [480, 480, 64, 208], None, 3),
    "gbG-all-freeze": (4, [0], [192, 192, 192, 192], (1, 1), None),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_persistent_cohort_rounds_match_tpu_kernel(name):
    """``ops.persistent_cohort_rounds`` on the CPU (K5's plain version)
    against the reference's K5 in interpret mode: K=4 rounds of B=32 at
    G=4, windows that cross the ring end, a freeze landing between rounds,
    an inert member of a folded block, dead acceptors (one group below
    quorum), a limit inside the wave and one that wrapped past int32 max.
    Two ``block_b`` values give the same result."""
    gb, gsel, bases, freeze, inert = KERNEL_CASES[name]
    g, b, k = 4, 32, 4
    rng = np.random.default_rng(sorted(KERNEL_CASES).index(name))
    rows = [blk * gb + j for blk in gsel for j in range(gb)]
    wen = np.zeros((k, g), np.int32)
    wen[:, rows] = 1
    if freeze is not None:
        wen[freeze[1] :, freeze[0]] = 0
    if inert is not None:
        wen[:, inert] = 0
    wni = _walk(bases, wen, b)
    windows = [np.concatenate([wni[r, gi] + np.arange(b) for r in range(k)]) for gi in range(g)]
    slabs = _slabs(rng, g, windows, 9)
    vals, _active = _wave_values(rng, k, len(rows), b)
    crnd = rng.integers(1, 7, g).astype(np.int32)
    alive = np.ones((g, A), bool)
    alive[0, 1] = False  # still a quorum
    alive[1, [0, 2]] = False  # below quorum: nothing decides
    limit = _wrap(np.array([0, 0, I32 - 100, 0]) + N)  # group 2's wraps negative
    limit[3] = bases[3] + 2 * b + 5  # bites inside the wave's third round
    r_st, r_ls, *r_out = rops.persistent_cohort_rounds(
        *_ref_state(slabs), jnp.asarray(gsel, jnp.int32), jnp.asarray(wni), jnp.asarray(wen),
        jnp.asarray(crnd), jnp.asarray(alive, jnp.int32), Q, jnp.asarray(vals), jnp.asarray(limit),
        group_block=gb, block_b=16,
    )  # fmt: skip
    want = [*vars(r_st).values(), *vars(r_ls).values(), *r_out]
    names = (*STATE, "fresh", "win", "value")
    for block_b in (16, 128):
        stack, lstate = _port_state(slabs)
        _, _, fresh, win, value = ops.persistent_cohort_rounds(
            stack, lstate, gsel, wni, wen, _t(crnd), _t(alive, torch.bool), Q, _t(vals), limit,
            group_block=gb, block_b=block_b,
        )  # fmt: skip
        assert fresh.dtype == torch.bool and fresh.shape == (k, len(rows), b)
        _equal(want, [*_flat(stack, lstate), fresh.numpy(), win.numpy(), value.numpy()], names)
    if name == "gb1-subset-freeze":  # the frozen rounds decide nothing
        assert not fresh.numpy()[2:, 1].any() and (win.numpy()[2:, 1] == -1).all()


@pytest.mark.parametrize("block_b", [8, 128])
def test_persistent_cohort_rounds_match_oracle_at_any_base(block_b):
    """K5's plain version against the reference's jnp oracle at window bases
    no block divides, one group's wave across 2**31, a freeze between rounds
    and one unselected group held inert by the oracle."""
    g, b, k = 4, 16, 5
    rng = np.random.default_rng(block_b)
    gsel = [0, 1, 3]
    bases = np.array([1003, I32 - 40, 7, 250])
    wen = np.ones((k, g), np.int32)
    wen[:, 2] = 0  # not selected
    wen[3:, 3] = 0  # frozen after round 2
    wni = _walk(bases, wen, b)
    windows = [np.concatenate([wni[r, gi] + np.arange(b) for r in range(k)]) for gi in range(g)]
    slabs = _slabs(rng, g, windows, 9)
    vals, active = _wave_values(rng, k, g, b)
    crnd = rng.integers(1, 7, g).astype(np.int32)
    alive = np.ones((g, A), bool)
    alive[3, 2] = False
    limit = _wrap(bases + N)
    limit[0] = 1003 + 3 * b + 4
    r_c, r_st, r_ls, r_fresh, _ri, r_win, r_val = rbatched.persistent_multigroup_rounds(
        R.CoordinatorState(jnp.asarray(_wrap(bases)), jnp.asarray(crnd)), *_ref_state(slabs),
        jnp.asarray(vals), jnp.asarray(active), jnp.asarray(alive), Q,
        enabled_rounds=jnp.asarray(wen), reclaim_limit=jnp.asarray(limit),
    )  # fmt: skip
    stack, lstate = _port_state(slabs)
    _, _, fresh, win, value = ops.persistent_cohort_rounds(
        stack, lstate, gsel, _t(wni), _t(wen), _t(crnd), _t(alive, torch.bool), Q,
        _t(vals[:, gsel]), limit, block_b=block_b,
    )  # fmt: skip
    want = [*vars(r_st).values(), *vars(r_ls).values(),
            *(np.asarray(x)[:, gsel] for x in (r_fresh, r_win, r_val))]  # fmt: skip
    _equal(want, [*_flat(stack, lstate), fresh.numpy(), win.numpy(), value.numpy()],
           (*STATE, "fresh", "win", "value"))  # fmt: skip
    assert np.asarray(r_fresh)[3:, 1].any()  # lanes past 2**31 decided
    marks = _wrap(wni[-1] + b * wen[-1])
    np.testing.assert_array_equal(np.asarray(r_c.next_inst)[gsel], marks[gsel])


def test_persistent_wave_refusals():
    """A wave that would lap the ring is refused by the plain version and by
    K5's wrapper; so are a descriptor that does not walk and repeated
    blocks (checked on the host, before any launch)."""
    stack, lstate = _port_state(_slabs(np.random.default_rng(0), 2, [[], []], 3))
    crnd, alive = torch.zeros(2, dtype=torch.int32), torch.ones((2, A), dtype=torch.bool)
    lap = torch.zeros((N // 16 + 1, 2, 16, V), dtype=torch.int32)
    wen = np.ones((lap.shape[0], 2), np.int32)
    with pytest.raises(ValueError, match="lap"):
        ops.persistent_cohort_rounds(stack, lstate, [0, 1], _walk([0, 0], wen, 16), wen, crnd,
                                     alive, Q, lap)  # fmt: skip
    wen = np.ones((3, 2), np.int32)
    rows = np.arange(2)
    k_wirepath._host_wave(_walk([5, I32 - 20], wen, 16), wen, 16, rows)
    bad = _walk([5, 0], wen, 16)
    bad[2, 1] += 1
    with pytest.raises(ValueError, match="walk"):
        k_wirepath._host_wave(bad, wen, 16, rows)
    k_wirepath._host_wave(bad, wen, 16, rows[:1])  # group 1 not selected: not checked
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        k_wirepath.persistent_wirepath_round(
            [0], _walk([0, 0], wen, 16), wen, crnd, Q, alive, *vars(stack).values(),
            *vars(lstate).values(), torch.zeros((3, 1, 16, V), dtype=torch.int32),
        )  # fmt: skip
    with pytest.raises(ValueError, match="distinct"):
        k_wirepath._host_gsel([1, 1], 2)


# ---------------------------------------------------------------------------
# 3. the dataplane
# ---------------------------------------------------------------------------
def _planes(g, use_kernels, n=128, be=16, reclaim=False):
    cfg = dict(n_acceptors=A, n_instances=n, value_words=V, batch=be, n_groups=g)
    ref = R.MultiGroupDataplane(R.PaxosConfig(**cfg), use_kernels=use_kernels)
    got = T.MultiGroupDataplane(T.PaxosConfig(**cfg), use_kernels=use_kernels, device="cpu")
    if reclaim:
        for hw in (ref, got):
            hw.enable_reclamation()
    return ref, got


def _same_plane(ref, got) -> None:
    want, have = export_state(ref), export_state(got)
    assert want.keys() == have.keys()
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)
    assert got.next_inst_host == ref.next_inst_host
    assert got.dispatch_count == ref.dispatch_count and got.last_gb == ref.last_gb


@pytest.mark.parametrize("use_kernels", [False, True])
def test_pipeline_persistent_equals_k_cohorts_and_reference(use_kernels):
    """A wave of K=3 over a cohort of three of four groups (one lagging at a
    misaligned watermark, so no fold), reclamation on: equal to three
    ``pipeline_cohort`` calls of the port and to the reference's wave."""
    g, be, k = 4, 16, 3
    rng = np.random.default_rng(23)
    gids = (0, 2, 3)
    vals, active = _wave_values(rng, k, len(gids), be)
    ref, got = _planes(g, use_kernels, reclaim=True)
    seq = T.MultiGroupDataplane(got.cfg, use_kernels=use_kernels, device="cpu")
    seq.enable_reclamation()
    for hw in (ref, got, seq):
        hw.burn_forward(2, 5)
        hw.kill_acceptor(3, 1)
    want = ref.pipeline_persistent(gids, vals, active)
    have = got.pipeline_persistent(gids, vals, active)
    assert have[0].shape == (k, len(gids), be)
    _equal(want, have, ("fresh", "inst", "value"))
    _same_plane(ref, got)
    assert got.dispatch_count == 1
    outs = [seq.pipeline_cohort(gids, vals[r], active[r]) for r in range(k)]
    _equal([np.stack(x) for x in zip(*outs, strict=True)], have, ("fresh", "inst", "value"))
    for key, arr in export_state(seq).items():
        np.testing.assert_array_equal(export_state(got)[key], arr, err_msg=key)
    assert seq.next_inst_host == got.next_inst_host == [k * be, 0, 5 + k * be, k * be]


def test_pipeline_persistent_window_across_int32_max():
    """A wave whose later windows cross 2**31, on the kernel engine (the
    reference's K5 runs: the windows are aligned): the descriptor wraps in
    int32 (numpy's ``marks + steps``), the device watermark wraps, the host
    mirror does not, exactly as in the reference.  Without reclamation the
    kernels' limit is int32 max, so the lane at 2**31 - 1 alone is refused
    (the reference's jnp engine gates nothing there; the port follows its
    kernel on every engine)."""
    g, be, k = 2, 16, 4
    rng = np.random.default_rng(31)
    vals, active = _wave_values(rng, k, g, be, fill=1.0)
    ref, got = _planes(g, True)
    for hw in (ref, got):
        hw.burn_forward(0, I32 - 32)
        hw.burn_forward(1, I32 - 32)
    with np.errstate(over="ignore"):
        want = ref.pipeline_persistent((0, 1), vals, active)
        have = got.pipeline_persistent((0, 1), vals, active)
    _equal(want, have, ("fresh", "inst", "value"))
    _same_plane(ref, got)
    assert have[1][2, 0, 0] == -I32 and have[1][1, 0, 15] == I32 - 1
    assert not have[0][1, :, 15].any() and have[0].sum() == have[0].size - g
    assert int(got.cstate.next_inst[0]) == -I32 + 32 and got.next_inst_host[0] == I32 + 32


def test_pipeline_persistent_refuses_lap_and_guards_the_last_window():
    """The ring-lap ``ValueError``; a wave whose last window passes a
    member's reclaim limit raises ``RingOverflowError`` before anything
    moves (slabs, mirrors and ``dispatch_count``), as the reference's; one
    round less fits and runs."""
    ref, got = _planes(2, True, n=64, be=16, reclaim=True)
    vals, active = _wave_values(np.random.default_rng(5), 5, 1, 16)
    for hw in (ref, got):
        with pytest.raises(ValueError, match="lap"):
            hw.pipeline_persistent((0,), vals, active)
        hw.pipeline_cohort((1,), vals[0], active[0])
        hw.burn_forward(0, 16)
    before = export_state(got)
    for hw, pkg in ((ref, R), (got, T)):
        with pytest.raises(pkg.RingOverflowError):
            hw.pipeline_persistent((0,), vals[:4], active[:4])
    for key, arr in export_state(got).items():
        np.testing.assert_array_equal(arr, before[key], err_msg=key)
    assert got.dispatch_count == ref.dispatch_count == 1
    _same_plane(ref, got)
    want = ref.pipeline_persistent((0,), vals[:3], active[:3])
    _equal(want, got.pipeline_persistent((0,), vals[:3], active[:3]), ("fresh", "inst", "value"))
    _same_plane(ref, got)


@pytest.mark.parametrize("seed", range(4))
def test_wave_block_matches_reference(seed):
    """``_wave_block`` (host arithmetic: the wave's block size) against the
    reference's on random rings, bursts and member bases."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.choice([64, 96, 128, 512, 1 << 16]))
        be = int(rng.choice([8, 16, 32, 64, 128]))
        cfg = dict(n_instances=n, batch=128, n_groups=2)
        ref = R.MultiGroupDataplane(R.PaxosConfig(**cfg))
        got = T.MultiGroupDataplane(T.PaxosConfig(**cfg), device="cpu")
        scale = int(rng.choice([1, be, 128]))
        bases = [int(x) * scale for x in rng.integers(0, 1 << 12, int(rng.integers(1, 5)))]
        assert got._wave_block(be, bases) == ref._wave_block(be, bases), (n, be, bases)


def test_single_group_dataplane_waves_match_reference():
    """G=1 as a multi-group dataplane (no context is grouped at G=1, in
    either package): waves of random depth between single rounds, a kill,
    a wipe and revive, reclamation with snapshot marks, a frozen stretch."""
    ref, got = _planes(1, True, n=256, be=16, reclaim=True)
    rng = np.random.default_rng(1)
    for step in range(24):
        k = int(rng.integers(1, 5))
        vals, active = _wave_values(rng, k, 1, 16)
        for hw in (ref, got):
            if step == 6:
                hw.kill_acceptor(0, 1)
            if step == 12:
                hw.wipe_acceptor(0, 1)
                hw.revive_acceptor(0, 1)
            if step % 2:
                hw.set_reclaimed(0, hw.next_inst_host[0])
            if k > 1:
                res = hw.pipeline_persistent((0,), vals, active)
            else:
                res = hw.pipeline_cohort((0,), vals[0], active[0])
            if hw is ref:
                want = res
        _equal(want, res, ("fresh", "inst", "value"))
    _same_plane(ref, got)


# ---------------------------------------------------------------------------
# 4. the grouped context at the reference's defaults
# ---------------------------------------------------------------------------
def _cfg(pkg, g: int, **kw):
    return pkg.PaxosConfig(**{**dict(n_acceptors=A, n_instances=N, batch=16, n_groups=g), **kw})


def _ctx(pkg, g, seed=None, deliver=None, **kw):
    """A grouped context at ``persistent_rounds=8`` (the default); the
    reference's with ``use_kernels=True`` (its Pallas kernels in interpret
    mode where windows align), the port's on the CPU."""
    net = pkg.SimNet() if seed is None else pkg.SimNet(pkg.FaultSpec(**FAULTS), seed)
    cfg_kw = {k: kw.pop(k) for k in ("async_pump", "realign_after") if k in kw}
    extra = {"device": "cpu"} if pkg is T else {}
    ctx = pkg.PaxosContext(_cfg(pkg, g, **cfg_kw), net=net, use_kernels=True, deliver=deliver,
                           **kw, **extra)  # fmt: skip
    assert ctx.cfg.persistent_rounds == 8
    return ctx


def _record(ctx) -> list:
    """Every dispatch as ``(kind, gids, K, fold width)``, in order."""
    seen: list = []
    hw = ctx.hw
    for kind in ("pipeline_cohort", "pipeline_persistent"):
        dispatch = getattr(hw, kind)

        def recorded(gids, values, *args, _d=dispatch, _kind=kind, **kw):
            out = _d(gids, values, *args, **kw)
            depth = values.shape[0] if _kind == "pipeline_persistent" else 1
            seen.append((_kind, tuple(gids), depth, hw.last_gb))
            return out

        setattr(hw, kind, recorded)
    return seen


def _assert_same(ref, got) -> None:
    for gid in range(ref.n_groups):
        assert got.full_group_log(gid) == ref.full_group_log(gid), gid
    assert got.group_log == ref.group_log
    assert got.stats == ref.stats
    want, have = export_state(ref.hw), export_state(got.hw)
    assert want.keys() == have.keys()
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)
    assert got.hw.dispatch_count == ref.hw.dispatch_count
    assert got.hw.last_gb == ref.hw.last_gb
    assert got.planner.report() == ref.planner.report()
    assert got.quiescent() and ref.quiescent()


def _schedule(ctx, g: int, seed: int) -> list:
    """Uniform load of 9 batches a group per pump (full-fold waves of K=8
    even where the lossy net dropped a few submits); skewed load with group 0
    at 2 to 12 batches per pump and the others trickling, a snapshot of
    every group after each pump; a kill and revive; a failover of group 2
    with the others forming waves, its restore and a recovery; a crash and
    restore; retire + create and retire + adopt; waves again.  Returns what
    each step returned."""
    rng = np.random.default_rng(seed)
    out = []
    hw, b = ctx.hw, ctx.cfg.batch

    def wave(tag, loads):
        for gid, k in enumerate(loads):
            for j in range(k):
                ctx.submit(f"{tag}g{gid}j{j}-{'x' * (j % 30)}".encode(), group=gid)
        ctx.run_until_quiescent()

    def snap_all():
        out.extend(ctx.snapshot_group(gid).seal for gid in ctx.live_groups())

    for w in range(2):
        wave(f"u{w}", [9 * b] * g)
        snap_all()
    for w in range(4):
        trickle = [int(x) for x in rng.integers(0, 12, g - 1)]
        wave(f"s{w}", [int(rng.integers(2 * b, 12 * b + 1)), *trickle])
        snap_all()
    hw.kill_acceptor(1, 2)
    wave("k", [3 * b] * g)
    hw.revive_acceptor(1, 2)
    snap_all()
    gap = hw.next_inst_host[2]
    out.append(ctx.fail_coordinator(est_next_inst=gap + b, group=2).next_inst)
    wave("f", [2 * b + 3] * g)
    ctx.restore_hardware_coordinator(group=2)
    ctx.recover(gap + 1, group=2)
    wave("r", [2] * g)
    snap_all()
    ctx.crash_acceptor(0, group=3)
    wave("c", [5 * b] * g)
    snap_all()
    out.append(ctx.restore_acceptor(0, group=3))
    out.append(ctx.retire_group(g - 1))
    out.append(ctx.create_group())
    out.append(ctx.retire_group(g - 2))
    snap = ctx.snapshot_group(1)
    out.append(ctx.adopt_group(snap, ctx.full_group_log(1)))
    wave("e", [4 * b + 1] * g)
    snap_all()
    return out


@pytest.mark.parametrize("g,async_pump", [(4, True), (4, False), (8, True)])
def test_default_context_matches_reference(g, async_pump):
    """The grouped context at ``persistent_rounds=8`` against the
    reference's on the same lossy schedule: equal step results, group logs,
    the sequence of ``deliver`` callbacks, every dispatch (kind, cohort,
    depth, fold width), slabs and mirrors, ``dispatch_count`` and the
    planner's report; waves of K=8 and of 1 < K < 8 both ran."""
    calls: list[list] = [[], []]
    ref, got = (
        _ctx(pkg, g, seed=g, deliver=lambda p, s, i, c=c: c.append((p, i)), snapshots=True,
             async_pump=async_pump)
        for pkg, c in ((R, calls[0]), (T, calls[1]))
    )  # fmt: skip
    seen = [_record(ref), _record(got)]
    want = _schedule(ref, g, seed=g)
    have = _schedule(got, g, seed=g)
    assert have == want
    assert calls[1] == calls[0] and len(calls[1]) == got.stats["delivered"]
    assert seen[1] == seen[0]
    _assert_same(ref, got)
    depths = {d for kind, _gids, d, _gb in seen[1] if kind == "pipeline_persistent"}
    assert 8 in depths and depths & set(range(2, 8)), sorted(depths)
    assert got.planner.report()["persistent_waves"] == len(
        [s for s in seen[1] if s[0] == "pipeline_persistent"]
    )


def test_async_pump_equals_serial_pump():
    """The port's double-buffered pump against its serial pump on the same
    lossy schedule: identical logs, deliveries, state and plan."""
    calls: list[list] = [[], []]
    runs = []
    for ap, c in ((True, calls[0]), (False, calls[1])):
        ctx = _ctx(T, 4, seed=9, deliver=lambda p, s, i, c=c: c.append((p, i)), snapshots=True,
                   async_pump=ap)  # fmt: skip
        _schedule(ctx, 4, seed=9)
        runs.append(ctx)
    assert calls[0] == calls[1]
    _assert_same(*runs)


@pytest.mark.parametrize("async_pump", [True, False])
def test_reclaim_clamped_wave_matches_reference(async_pump):
    """Reclaim headroom shorter than the planned wave: ``_wave_depth_clamped``
    cuts K to the headroom, identically in both packages; the traffic past
    the limit then raises ``RingOverflowError`` at the same dispatch in
    both, with equal state; after a snapshot both drain equally."""
    ref, got = (_ctx(pkg, 2, snapshots=True, async_pump=async_pump) for pkg in (R, T))
    seen = [_record(ref), _record(got)]
    b = ref.cfg.batch
    for ctx in (ref, got):
        for j in range(26 * b):
            ctx.submit(f"a{j}".encode(), group=0)
        ctx.run_until_quiescent()
        assert ctx.hw.next_inst_host[0] == 26 * b  # waves of 8, 8, 8, 2
        cohort = ctx.planner.last_plan.cohorts[0]
        assert cohort.gids == (0,) and cohort.burst == b
        assert ctx._wave_depth_clamped(dataclasses.replace(cohort, rounds=8)) == 6  # 96 left
        for j in range(10 * b):
            ctx.submit(f"b{j}".encode(), group=0)
        with pytest.raises(RuntimeError, match="ring"):
            ctx.run_until_quiescent()
    assert [s[2] for s in seen[1]] == [8, 8, 8, 2, 6] == [s[2] for s in seen[0]]
    for key, arr in export_state(ref.hw).items():
        np.testing.assert_array_equal(export_state(got.hw)[key], arr, err_msg=key)
    assert got.group_log == ref.group_log
    for ctx in (ref, got):
        ctx.snapshot_group(0)
        ctx.run_until_quiescent()
    _assert_same(ref, got)
    assert seen[1] == seen[0]


def test_midstream_submissions_match_reference():
    """A deliver callback that submits fresh traffic while a wave is still
    in flight: the port's async and serial pumps and the reference's agree
    on every log and on the order of deliveries."""
    logs, orders = [], []
    for pkg in (R, T):
        for ap in (True, False):
            order: list = []
            fired: list = []
            holder: list = []

            def follow_up(payload, size, inst, order=order, fired=fired, holder=holder):
                order.append((payload, inst))
                if payload == b"a0000" and not fired:
                    fired.append(inst)
                    for j in range(40):
                        holder[0].submit(f"f{j:04d}".encode(), group=1)

            ctx = pkg.PaxosContext(
                _cfg(pkg, 2, n_instances=1 << 10, batch=32, persistent_rounds=4, async_pump=ap),
                deliver=follow_up, use_kernels=True, **({"device": "cpu"} if pkg is T else {}),
            )  # fmt: skip
            holder.append(ctx)
            for i in range(96):
                ctx.submit(f"a{i:04d}".encode(), group=0)
            ctx.run_until_quiescent()
            assert ctx.quiescent() and fired
            logs.append(ctx.group_log)
            orders.append(order)
    assert all(log == logs[0] for log in logs) and len(logs[0][1]) == 40
    assert all(o == orders[0] for o in orders)


def test_one_dispatch_per_wave_matches_reference():
    """130 submits to group 0 and 45 to group 1 at batch 32: one K=4 wave
    and tail bursts, as the reference counts them; persistent_rounds=1
    needs more dispatches and plans no wave."""
    counts = {}
    for pkg in (R, T):
        for pr in (4, 1):
            ctx = pkg.PaxosContext(
                _cfg(pkg, 2, n_instances=1 << 10, batch=32, persistent_rounds=pr),
                use_kernels=True, **({"device": "cpu"} if pkg is T else {}),
            )  # fmt: skip
            for i in range(130):
                ctx.submit(f"a{i:04d}".encode(), group=0)
            for i in range(45):
                ctx.submit(f"b{i:04d}".encode(), group=1)
            ctx.run_until_quiescent()
            counts[pkg.__name__, pr] = (
                ctx.hw.dispatch_count, ctx.planner.stats["persistent_waves"], ctx.group_log
            )  # fmt: skip
    assert counts["repro_torch.core", 4] == counts["repro.core", 4]
    assert counts["repro_torch.core", 1] == counts["repro.core", 1]
    assert counts["repro_torch.core", 4][:2] == (4, 1)
    assert counts["repro_torch.core", 1][1] == 0
    assert counts["repro_torch.core", 4][0] < counts["repro_torch.core", 1][0]
    assert counts["repro_torch.core", 4][2] == counts["repro_torch.core", 1][2]
