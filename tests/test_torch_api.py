"""The port's whole single-group service against the reference's, bit for bit.

The reference ``repro.core.PaxosContext`` and the port's, both with
``fused=True, use_kernels=True, snapshots=True`` (the reference runs its
Pallas kernels in interpret mode, the port its plain versions on the CPU),
get the same schedule over the same seeded lossy ``SimNet``.  Their delivery
logs, stitched logs, every seal and the final dataplane state must be equal.
The state bridge is held to the same standard: the reference's state, read
out as numpy and loaded into the port, runs on identically.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.bridge import export_state, import_state  # noqa: E402
from repro_torch.launch.mesh import make_group_mesh  # noqa: E402

CFG = dict(n_acceptors=3, n_instances=256, value_words=16, batch=16)
FAULTS = dict(drop=0.08, dup=0.05, reorder=0.1)


def _contexts(seed: int, faults=FAULTS, cfg=CFG, **kw):
    common = dict(fused=True, use_kernels=True, **kw)
    ref = R.PaxosContext(R.PaxosConfig(**cfg), net=R.SimNet(R.FaultSpec(**faults), seed), **common)
    got = T.PaxosContext(
        T.PaxosConfig(**cfg), net=T.SimNet(T.FaultSpec(**faults), seed), device="cpu", **common
    )
    return ref, got


def _step(ctx, op, arg, tag):
    """Apply one schedule step; returns a seal where the step takes one."""
    if op == "submit":
        for i in range(arg):
            ctx.submit(f"{tag}-{i}-{'x' * (i % 40)}".encode())
    elif op == "drain":
        ctx.run_until_quiescent()
    elif op == "pump":
        ctx.pump(arg)
    elif op == "snap":
        return ctx.snapshot_group().seal
    elif op == "kill":
        ctx.hw.kill_acceptor(arg)
    elif op == "revive":
        ctx.hw.revive_acceptor(arg)
    elif op == "crash":
        ctx.crash_acceptor(arg)
    elif op == "restore_acceptor":
        return ctx.restore_acceptor(arg)
    elif op == "fail":
        return ctx.fail_coordinator(est_next_inst=arg).next_inst
    elif op == "restore_hw":
        ctx.restore_hardware_coordinator()
    elif op == "recover":
        ctx.recover(arg)
    else:
        raise ValueError(op)
    return None


def _run_both(schedule, seed: int):
    ref, got = _contexts(seed, snapshots=True)
    for n, (op, arg) in enumerate(schedule):
        r = _step(ref, op, arg, f"{n}")
        g = _step(got, op, arg, f"{n}")
        assert r == g, (n, op, r, g)
    return ref, got


def _assert_same(ref, got) -> None:
    assert got.delivered_log == ref.delivered_log
    assert got.group_log == ref.group_log
    assert got.full_group_log() == ref.full_group_log()
    assert got.stats == ref.stats
    assert got.quiescent() and ref.quiescent()
    assert got.snapshots.snapshot().seal == ref.snapshots.snapshot().seal
    want, have = export_state(ref.hw), export_state(got.hw)
    assert want.keys() == have.keys()
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)
    assert got.hw.dispatch_count == ref.hw.dispatch_count


def _laps(steps: int, per: int = 60):
    out = []
    for _ in range(steps):
        out += [("submit", per), ("drain", None), ("snap", None)]
    return out


SCHEDULES = {
    # 8 x 60 payloads plus fillers and retransmits: well past 256 instances
    "wrap_under_reclamation": _laps(8),
    "kill_to_quorum_boundary_and_revive": [
        ("submit", 40), ("drain", None), ("snap", None),
        ("kill", 2), ("submit", 40), ("drain", None),
        ("kill", 0), ("submit", 5), ("pump", 4),  # below quorum: nothing decides
        ("revive", 0), ("drain", None), ("snap", None),
        ("revive", 2), ("submit", 40), ("drain", None), ("snap", None),
    ],
    "failover_mid_stream": [
        ("submit", 50), ("drain", None), ("snap", None),
        ("submit", 30), ("pump", 1), ("fail", None),
        ("submit", 30), ("drain", None), ("snap", None),
        ("restore_hw", None), ("submit", 50), ("drain", None), ("snap", None),
        *_laps(3),
    ],
    "crash_and_restore_after_snapshot": [
        *_laps(2),
        ("crash", 1), ("submit", 60), ("drain", None), ("snap", None),
        ("restore_acceptor", 1), ("kill", 0), ("submit", 60), ("drain", None),
        ("revive", 0), ("snap", None), *_laps(2),
    ],
    "recover_skipped_instance": [
        ("submit", 20), ("drain", None),
        ("fail", 64), ("submit", 10), ("drain", None), ("restore_hw", None),
        ("recover", 40), ("recover", 70), ("drain", None), ("snap", None),
        ("submit", 20), ("drain", None), ("snap", None),
    ],
}  # fmt: skip


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_context_matches_reference(name):
    ref, got = _run_both(SCHEDULES[name], seed=len(name))
    _assert_same(ref, got)
    assert len(got.full_group_log()) == got.stats["submitted"]


def test_quickstart_sequence_matches_reference():
    """``examples/quickstart.py``'s own sequence, callbacks included."""
    cfg = dict(n_acceptors=3, n_instances=4096, batch=16)
    seen = {"ref": [], "got": []}
    ref, got = _contexts(0, faults={}, cfg=cfg)
    ref.deliver_cb = lambda v, s, i: seen["ref"].append((i, v, s))
    got.deliver_cb = lambda v, s, i: seen["got"].append((i, v, s))
    for ctx in (ref, got):
        for i in range(5):
            ctx.submit(f"command-{i}".encode())
        ctx.run_until_quiescent()
        ctx.hw.kill_acceptor(2)
        ctx.submit(b"still-works")
        ctx.run_until_quiescent()
        ctx.fail_coordinator()
        ctx.submit(b"after-failover")
        ctx.run_until_quiescent()
    assert seen["got"] == seen["ref"]
    assert [v for _, v, _ in seen["got"]] == [
        *(f"command-{i}".encode() for i in range(5)),
        b"still-works",
        b"after-failover",
    ]
    assert got.delivered_log == ref.delivered_log


@pytest.mark.parametrize("rounds_before", [3, 5])
def test_bridge_carries_reference_state_into_the_port(rounds_before):
    """Run the reference's dataplane k rounds, load its exported state into
    a fresh port dataplane, run both on: every output and state stays equal.
    A sub-batch burst leaves the watermark off the block boundary first."""
    cfg = CFG
    ref = R.HardwareDataplane(R.PaxosConfig(**cfg), use_kernels=True)
    ref.enable_reclamation()
    rng = np.random.default_rng(rounds_before)
    bursts = [16, 8] + [16] * (rounds_before - 2)
    for b in bursts:
        ref.pipeline(rng.integers(-(2**31), 2**31, (b, 16), dtype=np.int32), np.ones(b, bool))
    ref.kill_acceptor(1)
    ref.set_reclaimed(16)
    got = T.HardwareDataplane(T.PaxosConfig(**cfg), device="cpu")
    import_state(got, export_state(ref))
    for b in [16, 8, 16, 16]:
        vals = rng.integers(-(2**31), 2**31, (b, 16), dtype=np.int32)
        want = ref.pipeline(vals, np.ones(b, bool))
        have = got.pipeline(vals, np.ones(b, bool))
        for w, h in zip(want, have, strict=True):
            np.testing.assert_array_equal(h, w)
        w_state, h_state = export_state(ref), export_state(got)
        for key in w_state:
            np.testing.assert_array_equal(h_state[key], w_state[key], err_msg=key)


def test_export_state_copies():
    """An export is a snapshot: later rounds do not change it."""
    hw = T.HardwareDataplane(T.PaxosConfig(**CFG), device="cpu")
    before = export_state(hw)
    hw.pipeline(np.ones((16, 16), np.int32), np.ones(16, bool))
    assert not before["lstate.delivered"].any()
    assert export_state(hw)["lstate.delivered"].sum() == 16


def test_grouped_and_sharded_contexts_are_not_ported_yet(monkeypatch):
    """Every context is ported now.  The sharded dataplane is built by a
    ``mesh=`` context, and a context asked for the CPU on a mesh over
    several cards refuses it.  Persistent waves are ported: a grouped
    context with ``persistent_rounds=2`` builds and runs a wave of two
    rounds."""
    ctx = T.PaxosContext(T.PaxosConfig(n_groups=2, persistent_rounds=2, **CFG), device="cpu")
    waves = []
    persistent = ctx.hw.pipeline_persistent

    def recorded(gids, values, *args, **kw):
        waves.append((tuple(gids), values.shape[0]))
        return persistent(gids, values, *args, **kw)

    ctx.hw.pipeline_persistent = recorded
    for i in range(2 * CFG["batch"]):
        ctx.submit(f"w{i}".encode(), group=1)
    ctx.run_until_quiescent()
    assert waves == [((1,), 2)] and ctx.hw.dispatch_count == 1
    assert [p for _i, p in ctx.group_log[1]] == [f"w{i}".encode() for i in range(32)]
    sharded = T.PaxosContext(T.PaxosConfig(**CFG), mesh=make_group_mesh(device="cpu"),
                             device="cpu")  # fmt: skip
    assert isinstance(sharded.hw, T.ShardedMultiGroupDataplane) and sharded.grouped
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="not the mesh's device cuda:0"):
        T.PaxosContext(T.PaxosConfig(), mesh=make_group_mesh(), device="cpu")


def test_staged_path_runs_plain_on_the_cpu():
    """``fused=False`` runs the staged path; on the CPU its plain engine
    decides exactly as the reference's staged path does."""
    ref, got = (
        R.PaxosContext(R.PaxosConfig(**CFG), use_kernels=True),
        T.PaxosContext(T.PaxosConfig(**CFG), device="cpu"),
    )
    for ctx in (ref, got):
        for i in range(20):
            ctx.submit(f"staged-{i}".encode())
        ctx.run_until_quiescent()
    assert got.delivered_log == ref.delivered_log
    assert len(got.delivered_log) == 20


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert T.HardwareDataplane(T.PaxosConfig(**CFG)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.PaxosContext(T.PaxosConfig(**CFG))
